// Fused causal HiFiGAN resblock stack for Hopper (sm_90a), batch mode.
//
// Replaces the TPU kernel audiodec_tpu/ops/pallas/folded_stack.py
// folded_residual_stack (pallas_call at :372) in its vocoder mode: a chain
// of units
//
//   v += mask(conv_K,1(act(mask(conv_K,d(act(v)) + b1))) + b2)
//
// with act = LeakyReLU(slope), both convs causal with K taps (the first
// dilated by d), optional biases, and mask() zeroing every conv output at
// absolute t < 0, as the TPU kernel does (folded_stack.py:285-291,
// :353-354, :365-366): with biases a zero input no longer gives a zero
// output, so without the mask the halo before t=0 would leak bias into the
// sequence.  The TPU kernel's fold of time into the MXU's 128 lanes is a TPU
// workaround and is not ported, only the semantics are.
//
// Bound on the H100 at AD v1's last vocoder stage, (16, 32, 480000) in bf16
// per launch: one read and one write of the activation is 0.98 GB (0.29 ms
// at 3.35 TB/s); the dots are 3 * (11 + 11) * 32 * 32 * 2 = 135 kFLOP per
// sample, 1.04e12 FLOP (1.05 ms at 989 TFLOP/s on the bf16 tensor cores).
// This first version multiplies on the f32 FMA units (67 TFLOP/s), so it is
// bound by operations.
//
// Design: one block per (batch row, time tile).  The block stages the tile
// and its whole left halo, sum over units of (K-1)*d + (K-1) samples (120
// for K=11, d = 1, 3, 5), in shared memory, and runs every unit there, so
// device memory sees one read (plus the halo) and one write of the
// activation.  Shared memory holds the residual stream V in the storage
// dtype, the activations A = act(V) and M = act(conv1 + b1) in the dot
// operand type (bf16 when the operands are rounded to bf16, which is exact,
// else f32), and one unit's two f32 weight sets (90 KB at CP=32, K=11).
// The tile is the largest that fits the 227 KB a block may use, capped so
// that the first conv covers exactly one pass of the block (512 positions):
// at CP=32 and K=11 that is 402 samples with bf16 operands (223 KB) and 250
// in true f32 (227 KB), one block per SM.  Each thread holds 2 time
// positions x all (padded) output channels of a conv in registers; the
// weights are read as float4 broadcasts, the activations conflict-free
// (neighbouring lanes, neighbouring positions).
//
// Rounding points follow the TPU kernel (folded_stack.py:344-371): act in
// f32; dot operands rounded to bf16 when `dots_bf16` is set (the wrapper
// passes weights already rounded); products summed in f32; biases added in
// f32 to the f32 sum.  The residual is the TPU statement
// `v = v + y2.astype(v.dtype)` (:367) as XLA computes it: in f32 storage
// v + y2; in bf16 storage the f32 sum s = bf16(v) + bf16(y2), which the
// next unit's activation (:344) reads and the stream holds rounded to bf16
// (ops/kernels/folded_stack.py storage_residual).  So in bf16 storage the
// second conv's epilogue, where s is in registers, writes both V = bf16(s)
// and the next unit's operand A = bf16(act(s)) (A is free once the first
// conv is done), and the next unit does not restage A from V.  Channels C <= 32 are padded to CP in {4, 8, 16, 32}: the padded
// weights and biases are zero, so the padded channels stay zero.
//
// Templated on what the inner loops unroll (CP) and on the buffer types
// (storage S, operand OP: (f32, f32), (f32, bf16), (bf16, bf16)); K, the
// dilations, the slope and the presence of biases are run-time arguments.
//
// Plain C interface for ctypes: pointers and the stream as void*, ints as
// int, the slope as float; returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int POS = 2;                  // time positions per thread
constexpr int ROUND = NTHREADS * POS;   // positions the block covers per pass
constexpr int MAX_UNITS = 3;
constexpr int MAX_K = 16;
constexpr int SMEM_LIMIT = 232448;      // bytes a block may use on sm_90
constexpr int MIN_TILE = 32;

struct Units {
  int n;
  int dil[MAX_UNITS];
};

__device__ __forceinline__ float lrelu(float v, float slope) {
  return v > 0.f ? v : slope * v;
}

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// the unit's residual sum from the residual v and y2 (see above)
__device__ __forceinline__ float residual(float v, float y, const float*) {
  return v + y;
}
__device__ __forceinline__ float residual(float v, float y,
                                          const __nv_bfloat16*) {
  return v + __bfloat162float(__float2bfloat16_rn(y));
}

// acc[j][o] = sum_{i,k} w[k][i][o] * in[i][p[j] - (K-1-k)*d]
template <int CP, typename OP>
__device__ __forceinline__ void causal_conv(float (&acc)[POS][CP],
                                            const OP* in, const float* w,
                                            const int (&p)[POS], int L, int K,
                                            int d) {
#pragma unroll
  for (int j = 0; j < POS; ++j)
#pragma unroll
    for (int o = 0; o < CP; ++o) acc[j][o] = 0.f;
  for (int i = 0; i < CP; ++i) {
    const OP* row = in + i * L;
    for (int k = 0; k < K; ++k) {
      const int off = (K - 1 - k) * d;
      float a[POS];
#pragma unroll
      for (int j = 0; j < POS; ++j) a[j] = load_f(row + p[j] - off);
      const float4* wr = reinterpret_cast<const float4*>(w + (k * CP + i) * CP);
#pragma unroll
      for (int o4 = 0; o4 < CP / 4; ++o4) {
        const float4 wv = wr[o4];
#pragma unroll
        for (int j = 0; j < POS; ++j) {
          acc[j][4 * o4 + 0] += a[j] * wv.x;
          acc[j][4 * o4 + 1] += a[j] * wv.y;
          acc[j][4 * o4 + 2] += a[j] * wv.z;
          acc[j][4 * o4 + 3] += a[j] * wv.w;
        }
      }
    }
  }
}

template <int CP, typename S, typename OP>
__global__ void __launch_bounds__(NTHREADS, 1)
resblock_stack_kernel(const S* __restrict__ x, S* __restrict__ out,
                      const float* __restrict__ w1,    // (n, K, CP, CP)
                      const float* __restrict__ w2,    // (n, K, CP, CP)
                      const float* __restrict__ bias,  // (n, 2, CP) or null
                      int C, int T, int K, int tile, int halo, Units units,
                      float slope) {
  constexpr bool BF16 = sizeof(S) == 2;  // the f32 sum goes straight to A
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = tile + halo;
  const int wsize = K * CP * CP;
  float* W1 = reinterpret_cast<float*>(smem_raw);  // K x CP x CP: [k][i][o]
  float* W2 = W1 + wsize;                          // K x CP x CP
  float* Bs = W2 + wsize;                          // 2 x CP: b1, b2
  S* V = reinterpret_cast<S*>(Bs + 2 * CP);        // CP x L: residual stream
  OP* A = reinterpret_cast<OP*>(V + CP * L);       // CP x L: act(V)
  OP* M = A + CP * L;                              // CP x L: act(conv1 + b1)

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile - halo;  // time of buffer position 0
  const S* xb = x + (size_t)b * C * T;
  for (int e = threadIdx.x; e < CP * L; e += NTHREADS) {
    const int c = e / L, p = e - c * L, t = t0 + p;
    store_f(V + e, (c < C && t >= 0 && t < T)
                       ? load_f(xb + (size_t)c * T + t) : 0.f);
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int s = 0;  // first buffer position of V still valid
  for (int u = 0; u < units.n; ++u) {
    const int d = units.dil[u];
    __syncthreads();  // V is complete; weights, biases, A and M are free
    for (int e = threadIdx.x; e < wsize; e += NTHREADS) {
      W1[e] = w1[(size_t)u * wsize + e];
      W2[e] = w2[(size_t)u * wsize + e];
    }
    for (int e = threadIdx.x; e < 2 * CP; e += NTHREADS)
      Bs[e] = bias ? bias[u * 2 * CP + e] : 0.f;
    if (!BF16 || u == 0)
      for (int e = threadIdx.x; e < CP * L; e += NTHREADS)
        if (e % L >= s) store_f(A + e, lrelu(load_f(V + e), slope));
    __syncthreads();

    // first conv (dilation d) + b1, act, into M over [s1, L)
    const int s1 = s + (K - 1) * d;
    for (int base = s1 + warp * 32 * POS; base < L; base += ROUND) {
      int p[POS];
      bool ok[POS];
#pragma unroll
      for (int j = 0; j < POS; ++j) {
        p[j] = base + lane + 32 * j;
        ok[j] = p[j] < L;
        if (!ok[j]) p[j] = L - 1;  // in bounds; the result is not stored
      }
      float acc[POS][CP];
      causal_conv<CP>(acc, A, W1, p, L, K, d);
#pragma unroll
      for (int j = 0; j < POS; ++j) {
        if (!ok[j]) continue;
        const bool live = t0 + p[j] >= 0;  // exact zero before t=0
#pragma unroll
        for (int o = 0; o < CP; ++o)
          store_f(M + o * L + p[j],
                  live ? lrelu(acc[j][o] + Bs[o], slope) : 0.f);
      }
    }
    __syncthreads();

    // second conv (dilation 1) + b2, added to the residual over [s2, L)
    const int s2 = s1 + (K - 1);
    for (int base = s2 + warp * 32 * POS; base < L; base += ROUND) {
      int p[POS];
      bool ok[POS];
#pragma unroll
      for (int j = 0; j < POS; ++j) {
        p[j] = base + lane + 32 * j;
        ok[j] = p[j] < L;
        if (!ok[j]) p[j] = L - 1;
      }
      float acc[POS][CP];
      causal_conv<CP>(acc, M, W2, p, L, K, 1);
#pragma unroll
      for (int j = 0; j < POS; ++j) {
        if (!ok[j] || t0 + p[j] < 0) continue;  // V stays 0 before t=0
#pragma unroll
        for (int o = 0; o < CP; ++o) {
          S* vp = V + o * L + p[j];
          const float sum = residual(load_f(vp), acc[j][o] + Bs[CP + o], x);
          store_f(vp, sum);
          if (BF16) store_f(A + o * L + p[j], lrelu(sum, slope));
        }
      }
    }
    s = s2;
  }
  __syncthreads();

  S* ob = out + (size_t)b * C * T;
  const int t_out = blockIdx.x * tile;
  for (int e = threadIdx.x; e < C * tile; e += NTHREADS) {
    const int c = e / tile, j = e - c * tile, t = t_out + j;
    if (t < T) ob[(size_t)c * T + t] = V[c * L + halo + j];
  }
}

template <int CP, typename S, typename OP>
int launch(const void* x, void* out, const void* w1, const void* w2,
           const void* bias, int B, int C, int T, int K, Units units,
           float slope, cudaStream_t stream) {
  int halo = 0;
  for (int u = 0; u < units.n; ++u) halo += (K - 1) * units.dil[u] + (K - 1);
  const int fixed = (int)sizeof(float) * (2 * K * CP * CP + 2 * CP);
  const int per_pos = CP * (int)(sizeof(S) + 2 * sizeof(OP));
  int L = (SMEM_LIMIT - fixed) / per_pos;
  // the first unit's first conv then covers at most one pass of the block
  const int one_pass = ROUND + (K - 1) * units.dil[0];
  if (L > one_pass) L = one_pass;
  const int tile = L - halo;
  if (tile < MIN_TILE) return (int)cudaErrorInvalidValue;
  const int smem = fixed + L * per_pos;
  // raise the kernel's dynamic shared memory limit once per device and size
  constexpr int MAX_DEVICES = 64;
  static int granted[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES || smem > granted[dev]) {
    err = cudaFuncSetAttribute(resblock_stack_kernel<CP, S, OP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < MAX_DEVICES) granted[dev] = smem;
  }
  const dim3 grid((T + tile - 1) / tile, B);
  resblock_stack_kernel<CP, S, OP><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const S*>(x), static_cast<S*>(out),
      static_cast<const float*>(w1), static_cast<const float*>(w2),
      static_cast<const float*>(bias), C, T, K, tile, halo, units, slope);
  return (int)cudaGetLastError();
}

template <typename S, typename OP>
int dispatch(int cp, const void* x, void* out, const void* w1, const void* w2,
             const void* bias, int B, int C, int T, int K, Units units,
             float slope, cudaStream_t stream) {
  switch (cp) {
    case 4:
      return launch<4, S, OP>(x, out, w1, w2, bias, B, C, T, K, units, slope,
                              stream);
    case 8:
      return launch<8, S, OP>(x, out, w1, w2, bias, B, C, T, K, units, slope,
                              stream);
    case 16:
      return launch<16, S, OP>(x, out, w1, w2, bias, B, C, T, K, units,
                               slope, stream);
    case 32:
      return launch<32, S, OP>(x, out, w1, w2, bias, B, C, T, K, units,
                               slope, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x, out: (B, C, T) contiguous, float32 (storage_bf16 = 0) or bfloat16;
// w1, w2: (n_units, K, cp, cp) f32 as [u][k][i][o], zero-padded from C to cp
// channels (already rounded to bf16 when dots_bf16); bias: (n_units, 2, cp)
// f32 as [u][b1|b2][o], or null for no biases.  bf16 storage needs
// dots_bf16 (the TPU kernel rounds the operands to the storage dtype).
extern "C" int resblock_stack_forward(const void* x, void* out, const void* w1,
                                      const void* w2, const void* bias, int B,
                                      int C, int T, int cp, int K,
                                      int n_units, int d0, int d1, int d2,
                                      float slope, int dots_bf16,
                                      int storage_bf16, void* stream) {
  if (n_units < 1 || n_units > MAX_UNITS || C < 1 || C > cp || B < 1 ||
      T < 1 || K < 2 || K > MAX_K || (storage_bf16 && !dots_bf16))
    return (int)cudaErrorInvalidValue;
  Units units;
  units.n = n_units;
  units.dil[0] = d0;
  units.dil[1] = d1;
  units.dil[2] = d2;
  for (int u = 0; u < n_units; ++u)
    if (units.dil[u] < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (storage_bf16)
    return dispatch<__nv_bfloat16, __nv_bfloat16>(cp, x, out, w1, w2, bias, B,
                                                  C, T, K, units, slope, s);
  if (dots_bf16)
    return dispatch<float, __nv_bfloat16>(cp, x, out, w1, w2, bias, B, C, T,
                                          K, units, slope, s);
  return dispatch<float, float>(cp, x, out, w1, w2, bias, B, C, T, K, units,
                                slope, s);
}
