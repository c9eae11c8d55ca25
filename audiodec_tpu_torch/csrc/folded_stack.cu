// Fused causal residual stack for Hopper (sm_90a), batch mode.
//
// Replaces the TPU kernel audiodec_tpu/ops/pallas/folded_stack.py
// folded_residual_stack (pallas_call at :372) in its autoencoder mode: a
// chain of units v += conv1x1(act(conv_k7_dil_d(act(v)))), act = ELU, no
// biases, zero left context at t=0.  The TPU kernel folds time into the
// MXU's 128 lanes; that fold is a TPU workaround and is not ported, only
// the semantics are.
//
// Bound on the H100: at the main path's shape (16, 480000, 32) a stack moves
// one read and one write of the activation (1.97 GB in f32, 0.98 GB in bf16)
// and does 3 * (7 + 1) * 32 * 32 * 2 = 49 kFLOP per sample (3.8e11 FLOP).
// With bf16 operands the tensor cores would make it memory-bound in f32
// storage; this first version runs the products on the f32 FMA units
// (67 TFLOP/s), so it is bound by operations.
//
// Design: one block per (batch row, time tile).  The block stages the tile
// plus a left halo of sum((K-1)*d) samples (78 for d = 1, 3, 9) in shared
// memory, zero before t=0; without biases zeros stay exact zeros through
// ELU and the convs, so no row masking is needed.  All units run in shared
// memory, so the stack reads and writes device memory once.  Each thread
// holds 2 time positions x all (padded) channels of the k=7 conv in
// registers and applies the 1x1 conv to them in registers, so the
// intermediate never touches shared memory.  Rounding points follow the TPU
// kernel: the dot operands (activations and weights) are rounded to bf16
// when `dots_bf16` is set, and products are summed in f32.  The residual
// is the TPU statement `v = v + y2.astype(v.dtype)` (folded_stack.py:367)
// as XLA computes it: in f32 storage v + y2; in bf16 storage the f32 sum
// s = bf16(v) + bf16(y2), which the next unit's activation (:344) reads
// and the output holds rounded to bf16 (ops/kernels/folded_stack.py
// storage_residual).  V keeps s in shared memory, so carrying it costs
// nothing.  ELU is expm1 in f32 storage, as the plain version's F.elu, and
// the TPU kernel's exp(min(v, 0)) - 1 in bf16 storage.
//
// Channels C <= 32 are padded to CP in {4, 8, 16, 32}: the padded weights
// are zero, so the padded channels stay zero.
//
// Plain C interface for ctypes: pointers and the stream as void*, ints as
// int; returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int K = 7;
constexpr int NTHREADS = 256;
constexpr int POS = 2;                  // time positions per thread
constexpr int ROUND = NTHREADS * POS;   // positions the block covers per pass
constexpr int MAX_UNITS = 3;

struct Units {
  int n;
  int dil[MAX_UNITS];
};

// ELU: expm1 in f32 storage, exp(min(v, 0)) - 1 in bf16 storage (see above)
__device__ __forceinline__ float elu(float v, const float*) {
  return v > 0.f ? v : expm1f(v);
}
__device__ __forceinline__ float elu(float v, const __nv_bfloat16*) {
  return v > 0.f ? v : expf(fminf(v, 0.f)) - 1.f;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// the unit's residual sum from the carried sum v and y2 (see above)
__device__ __forceinline__ float residual(float v, float y, const float*) {
  return v + y;
}
__device__ __forceinline__ float residual(float v, float y,
                                          const __nv_bfloat16*) {
  return round_bf16(v) + round_bf16(y);
}

template <int CP, typename S>
__global__ void __launch_bounds__(NTHREADS, 1)
folded_stack_kernel(const S* __restrict__ x, S* __restrict__ out,
                    const float* __restrict__ w1,  // (n, K, CP, CP): [u][k][i][o]
                    const float* __restrict__ w2,  // (n, CP, CP): [u][i][o]
                    int C, int T, int tile, int halo, Units units,
                    int dots_bf16) {
  extern __shared__ __align__(16) float smem[];
  const int L = tile + halo;
  float* V = smem;                // CP x L: the residual stream
  float* A = V + CP * L;          // CP x L: act(V), rounded for the dots
  float* W1 = A + CP * L;         // K x CP x CP
  float* W2 = W1 + K * CP * CP;   // CP x CP

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile - halo;  // time of buffer position 0
  const S* xb = x + (size_t)b * C * T;
  for (int e = threadIdx.x; e < CP * L; e += NTHREADS) {
    const int c = e / L, p = e - c * L, t = t0 + p;
    V[e] = (c < C && t >= 0 && t < T) ? load_f(xb + (size_t)c * T + t) : 0.f;
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int s = 0;  // first buffer position still valid
  for (int u = 0; u < units.n; ++u) {
    const int d = units.dil[u];
    __syncthreads();  // V is complete and the weights are free
    for (int e = threadIdx.x; e < K * CP * CP; e += NTHREADS)
      W1[e] = w1[(size_t)u * K * CP * CP + e];
    for (int e = threadIdx.x; e < CP * CP; e += NTHREADS)
      W2[e] = w2[(size_t)u * CP * CP + e];
    for (int e = threadIdx.x; e < CP * L; e += NTHREADS) {
      if (e % L >= s) {
        const float a = elu(V[e], x);
        A[e] = dots_bf16 ? round_bf16(a) : a;
      }
    }
    __syncthreads();

    const int s_out = s + (K - 1) * d;
    for (int base = s_out + warp * 32 * POS; base < L; base += ROUND) {
      int p[POS];
      bool ok[POS];
#pragma unroll
      for (int j = 0; j < POS; ++j) {
        p[j] = base + lane + 32 * j;
        ok[j] = p[j] < L;
        if (!ok[j]) p[j] = L - 1;  // in bounds; the result is not stored
      }
      float acc[POS][CP];
#pragma unroll
      for (int j = 0; j < POS; ++j)
#pragma unroll
        for (int o = 0; o < CP; ++o) acc[j][o] = 0.f;

      // causal conv, k=7, dilation d: acc[o] += w1[k][i][o] * a[i][p-(6-k)d]
      for (int i = 0; i < CP; ++i) {
        const float* a_row = A + i * L;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int off = (K - 1 - k) * d;
          float a[POS];
#pragma unroll
          for (int j = 0; j < POS; ++j) a[j] = a_row[p[j] - off];
          const float4* wr =
              reinterpret_cast<const float4*>(W1 + (k * CP + i) * CP);
#pragma unroll
          for (int o4 = 0; o4 < CP / 4; ++o4) {
            const float4 w = wr[o4];
#pragma unroll
            for (int j = 0; j < POS; ++j) {
              acc[j][4 * o4 + 0] += a[j] * w.x;
              acc[j][4 * o4 + 1] += a[j] * w.y;
              acc[j][4 * o4 + 2] += a[j] * w.z;
              acc[j][4 * o4 + 3] += a[j] * w.w;
            }
          }
        }
      }

      // 1x1 conv on act(acc), in registers
      float y[POS][CP];
#pragma unroll
      for (int j = 0; j < POS; ++j)
#pragma unroll
        for (int o = 0; o < CP; ++o) y[j][o] = 0.f;
#pragma unroll
      for (int i = 0; i < CP; ++i) {
        float m[POS];
#pragma unroll
        for (int j = 0; j < POS; ++j) {
          const float v = elu(acc[j][i], x);
          m[j] = dots_bf16 ? round_bf16(v) : v;
        }
        const float4* wr = reinterpret_cast<const float4*>(W2 + i * CP);
#pragma unroll
        for (int o4 = 0; o4 < CP / 4; ++o4) {
          const float4 w = wr[o4];
#pragma unroll
          for (int j = 0; j < POS; ++j) {
            y[j][4 * o4 + 0] += m[j] * w.x;
            y[j][4 * o4 + 1] += m[j] * w.y;
            y[j][4 * o4 + 2] += m[j] * w.z;
            y[j][4 * o4 + 3] += m[j] * w.w;
          }
        }
      }

      // residual; in bf16 storage V keeps the f32 sum for the next unit
#pragma unroll
      for (int j = 0; j < POS; ++j) {
        if (!ok[j]) continue;
#pragma unroll
        for (int o = 0; o < CP; ++o) {
          float* vp = V + o * L + p[j];
          *vp = residual(*vp, y[j][o], x);
        }
      }
    }
    s = s_out;
  }
  __syncthreads();

  S* ob = out + (size_t)b * C * T;
  const int t_out = blockIdx.x * tile;
  for (int e = threadIdx.x; e < C * tile; e += NTHREADS) {
    const int c = e / tile, j = e - c * tile, t = t_out + j;
    if (t < T) store_f(ob + (size_t)c * T + t, V[c * L + halo + j]);
  }
}

template <int CP, typename S>
int launch(const void* x, void* out, const void* w1, const void* w2, int B,
           int C, int T, Units units, int dots_bf16, cudaStream_t stream) {
  int halo = 0;
  for (int u = 0; u < units.n; ++u) halo += (K - 1) * units.dil[u];
  // the first unit's conv then covers exactly one pass of the block
  int tile = ROUND - (halo - (K - 1) * units.dil[0]);
  if (tile < 64) tile = 64;
  const int L = tile + halo;
  const int smem = (int)sizeof(float) * (2 * CP * L + K * CP * CP + CP * CP);
  // raise the kernel's dynamic shared memory limit once per device and size
  constexpr int MAX_DEVICES = 64;
  static int granted[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES || smem > granted[dev]) {
    err = cudaFuncSetAttribute(folded_stack_kernel<CP, S>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < MAX_DEVICES) granted[dev] = smem;
  }
  const dim3 grid((T + tile - 1) / tile, B);
  folded_stack_kernel<CP, S><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const S*>(x), static_cast<S*>(out),
      static_cast<const float*>(w1), static_cast<const float*>(w2), C, T, tile,
      halo, units, dots_bf16);
  return (int)cudaGetLastError();
}

template <typename S>
int dispatch(int cp, const void* x, void* out, const void* w1, const void* w2,
             int B, int C, int T, Units units, int dots_bf16,
             cudaStream_t stream) {
  switch (cp) {
    case 4: return launch<4, S>(x, out, w1, w2, B, C, T, units, dots_bf16, stream);
    case 8: return launch<8, S>(x, out, w1, w2, B, C, T, units, dots_bf16, stream);
    case 16: return launch<16, S>(x, out, w1, w2, B, C, T, units, dots_bf16, stream);
    case 32: return launch<32, S>(x, out, w1, w2, B, C, T, units, dots_bf16, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x, out: (B, C, T) contiguous, float32 (storage_bf16 = 0) or bfloat16;
// w1: (n_units, 7, cp, cp) f32 as [u][k][i][o]; w2: (n_units, cp, cp) f32 as
// [u][i][o], both zero-padded from C to cp channels.
extern "C" int folded_stack_forward(const void* x, void* out, const void* w1,
                                    const void* w2, int B, int C, int T,
                                    int cp, int n_units, int d0, int d1,
                                    int d2, int dots_bf16, int storage_bf16,
                                    void* stream) {
  if (n_units < 1 || n_units > MAX_UNITS || C < 1 || C > cp || B < 1 || T < 1)
    return (int)cudaErrorInvalidValue;
  Units units;
  units.n = n_units;
  units.dil[0] = d0;
  units.dil[1] = d1;
  units.dil[2] = d2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (storage_bf16)
    return dispatch<__nv_bfloat16>(cp, x, out, w1, w2, B, C, T, units,
                                   dots_bf16, s);
  return dispatch<float>(cp, x, out, w1, w2, B, C, T, units, dots_bf16, s);
}
