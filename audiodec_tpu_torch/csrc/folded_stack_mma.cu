// The folded residual stack at C <= 32 on the bf16 tensor cores, for Hopper
// (sm_90a), batch mode, in f32 or bf16 storage.
//
// Replaces the TPU kernel audiodec_tpu/ops/pallas/folded_stack.py
// folded_residual_stack (pallas_call at :372) whenever its dot operands are
// rounded to bf16 (`bf16_dots`, or bf16 storage): a chain of units
//
//   v += mask(conv_k2,1(act(mask(conv_k,d(act(v)) + b1))) + b2)
//
// with act ELU or LeakyReLU(slope), any k and k2 (the second conv
// undilated), optional biases, any number of units and dilations, zero left
// context at t=0, and mask() zeroing each conv output at t < 0 when there
// are biases (folded_stack.py:285-291).  The autoencoder units (ELU, k = 7,
// k2 = 1, no biases) and the vocoder units (LeakyReLU, k = k2 in {3, 7,
// 11}, biases) are two of its shapes.  The TPU kernel's fold of time into
// the MXU's 128 lanes is a TPU workaround and is not ported.
//
// Bound on the H100 (bin/kernel_bounds.py): one read and one write of the
// activation against units * (k + k2) * 2 C^2 FLOP per sample on the bf16
// tensor cores.  At (16, 32, 480000): the autoencoder units 0.587 ms in f32
// storage (by bytes) and 0.382 ms in bf16 (by operations); the vocoder
// units at k = 11 in bf16 1.050 ms (by operations).
//
// Design (B4's narrow kernel, csrc/ablate_stack.cu, made general): one
// block per (batch row, time tile) holds the tile and its left halo, the
// sum over units of (k - 1) d + (k2 - 1) samples (78 for the autoencoder,
// 120 for the vocoder at k = 11), zero before t=0, in shared memory; it runs
// every unit there and writes the tile once.  The residual v stays f32 in
// shared memory, time-major (in bf16 storage it is the carried sum s).  Per
// unit:
//   - y1 = bf16(act(v)) is written as rows of CP channels padded to
//     CP + 8 bf16 (80 bytes at CP = 32, 48 at 16), so a warp's fragment
//     loads hit 32 distinct banks;
//   - each warp takes 32 output positions (two m16 tiles) at a time; the
//     first conv is a sum over taps of (16 x CP) @ (CP x CP) mma.sync
//     m16n8k16 products, A fragments from y1 at the tap's shift, B from the
//     unit's weights staged as [tap][c_out][c_in] bf16;
//   - k2 = 1: act(mask(acc + b1)), rounded to bf16, is the 1x1 conv's A
//     operand in registers (the m16n8 accumulator layout of two n-tiles is
//     the m16k16 operand layout), and its result goes into v;
//   - k2 > 1: bf16(act(mask(acc + b1))) goes to a second buffer, which
//     carries its own (k2 - 1)-sample halo; the second conv's weights
//     replace the first's, it reads that buffer at k2 shifts, and
//     mask(+ b2) and the residual follow.
// Each tap's products (CP of them, in CP / 16 chained k-steps) are summed
// from zero and added to the running sum with round-to-nearest f32 adds:
// one accumulator chained through many k-steps drifts from exact sums
// (ROADMAP §C, "Tensor-core sums drift").  Channels are padded to CP in
// {16, 32} with zero weights and biases, so the padded channels stay zero.
// One block of 16 warps per SM, capped at 128 registers a thread, with the
// largest tile that fits the block's 227 KB (ops/kernels/folded_stack.py
// mma_geometry): 896 samples for the autoencoder units, 576 for the vocoder
// units at k = 11.  Two blocks of 8 warps with half the tile ran slower
// (PERF.md §6): the halo is recomputed per tile, and the per-unit syncs
// idle fewer warps in one larger block.
//
// Rounding points (the TPU kernel's and the plain version's,
// ops/kernels/folded_stack.py folded_residual_stack_plain): act in f32,
// ELU as expm1 in f32 storage (F.elu) and as exp(min(v, 0)) - 1 in bf16
// storage; bf16 operands and f32 sums; biases added in f32; the residual the
// TPU statement `v = v + y2.astype(v.dtype)` (:367) as XLA computes it: in
// f32 storage v + y2; in bf16 storage the f32 sum s = bf16(v) + bf16(y2),
// which the next unit's act reads and the output holds rounded to bf16
// (storage_residual).  The weights come rounded to bf16 from the wrapper.
//
// Plain C interface for ctypes: pointers and the stream as void*, ints as
// int, the slope as float; returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_UNITS = 256;
constexpr int MT = 2;                 // m16 tiles per warp step
constexpr int NW = 16;                // warps per block
constexpr int NTHREADS = NW * 32;
constexpr int SMEM_LIMIT = 232448;    // bytes a block may use on sm_90
enum { ELU = 0, LEAKY = 1 };

// the launch's arguments; a __grid_constant__ kernel parameter, so that
// dil[u] is read in place rather than from a per-thread copy
struct Params {
  int C, T, tile, halo, n_units, k, k2, act, has_bias;
  float slope;
  int dil[MAX_UNITS];
};

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

// act in f32: ELU as expm1 in f32 storage, exp(min(v, 0)) - 1 in bf16
template <bool BF16>
__device__ __forceinline__ float activate(float v, int act, float slope) {
  if (act == LEAKY) return v > 0.f ? v : slope * v;
  if (BF16) return v > 0.f ? v : expf(fminf(v, 0.f)) - 1.f;
  return v > 0.f ? v : expm1f(v);
}

// the unit's residual sum from the carried sum v and y2 (see the header)
__device__ __forceinline__ float residual(float v, float y, bool bf16) {
  return bf16 ? round_bf16(v) + round_bf16(y) : v + y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a * b
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c = a * b, summed from zero
__device__ __forceinline__ void mma0(float (&c)[4], const uint32_t (&a)[4],
                                     const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

template <int CP>
__device__ __forceinline__ void zero(float (&c)[MT][CP / 8][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < CP / 8; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) c[m][n][q] = 0.f;
}

// acc += the causal conv of operand A (rows of CP bf16, stride CP + 8) with
// `taps` taps at dilation `dil`, weights W [tap][c_out][c_in] (same row
// stride), at the warp's positions p0 .. p0 + 16 * MT - 1 (rows past L - 1
// read row L - 1; their results are not stored).  Each tap's products are
// summed from zero, then added to acc.
template <int CP>
__device__ __forceinline__ void conv(float (&acc)[MT][CP / 8][4],
                                     const __nv_bfloat16* A,
                                     const __nv_bfloat16* W, int taps,
                                     int dil, int p0, int L, int g, int t) {
  constexpr int RS = CP + 8, KK = CP / 16, NT = CP / 8;
  int ra[MT], rb[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    ra[m] = min(p0 + 16 * m + g, L - 1);
    rb[m] = min(p0 + 16 * m + g + 8, L - 1);
  }
  for (int j = 0; j < taps; ++j) {
    const int off = (taps - 1 - j) * dil;
    uint32_t a[MT][KK][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        const __nv_bfloat16* pa = A + (ra[m] - off) * RS + kk * 16 + 2 * t;
        const __nv_bfloat16* pb = A + (rb[m] - off) * RS + kk * 16 + 2 * t;
        a[m][kk][0] = lds32(pa);
        a[m][kk][1] = lds32(pb);
        a[m][kk][2] = lds32(pa + 8);
        a[m][kk][3] = lds32(pb + 8);
      }
    const __nv_bfloat16* wj = W + j * CP * RS;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t b[KK][2];
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        const __nv_bfloat16* wb = wj + (n * 8 + g) * RS + kk * 16 + 2 * t;
        b[kk][0] = lds32(wb);
        b[kk][1] = lds32(wb + 8);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        float d[4];
        mma0(d, a[m][0], b[0]);
#pragma unroll
        for (int kk = 1; kk < KK; ++kk) mma(d, a[m][kk], b[kk]);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][n][q] += d[q];
      }
    }
  }
}

// copy `rows` rows of CP bf16 from device memory into rows of stride CP + 8
template <int CP>
__device__ __forceinline__ void stage(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src, int rows) {
  constexpr int RS = CP + 8, V = CP / 8;  // 16-byte vectors per row
  for (int e = threadIdx.x; e < rows * V; e += NTHREADS) {
    const int r = e / V, c = e - r * V;
    reinterpret_cast<uint4*>(dst + r * RS)[c] =
        reinterpret_cast<const uint4*>(src + (size_t)r * CP)[c];
  }
}

template <int CP, typename S, bool K2ONE>
__global__ void __launch_bounds__(NTHREADS, 1)
stack_kernel(const S* __restrict__ x, S* __restrict__ out,
             const __nv_bfloat16* __restrict__ w1,  // (n, k, CP, CP)
             const __nv_bfloat16* __restrict__ w2,  // (n, k2, CP, CP)
             const float* __restrict__ bias,        // (n, 2, CP) or null
             const __grid_constant__ Params P) {
  constexpr bool BF16 = sizeof(S) == 2;
  constexpr int RS = CP + 8, VS = CP + 1, NT = CP / 8, KK = CP / 16;
  constexpr int STEP = NW * 16 * MT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = P.tile + P.halo;
  const int wtaps = K2ONE ? P.k + 1 : max(P.k, P.k2);
  __nv_bfloat16* W = reinterpret_cast<__nv_bfloat16*>(smem);  // wtaps*CP x RS
  __nv_bfloat16* Y = W + wtaps * CP * RS;                      // L x RS
  __nv_bfloat16* M = Y + L * RS;              // k2 > 1: L x RS
  float* Bs = reinterpret_cast<float*>(M + (K2ONE ? 0 : L * RS));  // 2 x CP
  float* V = Bs + 2 * CP;                                       // L x VS

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * P.tile - P.halo;  // time of buffer position 0
  const S* xb = x + (size_t)b * P.C * P.T;
  for (int e = threadIdx.x; e < CP * L; e += NTHREADS) {
    const int c = e / L, p = e - c * L, tt = t0 + p;
    V[p * VS + c] = (c < P.C && tt >= 0 && tt < P.T)
                        ? load_f(xb + (size_t)c * P.T + tt) : 0.f;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  int s = 0;  // first buffer position still valid
  for (int u = 0; u < P.n_units; ++u) {
    const int d = P.dil[u];
    __syncthreads();  // v is complete and the weights are free
    stage<CP>(W, w1 + (size_t)u * P.k * CP * CP, P.k * CP);
    if (K2ONE)
      stage<CP>(W + P.k * CP * RS, w2 + (size_t)u * CP * CP, CP);
    if (P.has_bias)
      for (int e = threadIdx.x; e < 2 * CP; e += NTHREADS)
        Bs[e] = bias[u * 2 * CP + e];
    for (int e = threadIdx.x; e < (L - s) * (CP / 2); e += NTHREADS) {
      const int p = s + e / (CP / 2), c = 2 * (e % (CP / 2));
      *reinterpret_cast<uint32_t*>(Y + p * RS + c) =
          pack_bf16(activate<BF16>(V[p * VS + c], P.act, P.slope),
                    activate<BF16>(V[p * VS + c + 1], P.act, P.slope));
    }
    __syncthreads();

    const int s1 = s + (P.k - 1) * d;
    for (int p0 = s1 + warp * 16 * MT; p0 < L; p0 += STEP) {
      float acc[MT][NT][4];
      zero<CP>(acc);
      conv<CP>(acc, Y, W, P.k, d, p0, L, g, t);
      // mask(acc + b1), then act, in place
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float v = acc[m][n][q];
            if (P.has_bias) {
              const int p = p0 + 16 * m + g + 8 * (q >> 1);
              v = t0 + p >= 0 ? v + Bs[n * 8 + 2 * t + (q & 1)] : 0.f;
            }
            acc[m][n][q] = activate<BF16>(v, P.act, P.slope);
          }
      if (K2ONE) {
        // the 1x1 conv on bf16(act(...)) as A fragments in registers
        const __nv_bfloat16* W2 = W + P.k * CP * RS;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          uint32_t a[KK][4];
#pragma unroll
          for (int kk = 0; kk < KK; ++kk) {
            a[kk][0] = pack_bf16(acc[m][2 * kk][0], acc[m][2 * kk][1]);
            a[kk][1] = pack_bf16(acc[m][2 * kk][2], acc[m][2 * kk][3]);
            a[kk][2] = pack_bf16(acc[m][2 * kk + 1][0], acc[m][2 * kk + 1][1]);
            a[kk][3] = pack_bf16(acc[m][2 * kk + 1][2], acc[m][2 * kk + 1][3]);
          }
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            float y2[4];
#pragma unroll
            for (int kk = 0; kk < KK; ++kk) {
              const __nv_bfloat16* wb = W2 + (n * 8 + g) * RS + kk * 16 + 2 * t;
              const uint32_t bb[2] = {lds32(wb), lds32(wb + 8)};
              if (kk == 0)
                mma0(y2, a[0], bb);
              else
                mma(y2, a[kk], bb);
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int p = p0 + 16 * m + g + 8 * (q >> 1);
              const int c = n * 8 + 2 * t + (q & 1);
              if (p < L) {
                float y = y2[q];
                if (P.has_bias) y = t0 + p >= 0 ? y + Bs[CP + c] : 0.f;
                float* vp = V + p * VS + c;
                *vp = residual(*vp, y, BF16);
              }
            }
          }
        }
      } else {
        // bf16(act(...)) into M, the second conv's operand
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = p0 + 16 * m + g + 8 * h;
            if (p < L) {
#pragma unroll
              for (int n = 0; n < NT; ++n)
                *reinterpret_cast<uint32_t*>(M + p * RS + n * 8 + 2 * t) =
                    pack_bf16(acc[m][n][2 * h], acc[m][n][2 * h + 1]);
            }
          }
      }
    }
    if (K2ONE) {
      s = s1;
      continue;
    }

    __syncthreads();  // M is complete and the first conv's weights are free
    stage<CP>(W, w2 + (size_t)u * P.k2 * CP * CP, P.k2 * CP);
    __syncthreads();
    const int s2 = s1 + P.k2 - 1;
    for (int p0 = s2 + warp * 16 * MT; p0 < L; p0 += STEP) {
      float acc[MT][NT][4];
      zero<CP>(acc);
      conv<CP>(acc, M, W, P.k2, 1, p0, L, g, t);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int p = p0 + 16 * m + g + 8 * (q >> 1);
            const int c = n * 8 + 2 * t + (q & 1);
            if (p < L) {
              float y = acc[m][n][q];
              if (P.has_bias) y = t0 + p >= 0 ? y + Bs[CP + c] : 0.f;
              float* vp = V + p * VS + c;
              *vp = residual(*vp, y, BF16);
            }
          }
    }
    s = s2;
  }
  __syncthreads();

  S* ob = out + (size_t)b * P.C * P.T;
  const int t_out = blockIdx.x * P.tile;
  for (int e = threadIdx.x; e < P.C * P.tile; e += NTHREADS) {
    const int c = e / P.tile, j = e - c * P.tile, tt = t_out + j;
    if (tt < P.T)
      store_f(ob + (size_t)c * P.T + tt, V[(P.halo + j) * VS + c]);
  }
}

// shared memory of one block; ops/kernels/folded_stack.py mma_geometry
// states the same sum
int smem_bytes(int cp, int k, int k2, int L) {
  const int rs = cp + 8, vs = cp + 1;
  const int wtaps = k2 == 1 ? k + 1 : (k > k2 ? k : k2);
  return 2 * (wtaps * cp * rs + L * rs * (k2 == 1 ? 1 : 2)) +
         4 * (2 * cp + L * vs);
}

template <int CP, typename S, bool K2ONE>
int launch(const void* x, void* out, const void* w1, const void* w2,
           const void* bias, int B, const Params& P, int smem,
           cudaStream_t stream) {
  auto kernel = stack_kernel<CP, S, K2ONE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((P.T + P.tile - 1) / P.tile, B);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const S*>(x), static_cast<S*>(out),
      static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(bias),
      P);
  return (int)cudaGetLastError();
}

template <typename S>
int dispatch(int cp, bool k2one, const void* x, void* out, const void* w1,
             const void* w2, const void* bias, int B, const Params& P,
             int smem, cudaStream_t stream) {
  if (cp == 16)
    return k2one ? launch<16, S, true>(x, out, w1, w2, bias, B, P, smem, stream)
                 : launch<16, S, false>(x, out, w1, w2, bias, B, P, smem,
                                        stream);
  return k2one ? launch<32, S, true>(x, out, w1, w2, bias, B, P, smem, stream)
               : launch<32, S, false>(x, out, w1, w2, bias, B, P, smem, stream);
}

}  // namespace

// x, out: (B, C, T) contiguous, float32 (storage_bf16 = 0) or bfloat16;
// w1: (n_units, k, cp, cp) and w2: (n_units, k2, cp, cp) bf16 as
// [u][tap][c_out][c_in]; bias: (n_units, 2, cp) f32 or null; dil: n_units
// dilations (host memory); act: 0 ELU, 1 LeakyReLU(slope); tile: output
// samples per block.  Channels C <= cp, zero-padded in the weights and
// biases.
extern "C" int folded_stack_mma_forward(
    const void* x, void* out, const void* w1, const void* w2,
    const void* bias, int B, int C, int T, int cp, int n_units,
    const int* dil, int k, int k2, int act, float slope, int tile,
    int storage_bf16, void* stream) {
  if ((cp != 16 && cp != 32) || C < 1 || C > cp || B < 1 || T < 1 ||
      n_units < 1 || n_units > MAX_UNITS || k < 1 || k2 < 1 ||
      (act != ELU && act != LEAKY) || tile < 16)
    return (int)cudaErrorInvalidValue;
  Params P;
  P.C = C;
  P.T = T;
  P.tile = tile;
  P.n_units = n_units;
  P.k = k;
  P.k2 = k2;
  P.act = act;
  P.slope = slope;
  P.has_bias = bias != nullptr;
  P.halo = 0;
  for (int u = 0; u < n_units; ++u) {
    if (dil[u] < 1) return (int)cudaErrorInvalidValue;
    P.dil[u] = dil[u];
    P.halo += (k - 1) * dil[u] + (k2 - 1);
  }
  const int smem = smem_bytes(cp, k, k2, tile + P.halo);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (storage_bf16)
    return dispatch<__nv_bfloat16>(cp, k2 == 1, x, out, w1, w2, bias, B, P,
                                   smem, s);
  return dispatch<float>(cp, k2 == 1, x, out, w1, w2, bias, B, P, smem, s);
}
