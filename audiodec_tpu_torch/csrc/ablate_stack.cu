// The folded stack's ablation variants on the tensor cores, for Hopper
// (sm_90a), batch mode, at any width and in f32 or bf16 storage.
//
// Replaces the TPU kernel tools/folded_ablate.py build (pallas_call at
// :138): the autoencoder residual stack with bf16 dots, units
// v += conv1x1(ELU(conv_k7_dil_d(ELU(v)))), no biases, zero left context at
// t=0, in five variants that differ in how the k=7 conv's products are
// summed:
//
//   0 default: one accumulator chained through the taps;
//   1 tree:    one partial per tap, added pairwise as the TPU variant adds
//              its per-offset partials: ((p0+p1)+(p2+p3))+((p4+p5)+p6);
//   2 im2col:  the taps' shifted rows copied into one (16, 7*CP) operand in
//              shared memory, then one K = 7 * CP product;
//   3 noelu:   the default without either ELU;
//   4 noshift: every folded offset reads the window's first row.  On the
//              TPU's layout (f = max(1, 128 / C) samples per folded row,
//              span = ceil(6d / f) rows) tap j of output sample t = f*R + p
//              reads sample f*(R - span) + ((p + (j - 6) d) mod f); at f = 1
//              every tap reads sample t - 6d.  The TPU variant multiplies
//              by the folded weights, most of whose blocks are zero; this
//              kernel multiplies the same nonzero blocks, each tap by its
//              own w[j], so it computes the same function.
//
// Rounding points (the TPU kernel's): y1 = bf16(ELU(s)) with ELU computed
// in f32 as exp(min(s, 0)) - 1; the conv's products bf16 x bf16 summed in
// f32; a2 = bf16(ELU(acc)); y2 = a2 @ w2 in f32.  The residual is the
// TPU statement `v = v + y2.astype(v.dtype)` as XLA computes it: in f32
// storage s = v + y2; in bf16 storage s = bf16(v) + bf16(y2) in f32, the
// next unit's ELU reads s, and the stream and the output hold bf16(s)
// (ops/kernels/folded_stack.py storage_residual).  The weights come
// rounded to bf16 from the wrapper.
//
// Bound on the H100 (bin/kernel_bounds.py): one read and one write of the
// activation against 3 * 8 * 2 C^2 FLOP per sample on the bf16 tensor
// cores.  At (16, 32, 480000): f32 1.97 GB, 0.587 ms, by bytes; bf16
// 0.382 ms, by operations.  At the symAD stacks (16, C, T) = (64, 160000),
// (128, 40000), (256, 8000): 0.509 / 0.509 / 0.407 ms, by operations in
// both storages.
//
// Two designs, both mma.sync m16n8k16 with bf16 operands and f32 sums.
//
// C <= 32 (`narrow_kernel`): as csrc/folded_stack.cu, one block per
// (batch row, time tile) holds the tile and its left halo (the sum of the
// units' look-backs, zero before t=0) in shared memory, runs all three
// units there and writes the tile once.  The residual stays f32 in shared
// memory (in bf16 storage it is the carried sum s), time-major; each unit
// first writes y1 as bf16 rows of 32 channels, then each warp takes 16
// output positions at a time: the k=7 conv's A fragments are read from
// y1's rows at the tap's shift and B from the unit's weights, staged per
// unit as [tap][c_out][c_in]; the accumulators become, after ELU and
// rounding, the A fragments of the 1x1 conv in registers (the m16n8
// accumulator layout of two n-tiles is the m16k16 operand layout); its
// result is added to v.  Channels are padded to 32 with zero weights.
// Shared rows are padded to 80 bytes, so a warp's fragment loads hit 32
// distinct banks.  The launch bound caps a thread at 128 registers, so two
// blocks of 256 threads fit an SM in every variant whose shared memory
// allows it (all but im2col).
//
// C > 32 (`wide_kernel`): the three units' weights (up to 2.75 MB at
// C = 256) and a C-wide tile with its halo do not fit one block, so each
// unit is one launch that reads v and writes v; the weights are read from
// L2 through the read-only path.  Channels are padded to CP, a multiple of
// 32, with zero weights.  A block of NW warps owns 16 * NW output samples
// of one batch row: it stages y1 = bf16(ELU(v)) for those samples and the
// unit's look-back (6d, or noshift's f * span + f - 1), all CP channels,
// in shared memory.  Each warp owns 16 samples and walks the output
// channels in groups of 32: the k=7 conv over (tap, 16-channel k-step)
// into 16 x 32 accumulators, summed in the plain version's association
// (default, noelu, noshift: each folded offset's taps apart, the partials
// added in offset order; tree: one partial per tap, added pairwise, which
// at f > 1 groups taps where the TPU variant groups offsets; im2col: one
// sum over K), each mma's 16 products summed from zero and added with
// round-to-nearest f32 adds (mma_add; chained in the tensor cores, a sum
// of 7 * C products drifted twice as far from the exact sum as cuBLAS's
// f32 product at C = 256), then
// a2 = bf16(ELU(acc)) into the warp's own 16 x CP rows of shared memory;
// then the 1x1 conv over those rows, group by group, and the residual in
// the epilogue, which reads v again (L2-hot) and writes the output.  im2col
// first copies its 16 samples' seven shifted rows into one 16 x 7*CP
// operand per warp.  The host picks the largest NW in {8, 4, 2, 1} whose
// shared memory fits the block's 227 KB: at d <= 9 that holds C up to 1312
// (im2col 576).  In bf16 storage the carried sum s crosses the launches in
// f32 buffers from the wrapper (unit 0 reads x, the last unit writes bf16):
// the same choice as the folded stack's wide route (csrc/resunit_stack.cu).
//
// Plain C interface for ctypes: pointers and the stream as void*, ints as
// int; returns the first CUDA error of the launches (cudaGetLastError()
// after each), or cudaErrorInvalidValue for arguments it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K = 7;
constexpr int CP = 32;             // narrow: padded channels
constexpr int RS = CP + 8;         // narrow: bf16 row stride (80 B)
constexpr int VS = CP + 1;         // narrow: f32 row stride of v
constexpr int XS = K * CP + 8;     // narrow: bf16 row stride of im2col rows
constexpr int UNITS = 3;
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int TILE = 320;          // narrow: output samples per block
constexpr int WIDE_GROUP = 32;     // wide: output channels per pass
constexpr int MAX_WIDE_WARPS = 8;
constexpr int SMEM_LIMIT = 232448;  // bytes a block may use on sm_90

enum { DEFAULT = 0, TREE = 1, IM2COL = 2, NOELU = 3, NOSHIFT = 4 };

struct Units {
  int dil[UNITS];
  int look[UNITS];  // samples each unit reads before its output
  int span[UNITS];  // noshift: folded rows back to the window's first row
};

__device__ __forceinline__ float elu(float v) {
  return v > 0.f ? v : expf(fminf(v, 0.f)) - 1.f;
}

template <int VARIANT>
__device__ __forceinline__ float act(float v) {
  return VARIANT == NOELU ? v : elu(v);
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

// the unit's residual sum s from the carried sum v and y2 (see the header)
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

__device__ __forceinline__ uint32_t ldg32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c += a * b, the product summed apart (from zero) and added to c with
// round-to-nearest f32 adds.  The tensor cores' own accumulation of many
// k-steps into one sum drifts from a round-to-nearest f32 sum as the sum
// grows; summed apart, each k-step's 16 products are one short partial.
__device__ __forceinline__ void mma_add(float (&c)[4], uint32_t a0,
                                        uint32_t a1, uint32_t a2, uint32_t a3,
                                        uint32_t b0, uint32_t b1) {
  float d[4];
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "f"(0.f));
#pragma unroll
  for (int q = 0; q < 4; ++q) c[q] += d[q];
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) c[n][q] = 0.f;
}

// floor division and the nonnegative remainder, for a negative n too
__device__ __forceinline__ int fdiv(int n, int f) {
  return n >= 0 ? n / f : -((f - 1 - n) / f);
}
__device__ __forceinline__ int pmod(int n, int f) { return n - f * fdiv(n, f); }

// acc += part and part = 0, row g (fa) and row g + 8 (fb) apart
template <int N>
__device__ __forceinline__ void flush(float (&acc)[N][4], float (&part)[N][4],
                                      bool fa, bool fb) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q < 2 ? fa : fb) {
        acc[n][q] += part[n][q];
        part[n][q] = 0.f;
      }
}

template <int N>
__device__ __forceinline__ void add(float (&c)[N][4], const float (&b)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) c[n][q] += b[n][q];
}

// Narrow: acc += rows ra (lane's row g) and rb (row g + 8) of the operand
// at `a` (row stride `as`, columns col0..col0+31) times tap j's weights,
// staged in shared memory with row stride RS
__device__ __forceinline__ void tap_product(float (&acc)[CP / 8][4],
                                            const __nv_bfloat16* a, int as,
                                            int ra, int rb, int col0,
                                            const __nv_bfloat16* w, int t,
                                            int g) {
#pragma unroll
  for (int kk = 0; kk < CP / 16; ++kk) {
    const int c = col0 + kk * 16 + 2 * t;
    const uint32_t a0 = lds32(a + ra * as + c), a1 = lds32(a + rb * as + c);
    const uint32_t a2 = lds32(a + ra * as + c + 8);
    const uint32_t a3 = lds32(a + rb * as + c + 8);
#pragma unroll
    for (int n = 0; n < CP / 8; ++n) {
      const __nv_bfloat16* wb = w + (n * 8 + g) * RS + kk * 16 + 2 * t;
      mma(acc[n], a0, a1, a2, a3, lds32(wb), lds32(wb + 8));
    }
  }
}

// Wide: acc (16 x WIDE_GROUP) += rows ra, rb of the operand at `a` (row
// stride `as`, columns col0..col0+kc-1) times the weights at `w`, rows of
// kc input channels with row stride `ws`, read through the read-only path
// (w points at the group's first output channel)
__device__ __forceinline__ void wide_product(float (&acc)[WIDE_GROUP / 8][4],
                                             const __nv_bfloat16* a, int as,
                                             int ra, int rb, int col0, int kc,
                                             const __nv_bfloat16* w, int ws,
                                             int t, int g) {
  for (int kk = 0; kk < kc; kk += 16) {
    const int c = col0 + kk + 2 * t;
    const uint32_t a0 = lds32(a + ra * as + c), a1 = lds32(a + rb * as + c);
    const uint32_t a2 = lds32(a + ra * as + c + 8);
    const uint32_t a3 = lds32(a + rb * as + c + 8);
#pragma unroll
    for (int n = 0; n < WIDE_GROUP / 8; ++n) {
      const __nv_bfloat16* wb = w + (n * 8 + g) * ws + kk + 2 * t;
      mma_add(acc[n], a0, a1, a2, a3, ldg32(wb), ldg32(wb + 8));
    }
  }
}

// ---------------------------------------------------------------------------
// C <= 32: the whole stack in one launch
// ---------------------------------------------------------------------------

template <int VARIANT, typename S>
__global__ void __launch_bounds__(NTHREADS, 2)
narrow_kernel(const S* __restrict__ x, S* __restrict__ out,
              const __nv_bfloat16* __restrict__ w1,  // (3, K, CP, CP)
              const __nv_bfloat16* __restrict__ w2,  // (3, CP, CP)
              int C, int T, int halo, int fold, Units units) {
  constexpr bool BF16 = sizeof(S) == 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = TILE + halo;
  __nv_bfloat16* W1 = reinterpret_cast<__nv_bfloat16*>(smem);  // K*CP x RS
  __nv_bfloat16* W2 = W1 + K * CP * RS;                         // CP x RS
  __nv_bfloat16* Y = W2 + CP * RS;                              // L x RS
  __nv_bfloat16* X = Y + L * RS;  // im2col: NWARPS x 16 x XS
  float* V = reinterpret_cast<float*>(
      X + (VARIANT == IM2COL ? NWARPS * 16 * XS : 0));          // L x VS

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TILE - halo;  // time of buffer position 0
  const S* xb = x + (size_t)b * C * T;
  for (int e = threadIdx.x; e < CP * L; e += NTHREADS) {
    const int c = e / L, p = e - c * L, t = t0 + p;
    V[p * VS + c] =
        (c < C && t >= 0 && t < T) ? load_f(xb + (size_t)c * T + t) : 0.f;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  int s = 0;  // first buffer position still valid
  for (int u = 0; u < UNITS; ++u) {
    const int d = units.dil[u];
    __syncthreads();  // v is complete and the weights are free
    for (int e = threadIdx.x; e < K * CP * CP / 8; e += NTHREADS) {
      const int r = e / (CP / 8), c = e % (CP / 8);
      reinterpret_cast<uint4*>(W1 + r * RS)[c] =
          reinterpret_cast<const uint4*>(w1 + ((size_t)u * K * CP + r) * CP)[c];
    }
    for (int e = threadIdx.x; e < CP * CP / 8; e += NTHREADS) {
      const int r = e / (CP / 8), c = e % (CP / 8);
      reinterpret_cast<uint4*>(W2 + r * RS)[c] =
          reinterpret_cast<const uint4*>(w2 + ((size_t)u * CP + r) * CP)[c];
    }
    for (int e = threadIdx.x; e < (L - s) * CP; e += NTHREADS) {
      const int p = s + e / CP, c = e % CP;
      Y[p * RS + c] = __float2bfloat16_rn(act<VARIANT>(V[p * VS + c]));
    }
    __syncthreads();

    const int s_out = s + units.look[u];
    for (int p0 = s_out + warp * 16; p0 < L; p0 += NWARPS * 16) {
      const int ra = min(p0 + g, L - 1), rb = min(p0 + g + 8, L - 1);
      float acc[CP / 8][4];
      zero(acc);
      if (VARIANT == DEFAULT || VARIANT == NOELU) {
#pragma unroll
        for (int j = 0; j < K; ++j)
          tap_product(acc, Y, RS, ra - (K - 1 - j) * d, rb - (K - 1 - j) * d,
                      0, W1 + j * CP * RS, t, g);
      } else if (VARIANT == NOSHIFT) {
        // absolute times of the lane's two rows, their phase in the fold
        // and the window's first row, all in samples
        const int ta = t0 + ra, tb = t0 + rb;
        const int pa = ((ta % fold) + fold) % fold;
        const int pb = ((tb % fold) + fold) % fold;
        const int ba = ra - pa - fold * units.span[u];
        const int bb = rb - pb - fold * units.span[u];
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const int sh = (j - (K - 1)) * d;
          const int ga = (((pa + sh) % fold) + fold) % fold;
          const int gb = (((pb + sh) % fold) + fold) % fold;
          tap_product(acc, Y, RS, ba + ga, bb + gb, 0, W1 + j * CP * RS, t,
                      g);
        }
      } else if (VARIANT == TREE) {
        float s01[CP / 8][4], part[CP / 8][4], s45[CP / 8][4];
        zero(s01);
        tap_product(s01, Y, RS, ra - 6 * d, rb - 6 * d, 0, W1, t, g);
        zero(part);
        tap_product(part, Y, RS, ra - 5 * d, rb - 5 * d, 0, W1 + CP * RS, t,
                    g);
        add(s01, part);
        tap_product(acc, Y, RS, ra - 4 * d, rb - 4 * d, 0, W1 + 2 * CP * RS,
                    t, g);
        zero(part);
        tap_product(part, Y, RS, ra - 3 * d, rb - 3 * d, 0, W1 + 3 * CP * RS,
                    t, g);
        add(acc, part);   // p2 + p3
        add(s01, acc);    // (p0 + p1) + (p2 + p3)
        zero(s45);
        tap_product(s45, Y, RS, ra - 2 * d, rb - 2 * d, 0, W1 + 4 * CP * RS,
                    t, g);
        zero(part);
        tap_product(part, Y, RS, ra - d, rb - d, 0, W1 + 5 * CP * RS, t, g);
        add(s45, part);   // p4 + p5
        zero(part);
        tap_product(part, Y, RS, ra, rb, 0, W1 + 6 * CP * RS, t, g);
        add(s45, part);   // (p4 + p5) + p6
        zero(acc);
        add(acc, s01);
        add(acc, s45);
      } else {  // IM2COL
        __nv_bfloat16* xw = X + warp * 16 * XS;
        __syncwarp();  // the previous positions' reads are done
        for (int e = lane; e < 16 * K * (CP / 8); e += 32) {
          const int r = e / (K * CP / 8), q = e % (K * CP / 8);
          const int j = q / (CP / 8), c = q % (CP / 8);
          const int p = min(p0 + r, L - 1) - (K - 1 - j) * d;
          reinterpret_cast<uint4*>(xw + r * XS + j * CP)[c] =
              reinterpret_cast<const uint4*>(Y + p * RS)[c];
        }
        __syncwarp();
#pragma unroll
        for (int j = 0; j < K; ++j)
          tap_product(acc, xw, XS, g, g + 8, j * CP, W1 + j * CP * RS, t, g);
      }

      // a2 = bf16(ELU(acc)) as the 1x1 conv's A fragments, in registers
      float y2[CP / 8][4];
      zero(y2);
#pragma unroll
      for (int kk = 0; kk < CP / 16; ++kk) {
        float m[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int q = 0; q < 4; ++q) m[h][q] = act<VARIANT>(acc[2 * kk + h][q]);
        const uint32_t a0 = pack_bf16(m[0][0], m[0][1]);
        const uint32_t a1 = pack_bf16(m[0][2], m[0][3]);
        const uint32_t a2 = pack_bf16(m[1][0], m[1][1]);
        const uint32_t a3 = pack_bf16(m[1][2], m[1][3]);
#pragma unroll
        for (int n = 0; n < CP / 8; ++n) {
          const __nv_bfloat16* wb = W2 + (n * 8 + g) * RS + kk * 16 + 2 * t;
          mma(y2[n], a0, a1, a2, a3, lds32(wb), lds32(wb + 8));
        }
      }
#pragma unroll
      for (int n = 0; n < CP / 8; ++n) {
        const int c = n * 8 + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = p0 + g + 8 * h;
          if (p < L) {
            float* vp = V + p * VS + c;
            vp[0] = residual(vp[0], y2[n][2 * h], BF16);
            vp[1] = residual(vp[1], y2[n][2 * h + 1], BF16);
          }
        }
      }
    }
    s = s_out;
  }
  __syncthreads();

  S* ob = out + (size_t)b * C * T;
  const int t_out = blockIdx.x * TILE;
  for (int e = threadIdx.x; e < C * TILE; e += NTHREADS) {
    const int c = e / TILE, j = e - c * TILE, tt = t_out + j;
    if (tt < T) store_f(ob + (size_t)c * T + tt, V[(halo + j) * VS + c]);
  }
}

template <int VARIANT, typename S>
int launch_narrow(const void* x, void* out, const __nv_bfloat16* w1,
                  const __nv_bfloat16* w2, int B, int C, int T, int fold,
                  Units units, cudaStream_t stream) {
  const int halo = units.look[0] + units.look[1] + units.look[2];
  const int L = TILE + halo;
  const int smem =
      (int)sizeof(__nv_bfloat16) *
          ((K * CP + CP + L) * RS + (VARIANT == IM2COL ? NWARPS * 16 * XS : 0)) +
      (int)sizeof(float) * L * VS;
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      narrow_kernel<VARIANT, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + TILE - 1) / TILE, B);
  narrow_kernel<VARIANT, S><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const S*>(x), static_cast<S*>(out), w1, w2, C, T, halo,
      fold, units);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// C > 32: one launch per unit
// ---------------------------------------------------------------------------

struct Wide {
  int C, CP, T, d, fold, span, look;
  int in_bf16, out_bf16, round_res;  // storage of in and out; bf16 residual
};

__device__ __forceinline__ float load_any(const void* p, size_t i, int bf16) {
  return bf16 ? load_f(static_cast<const __nv_bfloat16*>(p) + i)
              : load_f(static_cast<const float*>(p) + i);
}

template <int VARIANT>
__global__ void __launch_bounds__(MAX_WIDE_WARPS * 32)
wide_kernel(const void* __restrict__ in, void* __restrict__ out,
            const __nv_bfloat16* __restrict__ w1,  // (K, cp, cp) [j][o][i]
            const __nv_bfloat16* __restrict__ w2,  // (cp, cp) [o][i]
            Wide a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nw = blockDim.x >> 5, bt = 16 * nw;
  const int L = bt + a.look;     // staged rows: look-back, then the tile
  const int rs = a.CP + 8;       // bf16 row stride (conflict-free frags)
  const int xs = K * a.CP + 8;   // im2col row stride
  __nv_bfloat16* Y = reinterpret_cast<__nv_bfloat16*>(smem);  // L x rs
  __nv_bfloat16* A2 = Y + L * rs;                              // nw x 16 x rs
  __nv_bfloat16* X = A2 + nw * 16 * rs;                        // nw x 16 x xs

  const int b = blockIdx.y, t0 = blockIdx.x * bt;
  const size_t base = (size_t)b * a.C * a.T;
  for (int e = threadIdx.x; e < a.CP * L; e += blockDim.x) {
    const int c = e / L, q = e - c * L, t = t0 - a.look + q;
    const float v = (c < a.C && t >= 0 && t < a.T)
                        ? load_any(in, base + (size_t)c * a.T + t, a.in_bf16)
                        : 0.f;
    Y[q * rs + c] = __float2bfloat16_rn(act<VARIANT>(v));
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int d = a.d, cp = a.CP;
  const int ra = a.look + warp * 16 + g, rb = ra + 8;  // rows in Y
  __nv_bfloat16* a2 = A2 + warp * 16 * rs;
  __nv_bfloat16* xw = X + warp * 16 * xs;
  if (VARIANT == IM2COL) {
    for (int e = lane; e < 16 * K * (cp / 8); e += 32) {
      const int r = e / (K * cp / 8), q = e % (K * cp / 8);
      const int j = q / (cp / 8), c = q % (cp / 8);
      const int p = a.look + warp * 16 + r - (K - 1 - j) * d;
      reinterpret_cast<uint4*>(xw + r * xs + j * cp)[c] =
          reinterpret_cast<const uint4*>(Y + p * rs)[c];
    }
    __syncwarp();
  }
  // the rows' phases in the TPU's fold: which folded offset each tap lands
  // on, and noshift's reads
  const int pa = (t0 + warp * 16 + g) % a.fold;
  const int pb = (t0 + warp * 16 + g + 8) % a.fold;

  for (int og = 0; og < cp; og += WIDE_GROUP) {
    float acc[WIDE_GROUP / 8][4];
    zero(acc);
    const __nv_bfloat16* wg = w1 + (size_t)og * cp;
    const size_t tap = (size_t)cp * cp;
    if (VARIANT == DEFAULT || VARIANT == NOELU || VARIANT == NOSHIFT) {
      // each folded offset's taps summed apart, the offsets' partials added
      // in order, as the plain version (and the TPU variant) sums: a row's
      // partial goes into acc where its next tap lands on another offset
      float part[WIDE_GROUP / 8][4];
      zero(part);
      const int ba = ra - pa - a.fold * a.span;
      const int bb = rb - pb - a.fold * a.span;
      for (int j = 0; j < K; ++j) {
        const int sh = (j - (K - 1)) * d;
        if (VARIANT == NOSHIFT)
          wide_product(part, Y, rs, ba + pmod(pa + sh, a.fold),
                       bb + pmod(pb + sh, a.fold), 0, cp, wg + j * tap, cp,
                       tq, g);
        else
          wide_product(part, Y, rs, ra + sh, rb + sh, 0, cp, wg + j * tap, cp,
                       tq, g);
        const bool last = j == K - 1;
        flush(acc, part,
              last || fdiv(pa + sh + d, a.fold) != fdiv(pa + sh, a.fold),
              last || fdiv(pb + sh + d, a.fold) != fdiv(pb + sh, a.fold));
      }
    } else if (VARIANT == TREE) {
      float s01[WIDE_GROUP / 8][4], part[WIDE_GROUP / 8][4];
      float s45[WIDE_GROUP / 8][4];
#define TAP(dst, j)                                                        \
  wide_product(dst, Y, rs, ra - (K - 1 - (j)) * d, rb - (K - 1 - (j)) * d, \
               0, cp, wg + (j) * tap, cp, tq, g)
      zero(s01);
      TAP(s01, 0);
      zero(part);
      TAP(part, 1);
      add(s01, part);   // p0 + p1
      TAP(acc, 2);
      zero(part);
      TAP(part, 3);
      add(acc, part);   // p2 + p3
      add(s01, acc);    // (p0 + p1) + (p2 + p3)
      zero(s45);
      TAP(s45, 4);
      zero(part);
      TAP(part, 5);
      add(s45, part);   // p4 + p5
      zero(part);
      TAP(part, 6);
      add(s45, part);   // (p4 + p5) + p6
#undef TAP
      zero(acc);
      add(acc, s01);
      add(acc, s45);
    } else {  // IM2COL: one product over K = 7 * cp
      for (int j = 0; j < K; ++j)
        wide_product(acc, xw, xs, g, g + 8, j * cp, cp, wg + j * tap, cp, tq,
                     g);
    }
    // a2 = bf16(ELU(acc)) into the warp's rows
#pragma unroll
    for (int n = 0; n < WIDE_GROUP / 8; ++n) {
      const int c = og + n * 8 + 2 * tq;
      *reinterpret_cast<uint32_t*>(a2 + g * rs + c) =
          pack_bf16(act<VARIANT>(acc[n][0]), act<VARIANT>(acc[n][1]));
      *reinterpret_cast<uint32_t*>(a2 + (g + 8) * rs + c) =
          pack_bf16(act<VARIANT>(acc[n][2]), act<VARIANT>(acc[n][3]));
    }
  }
  __syncwarp();

  for (int og = 0; og < cp; og += WIDE_GROUP) {
    float y2[WIDE_GROUP / 8][4];
    zero(y2);
    wide_product(y2, a2, rs, g, g + 8, 0, cp, w2 + (size_t)og * cp, cp, tq, g);
#pragma unroll
    for (int n = 0; n < WIDE_GROUP / 8; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = og + n * 8 + 2 * tq + (q & 1);
        const int t = t0 + warp * 16 + g + 8 * (q >> 1);
        if (c >= a.C || t >= a.T) continue;
        const size_t i = base + (size_t)c * a.T + t;
        const float s = residual(load_any(in, i, a.in_bf16), y2[n][q],
                                 a.round_res);
        if (a.out_bf16)
          store_f(static_cast<__nv_bfloat16*>(out) + i, s);
        else
          store_f(static_cast<float*>(out) + i, s);
      }
  }
}

// shared memory of a wide block of nw warps
size_t wide_smem(int variant, int nw, int cp, int look) {
  const size_t rows = (size_t)(16 * nw + look) * (cp + 8) +
                      (size_t)nw * 16 * (cp + 8) +
                      (variant == IM2COL ? (size_t)nw * 16 * (K * cp + 8) : 0);
  return rows * sizeof(__nv_bfloat16);
}

template <int VARIANT>
int launch_wide(const void* in, void* out, const __nv_bfloat16* w1,
                const __nv_bfloat16* w2, int B, const Wide& a,
                cudaStream_t stream) {
  int nw = MAX_WIDE_WARPS;
  while (nw > 1 && wide_smem(VARIANT, nw, a.CP, a.look) > SMEM_LIMIT) nw /= 2;
  const size_t smem = wide_smem(VARIANT, nw, a.CP, a.look);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      wide_kernel<VARIANT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.T + 16 * nw - 1) / (16 * nw), B);
  wide_kernel<VARIANT><<<grid, 32 * nw, smem, stream>>>(in, out, w1, w2, a);
  return (int)cudaGetLastError();
}

int wide_unit(int variant, const void* in, void* out, const __nv_bfloat16* w1,
              const __nv_bfloat16* w2, int B, const Wide& a, cudaStream_t s) {
  switch (variant) {
    case DEFAULT: return launch_wide<DEFAULT>(in, out, w1, w2, B, a, s);
    case TREE: return launch_wide<TREE>(in, out, w1, w2, B, a, s);
    case IM2COL: return launch_wide<IM2COL>(in, out, w1, w2, B, a, s);
    case NOELU: return launch_wide<NOELU>(in, out, w1, w2, B, a, s);
    case NOSHIFT: return launch_wide<NOSHIFT>(in, out, w1, w2, B, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename S>
int narrow(int variant, const void* x, void* out, const __nv_bfloat16* w1,
           const __nv_bfloat16* w2, int B, int C, int T, int fold,
           Units units, cudaStream_t s) {
  switch (variant) {
    case DEFAULT:
      return launch_narrow<DEFAULT, S>(x, out, w1, w2, B, C, T, fold, units, s);
    case TREE:
      return launch_narrow<TREE, S>(x, out, w1, w2, B, C, T, fold, units, s);
    case IM2COL:
      return launch_narrow<IM2COL, S>(x, out, w1, w2, B, C, T, fold, units, s);
    case NOELU:
      return launch_narrow<NOELU, S>(x, out, w1, w2, B, C, T, fold, units, s);
    case NOSHIFT:
      return launch_narrow<NOSHIFT, S>(x, out, w1, w2, B, C, T, fold, units,
                                       s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x, out: (B, C, T) contiguous, float32 (storage_bf16 = 0) or bfloat16;
// fold = max(1, 128 / C); variant as above; cp = 32 for C <= 32, else C
// rounded up to a multiple of 32; w1: (3, 7, cp, cp) bf16 as
// [u][tap][c_out][c_in]; w2: (3, cp, cp) bf16 as [u][c_out][c_in], both
// zero-padded from C to cp channels.  C > 32 runs one launch per unit
// through `scratch`, two (B, C, T) float32 buffers, which carry the
// residual between the units (unused at C <= 32).
extern "C" int ablate_stack_forward(const void* x, void* out, const void* w1,
                                    const void* w2, void* scratch, int B,
                                    int C, int T, int cp, int fold, int d0,
                                    int d1, int d2, int variant,
                                    int storage_bf16, void* stream) {
  if (B < 1 || C < 1 || T < 1 || fold < 1 || d0 < 1 || d1 < 1 || d2 < 1 ||
      variant < DEFAULT || variant > NOSHIFT ||
      cp != (C <= CP ? CP : (C + 31) / 32 * 32))
    return (int)cudaErrorInvalidValue;
  Units units;
  const int dil[UNITS] = {d0, d1, d2};
  for (int u = 0; u < UNITS; ++u) {
    const int d = dil[u], span = (6 * d + fold - 1) / fold;
    units.dil[u] = d;
    units.span[u] = span;
    // noshift reads up to fold * span + fold - 1 samples back
    units.look[u] = variant == NOSHIFT ? fold * span + fold - 1 : 6 * d;
  }
  const __nv_bfloat16* a = static_cast<const __nv_bfloat16*>(w1);
  const __nv_bfloat16* c = static_cast<const __nv_bfloat16*>(w2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= CP) {
    if (storage_bf16)
      return narrow<__nv_bfloat16>(variant, x, out, a, c, B, C, T, fold,
                                   units, s);
    return narrow<float>(variant, x, out, a, c, B, C, T, fold, units, s);
  }
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  float* buf[2] = {static_cast<float*>(scratch),
                   static_cast<float*>(scratch) + (size_t)B * C * T};
  const void* src = x;
  for (int u = 0; u < UNITS; ++u) {
    const bool last = u == UNITS - 1;
    void* dst = last ? out : static_cast<void*>(buf[u % 2]);
    const Wide args = {C, cp, T, units.dil[u], fold, units.span[u],
                       units.look[u], u == 0 ? storage_bf16 : 0,
                       last ? storage_bf16 : 0, storage_bf16};
    const int err = wide_unit(variant, src, dst, a + (size_t)u * K * cp * cp,
                              c + (size_t)u * cp * cp, B, args, s);
    if (err != 0) return err;
    src = dst;
  }
  return 0;
}
