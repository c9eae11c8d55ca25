// The folded stack's ablation variants on the tensor cores, for Hopper
// (sm_90a), batch mode.
//
// Replaces the TPU kernel tools/folded_ablate.py build (pallas_call at
// :138): the C <= 32 autoencoder residual stack with bf16 dots, three
// units v += conv1x1(ELU(conv_k7_dil_d(ELU(v)))), no biases, f32 storage,
// zero left context at t=0, in five variants that differ in how the k=7
// conv's products are summed:
//
//   0 default: one accumulator chained through the taps;
//   1 tree:    one partial per tap, added pairwise as the TPU variant adds
//              its per-offset partials: ((p0+p1)+(p2+p3))+((p4+p5)+p6);
//   2 im2col:  the taps' shifted rows copied into one (16, 7*32) operand in
//              shared memory, then one K = 224 product (14 k-steps);
//   3 noelu:   the default without either ELU;
//   4 noshift: every folded offset reads the window's first row.  On the
//              TPU's layout (f = 128 / C samples per folded row, span =
//              ceil(6d / f) rows) tap j of output sample t = f*R + p reads
//              sample f*(R - span) + ((p + (j - 6) d) mod f).  The TPU
//              variant multiplies by the folded weights, of which 3/4 of
//              the blocks are zero and which take 416 KiB at d = 9, over a
//              block's shared memory; this kernel multiplies the same
//              nonzero blocks, each tap by its own w[j], so it computes
//              the same function.
//
// Rounding points (the TPU kernel's): y1 = bf16(ELU(v)) with ELU computed
// in f32 as exp(min(v, 0)) - 1; the conv's products bf16 x bf16 summed in
// f32; a2 = bf16(ELU(acc)); y2 = a2 @ w2 in f32; v = v + y2 in f32.  The
// weights come rounded to bf16 from the wrapper.
//
// Bound on the H100 at (16, 32, 480000): one read and one write of the f32
// activation, 1.97 GB, 0.587 ms at 3.35 TB/s, against 3.8e11 FLOP on the
// bf16 tensor cores, 0.382 ms: bound by bytes (bin/kernel_bounds.py).
//
// Design: as csrc/folded_stack.cu, one block per (batch row, time tile)
// holds the tile and its left halo (the sum of the units' look-backs, zero
// before t=0) in shared memory, runs all three units there and writes the
// tile once.  The residual v stays f32, time-major; each unit first writes
// y1 as bf16 rows of 32 channels, then each warp takes 16 output positions
// at a time: the k=7 conv is mma.sync m16n8k16 (bf16 in, f32 sums) with A
// fragments read from y1's rows at the tap's shift and B from the unit's
// weights, staged per unit as [tap][c_out][c_in]; the accumulators become,
// after ELU and rounding, the A fragments of the 1x1 conv in registers (the
// m16n8 accumulator layout of two n-tiles is the m16k16 operand layout);
// its result is added to v.  Channels are padded to 32 with zero weights.
// Shared rows are padded to 80 bytes, so a warp's fragment loads hit 32
// distinct banks.  The launch bound caps a thread at 128 registers, so two
// blocks of 256 threads fit an SM in every variant whose shared memory
// allows it (all but im2col): uncapped, tree took 157 and ran 1.6x slower.
//
// Plain C interface for ctypes: pointers and the stream as void*, ints as
// int; returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K = 7;
constexpr int CP = 32;             // padded channels
constexpr int RS = CP + 8;         // bf16 row stride in shared memory (80 B)
constexpr int VS = CP + 1;         // f32 row stride of v
constexpr int XS = K * CP + 8;     // bf16 row stride of the im2col operand
constexpr int UNITS = 3;
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int TILE = 320;          // output samples per block

enum { DEFAULT = 0, TREE = 1, IM2COL = 2, NOELU = 3, NOSHIFT = 4 };

struct Units {
  int dil[UNITS];
  int look[UNITS];  // samples each unit reads before its output
  int span[UNITS];  // noshift: folded rows back to the window's first row
};

__device__ __forceinline__ float elu(float v) {
  return v > 0.f ? v : expf(fminf(v, 0.f)) - 1.f;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

__device__ __forceinline__ void zero(float (&c)[CP / 8][4]) {
#pragma unroll
  for (int n = 0; n < CP / 8; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) c[n][q] = 0.f;
}

__device__ __forceinline__ void add(float (&c)[CP / 8][4],
                                    const float (&b)[CP / 8][4]) {
#pragma unroll
  for (int n = 0; n < CP / 8; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) c[n][q] += b[n][q];
}

// acc += rows ra (lane's row g) and rb (row g + 8) of the operand at `a`
// (row stride `as`, columns col0..col0+31) times tap j's weights
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

template <int VARIANT>
__global__ void __launch_bounds__(NTHREADS, 2)
ablate_stack_kernel(const float* __restrict__ x, float* __restrict__ out,
                    const __nv_bfloat16* __restrict__ w1,  // (3, K, CP, CP)
                    const __nv_bfloat16* __restrict__ w2,  // (3, CP, CP)
                    int C, int T, int halo, int fold, Units units) {
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
  const float* xb = x + (size_t)b * C * T;
  for (int e = threadIdx.x; e < CP * L; e += NTHREADS) {
    const int c = e / L, p = e - c * L, t = t0 + p;
    V[p * VS + c] =
        (c < C && t >= 0 && t < T) ? xb[(size_t)c * T + t] : 0.f;
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
      const float v = V[p * VS + c];
      Y[p * RS + c] = __float2bfloat16_rn(VARIANT == NOELU ? v : elu(v));
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
          for (int q = 0; q < 4; ++q) {
            const float v = acc[2 * kk + h][q];
            m[h][q] = VARIANT == NOELU ? v : elu(v);
          }
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
        if (p0 + g < L) {
          V[(p0 + g) * VS + c] += y2[n][0];
          V[(p0 + g) * VS + c + 1] += y2[n][1];
        }
        if (p0 + g + 8 < L) {
          V[(p0 + g + 8) * VS + c] += y2[n][2];
          V[(p0 + g + 8) * VS + c + 1] += y2[n][3];
        }
      }
    }
    s = s_out;
  }
  __syncthreads();

  float* ob = out + (size_t)b * C * T;
  const int t_out = blockIdx.x * TILE;
  for (int e = threadIdx.x; e < C * TILE; e += NTHREADS) {
    const int c = e / TILE, j = e - c * TILE, tt = t_out + j;
    if (tt < T) ob[(size_t)c * T + tt] = V[(halo + j) * VS + c];
  }
}

template <int VARIANT>
int launch(const float* x, float* out, const __nv_bfloat16* w1,
           const __nv_bfloat16* w2, int B, int C, int T, int fold,
           Units units, cudaStream_t stream) {
  const int halo = units.look[0] + units.look[1] + units.look[2];
  const int L = TILE + halo;
  const int smem =
      (int)sizeof(__nv_bfloat16) *
          ((K * CP + CP + L) * RS + (VARIANT == IM2COL ? NWARPS * 16 * XS : 0)) +
      (int)sizeof(float) * L * VS;
  cudaError_t err = cudaFuncSetAttribute(
      ablate_stack_kernel<VARIANT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + TILE - 1) / TILE, B);
  ablate_stack_kernel<VARIANT><<<grid, NTHREADS, smem, stream>>>(
      x, out, w1, w2, C, T, halo, fold, units);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: (B, C, T) float32, contiguous, C <= 32; w1: (3, 7, 32, 32) bf16
// as [u][tap][c_out][c_in]; w2: (3, 32, 32) bf16 as [u][c_out][c_in], both
// zero-padded from C to 32 channels; fold = max(1, 128 / C); variant as
// above.
extern "C" int ablate_stack_forward(const void* x, void* out, const void* w1,
                                    const void* w2, int B, int C, int T,
                                    int fold, int d0, int d1, int d2,
                                    int variant, void* stream) {
  if (B < 1 || C < 1 || C > CP || T < 1 || fold < 1 || d0 < 1 || d1 < 1 ||
      d2 < 1)
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
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(out);
  const __nv_bfloat16* a = static_cast<const __nv_bfloat16*>(w1);
  const __nv_bfloat16* c = static_cast<const __nv_bfloat16*>(w2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case DEFAULT: return launch<DEFAULT>(xp, op, a, c, B, C, T, fold, units, s);
    case TREE: return launch<TREE>(xp, op, a, c, B, C, T, fold, units, s);
    case IM2COL: return launch<IM2COL>(xp, op, a, c, B, C, T, fold, units, s);
    case NOELU: return launch<NOELU>(xp, op, a, c, B, C, T, fold, units, s);
    case NOSHIFT: return launch<NOSHIFT>(xp, op, a, c, B, C, T, fold, units, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
