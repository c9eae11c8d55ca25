// The folded stack's ablation variants on the tensor cores, for Hopper
// (sm_90a), batch mode, at any width and in f32 or bf16 storage.
//
// Replaces the TPU kernel tools/folded_ablate.py build (pallas_call at
// :138): the autoencoder residual stack with bf16 dots, units
// v += conv1x1(ELU(conv_k7_dil_d(ELU(v)))), no biases, zero left context at
// t=0, in five variants that differ in how the k=7 conv's products are
// summed:
//
//   0 default: the taps in sequence;
//   1 tree:    one partial per tap, added pairwise as the TPU variant adds
//              its per-offset partials: ((p0+p1)+(p2+p3))+((p4+p5)+p6);
//   2 im2col:  one product over K = 7 * CP.  The TPU variant copies the
//              taps' shifted rows into one operand (a Mosaic workaround);
//              here the operand is read from the staged rows at each tap's
//              shift, which gives the same operand;
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
// both storages.  What holds the kernel back is feeding the tensor cores
// (fragment loads from shared memory per mma) and restaging the halo,
// not the device memory.
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
// blocks of 256 threads fit an SM.  im2col's one sum over K is the default's
// chain over (tap, k-step), so the two run the same code.
//
// C > 32 (`wide_kernel`): the three units' weights (up to 2.75 MB at
// C = 256) and a C-wide tile with its halo do not fit one block, so each
// unit is one launch that reads v and writes v, on the design of
// csrc/wide_stack_mma.cu (the staging, the weight ring and a warp's
// product over a stage are shared, wide_mma.cuh).
// Channels are padded to CP, a multiple of 32, with zero weights.  A block
// of wm x wn warps owns `rows` = 16 MTW wm output samples of one batch row:
//   - Y = bf16(ELU(v)) for those samples and the unit's look-back (6d, or
//     noshift's f * span + f - 1) is staged once, time-major, in rows of
//     CP + 8 bf16 (the pad puts an `ldmatrix`'s eight rows in distinct
//     banks), a thread's loads issued before any of its stores;
//   - the weights, packed [tap][c_out][c_in] bf16, stream through a ring of
//     2 or 3 `cp.async` stages shared by the block, one stage per (tap, kc
//     input channels) of a pass's output channels, the next stages' copies
//     in flight while a stage's products run;
//   - warp (i, j) owns MTW m16 tiles (16 MTW samples) x 32 output channels,
//     so each B fragment feeds MTW products; A and B fragments come from
//     `ldmatrix`, A read from Y at each tap's shift (noshift: at its rows'
//     reads, a row address per lane);
//   - where CP / 32 exceeds the wn warps along the channels, the block
//     walks the channels in passes of 32 wn (as csrc/int8_tile_mma.cu), and
//     a2 goes to its own rows; otherwise a2 = bf16(ELU(acc)) replaces Y;
//   - the epilogue transposes each m16 tile's 4 x 4 lane blocks with
//     shuffles, so a lane holds 4 consecutive samples of one channel, and
//     reads the residual and stores the output 16 bytes at a time (f32;
//     8 in bf16) where T is a multiple of 4.
// The k=7 conv's products are summed in the plain version's association
// (default, noelu, noshift: each folded offset's taps apart, the partials
// added in offset order; tree: one partial per tap, added pairwise, which
// at f > 1 groups taps where the TPU variant groups offsets; im2col: one
// sum over K), each mma's 16 products summed from zero and added with
// round-to-nearest f32 adds (mma_add; chained in the tensor cores, a sum of
// 7 * C products drifted twice as far from the exact sum as cuBLAS's f32
// product at C = 256).  A variant holds MTW x 16 sums a thread per register
// set (im2col one, default, noelu and noshift two, tree three): up to 64
// sums a block takes 16 warps at 128 registers a thread, above it 8 warps
// at 255.  What bounds the kernel is the shared memory's bandwidth for the
// fragment loads: 0.375 `ldmatrix` per mma at MTW = 4, 0.5 at MTW = 2,
// where the default variant's second set holds it at 16 warps.
// ops/kernels/ablate_stack.py ablate_wide_geometry picks MTW (by variant,
// the fastest on the card), wm, wn, kc and the buffers (this file's
// `wide_smem` states the same sum); at d <= 9 it fits C up to 1312 in every
// variant.  In bf16 storage the carried sum s crosses the launches in f32
// buffers from the wrapper (unit 0 reads x, the last unit writes bf16), as
// in the folded stack's wide route.
//
// Plain C interface for ctypes: pointers and the stream as void*, ints as
// int; returns the first CUDA error of the launches (cudaGetLastError()
// after each), or cudaErrorInvalidValue for arguments it does not take.

#include "wide_mma.cuh"

namespace {

using namespace wide_mma;

constexpr int K = 7;
constexpr int CP = 32;             // narrow: padded channels
constexpr int RS = CP + 8;         // narrow: bf16 row stride (80 B)
constexpr int VS = CP + 1;         // narrow: f32 row stride of v
constexpr int UNITS = 3;
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int TILE = 320;          // narrow: output samples per block
constexpr int WIDE_N = 32;         // wide: output channels per warp
constexpr int MAX_WIDE_WARPS = 16;

enum { DEFAULT = 0, TREE = 1, IM2COL = 2, NOELU = 3, NOSHIFT = 4 };

struct Units {
  int dil[UNITS];
  int look[UNITS];  // samples each unit reads before its output
  int span[UNITS];  // noshift: folded rows back to the window's first row
};

// ELU in f32 as exp(min(v, 0)) - 1, a select and not a branch
__device__ __forceinline__ float elu(float v) {
  const float m = v > 0.f ? 0.f : v;
  return v > 0.f ? v : __fsub_rn(expf(m), 1.f);
}

template <int VARIANT>
__device__ __forceinline__ float act(float v) {
  return VARIANT == NOELU ? v : elu(v);
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
  return bf16 ? __fadd_rn(round_bf16(v), round_bf16(y)) : __fadd_rn(v, y);
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

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) c[n][q] = 0.f;
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
  float* V = reinterpret_cast<float*>(Y + L * RS);              // L x VS

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
      if (VARIANT == DEFAULT || VARIANT == NOELU || VARIANT == IM2COL) {
        // im2col's one sum over K = 7 * CP is this chain over (tap, k-step)
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
      } else {  // TREE
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
  const int smem = (int)sizeof(__nv_bfloat16) * (K * CP + CP + L) * RS +
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
  int wm, wn, np;    // warps along time and channels; channel passes
  int rows;          // output samples per block, 16 MTW wm
  int L;             // staged rows of Y: rows + look
  int yrows;         // rows of the Y region (L at the largest look)
  int a2rows;        // rows of the separate a2 region (np > 1), else 0
  int kc, nkc, nbuf; // input channels per stage, stages per tap, buffers
  int vec;           // T % 4 == 0: the epilogue's 4-sample accesses align
  // per phase p < fold of a row: bit 8 p + j, its partial goes into the
  // sum after tap j (the next tap lands on another folded offset, or j is
  // the last); bits 2 (7 p + j), noshift's row within the fold for tap j,
  // pmod(p + (j - 6) d, fold)
  unsigned int flush;
  unsigned long long nsh;
};

template <int MTW>
__device__ __forceinline__ void zero3(float (&c)[MTW][4][4]) {
#pragma unroll
  for (int mt = 0; mt < MTW; ++mt) zero(c[mt]);
}

template <int MTW>
__device__ __forceinline__ void add3(float (&c)[MTW][4][4],
                                     float (&b)[MTW][4][4]) {
#pragma unroll
  for (int mt = 0; mt < MTW; ++mt) {
    add(c[mt], b[mt]);
    zero(b[mt]);
  }
}

// o = the 4 x 4 block of lanes g = 4a .. 4a + 3 (same t) transposed: lane
// g = 4a + i gets element i of lanes 4a .. 4a + 3, in their order
__device__ __forceinline__ void transpose4(const float (&v)[4], float (&o)[4],
                                           int lane) {
  const int i = (lane >> 2) & 3;
#pragma unroll
  for (int q = 0; q < 4; ++q) o[q] = 0.f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int si = (i - r) & 3, j = (i + r) & 3;
    const float send = si == 0 ? v[0] : si == 1 ? v[1] : si == 2 ? v[2] : v[3];
    const float got =
        __shfl_sync(0xffffffffu, send, (lane & ~12) | (j << 2));
#pragma unroll
    for (int q = 0; q < 4; ++q) o[q] = q == j ? got : o[q];
  }
}

// 4 consecutive samples at index i of in (f32 or bf16): a vector access
// where `vec`, else the first n, zero past them
__device__ __forceinline__ void load4(float (&v)[4], const void* p, size_t i,
                                      int bf16, bool vec, int n) {
  if (vec && bf16) {
    const uint2 u = *reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(p) + i);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
    v[0] = __low2float(lo);
    v[1] = __high2float(lo);
    v[2] = __low2float(hi);
    v[3] = __high2float(hi);
  } else if (vec) {
    const float4 f = *reinterpret_cast<const float4*>(
        static_cast<const float*>(p) + i);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      v[q] = q >= n ? 0.f
             : bf16 ? load_f(static_cast<const __nv_bfloat16*>(p) + i + q)
                    : load_f(static_cast<const float*>(p) + i + q);
  }
}

__device__ __forceinline__ void store4(void* p, size_t i, const float (&v)[4],
                                       int bf16, bool vec, int n) {
  if (vec && bf16) {
    uint2 u;
    u.x = pack_bf16(v[0], v[1]);
    u.y = pack_bf16(v[2], v[3]);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p) + i) = u;
  } else if (vec) {
    *reinterpret_cast<float4*>(static_cast<float*>(p) + i) =
        make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q >= n) break;
      if (bf16)
        store_f(static_cast<__nv_bfloat16*>(p) + i + q, v[q]);
      else
        store_f(static_cast<float*>(p) + i + q, v[q]);
    }
  }
}

// a variant's register sets of MTW x 16 sums: im2col one, tree three,
// the others two; a block of more than 64 sums a thread holds at most 8
// warps (255 registers a thread), else 16 (128)
constexpr int wide_sets(int variant) {
  return variant == IM2COL ? 1 : variant == TREE ? 3 : 2;
}
constexpr int wide_max_warps(int variant, int mtw) {
  return wide_sets(variant) * mtw > 4 ? MAX_WIDE_WARPS / 2 : MAX_WIDE_WARPS;
}

template <int VARIANT, int MTW>
__global__ void __launch_bounds__(wide_max_warps(VARIANT, MTW) * 32, 1)
wide_kernel(const void* __restrict__ in, void* __restrict__ out,
            const __nv_bfloat16* __restrict__ w1,  // (K, CP, CP) [j][o][i]
            const __nv_bfloat16* __restrict__ w2,  // (CP, CP) [o][i]
            const __grid_constant__ Wide P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int RSW = P.CP + 8, KS = P.kc + 8, PW = WIDE_N * P.wn;
  __nv_bfloat16* Y = reinterpret_cast<__nv_bfloat16*>(smem);  // yrows x RSW
  __nv_bfloat16* A2 = P.np > 1 ? Y + P.yrows * RSW : Y;        // rows x RSW
  __nv_bfloat16* wring = Y + (P.yrows + P.a2rows) * RSW;       // nbuf x PW x KS
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int mbase = (warp / P.wn) * 16 * MTW, nloc = (warp % P.wn) * WIDE_N;
  const int b = blockIdx.y, t0 = blockIdx.x * P.rows;
  const size_t base = (size_t)b * P.C * P.T;
  const int d = P.d, f = P.fold;
  const int per1 = K * P.nkc;                     // conv1 stages per pass
  const int n1 = P.np * per1, nsteps = n1 + P.np * P.nkc;

  // stage s: conv1's pass p, tap j, input chunk kci (pass-major, then
  // tap), then conv2's pass p, chunk kci; rows of the pass's output
  // channels, kc input channels each
  const auto ring = weight_ring(
      wring, PW * KS, P.nbuf, nsteps, P.kc, P.CP,
      [&](int s, int& rows) {
        const bool c1 = s < n1;
        const int p = c1 ? s / per1 : (s - n1) / P.nkc;
        const int r = c1 ? s - p * per1 : s - n1 - p * P.nkc;
        const int j = c1 ? r / P.nkc : 0, kci = c1 ? r - j * P.nkc : r;
        const int o0 = p * PW;
        rows = min(PW, P.CP - o0);
        return (c1 ? w1 + (size_t)j * P.CP * P.CP : w2) +
               (size_t)o0 * P.CP + kci * P.kc;
      });
  ring.start();

  // Y = bf16(ELU(v)) over rows 0 .. L - 1 (time t0 - look + row)
  auto y1 = [](float v) { return act<VARIANT>(v); };
  if (P.in_bf16)
    stage_act(Y, static_cast<const __nv_bfloat16*>(in) + base, t0 - P.look,
              P.L, P.T, P.C, P.CP, y1);
  else
    stage_act(Y, static_cast<const float*>(in) + base, t0 - P.look, P.L,
              P.T, P.C, P.CP, y1);

  // acc: im2col's sum, the others' offset sum, the 1x1 conv; part: a tap's
  // (an offset's) partial; s01: tree's left half
  float acc[MTW][4][4], part[MTW][4][4], s01[MTW][4][4];
  zero3(acc);
  zero3(part);
  zero3(s01);

  // the lane's ldmatrix rows: A row (lane & 15) at column (lane >> 4) * 8;
  // B rows (lane & 7) + 8 (lane >> 4) at column 8 ((lane >> 3) & 1)
  const int arow = lane & 15, acol = (lane >> 4) * 8;
  const int brow0 = nloc + (lane & 7) + ((lane >> 4) << 3);
  const int bcol = ((lane >> 3) & 1) * 8;
  // each tile's phases in the fold: of the lane's A row (noshift's reads)
  // and, as flush bits j and 8 + j, of its accumulator rows g and g + 8
  int aph[MTW];
  unsigned int fl[MTW];
#pragma unroll
  for (int mt = 0; mt < MTW; ++mt) {
    const int q = t0 + mbase + mt * 16;
    aph[mt] = (q + arow) % f;
    fl[mt] = ((P.flush >> (8 * ((q + g) % f))) & 0xffu) |
             (((P.flush >> (8 * ((q + g + 8) % f))) & 0xffu) << 8);
  }

  // the lane's B rows in stage s's buffer (WeightRing::next)
  auto next = [&](int s) { return ring.next(s) + brow0 * KS + bcol; };

  // conv1, pass by pass, tap by tap
  for (int s = 0; s < n1; ++s) {
    const __nv_bfloat16* bp = next(s);
    const int p = s / per1, r = s - p * per1, j = r / P.nkc;
    const int kci = r - j * P.nkc;
    const bool tap_end = kci == P.nkc - 1;
    const int oc = p * PW + nloc;         // the warp's first channel
    const bool live = oc < P.CP;
    if (live) {
      const int sh = (j - (K - 1)) * d;
      const __nv_bfloat16* ap[MTW];
#pragma unroll
      for (int mt = 0; mt < MTW; ++mt) {
        const int q = mbase + mt * 16 + arow;  // output row of the lane
        int row = q + sh;
        if (VARIANT == NOSHIFT)
          row = q - aph[mt] - f * P.span +
                (int)((P.nsh >> (2 * (7 * aph[mt] + j))) & 3u);
        ap[mt] = Y + (P.look + row) * RSW + kci * P.kc + acol;
      }
      if (VARIANT == IM2COL) {
        product<MTW>(acc, ap, bp, KS, P.kc);
      } else if (VARIANT == TREE) {
        if (j == 0)
          product<MTW>(s01, ap, bp, KS, P.kc);
        else if (j == 2 || j == 4)
          product<MTW>(acc, ap, bp, KS, P.kc);
        else
          product<MTW>(part, ap, bp, KS, P.kc);
      } else {
        product<MTW>(part, ap, bp, KS, P.kc);
      }
      if (tap_end && VARIANT == TREE) {
        if (j == 1) add3(s01, part);        // p0 + p1
        if (j == 3) {
          add3(acc, part);                  // p2 + p3
          add3(s01, acc);                   // (p0 + p1) + (p2 + p3)
        }
        if (j == 5 || j == 6) add3(acc, part);  // (p4 + p5) + p6
        if (j == 6) add3(acc, s01);         // left + right
      } else if (tap_end && VARIANT != IM2COL) {
        // a row's partial goes into acc where its next tap lands on
        // another folded offset (at every tap where f = 1)
#pragma unroll
        for (int mt = 0; mt < MTW; ++mt) {
          const bool fa = (fl[mt] >> j) & 1u, fb = (fl[mt] >> (8 + j)) & 1u;
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (q < 2 ? fa : fb) {
                acc[mt][n][q] += part[mt][n][q];
                part[mt][n][q] = 0.f;
              }
        }
      }
    }
    if (j == K - 1 && tap_end) {
      // conv1 of pass p done: a2 = bf16(ELU(acc)), into Y once every warp
      // is done reading it (one pass), or into its own rows; a later
      // step's barrier orders the writes before conv2's reads
      if (P.np == 1) __syncthreads();
      if (live) {
#pragma unroll
        for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int q = mbase + mt * 16 + g + 8 * h;
              *reinterpret_cast<uint32_t*>(A2 + q * RSW + oc + n * 8 +
                                           2 * tq) =
                  pack_bf16(act<VARIANT>(acc[mt][n][2 * h]),
                            act<VARIANT>(acc[mt][n][2 * h + 1]));
            }
        zero3(acc);
      }
    }
  }

  // conv2, the 1x1 conv over a2's rows, pass by pass, then the epilogue
  for (int s = n1; s < nsteps; ++s) {
    const __nv_bfloat16* bp = next(s);
    const int p = (s - n1) / P.nkc, kci = s - n1 - p * P.nkc;
    const int oc = p * PW + nloc;
    if (oc >= P.CP) continue;
    const __nv_bfloat16* ap[MTW];
#pragma unroll
    for (int mt = 0; mt < MTW; ++mt)
      ap[mt] = A2 + (mbase + mt * 16 + arow) * RSW + kci * P.kc + acol;
    product<MTW>(acc, ap, bp, KS, P.kc);
    if (kci != P.nkc - 1) continue;
    // out = residual(v, y2), a lane's 4 samples of one channel at a time
    // (transpose4), the tile's residuals loaded before any output is stored
#pragma unroll
    for (int mt = 0; mt < MTW; ++mt) {
      const int i = g & 3;
      const int q0 = mbase + mt * 16 + 4 * (g >> 2) + 8 * (i >> 1);
      const int t = t0 + q0, nt = min(4, P.T - t);
      float v[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        float y[4];
        transpose4(acc[mt][n], y, lane);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][n][e] = y[e];
        const int c = oc + n * 8 + 2 * tq + (i & 1);
        if (c < P.C && nt > 0)
          load4(v[n], in, base + (size_t)c * P.T + t, P.in_bf16,
                P.vec && nt == 4, nt);
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int c = oc + n * 8 + 2 * tq + (i & 1);
        if (c >= P.C || nt <= 0) continue;
        float r[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          r[e] = residual(v[n][e], acc[mt][n][e], P.round_res);
        store4(out, base + (size_t)c * P.T + t, r, P.out_bf16,
               P.vec && nt == 4, nt);
      }
    }
    zero3(acc);
  }
}

// floor division for a negative n too, on the host
int host_fdiv(int n, int f) { return n >= 0 ? n / f : -((f - 1 - n) / f); }

// shared memory of a wide block in bytes; ops/kernels/ablate_stack.py
// ablate_wide_smem states the same sum: Y and a2's rows, and the ring of
// nbuf stages of 32 wn output channels x kc input channels
size_t wide_smem(int cp, int yrows, int a2rows, int wn, int kc, int nbuf) {
  return 2 * ((size_t)(yrows + a2rows) * (cp + 8) +
              (size_t)nbuf * WIDE_N * wn * (kc + 8));
}

// the most m16 tiles a warp of the variant takes: tree's three register
// sets hold two
int wide_mtw_cap(int variant) { return variant == TREE ? 2 : 4; }

template <int VARIANT, int MTW>
int launch_wide(const void* in, void* out, const __nv_bfloat16* w1,
                const __nv_bfloat16* w2, int B, const Wide& a, size_t smem,
                cudaStream_t stream) {
  auto kernel = wide_kernel<VARIANT, MTW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)  // all of the SM's L1 as shared memory
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.T + a.rows - 1) / a.rows, B);
  kernel<<<grid, 32 * a.wm * a.wn, smem, stream>>>(in, out, w1, w2, a);
  return (int)cudaGetLastError();
}

template <int VARIANT>
int wide_variant(int mtw, const void* in, void* out, const __nv_bfloat16* w1,
                 const __nv_bfloat16* w2, int B, const Wide& a, size_t smem,
                 cudaStream_t s) {
  switch (mtw) {
    case 1: return launch_wide<VARIANT, 1>(in, out, w1, w2, B, a, smem, s);
    case 2: return launch_wide<VARIANT, 2>(in, out, w1, w2, B, a, smem, s);
    case 4:
      if (VARIANT != TREE)
        return launch_wide<VARIANT, VARIANT == TREE ? 2 : 4>(
            in, out, w1, w2, B, a, smem, s);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

int wide_unit(int variant, int mtw, const void* in, void* out,
              const __nv_bfloat16* w1, const __nv_bfloat16* w2, int B,
              const Wide& a, size_t smem, cudaStream_t s) {
  switch (variant) {
    case DEFAULT:
      return wide_variant<DEFAULT>(mtw, in, out, w1, w2, B, a, smem, s);
    case TREE: return wide_variant<TREE>(mtw, in, out, w1, w2, B, a, smem, s);
    case IM2COL:
      return wide_variant<IM2COL>(mtw, in, out, w1, w2, B, a, smem, s);
    case NOELU:
      return wide_variant<NOELU>(mtw, in, out, w1, w2, B, a, smem, s);
    case NOSHIFT:
      return wide_variant<NOSHIFT>(mtw, in, out, w1, w2, B, a, smem, s);
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
// residual between the units, with blocks of warps_m x warps_n warps of
// mtw m16 tiles each, weight stages of kc input channels and nbuf ring
// buffers (ops/kernels/ablate_stack.py ablate_wide_geometry); at C <= 32
// scratch and the geometry are unused.
extern "C" int ablate_stack_forward(const void* x, void* out, const void* w1,
                                    const void* w2, void* scratch, int B,
                                    int C, int T, int cp, int fold, int d0,
                                    int d1, int d2, int variant,
                                    int storage_bf16, int mtw, int warps_m,
                                    int warps_n, int kc, int nbuf,
                                    void* stream) {
  if (B < 1 || C < 1 || T < 1 || fold < 1 || d0 < 1 || d1 < 1 || d2 < 1 ||
      variant < DEFAULT || variant > NOSHIFT ||
      cp != (C <= CP ? CP : (C + 31) / 32 * 32))
    return (int)cudaErrorInvalidValue;
  Units units;
  const int dil[UNITS] = {d0, d1, d2};
  int look_max = 0;
  for (int u = 0; u < UNITS; ++u) {
    const int d = dil[u], span = (6 * d + fold - 1) / fold;
    units.dil[u] = d;
    units.span[u] = span;
    // noshift reads up to fold * span + fold - 1 samples back
    units.look[u] = variant == NOSHIFT ? fold * span + fold - 1 : 6 * d;
    look_max = max(look_max, units.look[u]);
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
  const int groups = cp / WIDE_N;
  // fold = 128 / C <= 3 above C = 32: the flush and noshift tables
  if (scratch == nullptr || fold > 3 || mtw < 1 ||
      mtw > wide_mtw_cap(variant) ||
      (mtw & (mtw - 1)) || warps_m < 1 || warps_n < 1 || warps_n > groups ||
      warps_m * warps_n > wide_max_warps(variant, mtw) ||
      kc < 16 || kc % 16 || cp % kc || (nbuf != 2 && nbuf != 3))
    return (int)cudaErrorInvalidValue;
  Wide args;
  args.C = C;
  args.CP = cp;
  args.T = T;
  args.fold = fold;
  args.round_res = storage_bf16;
  args.wm = warps_m;
  args.wn = warps_n;
  args.np = (groups + warps_n - 1) / warps_n;
  args.rows = 16 * mtw * warps_m;
  args.yrows = args.rows + look_max;
  args.a2rows = args.np > 1 ? args.rows : 0;
  args.kc = kc;
  args.nkc = cp / kc;
  args.nbuf = nbuf;
  args.vec = T % 4 == 0;
  const size_t smem =
      wide_smem(cp, args.yrows, args.a2rows, warps_n, kc, nbuf);
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  float* buf[2] = {static_cast<float*>(scratch),
                   static_cast<float*>(scratch) + (size_t)B * C * T};
  const void* src = x;
  for (int u = 0; u < UNITS; ++u) {
    const bool last = u == UNITS - 1;
    void* dst = last ? out : static_cast<void*>(buf[u % 2]);
    args.d = units.dil[u];
    args.span = units.span[u];
    args.flush = 0;
    args.nsh = 0;
    for (int p = 0; p < fold; ++p)
      for (int j = 0; j < K; ++j) {
        const int sh = (j - (K - 1)) * args.d;
        if (j == K - 1 || host_fdiv(p + sh + args.d, fold) !=
                              host_fdiv(p + sh, fold))
          args.flush |= 1u << (8 * p + j);
        args.nsh |= (unsigned long long)(p + sh - fold * host_fdiv(p + sh, fold))
                    << (2 * (K * p + j));
      }
    args.look = units.look[u];
    args.L = args.rows + args.look;
    args.in_bf16 = u == 0 ? storage_bf16 : 0;
    args.out_bf16 = last ? storage_bf16 : 0;
    const int err = wide_unit(variant, mtw, src, dst,
                              a + (size_t)u * K * cp * cp,
                              c + (size_t)u * cp * cp, B, args, smem, s);
    if (err != 0) return err;
    src = dst;
  }
  return 0;
}
