// The folded residual stack's int8 mode with "row" scales on the int8
// tensor cores, for Hopper (sm_90a), batch mode.
//
// Replaces the TPU kernel audiodec_tpu/ops/pallas/folded_stack.py
// folded_residual_stack (pallas_call at :372) in its int8 mode with "row"
// activation scales (int8_dots=True, int8_scale="row"), the mode that
// `codec_test --dtype int8-decode` runs for every decoder stack, at any
// width C from 1 to 512, any fold and every unit shape the TPU kernel
// takes.  A unit is
// v += conv_k2(act(mask(conv_k,d(act(v)) + b1))) + b2, act ELU or
// LeakyReLU(slope), any k and k2, biases or none, any number of units, f32
// or bf16 storage, zero left context at t=0, and both convs multiply int8
// by int8 into int32:
//
//   - weights: per output channel, s = max(absmax over taps and input
//     channels, 1e-12) / 127 and q = round(w / s), done by the wrapper;
//   - activations: per folded row, F consecutive samples x C channels (F
//     the wrapper's fold, by default the TPU kernel's max(1, 128 / C)),
//     rows aligned to t=0:
//     s_x = max|y| over the row, q = round(y * (127 / max(s_x, 1e-12))),
//     dequant scale s_x * (1/127);
//   - dequantization: for each folded-row offset o a conv reads
//     (ascending), the taps that read row u + o are summed exactly in
//     int32, converted to f32 once and added with one rounding,
//     acc = fmaf(part, s_row[u + o], acc) from zero; then acc * s_weight,
//     or with biases fmaf(acc, s_weight, b) (XLA's fma); conv1's rows
//     before t=0 are zero (the TPU kernel's mask); the residual is
//     v = fmaf(y2, s_weight2, v), or v + fmaf(y2, s_weight2, b2), in f32
//     storage; in bf16 storage the buffers hold f32 values, the sum
//     bf16(v) + bf16(y2 * s_weight2 [+ b2]) that the next unit's act reads
//     (XLA keeps that excess precision on the CPU), rounded to bf16 where
//     the residual is read and by the wrapper at the end.
// Every f32 operation is an explicit _rn intrinsic or fmaf, so nvcc's
// contraction cannot move a rounding; rounding to int8 is half to even, as
// torch.round; ELU is exp(min(v, 0)) - 1 with expf, the TPU kernel's form.
// Integer sums are exact in any order, so the tensor cores move no result:
// this is the plain version's arithmetic (ops/kernels/folded_stack.py
// folded_residual_stack_int8_plain).
//
// Bound on the H100: the int8 products run at 1979 TOP/s on the tensor
// cores; at the symAD decoder's stacks (16, T, C) = (16, 8000, 256),
// (16, 40000, 128), (16, 160000, 64), (16, 480000, 32) the bounds are
// 0.203 / 0.254 / 0.391 / 0.587 ms (bin/kernel_bounds.py), by operations at
// C = 256 and 128 and by the f32 activation's bytes at C = 64 and 32.
//
// Design: one CUDA launch per unit (the wrapper's call makes n_units); the
// stack ping-pongs between `out` and `tmp` so the last unit writes `out`.
// A block takes one batch row and a tile of TS samples (whole folded rows)
// with all C output channels, so it can requantize conv1's output, whose
// row scale needs every channel of the row (the trap of a split over
// channels).  In shared memory:
//   1. act(v) for the tile and its left halo of whole rows (conv1's span
//      and the X rows of conv1's output that conv2 reads before the tile,
//      zero before t=0) is staged as f32, [channel][sample], in chunks of
//      TS samples (a warp keeps U loads of 32 samples in flight); one warp
//      per folded row takes its absmax and quantizes it to int8 rows of CP
//      channels, the next of 32, 64, 128, 256 and 512 (zero padded: exact
//      in integers), laid out phase-major, Q[t mod F][t div F][CP + 16];
//   2. conv1 on the tensor cores, mma.sync m16n8k32 s8 x s8 -> s32: an M
//      tile is 16 consecutive folded rows of one phase p, so all its rows
//      share one tap-to-offset map (tap j reads phase (p + j d - span) mod
//      F at row offset o = floor((p + j d - span) / F), advanced from tap
//      to tap without a division) and its A operand is 16 consecutive rows
//      of Q, loaded with ldmatrix; the taps of one offset chain in the s32
//      accumulator (the chain's first mma adds to zero), and at each change
//      of offset (ascending with j) the warp flushes it through the
//      per-row fmaf in registers: the TPU kernel's per-offset dot, with no
//      per-element bookkeeping.  At F = 1 every tap is its own offset.
//      Each warp owns 2 M tiles x 32 output channels.  conv1 covers the
//      tile's R rows and the X rows before them, R + X whole M tiles;
//   3. act(acc * s1 [+ b1]) goes to the f32 buffer, [channel][sample], its
//      rows' absmax to shared memory (the four lanes of a row by shuffles,
//      then atomicMax), and it is quantized per row as in 1; conv2 runs as
//      conv1 does, over `fold_offsets(k2, 1, F)` (one offset for a 1x1
//      conv), y2 goes to the f32 buffer, and the residual is read and
//      written with coalesced accesses.
// Blocks are 8 warps at CP <= 64, two per SM (in half the SM's shared
// memory), and 16 warps at CP >= 128, one per SM: with 113-118 registers a
// thread, two blocks let one block's loads and stores overlap the other's
// products.  TS = 256 samples at C = 32, 128 at 64 and 128, 64 at 256, 32
// at 512, rounded up to whole M tiles of every phase; where that makes
// more M tiles than the warps hold, the block runs them in rounds.  The f32
// buffer holds the C real channels only, so that a large fold (C = 4 at
// F = 128: 2048 samples a tile) fits; where it still does not fit beside
// the rest (C = 512 at F = 4), each block keeps it in its own slice of a
// device-memory buffer instead (slower, and only there).  The weights
// stream through shared memory with cp.async, a stage holding
// `taps_per_stage` taps of `kc` input channels in 2 buffers (at C = 32 all k taps, at 64 six, at 128
// three; at C = 256 one tap's half, 32 KiB, in 3 buffers; at C = 512 the
// widest of 128, 64 and 32 channels that fits two buffers);
// ops/kernels/folded_stack.py int8_mma_geometry sizes it all.  An int32
// partial exceeds 2^22 only when 127^2 C times the taps of one offset
// does; below that (every decoder stack) it converts to f32 exactly by
// adding 1.5 x 2^23 to its bits (`exact_small`, per conv), else with
// cvt.rn.f32.s32.  What holds it back: PERF.md §7.
//
// Plain C interface for ctypes: pointers and the stream as void*, ints as
// int; returns the first CUDA error of the launches, or
// cudaErrorInvalidValue for arguments it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int NW = 32;                // output channels a warp owns
constexpr int MT = 2;                 // M tiles a warp owns per round
constexpr int U = 8;                  // loads a lane keeps in flight
constexpr int SMEM_LIMIT = 232448;    // bytes a block may use on sm_90
constexpr float QMAX = 127.f;
enum { ELU = 0, LEAKY = 1 };

// warps per block: 8 at CP <= 64, two blocks per SM; 16 above, one block
__host__ __device__ constexpr int warps_for(int cp) {
  return cp <= 64 ? 8 : 16;
}
constexpr float MAGIC = 12582912.f;   // 1.5 x 2^23
constexpr int MAGIC_BITS = 0x4B400000;

// one conv of a unit: its taps are read at row offsets advanced by
// d = dq F + dr from tap to tap; its output rows (per phase) start `halo`
// rows into its operand's `lr` rows per phase
struct Conv {
  int k, d, span;     // width, dilation, (k - 1) d
  int dq, dr;         // d / F, d % F
  int per_phase;      // M tiles per phase (output rows / 16)
  int lr, halo;       // operand rows per phase, rows before the output's
  int rounds, nst;    // rounds of the warps' M tiles, weight stages
  int exact_small;    // every int32 partial below 2^22
};

// one unit's launch
struct Params {
  int C, Tp, F;
  int TS, R;          // tile samples, tile rows (TS / F)
  int R1, X;          // conv1 output rows per phase (R1 = R + X: the X rows
                      // before the tile that the second conv reads)
  int hrow;           // conv1's halo rows
  int tps, kc, nkc, nbuf;
  int act, has_bias, bf16;
  float slope;
  Conv c1, c2;
  float* sg;          // the f32 buffer in device memory, c x (r1 f + 1) a
                      // block, where a block's shared memory cannot hold it
};

// ELU as exp(min(v, 0)) - 1 (the TPU kernel's form), or LeakyReLU
__device__ __forceinline__ float activate(float v, int act, float slope) {
  if (act == LEAKY) return v > 0.f ? v : __fmul_rn(v, slope);
  return v > 0.f ? v : __fsub_rn(expf(fminf(v, 0.f)), 1.f);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// an int32 partial as f32, rounded to nearest (exact below 2^22 in the
// fast form)
__device__ __forceinline__ float to_f32(int v, bool exact_small) {
  return exact_small ? __fsub_rn(__int_as_float(v + MAGIC_BITS), MAGIC)
                     : __int2float_rn(v);
}

__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return q * b > a ? q - 1 : q;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a * b, int8 operands, int32 sums; from zero where `first`
__device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1, bool first) {
  if (first)
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
        : "=r"(c[0]), "=r"(c[1]), "=r"(c[2]), "=r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "r"(0));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the absmax of conv1's output rows: a lane's max m of row `row` joins the
// other three lanes of its quad (the four lanes holding one row of an mma
// tile), and the quad's first lane takes it into rm[row] (float bits;
// non-negative floats order as their bits)
__device__ __forceinline__ void row_max(unsigned* rm, int row, float m) {
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
  if ((threadIdx.x & 3) == 0) atomicMax(rm + row, __float_as_uint(m));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// the shared-memory layout, in bytes; ops/kernels/folded_stack.py
// int8_mma_smem states the same sums
struct Layout {
  int w, q, s, sd, rm, total;
};

__host__ __device__ inline Layout layout(int cp, int c, int nbuf, int tps,
                                         int kc, int r1, int f, int lr_max,
                                         bool s_global) {
  Layout l;
  l.w = 0;                                    // nbuf x tps x cp x (kc + 16)
  l.q = l.w + nbuf * tps * cp * (kc + 16);    // f x lr x (cp + 16)
  l.s = l.q + f * lr_max * (cp + 16);         // c x (r1 f + 1) f32, or none
  l.sd = l.s + (s_global ? 0 : 4 * c * (r1 * f + 1));  // lr f32
  l.rm = l.sd + 4 * lr_max;                   // r1 u32
  l.total = l.rm + 4 * r1;
  return l;
}

// g / d for d >= 2 and g * d < 2^32, with m = ceil(2^32 / d)
__device__ __forceinline__ unsigned div_magic(int d) {
  return (unsigned)((0x100000000ull + d - 1) / d);
}

__device__ __forceinline__ int fast_div(int g, int d, unsigned m) {
  return d == 1 ? g : (int)__umulhi((unsigned)g, m);
}

// rows [row0, row0 + nrows) of the staged f32 buffer S ([c][LS], sample
// s = (r - row0) * F + p of the chunk) -> int8 rows Q[p][row][CP + 16]
// (`lr` rows per phase) and their dequant scales SD[row].  The rows'
// absmax is taken here (a warp's pass over the row), or, with HAVE_MAX,
// read from RM, which is reset to 0 for the next conv.  One warp per row,
// lane l holding channels l, l + 32, ...
template <int CP, int NWARPS, bool HAVE_MAX>
__device__ void quantize_rows(const float* S, int LS, int8_t* Q, float* SD,
                              unsigned* RM, int row0, int nrows, int lr,
                              int F, int C) {
  constexpr int QS = CP + 16, CL = CP / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* Sl = S + lane * LS;
  int8_t* Ql = Q + row0 * QS + lane;
  for (int r = warp; r < nrows; r += NWARPS) {
    const float* a = Sl + r * F;
    float m;
    if (HAVE_MAX) {
      m = __uint_as_float(RM[row0 + r]);
    } else {
      m = 0.f;
      for (int p = 0; p < F; ++p)
#pragma unroll
        for (int ci = 0; ci < CL; ++ci)
          if (lane + 32 * ci < C) m = fmaxf(m, fabsf(a[32 * ci * LS + p]));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    }
    const float r127 = __fdiv_rn(QMAX, fmaxf(m, (float)1e-12));
    for (int p = 0; p < F; ++p)
#pragma unroll
      for (int ci = 0; ci < CL; ++ci) {
        int q = 0;
        if (lane + 32 * ci < C)  // |y * r127| <= 127: adding 1.5 x 2^23
                                 // rounds half to even
          q = __float_as_int(
                  __fadd_rn(__fmul_rn(a[32 * ci * LS + p], r127), MAGIC)) -
              MAGIC_BITS;
        Ql[(p * lr + r) * QS + 32 * ci] = (int8_t)q;
      }
    if (lane == 0) SD[row0 + r] = __fmul_rn(m, (float)(1.0 / 127.0));
    if (HAVE_MAX) {
      __syncwarp();
      if (lane == 0) RM[row0 + r] = 0u;
    }
  }
}

// GENERAL = false: the int8 decode's units (ELU, a 1x1 conv2, no biases),
// whose conv2 is one offset read straight from its accumulator; GENERAL =
// true: every unit shape
template <int CP, bool GENERAL>
__global__ void __launch_bounds__(32 * warps_for(CP), 16 / warps_for(CP))
int8_mma_unit(const float* __restrict__ x, float* __restrict__ out,
              const int8_t* __restrict__ w1,  // (k, CP, CP) [tap][out][in]
              const int8_t* __restrict__ w2,  // (k2, CP, CP) [tap][out][in]
              const float* __restrict__ s1,   // (CP) conv1 weight scales
              const float* __restrict__ s2,   // (CP) conv2 weight scales
              const float* __restrict__ b1,   // (CP) conv1 bias, or null
              const float* __restrict__ b2,   // (CP) conv2 bias, or null
              const Params P) {
  constexpr int QS = CP + 16;
  constexpr int NWARPS = warps_for(CP), NTHREADS = 32 * NWARPS;
  constexpr int NS = CP / NW;                 // warps across the channels
  constexpr int MPR = (NWARPS / NS) * MT;     // M tiles per round
  static_assert(NS <= NWARPS, "a warp owns 32 of the channels");
  extern __shared__ __align__(16) unsigned char smem[];
  const int F = P.F, TS = P.TS, R1 = P.R1, LS = R1 * F + 1, KS = P.kc + 16;
  const Layout lay = layout(CP, P.C, P.nbuf, P.tps, P.kc, R1, F, P.c1.lr,
                            P.sg != nullptr);
  int8_t* Wbuf = reinterpret_cast<int8_t*>(smem + lay.w);
  int8_t* Q = reinterpret_cast<int8_t*>(smem + lay.q);
  float* S = P.sg == nullptr
                 ? reinterpret_cast<float*>(smem + lay.s)
                 : P.sg + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) *
                              P.C * LS;
  float* SD = reinterpret_cast<float*>(smem + lay.sd);
  unsigned* RM = reinterpret_cast<unsigned*>(smem + lay.rm);
  const int wbuf_bytes = P.tps * CP * KS;
  const int act = GENERAL ? P.act : ELU;
  const bool bias = GENERAL && P.has_bias;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TS;       // first output sample of the tile
  const int H = (P.hrow + P.X) * F;     // staged samples before the tile
  const float* xb = x + (size_t)b * P.C * P.Tp;
  float* ob = out + (size_t)b * P.C * P.Tp;

  // the steps of the weight pipeline: rounds x conv1 stages, then
  // rounds x conv2 stages
  const int n1 = P.c1.rounds * P.c1.nst;
  const int nsteps = n1 + P.c2.rounds * P.c2.nst;
  // stage s into buffer s mod nbuf, one commit group per call (empty past
  // the last stage, so that every step waits on the same group count)
  auto issue = [&](int s) {
    if (s >= nsteps) {
      cp_async_commit();
      return;
    }
    int8_t* dst = Wbuf + (s % P.nbuf) * wbuf_bytes;
    const bool first = s < n1;
    const int r = first ? s % P.c1.nst : (s - n1) % P.c2.nst;
    const int kci = r % P.nkc, j0 = (r / P.nkc) * P.tps;
    const int ntaps = min(P.tps, (first ? P.c1.k : P.c2.k) - j0);
    const int8_t* src = (first ? w1 : w2) + (size_t)j0 * CP * CP;
    const int vpr = P.kc / 16;  // 16-byte vectors per weight row
    for (int e = tid; e < ntaps * CP * vpr; e += NTHREADS) {
      const int row = e / vpr, v = e - row * vpr;  // row = tap * CP + out
      cp_async16(dst + row * KS + v * 16,
                 src + (size_t)row * CP + kci * P.kc + v * 16);
    }
    cp_async_commit();
  };
  for (int s = 0; s < P.nbuf - 1; ++s) issue(s);
  for (int e = tid; e < R1; e += NTHREADS) RM[e] = 0u;

  // 1. act(v) over the halo and the tile, in chunks of TS samples, each
  // quantized per row into Q (rows 0 .. LR - 1).  A warp reads segments of
  // 32 samples of one channel, U segments before it uses any, so that
  // enough loads are in flight
  const int L = H + TS;
  for (int cs = 0; cs < L; cs += TS) {
    const int n = min(TS, L - cs);
    const int tb = t0 - H + cs;
    const int nseg = (n + 31) / 32, total = P.C * nseg;
    const unsigned magic = div_magic(nseg);
    for (int g0 = warp; g0 < total; g0 += U * NWARPS) {
      float v[U];
#pragma unroll
      for (int i = 0; i < U; ++i) {
        const int gi = g0 + i * NWARPS, c = fast_div(gi, nseg, magic);
        const int s = (gi - c * nseg) * 32 + lane, t = tb + s;
        v[i] = (gi < total && s < n && t >= 0 && t < P.Tp)
                   ? __ldg(xb + (size_t)c * P.Tp + t) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < U; ++i) {
        const int gi = g0 + i * NWARPS, c = fast_div(gi, nseg, magic);
        const int s = (gi - c * nseg) * 32 + lane;
        if (gi < total && s < n)
          S[c * LS + s] = activate(v[i], act, P.slope);
      }
    }
    __syncthreads();
    quantize_rows<CP, NWARPS, false>(S, LS, Q, SD, RM, cs / F, n / F,
                                     P.c1.lr, F, P.C);
    __syncthreads();
  }

  // this warp's channels and M tiles (slot i of round rd: M tile
  // rd * MPR + mgroup * MT + i, phase mt / per_phase, rows from
  // 16 * (mt % per_phase))
  const int nbase = (warp % NS) * NW;
  const int mgroup = warp / NS;
  float acc[MT][NW / 8][4];
  int iacc[MT][NW / 8][4];
  bool fresh[MT];

  // step s of the weight pipeline, of conv1 (first) or conv2 (cv); two
  // loops below call it, so that each conv's parameters stay constants
  auto step = [&](const int s, const Conv& cv, const bool first) {
    // stage s has landed (nbuf - 2 later groups may be pending), and every
    // warp is done with step s - 1, whose buffer the next issue refills
    if (P.nbuf == 2)
      cp_async_wait<0>();
    else if (P.nbuf == 3)
      cp_async_wait<1>();
    else
      cp_async_wait<2>();
    __syncthreads();
    issue(s + P.nbuf - 1);
    const int8_t* Wb = Wbuf + (s % P.nbuf) * wbuf_bytes;
    const int sl = first ? s : s - n1;
    const int rd = sl / cv.nst, r = sl % cv.nst;
    const int kci = r % P.nkc;
    const int j0 = (r / P.nkc) * P.tps;
    const int ntaps = min(P.tps, cv.k - j0);
    const int mtiles = F * cv.per_phase;
    // off, pp: the row offset and phase that tap j of each M tile reads,
    // advanced by d = dq F + dr from tap to tap
    int mt[MT], ph[MT], u0[MT], off[MT], pp[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      mt[i] = rd * MPR + mgroup * MT + i;
      ph[i] = mt[i] / cv.per_phase;
      u0[i] = 16 * (mt[i] % cv.per_phase);
      const int a = ph[i] + j0 * cv.d - cv.span;
      off[i] = floor_div(a, F);
      pp[i] = a - off[i] * F;
    }
    if (r == 0) {  // the first stage of a conv in this round
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        fresh[i] = true;
#pragma unroll
        for (int n = 0; n < NW / 8; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][n][q] = 0.f;
      }
    }

    for (int jj = 0; jj < ntaps; ++jj) {
      const int j = j0 + jj;
      // the A rows of each M tile at this tap
      const int8_t* arow[MT];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int row = pp[i] * cv.lr + u0[i] + cv.halo + off[i];
        arow[i] = Q + (row + (lane & 15)) * QS + kci * P.kc + (lane >> 4) * 16;
      }
      const int8_t* brow = Wb + (jj * CP + nbase + (lane & 7) +
                                 ((lane >> 4) << 3)) * KS +
                           ((lane >> 3) & 1) * 16;
      for (int kk = 0; kk < P.kc / 32; ++kk) {
        uint32_t bf[NW / 16][4];
#pragma unroll
        for (int h = 0; h < NW / 16; ++h)
          ldmatrix_x4(bf[h], brow + h * 16 * KS + kk * 32);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          if (mt[i] >= mtiles) continue;
          uint32_t af[4];
          ldmatrix_x4(af, arow[i] + kk * 32);
#pragma unroll
          for (int n = 0; n < NW / 8; ++n)
            mma(iacc[i][n], af, bf[n >> 1][2 * (n & 1)],
                bf[n >> 1][2 * (n & 1) + 1], fresh[i]);
          fresh[i] = false;
        }
      }
      if (kci != P.nkc - 1 || (!GENERAL && !first)) continue;
      // a change of offset ends a chain: flush it through the row scales
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        int pn = pp[i] + cv.dr, on = off[i] + cv.dq;
        if (pn >= F) {
          pn -= F;
          ++on;
        }
        const int o = off[i];
        off[i] = on;
        pp[i] = pn;
        if (mt[i] >= mtiles || (j + 1 < cv.k && on == o)) continue;
        const int ra = u0[i] + g + cv.halo + o;
        const float sa = SD[ra], sb = SD[ra + 8];
#pragma unroll
        for (int n = 0; n < NW / 8; ++n) {
          acc[i][n][0] = fmaf(to_f32(iacc[i][n][0], cv.exact_small), sa,
                              acc[i][n][0]);
          acc[i][n][1] = fmaf(to_f32(iacc[i][n][1], cv.exact_small), sa,
                              acc[i][n][1]);
          acc[i][n][2] = fmaf(to_f32(iacc[i][n][2], cv.exact_small), sb,
                              acc[i][n][2]);
          acc[i][n][3] = fmaf(to_f32(iacc[i][n][3], cv.exact_small), sb,
                              acc[i][n][3]);
        }
        fresh[i] = true;  // the next chain's first mma starts from zero
      }
    }

    if (r == cv.nst - 1) {
      // conv1: act(acc * s1 [+ b1]) and its rows' absmax (rows u0 + g and
      // u0 + g + 8, over the 4 lanes of a row); conv2: its sum y2; both
      // to S
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (mt[i] >= mtiles) continue;
        float m[2] = {0.f, 0.f};
#pragma unroll
        for (int n = 0; n < NW / 8; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int c = nbase + n * 8 + 2 * t4 + (q & 1);
            const int row = u0[i] + g + 8 * (q >> 1);
            float y = acc[i][n][q];
            if (first) {
              // with biases, conv1's rows before t=0 are zero: the second
              // conv reads them as the TPU kernel's masked rows
              y = !bias ? __fmul_rn(y, __ldg(s1 + c))
                  : t0 / F - P.X + row < 0
                      ? 0.f
                      : fmaf(y, __ldg(s1 + c), __ldg(b1 + c));
              y = activate(y, act, P.slope);
              m[q >> 1] = fmaxf(m[q >> 1], fabsf(y));
            } else if (!GENERAL) {  // the 1x1 conv: one offset, o = 0
              y = __fmul_rn(to_f32(iacc[i][n][q], cv.exact_small), SD[row]);
            }
            if (c < P.C) S[c * LS + row * F + ph[i]] = y;
          }
        if (first) {
          row_max(RM, u0[i] + g, m[0]);
          row_max(RM, u0[i] + g + 8, m[1]);
        }
      }
    }
  };
  for (int s = 0; s < n1; ++s) step(s, P.c1, true);
  // conv1 done in every round: quantize its output into Q (rows 0 .. R1 - 1
  // of each phase) for the second conv
  __syncthreads();
  quantize_rows<CP, NWARPS, true>(S, LS, Q, SD, RM, 0, R1, R1, F, P.C);
  for (int s = n1; s < nsteps; ++s) step(s, P.c2, false);
  __syncthreads();

  // 3. the residual, coalesced over time, U segments of 32 samples in
  // flight per warp as in 1
  const int nseg = (TS + 31) / 32, total = P.C * nseg;
  const unsigned magic = div_magic(nseg);
  for (int g0 = warp; g0 < total; g0 += U * NWARPS) {
    float v[U];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int gi = g0 + i * NWARPS, c = fast_div(gi, nseg, magic);
      const int s = (gi - c * nseg) * 32 + lane, t = t0 + s;
      v[i] = (gi < total && s < TS && t < P.Tp)
                 ? __ldg(xb + (size_t)c * P.Tp + t) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int gi = g0 + i * NWARPS, c = fast_div(gi, nseg, magic);
      const int s = (gi - c * nseg) * 32 + lane, t = t0 + s;
      if (gi < total && s < TS && t < P.Tp) {
        const float y2 = S[c * LS + s], sc = __ldg(s2 + c);
        float y;
        if (bias) {  // v + (y2 * s2 + b2), as storage_residual
          const float yb = fmaf(y2, sc, __ldg(b2 + c));
          y = P.bf16 ? __fadd_rn(round_bf16(v[i]), round_bf16(yb))
                     : __fadd_rn(v[i], yb);
        } else {
          y = P.bf16 ? __fadd_rn(round_bf16(v[i]),
                                 round_bf16(__fmul_rn(y2, sc)))
                     : fmaf(y2, sc, v[i]);
        }
        ob[(size_t)c * P.Tp + t] = y;
      }
    }
  }
}

template <int CP, bool GENERAL>
int launch_units(const float* x, float* out, float* tmp, const int8_t* w1,
                 const int8_t* w2, const float* scales, const float* bias,
                 int B, Params P, int n_units, const int* dil,
                 const int* exact_small, int smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      int8_mma_unit<CP, GENERAL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err == cudaSuccess)  // all of the SM's L1 as shared memory
    err = cudaFuncSetAttribute(int8_mma_unit<CP, GENERAL>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((P.Tp + P.TS - 1) / P.TS, B);
  const int k = P.c1.k, k2 = P.c2.k;
  const float* src = x;
  for (int u = 0; u < n_units; ++u) {
    P.c1.d = dil[u];
    P.c1.dq = P.c1.d / P.F;
    P.c1.dr = P.c1.d % P.F;
    P.c1.span = (k - 1) * P.c1.d;
    P.hrow = (P.c1.span + P.F - 1) / P.F;
    P.c1.lr = P.R1 + P.hrow;
    P.c1.halo = P.hrow;
    P.c1.exact_small = exact_small[2 * u];
    P.c2.exact_small = exact_small[2 * u + 1];
    // the last unit writes out; earlier ones alternate so no unit reads
    // the buffer it writes
    float* dst = (n_units - 1 - u) % 2 == 0 ? out : tmp;
    const float* sc = scales + (size_t)u * 2 * CP;
    const float* bs = bias == nullptr ? nullptr : bias + (size_t)u * 2 * CP;
    int8_mma_unit<CP, GENERAL><<<grid, 32 * warps_for(CP), smem, s>>>(
        src, dst, w1 + (size_t)u * k * CP * CP, w2 + (size_t)u * k2 * CP * CP,
        sc, sc + CP, bs, bs == nullptr ? nullptr : bs + CP, P);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    src = dst;
  }
  return 0;
}

// launch_units at the kernel's width cp
template <bool GENERAL>
int launch_width(int cp, const float* x, float* out, float* tmp,
                 const int8_t* w1, const int8_t* w2, const float* scales,
                 const float* bias, int B, const Params& P, int n_units,
                 const int* dil, const int* exact_small, int smem,
                 cudaStream_t s) {
  auto run = [&](auto launch) {
    return launch(x, out, tmp, w1, w2, scales, bias, B, P, n_units, dil,
                  exact_small, smem, s);
  };
  switch (cp) {
    case 32:
      return run(launch_units<32, GENERAL>);
    case 64:
      return run(launch_units<64, GENERAL>);
    case 128:
      return run(launch_units<128, GENERAL>);
    case 256:
      return run(launch_units<256, GENERAL>);
    default:
      return run(launch_units<512, GENERAL>);
  }
}

}  // namespace

// x, out, tmp: (B, C, Tp) contiguous f32, Tp a multiple of the fold F;
// w1: (n_units, k, cp, cp) and w2: (n_units, k2, cp, cp) int8 as
// [u][tap][out][in], channels zero-padded to cp, the next of 32, 64, 128,
// 256 and 512; scales: (n_units, 2, cp) f32 weight scales of the two
// convs; bias: (n_units, 2, cp) f32 or null; dil: n_units ints and
// exact_small: 2 n_units ints (host memory), exact_small[2 u + i] = 1
// where every int32 partial of conv i of unit u is below 2^22; act: 0 ELU,
// 1 LeakyReLU(slope); tile: samples per block, a multiple of 16 F;
// sglobal: null, or B ceil(Tp / tile) C (r1 f + 1) f32 for the f32 buffer
// (r1 the rows per phase of conv1, int8_mma_geometry's) where it does not
// fit a block's shared memory beside the rest;
// taps_per_stage, kc, nbuf: the weight pipeline's stage (kc input
// channels of taps_per_stage taps; taps_per_stage > 1 only with kc = cp)
// and its buffers (2 to 4); bf16: the storage is bf16 (x holds bf16
// values).  x is read only; with one unit tmp is not used.
extern "C" int int8_mma_stack_forward(
    const void* x, void* out, void* tmp, const void* w1, const void* w2,
    const void* scales, const void* bias, void* sglobal, int B, int C,
    int Tp, int cp,
    int F, int k, int k2, int n_units, const int* dil,
    const int* exact_small, int act, float slope, int tile,
    int taps_per_stage, int kc, int nbuf, int bf16, void* stream) {
  if ((cp != 32 && cp != 64 && cp != 128 && cp != 256 && cp != 512) ||
      C < 1 || C > cp || B < 1 || Tp < 1 || F < 1 || Tp % F || k < 1 ||
      k2 < 1 || n_units < 1 || (act != ELU && act != LEAKY) ||
      tile < 16 * F || tile % (16 * F) || kc < 32 || kc % 32 || cp % kc ||
      taps_per_stage < 1 || nbuf < 2 || nbuf > 4 ||
      (taps_per_stage > 1 && kc != cp))
    return (int)cudaErrorInvalidValue;
  Params P;
  P.C = C;
  P.Tp = Tp;
  P.F = F;
  P.TS = tile;
  P.R = tile / F;
  // conv1 runs over whole M tiles that reach k2 - 1 samples before the tile
  const int hrow2 = (k2 - 1 + F - 1) / F;
  P.R1 = (P.R + hrow2 + 15) / 16 * 16;
  P.X = P.R1 - P.R;
  const int kmax = k > k2 ? k : k2;
  P.tps = taps_per_stage < kmax ? taps_per_stage : kmax;
  P.kc = kc;
  P.nkc = cp / kc;
  P.nbuf = nbuf;
  P.act = act;
  P.slope = slope;
  P.has_bias = bias != nullptr;
  P.bf16 = bf16;
  const int mpr = (warps_for(cp) / (cp / NW)) * MT;
  P.c1.k = k;
  P.c1.per_phase = P.R1 / 16;
  P.c1.rounds = (F * P.R1 / 16 + mpr - 1) / mpr;
  P.c1.nst = (k + P.tps - 1) / P.tps * P.nkc;
  P.c2.k = k2;
  P.c2.d = 1;
  P.c2.dq = 1 / F;
  P.c2.dr = 1 % F;
  P.c2.span = k2 - 1;
  P.c2.per_phase = P.R / 16;
  P.c2.lr = P.R1;
  P.c2.halo = P.X;
  P.c2.rounds = (F * P.R / 16 + mpr - 1) / mpr;
  P.c2.nst = (k2 + P.tps - 1) / P.tps * P.nkc;
  int lr_max = 0;
  for (int u = 0; u < n_units; ++u) {
    if (dil[u] < 1) return (int)cudaErrorInvalidValue;
    const int hrow = ((k - 1) * dil[u] + F - 1) / F;
    if (P.R1 + hrow > lr_max) lr_max = P.R1 + hrow;
  }
  P.sg = static_cast<float*>(sglobal);
  const int smem =
      layout(cp, C, nbuf, P.tps, kc, P.R1, F, lr_max, P.sg != nullptr).total;
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const float* xs = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  float* tm = static_cast<float*>(tmp);
  const int8_t* a = static_cast<const int8_t*>(w1);
  const int8_t* b = static_cast<const int8_t*>(w2);
  const float* sc = static_cast<const float*>(scales);
  const float* bs = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return act != ELU || k2 != 1 || bias != nullptr
             ? launch_width<true>(cp, xs, o, tm, a, b, sc, bs, B, P, n_units,
                                  dil, exact_small, smem, s)
             : launch_width<false>(cp, xs, o, tm, a, b, sc, bs, B, P,
                                   n_units, dil, exact_small, smem, s);
}
