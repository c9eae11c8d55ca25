// The folded residual stack's int8 mode with "row" scales on the int8
// tensor cores, for Hopper (sm_90a), batch mode.
//
// Replaces the TPU kernel audiodec_tpu/ops/pallas/folded_stack.py
// folded_residual_stack (pallas_call at :372) in its int8 mode with "row"
// activation scales (int8_dots=True, int8_scale="row"), the mode that
// `codec_test --dtype int8-decode` runs for every decoder stack, at any
// width C from 4 to 256 and any fold.  A unit is
// v += conv1x1(ELU(conv_k_dil_d(ELU(v)))), no biases, any k, any number of
// units, f32 or bf16 storage, zero left context at t=0, and both convs
// multiply int8 by int8 into int32:
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
//     acc = fmaf(part, s_row[u + o], acc) from zero; then acc * s_weight;
//     the residual is v = fmaf(y2, s_weight2, v) in f32 storage; in bf16
//     storage the buffers hold f32 values, the sum
//     bf16(v) + bf16(y2 * s_weight2) that the next unit's ELU reads (XLA
//     keeps that excess precision on the CPU), rounded to bf16 where the
//     residual is read and by the wrapper at the end.
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
//   1. ELU(v) for the tile and its left halo of whole rows (the conv's
//      span, zero before t=0) is staged as f32, [channel][sample], in
//      chunks of TS samples (a warp keeps U loads of 32 samples in
//      flight); one warp per folded row takes its absmax and quantizes it
//      to int8 rows of CP channels, the next of 32, 64, 128 and 256 (zero
//      padded: exact in integers), laid out phase-major,
//      Q[t mod F][t div F][CP + 16 bytes];
//   2. conv1 on the tensor cores, mma.sync m16n8k32 s8 x s8 -> s32: an M
//      tile is 16 consecutive folded rows of one phase p, so all its rows
//      share one tap-to-offset map (tap j reads phase (p + j d - span)
//      mod F at row offset o = floor((p + j d - span) / F), advanced from
//      tap to tap without a division) and its A operand is 16 consecutive
//      rows of Q, loaded with ldmatrix; the taps of one offset chain in
//      the s32 accumulator (the chain's first mma adds to zero), and at
//      each change of offset (ascending with j) the warp flushes it
//      through the per-row fmaf in registers: the TPU kernel's per-offset
//      dot, with no per-element bookkeeping.  At F = 1 every tap is its own
//      offset.  Each warp owns 2 M tiles x 32 output channels;
//   3. ELU(acc * s1) goes to the f32 buffer, [channel][sample], its rows'
//      absmax to shared memory (the four lanes of a row by shuffles, then
//      atomicMax), and it is quantized per row as in 1; the 1x1 conv runs
//      the same way (one offset), y2 = part * s_row goes to the f32
//      buffer, and the residual is read and written with coalesced
//      accesses.
// Blocks are 8 warps at CP <= 64, two per SM (in half the SM's shared
// memory), and 16 warps at CP >= 128, one per SM: with 113-118 registers a
// thread, two blocks let one block's loads and stores overlap the other's
// products.  TS = 256 samples at C = 32, 128 at 64 and 128, 64 at 256,
// rounded up to whole M tiles of every phase; where that makes more M
// tiles than the warps hold, the block runs them in rounds.  The weights
// stream through shared memory with cp.async, a stage holding
// `taps_per_stage` taps of `kc` input channels in 2 buffers (at C = 32 all
// k taps, at 64 six, at 128 three; at C = 256 one tap's half, 32 KiB, in 3
// buffers); ops/kernels/folded_stack.py int8_mma_geometry sizes it all.  An
// int32 partial exceeds 2^22 only when 127^2 C times the taps of one offset
// does; below that (every decoder stack) it converts to f32 exactly by
// adding 1.5 x 2^23 to its bits (`exact_small`), else with cvt.rn.f32.s32.
// What holds it back: PERF.md §7.
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

// warps per block: 8 at CP <= 64, two blocks per SM; 16 above, one block
__host__ __device__ constexpr int warps_for(int cp) {
  return cp <= 64 ? 8 : 16;
}
constexpr float MAGIC = 12582912.f;   // 1.5 x 2^23
constexpr int MAGIC_BITS = 0x4B400000;

// one unit's launch
struct Params {
  int C, Tp, F;
  int TS, R;          // tile samples, tile rows (TS / F)
  int k, d, span;     // conv1 width, dilation, (k - 1) d
  int dq, dr;         // d / F, d % F
  int hrow, LR;       // halo rows, staged rows (R + hrow)
  int rounds, tps, kc, nkc, nbuf;
  int exact_small, bf16;
};

__device__ __forceinline__ float elu(float v) {
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

__host__ __device__ inline Layout layout(int cp, int nbuf, int tps, int kc,
                                         int ts, int f, int lr_max) {
  Layout l;
  l.w = 0;                                    // nbuf x tps x cp x (kc + 16)
  l.q = l.w + nbuf * tps * cp * (kc + 16);    // f x lr x (cp + 16)
  l.s = l.q + f * lr_max * (cp + 16);               // cp x (ts + 1) f32
  l.sd = l.s + 4 * cp * (ts + 1);                   // lr f32
  l.rm = l.sd + 4 * lr_max;                         // ts / f u32
  l.total = l.rm + 4 * (ts / f);
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

template <int CP>
__global__ void __launch_bounds__(32 * warps_for(CP), 16 / warps_for(CP))
int8_mma_unit(const float* __restrict__ x, float* __restrict__ out,
              const int8_t* __restrict__ w1,  // (k, CP, CP) [tap][out][in]
              const int8_t* __restrict__ w2,  // (CP, CP) [out][in]
              const float* __restrict__ s1,   // (CP) conv1 weight scales
              const float* __restrict__ s2,   // (CP) 1x1 weight scales
              const Params P) {
  constexpr int QS = CP + 16;
  constexpr int NWARPS = warps_for(CP), NTHREADS = 32 * NWARPS;
  constexpr int NS = CP / NW;                 // warps across the channels
  constexpr int MPR = (NWARPS / NS) * MT;     // M tiles per round
  extern __shared__ __align__(16) unsigned char smem[];
  const int F = P.F, TS = P.TS, R = P.R, LS = TS + 1, KS = P.kc + 16;
  const Layout lay = layout(CP, P.nbuf, P.tps, P.kc, TS, F, P.LR);
  int8_t* Wbuf = reinterpret_cast<int8_t*>(smem + lay.w);
  int8_t* Q = reinterpret_cast<int8_t*>(smem + lay.q);
  float* S = reinterpret_cast<float*>(smem + lay.s);
  float* SD = reinterpret_cast<float*>(smem + lay.sd);
  unsigned* RM = reinterpret_cast<unsigned*>(smem + lay.rm);
  const int wbuf_bytes = P.tps * CP * KS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TS;       // first output sample of the tile
  const int H = P.hrow * F;
  const float* xb = x + (size_t)b * P.C * P.Tp;
  float* ob = out + (size_t)b * P.C * P.Tp;

  // the steps of the weight pipeline: rounds x conv1 stages, then
  // rounds x 1x1 stages
  const int groups = (P.k + P.tps - 1) / P.tps;
  const int nst1 = groups * P.nkc;
  const int n1 = P.rounds * nst1;
  const int nsteps = n1 + P.rounds * P.nkc;
  // stage s into buffer s mod nbuf, one commit group per call (empty past
  // the last stage, so that every step waits on the same group count)
  auto issue = [&](int s) {
    if (s >= nsteps) {
      cp_async_commit();
      return;
    }
    int8_t* dst = Wbuf + (s % P.nbuf) * wbuf_bytes;
    int j0 = 0, ntaps = 1, kci;
    const int8_t* src;
    if (s < n1) {
      const int r = s % nst1;
      kci = r % P.nkc;
      j0 = (r / P.nkc) * P.tps;
      ntaps = min(P.tps, P.k - j0);
      src = w1 + (size_t)j0 * CP * CP;
    } else {
      kci = (s - n1) % P.nkc;
      src = w2;
    }
    const int vpr = P.kc / 16;  // 16-byte vectors per weight row
    for (int e = tid; e < ntaps * CP * vpr; e += NTHREADS) {
      const int row = e / vpr, v = e - row * vpr;  // row = tap * CP + out
      cp_async16(dst + row * KS + v * 16,
                 src + (size_t)row * CP + kci * P.kc + v * 16);
    }
    cp_async_commit();
  };
  for (int s = 0; s < P.nbuf - 1; ++s) issue(s);
  for (int e = tid; e < R; e += NTHREADS) RM[e] = 0u;

  // 1. ELU(v) over the halo and the tile, in chunks of TS samples, each
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
        if (gi < total && s < n) S[c * LS + s] = elu(v[i]);
      }
    }
    __syncthreads();
    quantize_rows<CP, NWARPS, false>(S, LS, Q, SD, RM, cs / F, n / F, P.LR,
                                     F, P.C);
    __syncthreads();
  }

  // this warp's channels and M tiles (slot i of round rd: M tile
  // rd * MPR + mgroup * MT + i, phase mt / (R / 16), rows from
  // 16 * (mt % (R / 16)))
  const int nbase = (warp % NS) * NW;
  const int mgroup = warp / NS;
  const int mtiles = TS / 16, per_phase = R / 16;
  float acc[MT][NW / 8][4];
  int iacc[MT][NW / 8][4];
  bool fresh[MT];

  for (int s = 0; s < nsteps; ++s) {
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
    const bool conv1 = s < n1;
    const int rd = conv1 ? s / nst1 : (s - n1) / P.nkc;
    const int r = conv1 ? s % nst1 : (s - n1) % P.nkc;
    const int kci = r % P.nkc;
    const int j0 = conv1 ? (r / P.nkc) * P.tps : 0;
    const int ntaps = conv1 ? min(P.tps, P.k - j0) : 1;
    // off, pp: the row offset and phase that tap j of each M tile reads,
    // advanced by d = dq F + dr from tap to tap
    int mt[MT], ph[MT], u0[MT], off[MT], pp[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      mt[i] = rd * MPR + mgroup * MT + i;
      ph[i] = mt[i] / per_phase;
      u0[i] = 16 * (mt[i] % per_phase);
      const int a = ph[i] + j0 * P.d - P.span;
      off[i] = conv1 ? floor_div(a, F) : 0;
      pp[i] = conv1 ? a - off[i] * F : ph[i];
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
        const int row = conv1 ? pp[i] * P.LR + u0[i] + P.hrow + off[i]
                              : ph[i] * R + u0[i];
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
      if (!conv1 || kci != P.nkc - 1) continue;
      // a change of offset ends a chain: flush it through the row scales
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        int pn = pp[i] + P.dr, on = off[i] + P.dq;
        if (pn >= F) {
          pn -= F;
          ++on;
        }
        const int o = off[i];
        off[i] = on;
        pp[i] = pn;
        if (mt[i] >= mtiles || (j + 1 < P.k && on == o)) continue;
        const int ra = u0[i] + g + P.hrow + o;
        const float sa = SD[ra], sb = SD[ra + 8];
#pragma unroll
        for (int n = 0; n < NW / 8; ++n) {
          acc[i][n][0] = fmaf(to_f32(iacc[i][n][0], P.exact_small), sa,
                              acc[i][n][0]);
          acc[i][n][1] = fmaf(to_f32(iacc[i][n][1], P.exact_small), sa,
                              acc[i][n][1]);
          acc[i][n][2] = fmaf(to_f32(iacc[i][n][2], P.exact_small), sb,
                              acc[i][n][2]);
          acc[i][n][3] = fmaf(to_f32(iacc[i][n][3], P.exact_small), sb,
                              acc[i][n][3]);
        }
        fresh[i] = true;  // the next chain's first mma starts from zero
      }
    }

    const bool last = conv1 ? r == nst1 - 1 : r == P.nkc - 1;
    if (last) {
      // conv1: ELU(acc * s1) and its rows' absmax (rows u0 + g and
      // u0 + g + 8, over the 4 lanes of a row); the 1x1 conv:
      // y2 = part * s_row; both to S
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
            float y;
            if (conv1) {
              y = elu(__fmul_rn(acc[i][n][q], __ldg(s1 + c)));
              m[q >> 1] = fmaxf(m[q >> 1], fabsf(y));
            } else {
              y = __fmul_rn(to_f32(iacc[i][n][q], P.exact_small), SD[row]);
            }
            S[c * LS + row * F + ph[i]] = y;
          }
        if (conv1) {
          row_max(RM, u0[i] + g, m[0]);
          row_max(RM, u0[i] + g + 8, m[1]);
        }
      }
    }
    if (s == n1 - 1) {
      // conv1 done in every round: quantize its output into Q (rows
      // 0 .. R - 1 of each phase) for the 1x1 conv
      __syncthreads();
      quantize_rows<CP, NWARPS, true>(S, LS, Q, SD, RM, 0, R, R, F, P.C);
    }
  }
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
        ob[(size_t)c * P.Tp + t] =
            P.bf16 ? __fadd_rn(round_bf16(v[i]), round_bf16(__fmul_rn(y2, sc)))
                   : fmaf(y2, sc, v[i]);
      }
    }
  }
}

template <int CP>
int launch_units(const float* x, float* out, float* tmp, const int8_t* w1,
                 const int8_t* w2, const float* scales, int B, Params P,
                 int n_units, const int* dil, const int* exact_small,
                 int smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      int8_mma_unit<CP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)  // all of the SM's L1 as shared memory
    err = cudaFuncSetAttribute(int8_mma_unit<CP>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((P.Tp + P.TS - 1) / P.TS, B);
  const float* src = x;
  for (int u = 0; u < n_units; ++u) {
    P.d = dil[u];
    P.dq = P.d / P.F;
    P.dr = P.d % P.F;
    P.span = (P.k - 1) * P.d;
    P.hrow = (P.span + P.F - 1) / P.F;
    P.LR = P.R + P.hrow;
    P.exact_small = exact_small[u];
    // the last unit writes out; earlier ones alternate so no unit reads
    // the buffer it writes
    float* dst = (n_units - 1 - u) % 2 == 0 ? out : tmp;
    int8_mma_unit<CP><<<grid, 32 * warps_for(CP), smem, s>>>(
        src, dst, w1 + (size_t)u * P.k * CP * CP, w2 + (size_t)u * CP * CP,
        scales + (size_t)u * 2 * CP, scales + (size_t)u * 2 * CP + CP, P);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    src = dst;
  }
  return 0;
}

}  // namespace

// x, out, tmp: (B, C, Tp) contiguous f32, Tp a multiple of the fold F;
// w1: (n_units, k, cp, cp) int8 [u][tap][out][in], w2: (n_units, cp, cp),
// channels zero-padded to cp, the next of 32, 64, 128 and 256; scales:
// (n_units, 2, cp) f32 weight scales of conv1 and the 1x1 conv; dil,
// exact_small: n_units ints (host memory), exact_small[u] = 1 where every
// int32 partial of unit u is below 2^22; tile: samples per block, a
// multiple of 16 F; taps_per_stage, kc, nbuf: the weight pipeline's stage
// (kc input channels of taps_per_stage taps; taps_per_stage > 1 only with
// kc = cp) and its buffers (2 to 4); bf16: the storage is bf16 (x holds
// bf16 values).  x is read only; with one unit tmp is not used.
extern "C" int int8_mma_stack_forward(
    const void* x, void* out, void* tmp, const void* w1, const void* w2,
    const void* scales, int B, int C, int Tp, int cp, int F, int k,
    int n_units, const int* dil, const int* exact_small, int tile,
    int taps_per_stage, int kc, int nbuf, int bf16, void* stream) {
  if ((cp != 32 && cp != 64 && cp != 128 && cp != 256) || C < 1 || C > cp ||
      B < 1 || Tp < 1 || F < 1 || Tp % F || k < 1 || n_units < 1 ||
      tile < 16 * F || tile % (16 * F) ||
      kc < 32 || kc % 32 || cp % kc || taps_per_stage < 1 || nbuf < 2 ||
      nbuf > 4 ||
      (taps_per_stage > 1 && kc != cp))
    return (int)cudaErrorInvalidValue;
  Params P;
  P.C = C;
  P.Tp = Tp;
  P.F = F;
  P.TS = tile;
  P.R = tile / F;
  P.k = k;
  P.tps = taps_per_stage < k ? taps_per_stage : k;
  P.kc = kc;
  P.nkc = cp / kc;
  P.nbuf = nbuf;
  P.bf16 = bf16;
  const int mpr = (warps_for(cp) / (cp / NW)) * MT;
  P.rounds = (tile / 16 + mpr - 1) / mpr;
  int lr_max = 0;
  for (int u = 0; u < n_units; ++u) {
    if (dil[u] < 1) return (int)cudaErrorInvalidValue;
    const int hrow = ((k - 1) * dil[u] + F - 1) / F;
    if (P.R + hrow > lr_max) lr_max = P.R + hrow;
  }
  const int smem = layout(cp, nbuf, P.tps, kc, tile, F, lr_max).total;
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const float* xs = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  float* tm = static_cast<float*>(tmp);
  const int8_t* a = static_cast<const int8_t*>(w1);
  const int8_t* b = static_cast<const int8_t*>(w2);
  const float* sc = static_cast<const float*>(scales);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cp) {
    case 32:
      return launch_units<32>(xs, o, tm, a, b, sc, B, P, n_units, dil,
                              exact_small, smem, s);
    case 64:
      return launch_units<64>(xs, o, tm, a, b, sc, B, P, n_units, dil,
                              exact_small, smem, s);
    case 128:
      return launch_units<128>(xs, o, tm, a, b, sc, B, P, n_units, dil,
                               exact_small, smem, s);
    default:
      return launch_units<256>(xs, o, tm, a, b, sc, B, P, n_units, dil,
                               exact_small, smem, s);
  }
}
