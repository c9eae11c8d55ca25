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
// units at k = 11 in bf16 1.050 ms (by operations).  What holds it above
// that on this card (PERF.md §6, by ablation on the card): each tap
// reads its operand rows from shared memory again, 64 bytes per 2048 FLOP
// at CP = 32, the SM's whole shared-memory bandwidth at the tensor cores'
// rate; each tap's sum costs one f32 add per output (the drift rule
// below), issued after the tap's products land; and ELU costs expm1f, some
// 30 instructions, twice per element and unit in f32 storage (1.7 ms of
// the f32 autoencoder stack's 3.2 by ablation, near the card's expm1f
// throughput), and exp in bf16 storage.
//
// Design: the stack as a stream.  Each (batch row, segment of
// time) is one work item; a persistent grid of `grid` blocks walks the
// items, and within an item the tiles of `tile` = 32 x warps samples in
// time order, carrying each unit's look-back from one tile to the next
// instead of recomputing a halo.  A segment other than a row's first
// starts its stream `warm` samples early (the stack's halo, rounded up to
// tiles) from a zero look-back, so its outputs are exact from the segment's
// start on; those warm-up samples, one tile a segment of 118-157, are the
// only work done twice (the previous design recomputed 9-21%).  Zero
// look-back at t = 0 is the stack's zero left context: act(0) = 0, and the
// masked conv outputs before t = 0 are 0, so no mask remains to apply.
//   - Memory: each warp owns 32 samples of the tile (two m16 tiles) for the
//     whole stack, their f32 residual v in its registers in the m16n8
//     accumulator layout in which every conv's output lands, read from and
//     written to device memory there (each access instruction whole 32-byte
//     sectors, or both halves of one); the largest buffer of the previous
//     design, v in shared memory, is gone.  Two blocks of 8 warps share an
//     SM where their shared memory fits (the autoencoder units), so one
//     block's loads and barriers fall under the other's work; the vocoder
//     units' weights (132 KB) leave one block of 12 warps.  A prefetch of
//     the next tile into registers (one block of 8 warps) ran 1.5x slower
//     than 16 warps without it.
//   - Per unit, the warp writes bf16(act(v)) of its rows to the operand
//     buffer Y (rows of CP + 8 bf16, so each ldmatrix's eight rows hit
//     distinct banks) with stmatrix, behind the unit's look-back, which the
//     block copies in front of the tile's rows and, after the barrier,
//     replaces with the tile's last (k - 1) d rows for the next tile.  A
//     tap's operand is then plain rows at its shift.
//   - The products: the unit's weights stay in shared memory for the whole
//     launch (one unit's at a time where all do not fit, `resident` = 0);
//     at the shipped k = 7 (1x1 second conv) and k = k2 = 11, at CP = 32,
//     the taps unrolled by template on wgmma m64n32k16 (`wgmma`):
//     A the warp's m16k16 fragments by ldmatrix.x4 at the tap's rows, B
//     through a no-swizzle K-major descriptor, read once per warpgroup;
//     one commit group per m16 tile, so one tile's adds run under the
//     other's products, and with k2 > 1 the next tap's A loaded meanwhile.
//     Elsewhere mma.sync m16n8k16 over a runtime tap count, B fragments
//     in the lanes' order (one 16-byte load per lane and n8 tile).  wgmma
//     ran the autoencoder units 5% and the vocoder units 14% faster than
//     mma.sync with the same taps unrolled, with the same sums bit for bit.
//   - k2 = 1: act(acc + b1), rounded to bf16, is the 1x1 conv's A operand
//     in registers (the m16n8 accumulator layout of two n-tiles is the
//     m16k16 operand layout), and its result goes into v.  Y alternates
//     between two buffers by unit, so one barrier a unit suffices (one
//     buffer and two barriers where two do not fit, `ybufs`).
//   - k2 > 1: bf16(act(acc + b1)) goes to a second buffer M behind its own
//     look-back of k2 - 1 rows, and the second conv reads M; two barriers
//     a unit.
//   - The activation: computed once per element and conv operand, by the
//     warp that owns the element, in one loop per activation; ELU's
//     exponential is computed on every lane and selected.  The compiler's
//     branch around it per element, and the activation's switch per
//     element, had cost 17% of the f32 autoencoder stack and 24% of the
//     bf16 one (3.85 / 3.00 ms against 3.21 / 2.28).
// Each tap's products (CP of them, in CP / 16 chained k-steps) are summed
// from zero and added to the running sum with round-to-nearest f32 adds:
// one accumulator chained through many k-steps drifts from exact sums
// (ROADMAP §C, "Tensor-core sums drift").  Channels are padded to CP in
// {16, 32} with zero weights and biases, so the padded channels stay zero.
//
// Rounding points (the TPU kernel's and the plain version's,
// ops/kernels/folded_stack.py folded_residual_stack_plain), unchanged from
// the previous design, whose outputs this one reproduces bit for bit: act
// in f32, ELU as expm1f in f32 storage (F.elu) and as exp(min(v, 0)) - 1
// in bf16 storage; bf16 operands and f32 sums; biases added in f32; the
// residual the TPU statement `v = v + y2.astype(v.dtype)` (:367) as XLA
// computes it: in f32 storage v + y2; in bf16 storage the f32 sum
// s = bf16(v) + bf16(y2), which the next unit's act reads and the output
// holds rounded to bf16 (storage_residual).  The weights come rounded to
// bf16 from the wrapper.
//
// Plain C interface for ctypes: pointers and the stream as void*, ints as
// int, the slope as float; returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_UNITS = 256;
constexpr int MT = 2;                 // m16 tiles a warp owns
constexpr int WARP_ROWS = 16 * MT;    // samples a warp owns
constexpr int MAX_WARPS = 16;
constexpr int WG_WARPS = 12;          // the most of a wgmma block, k2 > 1
constexpr int SMEM_LIMIT = 232448;    // bytes a block may use on sm_90
enum { ELU = 0, LEAKY = 1 };

// the launch's arguments; a __grid_constant__ kernel parameter, so that
// dil[u] is read in place rather than from a per-thread copy
struct Params {
  int C, T, n_units, k, k2, act, has_bias;
  float slope;
  int tile;      // samples a block steps by: 32 x warps
  int seg;       // samples a segment holds (a multiple of tile)
  int nseg;      // segments a row holds
  int items;     // batch rows x nseg
  int warm;      // samples a stream starts before its segment
  int resident;  // every unit's weights in shared memory at once
  int h1rows;    // the first convs' look-back rows: sum of (k - 1) d
  int hy;        // the most of one first conv: max of (k - 1) d
  int ybufs;     // k2 = 1: Y buffers (2: one barrier a unit; 1: two)
  int dil[MAX_UNITS];
};

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// act in f32: ELU as expm1 in f32 storage, exp(min(v, 0)) - 1 in bf16.
// The exponential is computed on every lane and selected: left to itself
// the compiler branches around it per element, and with mixed signs in a
// warp the branch only adds instructions
template <bool BF16, int ACT>
__device__ __forceinline__ float act_of(float v, float slope) {
  if (ACT == LEAKY) return v > 0.f ? v : slope * v;
  float e = BF16 ? expf(fminf(v, 0.f)) - 1.f : expm1f(v);
  asm volatile("" : "+f"(e));
  return v > 0.f ? v : e;
}

// act of the warp's elements in place, one loop per activation
template <bool BF16, int NT>
__device__ __forceinline__ void activate(float (&s)[MT][NT][4], int act,
                                         float slope) {
  if (act == LEAKY) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          s[m][n][q] = act_of<BF16, LEAKY>(s[m][n][q], slope);
  } else {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          s[m][n][q] = act_of<BF16, ELU>(s[m][n][q], slope);
  }
}

// the unit's residual sum from the carried sum v and y2 (see the header)
__device__ __forceinline__ float residual(float v, float y, bool bf16) {
  return bf16 ? round_bf16(v) + round_bf16(y) : v + y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void stsm_x4(uint32_t addr,
                                        const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1,%2,%3,%4};\n"
      :: "r"(addr), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
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

// wgmma (the WG kernels): the warpgroup's fence, commit and wait, and a
// register pin that keeps the compiler from moving reads of the
// accumulators above the wait
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void pin(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}
__device__ __forceinline__ void pin(uint32_t& r) {
  asm volatile("" : "+r"(r) :: "memory");
}

// the descriptor of one tap's k-step kk of B (ops/kernels/folded_stack.py
// _pack_mma_wg): K-major, no swizzle, core matrices of 8 output channels x
// 16 bytes, those adjacent in k 512 bytes apart, in n 128 bytes
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)(512 >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

// d (the warp's 16 rows of a 64 x 32 product, the m16n8 accumulators of its
// four n8 tiles) = [d +] A x B: A the warp's m16k16 fragment, B through
// desc; scale_d = 0 sums from zero
__device__ __forceinline__ void wgmma_n32(float (&d)[16],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// one element of the input, its bits as loaded (a bf16 in the low half)
__device__ __forceinline__ uint32_t load_raw(const float* p) {
  uint32_t r;
  asm volatile("ld.global.nc.b32 %0, [%1];\n" : "=r"(r) : "l"(p));
  return r;
}
__device__ __forceinline__ uint32_t load_raw(const bf16* p) {
  uint32_t r;
  asm volatile("ld.global.nc.u16 %0, [%1];\n" : "=r"(r) : "l"(p));
  return r;
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// the warp's m16k16 operand (m16n8 accumulators of n-tiles 2 kk and
// 2 kk + 1, rounded to bf16): the registers of mma's A and of stmatrix.x4
template <int NT>
__device__ __forceinline__ void pack_a(uint32_t (&r)[4],
                                       const float (&s)[NT][4], int kk) {
  r[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
  r[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
  r[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
  r[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
}

// the lane's B fragments of one tap ([n][lane][kk][2] u32 in shared
// memory, ops/kernels/folded_stack.py _pack_mma_frag)
template <int CP>
__device__ __forceinline__ void load_b(uint32_t (&b)[CP / 8][CP / 16][2],
                                       const uint32_t* wtap, int lane) {
#pragma unroll
  for (int n = 0; n < CP / 8; ++n) {
    if constexpr (CP == 32) {
      const uint4 q = reinterpret_cast<const uint4*>(wtap)[n * 32 + lane];
      b[n][0][0] = q.x;
      b[n][0][1] = q.y;
      b[n][1][0] = q.z;
      b[n][1][1] = q.w;
    } else {
      const uint2 q = reinterpret_cast<const uint2*>(wtap)[n * 32 + lane];
      b[n][0][0] = q.x;
      b[n][0][1] = q.y;
    }
  }
}

// acc += the causal conv with `taps` taps at dilation `dil` of the bf16
// rows at `cur` (the tile's row 0, its look-back in the rows before), at
// the warp's rows; the lane's ldmatrix row r0 + 16 m at column byte colb.
// Each tap's products are summed from zero, then added to acc.  WG: on
// wgmma, one commit group per m16 tile so that the first tile's adds
// overlap the second's products; AHEAD: the next tap's A loaded while this
// tap's products run (16 registers more).
template <int CP, int KT, bool WG, bool AHEAD>
__device__ __forceinline__ void conv(float (&acc)[MT][CP / 8][4],
                                     uint32_t cur, const uint32_t* wt,
                                     int taps_rt, int dil, int r0,
                                     uint32_t colb, int lane) {
  constexpr int NT = CP / 8, KK = CP / 16, RB = (CP + 8) * 2;
  constexpr int WT = CP * CP / 2;
  const int taps = KT ? KT : taps_rt;
  const uint32_t base = cur + r0 * RB + colb;
  // tap j's A fragments
  auto load_a = [&](uint32_t (&a)[MT][KK][4], int j) {
    const uint32_t row = base - (taps - 1 - j) * dil * RB;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int kk = 0; kk < KK; ++kk)
        ldsm_x4(a[m][kk], row + m * 16 * RB + kk * 32);
  };
  if constexpr (WG) {
    uint32_t a[AHEAD ? 2 : 1][MT][KK][4];
    float d[MT][16];
    if (AHEAD) load_a(a[0], 0);
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      uint32_t (&aj)[MT][KK][4] = a[AHEAD ? j & 1 : 0];
      if (!AHEAD) load_a(aj, j);
      const uint32_t tap = smem_u32(wt + j * WT);
      wgmma_fence();
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int kk = 0; kk < KK; ++kk)
          wgmma_n32(d[m], aj[m][kk], b_desc(tap + kk * 1024), kk);
        wgmma_commit();
      }
      if (AHEAD && j + 1 < KT) load_a(a[AHEAD ? (j + 1) & 1 : 0], j + 1);
      wgmma_wait<MT - 1>();
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        pin(d[0][i]);
        acc[0][i >> 2][i & 3] += d[0][i];
      }
      wgmma_wait<0>();
#pragma unroll
      for (int m = 1; m < MT; ++m)
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          pin(d[m][i]);
          acc[m][i >> 2][i & 3] += d[m][i];
        }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int kk = 0; kk < KK; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) pin(aj[m][kk][e]);
    }
  } else {
#pragma unroll 1
    for (int j = 0; j < taps; ++j) {
      uint32_t a[MT][KK][4];
      load_a(a, j);
      uint32_t b[NT][KK][2];
      load_b<CP>(b, wt + j * WT, lane);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          float d[4];
          mma0(d, a[m][0], b[n][0]);
#pragma unroll
          for (int kk = 1; kk < KK; ++kk) mma(d, a[m][kk], b[n][kk]);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[m][n][q] += d[q];
        }
    }
  }
}

// bf16(s) of the warp's rows into the tile buffer whose row 0 is at `buf`
// (stmatrix); the block's threads copy the unit's look-back `keep` (h rows,
// kept from the last tile) into the h rows before row 0
template <int CP>
__device__ __forceinline__ void put_rows(const float (&s)[MT][CP / 8][4],
                                         bf16* buf, const bf16* keep, int h,
                                         int p0, int lrow, uint32_t colb) {
  constexpr int KK = CP / 16, RS = CP + 8, RB = RS * 2;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      uint32_t r[4];
      pack_a<CP / 8>(r, s[m], kk);
      stsm_x4(smem_u32(buf) + (p0 + 16 * m + lrow) * RB + colb + kk * 32,
              r);
    }
  for (int e = threadIdx.x; e < h * (CP / 8); e += blockDim.x) {
    const int row = e / (CP / 8), c = e - row * (CP / 8);
    reinterpret_cast<uint4*>(buf + (row - h) * RS)[c] =
        reinterpret_cast<const uint4*>(keep + row * RS)[c];
  }
}

// the look-back of the next tile: the block's threads copy the last h rows
// up to the tile's end (reaching into the rows before row 0 where h exceeds
// the tile) from the buffer at `buf` into `keep`.  Called after the barrier
// that follows put_rows, while the conv only reads the buffer
template <int CP>
__device__ __forceinline__ void keep_rows(const bf16* buf, bf16* keep, int h,
                                          int tile) {
  constexpr int RS = CP + 8;
  for (int e = threadIdx.x; e < h * (CP / 8); e += blockDim.x) {
    const int row = e / (CP / 8), c = e - row * (CP / 8);
    reinterpret_cast<uint4*>(keep + row * RS)[c] =
        reinterpret_cast<const uint4*>(buf + (tile - h + row) * RS)[c];
  }
}

// launch bounds: mma.sync up to 16 warps (128 registers); wgmma with the
// 1x1 second conv two blocks of 8 warps per SM (128), else up to 12 warps
// (168, room for AHEAD)
template <int CP, typename S, int KT, int K2T, bool WG>
__global__ void __launch_bounds__(WG ? (K2T == 1 ? 256 : 32 * WG_WARPS)
                                     : 32 * MAX_WARPS,
                                  WG && K2T == 1 ? 2 : 1)
stack_kernel(const S* __restrict__ x, S* __restrict__ out,
             const uint32_t* __restrict__ w,  // (n, k + k2) taps, frag order
             const float* __restrict__ bias,  // (n, 2, CP) or null
             const __grid_constant__ Params P) {
  constexpr bool BF16 = sizeof(S) == 2;
  constexpr bool K2ONE = K2T == 1;
  constexpr int RS = CP + 8, RB = RS * 2, NT = CP / 8, KK = CP / 16;
  constexpr int WT = CP * CP / 2;  // u32 of one tap's weights
  const int k = KT ? KT : P.k, k2 = K2T ? K2T : P.k2;
  const int utaps = k + k2, h2 = k2 - 1, tile = P.tile;
  const int nw = P.resident ? P.n_units : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* Ws = reinterpret_cast<uint32_t*>(smem);
  float* Bs = reinterpret_cast<float*>(Ws + nw * utaps * WT);
  // the tile buffers, each behind the rows of its look-back: Y once or
  // twice (k2 = 1, ybufs) or Y and M; then the look-backs kept from tile to
  // tile
  const int ys = P.hy + tile;               // rows of a Y buffer
  const int ny = K2ONE ? P.ybufs : 1;
  bf16* Y = reinterpret_cast<bf16*>(Bs + nw * 2 * CP) + P.hy * RS;
  bf16* Mb = Y + (ny - 1) * ys * RS + (K2ONE ? 0 : tile + h2) * RS;
  bf16* H1 = Mb + tile * RS;               // [h1rows]
  bf16* H2 = H1 + P.h1rows * RS;            // [n_units][k2 - 1]

  // the weights (and biases) of units u0 .. u0 + nu - 1 into slots 0 ..
  auto stage = [&](int u0, int nu) {
    const uint4* src = reinterpret_cast<const uint4*>(w) +
                       (size_t)u0 * utaps * (WT / 4);
    for (int e = threadIdx.x; e < nu * utaps * (WT / 4); e += blockDim.x)
      reinterpret_cast<uint4*>(Ws)[e] = src[e];
    if (P.has_bias)
      for (int e = threadIdx.x; e < nu * 2 * CP; e += blockDim.x)
        Bs[e] = bias[u0 * 2 * CP + e];
    // the weights, written by the threads, are read by wgmma (async proxy)
    if (WG) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };
  if (P.resident) stage(0, P.n_units);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int p0 = warp * WARP_ROWS;              // the warp's first row
  const int lrow = lane & 15;                   // its ldmatrix row ...
  const uint32_t colb = (lane >> 4) * 16;       // ... and column byte
  const int r0 = p0 + lrow;

  // the item's batch row, stream start, first stored sample and end
  auto item_of = [&](int item, int& b, int& tw, int& lo, int& hi) {
    b = item / P.nseg;
    lo = (item - b * P.nseg) * P.seg;
    hi = min(P.T, lo + P.seg);
    tw = max(0, lo - P.warm);
  };
  // the warp's elements of tile t0 of row b as loaded (load_raw), each
  // from an address clamped into the row (`take` zeroes those past C or T)
  auto load = [&](uint32_t (&r)[MT][NT][4], int b, int t0) {
    const S* xb = x + (size_t)b * P.C * P.T;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int tt = t0 + p0 + 16 * m + g + 8 * (q >> 1);
          const int c = n * 8 + 2 * t + (q & 1);
          r[m][n][q] = load_raw(xb + (size_t)min(c, P.C - 1) * P.T +
                                min(tt, P.T - 1));
        }
  };
  // v of tile t0 from what `load` loaded: f32, 0 past C or T
  auto take = [&](float (&v)[MT][NT][4], const uint32_t (&r)[MT][NT][4],
                  int t0) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int tt = t0 + p0 + 16 * m + g + 8 * (q >> 1);
          const int c = n * 8 + 2 * t + (q & 1);
          const float f = __uint_as_float(BF16 ? r[m][n][q] << 16
                                                : r[m][n][q]);
          v[m][n][q] = c < P.C && tt < P.T ? f : 0.f;
        }
  };

  int item = blockIdx.x, b, tw, lo, hi;
  item_of(item, b, tw, lo, hi);
  int t0 = tw;
  float v[MT][NT][4];
  {
    uint32_t r[MT][NT][4];
    load(r, b, t0);
    take(v, r, t0);
  }
  int ybuf = 0;
  while (true) {
    // the step after this tile: the item's next tile or the next item's
    // first
    int nitem = item, nb = b, ntw = tw, nlo = lo, nhi = hi, nt0 = t0 + tile;
    if (nt0 >= hi) {
      nitem = item + gridDim.x;
      if (nitem < P.items) {
        item_of(nitem, nb, ntw, nlo, nhi);
        nt0 = ntw;
      }
    }
    const bool more = nitem < P.items;

    if (t0 == tw) {
      // an item's first tile: zero look-back, before any thread copies it
      __syncthreads();
      const int rows = P.h1rows + P.n_units * h2;
      for (int e = threadIdx.x; e < rows * (RB / 16); e += blockDim.x) {
        const int row = e / (RB / 16), c = e - row * (RB / 16);
        bf16* base = row < P.h1rows ? H1 + row * RS
                                    : H2 + (row - P.h1rows) * RS;
        reinterpret_cast<uint4*>(base)[c] = make_uint4(0, 0, 0, 0);
      }
      __syncthreads();
    }

    int h1base = 0;
    for (int u = 0; u < P.n_units; ++u) {
      const int d = P.dil[u], h1 = (k - 1) * d;
      // the previous unit's weights, or its only Y buffer, are free
      if (!P.resident || ny == 1) __syncthreads();
      if (!P.resident) stage(u, 1);
      const int slot = P.resident ? u : 0;
      const uint32_t* Wu = Ws + slot * utaps * WT;
      const float* Bu = Bs + slot * 2 * CP;
      bf16* h1keep = H1 + h1base * RS;
      bf16* Yb = Y + (ny == 2 ? ybuf : 0) * ys * RS;
      ybuf ^= 1;

      // bf16(act(v)) of the warp's rows
      {
        float a[MT][NT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int q = 0; q < 4; ++q) a[m][n][q] = v[m][n][q];
        activate<BF16>(a, P.act, P.slope);
        put_rows<CP>(a, Yb, h1keep, h1, p0, lrow, colb);
      }
      __syncthreads();
      keep_rows<CP>(Yb, h1keep, h1, tile);

      float acc[MT][NT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[m][n][q] = 0.f;
      conv<CP, KT, WG, WG && !K2ONE>(acc, smem_u32(Yb), Wu, k, d, r0, colb,
                                     lane);
      // act(acc + b1), in place
      if (P.has_bias)
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              acc[m][n][q] += Bu[n * 8 + 2 * t + (q & 1)];
      activate<BF16>(acc, P.act, P.slope);
      if constexpr (K2ONE && WG) {
        // the 1x1 conv on bf16(act(...)) as A fragments in registers
        const uint32_t tap = smem_u32(Wu + k * WT);
        uint32_t a[MT][KK][4];
        float y2[MT][16];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int kk = 0; kk < KK; ++kk) pack_a<NT>(a[m][kk], acc[m], kk);
        wgmma_fence();
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int kk = 0; kk < KK; ++kk)
            wgmma_n32(y2[m], a[m][kk], b_desc(tap + kk * 1024), kk);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int kk = 0; kk < KK; ++kk)
#pragma unroll
            for (int e = 0; e < 4; ++e) pin(a[m][kk][e]);
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            pin(y2[m][i]);
            const int n = i >> 2, q = i & 3;
            float y = y2[m][i];
            if (P.has_bias) y += Bu[CP + n * 8 + 2 * t + (q & 1)];
            v[m][n][q] = residual(v[m][n][q], y, BF16);
          }
      } else if constexpr (K2ONE) {
        // the 1x1 conv on bf16(act(...)) as A fragments in registers
        uint32_t bw[NT][KK][2];
        load_b<CP>(bw, Wu + k * WT, lane);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          uint32_t a[KK][4];
#pragma unroll
          for (int kk = 0; kk < KK; ++kk) pack_a<NT>(a[kk], acc[m], kk);
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            float y2[4];
            mma0(y2, a[0], bw[n][0]);
#pragma unroll
            for (int kk = 1; kk < KK; ++kk) mma(y2, a[kk], bw[n][kk]);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              float y = y2[q];
              if (P.has_bias) y += Bu[CP + n * 8 + 2 * t + (q & 1)];
              v[m][n][q] = residual(v[m][n][q], y, BF16);
            }
          }
        }
      } else {
        // bf16(act(...)) into M, the second conv's operand
        bf16* h2keep = H2 + u * h2 * RS;
        put_rows<CP>(acc, Mb, h2keep, h2, p0, lrow, colb);
        __syncthreads();
        keep_rows<CP>(Mb, h2keep, h2, tile);
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[m][n][q] = 0.f;
        conv<CP, K2T, WG, WG>(acc, smem_u32(Mb), Wu + k * WT, k2, 1, r0, colb,
                              lane);
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              float y = acc[m][n][q];
              if (P.has_bias) y += Bu[CP + n * 8 + 2 * t + (q & 1)];
              v[m][n][q] = residual(v[m][n][q], y, BF16);
            }
      }
      h1base += h1;
    }

    // the tile's outputs from the segment's start on
    S* ob = out + (size_t)b * P.C * P.T;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int tt = t0 + p0 + 16 * m + g + 8 * (q >> 1);
          const int c = n * 8 + 2 * t + (q & 1);
          if (c < P.C && tt >= lo && tt < hi)
            store_f(ob + (size_t)c * P.T + tt, v[m][n][q]);
        }
    if (!more) break;
    {
      uint32_t r[MT][NT][4];
      load(r, nb, nt0);
      take(v, r, nt0);
    }
    item = nitem;
    b = nb;
    tw = ntw;
    lo = nlo;
    hi = nhi;
    t0 = nt0;
  }
}

// shared memory of one block; ops/kernels/folded_stack.py mma_smem states
// the same sum
int smem_bytes(int cp, int k, int k2, int n_units, int resident, int tile,
               int h1rows, int hy, int ybufs) {
  const int rb = (cp + 8) * 2, nw = resident ? n_units : 1;
  // the weights and biases; Y once or twice (k2 = 1) or Y and M, each
  // behind its look-back; the look-backs kept from tile to tile
  return nw * ((k + k2) * cp * cp * 2 + 2 * cp * 4) +
         (k2 == 1 ? ybufs * (tile + hy) : 2 * tile + hy + k2 - 1) * rb +
         h1rows * rb + n_units * (k2 - 1) * rb;
}

template <int CP, typename S, int KT, int K2T, bool WG = false>
int launch(const void* x, void* out, const void* w, const void* bias,
           const Params& P, int threads, int grid, int smem,
           cudaStream_t stream) {
  auto kernel = stack_kernel<CP, S, KT, K2T, WG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const S*>(x), static_cast<S*>(out),
      static_cast<const uint32_t*>(w), static_cast<const float*>(bias), P);
  return (int)cudaGetLastError();
}

// the template for the unit shape: on wgmma the taps unrolled at the
// shipped k = 7 (k2 = 1) and k = k2 = 11, at CP = 32; on mma.sync a runtime
// tap count
template <typename S>
int dispatch(int cp, int wgmma, const void* x, void* out, const void* w,
             const void* bias, const Params& P, int threads, int grid,
             int smem, cudaStream_t s) {
  if (wgmma) {
    if (cp != 32 || threads % 128 != 0 ||
        threads > (P.k2 == 1 ? 256 : 32 * WG_WARPS))
      return (int)cudaErrorInvalidValue;
    if (P.k == 7 && P.k2 == 1)
      return launch<32, S, 7, 1, true>(x, out, w, bias, P, threads, grid,
                                       smem, s);
    if (P.k == 11 && P.k2 == 11)
      return launch<32, S, 11, 11, true>(x, out, w, bias, P, threads, grid,
                                         smem, s);
    return (int)cudaErrorInvalidValue;
  }
  if (cp == 16)
    return P.k2 == 1
               ? launch<16, S, 0, 1>(x, out, w, bias, P, threads, grid, smem, s)
               : launch<16, S, 0, 0>(x, out, w, bias, P, threads, grid, smem, s);
  return P.k2 == 1
             ? launch<32, S, 0, 1>(x, out, w, bias, P, threads, grid, smem, s)
             : launch<32, S, 0, 0>(x, out, w, bias, P, threads, grid, smem, s);
}

}  // namespace

// x, out: (B, C, T) contiguous, float32 (storage_bf16 = 0) or bfloat16;
// w: (n_units, k + k2, cp / 8, 32, cp / 4) bf16, each unit's first conv's
// taps then its second's as the lanes' mma B fragments
// (ops/kernels/folded_stack.py _pack_mma_frag); bias: (n_units, 2, cp) f32
// or null; dil: n_units dilations (host memory); act: 0 ELU, 1
// LeakyReLU(slope); warps: a block's warps (its tile 32 x warps samples);
// wgmma: the products on wgmma (w in _pack_mma_wg's order), else mma.sync;
// resident: every unit's weights in shared memory at once; ybufs: with
// k2 = 1, one or two buffers of the first conv's operand; seg, nseg,
// warm: samples a segment holds, segments a row holds, samples a stream
// starts before its segment; grid: blocks.  Channels C <= cp, zero-padded
// in the weights and biases.
extern "C" int folded_stack_mma_forward(
    const void* x, void* out, const void* w, const void* bias, int B, int C,
    int T, int cp, int n_units, const int* dil, int k, int k2, int act,
    float slope, int storage_bf16, int warps, int wgmma, int resident,
    int ybufs, int seg, int nseg, int warm, int grid, void* stream) {
  if ((cp != 16 && cp != 32) || C < 1 || C > cp || B < 1 || T < 1 ||
      n_units < 1 || n_units > MAX_UNITS || k < 1 || k2 < 1 ||
      (act != ELU && act != LEAKY) || warps < 1 || warps > MAX_WARPS ||
      seg < 1 ||
      seg % (WARP_ROWS * warps) != 0 || nseg < 1 ||
      (long long)seg * nseg < T || (long long)seg * (nseg - 1) >= T ||
      warm < 0 || grid < 1 || (long long)B * nseg > (1ll << 30) ||
      ybufs < 1 || ybufs > 2)
    return (int)cudaErrorInvalidValue;
  Params P;
  P.C = C;
  P.T = T;
  P.n_units = n_units;
  P.k = k;
  P.k2 = k2;
  P.act = act;
  P.slope = slope;
  P.has_bias = bias != nullptr;
  P.tile = WARP_ROWS * warps;
  P.seg = seg;
  P.nseg = nseg;
  P.items = B * nseg;
  P.warm = warm;
  P.resident = resident != 0;
  P.ybufs = k2 == 1 ? ybufs : 1;
  P.h1rows = 0;
  P.hy = 0;
  for (int u = 0; u < n_units; ++u) {
    if (dil[u] < 1) return (int)cudaErrorInvalidValue;
    P.dil[u] = dil[u];
    P.h1rows += (k - 1) * dil[u];
    P.hy = P.hy > (k - 1) * dil[u] ? P.hy : (k - 1) * dil[u];
  }
  const int smem = smem_bytes(cp, k, k2, n_units, P.resident, P.tile,
                              P.h1rows, P.hy, P.ybufs);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  grid = grid < P.items ? grid : P.items;
  const int threads = 32 * warps;
  if (storage_bf16)
    return dispatch<bf16>(cp, wgmma, x, out, w, bias, P, threads, grid, smem,
                          s);
  return dispatch<float>(cp, wgmma, x, out, w, bias, P, threads, grid, smem,
                         s);
}
