// The folded residual stack above C = 32 with bf16 operands on the tensor
// cores, for Hopper (sm_90a), batch mode, in f32 or bf16 storage, at every
// unit shape.
//
// Replaces the TPU kernel audiodec_tpu/ops/pallas/folded_stack.py
// folded_residual_stack (pallas_call at :372) whenever its dot operands are
// rounded to bf16 (`bf16_dots`, or bf16 storage) at C from 33 to 512: a
// chain of units
//
//   v += mask(conv_k2,1(act(mask(conv_k,d(act(v)) + b1))) + b2)
//
// with act ELU or LeakyReLU(slope), any k and k2, optional biases, any
// number of units and dilations, zero left context at t=0, and mask()
// zeroing a conv output at t < 0 (folded_stack.py:285-291).  The HiFiGAN
// vocoders' resblocks above C = 32 (LeakyReLU, k = k2 = 3, 7 or 11,
// dilations 1, 3, 5, biases) are its shipped shape.  The TPU kernel's fold
// of time into the MXU's 128 lanes is a TPU workaround and is not ported.
//
// Bound on the H100 (bin/kernel_bounds.py mma_stack): one read and one
// write of the activation against units * (k + k2) * 2 C^2 FLOP per sample
// on the bf16 tensor cores.  The vocoders' resblocks at B = 16 x 10 s,
// (16, C, T) = (16, 256, 8000), (16, 128, 40000), (16, 64, 160000): 1.12 /
// 1.40 / 1.40 ms a resblock at k = 11, by operations.
//
// Design: one launch per unit (the f32 sum crosses the launches in two
// scratch buffers, as before: a tile's sum at the vocoder's widths, R x C
// f32, fits neither beside the tile in shared memory nor in the registers
// the products hold).  Within a launch, the unit as a stream:
//   - Work items are (batch row, segment of time); a persistent grid walks
//     them, and within an item the tiles of R samples in time order.  Each
//     tile restages its first conv's operand with its look-back (the look-
//     back rows were read by the tile before, so they come from L2), and
//     carries the second conv's look-back, the last k2 - 1 rows of a2, from
//     tile to tile in shared memory; a segment other than a row's first
//     starts with one tile of the first conv alone (`warm`), to fill that
//     look-back.  No conv is computed twice but that one.
//   - The operands Y = bf16(act(v)) and a2 are kept as [channel / 8][row]
//     [8] bf16, so that the 8 x 8 core matrix at any row is 128 contiguous
//     bytes and a tap's shift is a plain offset of a descriptor's start (16
//     bytes a row).  Y's rows start at a multiple of 4 samples, so that the
//     staging reads each channel in 16-byte runs (8 bytes in bf16).
//   - The products on wgmma m64n64k16, both operands through shared-memory
//     descriptors with no swizzle: M is 64 output channels of the packed
//     weights, N 64 samples of the operand; a consumer warpgroup takes 128
//     samples of the tile as two such halves, or 64 (two warpgroups of 64
//     ran C = 256 1.2-1.3x faster than one of 128: each one's f32 adds run
//     under the other's products; and at C = 512 nothing wider fits).
//   - The weights stream through a ring of `ns` stages, each 64 output x 64
//     input channels of one tap, laid out as wgmma reads them
//     (ops/kernels/folded_stack.py _pack_wide), one `cp.async.bulk` copy
//     issued by a producer warpgroup on the stage's `full` mbarrier; the
//     consumer warpgroups (1 or 2) release a stage on its `empty` mbarrier
//     once their products from it are done.  The weights of one unit, 180
//     KB at C = 64 and 2.9 MB at C = 256, do not fit beside a tile, so
//     every tile streams them once, from L2.  The producer warpgroup gives
//     its registers to the consumers (setmaxnreg): three warps share a
//     sub-partition, and a lone producer warp had held every thread to 168
//     registers, spilling the products.
//   - The sums: a stage's four k-steps run as two chains of two on the
//     tensor cores (32 products, the first k-step from zero), each chain
//     into registers of its own, all in flight together (one wait a
//     stage); the chains are then added to the running f32 sum in k-step
//     order with round-to-nearest adds.  One accumulator chained through
//     many k-steps drifts from exact sums (ROADMAP, "Tensor-core sums
//     drift"): chains of 4 put a case of chip_smoke.py's wide check past
//     its bar (1.195e-3 against 1e-3, C = 64, T = 50), chains of 2 and of
//     1 (the replaced kernel's sums, bit for bit) pass every case, and 2
//     ran 5-19% faster than 1 at the vocoder's shapes (PERF.md).
//   - The first conv's epilogue writes bf16(act(acc + b1)) into a2 behind
//     its look-back; the second's stages 32 channels x 64 samples of
//     acc + b2 in shared memory and then adds the residual, read, and
//     writes the output, in 16-byte runs of a channel (the scattered
//     4-byte accesses of the accumulator layout had taken a third of the
//     time).
// Channels are padded to CP, a multiple of 64, with zero weights and
// biases, so the padded channels stay zero.  ops/kernels/folded_stack.py
// wide_geometry picks the warpgroups and ns (this file's `smem_bytes`
// states the same sum) and wide_split the segments.
//
// Rounding points (the TPU kernel's and the plain version's,
// ops/kernels/folded_stack.py folded_residual_stack_plain): act in f32, ELU
// as expm1 in f32 storage (F.elu) and as exp(min(v, 0)) - 1 in bf16
// storage; bf16 operands and f32 sums; biases added in f32; the residual
// the TPU statement `v = v + y2.astype(v.dtype)` (:367) as XLA computes it:
// in f32 storage v + y2; in bf16 storage the f32 sum s = bf16(v) + bf16(y2),
// which the next unit's act reads and the stream holds rounded to bf16
// (storage_residual): so the buffers between the launches hold s in f32,
// and the last launch writes bf16(s).  The weights come rounded to bf16
// from the wrapper.
//
// Plain C interface for ctypes: pointers and the stream as void*, ints as
// int, the slope as float; returns the first CUDA error of the launches, or
// cudaErrorInvalidValue for arguments it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "bulk_ring.cuh"


namespace {

using bf16 = __nv_bfloat16;
using bulk_ring::bulk_copy;
using bulk_ring::mbar_arrive;
using bulk_ring::mbar_expect_tx;
using bulk_ring::mbar_fence_init;
using bulk_ring::mbar_init;
using bulk_ring::mbar_wait;
using bulk_ring::smem_u32;

constexpr int WM = 64;               // output channels of one wgmma
constexpr int NH = 64;               // samples of one wgmma
constexpr int KK = 4;                // k-steps of a weight stage
// k-steps the tensor cores chain before their sum is added to the running
// f32 sum (32 products), and the chains of a stage
constexpr int CHAIN = 2, NCH = KK / CHAIN;
// samples of a row of the epilogue's staging: 64, and 8 more so that a
// warp's float2 stores of 8 rows x 4 pairs hit distinct banks
constexpr int YS = 72;
constexpr int MAX_WG = 2;            // consumer warpgroups
constexpr int THREADS = 128 * (MAX_WG + 1);  // and one producer warpgroup
// registers a thread of a consumer and of the producer warpgroup holds
// (setmaxnreg): three warps share a sub-partition's 16384 at most
constexpr int CONSUMER_REGS = 232, PRODUCER_REGS = 40;
constexpr int MAX_UNITS = 256;
constexpr int SMEM_LIMIT = 232448;   // bytes a block may use on sm_90
enum { ELU = 0, LEAKY = 1 };  // the C interface's act
// the kernel's: ELU as expm1 (f32 storage) or exp(min(v, 0)) - 1 (bf16)
enum { ACT_EXPM1 = 0, ACT_EXP = 1, ACT_LEAKY = 2 };

// one unit's launch
struct Unit {
  int C, T, CP;
  int k, k2, d;
  int has_bias;
  float slope;
  int nwg;           // consumer warpgroups, N samples each
  int R;             // samples of a tile: N * nwg
  int ns;            // ring stages
  int yr, ar;        // rows of Y (R + (k - 1) max d) and of a2 (R + k2 - 1)
  int seg, nseg, items;  // samples of a segment, segments of a row, items
  int in_bf16, out_bf16, bf16;  // storage of in and out; bf16 storage
};

// act in f32, without a branch: a divergent branch around exp keeps the
// compiler from overlapping a thread's activations with each other
template <int ACT>
__device__ __forceinline__ float activate(float v, float slope) {
  if (ACT == ACT_LEAKY) return v > 0.f ? v : __fmul_rn(slope, v);
  const float m = v > 0.f ? 0.f : v;
  return v > 0.f ? v
                 : (ACT == ACT_EXPM1 ? expm1f(m) : __fsub_rn(expf(m), 1.f));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float load_any(const void* p, size_t i, int bf) {
  return bf ? __bfloat162float(static_cast<const bf16*>(p)[i])
            : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_any(void* p, size_t i, float v,
                                          int bf) {
  if (bf)
    static_cast<bf16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(REGS));
}
template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(REGS));
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// the threads' writes to shared memory, visible to wgmma (async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(PENDING)
               : "memory");
}
// keep the compiler from moving reads of the registers above the wait
__device__ __forceinline__ void pin(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}

// a K-major operand without swizzle: 8 x 8 core matrices of 128 contiguous
// bytes, those adjacent in K `lbo` bytes apart and in M or N `sbo`
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// d (64 x 64, the m64n64 accumulator layout) = [d +] A x B, both through
// descriptors, K-major; scale_d = 0 sums from zero
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Y = bf16(act(x)) of channels 0 .. CP - 1 at times tin .. tin + rows - 1
// into rows 0 .. rows - 1, zero outside [0, T) and past C: a thread takes
// one time and 8 channels (neighbouring threads, neighbouring times, so
// each load instruction reads a run of a channel), SU of them before it
// stores any, and stores them as one 16-byte chunk
template <int ACT>
__device__ __forceinline__ void stage_y(bf16* Y, const void* in, size_t base,
                                        int tin, int rows, int nthreads,
                                        int tid, const Unit& P) {
  constexpr int SU = 8;
  const int total = rows * (P.CP / 8);
  for (int e0 = tid; e0 < total; e0 += SU * nthreads) {
    float v[SU][8];
#pragma unroll
    for (int u = 0; u < SU; ++u) {
      const int e = e0 + u * nthreads;
      const int cg = e / rows, r = e - cg * rows, t = tin + r;
      const bool live = e < total && t >= 0 && t < P.T;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int ch = cg * 8 + c;
        v[u][c] = live && ch < P.C
                      ? load_any(in, base + (size_t)ch * P.T + t, P.in_bf16)
                      : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < SU; ++u) {
      const int e = e0 + u * nthreads;
      if (e >= total) break;
      const int cg = e / rows, r = e - cg * rows;
      __align__(16) bf16 h[8];
#pragma unroll
      for (int c = 0; c < 8; ++c)
        h[c] = __float2bfloat16_rn(activate<ACT>(v[u][c], P.slope));
      *reinterpret_cast<uint4*>(Y + ((size_t)cg * P.yr + r) * 8) =
          *reinterpret_cast<const uint4*>(h);
    }
  }
}


// out = residual(v, y) of 32 channels (c0 + 16 (r / 8) + r % 8 for staging
// row r) x 64 samples from tout, y staged in ys; the 128 threads of a
// warpgroup each take runs of 4 samples, v read and out written as one
// 16- or 8-byte access where the row's alignment allows
__device__ __forceinline__ void residual_out(const float* ys, const void* in,
                                             void* out, size_t base, int c0,
                                             int tout, int wt,
                                             const Unit& P) {
  const bool vec = (P.T & 3) == 0;
#pragma unroll
  for (int e = wt; e < 32 * 16; e += 128) {
    const int r = e >> 4, q = e & 15;
    const int o = c0 + 16 * (r >> 3) + (r & 7), t = tout + 4 * q;
    if (o >= P.C || t >= P.T) continue;
    const float4 y = *reinterpret_cast<const float4*>(ys + r * YS + 4 * q);
    const size_t i = base + (size_t)o * P.T + t;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    const float yv[4] = {y.x, y.y, y.z, y.w};
    const bool whole = vec && t + 4 <= P.T;
    if (whole && P.in_bf16) {
      const uint2 raw = *reinterpret_cast<const uint2*>(
          static_cast<const bf16*>(in) + i);
      const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = __bfloat162float(h[j]);
    } else if (whole) {
      const float4 f = *reinterpret_cast<const float4*>(
          static_cast<const float*>(in) + i);
      v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
    } else {
      for (int j = 0; j < 4 && t + j < P.T; ++j)
        v[j] = load_any(in, i + j, P.in_bf16);
    }
    float s[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      s[j] = P.bf16 ? __fadd_rn(round_bf16(v[j]), round_bf16(yv[j]))
                    : __fadd_rn(v[j], yv[j]);
    if (whole && P.out_bf16) {
      __align__(8) bf16 h[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) h[j] = __float2bfloat16_rn(s[j]);
      *reinterpret_cast<uint2*>(static_cast<bf16*>(out) + i) =
          *reinterpret_cast<const uint2*>(h);
    } else if (whole) {
      *reinterpret_cast<float4*>(static_cast<float*>(out) + i) =
          make_float4(s[0], s[1], s[2], s[3]);
    } else {
      for (int j = 0; j < 4 && t + j < P.T; ++j)
        store_any(out, i + j, s[j], P.out_bf16);
    }
  }
}

// stage_y with times read as runs of 4 (one 16- or 8-byte load a thread):
// rows from ta, a multiple of 4, so Y's row r is time ta + r; a warp takes
// 8 channels x 16 times, SU runs a thread in flight
template <int ACT>
__device__ __forceinline__ void stage_y_vec(bf16* Y, const void* in,
                                            size_t base, int ta, int rows,
                                            int nwarps, int warp, int lane,
                                            const Unit& P) {
  constexpr int SU = 8;
  const int nqb = (rows + 15) / 16;           // blocks of 16 rows
  const int total = (P.CP / 8) * nqb;
  const int c8 = lane & 7, qi = lane >> 3;
  for (int e0 = warp; e0 < total; e0 += SU * nwarps) {
    float v[SU][4];
#pragma unroll
    for (int u = 0; u < SU; ++u) {
      const int e = e0 + u * nwarps;
      const int cg = e / nqb, qb = e - cg * nqb;
      const int ch = cg * 8 + c8, t = ta + 16 * qb + 4 * qi;
      const size_t i = base + (size_t)ch * P.T + t;
#pragma unroll
      for (int j = 0; j < 4; ++j) v[u][j] = 0.f;
      if (e >= total || ch >= P.C) continue;
      if (t >= 0 && t + 4 <= P.T) {
        if (P.in_bf16) {
          const uint2 raw = *reinterpret_cast<const uint2*>(
              static_cast<const bf16*>(in) + i);
          const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
          for (int j = 0; j < 4; ++j) v[u][j] = __bfloat162float(h[j]);
        } else {
          const float4 f = *reinterpret_cast<const float4*>(
              static_cast<const float*>(in) + i);
          v[u][0] = f.x, v[u][1] = f.y, v[u][2] = f.z, v[u][3] = f.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (t + j >= 0 && t + j < P.T)
            v[u][j] = load_any(in, i + j, P.in_bf16);
      }
    }
#pragma unroll
    for (int u = 0; u < SU; ++u) {
      const int e = e0 + u * nwarps;
      if (e >= total) break;
      const int cg = e / nqb, qb = e - cg * nqb;
      bf16* y = Y + ((size_t)cg * P.yr + 16 * qb + 4 * qi) * 8 + c8;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (16 * qb + 4 * qi + j < P.yr)
          y[j * 8] = __float2bfloat16_rn(activate<ACT>(v[u][j], P.slope));
    }
  }
}

// N: the samples of a consumer warpgroup, N / 64 wgmmas a k-step
template <int N, int ACT>
__global__ void __launch_bounds__(THREADS, 1)
wide_unit_wg(const void* __restrict__ in, void* __restrict__ out,
             const bf16* __restrict__ w1,   // packed, _pack_wide
             const bf16* __restrict__ w2,
             const float* __restrict__ b1,  // (CP) or null
             const float* __restrict__ b2,  // (CP) or null
             const __grid_constant__ Unit P) {
  constexpr int NA = N / 2;                 // accumulators a thread holds
  constexpr int KC = 16 * KK;               // input channels of a stage
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int stage_bytes = WM * KC * 2;
  unsigned char* ring = smem;                          // ns stages
  bf16* Y = reinterpret_cast<bf16*>(ring + P.ns * stage_bytes);
  bf16* A2 = Y + (size_t)(P.CP / 8) * P.yr * 8;
  float* epi = reinterpret_cast<float*>(A2 + (size_t)(P.CP / 8) * P.ar * 8);
  uint64_t* bars = reinterpret_cast<uint64_t*>(epi + P.nwg * 32 * YS);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + P.ns);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int consumers = 128 * P.nwg;
  const int nob = P.CP / WM, nkb = P.CP / KC;
  const int h1 = (P.k - 1) * P.d;

  if (tid == 0) {
    for (int s = 0; s < P.ns; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * P.nwg);  // one arrive per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * P.nwg) {
    // the producer warpgroup, its registers given to the consumers: one
    // thread streams every stage the consumers read, in their order: per
    // tile the first conv's (64 output channels at a time, tap by tap, KC
    // input channels a stage), then the second's
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == 4 * P.nwg && lane == 0) {
      uint32_t q = 0;
      auto conv = [&](const bf16* w, int taps) {
        for (int ob = 0; ob < nob; ++ob)
          for (int j = 0; j < taps; ++j)
            for (int kb = 0; kb < nkb; ++kb, ++q) {
              const int s = q % P.ns, use = q / P.ns;
              if (use > 0) mbar_wait(empty0 + 8 * s, (use - 1) & 1);
              mbar_expect_tx(full0 + 8 * s, stage_bytes);
              // stage (ob, j, kb): 8 x 8 x 8 blocks kb KC / 8 .. of tap j
              bulk_copy(smem_u32(ring + s * stage_bytes),
                        w + ((size_t)(ob * taps + j) * (P.CP / 8) +
                             kb * (KC / 8)) * 512,
                        stage_bytes, full0 + 8 * s);
            }
      };
      for (int item = blockIdx.x; item < P.items; item += gridDim.x) {
        const int lo = (item % P.nseg) * P.seg;
        const int hi = min(P.T, lo + P.seg);
        if (lo > 0) conv(w1, P.k);  // the warm tile
        for (int t0 = lo; t0 < hi; t0 += P.R) {
          conv(w1, P.k);
          conv(w2, P.k2);
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns samples wg N .. wg N + N - 1 of a tile
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = warp >> 2, w4 = warp & 3, wt = tid & 127;
  const int g = lane >> 2, tq = lane & 3;
  const uint32_t ring0 = smem_u32(ring);
  const uint32_t y0 = smem_u32(Y), a0 = smem_u32(A2);
  uint32_t q = 0;
  float acc[NA];

  // acc = the conv of the operand at `op` (rows `orows` a channel group;
  // output row p of tap j reads row p + j * step) for output channels
  // ob * 64 .. + 63, stage by stage from the ring: the warpgroup's samples
  // as two halves of 64 (one wgmma each), each half's k-steps in chains of
  // CHAIN, every chain summed from zero into registers of its own, then
  // added to acc in k-step order
  auto conv = [&](uint32_t op, int orows, int taps, int step, int ob) {
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] = 0.f;
    const int nst = taps * nkb;
    for (int st = 0; st < nst; ++st) {
      const int s = (q + st) % P.ns;
      mbar_wait(full0 + 8 * s, ((q + st) / P.ns) & 1);
      const int j = st / nkb, kb = st - j * nkb;
      const uint32_t wa = ring0 + s * stage_bytes;
      const uint32_t xb =
          op + ((uint32_t)kb * (KC / 8) * orows + wg * N + j * step) * 16;
      constexpr int NHALF = N / NH;
      float d[NHALF][NCH][NH / 2];
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < NHALF; ++h)
#pragma unroll
        for (int kk = 0; kk < KK; ++kk)
          wgmma_ss(d[h][kk / CHAIN], desc(wa + kk * 2048, 1024, 128),
                   desc(xb + (h * NH + kk * 2 * orows) * 16, orows * 16,
                        128),
                   kk % CHAIN);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < NHALF; ++h)
#pragma unroll
        for (int c = 0; c < NCH; ++c)
#pragma unroll
          for (int i = 0; i < NH / 2; ++i) pin(d[h][c][i]);
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int h = 0; h < NHALF; ++h)
#pragma unroll
          for (int i = 0; i < NH / 2; ++i)
            acc[h * NH / 2 + i] = __fadd_rn(acc[h * NH / 2 + i], d[h][c][i]);
    }
    q += nst;
  };

  for (int item = blockIdx.x; item < P.items; item += gridDim.x) {
    const int b = item / P.nseg;
    const int lo = (item - b * P.nseg) * P.seg;
    const int hi = min(P.T, lo + P.seg);
    const size_t base = (size_t)b * P.C * P.T;
    if (lo == 0) {
      // a row's start: the second conv's look-back is zero (t < 0)
      for (int e = tid; e < (P.CP / 8) * (P.k2 - 1); e += consumers) {
        const int cg = e / (P.k2 - 1), r = e - cg * (P.k2 - 1);
        *reinterpret_cast<uint4*>(A2 + ((size_t)cg * P.ar + r) * 8) =
            make_uint4(0, 0, 0, 0);
      }
    }
    for (int t0 = lo > 0 ? lo - P.R : lo; t0 < hi; t0 += P.R) {
      const bool warm = t0 < lo;
      // the first sample of the thread's output pairs; its rows are
      // channels o_h = ob * 64 + w4 * 16 + g + 8 h
      const int p0 = wg * N + 2 * tq;
      // Y = bf16(act(v)) at t0 - h1 .. t0 + R - 1
      // Y = bf16(act(v)) from ta, t0 - h1 rounded down to a multiple of 4,
      // to t0 + R - 1: Y's row r is time ta + r
      const int ta = (t0 - h1) & ~3, yoff = t0 - h1 - ta;
      if ((P.T & 3) == 0)
        stage_y_vec<ACT>(Y, in, base, ta, P.R + h1 + yoff, consumers / 32,
                         warp, lane, P);
      else
        stage_y<ACT>(Y, in, base, ta, P.R + h1 + yoff, consumers, tid, P);
      fence_async_smem();
      bar_sync(1, consumers);

      // the first conv: a2 = bf16(act(acc + b1)) at rows k2 - 1 + p
      for (int ob = 0; ob < nob; ++ob) {
        conv(y0 + yoff * 16, P.yr, P.k, P.d, ob);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int o = ob * WM + w4 * 16 + g + 8 * h;
          const float bo = P.has_bias ? __ldg(b1 + o) : 0.f;
          bf16* col = A2 + ((size_t)(o >> 3) * P.ar + P.k2 - 1 + p0) * 8 +
                      (o & 7);
#pragma unroll
          for (int i = 0; i < N / 8; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              col[(8 * i + e) * 8] = __float2bfloat16_rn(activate<ACT>(
                  __fadd_rn(acc[4 * i + 2 * h + e], bo), P.slope));
        }
      }
      fence_async_smem();
      bar_sync(1, consumers);

      if (!warm) {
        // the second conv, then b2 and the residual: a warpgroup's 32
        // channels x 64 samples at a time through shared memory, so that
        // the residual is read and the output written in runs of 4
        // samples a thread, neighbouring threads on neighbouring runs of a
        // channel
        float* ys = epi + wg * 32 * YS;
        for (int ob = 0; ob < nob; ++ob) {
          conv(a0, P.ar, P.k2, 1, ob);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int o = ob * WM + w4 * 16 + g + 8 * h;
            const float bo = P.has_bias ? __ldg(b2 + o) : 0.f;
#pragma unroll
            for (int half = 0; half < N / 64; ++half) {
              float* yr = ys + (w4 * 8 + g) * YS + 2 * tq;
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                const int ai = 4 * (8 * half + i) + 2 * h;
                *reinterpret_cast<float2*>(yr + 8 * i) =
                    make_float2(__fadd_rn(acc[ai], bo),
                                __fadd_rn(acc[ai + 1], bo));
              }
              bar_sync(2 + wg, 128);
              residual_out(ys, in, out, base, ob * WM + 8 * h,
                           t0 + wg * N + 64 * half, wt, P);
              bar_sync(2 + wg, 128);
            }
          }
        }
      }
      // every read of a2 and Y is done; the next tile's look-back of a2,
      // its last k2 - 1 rows, moves to the front
      bar_sync(1, consumers);
      if (t0 + P.R < hi)
        for (int e = tid; e < (P.CP / 8) * (P.k2 - 1); e += consumers) {
          const int cg = e / (P.k2 - 1), r = e - cg * (P.k2 - 1);
          bf16* rowp = A2 + ((size_t)cg * P.ar + r) * 8;
          *reinterpret_cast<uint4*>(rowp) =
              *reinterpret_cast<const uint4*>(rowp + (size_t)P.R * 8);
        }
    }
  }
}

// shared memory of a block in bytes; ops/kernels/folded_stack.py
// wide_smem states the same sum: the ring (and its two mbarriers a
// stage), Y and a2 ([CP / 8][rows][8] bf16) and the epilogue's staging
int smem_bytes(int cp, int yr, int ar, int nwg, int ns) {
  return ns * (WM * 16 * KK * 2 + 16) + 2 * cp * (yr + ar) +
         nwg * 32 * YS * 4;
}

template <int N, int ACT>
cudaError_t launch(const void* src, void* dst, const bf16* wa,
                   const bf16* wb, const float* ba, const float* bb,
                   const Unit& P, int grid, int threads, int smem,
                   cudaStream_t s) {
  auto kernel = wide_unit_wg<N, ACT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, s>>>(src, dst, wa, wb, ba, bb, P);
  return cudaGetLastError();
}

// the kernel for the unit's activation and storage
template <int N>
cudaError_t launch_act(int act, const void* src, void* dst, const bf16* wa,
                       const bf16* wb, const float* ba, const float* bb,
                       const Unit& P, int grid, int threads, int smem,
                       cudaStream_t s) {
  if (act == LEAKY)
    return launch<N, ACT_LEAKY>(src, dst, wa, wb, ba, bb, P, grid, threads,
                                smem, s);
  if (P.bf16)
    return launch<N, ACT_EXP>(src, dst, wa, wb, ba, bb, P, grid, threads,
                              smem, s);
  return launch<N, ACT_EXPM1>(src, dst, wa, wb, ba, bb, P, grid, threads,
                              smem, s);
}

cudaError_t launch_unit(int act, int n, const void* src, void* dst,
                        const bf16* wa, const bf16* wb, const float* ba,
                        const float* bb, const Unit& P, int grid,
                        int threads, int smem, cudaStream_t s) {
  return n == 128 ? launch_act<128>(act, src, dst, wa, wb, ba, bb, P, grid,
                                    threads, smem, s)
                  : launch_act<64>(act, src, dst, wa, wb, ba, bb, P, grid,
                                   threads, smem, s);
}

long long cuda_launches = 0;  // kernel launches made, for the checks

}  // namespace

// the CUDA launches this library has made (one per unit of each call)
extern "C" long long wide_stack_cuda_launches() { return cuda_launches; }

// x, out: (B, C, T) contiguous, float32 (storage_bf16 = 0) or bfloat16;
// scratch: two (B, C, T) float32 buffers (one suffices for two units, none
// for one) that carry the f32 sum between the units; x is read only.
// w1: (n_units, cp / 64, k, cp / 8, 8, 8, 8) and w2 the same with k2, bf16
// (ops/kernels/folded_stack.py _pack_wide), channels zero-padded from C to
// cp (a multiple of 64); bias: (n_units, 2, cp) float32 or null; dil:
// n_units dilations (host memory); act: 0 ELU, 1 LeakyReLU(slope); n: the
// samples of a warpgroup (128 or 64); nwg: consumer warpgroups (1 or 2);
// ns: ring stages (at least 2); seg, nseg: samples of a segment (a
// multiple of n * nwg) and segments of a row; grid: blocks.
extern "C" int wide_stack_forward(
    const void* x, void* out, void* scratch, const void* w1, const void* w2,
    const void* bias, int B, int C, int T, int cp, int n_units,
    const int* dil, int k, int k2, int act, float slope, int n, int nwg,
    int ns, int storage_bf16, int seg, int nseg, int grid, void* stream) {
  if (B < 1 || C < 1 || T < 1 || cp < C || cp % WM || n_units < 1 ||
      n_units > MAX_UNITS || k < 1 || k2 < 1 ||
      (act != ELU && act != LEAKY) || (n != 64 && n != 128) || nwg < 1 ||
      nwg > MAX_WG || ns < 2 || seg < 1 || seg % (n * nwg) || nseg < 1 ||
      (long long)seg * nseg < T || (long long)seg * (nseg - 1) >= T ||
      grid < 1 || (long long)B * nseg > (1ll << 30) ||
      (n_units > 1 && scratch == nullptr) || n * nwg < k2 - 1)
    return (int)cudaErrorInvalidValue;
  int dmax = 0;
  for (int u = 0; u < n_units; ++u) {
    if (dil[u] < 1) return (int)cudaErrorInvalidValue;
    if (dil[u] > dmax) dmax = dil[u];
  }
  Unit P;
  P.C = C;
  P.T = T;
  P.CP = cp;
  P.k = k;
  P.k2 = k2;
  P.has_bias = bias != nullptr;
  P.slope = slope;
  P.nwg = nwg;
  P.R = n * nwg;
  P.ns = ns;
  P.yr = P.R + (k - 1) * dmax + 4;
  P.ar = P.R + k2 - 1;
  P.seg = seg;
  P.nseg = nseg;
  P.items = B * nseg;
  P.bf16 = storage_bf16;
  // the descriptors' 14-bit byte offsets (>> 4) and start addresses
  if (P.yr >= (1 << 14) || P.ar >= (1 << 14))
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(cp, P.yr, P.ar, nwg, ns);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const int threads = 128 * (nwg + 1);
  if (grid > P.items) grid = P.items;
  const bf16* wa = static_cast<const bf16*>(w1);
  const bf16* wb = static_cast<const bf16*>(w2);
  const float* bs = static_cast<const float*>(bias);
  float* buf[2] = {static_cast<float*>(scratch),
                   static_cast<float*>(scratch) + (size_t)B * C * T};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* src = x;
  const size_t unit1 = (size_t)k * cp * cp, unit2 = (size_t)k2 * cp * cp;
  for (int u = 0; u < n_units; ++u) {
    const bool last = u == n_units - 1;
    void* dst = last ? out : static_cast<void*>(buf[u % 2]);
    P.d = dil[u];
    P.in_bf16 = u == 0 ? storage_bf16 : 0;
    P.out_bf16 = last ? storage_bf16 : 0;
    const float* ba = bs == nullptr ? nullptr : bs + (size_t)u * 2 * cp;
    const float* bb = bs == nullptr ? nullptr : bs + (size_t)u * 2 * cp + cp;
    const cudaError_t err =
        launch_unit(act, n, src, dst, wa + u * unit1, wb + u * unit2, ba, bb,
                    P, grid, threads, smem, s);
    if (err != cudaSuccess) return (int)err;
    ++cuda_launches;
    src = dst;
  }
  return 0;
}
