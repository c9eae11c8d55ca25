// The folded residual stack's int8 mode with "tile" scales on the int8
// tensor cores, for Hopper (sm_90a), batch mode.
//
// Replaces the TPU kernel audiodec_tpu/ops/pallas/folded_stack.py
// folded_residual_stack (pallas_call at :372) in its int8 mode with "tile"
// activation scales (int8_dots=True, int8_scale="tile", `:297-306`,
// `:328-337`), the scales that `tools/folded_probe.py --int8` times, at
// every unit shape the TPU kernel takes and any width C >= 1.  A unit is
// v += conv_k2(act(mask(conv_k,d(act(v)) + b1))) + b2, act ELU
// (exp(min(v, 0)) - 1, the TPU kernel's form) or LeakyReLU(slope), any k
// and k2, biases or none, any number of units, f32 or bf16 storage, zero
// left context at t=0.  The function depends on the TPU kernel's tiling,
// which the wrapper computes (ops/kernels/folded_stack.py `tile_geometry`)
// and this kernel materializes in device memory: T zero-padded to a
// multiple of align * f samples, tiles of rows_tile folded rows, and each
// tile's window its samples plus the halo's before them (zero before
// t=0).  Every unit runs over every window, the halo recomputed with the
// window's own scales.  Per unit, over the window's valid samples
// [lo, Lw):
//
//   - y = act(v); one scale s = max|y| over the whole window, every
//     channel, the tail padding included; q = rint(y * (127 / max(s,
//     1e-12)));
//   - conv1 as ONE int32 sum over all taps and input channels (exact while
//     127^2 k C < 2^31), converted once with __int2float_rn, times
//     s * (1/127), times the output channel's weight scale (or fmaf with
//     the bias, zero before t=0), for the samples [lo + cut, Lw), cut the
//     unit's span rounded up to whole folded rows;
//   - act, a second scale over those samples, conv2 the same way over its
//     own k2 taps, giving y2 for [lo + cut + cut2, Lw); the residual
//     v = fmaf(y2, s_w2, v), or v + fmaf(y2, s_w2, b2) masked before t=0,
//     in f32 storage; in bf16 storage v = bf16(v) + bf16(y2 * s_w2 [+ b2])
//     in f32, the sum the next unit's act reads (XLA keeps that excess
//     precision on the CPU), rounded to bf16 at the end.
// Every f32 operation is an explicit _rn intrinsic or fmaf; rounding to
// int8 is half to even (adding 1.5 x 2^23), as the plain version
// (folded_residual_stack_int8_tile_plain) computes it.  Integer sums are
// exact in any order, so the tensor cores move no result.
//
// Bound on the H100 (bin/kernel_bounds.py): one read and one write of the
// activation and the int8 weights against the int8 products at 1979 TOP/s,
// 0.587 / 0.391 / 0.254 / 0.203 ms at the probe's (16, T, C) =
// (16, 480000, 32), (16, 160000, 64), (16, 40000, 128), (16, 8000, 256).
// The windows (1.4-31% more samples than T at the probe's shapes) are this
// design's cost, not the work's.
//
// Design: a window's scale needs all of the window before any of it can be
// quantized, and a window (up to 276 KB in int8 at the probe's shapes)
// does not fit one block, so each unit is two launches over all windows,
// each window split into time tiles of TS samples x all channels:
//   P. the scale pass: stage q(act(v)) of the tile and conv1's span in
//      shared memory, run conv1 on the tensor cores and fold
//      max|act(conv1)| into the window's second scale; nothing is written;
//      It keeps q(act(v)) of its samples in device memory (int8, a
//      quarter of v's bytes);
//   Q. the unit: copy q(act(v)) back, recompute conv1 over the tile and
//      the k2 - 1 samples before it, quantize act(conv1) with the second
//      scale into shared memory, run conv2, add the residual, write v and
//      fold max|act(v)| into the next unit's scale.
// So conv1's output never reaches device memory (the recomputed products
// are cheap on the tensor cores), and a unit reads v twice, writes it
// once, and writes and reads its int8 codes once.  A first launch builds the windows from x ((B, C, T), through a
// 32 x 32 transpose in shared memory) and takes the first unit's scale;
// the last unit writes its tile's samples into out, channel-major, from
// shared memory.  Windows are sample-major, (window, sample, channel), so
// a warp's lanes take consecutive channels of one sample.  A call is
// 2 n_units + 1 launches.
//
// The products: mma.sync m16n8k32 s8 x s8 -> s32.  An M tile is 16
// consecutive samples (in the tile mode every tap shares one accumulator,
// so no fold enters the arithmetic); tap j of an output row reads the
// staged row shifted by j d, loaded with ldmatrix from rows of CP + 16
// bytes (CP, C padded to a multiple of 32 with zeros, exact in integers;
// the stride keeps ldmatrix free of bank conflicts).  A warp takes MT M
// tiles x 32 output channels at a time and sums every tap and input
// channel into one int32 accumulator.  The weights are packed in the
// mma's B-fragment order, 8 bytes a lane per (tap, 32 input channels, 8
// output channels), and read from L1/L2 with one 8-byte load each.
//
// The scales are taken with atomicMax on the bits of non-negative floats,
// whose order is the floats' order: a max is exact in any order, so the
// result does not depend on the blocks' schedule.
//
// Plain C interface for ctypes: pointers and the stream as void*, ints as
// int, the slope as float; returns the first CUDA error, or
// cudaErrorInvalidValue for arguments it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 8, NTHREADS = 32 * NWARPS;
constexpr int U = 8;                  // loads a lane keeps in flight
constexpr int BUILD_SAMPLES = 256;    // window samples a build block takes
constexpr int SMEM_LIMIT = 232448;    // bytes a block may use on sm_90
constexpr float QMAX = 127.f;
constexpr float MAGIC = 12582912.f;   // 1.5 x 2^23
constexpr int MAGIC_BITS = 0x4B400000;
enum { ELU = 0, LEAKY = 1 };

// one launch
struct TileP {
  int C, CP, T;          // channels, padded to a multiple of 32, samples
  int nt, step, H, Lw;   // tiles per batch row, samples per tile, halo
                         // samples, window samples
  int k, k2, d, span;    // conv widths, conv1's dilation, (k - 1) d
  int lo, cut, cut2;     // the unit's first valid window sample, the cuts
  int TS;                // output samples per block
  int act, has_bias, bf16, last;
  float slope;
};

__device__ __forceinline__ float activate(float v, int act, float slope) {
  if (act == LEAKY) return v > 0.f ? v : __fmul_rn(v, slope);
  return v > 0.f ? v : __fsub_rn(expf(fminf(v, 0.f)), 1.f);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// rint(y * r) for |y * r| <= 127: adding 1.5 x 2^23 rounds half to even
__device__ __forceinline__ int quant(float y, float r) {
  return __float_as_int(__fadd_rn(__fmul_rn(y, r), MAGIC)) - MAGIC_BITS;
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
                                    uint2 b, bool first) {
  if (first)
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
        : "=r"(c[0]), "=r"(c[1]), "=r"(c[2]), "=r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y),
          "r"(0));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// the block's max of non-negative floats m into *dst, by atomicMax on
// their bits through *red (0 on entry)
__device__ __forceinline__ void block_max(float m, unsigned* red,
                                          unsigned* dst) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) atomicMax(red, __float_as_uint(m));
  __syncthreads();
  if (threadIdx.x == 0) atomicMax(dst, *red);
}

// the shared-memory layout of a launch, in bytes; ops/kernels/
// folded_stack.py int8_tile_smem states the same sums: the staged rows of
// q(act(v)) (conv1's m1 M tiles and its span), and in the unit pass the
// rows of q(act(conv1)) and the f32 y2 of the tile, [sample][C | 1]
struct Layout {
  int qm, s, total;
};

__host__ __device__ inline Layout layout(int cp, int c, int ts, int k2,
                                         int span, bool full) {
  const int qs = cp + 16;
  const int m1 = full ? (ts + k2 - 1 + 15) / 16 : ts / 16;
  Layout l;
  l.qm = (16 * m1 + span) * qs;
  l.s = l.qm + (full ? 16 * m1 * qs : 0);
  l.total = l.s + (full ? 4 * ts * (c | 1) : 0);
  return l;
}

// act(v) of window samples [pos0, pos0 + rows) quantized with r into rows
// of QS bytes (channels padded to CP with zeros, samples at or past Lw
// zero).  A warp takes U rows at a time, a lane per channel of a segment
// of 32, and loads all U before it uses any, so that enough loads are in
// flight
__device__ __forceinline__ void stage(const float* __restrict__ Vw, int pos0,
                                      int rows, float r, int8_t* Qa,
                                      const TileP& P) {
  const int QS = P.CP + 16, lane = threadIdx.x & 31;
  for (int r0 = (threadIdx.x >> 5) * U; r0 < rows; r0 += NWARPS * U)
    for (int c = lane; c < P.CP; c += 32) {
      float v[U];
#pragma unroll
      for (int i = 0; i < U; ++i) {
        const int pos = pos0 + r0 + i;
        v[i] = r0 + i < rows && c < P.C && pos < P.Lw
                   ? __ldg(Vw + (size_t)pos * P.C + c) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < U; ++i)
        if (r0 + i < rows)
          Qa[(r0 + i) * QS + c] =
              (int8_t)quant(activate(v[i], P.act, P.slope), r);
    }
}

// one warp's item of a conv: M tiles mg * MT .. + MT - 1 (of mtiles) x
// output channels ng * 32 .. + 31, every tap j (rows shifted by j d) and
// input channel in one int32 sum; the weight fragments of the next two
// steps are loaded while a step's products run
template <int MT>
__device__ __forceinline__ void conv_item(const int8_t* A, int QS,
                                          int mtiles, int k, int d,
                                          const uint2* __restrict__ w,
                                          int nkc, int mg, int ng,
                                          int (&acc)[MT][4][4]) {
  const int lane = threadIdx.x & 31, nt = nkc * 4, steps = k * nkc;
  const uint2* wb = w + (size_t)ng * 4 * 32 + lane;  // + step * nt * 32
  uint2 b[4], b1[4], b2[4];  // this step's fragments, the next two's
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    b[n] = __ldg(wb + (size_t)n * 32);
    b1[n] = steps > 1 ? __ldg(wb + ((size_t)nt + n) * 32) : b[n];
  }
  int j = 0, kc = 0;
  for (int st = 0; st < steps; ++st) {
#pragma unroll
    for (int n = 0; n < 4; ++n)
      b2[n] = st + 2 < steps ? __ldg(wb + ((size_t)(st + 2) * nt + n) * 32)
                             : b1[n];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int mt = mg * MT + i;
      if (mt >= mtiles) continue;
      uint32_t af[4];
      ldmatrix_x4(af, A + (mt * 16 + j * d + (lane & 15)) * QS + kc * 32 +
                          (lane >> 4) * 16);
#pragma unroll
      for (int n = 0; n < 4; ++n) mma(acc[i][n], af, b[n], st == 0);
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      b[n] = b1[n];
      b1[n] = b2[n];
    }
    if (++kc == nkc) {
      kc = 0;
      ++j;
    }
  }
}

// a's window scale as f32 from its bits
__device__ __forceinline__ float scale_of(const unsigned* s, int w) {
  return __uint_as_float(__ldg(s + w));
}

// builds the windows from x (B, C, T), f32 or bf16, and folds max|act(v)|
// of each into the first unit's scale; blocks of (window, BUILD_SAMPLES
// samples), 32 x 32 at a time
__global__ void __launch_bounds__(NTHREADS)
build_windows(const void* __restrict__ x, float* __restrict__ V,
              unsigned* __restrict__ s0, const TileP P) {
  __shared__ float tile[32][33];
  __shared__ unsigned red;
  const int w = blockIdx.x, b = w / P.nt;
  const int lane = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int tb = (w % P.nt) * P.step - P.H;
  if (threadIdx.x == 0) red = 0u;
  float m = 0.f;
  const int p1 = min(P.Lw, (blockIdx.y + 1) * BUILD_SAMPLES);
  for (int p0 = blockIdx.y * BUILD_SAMPLES; p0 < p1; p0 += 32) {
    for (int c0 = 0; c0 < P.C; c0 += 32) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = c0 + ty + 8 * i, pos = p0 + lane, t = tb + pos;
        float v = 0.f;
        if (c < P.C && pos < P.Lw && t >= 0 && t < P.T) {
          const size_t e = ((size_t)b * P.C + c) * P.T + t;
          v = P.bf16 ? __bfloat162float(
                           static_cast<const __nv_bfloat16*>(x)[e])
                     : __ldg(static_cast<const float*>(x) + e);
        }
        tile[ty + 8 * i][lane] = v;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int pos = p0 + ty + 8 * i, c = c0 + lane;
        if (c < P.C && pos < P.Lw) {
          const float v = tile[lane][ty + 8 * i];
          V[((size_t)w * P.Lw + pos) * P.C + c] = v;
          m = fmaxf(m, fabsf(activate(v, P.act, P.slope)));
        }
      }
      __syncthreads();
    }
  }
  block_max(m, &red, s0 + w);
}

// one pass of a unit over blocks of (window, TS samples): FULL = false the
// scale pass (P), FULL = true the unit (Q)
template <int MT, bool FULL>
__global__ void __launch_bounds__(NTHREADS, MT == 2 ? 3 : 2)
tile_unit(const float* __restrict__ Vin, float* __restrict__ Vout,
          void* __restrict__ out,
          const uint2* __restrict__ w1,  // conv1 in B-fragment order
          const uint2* __restrict__ w2,  // conv2 in B-fragment order
          const float* __restrict__ s1, const float* __restrict__ s2,
          const float* __restrict__ b1, const float* __restrict__ b2,
          const unsigned* __restrict__ sa,  // act(v)'s window scales
          unsigned* __restrict__ sm,        // act(conv1)'s window scales
          unsigned* __restrict__ snext,     // the next unit's, or null
          int8_t* __restrict__ qg,          // q(act(v)), (window, sample, CP)
          const TileP P) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned red;
  const int QS = P.CP + 16, NKC = P.CP / 32, NG = P.CP / 32;
  const int w = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  // the block's output samples [p0, p0 + TS); conv1's [q0, q0 + 16 m1)
  const int p0 = P.lo + P.cut + (FULL ? P.cut2 : 0) + blockIdx.y * P.TS;
  const int q0 = FULL ? p0 - (P.k2 - 1) : p0;
  const int m1 = FULL ? (P.TS + P.k2 - 1 + 15) / 16 : P.TS / 16;
  const Layout lay = layout(P.CP, P.C, P.TS, P.k2, P.span, FULL);
  int8_t* Qa = reinterpret_cast<int8_t*>(smem);
  int8_t* Qm = reinterpret_cast<int8_t*>(smem + lay.qm);
  float* S = reinterpret_cast<float*>(smem + lay.s);
  const int SC = P.C | 1;
  const int tb = (w % P.nt) * P.step - P.H;  // t of window sample 0
  const float* Vw = Vin + (size_t)w * P.Lw * P.C;
  if (threadIdx.x == 0) red = 0u;

  const float s_a = scale_of(sa, w);
  const float sd_a = __fmul_rn(s_a, (float)(1.0 / 127.0));
  // q(act(v)) over conv1's rows and span: the scale pass quantizes it and
  // keeps its rows in qg (the first block of a window the span's too),
  // the unit copies them back, 16 bytes a thread
  const int na = 16 * m1 + P.span, vpr = P.CP / 16;
  const int8_t* qw = qg + (size_t)w * P.Lw * P.CP;
  if (!FULL) {
    stage(Vw, q0 - P.span, na, __fdiv_rn(QMAX, fmaxf(s_a, (float)1e-12)), Qa,
          P);
    __syncthreads();
    const int r0 = blockIdx.y == 0 ? 0 : P.span;
    for (int e = threadIdx.x; e < (na - r0) * vpr; e += NTHREADS) {
      const int row = r0 + e / vpr, v = e % vpr, pos = q0 - P.span + row;
      if (pos < P.Lw)
        *reinterpret_cast<uint4*>(qg + ((size_t)w * P.Lw + pos) * P.CP +
                                  v * 16) =
            *reinterpret_cast<const uint4*>(Qa + row * QS + v * 16);
    }
  } else {
    for (int e = threadIdx.x; e < na * vpr; e += NTHREADS) {
      const int row = e / vpr, v = e % vpr, pos = q0 - P.span + row;
      *reinterpret_cast<uint4*>(Qa + row * QS + v * 16) =
          pos < P.Lw ? __ldg(reinterpret_cast<const uint4*>(
                           qw + (size_t)pos * P.CP + v * 16))
                     : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  float r_m = 0.f, sd_m = 0.f;
  if (FULL) {
    const float s_m = scale_of(sm, w);
    r_m = __fdiv_rn(QMAX, fmaxf(s_m, (float)1e-12));
    sd_m = __fmul_rn(s_m, (float)(1.0 / 127.0));
  }
  __syncthreads();

  // conv1: act(y * s_a/127 * s1 [+ b1, zero before t=0]); the scale pass
  // takes its max over the window's samples, the unit quantizes it
  float mx = 0.f;
  const int items1 = (m1 + MT - 1) / MT * NG;
  for (int it = warp; it < items1; it += NWARPS) {
    const int mg = it / NG, ng = it - mg * NG;
    int acc[MT][4][4];
    conv_item<MT>(Qa, QS, m1, P.k, P.d, w1, NKC, mg, ng, acc);
    // this lane's 8 output channels: (ng * 4 + n) * 8 + 2 t4 + (0, 1)
    float ws[4][2], wb[4][2];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = (ng * 4 + n) * 8 + 2 * t4 + h;
        ws[n][h] = __ldg(s1 + c);
        wb[n][h] = P.has_bias ? __ldg(b1 + c) : 0.f;
      }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int mt = mg * MT + i;
      if (mt >= m1) continue;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        int q[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = mt * 16 + g + 8 * (e >> 1);
          const int pos = q0 + row;
          float y = __fmul_rn(__int2float_rn(acc[i][n][e]), sd_a);
          y = !P.has_bias ? __fmul_rn(y, ws[n][e & 1])
              : tb + pos < 0 ? 0.f
                             : fmaf(y, ws[n][e & 1], wb[n][e & 1]);
          y = activate(y, P.act, P.slope);
          if (!FULL) {
            if (pos < P.Lw) mx = fmaxf(mx, fabsf(y));
          } else {
            q[e] = pos < P.Lw ? quant(y, r_m) : 0;
          }
        }
        if (FULL) {
          const int row = mt * 16 + g, c = (ng * 4 + n) * 8 + 2 * t4;
          *reinterpret_cast<uint16_t*>(Qm + row * QS + c) =
              (uint16_t)((q[0] & 0xff) | ((q[1] & 0xff) << 8));
          *reinterpret_cast<uint16_t*>(Qm + (row + 8) * QS + c) =
              (uint16_t)((q[2] & 0xff) | ((q[3] & 0xff) << 8));
        }
      }
    }
  }
  if (!FULL) {
    block_max(mx, &red, sm + w);
    return;
  }
  __syncthreads();

  // conv2 over q(act(conv1)): y2 = y * s_m/127 into S
  const int m2 = P.TS / 16;
  const int items2 = (m2 + MT - 1) / MT * NG;
  for (int it = warp; it < items2; it += NWARPS) {
    const int mg = it / NG, ng = it - mg * NG;
    int acc[MT][4][4];
    conv_item<MT>(Qm, QS, m2, P.k2, 1, w2, NKC, mg, ng, acc);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int mt = mg * MT + i;
      if (mt >= m2) continue;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = mt * 16 + g + 8 * (e >> 1);
          const int c = (ng * 4 + n) * 8 + 2 * t4 + (e & 1);
          if (c < P.C)
            S[row * SC + c] = __fmul_rn(__int2float_rn(acc[i][n][e]), sd_m);
        }
    }
  }
  __syncthreads();

  // the residual, a warp U samples at a time, a lane per channel, the U
  // loads in flight as in `stage`; the last unit keeps v in S for the
  // channel-major pass below
  const int rows = min(P.TS, P.Lw - p0);
  for (int r0 = warp * U; r0 < rows; r0 += NWARPS * U)
    for (int c = lane; c < P.C; c += 32) {
      const float sc = __ldg(s2 + c);
      const float bc = P.has_bias ? __ldg(b2 + c) : 0.f;
      float v[U];
#pragma unroll
      for (int i = 0; i < U; ++i)
        v[i] = r0 + i < rows ? Vw[(size_t)(p0 + r0 + i) * P.C + c] : 0.f;
#pragma unroll
      for (int i = 0; i < U; ++i) {
        const int row = r0 + i, pos = p0 + row;
        if (row >= rows) continue;
        const float y2 = S[row * SC + c];
        float y;
        if (P.has_bias) {  // v + mask(y2 * s2 + b2), as storage_residual
          const float yb = tb + pos < 0 ? 0.f : fmaf(y2, sc, bc);
          y = P.bf16 ? __fadd_rn(round_bf16(v[i]), round_bf16(yb))
                     : __fadd_rn(v[i], yb);
        } else {
          y = P.bf16
                  ? __fadd_rn(round_bf16(v[i]), round_bf16(__fmul_rn(y2, sc)))
                  : fmaf(y2, sc, v[i]);
        }
        if (P.last) {
          S[row * SC + c] = y;
        } else {
          Vout[((size_t)w * P.Lw + pos) * P.C + c] = y;
          mx = fmaxf(mx, fabsf(activate(y, P.act, P.slope)));
        }
      }
    }
  if (!P.last) {
    block_max(mx, &red, snext + w);
    return;
  }
  __syncthreads();
  // the last unit's window is its tile: out (B, C, T), a warp per channel,
  // lanes along time (S's odd row stride keeps the reads conflict-free)
  const int b = w / P.nt;
  for (int c = warp; c < P.C; c += NWARPS)
    for (int row = lane; row < P.TS; row += 32) {
      const int pos = p0 + row, t = tb + pos;
      if (pos >= P.Lw || t >= P.T) continue;
      const float y = S[row * SC + c];
      const size_t e = ((size_t)b * P.C + c) * P.T + t;
      if (P.bf16)
        static_cast<__nv_bfloat16*>(out)[e] = __float2bfloat16_rn(y);
      else
        static_cast<float*>(out)[e] = y;
    }
}

template <int MT>
int launch_units(const void* x, void* out, float* win, int8_t* qg,
                 unsigned* scal,
                 const uint2* w1, const uint2* w2, const float* scales,
                 const float* bias, int B, TileP P, int n_units,
                 const int* dil, const int* cuts, cudaStream_t s) {
  const int W = B * P.nt;
  int smem_max = 0;
  for (int u = 0; u < n_units; ++u) {
    const int span = (P.k - 1) * dil[u];
    const int sz = layout(P.CP, P.C, P.TS, P.k2, span, true).total;
    if (sz > smem_max) smem_max = sz;
  }
  if (smem_max > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  decltype(&tile_unit<MT, false>) kernels[2] = {tile_unit<MT, false>,
                                                 tile_unit<MT, true>};
  for (auto kernel : kernels) {
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
    if (err == cudaSuccess)  // all of the SM's L1 as shared memory
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
  }
  if (err == cudaSuccess)
    err = cudaMemsetAsync(scal, 0, sizeof(unsigned) * 2 * n_units * W, s);
  if (err != cudaSuccess) return (int)err;
  unsigned* sa = scal;                       // (n_units, W)
  unsigned* sm = scal + (size_t)n_units * W;  // (n_units, W)
  float* buf[2] = {win, win + (size_t)W * P.Lw * P.C};
  const size_t wstride1 = (size_t)P.k * P.CP * P.CP / 8;   // uint2 a unit
  const size_t wstride2 = (size_t)P.k2 * P.CP * P.CP / 8;
  build_windows<<<dim3(W, (P.Lw + BUILD_SAMPLES - 1) / BUILD_SAMPLES),
                  NTHREADS, 0, s>>>(x, buf[0], sa, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  P.lo = 0;
  for (int u = 0; u < n_units; ++u) {
    P.d = dil[u];
    P.span = (P.k - 1) * P.d;
    P.cut = cuts[u];
    P.last = u == n_units - 1;
    const float* sc = scales + (size_t)u * 2 * P.CP;
    const float* bs = bias == nullptr ? nullptr : bias + (size_t)u * 2 * P.CP;
    const float* bs2 = bs == nullptr ? nullptr : bs + P.CP;
    const uint2* a = w1 + u * wstride1;
    const uint2* b = w2 + u * wstride2;
    unsigned* su = sa + (size_t)u * W;
    unsigned* mu = sm + (size_t)u * W;
    unsigned* nx = P.last ? nullptr : sa + (size_t)(u + 1) * W;
    const int n1 = P.Lw - P.lo - P.cut, n2 = n1 - P.cut2;
    if (n2 < 1) return (int)cudaErrorInvalidValue;
    const int smem1 = layout(P.CP, P.C, P.TS, P.k2, P.span, false).total;
    const int smem2 = layout(P.CP, P.C, P.TS, P.k2, P.span, true).total;
    tile_unit<MT, false><<<dim3(W, (n1 + P.TS - 1) / P.TS), NTHREADS, smem1,
                           s>>>(buf[u % 2], nullptr, nullptr, a, b, sc,
                                sc + P.CP, bs, bs2, su, mu, nullptr, qg, P);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    tile_unit<MT, true><<<dim3(W, (n2 + P.TS - 1) / P.TS), NTHREADS, smem2,
                          s>>>(buf[u % 2], buf[(u + 1) % 2], out, a, b, sc,
                               sc + P.CP, bs, bs2, su, mu, nx, qg, P);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    P.lo += P.cut + P.cut2;
  }
  return 0;
}

}  // namespace

// x, out: (B, C, T) contiguous, f32 (bf16 = 0) or bf16; win: one (n_units
// == 1) or two f32 window buffers of (B nt, Lw, C); qg: (B nt, Lw, cp) int8
// for the quantized act(v) a unit's scale pass hands its unit pass; scal:
// 2 n_units B nt
// uint32 (zeroed here); w1: (n_units, k, cp/32, cp/8, 32, 8) and w2:
// (n_units, k2, ...) int8 in B-fragment order ([tap][32 input channels][8
// output channels][lane][8 bytes], channels zero-padded to cp, a multiple
// of 32); scales: (n_units, 2, cp) f32 weight scales; bias: (n_units, 2,
// cp) f32 or null; nt, step, H, Lw: tiles per batch row, samples per tile
// (rows_tile f), halo samples (halo f) and window samples; dil, cuts:
// n_units ints (host memory), cuts[u] conv1's span rounded up to whole
// folded rows, cut2 conv2's; act: 0 ELU, 1 LeakyReLU(slope); ts: output
// samples per block (a multiple of 16), mt: 2 or 4 M tiles per warp item.
extern "C" int int8_tile_mma_forward(
    const void* x, void* out, void* win, void* qg, void* scal, const void* w1,
    const void* w2, const void* scales, const void* bias, int B, int C,
    int T, int cp, int nt, int step, int H, int Lw, int n_units,
    const int* dil, const int* cuts, int k, int k2, int cut2, int act,
    float slope, int ts, int mt, int bf16, void* stream) {
  if (B < 1 || C < 1 || T < 1 || cp < C || cp % 32 || nt < 1 || step < 1 ||
      H < 0 || Lw != step + H || n_units < 1 || k < 1 || k2 < 1 ||
      cut2 < k2 - 1 || (act != ELU && act != LEAKY) || ts < 16 || ts % 16 ||
      (mt != 2 && mt != 4))
    return (int)cudaErrorInvalidValue;
  for (int u = 0; u < n_units; ++u)
    if (dil[u] < 1 || cuts[u] < (k - 1) * dil[u])
      return (int)cudaErrorInvalidValue;
  TileP P;
  P.C = C;
  P.CP = cp;
  P.T = T;
  P.nt = nt;
  P.step = step;
  P.H = H;
  P.Lw = Lw;
  P.k = k;
  P.k2 = k2;
  P.cut2 = cut2;
  P.TS = ts;
  P.act = act;
  P.slope = slope;
  P.has_bias = bias != nullptr;
  P.bf16 = bf16;
  const uint2* a = static_cast<const uint2*>(w1);
  const uint2* b = static_cast<const uint2*>(w2);
  const float* sc = static_cast<const float*>(scales);
  const float* bs = static_cast<const float*>(bias);
  float* wn = static_cast<float*>(win);
  int8_t* q = static_cast<int8_t*>(qg);
  unsigned* sl = static_cast<unsigned*>(scal);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return mt == 4 ? launch_units<4>(x, out, wn, q, sl, a, b, sc, bs, B, P,
                                   n_units, dil, cuts, s)
                 : launch_units<2>(x, out, wn, q, sl, a, b, sc, bs, B, P,
                                   n_units, dil, cuts, s);
}
