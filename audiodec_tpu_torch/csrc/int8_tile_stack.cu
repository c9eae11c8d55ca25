// Causal residual stack with int8 dot products and one activation scale per
// time tile, for Hopper (sm_90a), batch mode.
//
// Replaces the TPU kernel audiodec_tpu/ops/pallas/folded_stack.py
// folded_residual_stack (pallas_call at :372) in its int8 mode with "tile"
// activation scales (int8_dots=True, int8_scale="tile", `:297-306`,
// `:328-337`), the scales that `tools/folded_probe.py --int8` times.  A unit
// is v += conv1x1(ELU(conv_k7_dil_d(ELU(v)))), no biases, f32 or bf16
// storage, zero left context at t=0.  The function depends on the TPU
// kernel's tiling, which the wrapper computes (ops/kernels/folded_stack.py
// `tile_geometry`) and this kernel materializes in device memory: T
// zero-padded to a multiple of align * f samples, tiles of rows_tile
// folded rows, and each tile's window its samples plus the halo's before
// them (zero before t=0).  Every unit runs over every window, the halo
// recomputed with the window's own scales.  Per unit, over the window's
// valid samples [in0, S):
//
//   - y = ELU(v) (exp(min(v, 0)) - 1, the TPU kernel's form); one scale
//     s = max|y| over the whole window, every channel, the tail padding
//     included; q = rint(y * (127 / max(s, 1e-12)));
//   - the k=7 conv as ONE int32 sum over all taps and input channels
//     (|sum| <= 127^2 * 7 * C = 2.9e7 at C = 256: no overflow), converted
//     once with __int2float_rn, times s * (1/127), times the output
//     channel's weight scale, for the samples [in0 + cut, S), cut the
//     unit's span rounded up to whole folded rows;
//   - ELU, a second scale over those samples, the 1x1 conv the same way,
//     giving y2; the residual v = fmaf(y2, s_w2, v) in f32 storage; in
//     bf16 storage v = bf16(v) + bf16(y2 * s_w2) in f32, the sum the next
//     unit's ELU reads (XLA keeps that excess precision on the CPU), rounded
//     to bf16 where the residual is read and by the wrapper at the end;
//   - the valid samples start at in0 + cut.
// Every f32 operation is an explicit _rn intrinsic or fmaf and the int8
// rounding is __float2int_rn (half to even), as the plain version
// (folded_residual_stack_int8_tile_plain) computes them.
//
// Bound on the H100 (bin/kernel_bounds.py): one read and one write of the
// activation and the int8 weights against the int8 products at 1979 TOP/s,
// 0.587 / 0.391 / 0.254 / 0.203 ms at the probe's (16, T, C) =
// (16, 480000, 32), (16, 160000, 64), (16, 40000, 128), (16, 8000, 256).
// The windows (1.4-31% more samples than T at the probe's shapes) and the
// scratch of the conv's output are this design's cost, not the work's.
// This first version runs the products with __dp4a on the CUDA cores, so
// it is bound by the dp4a rate and its shared-memory operand loads.
//
// Design: a window's scale needs all of the window before any of it can be
// quantized, and a window (up to 276 KB in int8 at the probe's shapes) does
// not fit one block, so every unit is two launches over all windows, each
// window split into time tiles of TS samples x all C channels.  Windows and
// scratch are sample-major, (window, sample, channel): a warp's lanes take
// consecutive channels of one sample, so every load and store of device
// memory is one contiguous run (a first version kept the (channel, sample)
// layout, and its strided epilogues made the 1x1 launch cost more than the
// k=7 one).  Two more kernels build the windows from x and take the
// output apart from them, each through a 32 x 32 transpose in shared
// memory so that both sides of the copy run along contiguous addresses
// (a second version left both copies to PyTorch, 6.4 ms at C = 32); the
// build also takes the first unit's scale.
//   1. conv1: stage q of the tile and its left span in shared memory
//      (sample-major int8, channels padded to CP, a multiple of 16), dot
//      with __dp4a (16-byte weight loads from L2, operands broadcast in the
//      warp), write the dequantized output to the scratch `acc`, and fold
//      max|ELU(acc)| into the window's second scale;
//   2. the 1x1 conv: stage q of acc, dot, update v in place (each element
//      read and written by one thread), and fold max|ELU(v)| into the next
//      unit's scale.
// The scales are taken with atomicMax on the bits of non-negative floats,
// whose order is the floats' order: a max is exact in any order, so the
// result does not depend on the blocks' schedule.  A call is 2 n_units + 2
// launches.
//
// Plain C interface for ctypes: pointers and the stream as void*, ints as
// int; returns the first CUDA error, or 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int K = 7;
constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int NT = 8;              // samples per thread and pass
constexpr int MAX_UNITS = 3;
constexpr int TILE_BYTES = 32768;  // target TS x CP int8 operands per block
constexpr int TP = 32;             // the windows' transpose tile
constexpr float QMAX = 127.f;

struct Unit {
  int C, CP, S, d, in0, out0, TS, bf16;
};

__device__ __forceinline__ float elu(float v) {
  return v > 0.f ? v : __fsub_rn(expf(fminf(v, 0.f)), 1.f);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ int dot16(const int4 a, const int4 b, int acc) {
  acc = __dp4a(a.x, b.x, acc);
  acc = __dp4a(a.y, b.y, acc);
  acc = __dp4a(a.z, b.z, acc);
  return __dp4a(a.w, b.w, acc);
}

__device__ __forceinline__ int8_t quantize(float y, float r) {
  return (int8_t)__float2int_rn(__fmul_rn(y, r));
}

// the block's max of non-negative m, folded into *dst with one atomicMax on
// the float's bits; every thread of the block must call it
__device__ void block_max_to(float m, float* dst) {
  __shared__ float warp_max[NWARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < NWARPS; ++i) m = fmaxf(m, warp_max[i]);
    atomicMax(reinterpret_cast<unsigned int*>(dst), __float_as_uint(m));
  }
}

__device__ __forceinline__ float load_x(const void* x, size_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(x)[i])
              : static_cast<const float*>(x)[i];
}

// the windows from x (B, C, T) in the storage dtype: window w = (b, i)
// holds samples g = i * step - halo + s, s in [0, S), zero outside [0, T),
// sample-major in f32; and the first unit's scale, max|ELU| over the
// window.  A block takes TP samples of one window, all channels, through a
// TP x TP transpose in shared memory: loads run along samples, stores
// along channels.
__global__ void __launch_bounds__(NTHREADS)
window_kernel(const void* __restrict__ x, float* __restrict__ win,
              float* __restrict__ s_act, int C, int T, int S, int n_tiles,
              int step, int halo, int bf16) {
  __shared__ float tile[TP][TP + 1];
  const int w = blockIdx.x, b = w / n_tiles, i = w - b * n_tiles;
  const int s0 = blockIdx.y * TP;       // the block's first window sample
  const int g0 = i * step - halo + s0;  // its sample in x
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* ww = win + (size_t)w * S * C;
  float m = 0.f;
  for (int c0 = 0; c0 < C; c0 += TP) {
    for (int r = warp; r < TP; r += NWARPS) {  // r: channel, lane: sample
      const int c = c0 + r, g = g0 + lane;
      tile[r][lane] = (c < C && g >= 0 && g < T && s0 + lane < S)
                          ? load_x(x, ((size_t)b * C + c) * T + g, bf16)
                          : 0.f;
    }
    __syncthreads();
    for (int r = warp; r < TP; r += NWARPS) {  // r: sample, lane: channel
      const int s = s0 + r, c = c0 + lane;
      if (s < S && c < C) {
        const float v = tile[lane][r];
        ww[(size_t)s * C + c] = v;
        m = fmaxf(m, fabsf(elu(v)));
      }
    }
    __syncthreads();
  }
  block_max_to(m, s_act + w);
}

// the stack's output from the windows: out (B, C, T) in the storage dtype
// (bf16: rounded to nearest even), sample g of row b from window
// (b, g / step) at s = S - step + g % step; TP samples of one row per
// block, through the same transpose
__global__ void __launch_bounds__(NTHREADS)
unwindow_kernel(const float* __restrict__ win, void* __restrict__ out, int C,
                int T, int S, int n_tiles, int step, int bf16) {
  __shared__ float tile[TP][TP + 1];
  const int b = blockIdx.y, g0 = blockIdx.x * TP;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c0 = 0; c0 < C; c0 += TP) {
    for (int r = warp; r < TP; r += NWARPS) {  // r: sample, lane: channel
      const int g = g0 + r, c = c0 + lane;
      float v = 0.f;
      if (g < T && c < C) {
        const int i = g / step;
        v = win[((size_t)(b * n_tiles + i) * S + S - step + (g - i * step)) *
                    C + c];
      }
      tile[r][lane] = v;
    }
    __syncthreads();
    for (int r = warp; r < TP; r += NWARPS) {  // r: channel, lane: sample
      const int c = c0 + r, g = g0 + lane;
      if (c < C && g < T) {
        const size_t at = ((size_t)b * C + c) * T + g;
        if (bf16)
          static_cast<__nv_bfloat16*>(out)[at] =
              __float2bfloat16_rn(tile[lane][r]);
        else
          static_cast<float*>(out)[at] = tile[lane][r];
      }
    }
    __syncthreads();
  }
}

// conv1 of a unit for one (time tile, window): acc = dequantized
// conv_k7_dil_d(q(ELU(v))) over the tile's samples, and max|ELU(acc)| into
// the window's second scale
__global__ void __launch_bounds__(NTHREADS)
conv1_kernel(const float* __restrict__ v, float* __restrict__ acc,
             const int4* __restrict__ w1,  // (K, CP/16, C) x 16 int8
             const float* __restrict__ ws1, const float* __restrict__ s_act,
             float* __restrict__ s_mid, Unit u) {
  extern __shared__ __align__(16) int8_t Q[];  // (TS + span) x CP
  const int C = u.C, CP = u.CP, S = u.S, TS = u.TS;
  const int w = blockIdx.x;
  const int t0 = u.out0 + blockIdx.y * TS;  // first output sample
  const int span = (K - 1) * u.d;
  const int L = TS + span;
  const int tb = t0 - span;  // sample of staged row 0, >= in0
  const float* vw = v + (size_t)w * S * C;
  const float s1 = s_act[w];
  const float r1 = __fdiv_rn(QMAX, fmaxf(s1, (float)1e-12));
  const float sd1 = __fmul_rn(s1, (float)(1.0 / 127.0));

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int s = warp; s < L; s += NWARPS) {
    const int t = tb + s;
    for (int c = lane; c < CP; c += 32)
      Q[s * CP + c] =
          (c < C && t < S) ? quantize(elu(vw[(size_t)t * C + c]), r1) : 0;
  }
  __syncthreads();

  const int CP16 = CP / 16;
  const int4* Qv = reinterpret_cast<const int4*>(Q);
  float* aw = acc + (size_t)w * S * C;
  float m = 0.f;
  for (int e = threadIdx.x; e < (TS / NT) * C; e += NTHREADS) {
    const int co = e % C, s0 = (e / C) * NT;
    int part[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) part[n] = 0;
    for (int j = 0; j < K; ++j) {
      // output sample t0 + s0 + n reads sample t0 + s0 + n - span + j d,
      // staged row s0 + n + j d
      const int src0 = s0 + j * u.d;
      const int4* wj = w1 + (size_t)j * CP16 * C + co;
      for (int i = 0; i < CP16; ++i) {
        const int4 wv = __ldg(wj + (size_t)i * C);
#pragma unroll
        for (int n = 0; n < NT; ++n)
          part[n] = dot16(Qv[(size_t)(src0 + n) * CP16 + i], wv, part[n]);
      }
    }
    const float sc = __ldg(ws1 + co);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int t = t0 + s0 + n;
      if (t < S) {
        const float a = __fmul_rn(__fmul_rn(__int2float_rn(part[n]), sd1), sc);
        aw[(size_t)t * C + co] = a;
        m = fmaxf(m, fabsf(elu(a)));
      }
    }
  }
  block_max_to(m, s_mid + w);
}

// the 1x1 conv of a unit and the residual, in place in v, for one (time
// tile, window); max|ELU(v)| into the next unit's scale unless s_next is
// null
__global__ void __launch_bounds__(NTHREADS)
conv2_kernel(float* v, const float* __restrict__ acc,
             const int4* __restrict__ w2,  // (CP/16, C) x 16 int8
             const float* __restrict__ ws2, const float* __restrict__ s_mid,
             float* __restrict__ s_next, Unit u) {
  extern __shared__ __align__(16) int8_t Q[];  // TS x CP
  const int C = u.C, CP = u.CP, S = u.S, TS = u.TS;
  const int w = blockIdx.x;
  const int t0 = u.out0 + blockIdx.y * TS;
  const float* aw = acc + (size_t)w * S * C;
  float* vw = v + (size_t)w * S * C;
  const float s2 = s_mid[w];
  const float r2 = __fdiv_rn(QMAX, fmaxf(s2, (float)1e-12));
  const float sd2 = __fmul_rn(s2, (float)(1.0 / 127.0));

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int s = warp; s < TS; s += NWARPS) {
    const int t = t0 + s;
    for (int c = lane; c < CP; c += 32)
      Q[s * CP + c] =
          (c < C && t < S) ? quantize(elu(aw[(size_t)t * C + c]), r2) : 0;
  }
  __syncthreads();

  const int CP16 = CP / 16;
  const int4* Qv = reinterpret_cast<const int4*>(Q);
  float m = 0.f;
  for (int e = threadIdx.x; e < (TS / NT) * C; e += NTHREADS) {
    const int co = e % C, s0 = (e / C) * NT;
    int part[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) part[n] = 0;
    for (int i = 0; i < CP16; ++i) {
      const int4 wv = __ldg(w2 + (size_t)i * C + co);
#pragma unroll
      for (int n = 0; n < NT; ++n)
        part[n] = dot16(Qv[(size_t)(s0 + n) * CP16 + i], wv, part[n]);
    }
    const float sc = __ldg(ws2 + co);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int t = t0 + s0 + n;
      if (t < S) {
        const size_t at = (size_t)t * C + co;
        const float y2 = __fmul_rn(__int2float_rn(part[n]), sd2);
        const float vn = u.bf16 ? __fadd_rn(round_bf16(vw[at]),
                                            round_bf16(__fmul_rn(y2, sc)))
                                : fmaf(y2, sc, vw[at]);
        vw[at] = vn;
        m = fmaxf(m, fabsf(elu(vn)));
      }
    }
  }
  if (s_next != nullptr) block_max_to(m, s_next + w);
}

// dynamic shared memory above the default 48 KB must be granted first (at
// the probe's shapes no launch needs it)
cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// x: (B, C, T) contiguous, f32 or (bf16 != 0) bf16; out: the same; the
// tiling: windows of S = step + halo samples, window (b, i) starting at
// sample i * step - halo of row b, n_tiles per row (n_tiles * step >= T);
// win, acc: (B * n_tiles, S, C) f32 scratch; absmax: (2 * n_units,
// B * n_tiles) f32 scratch for the scales; w1: (n_units, 7, cp/16, C, 16)
// int8, w2: (n_units, cp/16, C, 16) int8, input channels zero-padded to cp
// (a multiple of 16); scales: (n_units, 2, C) f32 weight scales; d0..d2 the
// dilations and c0..c2 the samples each unit cuts from the window's front
// (its span rounded up to whole folded rows).  The output is each window's
// last `step` samples after the last unit, whose valid samples are
// [c0 + c1 + c2, S): so c0 + c1 + c2 <= halo.
extern "C" int int8_tile_stack_forward(const void* x, void* out, void* win,
                                       void* acc, void* absmax,
                                       const void* w1, const void* w2,
                                       const void* scales, int B, int C,
                                       int T, int S, int n_tiles, int step,
                                       int halo, int cp, int bf16,
                                       int n_units, int d0, int d1, int d2,
                                       int c0, int c1, int c2,
                                       void* stream) {
  const int dil[MAX_UNITS] = {d0, d1, d2};
  const int cut[MAX_UNITS] = {c0, c1, c2};
  if (n_units < 1 || n_units > MAX_UNITS || C < 4 || C > 256 || cp < C ||
      cp % 16 != 0 || B < 1 || T < 1 || n_tiles < 1 || step < 1 ||
      halo < 0 || S != step + halo || (long long)n_tiles * step < T)
    return (int)cudaErrorInvalidValue;
  int in0 = 0;
  for (int u = 0; u < n_units; ++u) {
    if (dil[u] < 1 || cut[u] < (K - 1) * dil[u])
      return (int)cudaErrorInvalidValue;
    in0 += cut[u];
  }
  if (in0 > halo) return (int)cudaErrorInvalidValue;

  const int W = B * n_tiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* v = static_cast<float*>(win);
  float* a = static_cast<float*>(acc);
  float* smax = static_cast<float*>(absmax);
  const float* ws = static_cast<const float*>(scales);
  cudaError_t err =
      cudaMemsetAsync(smax, 0, sizeof(float) * 2 * n_units * (size_t)W, s);
  if (err != cudaSuccess) return (int)err;

  int ts = TILE_BYTES / cp / NT * NT;
  if (ts < NT) ts = NT;

  // windows on grid x (up to 2^31 - 1), time tiles on y
  window_kernel<<<dim3(W, (S + TP - 1) / TP), NTHREADS, 0, s>>>(
      x, v, smax, C, T, S, n_tiles, step, halo, bf16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  in0 = 0;
  for (int u = 0; u < n_units; ++u) {
    Unit g;
    g.C = C;
    g.CP = cp;
    g.S = S;
    g.d = dil[u];
    g.in0 = in0;
    g.out0 = in0 + cut[u];
    g.TS = ts;
    g.bf16 = bf16;
    const dim3 grid(W, (S - g.out0 + ts - 1) / ts);
    const size_t smem1 = (size_t)(ts + (K - 1) * g.d) * cp;
    const size_t smem2 = (size_t)ts * cp;
    err = allow_smem((const void*)conv1_kernel, smem1);
    if (err == cudaSuccess) err = allow_smem((const void*)conv2_kernel, smem2);
    if (err != cudaSuccess) return (int)err;
    const size_t w1_unit = (size_t)K * (cp / 16) * C;  // int4 per unit
    const size_t w2_unit = (size_t)(cp / 16) * C;
    float* s_act = smax + (size_t)2 * u * W;
    float* s_mid = s_act + W;
    float* s_next = u + 1 < n_units ? s_mid + W : nullptr;
    conv1_kernel<<<grid, NTHREADS, smem1, s>>>(
        v, a, static_cast<const int4*>(w1) + u * w1_unit,
        ws + (size_t)u * 2 * C, s_act, s_mid, g);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    conv2_kernel<<<grid, NTHREADS, smem2, s>>>(
        v, a, static_cast<const int4*>(w2) + u * w2_unit,
        ws + (size_t)u * 2 * C + C, s_mid, s_next, g);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    in0 = g.out0;
  }
  unwindow_kernel<<<dim3((T + TP - 1) / TP, B), NTHREADS, 0, s>>>(
      v, out, C, T, S, n_tiles, step, bf16);
  return (int)cudaGetLastError();
}
