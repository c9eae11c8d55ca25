// Causal residual stack with int8 dot products, for Hopper (sm_90a), batch
// mode.
//
// Replaces the TPU kernel audiodec_tpu/ops/pallas/folded_stack.py
// folded_residual_stack (pallas_call at :372) in its int8 mode with "row"
// activation scales (int8_dots=True, int8_scale="row"), the mode that
// `codec_test --dtype int8-decode` runs for every decoder stack, at any
// fold.  A unit is v += conv1x1(ELU(conv_k7_dil_d(ELU(v)))), no biases, f32
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
//   - dequantization: for each input row a conv reads (ascending), the
//     int32 partial of its taps (exact in f32, below 2^24) times that row's
//     scale is added with one rounding, acc = fmaf(part, s_row, acc); then
//     acc * s_weight; the residual is v = fmaf(y2, s_weight2, v) in f32
//     storage; in bf16 storage the buffers hold f32 values, the sum
//     bf16(v) + bf16(y2 * s_weight2) that the next unit's ELU reads (XLA
//     keeps that excess precision on the CPU), rounded to bf16 where the
//     residual is read and by the wrapper at the end.
// Every f32 operation is an explicit _rn intrinsic or fmaf, so nvcc's
// contraction cannot move a rounding, and rounding to int8 is rintf (half
// to even, as torch.round).  ELU is exp(min(v, 0)) - 1 with expf, the TPU
// kernel's form.  This is the plain version's arithmetic
// (ops/kernels/folded_stack.py folded_residual_stack_int8_plain).
//
// Bound on the H100: the int8 products run at 1979 TOP/s on the tensor
// cores; at the symAD decoder's stacks (16, T, C) = (16, 8000, 256),
// (16, 40000, 128), (16, 160000, 64), (16, 480000, 32) the bounds are
// 0.203 / 0.254 / 0.391 / 0.587 ms (bin/kernel_bounds.py), by operations at
// C = 256 and 128 and by the f32 activation's bytes at C = 64 and 32.
// This first version runs the products with __dp4a on the CUDA cores and
// reads and writes the activation once per unit, so it is bound by the
// dp4a rate and its shared-memory operand loads.
//
// Design: one CUDA launch per unit (3 per wrapper call); the stack
// ping-pongs between `out` and `tmp` so the last unit writes `out`.  A
// block takes one batch row and a tile of TS samples (whole folded rows)
// with all C output channels, so it can quantize the intermediate, whose
// row scale needs every channel of the row:
//   1. stage ELU(v) for the tile and a left halo of whole rows covering
//      the conv's span (zero before t=0) in shared memory, sample-major;
//      quantize it per row (one warp per row) to int8, channels padded to
//      CP, a multiple of 16;
//   2. conv1: each thread owns one output channel and NT consecutive
//      samples; per tap and 16-channel chunk it loads 16 int8 weights
//      (one 16-byte load, coalesced across the warp's channels, from L2)
//      and the samples' 16-byte operands (broadcast within the warp), and
//      dots them with __dp4a; when the next tap reads another row, the
//      row's partial is dequantized into acc;
//   3. ELU(acc * s1) into shared memory over the staging buffer, quantize
//      per row, then the 1x1 conv the same way and the residual from v in
//      device memory.
// Weights are not held in shared memory: at C = 256 one unit's conv1 is
// 448 KiB of int8, over a block's 227 KB; all of a stack's weights sit in
// the 50 MB L2.
//
// Plain C interface for ctypes: pointers and the stream as void*, ints as
// int; returns the first CUDA error of the launches, or 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int K = 7;
constexpr int NTHREADS = 256;
constexpr int NT = 8;           // samples per thread and pass
constexpr int MAX_UNITS = 3;
constexpr int TILE_ELEMS = 8192;  // target TS x CP per block
constexpr float QMAX = 127.f;

struct Geometry {
  int C, CP, Tp, F, TS, H, L, d, bf16;
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

// rows x (F samples x CP channels) f32, sample-major -> int8 and the
// dequant scale per row; channels c >= C are not read and quantize to 0
__device__ void quantize_rows(const float* A, int8_t* Q, float* SD, int rows,
                              int F, int CP, int C) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = F * CP;
  for (int r = warp; r < rows; r += NTHREADS / 32) {
    const float* a = A + (size_t)r * n;
    float m = 0.f;
    for (int e = lane; e < n; e += 32)
      if (e % CP < C) m = fmaxf(m, fabsf(a[e]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float r127 = __fdiv_rn(QMAX, fmaxf(m, (float)1e-12));
    int8_t* q = Q + (size_t)r * n;
    for (int e = lane; e < n; e += 32)
      q[e] = e % CP < C ? (int8_t)__float2int_rn(__fmul_rn(a[e], r127)) : 0;
    if (lane == 0) SD[r] = __fmul_rn(m, (float)(1.0 / 127.0));
  }
}

__global__ void __launch_bounds__(NTHREADS)
int8_unit_kernel(const float* __restrict__ x, float* __restrict__ out,
                 const int4* __restrict__ w1,  // (K, CP/16, C) x 16 int8
                 const int4* __restrict__ w2,  // (CP/16, C) x 16 int8
                 const float* __restrict__ s1, const float* __restrict__ s2,
                 Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = g.C, CP = g.CP, F = g.F, TS = g.TS, L = g.L;
  float* A = reinterpret_cast<float*>(smem);         // L x CP, later TS x CP
  int8_t* Q1 = reinterpret_cast<int8_t*>(A + (size_t)L * CP);  // L x CP
  int8_t* Q2 = Q1 + (size_t)L * CP;                             // TS x CP
  float* SD1 = reinterpret_cast<float*>(Q2 + (size_t)TS * CP);  // L / F
  float* SD2 = SD1 + L / F;                                     // TS / F

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TS;  // first output sample of the tile
  const int tb = t0 - g.H;         // time of buffer sample 0, row aligned
  const float* xb = x + (size_t)b * C * g.Tp;
  float* ob = out + (size_t)b * C * g.Tp;

  // 1. ELU(v) over the halo and the tile, quantized per row
  for (int e = threadIdx.x; e < CP * L; e += NTHREADS) {
    const int c = e / L, s = e - c * L, t = tb + s;
    const float v = (c < C && t >= 0 && t < g.Tp) ? xb[(size_t)c * g.Tp + t]
                                                  : 0.f;
    A[s * CP + c] = elu(v);
  }
  __syncthreads();
  quantize_rows(A, Q1, SD1, L / F, F, CP, C);
  __syncthreads();

  // 2. conv1 (k=7, dilation d), dequantized row by row, then ELU(acc * s1)
  const int CP16 = CP / 16;
  const int span = (K - 1) * g.d;
  const int4* Q1v = reinterpret_cast<const int4*>(Q1);
  const int groups = TS / NT;
  for (int e = threadIdx.x; e < groups * C; e += NTHREADS) {
    const int co = e % C, s0 = (e / C) * NT;  // s0: tile sample of n = 0
    int part[NT];
    float acc[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      part[n] = 0;
      acc[n] = 0.f;
    }
    for (int j = 0; j < K; ++j) {
      const int src0 = s0 + g.H - span + j * g.d;  // buffer sample of n = 0
      const int4* wj = w1 + (size_t)j * CP16 * C + co;
      for (int i = 0; i < CP16; ++i) {
        const int4 w = __ldg(wj + (size_t)i * C);
#pragma unroll
        for (int n = 0; n < NT; ++n)
          part[n] = dot16(Q1v[(size_t)(src0 + n) * CP16 + i], w, part[n]);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int row = (src0 + n) / F;
        if (j == K - 1 || (src0 + n + g.d) / F != row) {
          acc[n] = fmaf(__int2float_rn(part[n]), SD1[row], acc[n]);
          part[n] = 0;
        }
      }
    }
    const float sc = __ldg(s1 + co);
#pragma unroll
    for (int n = 0; n < NT; ++n)
      A[(s0 + n) * CP + co] = elu(__fmul_rn(acc[n], sc));
  }
  __syncthreads();
  quantize_rows(A, Q2, SD2, TS / F, F, CP, C);
  __syncthreads();

  // 3. the 1x1 conv and the residual
  const int4* Q2v = reinterpret_cast<const int4*>(Q2);
  for (int e = threadIdx.x; e < groups * C; e += NTHREADS) {
    const int co = e % C, s0 = (e / C) * NT;
    int part[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) part[n] = 0;
    for (int i = 0; i < CP16; ++i) {
      const int4 w = __ldg(w2 + (size_t)i * C + co);
#pragma unroll
      for (int n = 0; n < NT; ++n)
        part[n] = dot16(Q2v[(size_t)(s0 + n) * CP16 + i], w, part[n]);
    }
    const float sc = __ldg(s2 + co);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int t = t0 + s0 + n;
      if (t < g.Tp) {
        const size_t at = (size_t)co * g.Tp + t;
        const float y2 = __fmul_rn(__int2float_rn(part[n]), SD2[(s0 + n) / F]);
        ob[at] = g.bf16 ? __fadd_rn(round_bf16(xb[at]),
                                    round_bf16(__fmul_rn(y2, sc)))
                        : fmaf(y2, sc, xb[at]);
      }
    }
  }
}

int smem_bytes(const Geometry& g) {
  return (int)(sizeof(float) * (size_t)g.L * g.CP + (size_t)g.L * g.CP +
               (size_t)g.TS * g.CP + sizeof(float) * (g.L / g.F + g.TS / g.F));
}

Geometry geometry(int C, int CP, int Tp, int F, int d, int bf16) {
  Geometry g;
  g.C = C;
  g.CP = CP;
  g.Tp = Tp;
  g.F = F;
  g.d = d;
  g.bf16 = bf16;
  // a whole number of rows and of NT-sample groups
  const int unit = NT * g.F;
  int ts = TILE_ELEMS / CP;
  if (ts < 32) ts = 32;
  g.TS = (ts + unit - 1) / unit * unit;
  const int span = (K - 1) * d;
  g.H = (span + g.F - 1) / g.F * g.F;
  g.L = g.H + g.TS;
  return g;
}

}  // namespace

// x, out, tmp: (B, C, Tp) contiguous f32, Tp a multiple of the fold F;
// w1: (n_units, 7, cp/16, C, 16) int8, w2: (n_units, cp/16, C, 16) int8,
// input channels zero-padded to cp (a multiple of 16); scales:
// (n_units, 2, C) f32 weight scales of conv1 and the 1x1 conv; bf16: the
// storage is bf16 (x holds bf16 values).  x is read only; with one unit
// tmp is not used.
extern "C" int int8_stack_forward(const void* x, void* out, void* tmp,
                                  const void* w1, const void* w2,
                                  const void* scales, int B, int C, int Tp,
                                  int cp, int F, int bf16, int n_units,
                                  int d0, int d1, int d2, void* stream) {
  if (n_units < 1 || n_units > MAX_UNITS || C < 4 || C > 256 || cp < C ||
      cp % 16 != 0 || B < 1 || Tp < 1 || F < 1 || Tp % F)
    return (int)cudaErrorInvalidValue;
  const int dil[MAX_UNITS] = {d0, d1, d2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  // raise the kernel's dynamic shared memory limit once per device and size
  constexpr int MAX_DEVICES = 64;
  static int granted[MAX_DEVICES];
  const float* src = static_cast<const float*>(x);
  for (int u = 0; u < n_units; ++u) {
    if (dil[u] < 1) return (int)cudaErrorInvalidValue;
    const Geometry g = geometry(C, cp, Tp, F, dil[u], bf16);
    const int smem = smem_bytes(g);
    if (dev >= MAX_DEVICES || smem > granted[dev]) {
      err = cudaFuncSetAttribute(int8_unit_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return (int)err;
      if (dev < MAX_DEVICES) granted[dev] = smem;
    }
    // the last unit writes out; earlier ones alternate so no unit reads
    // the buffer it writes
    float* dst = static_cast<float*>((n_units - 1 - u) % 2 == 0 ? out : tmp);
    const dim3 grid((Tp + g.TS - 1) / g.TS, B);
    const size_t w1_unit = (size_t)K * (cp / 16) * C;  // int4 per unit
    const size_t w2_unit = (size_t)(cp / 16) * C;
    int8_unit_kernel<<<grid, NTHREADS, smem, s>>>(
        src, dst, static_cast<const int4*>(w1) + u * w1_unit,
        static_cast<const int4*>(w2) + u * w2_unit,
        static_cast<const float*>(scales) + (size_t)u * 2 * C,
        static_cast<const float*>(scales) + (size_t)u * 2 * C + C, g);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    src = dst;
  }
  return 0;
}
