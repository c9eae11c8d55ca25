// The folded residual stack above C = 32 with bf16 operands on the tensor
// cores, for Hopper (sm_90a), batch mode, in f32 or bf16 storage, at every
// unit shape.
//
// Replaces the TPU kernel audiodec_tpu/ops/pallas/folded_stack.py
// folded_residual_stack (pallas_call at :372) whenever its dot operands are
// rounded to bf16 (`bf16_dots`, or bf16 storage) at C from 33 to 512 (one
// warp per 32 output channels, at most 16 warps a block): a
// chain of units
//
//   v += mask(conv_k2,1(act(mask(conv_k,d(act(v)) + b1))) + b2)
//
// with act ELU or LeakyReLU(slope), any k and k2, optional biases, any
// number of units and dilations, zero left context at t=0, and mask()
// zeroing a conv output at t < 0 (folded_stack.py:285-291).  The TPU
// kernel's fold of time into the MXU's 128 lanes is a TPU workaround and is
// not ported.
//
// Bound on the H100 (bin/kernel_bounds.py mma_stack): one read and one
// write of the activation against units * (k + k2) * 2 C^2 FLOP per sample
// on the bf16 tensor cores; the autoencoder units at the symAD stacks'
// (16, C, T) = (16, 64, 160000), (16, 128, 40000), (16, 256, 8000): 0.509 /
// 0.509 / 0.407 ms, by operations in both storages.
//
// Design: one CUDA launch per unit (the wrapper's call makes one per unit;
// the carried sum crosses the launches in two f32 buffers).  A block of
// 32 * wm * CP / 32 threads owns every output channel of a time tile:
//   - Y = bf16(act(v)) for the tile, the k2 - 1 samples before it and the
//     first conv's look-back (k - 1) d, zero outside [0, T), is staged once
//     in shared memory, time-major, in rows of CP + 8 bf16 (the pad puts
//     the eight rows of an 8x8 `ldmatrix` in distinct banks);
//   - the weights, packed [tap][c_out][c_in] bf16, stream through a ring
//     of 2 or 3 `cp.async` buffers, one stage per (tap, kc input channels),
//     the next stages' copies in flight while a stage's products run;
//   - warps are laid out wm (time) x CP / 32 (channels); each owns 4 m16
//     tiles (64 samples) x 32 output channels and runs mma.sync m16n8k16
//     with A and B fragments from `ldmatrix`: the first conv over the
//     tile and k2 - 1 more samples, A read from Y at each tap's shift;
//   - a2 = bf16(act(mask(acc + b1))) replaces Y in shared memory (Y is no
//     longer needed) as the second conv's operand, read at its k2 shifts;
//   - the epilogue adds b2 and the residual, reading v once more from
//     device memory, an m16 tile's 16 values loaded before any is stored;
//   - the staging loads four of a thread's pairs before it stores any, and
//     the activation is a select, not a branch (the kernel is built once
//     per activation), so that a thread's loads and activations overlap.
// Each mma's 16 products are summed from zero and added to the running sum
// with round-to-nearest f32 adds, as B4's wide route (`mma_add`): one
// accumulator chained through many k-steps drifts from exact sums (ROADMAP
// §C).  Channels are padded to CP, a multiple of 32, with zero weights and
// biases, so the padded channels stay zero.
// ops/kernels/folded_stack.py wide_geometry picks wm, the stage width kc
// and the buffers (this file's `smem_bytes` states the same sum).  The
// staging, the weight ring and a warp's product over a stage are
// wide_mma.cuh's, shared with csrc/ablate_stack.cu's wide route.
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

#include "wide_mma.cuh"

namespace {

using namespace wide_mma;

constexpr int MTW = 4;               // m16 tiles per warp
constexpr int WARP_N = 32;           // output channels per warp
constexpr int MAX_WARPS = 16;
constexpr int MAX_UNITS = 256;
enum { ELU = 0, LEAKY = 1 };  // the C interface's act
// the kernel's: ELU as expm1 (f32 storage) or exp(min(v, 0)) - 1 (bf16)
enum { ACT_EXPM1 = 0, ACT_EXP = 1, ACT_LEAKY = 2 };

// one unit's launch
struct Unit {
  int C, T, CP;
  int k, k2, d;
  int has_bias;
  float slope;
  int wn;            // warps along the channels, CP / 32
  int rows, tile;    // conv1 samples per block (64 wm), output samples
  int L;             // staged rows of act(v): rows + (k - 1) d
  int yrows;         // rows of the Y region (L for the largest d, and a2)
  int kc, nkc, nbuf; // input channels per stage, stages per tap, buffers
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

__device__ __forceinline__ void store_any(void* p, size_t i, float v,
                                          int bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

// Y = bf16(act(v)) over rows 0 .. L - 1 (time tin + row), zero outside
// [0, T) and past C (wide_mma.cuh stage_act)
template <int ACT, typename S>
__device__ __forceinline__ void stage_unit(__nv_bfloat16* Y, const void* in,
                                           size_t base, int tin,
                                           const Unit& P) {
  const float slope = P.slope;
  stage_act(Y, static_cast<const S*>(in) + base, tin, P.L, P.T, P.C, P.CP,
            [slope](float v) { return activate<ACT>(v, slope); });
}

// the residuals of one m16 tile's outputs in a warp's accumulator layout
// (rows p0, p0 + 8; channels o0 + 8 n, + 1), all loaded before any is
// used, so that their round trips to device memory overlap; 0 outside
template <typename S>
__device__ __forceinline__ void load_tile(float (&v)[4][4], const void* in,
                                          size_t base, int tout, int p0,
                                          int o0, const Unit& P) {
  const S* x = static_cast<const S*>(in) + base;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int o = o0 + n * 8 + (q & 1);
      const int p = p0 + 8 * (q >> 1), t = tout + p;
      v[n][q] = o < P.C && p < P.tile && t < P.T
                    ? to_f32(x[(size_t)o * P.T + t]) : 0.f;
    }
}

template <int ACT>
__global__ void __launch_bounds__(MAX_WARPS * 32, 1)
wide_unit(const void* __restrict__ in, void* __restrict__ out,
          const __nv_bfloat16* __restrict__ w1,  // (k, CP, CP) [tap][o][i]
          const __nv_bfloat16* __restrict__ w2,  // (k2, CP, CP)
          const float* __restrict__ b1,          // (CP) or null
          const float* __restrict__ b2,          // (CP) or null
          const __grid_constant__ Unit P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int RS = P.CP + 8, KS = P.kc + 8;
  __nv_bfloat16* Y = reinterpret_cast<__nv_bfloat16*>(smem);  // yrows x RS
  __nv_bfloat16* wring = Y + P.yrows * RS;         // nbuf x CP x KS
  const int stage = P.CP * KS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int mbase = (warp / P.wn) * 16 * MTW, nbase = (warp % P.wn) * WARP_N;
  const int b = blockIdx.y;
  const int tout = blockIdx.x * P.tile;    // first output sample
  const int ta2 = tout - (P.k2 - 1);       // time of conv1's output row 0
  const int tin = ta2 - (P.k - 1) * P.d;   // time of Y's row 0
  const size_t base = (size_t)b * P.C * P.T;
  const int n1 = P.k * P.nkc, nsteps = n1 + P.k2 * P.nkc;

  // stage s: conv1's tap j = s / nkc, then conv2's, rows of CP output
  // channels, kc input channels each
  const auto ring = weight_ring(
      wring, stage, P.nbuf, nsteps, P.kc, P.CP,
      [&](int s, int& rows) {
        const bool c1 = s < n1;
        const int r = c1 ? s : s - n1;
        const int j = r / P.nkc, kci = r - j * P.nkc;
        rows = P.CP;
        return (c1 ? w1 : w2) + (size_t)j * P.CP * P.CP + kci * P.kc;
      });
  ring.start();

  // Y = bf16(act(v)) over rows 0 .. L - 1, zero outside [0, T) and past C
  if (P.in_bf16)
    stage_unit<ACT, __nv_bfloat16>(Y, in, base, tin, P);
  else
    stage_unit<ACT, float>(Y, in, base, tin, P);

  float acc[MTW][4][4];
#pragma unroll
  for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][n][q] = 0.f;

  // the lane's ldmatrix rows: A row (lane & 15) at column (lane >> 4) * 8;
  // B rows (lane & 7) + 8 (lane >> 4) at column 8 ((lane >> 3) & 1)
  const int arow0 = mbase + (lane & 15), acol = (lane >> 4) * 8;
  const int brow0 = nbase + (lane & 7) + ((lane >> 4) << 3);
  const int bcol = ((lane >> 3) & 1) * 8;

  for (int s = 0; s < nsteps; ++s) {
    const __nv_bfloat16* Wb = ring.next(s);
    const bool c1 = s < n1;
    const int r = c1 ? s : s - n1;
    const int j = r / P.nkc, kci = r - j * P.nkc;
    // output row p of either conv reads operand row p + shift: Y at the
    // tap's dilated shift, or a2 at its tap
    const int shift = c1 ? j * P.d : j;
    const __nv_bfloat16* ap[MTW];
#pragma unroll
    for (int mt = 0; mt < MTW; ++mt)
      ap[mt] = Y + (arow0 + mt * 16 + shift) * RS + kci * P.kc + acol;
    product<MTW>(acc, ap, Wb + brow0 * KS + bcol, KS, P.kc);
    if (s != n1 - 1) continue;
    // conv1 done: a2 = bf16(act(mask(acc + b1))) replaces Y, once every
    // warp is done reading Y; the next step's barrier orders the writes
    // before conv2's reads
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int o = nbase + n * 8 + 2 * tq;
        const float ba = P.has_bias ? __ldg(b1 + o) : 0.f;
        const float bb = P.has_bias ? __ldg(b1 + o + 1) : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = mbase + mt * 16 + g + 8 * h;
          float v0 = acc[mt][n][2 * h], v1 = acc[mt][n][2 * h + 1];
          if (P.has_bias) {
            v0 = __fadd_rn(v0, ba);
            v1 = __fadd_rn(v1, bb);
          }
          const bool live = ta2 + p >= 0;
          *reinterpret_cast<uint32_t*>(Y + p * RS + o) =
              pack_bf16(live ? activate<ACT>(v0, P.slope) : 0.f,
                        live ? activate<ACT>(v1, P.slope) : 0.f);
          acc[mt][n][2 * h] = acc[mt][n][2 * h + 1] = 0.f;
        }
      }
  }

  // out = residual(v, y2 + b2) at the block's output samples, one m16
  // tile at a time (load_tile)
#pragma unroll
  for (int mt = 0; mt < MTW; ++mt) {
    const int p0 = mbase + mt * 16 + g;
    float v[4][4];
    if (P.in_bf16)
      load_tile<__nv_bfloat16>(v, in, base, tout, p0, nbase + 2 * tq, P);
    else
      load_tile<float>(v, in, base, tout, p0, nbase + 2 * tq, P);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int o = nbase + n * 8 + 2 * tq + (q & 1);
        const int p = p0 + 8 * (q >> 1), t = tout + p;
        if (o >= P.C || p >= P.tile || t >= P.T) continue;
        float y = acc[mt][n][q];
        if (P.has_bias) y = __fadd_rn(y, __ldg(b2 + o));
        store_any(out, base + (size_t)o * P.T + t,
                  P.bf16 ? __fadd_rn(round_bf16(v[n][q]), round_bf16(y))
                         : __fadd_rn(v[n][q], y),
                  P.out_bf16);
      }
  }
}

// shared memory of a block in bytes; ops/kernels/folded_stack.py
// wide_smem states the same sum
int smem_bytes(int cp, int yrows, int kc, int nbuf) {
  return 2 * (yrows * (cp + 8) + nbuf * cp * (kc + 8));
}

long long cuda_launches = 0;  // kernel launches made, for the checks

}  // namespace

// the CUDA launches this library has made (one per unit of each call)
extern "C" long long wide_stack_cuda_launches() { return cuda_launches; }

// x, out: (B, C, T) contiguous, float32 (storage_bf16 = 0) or bfloat16;
// scratch: two (B, C, T) float32 buffers (one suffices for two units, none
// for one) that carry the f32 sum between the units; x is read only.
// w1: (n_units, k, cp, cp) and w2: (n_units, k2, cp, cp) bf16 as
// [u][tap][c_out][c_in], channels zero-padded from C to cp (a multiple of
// 32); bias: (n_units, 2, cp) float32 or null; dil: n_units dilations (host
// memory); act: 0 ELU, 1 LeakyReLU(slope); warps_m: warps along time, so
// blocks of warps_m * cp / 32 warps and 64 * warps_m conv1 samples; kc:
// input channels per weight stage (a multiple of 16 dividing cp); nbuf: 2
// or 3 ring buffers.
extern "C" int wide_stack_forward(
    const void* x, void* out, void* scratch, const void* w1, const void* w2,
    const void* bias, int B, int C, int T, int cp, int n_units,
    const int* dil, int k, int k2, int act, float slope, int warps_m, int kc,
    int nbuf, int storage_bf16, void* stream) {
  if (B < 1 || C < 1 || T < 1 || cp < C || cp % WARP_N ||
      n_units < 1 || n_units > MAX_UNITS || k < 1 || k2 < 1 ||
      (act != ELU && act != LEAKY) || warps_m < 1 ||
      warps_m * (cp / WARP_N) > MAX_WARPS || kc < 16 || kc % 16 || cp % kc ||
      (nbuf != 2 && nbuf != 3) || (n_units > 1 && scratch == nullptr))
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
  P.wn = cp / WARP_N;
  P.rows = 16 * MTW * warps_m;
  P.tile = P.rows - (k2 - 1);
  P.kc = kc;
  P.nkc = cp / kc;
  P.nbuf = nbuf;
  P.bf16 = storage_bf16;
  const int look = P.rows + (k - 1) * dmax, a2 = P.rows + k2 - 1;
  P.yrows = look > a2 ? look : a2;
  if (P.tile < 1) return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(cp, P.yrows, kc, nbuf);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  auto kernel = act == LEAKY      ? wide_unit<ACT_LEAKY>
                : storage_bf16 ? wide_unit<ACT_EXP>
                               : wide_unit<ACT_EXPM1>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)  // all of the SM's L1 as shared memory
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + P.tile - 1) / P.tile, B);
  const int threads = 32 * warps_m * P.wn;
  const __nv_bfloat16* wa = static_cast<const __nv_bfloat16*>(w1);
  const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w2);
  const float* bs = static_cast<const float*>(bias);
  float* buf[2] = {static_cast<float*>(scratch),
                   static_cast<float*>(scratch) + (size_t)B * C * T};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* src = x;
  for (int u = 0; u < n_units; ++u) {
    const bool last = u == n_units - 1;
    void* dst = last ? out : static_cast<void*>(buf[u % 2]);
    P.d = dil[u];
    P.L = P.rows + (k - 1) * P.d;
    P.in_bf16 = u == 0 ? storage_bf16 : 0;
    P.out_bf16 = last ? storage_bf16 : 0;
    kernel<<<grid, threads, smem, s>>>(
        src, dst, wa + (size_t)u * k * cp * cp, wb + (size_t)u * k2 * cp * cp,
        bs == nullptr ? nullptr : bs + (size_t)u * 2 * cp,
        bs == nullptr ? nullptr : bs + (size_t)u * 2 * cp + cp, P);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++cuda_launches;
    src = dst;
  }
  return 0;
}
