// Residual vector quantization, encode, in f32 for Hopper (sm_90a).
//
// Replaces the TPU kernel audiodec_tpu/archive/vq_kernel.py
// rvq_encode_pallas (pallas_call at :78).  For each frame and each layer q
// in order:
//   dist[n] = (r2 - 2 * cross[n]) + e2[q][n], r2 = sum(r * r),
//             cross[n] = r . E_q[n], all in f32
//   idx     = argmin over n, the lowest index on ties
//   quant   = E_q[idx]               (an exact gather)
//   r      -= quant; zq += quant     (the plain update, not the
//                                     straight-through form)
// e2 = |E_q[n]|^2 comes from the wrapper, computed as the plain version
// computes it.  While the indices agree, the update and zq are the plain
// version's operations in its order, so zq equals it bit for bit; the sums
// of r2 and cross run in another order than the plain version's matmul, so
// an index can differ only where two codes are within rounding of a tie.
// A frame with no finite distance takes code 0, as argmin of an all-inf
// row gives.
//
// Bound on the H100: at (16, 1600, 64) frames x 8 layers x 1024 codes the
// cross terms are 2 * 25600 * 8 * 1024 * 64 = 2.7e10 FLOP on the f32 FMA
// units (67 TFLOP/s), against 8.6 MB of input and output: 0.401 ms, bound
// by operations (bin/kernel_bounds.py:81).  The distances stay true f32 on
// the FMA units (TF32 off), so the design is an f32 matrix product with
// an argmin in its epilogue.
//
// What held the first version (slice 4) at 23% of that bound (1.71 ms), and what this
// design does about it (one launch per call; the geometry comes from
// archive/vq_kernel.py rvq_geometry):
//  1. Shared-memory loads set its pace (32 FMAs per 12 scalar loads).
//     Here a thread scores an 8 x 8 register tile, frames 8ty..8ty+7
//     against codes 4tx..4tx+3 and NC/2+4tx..NC/2+4tx+3 of the chunk, 64
//     accumulators: per step of D two 16-byte vectors of the residuals R
//     (the warp's one or two frame rows, broadcast) and two of the chunk
//     (the warp's 16 or 32 code columns on consecutive vectors, no bank
//     conflicts), 16 FMAs per 16-byte load.  The next row's vectors load
//     while this row is multiplied, 8 rows a trip of the loop.  A warp
//     holds WR rows of COLS = 32/WR threads: chunks of NC = 128 codes
//     (WR = 2) or 256 (WR = 1).
//  2. Its chunks were staged by every thread between two barriers, with an
//     integer division per element and no overlap.  Here the wrapper packs
//     the codebooks once, in chunks of NC codes, each k-major with its e2
//     row after the DP rows of D (archive/vq_kernel.py pack_codebooks), so
//     a ring stage (KS rows of one chunk, the e2 row after the last slice)
//     is one run of memory: thread 0 issues it as one `cp.async.bulk` on
//     the stage's `full` mbarrier, and each warp releases the stage on its
//     `empty` mbarrier once done with it (csrc/bulk_ring.cuh), so copies
//     of later (layer, chunk, slice) steps land while this one is consumed
//     and no block-wide barrier runs inside a layer.  KS bounds a stage at
//     any D; the geometry shrinks FT as D grows so that R (DP rows of
//     FT + 4 floats, k-major) fits, so any D runs while a tile fits.
//  3. 64-frame blocks left SMs idle (400 blocks, about three waves).  Here
//     blocks of 4 or 8 warps spread evenly over an SM's four
//     sub-partitions, and rvq_geometry picks the tile and ring by a cost
//     model fitted to a sweep of every tile on the card: at (16, 1600, 64)
//     200 blocks of 128 frames, two an SM, all resident at once.
//  4. r2 was rebuilt by one shuffle reduction per frame.  It still is, in
//     the first version's order (lane-strided fmaf sums and a butterfly), so
//     that every distance, index and zq equals that kernel's bit for bit,
//     but four frames a warp at a time, so that their loads and shuffles
//     overlap.
// The argmin runs in each chunk's epilogue: a running (best, idx) per frame
// over the thread's codes in ascending order, replaced only on a strict <,
// padded codes masked by index; at the end of a layer the COLS threads of
// a row reduce by the lexicographic min of (distance, index) with
// shuffles, which gives the lowest index among equal minima.  Then the
// gather of E_q[idx] (from the row-major codebook in L2, a warp taking 4
// frames x 8 elements of D, 4 such items' loads in flight), the update of
// R, and r2 for the next layer.  zq is summed once, after the last layer,
// from every layer's indices kept in shared memory: ((0 + E_0[i_0]) +
// E_1[i_1]) + ..., the plain update's additions in its order.  R's row
// stride FT + 4 keeps its rows 16-byte aligned and puts those 8 rows x 4
// frames in 32 distinct banks.
//
// Plain C interface for ctypes: pointers and the stream as void*, ints as
// int; returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "bulk_ring.cuh"

namespace {

using bulk_ring::bulk_copy;
using bulk_ring::mbar_arrive;
using bulk_ring::mbar_expect_tx;
using bulk_ring::mbar_fence_init;
using bulk_ring::mbar_init;
using bulk_ring::mbar_wait;
using bulk_ring::smem_u32;

constexpr int SMEM_LIMIT = 232448;  // bytes a block may use on sm_90
constexpr int TF = 8;               // frames per thread
constexpr int TC = 8;               // codes per thread and chunk
constexpr int UB = 4;               // a warp's work items whose loads overlap
constexpr int RU = 8;               // rows of D a trip of the product loop
constexpr int NF = 4;               // frames of a warp's r2 sums at a time
constexpr int MAX_STAGES = 4;
constexpr int BAR_BYTES = 16 * MAX_STAGES;  // full and empty barriers

// threads of a block: WR rows of TF frames a warp, FT frames a block
template <int WR, int FT>
__host__ __device__ constexpr int block_threads() {
  return FT / TF / WR * 32;
}

// shared memory of a block: the barriers, R (DP rows of FT + 4), the ring
// (NBUF stages of KS rows and e2), r2 and every layer's indices
__host__ __device__ constexpr size_t smem_bytes(int FT, int DP, int NC,
                                                int KS, int NBUF, int Q) {
  return BAR_BYTES + 4 * ((size_t)DP * (FT + 4) +
                          (size_t)NBUF * (KS + 1) * NC + (size_t)FT * (1 + Q));
}

// a row of the thread's frames (8 consecutive, 16-byte aligned) and of its
// codes (4 at ep, 4 at ep + NC / 2)
template <int NC>
__device__ __forceinline__ void load_row(float4 (&a)[2], float4 (&b)[2],
                                         const float* rp, const float* ep) {
  a[0] = *reinterpret_cast<const float4*>(rp);
  a[1] = *reinterpret_cast<const float4*>(rp + 4);
  b[0] = *reinterpret_cast<const float4*>(ep);
  b[1] = *reinterpret_cast<const float4*>(ep + NC / 2);
}

// acc[i][j] += a[i] * b[j], one fmaf each
__device__ __forceinline__ void outer(float (&acc)[TF][TC],
                                      const float4 (&a)[2],
                                      const float4 (&b)[2]) {
  const float av[TF] = {a[0].x, a[0].y, a[0].z, a[0].w,
                        a[1].x, a[1].y, a[1].z, a[1].w};
  const float bv[TC] = {b[0].x, b[0].y, b[0].z, b[0].w,
                        b[1].x, b[1].y, b[1].z, b[1].w};
#pragma unroll
  for (int i = 0; i < TF; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

// at most 128 registers a thread, so that 512 threads of an SM fit
template <int WR, int FT>
__global__ void __launch_bounds__(block_threads<WR, FT>(),
                                  512 / block_threads<WR, FT>())
rvq_encode_kernel(const float* __restrict__ z,       // (N, D)
                  const float* __restrict__ packed,  // (Q, NCH, DP + 1, NC)
                  const float* __restrict__ embed,   // (Q, NE, D)
                  float* __restrict__ zq,            // (N, D)
                  int* __restrict__ idx,             // (N, Q)
                  int N, int Q, int NE, int D, int DP, int KS, int NBUF) {
  constexpr int COLS = 32 / WR;   // threads sharing a frame
  constexpr int NC = TC * COLS;   // codes per chunk
  constexpr int SR = FT + 4;      // row stride of R
  constexpr int NTHREADS = block_threads<WR, FT>();
  constexpr int NWARPS = NTHREADS / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t full0 = smem_u32(smem_raw);
  const uint32_t empty0 = full0 + 8 * MAX_STAGES;
  float* R = reinterpret_cast<float*>(smem_raw + BAR_BYTES);  // k-major
  const int stage = (KS + 1) * NC;
  float* ring = R + (size_t)DP * SR;
  float* R2 = ring + NBUF * stage;
  int* IDX = reinterpret_cast<int*>(R2 + FT);  // Q x FT

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = lane % COLS, ty = warp * WR + lane / COLS;
  const int n0 = blockIdx.x * FT;
  const int nch = (NE + NC - 1) / NC, nsl = (DP + KS - 1) / KS;
  const int per_q = nch * nsl, steps = Q * per_q;
  // steps in flight ahead of the one consumed; a buffer is refilled once
  // every warp has released its last step
  const int ahead = NBUF > 2 ? NBUF - 2 : 1;

  // thread 0: step s = (layer, chunk, slice), its KS rows and, in the
  // last slice, the e2 row after them, one bulk copy
  auto issue = [&](int s) {
    if (s >= steps) return;
    const int b = s % NBUF, use = s / NBUF;
    if (use > 0) mbar_wait(empty0 + 8 * b, (use - 1) & 1);
    const int q = s / per_q, r = s - q * per_q;
    const int ch = r / nsl, sl = r - ch * nsl;
    const int k0 = sl * KS;
    const int rows = min(KS, DP - k0) + (sl == nsl - 1);
    const uint32_t bytes = 4u * rows * NC;
    mbar_expect_tx(full0 + 8 * b, bytes);
    bulk_copy(smem_u32(ring + b * stage),
              packed + (((size_t)q * nch + ch) * (DP + 1) + k0) * NC, bytes,
              full0 + 8 * b);
  };
  // r2 of every frame: a warp per frame, lane-strided fmaf sums, then a
  // butterfly (every lane ends with the same sum); NF frames at a time so
  // that their loads and shuffles overlap
  auto norms = [&]() {
    for (int f0 = warp; f0 < FT; f0 += NF * NWARPS) {
      float s[NF];
#pragma unroll
      for (int u = 0; u < NF; ++u) s[u] = 0.f;
      for (int k = lane; k < D; k += 32)
#pragma unroll
        for (int u = 0; u < NF; ++u) {
          const float r = R[k * SR + min(f0 + u * NWARPS, FT - 1)];
          s[u] = fmaf(r, r, s[u]);
        }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < NF; ++u)
          s[u] = __fadd_rn(s[u], __shfl_xor_sync(0xffffffffu, s[u], o));
#pragma unroll
      for (int u = 0; u < NF; ++u)
        if (lane == 0 && f0 + u * NWARPS < FT) R2[f0 + u * NWARPS] = s[u];
    }
  };
  // work items of the staging and the update: a warp takes frames
  // 4g..4g+3 x elements 8kb..8kb+7 of D, UB items at a time
  const int groups = FT / 4;
  const int items = groups * ((DP + 7) / 8);

  if (tid == 0) {
    for (int b = 0; b < NBUF; ++b) {
      mbar_init(full0 + 8 * b, 1);
      mbar_init(empty0 + 8 * b, NWARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < ahead; ++s) issue(s);

  // this block's frames, zero past N and in the padding of D
  for (int it0 = warp; it0 < items; it0 += UB * NWARPS) {
    float zv[UB];
#pragma unroll
    for (int u = 0; u < UB; ++u) {
      const int it = it0 + u * NWARPS;
      const int kb = it / groups, g = it - kb * groups;
      const int f = 4 * g + (lane & 3), k = 8 * kb + (lane >> 2);
      const int n = n0 + f;
      zv[u] = it < items && n < N && k < D ? z[(size_t)n * D + k] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UB; ++u) {
      const int it = it0 + u * NWARPS;
      const int kb = it / groups, g = it - kb * groups;
      const int f = 4 * g + (lane & 3), k = 8 * kb + (lane >> 2);
      if (it < items && k < DP) R[k * SR + f] = zv[u];
    }
  }
  __syncthreads();
  norms();
  __syncthreads();

  int s = 0;
  for (int q = 0; q < Q; ++q) {
    float best[TF];
    int bidx[TF];
#pragma unroll
    for (int i = 0; i < TF; ++i) {
      best[i] = INFINITY;
      bidx[i] = 0x7fffffff;
    }
    for (int ch = 0; ch < nch; ++ch) {
      float acc[TF][TC];
#pragma unroll
      for (int i = 0; i < TF; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) acc[i][j] = 0.f;
      const float* E = nullptr;
      int rows = 0;
      for (int sl = 0; sl < nsl; ++sl, ++s) {
        if (tid == 0) issue(s + ahead);
        const int b = s % NBUF;
        mbar_wait(full0 + 8 * b, (s / NBUF) & 1);
        E = ring + b * stage;
        const int k0 = sl * KS;
        rows = min(KS, DP - k0);
        const float* rp = R + k0 * SR + TF * ty;
        const float* ep = E + 4 * tx;
        // rows of R and of the chunk, two in registers: row kk + 1 loads
        // while row kk is multiplied; RU rows a trip, then 4 (rows is a
        // multiple of 4; the row one past the last lies in shared memory
        // too and is not used)
        float4 va[2][2], vb[2][2];
        load_row<NC>(va[0], vb[0], rp, ep);
        int kk = 0;
        for (; kk + RU <= rows; kk += RU) {
#pragma unroll
          for (int u = 0; u < RU; u += 2) {
            load_row<NC>(va[1], vb[1], rp + (u + 1) * SR, ep + (u + 1) * NC);
            outer(acc, va[0], vb[0]);
            load_row<NC>(va[0], vb[0], rp + (u + 2) * SR, ep + (u + 2) * NC);
            outer(acc, va[1], vb[1]);
          }
          rp += RU * SR;
          ep += RU * NC;
        }
        for (; kk < rows; kk += 2) {
          load_row<NC>(va[1], vb[1], rp + SR, ep + NC);
          outer(acc, va[0], vb[0]);
          load_row<NC>(va[0], vb[0], rp + 2 * SR, ep + 2 * NC);
          outer(acc, va[1], vb[1]);
          rp += 2 * SR;
          ep += 2 * NC;
        }
        if (sl + 1 < nsl) {  // the last slice is released after its e2 row
          __syncwarp();
          if (lane == 0) mbar_arrive(empty0 + 8 * b);
        }
      }
      // the chunk's distances, this thread's codes in ascending order; the
      // e2 row follows the last slice's rows
      float r2[TF];
#pragma unroll
      for (int i = 0; i < TF; ++i) r2[i] = R2[TF * ty + i];
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int col = 4 * tx + (j < 4 ? j : NC / 2 + j - 4);
        const int c = ch * NC + col;
        const float ec = E[rows * NC + col];
        const bool real = c < NE;  // the padded codes never win
#pragma unroll
        for (int i = 0; i < TF; ++i) {
          const float dist =
              __fadd_rn(__fsub_rn(r2[i], __fmul_rn(2.f, acc[i][j])), ec);
          if (real && dist < best[i]) {
            best[i] = dist;
            bidx[i] = c;
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * ((s - 1) % NBUF));
    }

    // the row's COLS candidates by the lexicographic min of (dist, index)
#pragma unroll
    for (int i = 0; i < TF; ++i) {
      float bd = best[i];
      int bi = bidx[i];
#pragma unroll
      for (int o = COLS / 2; o > 0; o >>= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, bd, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (od < bd || (od == bd && oi < bi)) {
          bd = od;
          bi = oi;
        }
      }
      if (bi >= NE) bi = 0;  // no finite distance
      if (tx == 0) {
        const int f = TF * ty + i, n = n0 + f;
        IDX[FT * q + f] = bi;
        if (n < N) idx[(size_t)n * Q + q] = bi;
      }
    }
    __syncthreads();

    // gather, r -= quant (zq is summed once every index is known)
    const float* Eq = embed + (size_t)q * NE * D;
    for (int it0 = warp; it0 < items; it0 += UB * NWARPS) {
      float qv[UB];
#pragma unroll
      for (int u = 0; u < UB; ++u) {
        const int it = it0 + u * NWARPS;
        const int kb = it / groups, g = it - kb * groups;
        const int f = 4 * g + (lane & 3), k = 8 * kb + (lane >> 2);
        qv[u] = it < items && k < D ? Eq[(size_t)IDX[FT * q + f] * D + k]
                                    : 0.f;
      }
#pragma unroll
      for (int u = 0; u < UB; ++u) {
        const int it = it0 + u * NWARPS;
        const int kb = it / groups, g = it - kb * groups;
        const int f = 4 * g + (lane & 3), k = 8 * kb + (lane >> 2);
        if (it < items && k < D) {
          float* r = R + k * SR + f;
          *r = __fsub_rn(*r, qv[u]);
        }
      }
    }
    __syncthreads();
    if (q + 1 < Q) {
      norms();
      __syncthreads();
    }
  }
  // zq = ((0 + E_0[i_0]) + E_1[i_1]) + ..., the plain update's sum in
  // layer order, its gathers independent of each other
  for (int it0 = warp; it0 < items; it0 += UB * NWARPS) {
    float v[UB];
#pragma unroll
    for (int u = 0; u < UB; ++u) v[u] = 0.f;
#pragma unroll 4
    for (int q = 0; q < Q; ++q) {
      const float* Eq = embed + (size_t)q * NE * D;
#pragma unroll
      for (int u = 0; u < UB; ++u) {
        const int it = it0 + u * NWARPS;
        const int kb = it / groups, g = it - kb * groups;
        const int f = 4 * g + (lane & 3), k = 8 * kb + (lane >> 2);
        const float qv = it < items && k < D
                             ? Eq[(size_t)IDX[FT * q + f] * D + k]
                             : 0.f;
        v[u] = __fadd_rn(v[u], qv);
      }
    }
#pragma unroll
    for (int u = 0; u < UB; ++u) {
      const int it = it0 + u * NWARPS;
      const int kb = it / groups, g = it - kb * groups;
      const int f = 4 * g + (lane & 3), k = 8 * kb + (lane >> 2);
      const int n = n0 + f;
      if (it < items && k < D && n < N) zq[(size_t)n * D + k] = v[u];
    }
  }
}

template <int WR, int FT>
int launch(const void* z, const void* packed, const void* embed, void* zq,
           void* idx, int N, int Q, int NE, int D, int DP, int KS, int NBUF,
           cudaStream_t stream) {
  constexpr int NC = TC * 32 / WR;
  const size_t smem = smem_bytes(FT, DP, NC, KS, NBUF, Q);
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  auto kernel = rvq_encode_kernel<WR, FT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)  // all of the SM's L1 as shared memory
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + FT - 1) / FT;
  kernel<<<blocks, block_threads<WR, FT>(), smem, stream>>>(
      static_cast<const float*>(z), static_cast<const float*>(packed),
      static_cast<const float*>(embed), static_cast<float*>(zq),
      static_cast<int*>(idx), N, Q, NE, D, DP, KS, NBUF);
  return (int)cudaGetLastError();
}

}  // namespace

// z, zq: (N, D) float32; packed: (Q, NCH, DP + 1, NC) float32, the
// codebooks in chunks of NC = 256 / WR codes, k-major (DP = D rounded up to
// a multiple of 4), row DP the codes' |E|^2, zero past NE and D; embed:
// (Q, NE, D) float32; idx: (N, Q) int32; all contiguous.  The geometry:
// FT frames a block and WR rows of threads a warp (one of the pairs
// instantiated below), KS rows of D a ring stage (a multiple of 4), NBUF
// stages (2 to 4).
extern "C" int rvq_encode_forward(const void* z, const void* packed,
                                  const void* embed, void* zq, void* idx,
                                  int N, int Q, int NE, int D, int DP, int FT,
                                  int WR, int KS, int NBUF, void* stream) {
  if (N < 1 || Q < 1 || NE < 1 || D < 1 || DP != (D + 3) / 4 * 4 ||
      KS < 4 || KS % 4 || NBUF < 2 || NBUF > MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RVQ_LAUNCH(wr, ft)                                                  \
  if (WR == wr && FT == ft)                                                 \
    return launch<wr, ft>(z, packed, embed, zq, idx, N, Q, NE, D, DP, KS,   \
                          NBUF, st);
  RVQ_LAUNCH(2, 128)
  RVQ_LAUNCH(2, 64)
  RVQ_LAUNCH(1, 64)
  RVQ_LAUNCH(1, 32)
  RVQ_LAUNCH(1, 16)
  RVQ_LAUNCH(1, 8)
#undef RVQ_LAUNCH
  return (int)cudaErrorInvalidValue;
}
