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
//
// Bound on the H100: at (16, 1600, 64) frames x 8 layers x 1024 codes the
// cross terms are 2 * 25600 * 8 * 1024 * 64 = 2.7e10 FLOP on the f32 FMA
// units (67 TFLOP/s), against 8.6 MB of input and output: 0.401 ms, bound
// by operations (bin/kernel_bounds.py).
//
// Design: a block owns FB = 64 frames, their residuals in shared memory
// (row stride D + 1, so the lanes' reads fall in distinct banks); warp w
// owns frames 8w..8w+7, so after the first staging the residual rows are
// private to one warp.  For each layer it streams E_q through shared
// memory in chunks of NC = 128 codes (32 KiB at D = 64; a whole layer is
// 256 KiB, over a block's 227 KB).  Each thread scores its warp's 8 frames
// against 4 codes of the chunk (lane + 32 j, ascending), 32 dot products
// in registers, so per step of D it loads 4 code values (conflict-free)
// and 8 residual values (warp broadcasts) for 32 FMAs.  It keeps a running
// (min, argmin) per frame and replaces it only on a strict <, scanning its
// codes upward, and the warp reduces the 32 lanes' candidates by the
// lexicographic min of (distance, index), which gives the lowest index
// among equal minima.  The gather reads E_q[idx] from device memory (the
// whole codebook, 2 MiB for symAD, stays in L2); zq is accumulated in the
// output itself, each element by one thread.  Frames past N are masked.
//
// Plain C interface for ctypes: pointers and the stream as void*, ints as
// int; returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int FPW = 8;               // frames per warp
constexpr int FB = NWARPS * FPW;     // frames per block
constexpr int TC = 4;                // codes per thread and chunk
constexpr int NC = 32 * TC;          // codes per chunk
constexpr int MAX_D = 256;

__global__ void __launch_bounds__(NTHREADS)
rvq_encode_kernel(const float* __restrict__ z,      // (N, D)
                  const float* __restrict__ embed,  // (Q, NE, D)
                  const float* __restrict__ e2,     // (Q, NE)
                  float* __restrict__ zq,           // (N, D)
                  int* __restrict__ idx,            // (N, Q)
                  int N, int Q, int NE, int D) {
  extern __shared__ __align__(16) float smem[];
  const int S = D + 1;             // padded row stride
  float* R = smem;                 // FB x S residuals
  float* E = R + FB * S;           // NC x S codes of the chunk
  float* R2 = E + NC * S;          // FB

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * FB;
  const int f0 = warp * FPW;       // this warp's first frame in the block

  // stage this warp's residuals; zq starts at 0
  for (int f = 0; f < FPW; ++f) {
    const int n = n0 + f0 + f;
    for (int e = lane; e < D; e += 32) {
      R[(f0 + f) * S + e] = n < N ? z[(size_t)n * D + e] : 0.f;
      if (n < N) zq[(size_t)n * D + e] = 0.f;
    }
  }

  for (int q = 0; q < Q; ++q) {
    const float* Eq = embed + (size_t)q * NE * D;
    __syncwarp();
    for (int f = 0; f < FPW; ++f) {
      float s = 0.f;
      for (int e = lane; e < D; e += 32) {
        const float r = R[(f0 + f) * S + e];
        s = fmaf(r, r, s);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
      if (lane == 0) R2[f0 + f] = s;
    }
    __syncwarp();
    float r2[FPW];
#pragma unroll
    for (int f = 0; f < FPW; ++f) r2[f] = R2[f0 + f];

    float best[FPW];
    int bidx[FPW];
#pragma unroll
    for (int f = 0; f < FPW; ++f) {
      best[f] = INFINITY;
      bidx[f] = 0x7fffffff;
    }

    for (int c0 = 0; c0 < NE; c0 += NC) {
      __syncthreads();  // the previous chunk is consumed
      for (int e = threadIdx.x; e < NC * D; e += NTHREADS) {
        const int c = e / D, k = e - c * D;
        E[c * S + k] = c0 + c < NE ? Eq[(size_t)(c0 + c) * D + k] : 0.f;
      }
      __syncthreads();

      float acc[FPW][TC];
#pragma unroll
      for (int f = 0; f < FPW; ++f)
#pragma unroll
        for (int j = 0; j < TC; ++j) acc[f][j] = 0.f;
      const float* rrow = R + f0 * S;
      const float* erow = E + lane * S;
      for (int k = 0; k < D; ++k) {
        float ev[TC], rv[FPW];
#pragma unroll
        for (int j = 0; j < TC; ++j) ev[j] = erow[j * 32 * S + k];
#pragma unroll
        for (int f = 0; f < FPW; ++f) rv[f] = rrow[f * S + k];
#pragma unroll
        for (int f = 0; f < FPW; ++f)
#pragma unroll
          for (int j = 0; j < TC; ++j) acc[f][j] = fmaf(rv[f], ev[j], acc[f][j]);
      }
#pragma unroll
      for (int j = 0; j < TC; ++j) {   // this thread's codes, ascending
        const int c = c0 + lane + 32 * j;
        if (c >= NE) continue;
        const float ec = e2[(size_t)q * NE + c];
#pragma unroll
        for (int f = 0; f < FPW; ++f) {
          const float dist =
              __fadd_rn(__fsub_rn(r2[f], __fmul_rn(2.f, acc[f][j])), ec);
          if (dist < best[f]) {
            best[f] = dist;
            bidx[f] = c;
          }
        }
      }
    }

#pragma unroll
    for (int f = 0; f < FPW; ++f) {
      float bd = best[f];
      int bi = bidx[f];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, bd, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (od < bd || (od == bd && oi < bi)) {
          bd = od;
          bi = oi;
        }
      }
      // no finite distance (an overflow or NaN input): code 0, as argmin
      // of an all-inf row gives
      if (bi >= NE) bi = 0;
      const int n = n0 + f0 + f;
      const float* code = Eq + (size_t)bi * D;
      for (int e = lane; e < D; e += 32) {
        const float qv = code[e];
        float* r = R + (f0 + f) * S + e;
        *r = __fsub_rn(*r, qv);
        if (n < N) {
          float* zp = zq + (size_t)n * D + e;
          *zp = __fadd_rn(*zp, qv);
        }
      }
      if (lane == 0 && n < N) idx[(size_t)n * Q + q] = bi;
    }
  }
}

}  // namespace

// z, zq: (N, D) float32; embed: (Q, NE, D) float32; e2: (Q, NE) float32;
// idx: (N, Q) int32; all contiguous.  D <= 256.
extern "C" int rvq_encode_forward(const void* z, const void* embed,
                                  const void* e2, void* zq, void* idx, int N,
                                  int Q, int NE, int D, void* stream) {
  if (N < 1 || Q < 1 || NE < 1 || D < 1 || D > MAX_D)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)(FB + NC) * (D + 1) + FB);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rvq_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (N + FB - 1) / FB;
  rvq_encode_kernel<<<blocks, NTHREADS, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<const float*>(embed),
      static_cast<const float*>(e2), static_cast<float*>(zq),
      static_cast<int*>(idx), N, Q, NE, D);
  return (int)cudaGetLastError();
}
