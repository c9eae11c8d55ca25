// Building blocks of the wide tensor-core stacks (csrc/wide_stack_mma.cu,
// the folded residual stack above C = 32, and csrc/ablate_stack.cu's wide
// route): bf16 rounding and packing, `ldmatrix` fragment loads, mma.sync
// m16n8k16 summed apart (`mma_add`), a warp's product over one weight
// stage (`product`), the `cp.async` weight ring (`WeightRing`) and the
// time-major staging of act(v).
//
// A header of device functions only, included by each source; the build
// (ops/kernels/_build.py) hashes it with every source.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace wide_mma {

constexpr int SMEM_LIMIT = 232448;   // bytes a block may use on sm_90

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
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

// c += a * b, the mma's 16 products summed from zero and added to c with
// round-to-nearest f32 adds: one accumulator chained through many k-steps
// in the tensor cores drifts from exact sums (ROADMAP §C)
__device__ __forceinline__ void mma_add(float (&c)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  float d[4];
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
#pragma unroll
  for (int q = 0; q < 4; ++q) c[q] = __fadd_rn(c[q], d[q]);
}

// c += the MTW m16 tiles of A (tile mt's lane row at ap[mt]) x 32 output
// channels of B (the lane's row at bp, rows ks apart) over kc input
// channels: A and B fragments from ldmatrix (the lane's A row lane & 15 at
// column 8 (lane >> 4); its B row (lane & 7) + 8 (lane >> 4) at column
// 8 ((lane >> 3) & 1)), each B fragment feeding MTW tiles, each mma summed
// apart (mma_add)
template <int MTW>
__device__ __forceinline__ void product(float (&c)[MTW][4][4],
                                        const __nv_bfloat16* const (&ap)[MTW],
                                        const __nv_bfloat16* bp, int ks,
                                        int kc) {
  for (int kk = 0; kk < kc; kk += 16) {
    uint32_t bf[2][4];
    ldmatrix_x4(bf[0], bp + kk);
    ldmatrix_x4(bf[1], bp + 16 * ks + kk);
#pragma unroll
    for (int mt = 0; mt < MTW; ++mt) {
      uint32_t af[4];
      ldmatrix_x4(af, ap[mt] + kk);
#pragma unroll
      for (int n = 0; n < 4; ++n)
        mma_add(c[mt][n], af, bf[n >> 1][2 * (n & 1)],
                bf[n >> 1][2 * (n & 1) + 1]);
    }
  }
}

// The weight ring: nbuf (2 or 3) shared-memory buffers of `stage` bf16
// through which a block streams its weight stages with cp.async, stage s
// into buffer s % nbuf as rows of kc bf16 padded to kc + 8 (so that an
// ldmatrix's eight rows hit distinct banks).  src(s, rows) gives stage
// s's first row in device memory, the rows ld apart, and sets its row
// count.  Every thread of the block calls start() once, then next(s) for
// s = 0, 1, ... in turn.
template <typename Src>
struct WeightRing {
  __nv_bfloat16* buf;
  int stage, nbuf, nsteps, kc, ld;
  Src src;

  // stage s's copies as one commit group (empty past the last stage)
  __device__ __forceinline__ void issue(int s) const {
    if (s < nsteps) {
      int rows;
      const __nv_bfloat16* g = src(s, rows);
      __nv_bfloat16* dst = buf + (s % nbuf) * stage;
      const int vpr = kc / 8, ks = kc + 8;  // 16-byte vectors per row
      for (int e = threadIdx.x; e < rows * vpr; e += blockDim.x) {
        const int o = e / vpr, v = e - o * vpr;
        cp_async16(dst + o * ks + v * 8, g + (size_t)o * ld + v * 8);
      }
    }
    cp_async_commit();
  }

  // the copies of the first nbuf - 1 stages
  __device__ __forceinline__ void start() const {
    for (int s = 0; s < nbuf - 1; ++s) issue(s);
  }

  // stage s's buffer, once the stage has landed (nbuf - 2 later groups
  // may be pending) and every warp is done with step s - 1, whose buffer
  // then starts to take stage s + nbuf - 1
  __device__ __forceinline__ const __nv_bfloat16* next(int s) const {
    if (nbuf == 3)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    issue(s + nbuf - 1);
    return buf + (s % nbuf) * stage;
  }
};

template <typename Src>
__device__ __forceinline__ WeightRing<Src> weight_ring(
    __nv_bfloat16* buf, int stage, int nbuf, int nsteps, int kc, int ld,
    Src src) {
  return {buf, stage, nbuf, nsteps, kc, ld, src};
}

// Y = bf16(act(x)) over rows 0 .. L - 1 (time tin + row) of the channels
// 0 .. CP - 1 of x (C x T, time contiguous), zero outside [0, T) and past
// C, in rows of CP + 8 bf16.  A warp takes 8 rows x 4 channel pairs:
// 32-byte runs of each channel from device memory, and 4-byte stores to 32
// distinct banks; a thread loads SU of its pairs before it stores any, so
// that their round trips to device memory overlap.  act is a select, not a
// branch, so that a thread's activations overlap too.
template <typename S, typename Act>
__device__ __forceinline__ void stage_act(__nv_bfloat16* Y, const S* x,
                                          int tin, int L, int T, int C,
                                          int CP, Act act) {
  constexpr int SU = 4;
  const int NT = blockDim.x, RS = CP + 8, pblocks = CP / 8;
  const int total = (L + 7) / 8 * pblocks * 32;
  for (int e0 = threadIdx.x; e0 < total; e0 += SU * NT) {
    float v[SU][2];
    int row[SU], col[SU];
#pragma unroll
    for (int u = 0; u < SU; ++u) {
      const int e = e0 + u * NT, gi = e >> 5, l = e & 31;
      const int rb = gi / pblocks, pb = gi - rb * pblocks;
      const int r = rb * 8 + (l & 7), c = (pb * 4 + (l >> 3)) * 2;
      const int t = tin + r;
      const bool live = e < total && r < L && t >= 0 && t < T;
      row[u] = e < total && r < L ? r : -1;
      col[u] = c;
      v[u][0] = live && c < C ? to_f32(x[(size_t)c * T + t]) : 0.f;
      v[u][1] = live && c + 1 < C ? to_f32(x[(size_t)(c + 1) * T + t]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < SU; ++u)
      if (row[u] >= 0)
        *reinterpret_cast<uint32_t*>(Y + row[u] * RS + col[u]) =
            pack_bf16(act(v[u][0]), act(v[u][1]));
  }
}

}  // namespace wide_mma
