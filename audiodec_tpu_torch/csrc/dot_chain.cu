// Dot chain of the matrix-unit rate probe, for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/mxu_rate_probe.py make_pallas_chain
// (pallas_call at :64): x is (M, 128), w is (n_dots, 128, 128), and every
// row of x runs through
//
//   chained:      y = x_row; for i: d = y @ w[i]; y = narrow(d)
//   independent:  acc = sum_i x_row @ w[i] (in order i = 0, 1, ...);
//                 out = narrow(acc)
//
// with the sums in f32 (int32 for int8).  narrow is the dtype's cast: bf16
// rounds to nearest even; int8 keeps the low byte, after floor(d / 4096) in
// the chained mode; f32 keeps d.  Rows are independent, so the TPU's tiles
// of `rows` rows are a layout only: a block here takes BM rows.
//
// Bound on the H100 at the probe's default (120 x 1024 rows, 64 dots): the
// products, 2 * M * 64 * 128 * 128 = 2.6e11 operations, at 989 TFLOP/s
// (bf16), 1979 TOP/s (int8) or 67 TFLOP/s (f32): 0.261 / 0.130 / 3.846 ms,
// far above the bytes (bin/kernel_bounds.py).  That is the point of the
// probe: it measures the matrix unit's rate on the folded stack's dot
// shape.
//
// Design, bf16 and int8: the tensor cores through mma.sync (bf16 m16n8k16
// into f32, int8 m16n8k32 into s32).  A block of 4 warps owns BM = 128 rows,
// 32 per warp (two 16-row m-tiles, so each B fragment feeds two products),
// and stages w[i], transposed by the wrapper to [n][k], in shared memory,
// one dot at a time.  Each warp keeps its rows' current operand in its own
// shared buffer; a chained step narrows its accumulators back into that
// buffer, which the next dot reads as its A fragments.  Rows of shared
// memory are padded by 16 bytes, so the fragment loads (row g, 4-byte word
// t of a 32-byte k-chunk, for g < 8, t < 4) hit 32 distinct banks.  In
// bytes the two types' fragments have one layout, so one code serves both.
//
// Design, f32: true f32 on the FMA units (TF32 would be another function).
// A block of 256 threads owns BM = 128 rows; w[i] ([k][n]) and the rows'
// operand, transposed to [k][row], sit in shared memory; each thread sums an
// 8 x 8 block of outputs in registers.
//
// Plain C interface for ctypes: pointers and the stream as void*, ints as
// int; returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N = 128;        // the dot's width and depth
constexpr int BM = 128;       // rows per block
constexpr int WARPS = 4;      // tensor-core kernel: warps per block
constexpr int WROWS = BM / WARPS;
constexpr int PAD = 16;       // bytes of padding per shared row

enum { BF16 = 0, INT8 = 1, F32 = 2 };

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// narrow two adjacent accumulators and store them at p
__device__ __forceinline__ void store2(unsigned char* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) =
      __nv_bfloat162(__float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
}
__device__ __forceinline__ void store2(unsigned char* p, int v0, int v1) {
  // the low byte of each, as XLA's s32 -> s8 convert
  *reinterpret_cast<uint16_t*>(p) =
      (uint16_t)((uint32_t)(v0 & 0xff) | ((uint32_t)(v1 & 0xff) << 8));
}

// floor(d / 4096) of the chained int8 step; bf16 keeps d
__device__ __forceinline__ float requant(float d) { return d; }
__device__ __forceinline__ int requant(int d) { return d >> 12; }

// T: the element type (__nv_bfloat16 or int8_t); A: the accumulator type
template <typename T, typename A>
__global__ void __launch_bounds__(WARPS * 32)
mma_chain_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                 T* __restrict__ out, int M, int n_dots, int independent) {
  constexpr int RB = N * (int)sizeof(T);  // bytes of one 128-element row
  constexpr int RS = RB + PAD;            // shared row stride in bytes
  constexpr int KSTEPS = RB / 32;         // an mma's depth is 32 bytes
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* W = smem;                // [n][k], N rows of RS bytes
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  unsigned char* Y = smem + N * RS + warp * WROWS * RS;  // this warp's rows
  const int row0 = blockIdx.x * BM + warp * WROWS;

  // the warp's rows of x, zero past M
  for (int e = lane; e < WROWS * (RB / 16); e += 32) {
    const int r = e / (RB / 16), c = e % (RB / 16);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < M)
      v = reinterpret_cast<const uint4*>(x + (size_t)(row0 + r) * N)[c];
    *reinterpret_cast<uint4*>(Y + r * RS + c * 16) = v;
  }

  A acc[2][N / 8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][j][q] = 0;

  for (int i = 0; i < n_dots; ++i) {
    __syncthreads();  // every warp is done with the previous w
    const T* wi = wt + (size_t)i * N * N;
    for (int e = threadIdx.x; e < N * (RB / 16); e += WARPS * 32) {
      const int r = e / (RB / 16), c = e % (RB / 16);
      *reinterpret_cast<uint4*>(W + r * RS + c * 16) =
          reinterpret_cast<const uint4*>(wi + (size_t)r * N)[c];
    }
    __syncthreads();

    if (!independent) {
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[m][j][q] = 0;
    }
#pragma unroll 1
    for (int ks = 0; ks < KSTEPS; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const unsigned char* p = Y + (m * 16 + g) * RS + ks * 32 + 4 * t;
        a[m][0] = lds32(p);
        a[m][1] = lds32(p + 8 * RS);
        a[m][2] = lds32(p + 16);
        a[m][3] = lds32(p + 8 * RS + 16);
      }
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const unsigned char* p = W + (j * 8 + g) * RS + ks * 32 + 4 * t;
        const uint32_t b0 = lds32(p), b1 = lds32(p + 16);
        mma(acc[0][j], a[0], b0, b1);
        mma(acc[1][j], a[1], b0, b1);
      }
    }

    if (!independent) {
      __syncwarp();  // every lane has read this dot's operand
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          unsigned char* p = Y + (m * 16 + g) * RS +
                             (j * 8 + 2 * t) * (int)sizeof(T);
          store2(p, requant(acc[m][j][0]), requant(acc[m][j][1]));
          store2(p + 8 * RS, requant(acc[m][j][2]), requant(acc[m][j][3]));
        }
      __syncwarp();
    }
  }

  if (independent) {
    __syncwarp();
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        unsigned char* p = Y + (m * 16 + g) * RS +
                           (j * 8 + 2 * t) * (int)sizeof(T);
        store2(p, acc[m][j][0], acc[m][j][1]);
        store2(p + 8 * RS, acc[m][j][2], acc[m][j][3]);
      }
    __syncwarp();
  }

  for (int e = lane; e < WROWS * (RB / 16); e += 32) {
    const int r = e / (RB / 16), c = e % (RB / 16);
    if (row0 + r < M)
      reinterpret_cast<uint4*>(out + (size_t)(row0 + r) * N)[c] =
          *reinterpret_cast<const uint4*>(Y + r * RS + c * 16);
  }
}

constexpr int FTHREADS = 256;  // f32 kernel: 16 x 16 threads of 8 x 8
constexpr int FS = BM + 4;     // stride of the transposed operand [k][row]

__global__ void __launch_bounds__(FTHREADS, 1)
f32_chain_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 float* __restrict__ out, int M, int n_dots,
                 int independent) {
  extern __shared__ __align__(16) float fsmem[];
  float* W = fsmem;          // [k][n], N x N
  float* Y = W + N * N;      // [k][row], N x FS
  const int row0 = blockIdx.x * BM;
  const int r0 = (threadIdx.x >> 4) * 8, c0 = (threadIdx.x & 15) * 8;

  for (int e = threadIdx.x; e < BM * N; e += FTHREADS) {
    const int r = e / N, k = e % N;
    Y[k * FS + r] = row0 + r < M ? x[(size_t)(row0 + r) * N + k] : 0.f;
  }

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  for (int i = 0; i < n_dots; ++i) {
    __syncthreads();  // the previous dot's reads of W and Y are done
    const float4* wi = reinterpret_cast<const float4*>(w + (size_t)i * N * N);
    for (int e = threadIdx.x; e < N * N / 4; e += FTHREADS)
      reinterpret_cast<float4*>(W)[e] = wi[e];
    __syncthreads();
    if (!independent) {
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
    }
#pragma unroll 4
    for (int k = 0; k < N; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(Y + k * FS + r0);
      const float4 a1 = *reinterpret_cast<const float4*>(Y + k * FS + r0 + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(W + k * N + c0);
      const float4 b1 = *reinterpret_cast<const float4*>(W + k * N + c0 + 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    if (!independent) {
      __syncthreads();  // every thread has read this dot's operand
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int r = 0; r < 8; ++r) Y[(c0 + c) * FS + r0 + r] = acc[r][c];
    }
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    if (row0 + r0 + r >= M) continue;
    float4* o = reinterpret_cast<float4*>(out + (size_t)(row0 + r0 + r) * N +
                                          c0);
    o[0] = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    o[1] = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

}  // namespace

// x, out: (M, 128) contiguous; w: (n_dots, 128, 128) contiguous, [i][n][k]
// (transposed) for bf16 and int8, [i][k][n] for f32.  dtype: 0 bf16,
// 1 int8, 2 f32.
extern "C" int dot_chain_forward(const void* x, const void* w, void* out,
                                 int M, int n_dots, int dtype,
                                 int independent, void* stream) {
  if (M < 1 || n_dots < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == BF16) {
    const int smem = (N + BM) * (N * 2 + PAD);
    auto k = mma_chain_kernel<__nv_bfloat16, float>;
    if ((err = allow_smem(k, smem)) != cudaSuccess) return (int)err;
    k<<<grid, WARPS * 32, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), M, n_dots, independent);
  } else if (dtype == INT8) {
    const int smem = (N + BM) * (N + PAD);
    auto k = mma_chain_kernel<int8_t, int>;
    if ((err = allow_smem(k, smem)) != cudaSuccess) return (int)err;
    k<<<grid, WARPS * 32, smem, s>>>(
        static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
        static_cast<int8_t*>(out), M, n_dots, independent);
  } else if (dtype == F32) {
    const int smem = (int)sizeof(float) * (N * N + N * FS);
    if ((err = allow_smem(f32_chain_kernel, smem)) != cudaSuccess)
      return (int)err;
    f32_chain_kernel<<<grid, FTHREADS, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), M, n_dots, independent);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
