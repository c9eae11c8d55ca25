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
// Design, bf16 and int8: the tensor cores through `wgmma` (bf16
// m64n128k16 into f32, s8 m64n128k32 into s32), the only way to Hopper's
// full tensor-core rate.  A block has CWG consumer warpgroups, each owning
// 64 rows (BM = 64 CWG), and one producer warp; a block walks the M tiles
// from blockIdx.x in steps of gridDim.x, a persistent grid of one block
// per SM (faster than one block per tile on the card in every case).
// What bounds it is keeping the tensor cores fed, so:
//   - w[i], packed by the wrapper in wgmma's K-major order with the
//     128-byte swizzle (ops/kernels/dot_chain.py wgmma_pack), streams into
//     a ring of NSTAGE shared-memory stages, one `cp.async.bulk` copy of
//     32 KB (bf16) or 16 KB (int8) per dot issued by the producer's one
//     thread, completion signalled on the stage's `full` mbarrier; the
//     consumers release a stage on its `empty` mbarrier after the
//     `wgmma.wait_group` that covers its last reader, so NSTAGE - 1 copies
//     are in flight while the products run;
//   - B is read through a shared-memory descriptor (128-byte swizzle,
//     8-row groups 1024 bytes apart), advanced 32 bytes per k-step inside
//     a 128-byte swizzle atom;
//   - chained: A lives in registers (wgmma's register-A form).  x's rows
//     are loaded straight into the A fragments; after each dot the
//     accumulators are narrowed into the next dot's A fragments.  For bf16
//     the m64n128 f32 accumulator layout is the m64k16 A layout k-step by
//     k-step (two n8 blocks per k-step); for s8 it is not (a thread holds 2
//     adjacent columns of a row, the A fragment 4), so each quad of lanes
//     trades its narrowed bytes with 2 shuffles per k-step and row half and
//     byte permutes.  The CWG warpgroups' chains interleave on the tensor
//     cores, hiding each one's wait and narrow step;
//   - independent: x's 64 rows of a warpgroup are staged once, swizzled,
//     in shared memory and read through a descriptor for every dot, one
//     accumulator set chained through all dots (the tensor cores' sum; for
//     bf16 within 2.2e-4 relative L2 of the plain version's f32 sums at the
//     probe's 64 dots, on the card), one wgmma group kept in flight while
//     the next dot's products are issued.
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

#include "bulk_ring.cuh"

namespace {

constexpr int N = 128;        // the dot's width and depth
constexpr int CWG = 3;        // wgmma kernel: consumer warpgroups per block
constexpr int WBM = 64 * CWG; // wgmma kernel: rows per block
constexpr int WTHREADS = 128 * CWG + 32;  // and one producer warp
constexpr int NSTAGE = 4;     // ring stages of w[i]
constexpr int KBYTES = 32;    // bytes of one k-step of a row
constexpr int ATOM = 128;     // bytes of a row in one swizzle atom

enum { BF16 = 0, INT8 = 1, F32 = 2 };

using bulk_ring::bulk_copy;
using bulk_ring::mbar_arrive;
using bulk_ring::mbar_expect_tx;
using bulk_ring::mbar_fence_init;
using bulk_ring::mbar_init;
using bulk_ring::mbar_wait;
using bulk_ring::smem_u32;

// wgmma's shared-memory descriptor of a K-major operand with the 128-byte
// swizzle: start address >> 4, leading byte offset 16 (unused by this
// layout), 8-row groups 1024 bytes apart, layout 1 (128-byte swizzle)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// byte offset of 16-byte chunk c of row r in a K-major tile of `rows` rows
// with the 128-byte swizzle: atoms of 128 bytes per row, rows * 128 bytes
// apart, the chunk index XORed with the row's phase in its 8-row group
__device__ __forceinline__ int swizzled(int r, int c, int rows) {
  return (c >> 3) * rows * ATOM + r * ATOM + (((c & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N_>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N_) : "memory");
}
// keep the compiler from moving reads or writes of the registers across
// an asynchronous wgmma
__device__ __forceinline__ void pin(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}
__device__ __forceinline__ void pin(int& r) {
  asm volatile("" : "+r"(r) :: "memory");
}
__device__ __forceinline__ void pin(uint32_t& r) {
  asm volatile("" : "+r"(r) :: "memory");
}

// d (64 x 128, the m64n128 accumulator layout) += A x B, B through the
// descriptor db, A from registers (_rs) or through the descriptor da
// (_ss); scale_d = 0 drops d
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, "
      "%65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db,
    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, "
      "%65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(int (&d)[64], const uint32_t (&a)[4],
    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, "
      "%65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(int (&d)[64], uint64_t da, uint64_t db,
    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, "
      "%65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// the dtype's traits: k-steps per 128-wide dot, the chained step's narrow
// into the next dot's A fragments, and the output's narrow
template <typename T>
struct Chain;

template <>
struct Chain<__nv_bfloat16> {
  using Acc = float;
  static constexpr int KSTEPS = 8;  // k16
  // the m64n128 accumulators as the m64k16 A fragments: k-step ks covers
  // n8 blocks 2 ks and 2 ks + 1
  __device__ __forceinline__ static void to_a(uint32_t (&a)[KSTEPS][4], const float (&d)[64],
                              int) {
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const int j0 = 8 * ks, j1 = 8 * ks + 4;
      a[ks][0] = pack_bf16(d[j0], d[j0 + 1]);
      a[ks][1] = pack_bf16(d[j0 + 2], d[j0 + 3]);
      a[ks][2] = pack_bf16(d[j1], d[j1 + 1]);
      a[ks][3] = pack_bf16(d[j1 + 2], d[j1 + 3]);
    }
  }
  // two adjacent outputs at p
  __device__ __forceinline__ static void store2(void* p, float v0, float v1, bool) {
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(v0, v1);
  }
};

template <>
struct Chain<int8_t> {
  using Acc = int;
  static constexpr int KSTEPS = 4;  // k32
  // the low bytes of floor(d / 4096) as the m64k32 A fragments.  A thread
  // holds columns 2t, 2t + 1 of each n8 block j; the fragment wants
  // columns 4t .. 4t + 3 of k-step ks for a0 / a1 (block 4 ks + t / 2, held
  // by lanes 2 (t & 1) and 2 (t & 1) + 1 of the quad) and 16 more for
  // a2 / a3 (block 4 ks + 2 + t / 2).  Each lane packs, per k-step and row
  // half, its two bytes of blocks m and m + 2 into one word, for m = t & 1
  // and for m = 1 - (t & 1); two shuffles then bring each lane its two
  // source lanes' words (lane 2 (t & 1) + (t >> 1) reads parity t >> 1
  // first), and two byte permutes put them in column order.
  __device__ __forceinline__ static void to_a(uint32_t (&a)[KSTEPS][4],
                                              const int (&d)[64], int lane) {
    const int t = lane & 3, hi = t >> 1, odd = t & 1;
    const int base = lane & ~3;
    const int src1 = base | (2 * odd + hi), src2 = base | (2 * odd + 1 - hi);
    // (r1, r2) -> a word of the two sources' low (P0) or high (P1) halves,
    // the lower-column source first
    const uint32_t lo = hi ? 0x1054u : 0x5410u, up = hi ? 0x3276u : 0x7632u;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t b[4];  // block 4 ks + m, row half h: 2 bytes (low half)
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int j = 4 * (4 * ks + m) + 2 * h;
          b[m] = __byte_perm((uint32_t)(d[j] >> 12),
                             (uint32_t)(d[j + 1] >> 12), 0x0040u);
        }
        const uint32_t w0 = __byte_perm(b[0], b[2], 0x5410u);
        const uint32_t w1 = __byte_perm(b[1], b[3], 0x5410u);
        const uint32_t r1 = __shfl_sync(0xffffffffu, odd ? w1 : w0, src1);
        const uint32_t r2 = __shfl_sync(0xffffffffu, odd ? w0 : w1, src2);
        a[ks][h] = __byte_perm(r1, r2, lo);
        a[ks][2 + h] = __byte_perm(r1, r2, up);
      }
  }
  // the low byte of each (after floor(d / 4096) where `shift`), as XLA's
  // s32 -> s8 convert
  __device__ __forceinline__ static void store2(void* p, int v0, int v1, bool shift) {
    if (shift) {
      v0 >>= 12;
      v1 >>= 12;
    }
    *reinterpret_cast<uint16_t*>(p) =
        (uint16_t)((uint32_t)(v0 & 0xff) | ((uint32_t)(v1 & 0xff) << 8));
  }
};

// T: __nv_bfloat16 or int8_t.  wpack: n_dots packed B tiles (wgmma_pack);
// tiles of WBM rows from blockIdx.x in steps of gridDim.x.
template <typename T>
__global__ void __launch_bounds__(WTHREADS, 1)
wgmma_chain_kernel(const T* __restrict__ x, const unsigned char* __restrict__ wpack,
                   T* __restrict__ out, int M, int n_dots, int independent) {
  using C = Chain<T>;
  using Acc = typename C::Acc;
  constexpr int RB = N * (int)sizeof(T);    // bytes of a 128-element row
  constexpr int WB = N * RB;                // bytes of one packed w[i]
  constexpr int XB = 64 * RB;               // bytes of a warpgroup's rows
  constexpr int KS = C::KSTEPS;
  constexpr int KPA = ATOM / KBYTES;        // k-steps per swizzle atom
  extern __shared__ unsigned char smem_raw[];
  // the swizzle repeats every 1024 bytes: align the ring and the rows
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* ring = smem;                         // NSTAGE x WB
  unsigned char* xs = ring + NSTAGE * WB;             // CWG x XB
  uint64_t* bars = reinterpret_cast<uint64_t*>(xs + CWG * XB);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + NSTAGE);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ntiles = (M + WBM - 1) / WBM;

  if (tid == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * CWG);  // one arrive per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * CWG) {  // the producer: one thread streams the ring
    if (lane == 0) {
      int q = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x)
        for (int i = 0; i < n_dots; ++i, ++q) {
          const int s = q % NSTAGE, use = q / NSTAGE;
          if (use > 0) mbar_wait(empty0 + 8 * s, (use - 1) & 1);
          mbar_expect_tx(full0 + 8 * s, WB);
          bulk_copy(smem_u32(ring + s * WB), wpack + (size_t)i * WB, WB,
                    full0 + 8 * s);
        }
    }
    return;
  }

  const int wg = warp >> 2, wt = tid & 127;
  const int g = lane >> 2, t = lane & 3;
  unsigned char* xw = xs + wg * XB;  // this warpgroup's rows (independent)
  const uint32_t ring0 = smem_u32(ring), xw0 = smem_u32(xw);
  Acc d[64];
  uint32_t a[KS][4];
  int q = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int row0 = tile * WBM + wg * 64;
    const int ra = row0 + (warp & 3) * 16 + g, rb = ra + 8;
#pragma unroll
    for (int e = 0; e < 64; ++e) d[e] = 0;
    if (independent) {
      // the rows into xw, swizzled, zero past M; the warpgroup's reads of
      // the last tile's rows are done
      bar_sync(1 + wg, 128);
      for (int e = wt; e < 64 * (RB / 16); e += 128) {
        const int r = e / (RB / 16), c = e % (RB / 16);
        uint4 v = make_uint4(0, 0, 0, 0);
        if (row0 + r < M)
          v = reinterpret_cast<const uint4*>(x + (size_t)(row0 + r) * N)[c];
        *reinterpret_cast<uint4*>(xw + swizzled(r, c, 64)) = v;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_sync(1 + wg, 128);
      for (int i = 0; i < n_dots; ++i, ++q) {
        const int s = q % NSTAGE;
        mbar_wait(full0 + 8 * s, (q / NSTAGE) & 1);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const int off = (ks % KPA) * KBYTES;
          wgmma_ss(d, sw128_desc(xw0 + (ks / KPA) * 64 * ATOM + off),
                   sw128_desc(ring0 + s * WB + (ks / KPA) * N * ATOM + off),
                   1);
        }
        wgmma_commit();
        // the last dot's products are done: release its stage
        wgmma_wait<1>();
        if (i > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((q - 1) % NSTAGE));
      }
      wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < 64; ++e) pin(d[e]);
      if (lane == 0) mbar_arrive(empty0 + 8 * ((q - 1) % NSTAGE));
    } else {
      // x's rows as the A fragments: rows ra, rb; k-step ks at byte
      // 32 ks (+ 16 for a2, a3), a lane's 4 bytes at 4 t
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int r = (h & 1) ? rb : ra;
          const unsigned char* p = reinterpret_cast<const unsigned char*>(
              x + (size_t)r * N) + ks * KBYTES + (h >> 1) * 16 + 4 * t;
          a[ks][h] = r < M ? *reinterpret_cast<const uint32_t*>(p) : 0u;
        }
      for (int i = 0; i < n_dots; ++i, ++q) {
        const int s = q % NSTAGE;
        mbar_wait(full0 + 8 * s, (q / NSTAGE) & 1);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          wgmma_rs(d, a[ks],
                   sw128_desc(ring0 + s * WB + (ks / KPA) * N * ATOM +
                              (ks % KPA) * KBYTES),
                   ks > 0);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int e = 0; e < 64; ++e) pin(d[e]);
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
#pragma unroll
          for (int h = 0; h < 4; ++h) pin(a[ks][h]);
        if (lane == 0) mbar_arrive(empty0 + 8 * s);
        if (i + 1 < n_dots) C::to_a(a, d, lane);
      }
    }
    // out: rows ra, rb, columns 8 j + 2 t, + 1
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = h ? rb : ra;
        if (r < M)
          C::store2(out + (size_t)r * N + 8 * j + 2 * t, d[4 * j + 2 * h],
                    d[4 * j + 2 * h + 1], !independent);
      }
  }
}

// shared memory of the wgmma kernel: the ring, the warpgroups' rows, the
// barriers and the slack of the 1024-byte alignment
template <typename T>
constexpr int wgmma_smem() {
  return NSTAGE * N * N * (int)sizeof(T) + CWG * 64 * N * (int)sizeof(T) +
         2 * NSTAGE * 8 + 1024;
}

constexpr int BM = 128;       // f32 kernel: rows per block
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

// one block per SM, or per tile where the tiles are fewer
template <typename T>
int launch_wgmma(const void* x, const void* w, void* out, int M, int n_dots,
                 int independent, cudaStream_t s) {
  const int ntiles = (M + WBM - 1) / WBM;
  const int smem = wgmma_smem<T>();
  auto k = wgmma_chain_kernel<T>;
  int dev, sms;
  cudaError_t err = allow_smem(k, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  k<<<sms < ntiles ? sms : ntiles, WTHREADS, smem, s>>>(
      static_cast<const T*>(x), static_cast<const unsigned char*>(w),
      static_cast<T*>(out), M, n_dots, independent);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: (M, 128) contiguous; dtype: 0 bf16, 1 int8, 2 f32.  w: for f32
// (n_dots, 128, 128) contiguous as [i][k][n]; for bf16 and int8 the
// n_dots tiles of ops/kernels/dot_chain.py wgmma_pack (w[i] transposed to
// [n][k] and laid out in wgmma's 128-byte swizzle), 16-byte aligned.
extern "C" int dot_chain_forward(const void* x, const void* w, void* out,
                                 int M, int n_dots, int dtype,
                                 int independent, void* stream) {
  if (M < 1 || n_dots < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == BF16)
    return launch_wgmma<__nv_bfloat16>(x, w, out, M, n_dots, independent,
                                       s);
  if (dtype == INT8)
    return launch_wgmma<int8_t>(x, w, out, M, n_dots, independent, s);
  if (dtype != F32) return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(float) * (N * N + N * FS);
  if ((err = allow_smem(f32_chain_kernel, smem)) != cudaSuccess)
    return (int)err;
  f32_chain_kernel<<<(M + BM - 1) / BM, FTHREADS, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), M, n_dots, independent);
  return (int)cudaGetLastError();
}
