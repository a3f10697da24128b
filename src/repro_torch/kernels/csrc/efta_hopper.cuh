// Hopper building blocks that kernel B2's cluster and tile layouts and
// kernel B1's tile and decode layouts share (efta_attention_cluster.cuh,
// efta_attention_tile.cuh, efta_paged_tile.cuh, efta_paged_decode.cuh):
// branch-free division, NaN-propagating min / max, TF32 mma.sync and bf16
// splits, the cluster's rank, barrier and distributed shared memory, wgmma
// on 8 x 8 core-matrix tiles, mbarriers, the consumer warps' named barrier
// and the producer warpgroup's setmaxnreg. Header-only, internal linkage,
// after efta_common.cuh.
#pragma once

#include "efta_common.cuh"

namespace {

// a producer warpgroup's threads and their registers a thread, and the
// consumers' registers a thread: 4 x 128 x 112 + 128 x 32 = 640 x 96, the
// registers a CTA of 16 consumer warps launches with (setmaxnreg.inc takes
// only what .dec gave back)
constexpr int PRODUCER_THREADS = 128, PRODUCER_REGS = 32, CONSUMER_REGS = 112;

// x / d and x % d (0 <= x < 2^22, 1 <= d <= 1024) without a branch: the
// high word of x * ceil(2^32 / d), exact in that range (and x for d = 1);
// a predicated division path costs issue slots in every inner loop
struct FDiv {
  unsigned d, m, one;
  __device__ explicit FDiv(int d_)
      : d((unsigned)d_),
        m(d_ > 1 ? (unsigned)(((1ull << 32) + d_ - 1) / d_) : 0u),
        one(d_ == 1 ? 0xffffffffu : 0u) {}
  __device__ __forceinline__ int q(int x) const {
    return (int)(__umulhi((unsigned)x, m) + ((unsigned)x & one));
  }
  __device__ __forceinline__ int r(int x) const { return x - q(x) * (int)d; }
};

// the consumer warps' barrier (a producer warpgroup takes no part)
__device__ __forceinline__ void consumer_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// nan_max and nan_min (NaN in, canonical NaN out) as one instruction each
__device__ __forceinline__ float fmax_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;\n" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float min_cap(float x, float cap) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;\n" : "=f"(d) : "f"(x), "f"(cap));
  return d;
}

// D (16x8 f32) += A (16x8 tf32, row) * B (8x8 tf32, col). Fragments, with
// g = lane / 4 and t = lane % 4: a = {(g, t), (g+8, t), (g, t+4), (g+8,
// t+4)}; b = {(k t, n g), (k t+4, n g)}; d as mma_bf16's.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// x rounded to tf32 (nearest, ties away), as its f32 bits
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// bf16 pair (x - bf16(x), y - bf16(y)): the low parts of a split x = hi +
// lo, hi = pack_bf16(x, y)
__device__ __forceinline__ uint32_t pack_bf16_lo(float x, float y,
                                                 uint32_t hi) {
  const float hx = __uint_as_float(hi << 16);
  const float hy = __uint_as_float(hi & 0xffff0000u);
  return pack_bf16(x - hx, y - hy);
}

// ---- thread block clusters: rank, barrier, distributed shared memory ----
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// every thread of every CTA of the cluster arrives; shared-memory writes
// before it are visible to every CTA after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}
// the generic address of the same shared-memory location as `p` in CTA
// `rank`: plain loads read it, and the compiler may batch them between two
// cluster barriers
template <typename X>
__device__ __forceinline__ const X* at_rank(const X* p, unsigned rank) {
  uint64_t a;
  asm("mapa.u64 %0, %1, %2;\n" : "=l"(a) : "l"(p), "r"(rank));
  return reinterpret_cast<const X*>(a);
}
// the same address to store through: a store reaches CTA `rank`'s shared
// memory without waiting on it, and is visible there after the next
// cluster barrier
template <typename X>
__device__ __forceinline__ X* to_rank(X* p, unsigned rank) {
  uint64_t a;
  asm("mapa.u64 %0, %1, %2;\n" : "=l"(a) : "l"(p), "r"(rank));
  return reinterpret_cast<X*>(a);
}

// ---- bf16 tiles, wgmma, mbarriers ----
// element (r, c) of a bf16 tile of D columns in shared memory (the ring's
// chunks, Q): 8 x 8 core matrices, [r / 8][c / 8][r % 8][c % 8], each 128
// contiguous bytes. ldmatrix reads a core matrix without bank conflicts,
// and it is wgmma's layout without swizzle: a K or V chunk is the K-major
// B of GEMM I and the N-major (transposed) B of GEMM II as it stands.
__device__ __forceinline__ int cm(int r, int c, int D) {
  return (r >> 3) * 8 * D + (c >> 3) * 64 + (r & 7) * 8 + (c & 7);
}
// wgmma's shared-memory matrix descriptor without swizzle: the start
// address, the byte offsets between neighbouring core matrices along K
// (lbo) and along M or N (sbo), each in 16-byte units
__device__ __forceinline__ uint64_t wg_desc(const void* p, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((smem_addr(p) >> 4) & 0x3fff) |
         ((uint64_t)((lbo >> 4) & 0x3fff) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3fff) << 32);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit_wait() {
  asm volatile(
      "wgmma.commit_group.sync.aligned;\n"
      "wgmma.wait_group.sync.aligned 0;\n" ::
          : "memory");
}
// keeps the compiler from moving accesses to wgmma's accumulators across
// the asynchronous product
__device__ __forceinline__ void reg_fence(float* d, int k) {
#pragma unroll
  for (int i = 0; i < k; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// shared-memory writes of the generic proxy (st.shared, cp.async) made
// visible to wgmma's reads (the async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// a wgmma shape as a value, for generic lambdas over the shapes
template <int N>
struct IC {
  static constexpr int value = N;
};
// D (64 x N, f32) += A (64 x 16, bf16, K-major, descriptor a) * B (16 x N,
// K-major, descriptor b), for the warpgroup; d: N / 2 floats a thread, the
// layout of mma_bf16's d for each 8 columns, warp i of the group on rows
// 16 i ..
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b);
// the same with A from registers (each warp its 16 rows, mma_bf16's a) and
// B N-major (transposed)
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t b);
template <>
__device__ __forceinline__ void wgmma_ss<8>(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_ss<16>(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_ss<32>(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<8>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<24>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, %16, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void mbar_init(uint64_t* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(b)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(b))
               : "memory");
}
// the arrive-on of `b` once every cp.async this thread issued has landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* b) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(smem_addr(b))
               : "memory");
}
// until the phase of `b` of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* b, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(b)), "r"(parity)
        : "memory");
  } while (!done);
}


// the producer warpgroup gives registers back, and the consumer
// warpgroups take them (setmaxnreg moves them a warpgroup at a time)
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
}

}  // namespace
