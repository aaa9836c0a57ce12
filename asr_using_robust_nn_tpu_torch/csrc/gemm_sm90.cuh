// The Hopper GEMM main loop shared by the fused training kernels
// (fused_epoch.cu, fused_step.cu), the helpers their epilogues are written
// with, and the dW + Adam kernel body both files instantiate.
//
// The shared-memory ring (ring_loop) also carries K4's int8 operands
// (int8_dft_power_mel.cu) and K5's bf16 ones (dft_power_mel_x3.cu, with the
// 128-wide products below, one of them with A from registers).
//
// Main loop: one warpgroup (128 threads) computes a 64 x 64 fp32 tile as a
// sum over 64-deep bf16 operand tiles. The tiles travel through a ring of
// kStages shared-memory stages filled by 16-byte cp.async copies (every
// thread copies four chunks of each operand a stage; up to kStages - 1 tiles
// are in flight while one is multiplied) and are multiplied by
// wgmma.mma_async m64n64k16 with both operands read from shared memory in
// the 128-byte swizzled layout; the sum stays in 32 registers a thread and
// the epilogues work from those registers.
//
// Operand layouts. A tile is 64 rows of 128 bytes; the 16-byte chunk c of row
// r sits at r * 128 + ((c ^ (r & 7)) << 4) (the 128-byte swizzle: 8-row
// groups of 1024 bytes). For an operand whose depth (K) is contiguous in
// memory the rows are its M or N index and a row holds 64 depth entries
// ("K-major": the k16 step advances the descriptor by 32 bytes inside the
// row). For an operand whose M or N index is contiguous in memory (stored
// (K, ld)) the rows are depth entries and a row holds the 64 M or N entries
// ("MN-major", wgmma's transpose bit: the k16 step advances the descriptor
// by two 8-row groups). So the three products of a training step (X.W,
// dZ.W^T, X^T.dZ) read their operands as they lie in memory; nothing is
// transposed on the way. Every 64-wide operand is one swizzle atom across, so
// both descriptor strides are the 1024-byte group stride.
//
// Cluster helpers: cluster barriers (arrive.release / wait.acquire) and loads
// from another block's shared memory (mapa + ld.shared::cluster), with which
// the epilogues add per-block partials in rank order.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "adam_common.cuh"

namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;             // tile rows, columns and depth
constexpr int kThreads = 128;         // one warpgroup
constexpr int kStages = 4;            // ring depth
constexpr int kTileBytes = 64 * 128;  // one operand tile of one stage
constexpr int kRingBytes = 2 * kStages * kTileBytes;
constexpr int kAlign = 1024;          // swizzle atoms start on 1024 bytes
constexpr int kPartStride = 68;       // fp32 row stride of a shared 64x64 tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory of a block, rounded up to the swizzle alignment.
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + ((kAlign - (a & (kAlign - 1))) & (kAlign - 1));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// One 64 x 64 bf16 operand tile into shared memory. ROWS_ARE_K: the operand
// is stored (K, ld) and tile row r is depth k0 + r, holding entries r0 ..
// r0 + 63; else it is stored (R, ld) and tile row r is entry r0 + r, holding
// depths k0 .. k0 + 63.
template <bool ROWS_ARE_K>
__device__ __forceinline__ void load_tile(uint32_t tile, const bf16* g, int ld,
                                          int r0, int k0) {
#pragma unroll
  for (int e = threadIdx.x; e < 512; e += kThreads) {
    const int row = e >> 3, ch = e & 7;
    const bf16* src =
        ROWS_ARE_K ? g + static_cast<int64_t>(k0 + row) * ld + r0 + ch * 8
                   : g + static_cast<int64_t>(r0 + row) * ld + k0 + ch * 8;
    cp_async16(tile + row * 128 + ((ch ^ (row & 7)) << 4), src);
  }
}

// Shared-memory matrix descriptor, 128-byte swizzle, both strides 1024 bytes.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFFu) >> 4);
  d |= static_cast<uint64_t>(1024 >> 4) << 16;  // leading byte offset
  d |= static_cast<uint64_t>(1024 >> 4) << 32;  // stride byte offset
  d |= static_cast<uint64_t>(1) << 62;          // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// d (64 x 64 fp32, 32 registers a thread) += A (64 x 16) . B (16 x 64), bf16
// operands from shared memory; TA / TB: the operand is MN-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d (64 x 128 fp32, 64 registers a thread) = A (64 x 16) . B (16 x 128) + d
// if scale_d, else without d, bf16 operands from shared memory, both K-major.
// Register j = nb * 4 + h * 2 + q of d is row frag_row() + 8 h, column nb * 8
// + frag_col() + q, as in the 64-wide form. Starting a sum with scale_d = 0
// instead of zeroing d keeps d defined by wgmma alone, so that products left
// in flight across loop iterations are not serialized by ptxas.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db,
                                                 int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53,"
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
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

// d += A . B with A from registers: a[0..3] is the thread's share of a 64 x 16
// bf16 tile in the layout of an fp32 accumulator's 16 columns (a[0]: row
// frag_row(), columns frag_col() and + 1, the lower column in the low half;
// a[1]: row + 8; a[2], a[3]: the same rows, columns + 8). So registers 8 t ..
// 8 t + 7 of a 64-column accumulator, rounded and packed in pairs, are the A
// operand of its columns 16 t .. 16 t + 15.
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53,"
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The ring: S stages of shared memory that steps 0 .. n - 1 pass through in
// turn. fill(k) starts the cp.async copies of step k into stage k % S;
// consume(k) uses them once they have landed. Up to S - 1 steps are in
// flight while one is consumed; a stage is refilled only after every thread
// of the block has passed the barrier that follows its consumption. Writes
// to shared memory that fill(k) makes with plain stores are fenced for the
// async proxy (wgmma) with the copies. All threads of the block call it; on
// return no copy is pending.
template <int S, class Fill, class Consume>
__device__ __forceinline__ void ring_loop(int n, Fill&& fill,
                                          Consume&& consume) {
  static_assert(S >= 2, "a ring has two stages or more");
  for (int s = 0; s < S - 1; ++s) {
    if (s < n) fill(s);
    cp_commit();
  }
  for (int k = 0; k < n; ++k) {
    cp_wait<S - 2>();  // this thread's copies of step k have landed
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();  // ... everyone's; and step k - 1 has been consumed
    if (k + S - 1 < n) fill(k + S - 1);
    cp_commit();
    consume(k);
  }
  cp_wait<0>();
}

// acc = sum over nk depth tiles from kbeg of A-tile . B-tile for the output
// tile at (m0, n0). AT: A is stored (K, lda), else (M, lda). BT: B is stored
// (N, ldb), else (K, ldb). `ring` is kRingBytes of 1024-aligned shared
// memory. All 128 threads call it; on return every wgmma has completed and
// the ring is free.
template <bool AT, bool BT>
__device__ __forceinline__ void mainloop(float (&acc)[32], const bf16* A,
                                         int lda, const bf16* B, int ldb,
                                         int m0, int n0, int kbeg, int nk,
                                         uint32_t ring) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  auto fill = [&](int kt) {
    const uint32_t a = ring + (kt % kStages) * 2 * kTileBytes;
    load_tile<AT>(a, A, lda, m0, kbeg + kt * kTile);
    load_tile<!BT>(a + kTileBytes, B, ldb, n0, kbeg + kt * kTile);
  };
  auto consume = [&](int kt) {
    const uint32_t a = ring + (kt % kStages) * 2 * kTileBytes;
    const uint32_t b = a + kTileBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint64_t da = make_desc(a + (AT ? kk * 2048 : kk * 32));
      const uint64_t db = make_desc(b + (!BT ? kk * 2048 : kk * 32));
      wgmma_m64n64k16<AT ? 1 : 0, BT ? 0 : 1>(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait0();
  };
  ring_loop<kStages>(nk, fill, consume);
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(acc[i]) :: "memory");
  __syncthreads();
}

// Where a thread's accumulators sit in the 64 x 64 tile: register j = nb * 4
// + h * 2 + q is row frag_row() + 8 h, column nb * 8 + frag_col() + q.
__device__ __forceinline__ int frag_row() {
  return (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);
}
__device__ __forceinline__ int frag_col() { return (threadIdx.x & 3) * 2; }

// NS column sums over the block's 64 rows at once. v[s][nb * 2 + q] is the
// thread's partial (its two rows) of sum s of column nb * 8 + frag_col() + q.
// Leaves the sums in out[s * 64 + column] (shared); `wp` is NS * 256 floats
// of shared scratch. The order is fixed: eight lanes by shuffles, then the
// four warps in order. The caller synchronizes before `out` is read.
template <int NS>
__device__ __forceinline__ void block_colsum(float (&v)[NS][16], float* wp,
                                             float* out) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        v[s][i] += __shfl_xor_sync(0xffffffffu, v[s][i], o);
      }
    }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // wp may still be read from the previous call
  if (lane < 4) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        wp[s * 256 + warp * 64 + (i >> 1) * 8 + lane * 2 + (i & 1)] = v[s][i];
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < NS * 64; e += kThreads) {
    const float* w = wp + (e >> 6) * 256 + (e & 63);
    out[e] = ((w[0] + w[64]) + w[128]) + w[192];
  }
}

// -- thread-block cluster ----------------------------------------------------

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return static_cast<int>(r);
}
__device__ __forceinline__ int cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return static_cast<int>(r);
}
// `p` (in this block's shared memory) as it lies in block `rank`
__device__ __forceinline__ uint32_t remote_u32(const void* p, int rank) {
  uint32_t r;
  asm("mapa.shared::cluster.u32 %0, %1, %2;"
      : "=r"(r) : "r"(smem_u32(p)), "r"(rank));
  return r;
}
// Volatile, so that a load stays behind the cluster barrier it follows, but
// without a memory clobber, so that several loads can be in flight.
__device__ __forceinline__ float ld_remote(const float* p, int rank) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];"
               : "=f"(v) : "r"(remote_u32(p, rank)));
  return v;
}
__device__ __forceinline__ float4 ld_remote4(const float* p, int rank) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote_u32(p, rank)));
  return v;
}
constexpr int kMaxCluster = 8;  // the portable cluster size

// Entry p of every block's shared memory, added in rank order: every block
// of the cluster gets the same bits. The loads are issued together (each
// takes a trip through the cluster's network) and then added in order.
__device__ __forceinline__ float cluster_ordered_sum(const float* p, int n) {
  float v[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) v[r] = r < n ? ld_remote(p, r) : 0.f;
  float total = 0.f;
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) {
    if (r < n) total += v[r];
  }
  return total;
}

// -- dW + Adam -----------------------------------------------------------------
//
// dW (M, N) = X^T . dZ with X stored (K, M) and dZ (K, N), fused with Adam on
// the fp32 master and moments, the NonNeg clamp and the bf16 copy. Grid
// (N / 64, M / 64, split) with clusters of (1, 1, split) blocks: the blocks
// of a cluster share one 64 x 64 tile of dW and each sums K / split of the
// depth; the partial tiles (written over the ring, which is free by then)
// meet through distributed shared memory, where rank r adds the `split`
// partials of its 64 / split rows of the tile in rank order and runs Adam on
// exactly those rows. So every weight is updated once, by one block, with one
// fixed summation order, in one launch, and a narrow layer (a 128 x 128 one
// is four tiles) still puts 8 blocks on each tile.
//
// The block's rows of the master and both moments start their way to shared
// memory (cp.async) before the main loop and are read from there in the
// epilogue, so the 12 bytes of state a weight travel while the tile is
// multiplied. `scales` (null, or the per-layer factors of the deferred
// simple_norm rescale) multiplies the master at its load.

struct DwArgs {
  const bf16* x;
  const bf16* dz;
  float* master;
  float* mw;
  float* vw;
  bf16* w16;
  int M, N, K;
  const int* count;
  int step;
  const float* scales;
  int layer;
  AdamArgs adam;
  int nonneg;
};

constexpr int kDwSmemBytes = kAlign + kRingBytes + 3 * kTile * kTile * 4;
static_assert(kTile * kPartStride * 4 <= kRingBytes,
              "the partial dW tile reuses the ring");

// One weight's update from its gradient g: the master as loaded times the
// deferred factor s_prev, Adam, NonNeg. Every dW + Adam kernel (this body,
// fused_epoch.cu's grouped one) updates through it. Each operation's
// rounding is spelled out, as the compiler contracted adam_step's
// expressions in fe_dw_adam, so that the same inputs give the same bits in
// whatever code it is inlined into (left to the compiler, the grouped
// kernel's m' came out as fma(b1, m, omb1 * g), one ulp off a third of the
// time).
__device__ __forceinline__ void dw_adam_update(float& p, float& m, float& v,
                                               float g, float s_prev,
                                               float bc1, float bc2,
                                               const AdamArgs& a,
                                               int nonneg) {
  const float mn = __fmaf_rn(g, a.omb1, __fmul_rn(a.b1, m));
  const float vn = __fmaf_rn(__fmul_rn(a.omb2, g), g, __fmul_rn(a.b2, v));
  const float upd = __fdiv_rn(
      __fdiv_rn(mn, bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(vn, bc2)), a.eps));
  p = __fmaf_rn(-upd, a.lr, __fmul_rn(p, s_prev));
  if (nonneg) p = fmaxf(p, 0.f);
  m = mn;
  v = vn;
}

__device__ __forceinline__ void dw_adam_body(const DwArgs& a,
                                             unsigned char* smem_raw) {
  unsigned char* smem = aligned_smem(smem_raw);
  // the partial tile takes the ring's place once the main loop is done
  float* part = reinterpret_cast<float*>(smem);
  float* st = reinterpret_cast<float*>(smem + kRingBytes);  // [3][own][64]
  const int tid = threadIdx.x;
  const int split = cluster_size(), rank = cluster_rank();
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int own = kTile / split, own0 = rank * own;
  float* const state[3] = {a.master, a.mw, a.vw};

  for (int u = tid; u < own * 16; u += kThreads) {
    const int lr = u >> 4, c4 = u & 15;
    const int64_t g = static_cast<int64_t>(m0 + own0 + lr) * a.N + n0 + c4 * 4;
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      cp_async16(smem_u32(st + (t * own + lr) * kTile + c4 * 4), state[t] + g);
    }
  }
  cp_commit();  // the oldest group: the main loop's first wait covers it

  float acc[32];
  const int kper = a.K / split;
  mainloop<true, false>(acc, a.x, a.M, a.dz, a.N, m0, n0, rank * kper,
                        kper / kTile, smem_u32(smem));

  const int r0 = frag_row(), c0 = frag_col();
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<float2*>(
          &part[(r0 + 8 * h) * kPartStride + nb * 8 + c0]) =
          make_float2(acc[nb * 4 + h * 2], acc[nb * 4 + h * 2 + 1]);
    }
  }
  cluster_sync();  // every rank's partial tile is in its shared memory

  float bc1, bc2;
  bias_corrections(a.count, a.step, a.adam, bc1, bc2);
  const float s_prev = a.scales != nullptr ? a.scales[a.layer] : 1.f;
  for (int u = tid; u < own * 16; u += kThreads) {
    const int lr = u >> 4, c4 = u & 15;
    const float* src = part + (own0 + lr) * kPartStride + c4 * 4;
    float4 pr[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      pr[r] = r < split ? ld_remote4(src, r) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float g[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < split) {
        g[0] += pr[r].x, g[1] += pr[r].y, g[2] += pr[r].z, g[3] += pr[r].w;
      }
    }
    const int64_t gi =
        static_cast<int64_t>(m0 + own0 + lr) * a.N + n0 + c4 * 4;
    float4 sv[3];
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      sv[t] = *reinterpret_cast<const float4*>(st + (t * own + lr) * kTile +
                                               c4 * 4);
    }
    float p[4] = {sv[0].x, sv[0].y, sv[0].z, sv[0].w};
    float mm[4] = {sv[1].x, sv[1].y, sv[1].z, sv[1].w};
    float vv[4] = {sv[2].x, sv[2].y, sv[2].z, sv[2].w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      dw_adam_update(p[q], mm[q], vv[q], g[q], s_prev, bc1, bc2, a.adam,
                     a.nonneg);
    }
    *reinterpret_cast<float4*>(a.master + gi) =
        make_float4(p[0], p[1], p[2], p[3]);
    *reinterpret_cast<float4*>(a.mw + gi) =
        make_float4(mm[0], mm[1], mm[2], mm[3]);
    *reinterpret_cast<float4*>(a.vw + gi) =
        make_float4(vv[0], vv[1], vv[2], vv[3]);
    __nv_bfloat162 lo = __floats2bfloat162_rn(p[0], p[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(p[2], p[3]);
    uint2 packed;
    packed.x = *reinterpret_cast<uint32_t*>(&lo);
    packed.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(a.w16 + gi) = packed;
  }
  cluster_sync();  // no block leaves while another still reads its tile
}

// One launch as the host's plan states it (ops/cuda_train.py::launch_plan):
// seven ints, grid x y z, cluster x y z, dynamic shared-memory bytes. The
// entries launch with these and refuse a plan that does not cover their
// matrices or gives the kernel less shared memory than it addresses.
struct LaunchDims {
  dim3 grid, cluster;
  int smem;
};

// False if `d` cannot be a launch of a cluster kernel at all.
inline bool read_dims(const int* d, LaunchDims* out) {
  for (int k = 0; k < 6; ++k) {
    if (d[k] < 1) return false;
  }
  if (d[6] < 0 || d[0] % d[3] || d[1] % d[4] || d[2] % d[5] ||
      d[3] * d[4] * d[5] > kMaxCluster) {
    return false;
  }
  out->grid = dim3(d[0], d[1], d[2]);
  out->cluster = dim3(d[3], d[4], d[5]);
  out->smem = d[6];
  return true;
}

// True if the (gx, gy) blocks of `d` are the 64 x 64 tiles of an (M, N)
// matrix, each once.
inline bool covers_tiles(const LaunchDims& d, int M, int N) {
  return M > 0 && N > 0 && d.grid.x * kTile == static_cast<unsigned>(N) &&
         d.grid.y * kTile == static_cast<unsigned>(M);
}

// True if `d` launches dw_adam_body on an (M, N) kernel over the depth K: the
// tiles of the kernel, each on a cluster of grid.z blocks along the depth
// (1, 2, 4 or 8, so a rank's 64 / grid.z rows are whole), every block a
// whole number of 64-deep slices, with the ring and the state tiles.
inline bool dw_dims_ok(const LaunchDims& d, int M, int N, int K) {
  const unsigned split = d.grid.z;
  return covers_tiles(d, M, N) && d.cluster.x == 1 && d.cluster.y == 1 &&
         d.cluster.z == split && (split & (split - 1)) == 0 && K > 0 &&
         K % (split * kTile) == 0 && d.smem >= kDwSmemBytes;
}

// Launch of a kernel of 128 threads as `d` states it.
template <class... KArgs, class... Args>
cudaError_t launch_cluster(void (*kern)(KArgs...), const LaunchDims& d,
                           void* stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = d.grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = d.smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  const dim3 cluster = d.cluster;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster.x;
  attr.val.clusterDim.y = cluster.y;
  attr.val.clusterDim.z = cluster.z;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, KArgs(args)...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Opt in to `smem` bytes of dynamic shared memory and report how many
// clusters of `cluster` blocks of `kern` the device can hold at once.
template <class... KArgs>
cudaError_t prepare_kernel(void (*kern)(KArgs...), int smem, dim3 cluster,
                           int* max_clusters) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = cluster;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster.x;
  attr.val.clusterDim.y = cluster.y;
  attr.val.clusterDim.z = cluster.z;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
  if (err != cudaSuccess) return err;
  if (n < *max_clusters) *max_clusters = n;
  return cudaSuccess;
}

}  // namespace sm90
