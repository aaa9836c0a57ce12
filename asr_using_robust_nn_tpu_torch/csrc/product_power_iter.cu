// K2 on Hopper: power iteration for sigma = ||W_m^T ... W_1^T||_2, the whole
// iteration in one launch on one thread-block cluster.
//
// Replaces asr_using_robust_nn_tpu/ops/pallas_spectral.py::_pi_kernel (the
// Pallas TPU kernel behind product_spectral_norm_pallas) and the projection
// phase of ops/pallas_train.py::_make_epoch_kernel. Semantics, as there:
// the kernels are cast once (bf16 or fp32), every sum is in fp32, nrm(x) =
// x / (||x|| + eps), and
//   u = nrm(u0); repeat n_iter: v = nrm(P^T u), u = nrm(P v);
//   v = nrm(P^T u); sigma = u . (P v); return (sigma, u)
// with P^T x = W_1 ... W_m x and P x = W_m^T ... W_1^T x. With rho > 0 the
// simple_norm factors f_i = exp(log(rho / (s_i + eps)) / m), s_{i+1} = s_i
// f_i, s_0 = sigma, then rescale the bf16 kernels and their fp32 masters.
//
// What bounds it on an H100: latency. Run as written, the iteration is a
// chain of 2*m*(n_iter+1) dependent matvecs (204 at the digit recipe, n_iter
// 16); one pass over the 3.2 MB of bf16 weights is 2 us of HBM time.
//
// The widths run at are the true ones (`dims`); the buffers may be wider
// (K3's and K6's are padded to 128: row stride `ld`, `numel` elements) and
// their padding is zero, so it adds nothing to P. u_out[dims[m]:u_len] is
// written with zeros. The rescale covers the whole buffers.
//
// Two forms of one algorithm, chosen on the host from the widths alone
// (ops/cuda_spectral.py::pi_plan), never from n_iter:
//
// THE PRODUCT (GRAM) FORM, where d_m <= 32 and two fp32 copies of R_j (below)
// fit a block's shared memory: every preset. The carried u lives in R^{d_m},
// and one round u <- nrm(P nrm(P^T u)) is u <- nrm(G u) with G = P P^T =
// Q^T Q, Q = W_1 ... W_m (d_0 x d_m): the same iteration, apart from the eps
// inside the inner nrm (a 1e-16 relative change). So:
//  1. Q from the narrow end: R_m = W_m (every block loads it whole), R_j =
//     W_j R_{j+1}: m - 1 dependent multi-vector links. Block c owns rows
//     [c per_j, (c+1) per_j) of W_j, as in the chain form, reads them once
//     from global memory (L2, 16 bytes a lane where the widths allow),
//     forms its rows of R_j (fp32) in its own copy and sends them to every
//     other block's copy as one bulk message each: one exchange a link. R_1
//     = Q stays with the owners of its rows. A lane takes two rows; the
//     warps split the depth K into `gram_splits` runs of ks consecutive k,
//     each summed in order with one fmaf a term, and the runs' sums are
//     added in run order. All lanes of a warp read the same row of R, so a
//     read of R is a broadcast (with a lane a column of R instead, each lane
//     read its own row and a link took no less time).
//  2. G = Q^T Q: each block sums its own rows of Q (one fmaf a row, rows in
//     order) and one exchange carries the d_m^2 partials to every block (a
//     bulk message each); all add them in rank order, so all hold the same
//     bits.
//  3. u = nrm(u0), n_iter rounds of u = nrm(G u), then q = u^T G u and
//     sigma = q / (sqrt(q) + eps): in one warp of every block, lane i holding
//     row i of G in registers, every sum a sequential fmaf chain in index
//     order.
// m - 1 exchanges (5 at the digit recipe) instead of 2 m (n_iter + 1) +
// n_iter + 1 (221), and d_m passes over the weights instead of 2 (n_iter +
// 1). Every product and sum is an explicit fmaf or add in a fixed order, so
// the plain twin ops/cuda_spectral.py::product_spectral_norm_gram gives the
// same bits. On an H100 (700 W; 33 or 129 launches captured in a graph, in
// K3's padded buffers, rescale included) a launch takes 0.059 ms at the
// digit recipe and 0.095 at the speaker recipe, against the chain form's
// 0.393 and 0.612: of the speaker launch ~55 % the links (the first, 2020 x
// 1024 x 20, ~26 %), ~32 % the rescale, ~6 % the 16 rounds. Shared memory
// bounds the links: a 16-byte read of R costs a warp 4 cycles and serves 8
// sums; 4 rows a lane would halve that, but spill at 128 registers.
//
// THE CHAIN FORM, for any other shape (a wide last layer, an 8192-wide
// layer whose R copy would not fit): the iteration as written, the vector
// rounded to bf16 before every link (bf16 mode). Its links are separated by
// exchanges through distributed shared memory instead of launches, and the
// weights stay in the cluster's shared memory where they fit.
//  * One cluster of C blocks (the wrapper launches 16, which needs the
//    non-portable cluster size), 512 threads each. Every vector
//    dimension d_i is cut into C contiguous slices of per_i = ceil(d_i / C)
//    rounded up to a multiple of 4 entries; block c owns rows [c per_i,
//    (c+1) per_i) of W_i (d_i x d_{i+1}) for BOTH directions, so one
//    resident copy of its rows serves every link.
//  * A P^T link (y = W_i x) is row dots against the block's full copy of x:
//    a warp takes up to four owned rows at a time (one read of x, four
//    independent sums) and sends its y values, already rounded, into every
//    block's copy of the vector. A P link (y = W_i^T x) needs only the
//    block's own slice of x: it forms its partial of every output column
//    from its rows and sends each column segment's partial into the inbox
//    of the block that owns that slice of d_{i+1}; the owner adds the C
//    partials in rank order, which leaves it exactly the slice the next P
//    link reads. So every link costs one exchange; a norm costs one more:
//    each block sends its partial sum of squares to all, and all add the C
//    partials in rank order, so all hold the same bits. 2m + 1 exchanges a
//    round, 221 for the digit recipe.
//  * Where a layer's width and its owner slices are multiples of 4, weights
//    move as 8-byte (bf16) or 16-byte (fp32) words and vector entries as
//    16-byte words, locally and between blocks; any other width takes the
//    one-entry path.
//  * Residency is decided per layer on the host (pi_plan) from the widths:
//    a layer whose widest slice still fits beside the vectors in the block's
//    227 KB stays in shared memory for all passes; any other layer is read
//    from global memory (L2) on every pass. Widths up to 8192.
//  * A round of 13 exchanges took ~22 us at the digit recipe (0.37 ms a
//    launch at n_iter 16), ~1.7 us a link: what the product form removes.
//  * Every multiply-add is an explicit fmaf, so the plain twin ops/
//    cuda_spectral.py::product_spectral_norm_partitioned, which takes every
//    sum in the same order (lanes, the xor trees, block_sum, ranks), gives
//    the same bits.
//
// Both forms:
//  * An exchange is st.async stores counted by a transaction barrier in the
//    receiving block (see `Exchange` below), not a cluster barrier: a
//    cluster.sync() after remote stores makes all 512 threads of all blocks
//    meet, a transaction barrier only makes a block wait for its own data.
//    On an H100 the digit chain took 0.417 ms with cluster barriers and
//    0.369 ms with these exchanges (chip_smoke.py's launch time).
//  * The finish (the factors) and the rescale of kernels and masters run in
//    the same launch after the last exchange, spread over the cluster's
//    threads (19 MB of traffic at the digit recipe).
//  * No atomics on data, fixed partition, fixed summation orders: two
//    launches on the same inputs give the same bits, so CUDA-graph replays
//    stay reproducible.
//  * It is an ordinary kernel node (cudaLaunchKernelEx with a cluster
//    dimension), so it is captured into the fused epoch's and the fused
//    step's graphs. Attributes (227 KB of dynamic shared memory, the
//    non-portable cluster size) are set in asr_pi_preload, before a capture.
// No block leaves while another may still send into its shared memory: in
// the last exchange every block waits for every block's token and data, and
// nothing is sent after it.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLayers = 16;
constexpr int kMaxDim = 8192;
constexpr int kMaxCluster = 16;
constexpr int kSmemMax = 232448;  // shared memory one block may use
constexpr int kMaxDevices = 64;

struct PiArgs {
  const void* w[kMaxLayers];
  float* master[kMaxLayers];
  int64_t numel[kMaxLayers];  // elements of buffer i: what the rescale covers
  int ld[kMaxLayers];         // row stride of buffer i (>= dims[i + 1])
  int dims[kMaxLayers + 1];
  int per[kMaxLayers + 1];    // slice length of dimension i per block
  int res_off[kMaxLayers];    // byte offset of the resident slice, -1: global
  int vec[kMaxLayers];        // chain: rows may be read four entries at a
                              // time; product form: 16 bytes at a time
  int m, n_iter, cluster, u_len, gram;
  int dmax_e, dm_e, segmax;   // chain: max dims and dims[m] rounded up to 4;
                              // max(per)
  int rrows;                  // product form: rows of each copy of R
  float eps, rho, inv_m;
  const float* u_in;
  float* u_out;
  float* sigma;
};

constexpr int kPartFloats = 4 * kThreads;  // P-link partials of the row groups
constexpr int kPlanFloats = 80;            // barriers; per-dimension lo, hi,
                                           // ranks, 1/per
constexpr int kGramCols = 32;              // the product form's widest d_m

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// floats of shared memory ahead of the resident slices
__host__ __device__ inline int vector_floats(int dmax_e, int dm_e, int segmax,
                                             int cluster) {
  return 2 * dmax_e + dm_e + segmax + 2 * cluster * segmax + 4 * cluster +
         kPartFloats + 32 + kPlanFloats;
}

// floats of shared memory of the product form: two copies of R, the Gram's
// partials from every block, the Gram, u, the exchange's tokens, the
// reduction scratch and the plan
__host__ __device__ inline int gram_floats(int rrows, int dm, int cluster) {
  return 2 * rrows * round4(dm) + (cluster + 1) * round4(dm * dm) +
         round4(dm) + round4(cluster) + 32 + kPlanFloats;
}

// VW consecutive weights as floats in one load of VW x sizeof(T) bytes.
template <typename T, int VW>
struct Load;
template <>
struct Load<bf16, 4> {
  static __device__ __forceinline__ void at(const bf16* p, float* v) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
  }
};
template <>
struct Load<bf16, 8> {
  static __device__ __forceinline__ void at(const bf16* p, float* v) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = __bfloat1622float2(h[q]);
      v[2 * q] = f.x, v[2 * q + 1] = f.y;
    }
  }
};
template <>
struct Load<float, 4> {
  static __device__ __forceinline__ void at(const float* p, float* v) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  }
};
template <>
struct Load<bf16, 1> {
  static __device__ __forceinline__ void at(const bf16* p, float* v) {
    v[0] = __bfloat162float(*p);
  }
};
template <>
struct Load<float, 1> {
  static __device__ __forceinline__ void at(const float* p, float* v) {
    v[0] = *p;
  }
};

template <typename T>
__device__ __forceinline__ float cast_link(float x) {
  return x;
}
template <>
__device__ __forceinline__ float cast_link<bf16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// -- the exchange between blocks --------------------------------------------
// Data moves between blocks by st.async: a store into another block's shared
// memory that, on arrival, counts its bytes down on a transaction barrier
// (mbarrier) in that block. A block posts the bytes it expects for an
// exchange, does its own sends, and waits on its own barrier; there is no
// cluster-wide barrier and no fence. Every block also sends every block a
// 4-byte token when it enters an exchange, so a block finishes exchange e
// only after all blocks have finished e - 1: no block runs more than one
// exchange ahead of another, also not of one that expects no data. That is
// what lets two barriers (and two copies of each receive buffer) alternate,
// exchange by exchange.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the address of `p` (in this block's shared memory) in block `rank`
__device__ __forceinline__ uint32_t remote_u32(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(smem_u32(p)), "r"(rank));
  return r;
}

__device__ __forceinline__ void send1(float* dst, uint64_t* bar, int rank,
                                      float v) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
      :: "r"(remote_u32(dst, rank)), "r"(__float_as_uint(v)),
         "r"(remote_u32(bar, rank)) : "memory");
}

__device__ __forceinline__ void send4(float* dst, uint64_t* bar, int rank,
                                      float a, float b, float c, float d) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];"
      :: "r"(remote_u32(dst, rank)), "r"(__float_as_uint(a)),
         "r"(__float_as_uint(b)), "r"(__float_as_uint(c)),
         "r"(__float_as_uint(d)), "r"(remote_u32(bar, rank)) : "memory");
}

// `bytes` (a multiple of 16) of this block's shared memory at `src` to the
// same offset in block `rank`, counted on its barrier `bar`: one message.
// The writes to `src` must be ordered before it for the async proxy
// (fence.proxy.async.shared::cta in every writing thread, then a barrier).
__device__ __forceinline__ void send_bulk(float* src, int bytes, uint64_t* bar,
                                          int rank) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(remote_u32(src, rank)), "r"(smem_u32(src)), "r"(bytes),
         "r"(remote_u32(bar, rank)) : "memory");
}

// Waits until this thread's bulk sends have read their source.
__device__ __forceinline__ void bulk_sent() {
  asm volatile("cp.async.bulk.commit_group;\n"
               "cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// Orders this thread's writes to shared memory before later bulk sends.
__device__ __forceinline__ void fence_for_bulk() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// One block's side of the exchanges, in order. expect(bytes) is called by
// every thread before the block's sends of an exchange (thread 0 posts the
// data bytes and the tokens it expects; the first `cluster` threads send
// this block's tokens), wait() by every thread after them; wait() ends with
// a block barrier, so no thread is an exchange behind another.
struct Exchange {
  uint64_t* bars;  // [2]
  float* tokens;   // [cluster]
  int cluster, rank;
  int e = 0;
  __device__ __forceinline__ uint64_t* bar() const { return bars + (e & 1); }
  __device__ __forceinline__ void expect(int bytes) const {
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   :: "r"(smem_u32(bar())), "r"(bytes + 4 * cluster)
                   : "memory");
    }
    if (threadIdx.x < cluster) {
      send1(tokens + rank, bar(), threadIdx.x, 0.f);
    }
  }
  __device__ __forceinline__ void wait() {
    const uint32_t addr = smem_u32(bar()), parity = (e >> 1) & 1;
    uint32_t done;
    do {
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    } while (!done);
    ++e;
    __syncthreads();
  }
};

// Sum over the block in a fixed order; every thread gets the total.
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // red may still be read from a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < kWarps ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  return t;
}

// The rows of a P^T link a block owns: y[r] = sum_n w[r, n] * x[n] (rows
// `ld` apart), a warp on RW rows at a time (one load of x serves RW
// independent sums). Calls emit(r0, acc, count) once per row group with
// every lane holding the sums.
template <typename T, int VW, int RW, typename Emit>
__device__ __forceinline__ void pt_rows(const T* w, int ld, const float* x,
                                        int nrows, int len, Emit emit) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r0 = warp * RW; r0 < nrows; r0 += kWarps * RW) {
    float acc[RW];
    const T* wr[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      acc[r] = 0.f;  // rows past the slice repeat its last row, unused
      wr[r] = w + static_cast<int64_t>(min(r0 + r, nrows - 1)) * ld;
    }
#pragma unroll 2
    for (int n = VW * lane; n < len; n += 32 * VW) {
      float xv[VW];
      Load<float, VW>::at(x + n, xv);
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        float wv[VW];
        Load<T, VW>::at(wr[r] + n, wv);
#pragma unroll
        for (int q = 0; q < VW; ++q) acc[r] = fmaf(wv[q], xv[q], acc[r]);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], o);
      }
    }
    emit(r0, acc, min(RW, nrows - r0));
  }
}

template <typename T, int VW, typename Emit>
__device__ __forceinline__ void pt_link(const T* w, int ld, const float* x,
                                        int nrows, int len, Emit emit) {
  if (nrows > 2 * kWarps) {
    pt_rows<T, VW, 4>(w, ld, x, nrows, len, emit);
  } else if (nrows > kWarps) {
    pt_rows<T, VW, 2>(w, ld, x, nrows, len, emit);
  } else {
    pt_rows<T, VW, 1>(w, ld, x, nrows, len, emit);
  }
}

// A block's partials of a P link: for every column n < dout, sum over the
// block's rows k (`ld` apart) of xown[k] * w[k, n], handed VW columns at a
// time to publish(n, values). Column units are spread over the threads;
// when there are fewer units than threads the rows are split over thread
// groups and added in group order.
template <typename T, int VW, typename Publish>
__device__ __forceinline__ void p_link_partials(const T* wrows, int ld,
                                                int nrows, int dout,
                                                const float* xown,
                                                float* part, Publish publish) {
  const int units = dout / VW;
  const int tid = threadIdx.x;
  if (units >= kThreads) {
    for (int p = tid; p < units; p += kThreads) {
      const T* col = wrows + p * VW;
      float acc[VW];
#pragma unroll
      for (int q = 0; q < VW; ++q) acc[q] = 0.f;
#pragma unroll 8
      for (int k = 0; k < nrows; ++k) {
        const float xv = xown[k];
        float wv[VW];
        Load<T, VW>::at(col + static_cast<int64_t>(k) * ld, wv);
#pragma unroll
        for (int q = 0; q < VW; ++q) acc[q] = fmaf(wv[q], xv, acc[q]);
      }
      publish(p * VW, acc);
    }
    return;
  }
  const int groups = min(kThreads / units, nrows);
  const int g = tid / units, p = tid - g * units;
  if (g < groups) {
    const T* col = wrows + p * VW;
    float acc[VW];
#pragma unroll
    for (int q = 0; q < VW; ++q) acc[q] = 0.f;
#pragma unroll 8
    for (int k = g; k < nrows; k += groups) {
      const float xv = xown[k];
      float wv[VW];
      Load<T, VW>::at(col + static_cast<int64_t>(k) * ld, wv);
#pragma unroll
      for (int q = 0; q < VW; ++q) acc[q] = fmaf(wv[q], xv, acc[q]);
    }
#pragma unroll
    for (int q = 0; q < VW; ++q) part[g * dout + p * VW + q] = acc[q];
  }
  __syncthreads();
  for (int u = tid; u < units; u += kThreads) {
    float acc[VW];
#pragma unroll
    for (int q = 0; q < VW; ++q) acc[q] = 0.f;
    for (int t = 0; t < groups; ++t) {
      float pv[VW];
      Load<float, VW>::at(part + t * dout + u * VW, pv);
#pragma unroll
      for (int q = 0; q < VW; ++q) acc[q] += pv[q];
    }
    publish(u * VW, acc);
  }
}

// The block's slice [lo, hi) of every dimension, the ranks that own a slice
// of it, and 1 / per, computed once, and the exchange's two barriers,
// initialized: kPlanFloats floats of shared memory at `head`.
struct Slices {
  uint64_t* bars;  // [2]
  int* lo;
  int* hi;
  int* ranks;
  float* inv;
};

__device__ Slices setup_slices(const PiArgs& a, float* head, int rank) {
  Slices s;
  s.bars = reinterpret_cast<uint64_t*>(head);
  s.lo = reinterpret_cast<int*>(s.bars + 2);
  s.hi = s.lo + kMaxLayers + 1;
  s.ranks = s.hi + kMaxLayers + 1;
  s.inv = reinterpret_cast<float*>(s.ranks + kMaxLayers + 1);
  const int tid = threadIdx.x;
  if (tid <= a.m) {
    s.lo[tid] = min(rank * a.per[tid], a.dims[tid]);
    s.hi[tid] = min((rank + 1) * a.per[tid], a.dims[tid]);
    s.ranks[tid] = (a.dims[tid] + a.per[tid] - 1) / a.per[tid];
    s.inv[tid] = 1.f / static_cast<float>(a.per[tid]);
  }
  if (tid == 0) {
    for (int b = 0; b < 2; ++b) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_u32(s.bars + b)) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return s;
}

// `n` partials of one value per rank, `stride` apart, added in rank order
__device__ __forceinline__ float ordered(const float* p, int stride, int n) {
  float total = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxCluster; ++c) {
    if (c < n) total += p[c * stride];
  }
  return total;
}

// What a form leaves for the finish, the same in every block: sigma, u
// (dims[m] entries of shared memory) and kMaxLayers floats of scratch.
struct Result {
  float sigma;
  const float* u;
  float* scratch;
};

// -- the chain form -----------------------------------------------------------

template <typename T>
__device__ Result chain_form(const PiArgs& a, unsigned char* smem, int rank) {
  const int C = a.cluster;
  const int tid = threadIdx.x, lane = tid % 32;
  const int m = a.m, dm = a.dims[m];

  float* xfull = reinterpret_cast<float*>(smem);  // [2][dmax_e]
  float* ufull = xfull + 2 * a.dmax_e;            // [dm_e] nrm(u), unrounded
  float* xown = ufull + a.dm_e;                   // [segmax]
  float* inbox = xown + a.segmax;                 // [2][C][segmax]
  float* ssq = inbox + 2 * C * a.segmax;          // [3][C], then C tokens
  float* part = ssq + 4 * C;                      // [kPartFloats]
  float* red = part + kPartFloats;                // [32]
  const Slices s = setup_slices(a, red + 32, rank);
  const int* s_lo = s.lo;
  const int* s_hi = s.hi;
  const int* s_ranks = s.ranks;
  Exchange ex{s.bars, ssq + 3 * C, C, rank};

  // the block's rows of layer j and their stride: resident copy (rows
  // dims[j + 1] apart) or global memory (rows ld[j] apart)
  auto rows_of = [&](int j) -> const T* {
    if (a.res_off[j] >= 0) return reinterpret_cast<const T*>(smem + a.res_off[j]);
    return static_cast<const T*>(a.w[j]) +
           static_cast<int64_t>(s_lo[j]) * a.ld[j];
  };
  auto ld_of = [&](int j) -> int {
    return a.res_off[j] >= 0 ? a.dims[j + 1] : a.ld[j];
  };
  // partial p of this block to slot `slot` of every block; then all add the
  // partials of the `n` ranks that own a slice, in rank order
  auto all_sum = [&](float p, int slot, int n) -> float {
    ex.expect(4 * C);
    if (tid < C) send1(ssq + slot * C + rank, ex.bar(), tid, p);
    ex.wait();
    return ordered(ssq + slot * C, 1, n);
  };

  // resident slices, and u = nrm(u0) in every block
  for (int j = 0; j < m; ++j) {
    if (a.res_off[j] < 0) continue;
    const int len = a.dims[j + 1];
    const int64_t count = static_cast<int64_t>(s_hi[j] - s_lo[j]) * len;
    const T* src = static_cast<const T*>(a.w[j]) +
                   static_cast<int64_t>(s_lo[j]) * a.ld[j];
    T* dst = reinterpret_cast<T*>(smem + a.res_off[j]);
    const int64_t bytes = count * static_cast<int64_t>(sizeof(T));
    if (a.ld[j] == len && reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
        bytes % 16 == 0) {
      const uint4* s4 = reinterpret_cast<const uint4*>(src);
      uint4* d4 = reinterpret_cast<uint4*>(dst);
      for (int64_t i = tid; i < bytes / 16; i += kThreads) d4[i] = s4[i];
    } else {
      for (int64_t i = tid; i < count; i += kThreads) {
        const int64_t r = i / len;
        dst[i] = src[r * a.ld[j] + (i - r * len)];
      }
    }
  }
  {
    float ss = 0.f;
    for (int n = tid; n < dm; n += kThreads) {
      const float v = a.u_in[n];
      ufull[n] = v;
      ss = fmaf(v, v, ss);
    }
    const float den = sqrtf(block_sum(ss, red)) + a.eps;
    for (int n = tid; n < dm; n += kThreads) {
      const float v = ufull[n] / den;
      ufull[n] = v;
      xfull[n] = cast_link<T>(v);
    }
  }
  // every block of the cluster runs, its barriers initialized, before any
  // block sends to it
  cg::this_cluster().sync();

  int xb = 0, ib = 0;
  float sigma = 0.f;
  for (int round = 0; round <= a.n_iter; ++round) {
    // P^T chain: x (d_m, in every block) -> t = W_1 ... W_m x, slice by slice
    for (int j = m - 1; j >= 0; --j) {
      const int lo = s_lo[j], nrows = s_hi[j] - lo, len = a.dims[j + 1];
      const T* w = rows_of(j);
      const float* x = xfull + xb * a.dmax_e;
      float* next = xfull + (xb ^ 1) * a.dmax_e + lo;
      if (j > 0) ex.expect(4 * a.dims[j]);
      // sums of `count` rows from r0 on: rounded and sent to every block's
      // copy of the vector (four at a time where the group is whole), or,
      // at the end of the chain, kept unrounded for the norm
      auto emit = [&](int r0, const auto& acc, int count) {
        constexpr int RW = sizeof(acc) / sizeof(acc[0]);
        if (j == 0) {
          if (lane == 0) {
#pragma unroll
            for (int r = 0; r < RW; ++r) {
              if (r < count) xown[r0 + r] = acc[r];
            }
          }
        } else if (lane < C) {
          float* dst = next + r0;
          if constexpr (RW == 4) {
            if (count == 4) {
              send4(dst, ex.bar(), lane, cast_link<T>(acc[0]),
                    cast_link<T>(acc[1]), cast_link<T>(acc[2]),
                    cast_link<T>(acc[3]));
              return;
            }
          }
#pragma unroll
          for (int r = 0; r < RW; ++r) {
            if (r < count) send1(dst + r, ex.bar(), lane, cast_link<T>(acc[r]));
          }
        }
      };
      if (a.vec[j]) {
        pt_link<T, 4>(w, ld_of(j), x, nrows, len, emit);
      } else {
        pt_link<T, 1>(w, ld_of(j), x, nrows, len, emit);
      }
      if (j > 0) {
        ex.wait();
        xb ^= 1;
      }
    }
    {  // v = nrm(t): the block keeps its slice, rounded for the first P link
      __syncthreads();
      const int n0 = s_hi[0] - s_lo[0];
      float ss = 0.f;
      for (int i = tid; i < n0; i += kThreads) {
        ss = fmaf(xown[i], xown[i], ss);
      }
      ss = block_sum(ss, red);
      const float den = sqrtf(all_sum(ss, 0, s_ranks[0])) + a.eps;
      for (int i = tid; i < n0; i += kThreads) xown[i] = cast_link<T>(xown[i] / den);
      __syncthreads();
    }
    // P chain: x (d_0, sliced) -> W_m^T ... W_1^T x (d_m, sliced)
    for (int j = 0; j < m; ++j) {
      const int nrows = s_hi[j] - s_lo[j], dout = a.dims[j + 1];
      const int per_out = a.per[j + 1];
      const float inv_per = s.inv[j + 1];
      float* box = inbox + (ib * C + rank) * a.segmax;
      const int lo2 = s_lo[j + 1], n2 = s_hi[j + 1] - lo2;
      const int senders = s_ranks[j];
      ex.expect(4 * senders * n2);
      // the owner of column n is n / per_out; (n + 0.5) / per_out is at
      // least 0.5 / 8192 from an integer, far more than fp32 rounding moves
      // it, so the product's truncation is that quotient
      auto publish = [&](int n, const float* v) {
        const int owner = __float2int_rz((n + 0.5f) * inv_per);
        float* dst = box + (n - owner * per_out);
        if (a.vec[j]) {  // per_out is a multiple of 4: one owner, aligned
          send4(dst, ex.bar(), owner, v[0], v[1], v[2], v[3]);
        } else {
          send1(dst, ex.bar(), owner, v[0]);
        }
      };
      if (nrows > 0) {
        if (a.vec[j]) {
          p_link_partials<T, 4>(rows_of(j), ld_of(j), nrows, dout, xown, part,
                                publish);
        } else {
          p_link_partials<T, 1>(rows_of(j), ld_of(j), nrows, dout, xown, part,
                                publish);
        }
      }
      ex.wait();
      const float* in = inbox + ib * C * a.segmax;
      ib ^= 1;
      if (j < m - 1) {
        for (int i = tid; i < n2; i += kThreads) {
          xown[i] = cast_link<T>(ordered(in + i, a.segmax, senders));
        }
        __syncthreads();
      } else if (round < a.n_iter) {
        // u = nrm(P v): slices to every block, then the norm
        float* next = xfull + (xb ^ 1) * a.dmax_e;
        float sq = 0.f;
        ex.expect(4 * dm + 4 * C);
        for (int i = tid; i < n2; i += kThreads) {
          const float v = ordered(in + i, a.segmax, senders);
          sq = fmaf(v, v, sq);
          for (int c = 0; c < C; ++c) send1(next + lo2 + i, ex.bar(), c, v);
        }
        sq = block_sum(sq, red);
        if (tid < C) send1(ssq + C + rank, ex.bar(), tid, sq);
        ex.wait();
        const float den = sqrtf(ordered(ssq + C, 1, s_ranks[m])) + a.eps;
        xb ^= 1;
        for (int n = tid; n < dm; n += kThreads) {
          const float v = next[n] / den;
          ufull[n] = v;
          next[n] = cast_link<T>(v);
        }
        __syncthreads();
      } else {
        // sigma = u . (P v)
        float d = 0.f;
        for (int i = tid; i < n2; i += kThreads) {
          d = fmaf(ufull[lo2 + i], ordered(in + i, a.segmax, senders), d);
        }
        d = block_sum(d, red);
        sigma = all_sum(d, 2, s_ranks[m]);  // the last exchange
      }
    }
  }
  return Result{sigma, ufull, part};
}

// -- the product (Gram) form --------------------------------------------------

// Rows a lane of a product-form link takes: each read of R then serves 2
// rows. Shared memory returns 128 bytes a cycle to an SM, so a warp's
// 16-byte read of R costs 4 cycles, broadcast or not, against 2 cycles of
// FMA work for its 8 sums; 4 rows a lane would balance the two, but their
// 4 NC sums spill at 128 registers a thread (H100, a launch on 2020 x 1024
// x 20 at n_iter 0: 35.2 us at 2 rows, 54.2 at 4).
constexpr int kGramRows = 2;

// How a product-form link's depth K is cut over the warps: ceil(per / (32
// kGramRows)) warps cover a block's rows, and `splits` groups of them (as
// many as the warps allow, at most one per 32 of K) each take `ks`
// consecutive k, a multiple of 8. ops/cuda_spectral.py::_gram_splits is the
// same function.
__host__ __device__ inline int gram_splits(int per, int K) {
  constexpr int kLanesRows = 32 * kGramRows;
  const int by_warps = kWarps / ((per + kLanesRows - 1) / kLanesRows);
  const int by_depth = (K + 31) / 32;
  const int n = by_warps < by_depth ? by_warps : by_depth;
  return n > 1 ? n : 1;
}

// One product-form link on the block's `nrows` rows of w (rows `ld` apart,
// `per` the rows a block owns): out[r][c] = sum_k w[r, k] R[k, c], c < NC,
// rows of R and out `rs` floats apart. Lane l of the warp for split s and
// row group g takes rows 32 (RW g + i) + l, i < RW, and sums its ks values
// of k in order, one fmaf each, reading VW weights of a row at a time; all
// lanes of a warp read the same row of R, so a 16-byte read of R is one
// broadcast, and it serves RW rows. The splits' sums are added into out in
// split order (0 + s_0 + s_1 + ...), a block barrier after each.
template <typename T, int NC, int VW>
__device__ void gram_link(const T* w, int ld, const float* R, int rs,
                          int nrows, int K, int per, float* out) {
  constexpr int RW = kGramRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rw = (per + 32 * RW - 1) / (32 * RW);
  const int splits = gram_splits(per, K);
  const int ks = ((K + splits - 1) / splits + 7) & ~7;
  const int group = rw < kWarps ? rw : kWarps;  // warps of one split
  const int sp = warp / group;
  for (int g0 = 0; g0 < rw; g0 += group) {
    const int r0 = 32 * RW * (g0 + warp % group) + lane;
    float acc[RW][NC];
#pragma unroll
    for (int i = 0; i < RW; ++i) {
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
    }
    const int k0 = min(K, sp * ks), k1 = min(K, k0 + ks);
    if (sp < splits && r0 < nrows && k0 < k1) {
      const T* wr[RW];  // rows past the slice repeat its last row, unused
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        wr[i] = w + static_cast<int64_t>(min(r0 + 32 * i, nrows - 1)) * ld;
      }
      float wv[RW][VW];  // this step's weights; the next step's load ahead
#pragma unroll
      for (int i = 0; i < RW; ++i) Load<T, VW>::at(wr[i] + k0, wv[i]);
      for (int k = k0; k < k1; k += VW) {
        float nx[RW][VW] = {};
        if (k + VW < k1) {
#pragma unroll
          for (int i = 0; i < RW; ++i) Load<T, VW>::at(wr[i] + k + VW, nx[i]);
        }
#pragma unroll
        for (int q = 0; q < VW; ++q) {
          const float* rk = R + (k + q) * rs;
#pragma unroll
          for (int c = 0; c < NC; c += 4) {
            const float4 v = *reinterpret_cast<const float4*>(rk + c);
#pragma unroll
            for (int i = 0; i < RW; ++i) {
              acc[i][c] = fmaf(wv[i][q], v.x, acc[i][c]);
              acc[i][c + 1] = fmaf(wv[i][q], v.y, acc[i][c + 1]);
              acc[i][c + 2] = fmaf(wv[i][q], v.z, acc[i][c + 2]);
              acc[i][c + 3] = fmaf(wv[i][q], v.w, acc[i][c + 3]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < RW; ++i) {
#pragma unroll
          for (int q = 0; q < VW; ++q) wv[i][q] = nx[i][q];
        }
      }
    }
    for (int t = 0; t < splits; ++t) {
      if (sp == t) {
#pragma unroll
        for (int i = 0; i < RW; ++i) {
          if (r0 + 32 * i >= nrows) continue;
          float* o = out + (r0 + 32 * i) * rs;
#pragma unroll
          for (int c = 0; c < NC; c += 4) {
            const float4 p = t == 0 ? make_float4(0.f, 0.f, 0.f, 0.f)
                                    : *reinterpret_cast<const float4*>(o + c);
            *reinterpret_cast<float4*>(o + c) =
                make_float4(p.x + acc[i][c], p.y + acc[i][c + 1],
                            p.z + acc[i][c + 2], p.w + acc[i][c + 3]);
          }
        }
      }
      __syncthreads();
    }
  }
}

// NC = dims[m] rounded up to 4: the columns of R the links compute (those
// past dims[m] stay 0).
template <typename T, int NC>
__device__ Result gram_form(const PiArgs& a, unsigned char* smem, int rank) {
  const int C = a.cluster, m = a.m, dm = a.dims[m];
  constexpr int rs = NC;  // floats between rows of R
  const int tid = threadIdx.x, lane = tid % 32;
  const int g4 = round4(dm * dm);

  float* cur = reinterpret_cast<float*>(smem);  // [rrows][rs] R_{j+1}
  float* nxt = cur + a.rrows * rs;              // [rrows][rs] R_j
  float* gin = nxt + a.rrows * rs;              // [C][g4] every block's partial
  float* G = gin + C * g4;                      // [g4]
  float* u = G + g4;                            // [NC]
  float* tokens = u + NC;                       // [round4(C)]
  float* red = tokens + round4(C);              // [32]
  const Slices s = setup_slices(a, red + 32, rank);
  Exchange ex{s.bars, tokens, C, rank};

  {  // R_m = W_m: the whole layer in every block, or (m = 1) the block's rows
    const int j = m - 1, lo = m == 1 ? s.lo[0] : 0;
    const int rows = m == 1 ? s.hi[0] - lo : a.dims[j];
    const T* w = static_cast<const T*>(a.w[j]) +
                 static_cast<int64_t>(lo) * a.ld[j];
#pragma unroll 4
    for (int i = tid; i < rows * NC; i += kThreads) {
      const int r = i / NC, c = i - r * NC;
      float v = 0.f;
      if (c < dm) {
        Load<T, 1>::at(w + static_cast<int64_t>(r) * a.ld[j] + c, &v);
      }
      cur[r * rs + c] = v;
    }
    for (int n = tid; n < dm; n += kThreads) u[n] = a.u_in[n];
  }
  // every block of the cluster runs, its barriers initialized, before any
  // block sends to it
  cg::this_cluster().sync();

  // R_j = W_j R_{j+1}, j = m - 1 .. 1 (0-based: m - 2 .. 0): each block forms
  // its rows into its own copy, then sends them to the others' copies; R_1 =
  // Q stays with the owners of its rows (from row 0 of the copy)
  constexpr int kVec = 16 / sizeof(T);  // weights a lane reads at once
  for (int j = m - 2; j >= 0; --j) {
    const int lo = s.lo[j], nrows = s.hi[j] - lo;
    const T* w = static_cast<const T*>(a.w[j]) +
                 static_cast<int64_t>(lo) * a.ld[j];
    float* own = nxt + (j > 0 ? lo : 0) * rs;
    if (j > 0) ex.expect(4 * (a.dims[j] - nrows) * NC);
    if (a.vec[j]) {
      gram_link<T, NC, kVec>(w, a.ld[j], cur, rs, nrows, a.dims[j + 1],
                             a.per[j], own);
    } else {
      gram_link<T, NC, 1>(w, a.ld[j], cur, rs, nrows, a.dims[j + 1],
                          a.per[j], own);
    }
    if (j > 0) {  // the block's rows, one bulk message to each other block
      fence_for_bulk();
      __syncthreads();
      if (tid < C && tid != rank && nrows > 0) {
        send_bulk(own, 4 * nrows * NC, ex.bar(), tid);
        bulk_sent();
      }
      ex.wait();
    }
    float* t = cur;
    cur = nxt;
    nxt = t;
  }

  // G = Q^T Q: the partial over the block's rows of Q into the block's own
  // slot, then one bulk message to each other block's slot; all add the
  // partials in rank order (the last exchange)
  const int n0 = s.hi[0] - s.lo[0];
  for (int t = tid; t < g4; t += kThreads) {
    float acc = 0.f;
    if (t < dm * dm) {
      const int i = t / dm, k = t - i * dm;
#pragma unroll 8
      for (int r = 0; r < n0; ++r) {
        acc = fmaf(cur[r * rs + i], cur[r * rs + k], acc);
      }
    }
    gin[rank * g4 + t] = acc;
  }
  ex.expect(4 * (C - 1) * g4);
  fence_for_bulk();
  __syncthreads();
  if (tid < C && tid != rank) {
    send_bulk(gin + rank * g4, 4 * g4, ex.bar(), tid);
    bulk_sent();
  }
  ex.wait();
  for (int t = tid; t < dm * dm; t += kThreads) {
    G[t] = ordered(gin + t, g4, s.ranks[0]);
  }
  __syncthreads();

  // the rounds on G in one warp: lane i holds row i of G and entry i of u
  // (zeros past dm, which add exact zeros to every sum); every lane forms
  // the same sums in index order, taking the other lanes' entries by shuffle
  if (tid < 32) {
    constexpr unsigned kAll = 0xffffffffu;
    float grow[NC];
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      grow[n] = lane < dm && n < dm ? G[lane * dm + n] : 0.f;
    }
    auto sumsq = [&](float v) {
      float ss = 0.f;
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const float vn = __shfl_sync(kAll, v, n);
        ss = fmaf(vn, vn, ss);
      }
      return ss;
    };
    auto apply = [&](float v) {  // (G v)_lane
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        acc = fmaf(grow[n], __shfl_sync(kAll, v, n), acc);
      }
      return acc;
    };
    float ui = lane < dm ? u[lane] : 0.f;
    ui = ui / (sqrtf(sumsq(ui)) + a.eps);
    for (int it = 0; it < a.n_iter; ++it) {
      const float yi = apply(ui);
      ui = yi / (sqrtf(sumsq(yi)) + a.eps);
    }
    const float yi = apply(ui);
    float q = 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      q = fmaf(__shfl_sync(kAll, ui, n), __shfl_sync(kAll, yi, n), q);
    }
    if (lane < dm) u[lane] = ui;
    if (lane == 0) red[0] = q / (sqrtf(q) + a.eps);
  }
  __syncthreads();
  return Result{red[0], u, red + 1};
}

template <typename T>
__device__ Result gram_dispatch(const PiArgs& a, unsigned char* smem,
                                int rank) {
  switch (round4(a.dims[a.m])) {
    case 4: return gram_form<T, 4>(a, smem, rank);
    case 8: return gram_form<T, 8>(a, smem, rank);
    case 12: return gram_form<T, 12>(a, smem, rank);
    case 16: return gram_form<T, 16>(a, smem, rank);
    case 20: return gram_form<T, 20>(a, smem, rank);
    case 24: return gram_form<T, 24>(a, smem, rank);
    case 28: return gram_form<T, 28>(a, smem, rank);
    default: return gram_form<T, kGramCols>(a, smem, rank);
  }
}

// -- the launch ---------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
pi_cluster_kernel(const __grid_constant__ PiArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int tid = threadIdx.x, m = a.m, dm = a.dims[m];
  const Result res = a.gram ? gram_dispatch<T>(a, smem, rank)
                            : chain_form<T>(a, smem, rank);

  if (rank == 0) {
    for (int n = tid; n < a.u_len; n += kThreads) {
      a.u_out[n] = n < dm ? res.u[n] : 0.f;
    }
    if (tid == 0) a.sigma[0] = res.sigma;
  }
  if (a.rho <= 0.f) return;

  // simple_norm: w16 <- bf16(f32(w16) * f_i), master <- master * f_i
  float* fac = res.scratch;
  if (tid == 0) {
    float sg = res.sigma;
    for (int i = 0; i < m; ++i) {
      const float fi = expf(logf(a.rho / (sg + a.eps)) * a.inv_m);
      fac[i] = fi;
      sg = sg * fi;
    }
  }
  __syncthreads();
  const int64_t t0 = static_cast<int64_t>(rank) * kThreads + tid;
  const int64_t stride = static_cast<int64_t>(a.cluster) * kThreads;
  for (int i = 0; i < m; ++i) {
    const float fi = fac[i];
    const int64_t n = a.numel[i];
    bf16* w16 = static_cast<bf16*>(const_cast<void*>(a.w[i]));
    float* ms = a.master[i];
    const bool wide = n % 8 == 0 && reinterpret_cast<uintptr_t>(w16) % 16 == 0 &&
                      (ms == nullptr || reinterpret_cast<uintptr_t>(ms) % 16 == 0);
    if (wide) {
      for (int64_t i8 = t0; i8 < n / 8; i8 += stride) {
        uint4 raw = reinterpret_cast<uint4*>(w16)[i8];
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 v = __bfloat1622float2(h[q]);
          h[q] = __floats2bfloat162_rn(v.x * fi, v.y * fi);
        }
        reinterpret_cast<uint4*>(w16)[i8] = raw;
        if (ms != nullptr) {
          float4* m4 = reinterpret_cast<float4*>(ms) + 2 * i8;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            float4 v = m4[q];
            v.x *= fi, v.y *= fi, v.z *= fi, v.w *= fi;
            m4[q] = v;
          }
        }
      }
    } else {
      for (int64_t e = t0; e < n; e += stride) {
        w16[e] = __float2bfloat16(__bfloat162float(w16[e]) * fi);
        if (ms != nullptr) ms[e] *= fi;
      }
    }
  }
}

template <typename T>
cudaError_t set_attributes() {
  const void* fn = reinterpret_cast<const void*>(pi_cluster_kernel<T>);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// The attributes are per device: set them at the first use on each one.
cudaError_t ensure_attributes() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = set_attributes<bf16>();
  if (err == cudaSuccess) err = set_attributes<float>();
  if (err == cudaSuccess) done[dev].store(true, std::memory_order_release);
  return err;
}

void launch_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                   int cluster, int smem, cudaStream_t st) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cluster);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

}  // namespace

// Enqueues the whole power iteration as one cluster launch on `stream` and
// returns cudaGetLastError() (0 on success). ws[i] is a row-major device
// buffer of numel[i] elements, bf16 when wbf16 else fp32, whose first
// dims[i] rows of ld[i] entries hold W_i (dims[i] x dims[i+1]) in their
// first dims[i+1] columns, zeros beyond; u_in (dims[m] read), u_out (u_len
// written: zeros past dims[m]) fp32, may alias; sigma (1,) fp32. rho > 0
// also applies the simple_norm rescale to the whole buffers (bf16 kernels
// only) and to masters[i] (fp32, same layout) when masters is not null. The
// plan comes from ops/cuda_spectral.py::pi_plan: `gram` picks the product
// form, `cluster` blocks, per[i] (i <= m) entries of dimension i per block,
// res_off[i] (chain form) the byte offset of layer i's resident slice in the
// block's `smem_bytes` of dynamic shared memory, or -1 for a layer read from
// global memory.
extern "C" int asr_pi_run(const void* const* ws, const int* dims,
                          const int* ld, const long long* numel, int m,
                          int wbf16, const void* u_in, void* u_out, int u_len,
                          void* sigma, int n_iter, float eps, float rho,
                          float inv_m, void* const* masters, int cluster,
                          int gram, const int* per, const int* res_off,
                          int smem_bytes, void* stream) {
  if (m < 1 || m > kMaxLayers || n_iter < 0 || (rho > 0.f && !wbf16) ||
      cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) != 0 ||
      smem_bytes > kSmemMax || u_len < dims[m]) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PiArgs a{};
  const int esize = wbf16 ? 2 : 4;
  int dmax = 0, segmax = 0;
  for (int i = 0; i <= m; ++i) {
    if (dims[i] < 1 || dims[i] > kMaxDim || per[i] < 1 ||
        static_cast<int64_t>(per[i]) * cluster < dims[i]) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    a.dims[i] = dims[i];
    a.per[i] = per[i];
    dmax = dims[i] > dmax ? dims[i] : dmax;
    segmax = per[i] > segmax ? per[i] : segmax;
  }
  for (int i = 0; i < m; ++i) {
    if (ld[i] < dims[i + 1] ||
        numel[i] < static_cast<int64_t>(dims[i]) * ld[i]) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    a.w[i] = ws[i];
    a.master[i] =
        masters != nullptr ? static_cast<float*>(masters[i]) : nullptr;
    a.ld[i] = ld[i];
    a.numel[i] = numel[i];
  }
  if (gram) {
    // two copies of R (rows: the widest inner dimension or the block's
    // slice of d_0)
    const int dm = dims[m];
    int rrows = per[0];
    for (int j = 1; j < m; ++j) rrows = dims[j] > rrows ? dims[j] : rrows;
    if (dm > kGramCols ||
        4 * static_cast<int64_t>(gram_floats(rrows, dm, cluster)) >
            smem_bytes) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    a.gram = 1;
    a.rrows = rrows;
    for (int i = 0; i < m; ++i) {
      a.res_off[i] = -1;
      // rows read 16 bytes at a time: 16-byte rows, whole words
      const int vw = 16 / esize;
      a.vec[i] = ld[i] % vw == 0 && dims[i + 1] % vw == 0 &&
                 reinterpret_cast<uintptr_t>(ws[i]) % 16 == 0;
    }
  } else {
    a.dmax_e = round4(dmax);
    a.dm_e = round4(dims[m]);
    a.segmax = segmax;
    const int vec_bytes =
        4 * vector_floats(a.dmax_e, a.dm_e, segmax, cluster);
    if (vec_bytes > smem_bytes) return static_cast<int>(cudaErrorInvalidValue);
    for (int i = 0; i < m; ++i) {
      a.res_off[i] = res_off[i];
      const int64_t slice = static_cast<int64_t>(per[i]) * dims[i + 1] * esize;
      if (res_off[i] >= 0 && (res_off[i] < vec_bytes || res_off[i] % 16 != 0 ||
                              res_off[i] + slice > smem_bytes)) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      // four entries at a time: rows start on 8- (bf16) or 16-byte (fp32)
      // boundaries, and four columns share an owner
      a.vec[i] = dims[i + 1] % 4 == 0 && per[i + 1] % 4 == 0 &&
                 ld[i] % 4 == 0 &&
                 reinterpret_cast<uintptr_t>(ws[i]) % (4 * esize) == 0;
    }
  }
  a.m = m;
  a.n_iter = n_iter;
  a.cluster = cluster;
  a.u_len = u_len;
  a.eps = eps;
  a.rho = rho;
  a.inv_m = inv_m;
  a.u_in = static_cast<const float*>(u_in);
  a.u_out = static_cast<float*>(u_out);
  a.sigma = static_cast<float*>(sigma);
  cudaError_t err = ensure_attributes();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  launch_config(&cfg, &attr, cluster, smem_bytes,
                static_cast<cudaStream_t>(stream));
  err = wbf16 ? cudaLaunchKernelEx(&cfg, pi_cluster_kernel<bf16>, a)
              : cudaLaunchKernelEx(&cfg, pi_cluster_kernel<float>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Loads both kernels into the current context and sets their attributes, so
// that a later CUDA-graph capture neither loads modules lazily nor changes
// a function attribute. Writes to *max_clusters how many clusters of
// `cluster` blocks with the full 227 KB of shared memory the device can
// hold at once; 0 means such a cluster can never be scheduled, and the
// caller must not launch one.
extern "C" int asr_pi_preload(int cluster, int* max_clusters) {
  cudaError_t err = ensure_attributes();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes fa;
  const void* fns[] = {reinterpret_cast<const void*>(pi_cluster_kernel<bf16>),
                       reinterpret_cast<const void*>(pi_cluster_kernel<float>)};
  for (const void* fn : fns) {
    err = cudaFuncGetAttributes(&fa, fn);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  launch_config(&cfg, &attr, cluster, kSmemMax, nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, pi_cluster_kernel<bf16>, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  *max_clusters = n;
  return 0;
}
