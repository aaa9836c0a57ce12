// K3 on Hopper: the kernels of one fused constrained training step.
//
// Replaces asr_using_robust_nn_tpu/ops/pallas_train.py::_make_epoch_kernel,
// the Pallas TPU kernel that runs a whole epoch as one pallas_call with a
// grid over the steps. Each step: bf16 forward (Dense + bias + ReLU,
// row-weighted BatchNorm that also moves the running statistics, dropout),
// softmax-CCE with row weights, the manual backward (BN backward included,
// the dropout mask regenerated, not stored), Adam on fp32 masters and
// moments, the NonNeg clamp and the simple_norm projection (K2's kernel,
// csrc/product_power_iter.cu) with its eager rescale.
//
// What bounds it on an H100: at batch 512 a step is ~4 GFLOP of bf16 GEMMs
// (4 us at the card's rate) over a state that stays in the 50 MB L2, so
// neither bytes nor operations bound it: the chain of dependent launches
// does; within it, the weight update is bound by the bytes of the fp32
// state (fe_dw_adam_group below). Every product is small (the widths fall 1024 -> 128), so a launch
// is worth its latency only if it fills the card and does everything that
// depends on its tile while the tile is in registers.
//
// What the design does about it (ops/cuda_train.py::launch_plan decides the
// form of every launch from the spec alone; the step's launches are captured
// once into a CUDA graph and replayed):
//  * One GEMM main loop (gemm_sm90.cuh): a 4-stage shared-memory ring filled
//    by cp.async, multiplied by wgmma m64n64k16 from 128-byte swizzled tiles,
//    fp32 sums in registers, epilogues applied from the registers. The three
//    operand layouts of a step map to wgmma's per-operand transpose bits.
//  * fe_fwd_bn: a hidden layer's whole forward in one launch. The blocks
//    that share a 64-column tile (batch / 64 of them, at most 8) form a
//    thread-block cluster along the batch; each holds relu(z + b) of its 64
//    rows in registers, the weighted column sums of a, then of (a - mu)^2
//    (two passes, as the TPU kernel and the twin compute the variance), meet
//    through distributed shared memory and are added in rank order by every
//    block, rank 0 writes mu, 1/sd and the running statistics, and every
//    block writes x^ and the dropped-out activation in bf16. No fp32 z ever
//    leaves the SM.
//  * fe_ce: softmax-CCE on rows / 8 blocks, a warp a row (max, sum of exp,
//    NLL and argmax by shuffles), dZ written directly as the bf16 operand of
//    the two GEMMs that read it; per-block partials of the loss, the
//    accuracy and the output layer's db are added in block order by the last
//    block to finish (an integer ticket, no floating-point atomics), which
//    also runs Adam on that bias.
//  * fe_dx_bn: dX of a layer with the BN/ReLU/dropout backward of the layer
//    below in its epilogue, again on a cluster along the batch: dD tile in
//    registers -> dropout -> the four column sums (dgamma, dbeta, s1, s2) by
//    one exchange -> dz -> ReLU mask -> dzb in bf16 and the db sums by a
//    second exchange; rank 0 runs Adam on gamma, beta, b (gamma is read
//    before its update). No fp32 dD ever leaves the SM. The mask compares the
//    bf16 x^ with the bf16-rounded threshold -mu * sdinv, and the forward
//    stores a live unit's x^ one bf16 step above that threshold where it
//    would round onto it (xhat_store), so the mask is exactly a > 0. The
//    Pallas kernel's fp32 threshold lets about half the dead units (a = 0,
//    whose bf16 x^ rounds above it) pass gradient; a threshold rounded
//    alone, without xhat_store, drops the gradient of the live units whose
//    x^ rounds onto it.
//  * fe_dw_adam_group: every layer's dW fused with Adam + NonNeg + the bf16
//    copy, in one launch a step issued after the whole dX chain (dX of a
//    layer reads the kernel above before its update either way). The dW
//    products are short (depth = the batch), so what bounds this part is
//    the fp32 state: master and both moments read and written and the bf16
//    copy written, 26 bytes a padded weight (73 MB a step at the speaker
//    widths, 43 MB at the digit ones; 22 / 13 us at 3.35 TB/s, less from
//    L2). Four persistent blocks an SM walk a static list of all layers'
//    64 x 64 tiles, largest layer first; each tile's state is fetched into
//    L2 while the tile before it is multiplied and updated, its loads are
//    issued in batches ahead of the stores, and the operand slices of
//    consecutive tiles share one ring. The per-layer form it replaced on
//    K3's path (fe_dw_adam, one cluster launch a layer, split over the
//    batch so that narrow layers filled SMs; gemm_sm90.cuh::dw_adam_body,
//    still K6's) ran each tile in a non-persistent block, with a launch's
//    latency and tail a layer: 4.5-4.7x the byte bound on an H100 (the
//    grouped form, timed alone: 1.8x / 2.7x). Staging the state in shared memory by 256-byte bulk
//    copies on one block an SM was slower than the per-layer form. The
//    grouped form adds each layer's depth slices in that cluster's rank
//    order and updates through the same function, so the two give the
//    same bits.
//  * A batch of more than 8 row tiles (or a tile count that is no power of
//    two) cannot put a column's rows into one cluster: it takes fe_gemm
//    (the same main loop, plain epilogues: bias + ReLU into an fp32 z, dX
//    into an fp32 dD) followed by the column kernels fe_bn_fwd / fe_bn_bwd,
//    one block per 8 columns (four times the grid of the 32-column form they
//    replace, 32-byte row segments).
//  * Fixed partitions and summation orders everywhere: two replays of a
//    graph give the same bits.
//
// Tried and refused here: nothing is summed with floating-point atomics, and
// the exchanges use cluster barriers (two or three a launch), not st.async
// with transaction barriers as K2 does for its ~200 exchanges: a launch here
// has so few that the simpler pull model costs nothing measurable.
//
// Dropout: a counter-based integer hash (lowbias32, two rounds) of the
// step's seed + layer and the unit's index row * width + col (global row and
// column on the padded width); the unit is kept when (h >> 8) * 2^-24 <
// keep. ops/cuda_train.py computes the same hash with torch integer ops, so
// kernel and plain twin drop the same units.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "adam_common.cuh"  // AdamArgs, bias_corrections, adam_step
#include "gemm_sm90.cuh"    // the wgmma main loop, cluster helpers, dW + Adam

namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int CW = 8;     // column kernels: columns per block
constexpr int CG = 32;    // ... and row groups (CW * CG threads)
constexpr int CT = CW * CG;
constexpr int RT = 256;   // row / reduction kernels
constexpr int CE_ROWS = RT / 32;  // fe_ce: rows per block, a warp each
constexpr int CE_MAXP = 512;      // fe_ce: widest padded class dimension
constexpr int kGemmSmem = kAlign + kRingBytes;

struct SmallRows {  // this layer's rows of the small (m, dmax) arrays
  float* p[9];      // gamma, m_gamma, v_gamma, beta, m_beta, v_beta, b, m_b, v_b
};

__device__ __forceinline__ void adam_col(float* p, float* m, float* v, int c,
                                         float g, float bc1, float bc2,
                                         const AdamArgs& a) {
  float pp = p[c], mm = m[c], vv = v[c];
  adam_step(pp, mm, vv, g, bc1, bc2, a);
  p[c] = pp;
  m[c] = mm;
  v[c] = vv;
}

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ bool keep_unit(uint32_t key_mix, int r, int c,
                                          int d, float keep) {
  const uint32_t h = mix32(static_cast<uint32_t>(r * d + c) ^ key_mix);
  return static_cast<float>(h >> 8) * (1.0f / 16777216.0f) < keep;
}

__device__ __forceinline__ uint32_t drop_key(const int* seeds, int step,
                                             int layer) {
  return mix32(static_cast<uint32_t>(seeds[step]) +
               static_cast<uint32_t>(layer));
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// The bf16 value one step above the bf16 value x.
__device__ __forceinline__ float bf16_next_up(float x) {
  const unsigned short b = __bfloat16_as_ushort(__float2bfloat16(x));
  const unsigned short n =
      (b & 0x7fff) == 0 ? 1 : ((b & 0x8000) ? b - 1 : b + 1);
  return __bfloat162float(__ushort_as_bfloat16(n));
}

// x^ as stored, in bf16 (exactly representable): its rounding, but one
// step above the bf16 ReLU threshold thr = bf16(-mu * sdinv) where a live
// unit (a > 0) would round onto it. A dead unit's x^ is the threshold
// itself, so the backward's mask x^ > thr is exactly a > 0.
__device__ __forceinline__ float xhat_store(float xh, float a, float thr) {
  const float r = bf16_round(xh);
  return (a > 0.f && r <= thr) ? bf16_next_up(r) : r;
}

// Sum over a block of RT threads; every thread gets the total.
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < RT / 32 ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  return t;
}

// Column total over the CG row groups of a CT block (thread (ty, tx) holds
// the partial of rows ty, ty + CG, ... of column tx), added in group order.
__device__ __forceinline__ float col_reduce(float v, float (*red)[CW + 1],
                                            int tx, int ty) {
  red[ty][tx] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int k = 0; k < CG; ++k) t += red[k][tx];
  __syncthreads();
  return t;
}

// ---- GEMM with a plain epilogue ---------------------------------------------

struct EpiHidden {  // out = relu(v + bias), fp32
  const float* bias;
  float* out;
  int ld;
  __device__ void operator()(int m, int n, float v0, float v1) const {
    *reinterpret_cast<float2*>(out + static_cast<int64_t>(m) * ld + n) =
        make_float2(fmaxf(v0 + bias[n], 0.f), fmaxf(v1 + bias[n + 1], 0.f));
  }
};

struct EpiLogits {  // out = v + bias, -1e9 past the true classes
  const float* bias;
  float* out;
  int ld, n_classes;
  __device__ void operator()(int m, int n, float v0, float v1) const {
    *reinterpret_cast<float2*>(out + static_cast<int64_t>(m) * ld + n) =
        make_float2(n >= n_classes ? -1e9f : v0 + bias[n],
                    n + 1 >= n_classes ? -1e9f : v1 + bias[n + 1]);
  }
};

struct EpiStore {
  float* out;
  int ld;
  __device__ void operator()(int m, int n, float v0, float v1) const {
    *reinterpret_cast<float2*>(out + static_cast<int64_t>(m) * ld + n) =
        make_float2(v0, v1);
  }
};

// AT: A is stored (K, lda) and read transposed; else (M, lda).
// BT: B is stored (N, ldb) and read transposed; else (K, ldb).
template <bool AT, bool BT, class Epi>
__global__ void __launch_bounds__(kThreads)
fe_gemm(const bf16* __restrict__ A, int lda, const bf16* __restrict__ B,
        int ldb, int K, Epi epi) {
  extern __shared__ unsigned char smem_raw[];
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  float acc[32];
  mainloop<AT, BT>(acc, A, lda, B, ldb, m0, n0, 0, K / kTile,
                   smem_u32(aligned_smem(smem_raw)));
  const int r0 = m0 + frag_row(), c0 = n0 + frag_col();
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      epi(r0 + 8 * h, c0 + nb * 8, acc[nb * 4 + h * 2], acc[nb * 4 + h * 2 + 1]);
    }
  }
}

// ---- a hidden layer's forward, BN in the epilogue -----------------------------

struct FwdArgs {
  const bf16* a;       // (M, K) activations
  const bf16* w;       // (K, N) kernel
  const float* bias;
  const float* wrow;
  const float* denom;
  const float* gamma;
  const float* beta;
  float* rmean;
  float* rvar;
  float* muvec;
  float* sdvec;
  bf16* xhat;
  bf16* act_next;
  const int* seeds;
  int N, K, use_bn, step, layer;
  float bn_eps, mom, omm, keep;
};

__device__ __forceinline__ void store_bf162(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Grid (N / 64, M / 64), clusters of (1, M / 64) blocks.
__global__ void __launch_bounds__(kThreads) fe_fwd_bn(FwdArgs p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ float wp[256];
  __shared__ float xch[2][64];
  __shared__ float s_mu[64], s_sd[64];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int r0 = frag_row(), c0 = frag_col();
  const int nranks = cluster_size(), rank = cluster_rank();
  // what the epilogue reads is asked for before the main loop
  const float w0 = p.wrow[m0 + r0], w1 = p.wrow[m0 + r0 + 8];
  const float den = p.denom[0];
  float bias[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    bias[i] = p.bias[n0 + (i >> 1) * 8 + c0 + (i & 1)];
  }
  float acc[32];
  mainloop<false, false>(acc, p.a, p.K, p.w, p.N, m0, n0, 0, p.K / kTile,
                         smem_u32(aligned_smem(smem_raw)));
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int j = (i >> 1) * 4 + (i & 1);
    acc[j] = fmaxf(acc[j] + bias[i], 0.f);
    acc[j + 2] = fmaxf(acc[j + 2] + bias[i], 0.f);
  }
  if (p.use_bn) {
    float v[1][16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int j = (i >> 1) * 4 + (i & 1);
      v[0][i] = acc[j] * w0 + acc[j + 2] * w1;
    }
    block_colsum<1>(v, wp, xch[0]);
    cluster_sync();
    if (tid < 64) s_mu[tid] = cluster_ordered_sum(&xch[0][tid], nranks) / den;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int j = (i >> 1) * 4 + (i & 1);
      const float mu = s_mu[(i >> 1) * 8 + c0 + (i & 1)];
      const float t0 = acc[j] - mu, t1 = acc[j + 2] - mu;
      v[0][i] = (t0 * t0) * w0 + (t1 * t1) * w1;
    }
    block_colsum<1>(v, wp, xch[1]);
    cluster_sync();
    if (tid < 64) {
      const float var = cluster_ordered_sum(&xch[1][tid], nranks) / den;
      const float sdinv = 1.f / sqrtf(var + p.bn_eps);
      s_sd[tid] = sdinv;
      if (rank == 0) {
        const int c = n0 + tid;
        const float mu = s_mu[tid];
        p.muvec[c] = mu;
        p.sdvec[c] = sdinv;
        p.rmean[c] = p.mom * p.rmean[c] + p.omm * mu;
        p.rvar[c] = p.mom * p.rvar[c] + p.omm * var;
      }
    }
    cluster_arrive();  // this block has read what it needs of the others
    __syncthreads();
  } else if (rank == 0 && tid < 64) {
    p.muvec[n0 + tid] = 0.f;
    p.sdvec[n0 + tid] = 1.f;
  }
  const bool drop = p.keep < 1.f;
  const uint32_t km = drop ? drop_key(p.seeds, p.step, p.layer) : 0u;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    const int lc = nb * 8 + c0, col = n0 + lc;
    float mu[2] = {0.f, 0.f}, sd[2] = {1.f, 1.f}, g[2] = {1.f, 1.f},
          bt[2] = {0.f, 0.f};
    if (p.use_bn) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        mu[q] = s_mu[lc + q];
        sd[q] = s_sd[lc + q];
        g[q] = p.gamma[col + q];
        bt[q] = p.beta[col + q];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + r0 + 8 * h;
      float xh[2], out[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float av = acc[nb * 4 + h * 2 + q];
        xh[q] = av;
        out[q] = av;
        if (p.use_bn) {
          xh[q] = (av - mu[q]) * sd[q];
          out[q] = xh[q] * g[q] + bt[q];
          const float thr = bf16_round(-mu[q] * sd[q]);
          xh[q] = xhat_store(xh[q], av, thr);
        }
        if (drop) {
          out[q] = keep_unit(km, row, col + q, p.N, p.keep) ? out[q] / p.keep
                                                            : 0.f;
        }
      }
      const int64_t i = static_cast<int64_t>(row) * p.N + col;
      store_bf162(p.xhat + i, xh[0], xh[1]);
      store_bf162(p.act_next + i, out[0], out[1]);
    }
  }
  if (p.use_bn) cluster_wait();  // nobody still reads this block's sums
}

// ---- softmax-CCE and the output layer's backward --------------------------------

struct CeArgs {
  const float* logits;  // (rows, P)
  const int* y;
  const float* wrow;
  const float* denom;
  float* loss;
  float* acc;
  bf16* dzb;            // (rows, P): dz = (softmax - onehot) * w / denom
  float* part;          // (blocks, P + 2) partials: db columns, loss, acc
  unsigned int* ticket;
  float* b;             // the output layer's bias and its moments
  float* m_b;
  float* v_b;
  const int* count;
  int rows, P, step;
  AdamArgs adam;
};

// rows / CE_ROWS blocks; a warp a row. The last block to take a ticket adds
// the partials in block order, writes loss[step] and acc[step], runs Adam on
// the bias and resets the ticket for the next launch.
__global__ void __launch_bounds__(RT) fe_ce(CeArgs p) {
  __shared__ float s_dz[CE_ROWS][CE_MAXP];
  __shared__ float s_la[2][CE_ROWS];
  __shared__ bool s_last;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r = blockIdx.x * CE_ROWS + warp;
  const int P = p.P;
  const float den = p.denom[0];
  const float* lr = p.logits + static_cast<int64_t>(r) * P;
  float zmax = -INFINITY;
  int arg = 0;
  for (int c = lane * 4; c < P; c += 128) {
    const float4 v = *reinterpret_cast<const float4*>(lr + c);
    const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (e[q] > zmax) {
        zmax = e[q];
        arg = c + q;
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {  // the first maximum, as argmax takes it
    const float oz = __shfl_xor_sync(0xffffffffu, zmax, o);
    const int oa = __shfl_xor_sync(0xffffffffu, arg, o);
    if (oz > zmax || (oz == zmax && oa < arg)) {
      zmax = oz;
      arg = oa;
    }
  }
  float sez = 0.f;
  for (int c = lane * 4; c < P; c += 128) {
    const float4 v = *reinterpret_cast<const float4*>(lr + c);
    sez += expf(v.x - zmax) + expf(v.y - zmax) + expf(v.z - zmax) +
           expf(v.w - zmax);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sez += __shfl_xor_sync(0xffffffffu, sez, o);
  const int yr = p.y[r];
  const float w = p.wrow[r];
  bf16* dzr = p.dzb + static_cast<int64_t>(r) * P;
  for (int c = lane * 4; c < P; c += 128) {
    const float4 v = *reinterpret_cast<const float4*>(lr + c);
    const float e[4] = {v.x, v.y, v.z, v.w};
    float dz[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float pr = expf(e[q] - zmax) / sez;
      dz[q] = ((pr - (c + q == yr ? 1.f : 0.f)) * w) / den;
      s_dz[warp][c + q] = dz[q];
    }
    store_bf162(dzr + c, dz[0], dz[1]);
    store_bf162(dzr + c + 2, dz[2], dz[3]);
  }
  if (lane == 0) {
    const float nll = -((lr[yr] - zmax) - logf(sez));
    s_la[0][warp] = nll * w;
    s_la[1][warp] = (arg == yr ? 1.f : 0.f) * w;
  }
  __syncthreads();
  float* mine = p.part + static_cast<int64_t>(blockIdx.x) * (P + 2);
  for (int c = tid; c < P + 2; c += RT) {
    float t = 0.f;
    if (c < P) {
#pragma unroll
      for (int k = 0; k < CE_ROWS; ++k) t += s_dz[k][c];
    } else {
#pragma unroll
      for (int k = 0; k < CE_ROWS; ++k) t += s_la[c - P][k];
    }
    mine[c] = t;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    s_last = atomicAdd(p.ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  float bc1, bc2;
  bias_corrections(p.count, p.step, p.adam, bc1, bc2);
  const int nb = gridDim.x;
  for (int c = tid; c < P + 2; c += RT) {
    float t = 0.f;
    for (int b0 = 0; b0 < nb; b0 += 8) {  // eight loads in flight, added in order
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        v[k] = b0 + k < nb
                   ? __ldcg(p.part + static_cast<int64_t>(b0 + k) * (P + 2) + c)
                   : 0.f;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (b0 + k < nb) t += v[k];
      }
    }
    if (c < P) {
      adam_col(p.b, p.m_b, p.v_b, c, t, bc1, bc2, p.adam);
    } else if (c == P) {
      p.loss[p.step] = t / den;
    } else {
      p.acc[p.step] = t / den;
    }
  }
  if (tid == 0) *p.ticket = 0u;
}

// ---- dX of a layer with the backward of the layer below in the epilogue ----

struct DxArgs {
  const bf16* dz;    // (M, K): dZ of the layer above
  const bf16* w;     // (N, K): its kernel
  const bf16* xhat;  // (M, N): x^ of the layer below
  const float* wrow;
  const float* denom;
  SmallRows sm;      // the layer below
  const float* muvec;
  const float* sdvec;
  bf16* dzb;         // (M, N): dZ of the layer below
  const int* seeds;
  const int* count;
  int N, K, mode, step, layer;  // mode 1: BN, 2: no BN
  float keep;
  AdamArgs adam;
};

// Grid (N / 64, M / 64), clusters of (1, M / 64) blocks.
__global__ void __launch_bounds__(kThreads) fe_dx_bn(DxArgs p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ float wp[4 * 256];
  __shared__ float xch[5][64];
  __shared__ float tot[4][64];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int r0 = frag_row(), c0 = frag_col();
  const int nranks = cluster_size(), rank = cluster_rank();
  // what the epilogue reads is asked for before the main loop
  const float den = p.denom[0];
  const float wr0 = p.wrow[m0 + r0], wr1 = p.wrow[m0 + r0 + 8];
  const bool drop = p.keep < 1.f;
  const uint32_t km = drop ? drop_key(p.seeds, p.step, p.layer) : 0u;
  __nv_bfloat162 xh2[16];  // x^ of (row half h, column pair nb): nb * 2 + h
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      xh2[nb * 2 + h] = *reinterpret_cast<const __nv_bfloat162*>(
          p.xhat + static_cast<int64_t>(m0 + r0 + 8 * h) * p.N + n0 + nb * 8 +
          c0);
    }
  }
  float g[16], sd[16], thr[16];
  if (p.mode == 1) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int c = n0 + (i >> 1) * 8 + c0 + (i & 1);
      g[i] = p.sm.p[0][c];
      sd[i] = p.sdvec[c];
      // a > 0 <=> x^ > -mu * sdinv. x^ is stored in bf16, so the threshold is
      // rounded the same way (a dead unit's x^ then equals it exactly).
      thr[i] = bf16_round(-p.muvec[c] * sd[i]);
    }
  }
  float acc[32];
  mainloop<false, true>(acc, p.dz, p.K, p.w, p.K, m0, n0, 0, p.K / kTile,
                        smem_u32(aligned_smem(smem_raw)));
  float xh[32];
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + r0 + 8 * h, col = n0 + nb * 8 + c0;
      const float2 x2 = __bfloat1622float2(xh2[nb * 2 + h]);
      const int j = nb * 4 + h * 2;
      xh[j] = x2.x;
      xh[j + 1] = x2.y;
      if (drop) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          acc[j + q] = keep_unit(km, row, col + q, p.N, p.keep)
                           ? acc[j + q] / p.keep
                           : 0.f;
        }
      }
    }
  }
  if (p.mode == 1) {
    float v[4][16];  // dgamma, dbeta, s1 = sum dx^, s2 = sum dx^ * x^
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int j = (i >> 1) * 4 + (i & 1);
      v[0][i] = acc[j] * xh[j] + acc[j + 2] * xh[j + 2];
      v[1][i] = acc[j] + acc[j + 2];
      v[2][i] = acc[j] * g[i] + acc[j + 2] * g[i];
      v[3][i] = (acc[j] * g[i]) * xh[j] + (acc[j + 2] * g[i]) * xh[j + 2];
    }
    block_colsum<4>(v, wp, &xch[0][0]);
    cluster_sync();
    for (int e = tid; e < 256; e += kThreads) {
      tot[e >> 6][e & 63] = cluster_ordered_sum(&xch[e >> 6][e & 63], nranks);
    }
    __syncthreads();
    const float wd0 = wr0 / den, wd1 = wr1 / den;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int lc = (i >> 1) * 8 + c0 + (i & 1), j = (i >> 1) * 4 + (i & 1);
      const float s1 = tot[2][lc], s2 = tot[3][lc];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float wd = h ? wd1 : wd0;
        const float x = xh[j + 2 * h];
        const float dxh = acc[j + 2 * h] * g[i];
        const float dz = sd[i] * (dxh - wd * s1 - wd * x * s2);
        acc[j + 2 * h] = x > thr[i] ? dz : 0.f;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = xh[j] > 0.f ? acc[j] : 0.f;
  }
  float vb[1][16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {  // db
    const int j = (i >> 1) * 4 + (i & 1);
    vb[0][i] = acc[j] + acc[j + 2];
  }
  block_colsum<1>(vb, wp, xch[4]);
  cluster_sync();
  if (rank == 0 && tid < 64) {
    const int c = n0 + tid;
    float bc1, bc2;
    bias_corrections(p.count, p.step, p.adam, bc1, bc2);
    const float db = cluster_ordered_sum(&xch[4][tid], nranks);
    adam_col(p.sm.p[6], p.sm.p[7], p.sm.p[8], c, db, bc1, bc2, p.adam);
    if (p.mode == 1) {
      adam_col(p.sm.p[0], p.sm.p[1], p.sm.p[2], c, tot[0][tid], bc1, bc2, p.adam);
      adam_col(p.sm.p[3], p.sm.p[4], p.sm.p[5], c, tot[1][tid], bc1, bc2, p.adam);
    }
  }
  cluster_arrive();  // rank 0 has read the others' db sums
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + r0 + 8 * h, col = n0 + nb * 8 + c0;
      const int j = nb * 4 + h * 2;
      store_bf162(p.dzb + static_cast<int64_t>(row) * p.N + col, acc[j],
                  acc[j + 1]);
    }
  }
  cluster_wait();
}

// ---- dW + Adam ----------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) fe_dw_adam(DwArgs a) {
  extern __shared__ unsigned char smem_raw[];
  dw_adam_body(a, smem_raw);
}

// ---- dW + Adam of every layer in one persistent launch ------------------------
//
// The tiles of every layer's dW form one list, layer by layer in the host's
// order (largest first); block b of G takes tiles b, b + G, b + 2G, ...,
// four blocks an SM (a 3-stage ring each). The operand slices of all of a block's tiles pass
// through one ring in turn, so the next tile's first slices load while this
// tile's Adam runs, and each tile's master and moments (48 KB) are fetched
// into L2 while the tile before it is multiplied and updated; the update
// reads them into registers in the accumulator's layout and stores straight
// out. A tile whose layer the per-layer plan splits over `split` depth ranks
// sums each rank's slices in its own accumulator and adds the rank sums in
// rank order: the operations and order of fe_dw_adam's cluster, without the
// cluster, and the same update (dw_adam_update), so the two give the same
// bits.

constexpr int kGroupMaxLayers = 16;
constexpr int kGroupStages = 3;
constexpr int kGroupSmemBytes = kAlign + kGroupStages * 2 * kTileBytes;
constexpr int kGroupBlocksPerSm = 4;
constexpr int kGroupLoadBatch = 4;  // positions whose state loads are in flight

struct DwLayer {  // one listed layer: dW (M, N) = x^T . dz, x (K, M), dz (K, N)
  const bf16* x;
  const bf16* dz;
  float* master;
  float* mw;
  float* vw;
  bf16* w16;
  int M, N, split, tile0, layer;
};

struct DwGroupArgs {
  DwLayer L[kGroupMaxLayers];
  int n_layers, n_tiles, K;
  const int* count;
  int step;
  const float* scales;  // null: as fe_dw_adam, whose factor is 1
  AdamArgs adam;
  int nonneg;
};

struct GroupTile {
  int j, m0, n0;  // listed layer, tile origin
};

__device__ __forceinline__ GroupTile group_tile(const DwGroupArgs& a, int t) {
  int j = 0;
  while (j + 1 < a.n_layers && t >= a.L[j + 1].tile0) ++j;
  const int local = t - a.L[j].tile0, tn = a.L[j].N / kTile;
  return {j, (local / tn) * kTile, (local % tn) * kTile};
}

// Tile t's master and moments into L2: 3 x 64 rows of 256 bytes, 384 lines
// of 128 bytes, three a thread.
__device__ __forceinline__ void prefetch_state(const DwGroupArgs& a, int t) {
  const GroupTile at = group_tile(a, t);
  const DwLayer& L = a.L[at.j];
#pragma unroll
  for (int arr = 0; arr < 3; ++arr) {
    const float* base = arr == 0 ? L.master : arr == 1 ? L.mw : L.vw;
    const int row = threadIdx.x >> 1, half = threadIdx.x & 1;
    const float* p =
        base + static_cast<int64_t>(at.m0 + row) * L.N + at.n0 + half * 32;
    asm volatile("prefetch.global.L2 [%0];" :: "l"(p));
  }
}

// Grid (G, 1, 1), G at most the tile count; no cluster.
__global__ void __launch_bounds__(kThreads, kGroupBlocksPerSm)
fe_dw_adam_group(const __grid_constant__ DwGroupArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = smem_u32(aligned_smem(smem_raw));
  const int b = blockIdx.x, G = gridDim.x;
  const int mine = (a.n_tiles - b + G - 1) / G;  // this block's tiles
  const int kt = a.K / kTile;                   // 64-deep slices a tile
  prefetch_state(a, b);
  float bc1, bc2;
  bias_corrections(a.count, a.step, a.adam, bc1, bc2);
  const int r0 = frag_row(), c0 = frag_col();
  float acc[32], tot[32];

  auto fill = [&](int k) {
    const int s = k % kt;
    const GroupTile at = group_tile(a, b + (k / kt) * G);
    const DwLayer& L = a.L[at.j];
    const uint32_t st = ring + (k % kGroupStages) * 2 * kTileBytes;
    load_tile<true>(st, L.x, L.M, at.m0, s * kTile);
    load_tile<true>(st + kTileBytes, L.dz, L.N, at.n0, s * kTile);
  };

  // The tile's 16 positions of two columns, kGroupLoadBatch at a time: all
  // loads of a batch are issued before its first store (a store may alias a
  // later load as far as the compiler knows, so it would not move them).
  auto update = [&](const GroupTile& at) {
    const DwLayer& L = a.L[at.j];
    const float s_prev = a.scales != nullptr ? a.scales[L.layer] : 1.f;
#pragma unroll
    for (int u0 = 0; u0 < 16; u0 += kGroupLoadBatch) {
      float2 pv[kGroupLoadBatch], mv[kGroupLoadBatch], vv[kGroupLoadBatch];
      int64_t gi[kGroupLoadBatch];
#pragma unroll
      for (int u = 0; u < kGroupLoadBatch; ++u) {
        const int nb = (u0 + u) >> 1, h = (u0 + u) & 1;
        gi[u] = static_cast<int64_t>(at.m0 + r0 + 8 * h) * L.N + at.n0 +
                nb * 8 + c0;
        pv[u] = *reinterpret_cast<const float2*>(L.master + gi[u]);
        mv[u] = *reinterpret_cast<const float2*>(L.mw + gi[u]);
        vv[u] = *reinterpret_cast<const float2*>(L.vw + gi[u]);
      }
#pragma unroll
      for (int u = 0; u < kGroupLoadBatch; ++u) {
        const int j = ((u0 + u) >> 1) * 4 + ((u0 + u) & 1) * 2;
        float p[2] = {pv[u].x, pv[u].y}, mm[2] = {mv[u].x, mv[u].y},
              v[2] = {vv[u].x, vv[u].y};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          dw_adam_update(p[e], mm[e], v[e], tot[j + e], s_prev, bc1, bc2,
                         a.adam, a.nonneg);
        }
        *reinterpret_cast<float2*>(L.master + gi[u]) = make_float2(p[0], p[1]);
        *reinterpret_cast<float2*>(L.mw + gi[u]) = make_float2(mm[0], mm[1]);
        *reinterpret_cast<float2*>(L.vw + gi[u]) = make_float2(v[0], v[1]);
        store_bf162(L.w16 + gi[u], p[0], p[1]);
      }
    }
  };

  auto consume = [&](int k) {
    const int q = k / kt, s = k % kt;
    const GroupTile at = group_tile(a, b + q * G);
    const int per = kt / a.L[at.j].split;  // slices of one depth rank
    if (s == 0) {
      if (q + 1 < mine) prefetch_state(a, b + (q + 1) * G);
#pragma unroll
      for (int i = 0; i < 32; ++i) tot[i] = 0.f;
    }
    if (s % per == 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    }
    const uint32_t st = ring + (k % kGroupStages) * 2 * kTileBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      wgmma_m64n64k16<1, 1>(acc, make_desc(st + kk * 2048),
                            make_desc(st + kTileBytes + kk * 2048));
    }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(acc[i]) :: "memory");
    if (s % per == per - 1) {  // a rank's sum, added in rank order
#pragma unroll
      for (int i = 0; i < 32; ++i) tot[i] += acc[i];
    }
    if (s == kt - 1) update(at);
  };

  ring_loop<kGroupStages>(mine * kt, fill, consume);
}

// ---- elementwise and column kernels ---------------------------------------------

__global__ void fe_cast_bf16(const float* __restrict__ src,
                             bf16* __restrict__ dst, int64_t n) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    dst[i] = __float2bfloat16(src[i]);
  }
}

// acts0 = bf16(x); block 0 also writes denom = sum(wrow) + 1e-9.
__global__ void __launch_bounds__(RT)
fe_prologue(const float* __restrict__ x, bf16* __restrict__ acts0, int64_t n,
            const float* __restrict__ wrow, int rows, float* __restrict__ denom) {
  __shared__ float red[RT / 32];
  for (int64_t i = blockIdx.x * static_cast<int64_t>(RT) + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * RT) {
    acts0[i] = __float2bfloat16(x[i]);
  }
  if (blockIdx.x == 0) {
    float s = 0.f;
    for (int r = threadIdx.x; r < rows; r += RT) s += wrow[r];
    s = block_sum(s, red);
    if (threadIdx.x == 0) denom[0] = s + 1e-9f;
  }
}

// The separate-kernel form of BN forward: one block per CW columns of the
// fp32 ReLU output `a`.
__global__ void __launch_bounds__(CT)
fe_bn_fwd(const float* __restrict__ a, int rows, int d,
          const float* __restrict__ wrow, const float* __restrict__ denom,
          const float* __restrict__ gamma, const float* __restrict__ beta,
          float* __restrict__ rmean, float* __restrict__ rvar,
          float* __restrict__ muvec, float* __restrict__ sdvec,
          bf16* __restrict__ xhat, bf16* __restrict__ act_next, int use_bn,
          float bn_eps, float mom, float omm, float keep,
          const int* __restrict__ seeds, int step, int layer) {
  __shared__ float red[CG][CW + 1];
  const int tx = threadIdx.x % CW, ty = threadIdx.x / CW;
  const int c = blockIdx.x * CW + tx;
  const float den = denom[0];
  float mu = 0.f, sdinv = 1.f, g = 1.f, bt = 0.f;
  if (use_bn) {
    float s = 0.f;
    for (int r = ty; r < rows; r += CG) {
      s += a[static_cast<int64_t>(r) * d + c] * wrow[r];
    }
    mu = col_reduce(s, red, tx, ty) / den;
    float q = 0.f;
    for (int r = ty; r < rows; r += CG) {
      const float t = a[static_cast<int64_t>(r) * d + c] - mu;
      q += (t * t) * wrow[r];
    }
    const float var = col_reduce(q, red, tx, ty) / den;
    sdinv = 1.f / sqrtf(var + bn_eps);
    g = gamma[c];
    bt = beta[c];
    if (ty == 0) {
      muvec[c] = mu;
      sdvec[c] = sdinv;
      rmean[c] = mom * rmean[c] + omm * mu;
      rvar[c] = mom * rvar[c] + omm * var;
    }
  } else if (ty == 0) {
    muvec[c] = 0.f;
    sdvec[c] = 1.f;
  }
  const float thr = bf16_round(-mu * sdinv);  // see xhat_store
  const bool drop = keep < 1.f;
  const uint32_t km = drop ? drop_key(seeds, step, layer) : 0u;
  for (int r = ty; r < rows; r += CG) {
    const int64_t i = static_cast<int64_t>(r) * d + c;
    const float av = a[i];
    float xh = av, out = av;
    if (use_bn) {
      xh = (av - mu) * sdinv;
      out = xh * g + bt;
      xh = xhat_store(xh, av, thr);
    }
    xhat[i] = __float2bfloat16(xh);
    if (drop) out = keep_unit(km, r, c, d, keep) ? out / keep : 0.f;
    act_next[i] = __float2bfloat16(out);
  }
}

// The separate-kernel form of a hidden layer's backward (mode 1: with BN, 2:
// without), one block per CW columns of the fp32 dD. Writes dzb = bf16(dz)
// and runs Adam on b (and, mode 1, on gamma and beta, gamma read before its
// update).
__global__ void __launch_bounds__(CT)
fe_bn_bwd(int mode, const float* __restrict__ dD, int rows, int d,
          const bf16* __restrict__ xhat, const float* __restrict__ wrow,
          const float* __restrict__ denom, SmallRows sm,
          const float* __restrict__ muvec, const float* __restrict__ sdvec,
          bf16* __restrict__ dzb, float keep, const int* __restrict__ seeds,
          int step, int layer, const int* __restrict__ count, AdamArgs ad) {
  __shared__ float red[CG][CW + 1];
  const int tx = threadIdx.x % CW, ty = threadIdx.x / CW;
  const int c = blockIdx.x * CW + tx;
  const float den = denom[0];
  float bc1, bc2;
  bias_corrections(count, step, ad, bc1, bc2);
  const bool drop = keep < 1.f;
  const uint32_t km = drop ? drop_key(seeds, step, layer) : 0u;
  float g = 0.f, s1 = 0.f, s2 = 0.f, sd = 1.f, thr = 0.f;
  if (mode == 1) {
    g = sm.p[0][c];
    float dg = 0.f, dbt = 0.f, a1 = 0.f, a2 = 0.f;
    for (int r = ty; r < rows; r += CG) {
      const int64_t i = static_cast<int64_t>(r) * d + c;
      float v = dD[i];
      if (drop) v = keep_unit(km, r, c, d, keep) ? v / keep : 0.f;
      const float xh = __bfloat162float(xhat[i]);
      dg += v * xh;
      dbt += v;
      const float dxh = v * g;
      a1 += dxh;
      a2 += dxh * xh;
    }
    dg = col_reduce(dg, red, tx, ty);
    dbt = col_reduce(dbt, red, tx, ty);
    s1 = col_reduce(a1, red, tx, ty);
    s2 = col_reduce(a2, red, tx, ty);
    if (ty == 0) {
      adam_col(sm.p[0], sm.p[1], sm.p[2], c, dg, bc1, bc2, ad);
      adam_col(sm.p[3], sm.p[4], sm.p[5], c, dbt, bc1, bc2, ad);
    }
    sd = sdvec[c];
    thr = bf16_round(-muvec[c] * sd);  // see fe_dx_bn
  }
  float db = 0.f;
  for (int r = ty; r < rows; r += CG) {
    const int64_t i = static_cast<int64_t>(r) * d + c;
    float dz = dD[i];
    if (drop) dz = keep_unit(km, r, c, d, keep) ? dz / keep : 0.f;
    const float xh = __bfloat162float(xhat[i]);
    bool pos;
    if (mode == 1) {
      const float dxh = dz * g;
      const float wd = wrow[r] / den;
      dz = sd * (dxh - wd * s1 - wd * xh * s2);
      pos = xh > thr;
    } else {
      pos = xh > 0.f;
    }
    dz = pos ? dz : 0.f;
    db += dz;
    dzb[i] = __float2bfloat16(dz);
  }
  db = col_reduce(db, red, tx, ty);
  if (ty == 0) adam_col(sm.p[6], sm.p[7], sm.p[8], c, db, bc1, bc2, ad);
}

__global__ void fe_count_add(int* count, int n) { count[0] += n; }

bool bad_tiles(int M, int N, int K) {
  return M % kTile || N % kTile || K % kTile || M <= 0 || N <= 0 || K <= 0;
}

bool bad_cluster(int n) { return n != 1 && n != 2 && n != 4 && n != 8; }

// A plain-epilogue GEMM: one block a tile, no cluster.
template <bool AT, bool BT, class Epi>
cudaError_t launch_gemm(const void* A, int lda, const void* B, int ldb, int M,
                        int N, int K, Epi epi, const int* dims, void* stream) {
  LaunchDims d;
  if (bad_tiles(M, N, K) || !read_dims(dims, &d) || !covers_tiles(d, M, N) ||
      d.grid.z != 1 || d.cluster.x != 1 || d.cluster.y != 1 ||
      d.smem < kGemmSmem) {
    return cudaErrorInvalidValue;
  }
  return launch_cluster(fe_gemm<AT, BT, Epi>, d, stream,
                        static_cast<const bf16*>(A), lda,
                        static_cast<const bf16*>(B), ldb, K, epi);
}

// A GEMM with BN in its epilogue: the blocks of a column tile are one cluster
// along the batch (1, 2, 4 or 8 of them), which holds all M rows.
bool batch_cluster_ok(const LaunchDims& d, int M, int N) {
  return covers_tiles(d, M, N) && d.grid.z == 1 && d.cluster.x == 1 &&
         d.cluster.y == d.grid.y && !bad_cluster(d.cluster.y) &&
         d.smem >= kGemmSmem;
}

// A column kernel: one block for every CW columns of a (rows, d) matrix.
bool column_dims_ok(const LaunchDims& ld, int rows, int d) {
  return rows > 0 && d > 0 && ld.grid.x * CW == static_cast<unsigned>(d) &&
         ld.grid.y == 1 && ld.grid.z == 1 && ld.cluster.x == 1;
}

int blocks_for(int64_t n, int threads) {
  const int64_t b = (n + threads - 1) / threads;
  return static_cast<int>(b < 1024 ? (b < 1 ? 1 : b) : 1024);
}

}  // namespace

// Every entry enqueues on `stream` and returns cudaGetLastError() (0 on
// success). Matrices are row-major and contiguous; every matrix dimension is
// a multiple of 64, as the packed state's and the padded batch's are. `dims`
// is the launch as the host's plan states it (LaunchDims: seven ints); an
// entry launches with it and returns cudaErrorInvalidValue if it does not
// cover the matrices or holds less shared memory than the kernel addresses.

extern "C" int asr_fe_cast_bf16(const void* src, void* dst, long long n,
                                void* stream) {
  fe_cast_bf16<<<blocks_for(n, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<bf16*>(dst), n);
  return static_cast<int>(cudaGetLastError());
}

// x (rows, cols) fp32 -> acts0 bf16; denom[0] = sum(wrow[0..rows)) + 1e-9.
extern "C" int asr_fe_prologue(const void* x, void* acts0, const void* wrow,
                               void* denom, int rows, int cols, void* stream) {
  const int64_t n = static_cast<int64_t>(rows) * cols;
  fe_prologue<<<blocks_for(n, RT), RT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<bf16*>(acts0), n,
      static_cast<const float*>(wrow), rows, static_cast<float*>(denom));
  return static_cast<int>(cudaGetLastError());
}

// out (M, N) fp32 = A (M, K) . W (K, N) + bias, then ReLU (n_classes < 0) or
// the -1e9 mask of columns >= n_classes (the logits).
extern "C" int asr_fe_gemm_fwd(const void* a, const void* w, const void* bias,
                               void* out, int M, int N, int K, int n_classes,
                               const int* dims, void* stream) {
  const auto* b = static_cast<const float*>(bias);
  auto* o = static_cast<float*>(out);
  const cudaError_t err =
      n_classes < 0
          ? launch_gemm<false, false>(a, K, w, N, M, N, K, EpiHidden{b, o, N},
                                      dims, stream)
          : launch_gemm<false, false>(a, K, w, N, M, N, K,
                                      EpiLogits{b, o, N, n_classes}, dims,
                                      stream);
  return static_cast<int>(err);
}

// out (M, N) fp32 = dZ (M, K) . W^T, W stored (N, K).
extern "C" int asr_fe_gemm_dx(const void* dz, const void* w, void* out, int M,
                              int N, int K, const int* dims, void* stream) {
  return static_cast<int>(launch_gemm<false, true>(
      dz, K, w, K, M, N, K, EpiStore{static_cast<float*>(out), N}, dims,
      stream));
}

// A hidden layer's forward in one launch (fe_fwd_bn): a (M, K) bf16, w
// (K, N) bf16 -> xhat, act_next (M, N) bf16, mu / sdinv / running statistics
// of the layer's N columns. M / 64 must be 1, 2, 4 or 8 (the cluster).
extern "C" int asr_fe_fwd_bn(const void* a, const void* w, const void* bias,
                             const void* wrow, const void* denom,
                             const void* gamma, const void* beta, void* rmean,
                             void* rvar, void* muvec, void* sdvec, void* xhat,
                             void* act_next, int M, int N, int K, int use_bn,
                             float bn_eps, float mom, float omm, float keep,
                             const void* seeds, int step, int layer,
                             const int* dims, void* stream) {
  LaunchDims d;
  if (bad_tiles(M, N, K) || !read_dims(dims, &d) ||
      !batch_cluster_ok(d, M, N)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FwdArgs p{static_cast<const bf16*>(a),     static_cast<const bf16*>(w),
            static_cast<const float*>(bias), static_cast<const float*>(wrow),
            static_cast<const float*>(denom), static_cast<const float*>(gamma),
            static_cast<const float*>(beta), static_cast<float*>(rmean),
            static_cast<float*>(rvar),       static_cast<float*>(muvec),
            static_cast<float*>(sdvec),      static_cast<bf16*>(xhat),
            static_cast<bf16*>(act_next),    static_cast<const int*>(seeds),
            N, K, use_bn, step, layer, bn_eps, mom, omm, keep};
  return static_cast<int>(launch_cluster(fe_fwd_bn, d, stream, p));
}

// Softmax-CCE of logits (rows, P) fp32 with labels y (rows,) int32 ->
// loss[step], acc[step], dzb (rows, P) bf16, and Adam on the output layer's
// bias (small3: b, m_b, v_b rows). part: rows / 8 * (P + 2) floats of
// scratch; ticket: one zeroed uint32. rows a multiple of 8, P a multiple of
// 128 up to 512.
extern "C" int asr_fe_ce(const void* logits, const void* y, const void* wrow,
                         const void* denom, int rows, int P, void* loss,
                         void* acc, int step, void* dzb, void* part,
                         void* ticket, void* const* small3, const void* count,
                         const AdamArgs* adam, const int* dims, void* stream) {
  LaunchDims d;
  if (rows <= 0 || P <= 0 || P % 128 || P > CE_MAXP || !read_dims(dims, &d) ||
      d.grid.x * CE_ROWS != static_cast<unsigned>(rows) || d.grid.y != 1 ||
      d.grid.z != 1 || d.cluster.x != 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CeArgs p{static_cast<const float*>(logits), static_cast<const int*>(y),
           static_cast<const float*>(wrow),   static_cast<const float*>(denom),
           static_cast<float*>(loss),         static_cast<float*>(acc),
           static_cast<bf16*>(dzb),           static_cast<float*>(part),
           static_cast<unsigned int*>(ticket), static_cast<float*>(small3[0]),
           static_cast<float*>(small3[1]),    static_cast<float*>(small3[2]),
           static_cast<const int*>(count),    rows, P, step, *adam};
  fe_ce<<<d.grid, RT, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// dX (M, N) = dZ (M, K) . W^T (W stored (N, K)) with the backward of the
// layer below (x^ (M, N), mode 1: BN, 2: none) in the epilogue (fe_dx_bn):
// -> dzb (M, N) bf16 and Adam on that layer's gamma, beta, b (`small`: the 9
// row pointers of SmallRows). M / 64 must be 1, 2, 4 or 8.
extern "C" int asr_fe_dx_bn(const void* dz, const void* w, const void* xhat,
                            const void* wrow, const void* denom,
                            void* const* small, const void* muvec,
                            const void* sdvec, void* dzb, int M, int N, int K,
                            int mode, float keep, const void* seeds, int step,
                            int layer, const void* count, const AdamArgs* adam,
                            const int* dims, void* stream) {
  LaunchDims d;
  if (bad_tiles(M, N, K) || mode < 1 || mode > 2 || !read_dims(dims, &d) ||
      !batch_cluster_ok(d, M, N)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DxArgs p{};
  p.dz = static_cast<const bf16*>(dz);
  p.w = static_cast<const bf16*>(w);
  p.xhat = static_cast<const bf16*>(xhat);
  p.wrow = static_cast<const float*>(wrow);
  p.denom = static_cast<const float*>(denom);
  for (int k = 0; k < 9; ++k) p.sm.p[k] = static_cast<float*>(small[k]);
  p.muvec = static_cast<const float*>(muvec);
  p.sdvec = static_cast<const float*>(sdvec);
  p.dzb = static_cast<bf16*>(dzb);
  p.seeds = static_cast<const int*>(seeds);
  p.count = static_cast<const int*>(count);
  p.N = N, p.K = K, p.mode = mode, p.step = step, p.layer = layer;
  p.keep = keep;
  p.adam = *adam;
  return static_cast<int>(launch_cluster(fe_dx_bn, d, stream, p));
}

// dW (M, N) = X^T . dZ with X stored (K, M) and dZ (K, N), fused with the
// Adam update of master/moments (M, N) fp32, NonNeg, and the bf16 copy; the
// depth K is split over clusters of dims' grid z blocks (1, 2, 4 or 8; each
// block's share of K a multiple of 64).
extern "C" int asr_fe_gemm_dw_adam(const void* x, const void* dz, void* mast,
                                   void* mw, void* vw, void* w16, int M, int N,
                                   int K, const void* count, int step,
                                   const AdamArgs* adam, int nonneg,
                                   const int* dims, void* stream) {
  LaunchDims d;
  if (bad_tiles(M, N, K) || !read_dims(dims, &d) || !dw_dims_ok(d, M, N, K)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DwArgs a{static_cast<const bf16*>(x), static_cast<const bf16*>(dz),
           static_cast<float*>(mast),   static_cast<float*>(mw),
           static_cast<float*>(vw),     static_cast<bf16*>(w16),
           M, N, K, static_cast<const int*>(count), step, nullptr, 0, *adam,
           nonneg};
  return static_cast<int>(launch_cluster(fe_dw_adam, d, stream, a));
}

// dW + Adam of every layer in one launch (fe_dw_adam_group): `ptrs` holds six
// pointers a listed layer (x, dz, master, mw, vw, w16, as asr_fe_gemm_dw_adam
// takes them) and `shape` four ints (its layer index, M, N, split), in list
// order; the tiles are listed layer by layer in that order, row-major within
// a layer. Every layer's depth is K; `split` (1, 2, 4 or 8, dividing K / 64)
// is the depth ranks whose sums are added in rank order, as fe_dw_adam's
// cluster adds them. dims: grid (G, 1, 1), G at most the tiles, no cluster.
extern "C" int asr_fe_dw_adam_group(void* const* ptrs, const int* shape,
                                    int n_layers, int K, const void* count,
                                    int step, const AdamArgs* adam,
                                    int nonneg, const int* dims,
                                    void* stream) {
  LaunchDims d;
  if (n_layers < 1 || n_layers > kGroupMaxLayers || !read_dims(dims, &d) ||
      d.grid.y != 1 || d.grid.z != 1 || d.cluster.x != 1 ||
      d.cluster.y != 1 || d.cluster.z != 1 || d.smem < kGroupSmemBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DwGroupArgs a{};
  int tiles = 0;
  for (int j = 0; j < n_layers; ++j) {
    const int* sh = shape + 4 * j;
    const int M = sh[1], N = sh[2], split = sh[3];
    if (bad_tiles(M, N, K) || bad_cluster(split) || (K / kTile) % split) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    void* const* p = ptrs + 6 * j;
    a.L[j] = DwLayer{static_cast<const bf16*>(p[0]),
                     static_cast<const bf16*>(p[1]),
                     static_cast<float*>(p[2]),
                     static_cast<float*>(p[3]),
                     static_cast<float*>(p[4]),
                     static_cast<bf16*>(p[5]),
                     M, N, split, tiles, sh[0]};
    tiles += (M / kTile) * (N / kTile);
  }
  if (d.grid.x > static_cast<unsigned>(tiles)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.n_layers = n_layers;
  a.n_tiles = tiles;
  a.K = K;
  a.count = static_cast<const int*>(count);
  a.step = step;
  a.scales = nullptr;
  a.adam = *adam;
  a.nonneg = nonneg;
  return static_cast<int>(launch_cluster(fe_dw_adam_group, d, stream, a));
}

// BN forward of one hidden layer over a (rows, d) fp32 ReLU output `a`
// (fe_bn_fwd); rmean, rvar, muvec, sdvec, gamma, beta are this layer's rows.
// keep >= 1: no dropout.
extern "C" int asr_fe_bn_fwd(const void* a, int rows, int d, const void* wrow,
                             const void* denom, const void* gamma,
                             const void* beta, void* rmean, void* rvar,
                             void* muvec, void* sdvec, void* xhat,
                             void* act_next, int use_bn, float bn_eps,
                             float mom, float omm, float keep,
                             const void* seeds, int step, int layer,
                             const int* dims, void* stream) {
  LaunchDims ld;
  if (!read_dims(dims, &ld) || !column_dims_ok(ld, rows, d)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  fe_bn_fwd<<<ld.grid, CT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), rows, d, static_cast<const float*>(wrow),
      static_cast<const float*>(denom), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<float*>(rmean),
      static_cast<float*>(rvar), static_cast<float*>(muvec),
      static_cast<float*>(sdvec), static_cast<bf16*>(xhat),
      static_cast<bf16*>(act_next), use_bn, bn_eps, mom, omm, keep,
      static_cast<const int*>(seeds), step, layer);
  return static_cast<int>(cudaGetLastError());
}

// Backward through one hidden layer's BN/ReLU/dropout over the fp32 dD
// (fe_bn_bwd, mode 1 or 2); `small` holds the 9 row pointers of SmallRows.
extern "C" int asr_fe_bn_bwd(int mode, const void* dD, int rows, int d,
                             const void* xhat, const void* wrow,
                             const void* denom, void* const* small,
                             const void* muvec, const void* sdvec, void* dzb,
                             float keep, const void* seeds, int step,
                             int layer, const void* count,
                             const AdamArgs* adam, const int* dims,
                             void* stream) {
  LaunchDims ld;
  if (mode < 1 || mode > 2 || !read_dims(dims, &ld) ||
      !column_dims_ok(ld, rows, d)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SmallRows sm;
  for (int k = 0; k < 9; ++k) sm.p[k] = static_cast<float*>(small[k]);
  fe_bn_bwd<<<ld.grid, CT, 0, static_cast<cudaStream_t>(stream)>>>(
      mode, static_cast<const float*>(dD), rows, d,
      static_cast<const bf16*>(xhat), static_cast<const float*>(wrow),
      static_cast<const float*>(denom), sm, static_cast<const float*>(muvec),
      static_cast<const float*>(sdvec), static_cast<bf16*>(dzb), keep,
      static_cast<const int*>(seeds), step, layer,
      static_cast<const int*>(count), *adam);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int asr_fe_count_add(void* count, int n, void* stream) {
  fe_count_add<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(count), n);
  return static_cast<int>(cudaGetLastError());
}

// The constants the host's launch plan mirrors, so that a check on the device
// can hold the mirror to the build: out[0..10) = tile, ring stages, rows a
// CCE block, widest class dimension, columns a column-kernel block, dynamic
// bytes of a GEMM block, of a dW block, threads of a cluster-kernel block,
// dynamic bytes of a grouped dW block, layers a grouped launch lists at most;
// out[10..17) = static shared-memory bytes of fe_fwd_bn, fe_dx_bn,
// fe_dw_adam, fe_ce, fe_bn_fwd, fe_bn_bwd, fe_dw_adam_group as compiled.
extern "C" int asr_fe_geometry(int* out) {
  const int head[] = {kTile,     kStages,      CE_ROWS,  CE_MAXP,
                      CW,        kGemmSmem,    kDwSmemBytes, kThreads,
                      kGroupSmemBytes, kGroupMaxLayers};
  for (int k = 0; k < 10; ++k) out[k] = head[k];
  const void* fns[] = {reinterpret_cast<const void*>(fe_fwd_bn),
                       reinterpret_cast<const void*>(fe_dx_bn),
                       reinterpret_cast<const void*>(fe_dw_adam),
                       reinterpret_cast<const void*>(fe_ce),
                       reinterpret_cast<const void*>(fe_bn_fwd),
                       reinterpret_cast<const void*>(fe_bn_bwd),
                       reinterpret_cast<const void*>(fe_dw_adam_group)};
  for (int k = 0; k < 7; ++k) {
    cudaFuncAttributes a;
    const cudaError_t err = cudaFuncGetAttributes(&a, fns[k]);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[10 + k] = static_cast<int>(a.sharedSizeBytes);
  }
  return 0;
}

// Loads every kernel of this library into the current context and opts the
// GEMM kernels in to their dynamic shared memory, so that a later CUDA-graph
// capture does neither. Writes to *max_clusters how many 8-block clusters of
// the hungriest cluster kernel the device can hold at once; 0 means such a
// cluster can never be scheduled, and the caller must not launch one.
extern "C" int asr_fe_preload(int* max_clusters) {
  int n = 1 << 30;
  cudaError_t err;
  const dim3 one(1, 1, 1);
  int ignore = 1 << 30;
  err = prepare_kernel(fe_gemm<false, false, EpiHidden>, kGemmSmem, one, &ignore);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = prepare_kernel(fe_gemm<false, false, EpiLogits>, kGemmSmem, one, &ignore);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = prepare_kernel(fe_gemm<false, true, EpiStore>, kGemmSmem, one, &ignore);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = prepare_kernel(fe_fwd_bn, kGemmSmem, dim3(1, 8, 1), &n);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = prepare_kernel(fe_dx_bn, kGemmSmem, dim3(1, 8, 1), &n);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = prepare_kernel(fe_dw_adam, kDwSmemBytes, dim3(1, 1, 8), &n);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = prepare_kernel(fe_dw_adam_group, kGroupSmemBytes, one, &ignore);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes a;
  const void* fns[] = {reinterpret_cast<const void*>(fe_cast_bf16),
                       reinterpret_cast<const void*>(fe_prologue),
                       reinterpret_cast<const void*>(fe_bn_fwd),
                       reinterpret_cast<const void*>(fe_ce),
                       reinterpret_cast<const void*>(fe_bn_bwd),
                       reinterpret_cast<const void*>(fe_count_add)};
  for (const void* fn : fns) {
    err = cudaFuncGetAttributes(&a, fn);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  *max_clusters = n;
  return 0;
}
