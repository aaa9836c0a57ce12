// K3 on Hopper: the kernels of one fused constrained training step.
//
// Replaces asr_using_robust_nn_tpu/ops/pallas_train.py::_make_epoch_kernel,
// the Pallas TPU kernel that runs a whole epoch as one pallas_call with a
// grid over the steps. Each step: bf16 forward (Dense + bias + ReLU,
// row-weighted BatchNorm that also moves the running statistics, dropout),
// softmax-CCE with row weights, the manual backward (BN backward included,
// the dropout mask regenerated, not stored), Adam on fp32 masters and
// moments, the NonNeg clamp and the simple_norm projection (K2's kernels,
// csrc/product_power_iter.cu) with its eager rescale.
//
// Design: several kernels per step, enqueued by ops/cuda_train.py on one
// stream for all n_batches steps and captured once per (spec, n_batches)
// into one CUDA graph, which each epoch replays. A single persistent kernel
// would need a grid-wide barrier between every dependent phase of a step
// (~20 per step plus ~200 for the power iteration) and one register/shared
// memory budget for GEMMs and reductions alike; the graph keeps each kernel
// simple and lets its launch configuration fit its shape. No kernel
// allocates, synchronizes with the host or reads a host value at run time:
// the step index is a launch argument, the dropout seed, the Adam count and
// the batch live in device buffers. The whole training state (~23 MB of fp32
// masters, moments and bf16 copies at the digit widths) stays in the 50 MB L2
// between kernels.
//
// What bounds it on an H100: at batch 512 a step is ~4 GFLOP in bf16 GEMMs
// (forward, dX, dW), tens of microseconds at tensor-core rates, so the step
// is bounded by the chain of small dependent kernels (launch latency, the
// under-filled grids of the narrow layers and the power iteration's ~200
// dependent matvecs), not by bytes or FLOPs.
//
// Kernels:
//  * gemm_bf16: C = A . B with bf16 operands on the tensor cores (WMMA
//    m16n16k16, fp32 accumulators), 64x64x32 block tiles staged in shared
//    memory, 4 warps of 32x32. Operand layouts cover the three products of
//    a step: forward X.W, dX = dZ.W^T, dW = X^T.dZ. Fused epilogues: bias +
//    ReLU (hidden layers), bias + class mask (logits), plain store (dX), and
//    the whole Adam + NonNeg + bf16 copy update of a weight (dW).
//  * fe_bn_fwd: per 32-column slab, the weighted batch mean and (two-pass)
//    variance, the running statistics, x^ and the layer output with dropout,
//    stored as bf16 for the backward pass.
//  * fe_ce: softmax-CCE, accuracy and dZ of the logits, one block.
//  * fe_bn_bwd: per 32-column slab, dropout backward, dgamma/dbeta and the
//    BN backward, the ReLU mask from the stored x^, db, and the Adam updates
//    of gamma, beta and b; writes dZ in bf16 for the two GEMMs. The mask
//    compares the bf16 x^ with the bf16-rounded threshold -mu * sdinv: the
//    Pallas kernel's fp32 threshold lets about half the dead units (a = 0,
//    whose bf16 x^ rounds above it) pass gradient.
//
// Dropout: a counter-based integer hash (lowbias32, two rounds) of the
// step's seed + layer and the unit's index row * width + col; the unit is
// kept when (h >> 8) * 2^-24 < keep. ops/cuda_train.py computes the same hash
// with torch integer ops, so kernel and plain twin drop the same units.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

#include "adam_common.cuh"  // AdamArgs, bias_corrections, adam_step

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int GM = 64, GN = 64, GK = 32;  // GEMM block tile
constexpr int GT = 128;                   // GEMM threads: 4 warps of 32x32
constexpr int CT = 256;                   // column kernels: 32 cols x 8 rows
constexpr int RT = 256;                   // row / reduction kernels

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

// Column total over the 8 row groups of a CT block (thread (ty, tx) holds
// the partial of rows ty, ty+8, ... of column tx).
__device__ __forceinline__ float col_reduce(float v, float (*red)[33], int tx,
                                            int ty) {
  red[ty][tx] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int k = 0; k < CT / 32; ++k) t += red[k][tx];
  __syncthreads();
  return t;
}

// ---- GEMM ----------------------------------------------------------------

// AT: A is stored (K, lda) and read transposed; else (M, lda).
// BT: B is stored (N, ldb) and read transposed; else (K, ldb).
template <bool AT, bool BT>
struct GemmSmem {
  bf16 a[AT ? GK : GM][(AT ? GM : GK) + 8];
  bf16 b[BT ? GN : GK][(BT ? GK : GN) + 8];
  float c[GM][GN + 4];
};

template <bool AT, bool BT>
__device__ __forceinline__ void load_tiles(GemmSmem<AT, BT>& s,
                                           const bf16* __restrict__ A, int lda,
                                           const bf16* __restrict__ B, int ldb,
                                           int m0, int n0, int k0) {
  const int tid = threadIdx.x;
  if constexpr (!AT) {
    for (int e = tid; e < GM * (GK / 8); e += GT) {
      const int r = e / (GK / 8), ch = e % (GK / 8);
      *reinterpret_cast<uint4*>(&s.a[r][ch * 8]) = *reinterpret_cast<const uint4*>(
          A + static_cast<int64_t>(m0 + r) * lda + k0 + ch * 8);
    }
  } else {
    for (int e = tid; e < GK * (GM / 8); e += GT) {
      const int r = e / (GM / 8), ch = e % (GM / 8);
      *reinterpret_cast<uint4*>(&s.a[r][ch * 8]) = *reinterpret_cast<const uint4*>(
          A + static_cast<int64_t>(k0 + r) * lda + m0 + ch * 8);
    }
  }
  if constexpr (!BT) {
    for (int e = tid; e < GK * (GN / 8); e += GT) {
      const int r = e / (GN / 8), ch = e % (GN / 8);
      *reinterpret_cast<uint4*>(&s.b[r][ch * 8]) = *reinterpret_cast<const uint4*>(
          B + static_cast<int64_t>(k0 + r) * ldb + n0 + ch * 8);
    }
  } else {
    for (int e = tid; e < GN * (GK / 8); e += GT) {
      const int r = e / (GK / 8), ch = e % (GK / 8);
      *reinterpret_cast<uint4*>(&s.b[r][ch * 8]) = *reinterpret_cast<const uint4*>(
          B + static_cast<int64_t>(n0 + r) * ldb + k0 + ch * 8);
    }
  }
}

template <bool AT, bool BT, class Epi>
__global__ void __launch_bounds__(GT)
gemm_bf16(const bf16* __restrict__ A, int lda, const bf16* __restrict__ B,
          int ldb, int K, Epi epi) {
  __shared__ __align__(128) GemmSmem<AT, BT> s;
  using LA = std::conditional_t<AT, wmma::col_major, wmma::row_major>;
  using LB = std::conditional_t<BT, wmma::col_major, wmma::row_major>;
  const int m0 = blockIdx.y * GM, n0 = blockIdx.x * GN;
  const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += GK) {
    load_tiles<AT, BT>(s, A, lda, B, ldb, m0, n0, k0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm * 32 + i * 16;
        if constexpr (!AT) {
          wmma::load_matrix_sync(fa[i], &s.a[r][kk], GK + 8);
        } else {
          wmma::load_matrix_sync(fa[i], &s.a[kk][r], GM + 8);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = wn * 32 + j * 16;
        if constexpr (!BT) {
          wmma::load_matrix_sync(fb[j], &s.b[kk][c], GN + 8);
        } else {
          wmma::load_matrix_sync(fb[j], &s.b[c][kk], GK + 8);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&s.c[wm * 32 + i * 16][wn * 32 + j * 16],
                              acc[i][j], GN + 4, wmma::mem_row_major);
  __syncthreads();
  epi.prepare();
  for (int e = threadIdx.x; e < GM * GN; e += GT) {
    const int r = e / GN, c = e % GN;
    epi(m0 + r, n0 + c, s.c[r][c]);
  }
}

struct EpiHidden {  // out = relu(v + bias)
  const float* bias;
  float* out;
  int ld;
  __device__ void prepare() {}
  __device__ void operator()(int m, int n, float v) const {
    out[static_cast<int64_t>(m) * ld + n] = fmaxf(v + bias[n], 0.f);
  }
};

struct EpiLogits {  // out = v + bias, -1e9 past the true classes
  const float* bias;
  float* out;
  int ld, n_classes;
  __device__ void prepare() {}
  __device__ void operator()(int m, int n, float v) const {
    out[static_cast<int64_t>(m) * ld + n] = n >= n_classes ? -1e9f : v + bias[n];
  }
};

struct EpiStore {
  float* out;
  int ld;
  __device__ void prepare() {}
  __device__ void operator()(int m, int n, float v) const {
    out[static_cast<int64_t>(m) * ld + n] = v;
  }
};

struct EpiAdam {  // v is dW[m, n]: Adam, NonNeg, bf16 copy of the weight
  float* mast;
  float* mw;
  float* vw;
  bf16* w16;
  int ld;
  const int* count;
  int step;
  AdamArgs a;
  int nonneg;
  float bc1, bc2;
  __device__ void prepare() { bias_corrections(count, step, a, bc1, bc2); }
  __device__ void operator()(int m, int n, float g) const {
    const int64_t i = static_cast<int64_t>(m) * ld + n;
    float p = mast[i], mm = mw[i], vv = vw[i];
    adam_step(p, mm, vv, g, bc1, bc2, a);
    if (nonneg) p = fmaxf(p, 0.f);
    mast[i] = p;
    mw[i] = mm;
    vw[i] = vv;
    w16[i] = __float2bfloat16(p);
  }
};

// ---- elementwise, column and row kernels ----------------------------------

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

__global__ void __launch_bounds__(CT)
fe_bn_fwd(const float* __restrict__ a, int rows, int d,
          const float* __restrict__ wrow, const float* __restrict__ denom,
          const float* __restrict__ gamma, const float* __restrict__ beta,
          float* __restrict__ rmean, float* __restrict__ rvar,
          float* __restrict__ muvec, float* __restrict__ sdvec,
          bf16* __restrict__ xhat, bf16* __restrict__ act_next, int use_bn,
          float bn_eps, float mom, float omm, float keep,
          const int* __restrict__ seeds, int step, int layer) {
  __shared__ float red[CT / 32][33];
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + tx;
  const float den = denom[0];
  float mu = 0.f, sdinv = 1.f, g = 1.f, bt = 0.f;
  if (use_bn) {
    float s = 0.f;
    for (int r = ty; r < rows; r += CT / 32) {
      s += a[static_cast<int64_t>(r) * d + c] * wrow[r];
    }
    mu = col_reduce(s, red, tx, ty) / den;
    float q = 0.f;
    for (int r = ty; r < rows; r += CT / 32) {
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
  const bool drop = keep < 1.f;
  const uint32_t km =
      drop ? mix32(static_cast<uint32_t>(seeds[step]) + static_cast<uint32_t>(layer)) : 0u;
  for (int r = ty; r < rows; r += CT / 32) {
    const int64_t i = static_cast<int64_t>(r) * d + c;
    const float av = a[i];
    float xh = av, out = av;
    if (use_bn) {
      xh = (av - mu) * sdinv;
      out = xh * g + bt;
    }
    xhat[i] = __float2bfloat16(xh);
    if (drop) out = keep_unit(km, r, c, d, keep) ? out / keep : 0.f;
    act_next[i] = __float2bfloat16(out);
  }
}

// One block: per row softmax, CCE, argmax; the step's weighted loss and
// accuracy; dz = (softmax - onehot) * w / denom.
__global__ void __launch_bounds__(RT)
fe_ce(const float* __restrict__ logits, const int* __restrict__ y,
      const float* __restrict__ wrow, const float* __restrict__ denom,
      int rows, int P, float* __restrict__ loss, float* __restrict__ acc,
      int step, float* __restrict__ dz) {
  __shared__ float red[RT / 32];
  const float den = denom[0];
  float lsum = 0.f, asum = 0.f;
  for (int r = threadIdx.x; r < rows; r += RT) {
    const float* lr = logits + static_cast<int64_t>(r) * P;
    float zmax = lr[0];
    int arg = 0;
    for (int n = 1; n < P; ++n) {
      if (lr[n] > zmax) {
        zmax = lr[n];
        arg = n;
      }
    }
    float sez = 0.f;
    for (int n = 0; n < P; ++n) sez += expf(lr[n] - zmax);
    const int yr = y[r];
    const float w = wrow[r];
    const float nll = -((lr[yr] - zmax) - logf(sez));
    lsum += nll * w;
    asum += (arg == yr ? 1.f : 0.f) * w;
    float* dzr = dz + static_cast<int64_t>(r) * P;
    for (int n = 0; n < P; ++n) {
      const float p = expf(lr[n] - zmax) / sez;
      dzr[n] = ((p - (n == yr ? 1.f : 0.f)) * w) / den;
    }
  }
  lsum = block_sum(lsum, red);
  asum = block_sum(asum, red);
  if (threadIdx.x == 0) {
    loss[step] = lsum / den;
    acc[step] = asum / den;
  }
}

// mode 0: the output layer (dz = dD); 1: hidden layer with BN; 2: hidden
// layer without BN. Writes dzb = bf16(dz) and runs Adam on b (and, mode 1,
// on gamma and beta, gamma read before its update).
__global__ void __launch_bounds__(CT)
fe_bn_bwd(int mode, const float* __restrict__ dD, int rows, int d,
          const bf16* __restrict__ xhat, const float* __restrict__ wrow,
          const float* __restrict__ denom, SmallRows sm,
          const float* __restrict__ muvec, const float* __restrict__ sdvec,
          bf16* __restrict__ dzb, float keep, const int* __restrict__ seeds,
          int step, int layer, const int* __restrict__ count, AdamArgs ad) {
  __shared__ float red[CT / 32][33];
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + tx;
  const float den = denom[0];
  float bc1, bc2;
  bias_corrections(count, step, ad, bc1, bc2);
  const bool drop = mode != 0 && keep < 1.f;
  const uint32_t km =
      drop ? mix32(static_cast<uint32_t>(seeds[step]) + static_cast<uint32_t>(layer)) : 0u;
  float g = 0.f, s1 = 0.f, s2 = 0.f, sd = 1.f, thr = 0.f;
  if (mode == 1) {
    g = sm.p[0][c];
    float dg = 0.f, dbt = 0.f, a1 = 0.f, a2 = 0.f;
    for (int r = ty; r < rows; r += CT / 32) {
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
    // a > 0 <=> x^ > -mu * sdinv. x^ is stored in bf16, so the threshold is
    // rounded the same way (a dead unit's x^ then equals it exactly).
    thr = __bfloat162float(__float2bfloat16(-muvec[c] * sd));
  }
  float db = 0.f;
  for (int r = ty; r < rows; r += CT / 32) {
    const int64_t i = static_cast<int64_t>(r) * d + c;
    float dz = dD[i];
    if (mode != 0) {
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
    }
    db += dz;
    dzb[i] = __float2bfloat16(dz);
  }
  db = col_reduce(db, red, tx, ty);
  if (ty == 0) adam_col(sm.p[6], sm.p[7], sm.p[8], c, db, bc1, bc2, ad);
}

__global__ void fe_count_add(int* count, int n) { count[0] += n; }

template <bool AT, bool BT, class Epi>
cudaError_t launch_gemm(const void* A, int lda, const void* B, int ldb, int M,
                        int N, int K, Epi epi, void* stream) {
  if (M % GM || N % GN || K % GK || M <= 0 || N <= 0 || K <= 0) {
    return cudaErrorInvalidValue;
  }
  gemm_bf16<AT, BT, Epi><<<dim3(N / GN, M / GM), GT, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(A), lda, static_cast<const bf16*>(B), ldb, K,
      epi);
  return cudaGetLastError();
}

int blocks_for(int64_t n, int threads) {
  const int64_t b = (n + threads - 1) / threads;
  return static_cast<int>(b < 1024 ? (b < 1 ? 1 : b) : 1024);
}

}  // namespace

// Every entry enqueues on `stream` and returns cudaGetLastError() (0 on
// success). Matrices are row-major and contiguous; widths must be multiples
// of 64 (columns) and 32 (GEMM depth), as the packed state's are.

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

// out (M, N) = A (M, K) . W (K, N) + bias, then ReLU (n_classes < 0) or the
// -1e9 mask of columns >= n_classes (the logits).
extern "C" int asr_fe_gemm_fwd(const void* a, const void* w, const void* bias,
                               void* out, int M, int N, int K, int n_classes,
                               void* stream) {
  const auto* b = static_cast<const float*>(bias);
  auto* o = static_cast<float*>(out);
  const cudaError_t err =
      n_classes < 0
          ? launch_gemm<false, false>(a, K, w, N, M, N, K, EpiHidden{b, o, N}, stream)
          : launch_gemm<false, false>(a, K, w, N, M, N, K,
                                      EpiLogits{b, o, N, n_classes}, stream);
  return static_cast<int>(err);
}

// out (M, N) = dZ (M, K) . W^T, W stored (N, K).
extern "C" int asr_fe_gemm_dx(const void* dz, const void* w, void* out, int M,
                              int N, int K, void* stream) {
  return static_cast<int>(launch_gemm<false, true>(
      dz, K, w, K, M, N, K, EpiStore{static_cast<float*>(out), N}, stream));
}

// dW (M, N) = X^T . dZ with X stored (K, M) and dZ (K, N), fused with the
// Adam update of master/moments (M, N) fp32, NonNeg, and the bf16 copy.
extern "C" int asr_fe_gemm_dw_adam(const void* x, const void* dz, void* mast,
                                   void* mw, void* vw, void* w16, int M, int N,
                                   int K, const void* count, int step,
                                   const AdamArgs* adam, int nonneg,
                                   void* stream) {
  EpiAdam epi{static_cast<float*>(mast), static_cast<float*>(mw),
              static_cast<float*>(vw),   static_cast<bf16*>(w16),
              N,                         static_cast<const int*>(count),
              step,                      *adam,
              nonneg,                    0.f,
              0.f};
  return static_cast<int>(
      launch_gemm<true, false>(x, M, dz, N, M, N, K, epi, stream));
}

// BN forward of one hidden layer over a (rows, d) ReLU output `a`; rmean,
// rvar, muvec, sdvec, gamma, beta are this layer's rows. keep >= 1: no
// dropout.
extern "C" int asr_fe_bn_fwd(const void* a, int rows, int d, const void* wrow,
                             const void* denom, const void* gamma,
                             const void* beta, void* rmean, void* rvar,
                             void* muvec, void* sdvec, void* xhat,
                             void* act_next, int use_bn, float bn_eps,
                             float mom, float omm, float keep,
                             const void* seeds, int step, int layer,
                             void* stream) {
  if (d % 32 || d <= 0 || rows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  fe_bn_fwd<<<d / 32, CT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), rows, d, static_cast<const float*>(wrow),
      static_cast<const float*>(denom), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<float*>(rmean),
      static_cast<float*>(rvar), static_cast<float*>(muvec),
      static_cast<float*>(sdvec), static_cast<bf16*>(xhat),
      static_cast<bf16*>(act_next), use_bn, bn_eps, mom, omm, keep,
      static_cast<const int*>(seeds), step, layer);
  return static_cast<int>(cudaGetLastError());
}

// logits (rows, P), labels y (rows,) int32 -> loss[step], acc[step], dz.
extern "C" int asr_fe_ce(const void* logits, const void* y, const void* wrow,
                         const void* denom, int rows, int P, void* loss,
                         void* acc, int step, void* dz, void* stream) {
  fe_ce<<<1, RT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const int*>(y),
      static_cast<const float*>(wrow), static_cast<const float*>(denom), rows,
      P, static_cast<float*>(loss), static_cast<float*>(acc), step,
      static_cast<float*>(dz));
  return static_cast<int>(cudaGetLastError());
}

// Backward through one layer's BN/ReLU/dropout (see fe_bn_bwd); `small`
// holds the 9 row pointers of SmallRows.
extern "C" int asr_fe_bn_bwd(int mode, const void* dD, int rows, int d,
                             const void* xhat, const void* wrow,
                             const void* denom, void* const* small,
                             const void* muvec, const void* sdvec, void* dzb,
                             float keep, const void* seeds, int step,
                             int layer, const void* count,
                             const AdamArgs* adam, void* stream) {
  if (d % 32 || d <= 0 || rows <= 0 || mode < 0 || mode > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SmallRows sm;
  for (int k = 0; k < 9; ++k) sm.p[k] = static_cast<float*>(small[k]);
  fe_bn_bwd<<<d / 32, CT, 0, static_cast<cudaStream_t>(stream)>>>(
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

// Loads every kernel of this library into the current context, so that a
// later CUDA-graph capture does not load modules lazily.
extern "C" int asr_fe_preload() {
  cudaFuncAttributes a;
  const void* fns[] = {
      reinterpret_cast<const void*>(gemm_bf16<false, false, EpiHidden>),
      reinterpret_cast<const void*>(gemm_bf16<false, false, EpiLogits>),
      reinterpret_cast<const void*>(gemm_bf16<false, true, EpiStore>),
      reinterpret_cast<const void*>(gemm_bf16<true, false, EpiAdam>),
      reinterpret_cast<const void*>(fe_cast_bf16),
      reinterpret_cast<const void*>(fe_prologue),
      reinterpret_cast<const void*>(fe_bn_fwd),
      reinterpret_cast<const void*>(fe_ce),
      reinterpret_cast<const void*>(fe_bn_bwd),
      reinterpret_cast<const void*>(fe_count_add)};
  for (const void* fn : fns) {
    const cudaError_t err = cudaFuncGetAttributes(&a, fn);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
