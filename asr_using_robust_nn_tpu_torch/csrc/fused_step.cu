// K6 on Hopper: the kernels that set one per-step fused train step apart
// from a step of the fused epoch (K3, fused_epoch.cu).
//
// Replaces asr_using_robust_nn_tpu/ops/pallas_train.py::_make_kernel, the
// Pallas TPU kernel that runs ONE constrained train step per pallas_call:
// the bf16 compute copies of the kernels are state carried from call to
// call, Adam streams the fp32 masters and moments through fast memory tile
// by tile while the dW tile is computed, and the simple_norm rescale touches
// only the bf16 copies: its per-layer factors are written to `scales` and
// the fp32 masters absorb them at the NEXT step's Adam load ("deferred
// scales"), so the rescale never reads or writes the masters.
//
// A K6 step is K3's step program with two operations swapped, so the forward
// GEMMs, BN forward/backward, the CCE, dX (fused_epoch.cu) and the power
// iteration's links (product_power_iter.cu) are the same compiled functions
// K3 launches. New here:
//
//  * fs_dw_adam: dW tile = X^T . dZ on the tensor cores (WMMA m16n16k16,
//    bf16 operands, fp32 sums, 64x64 tile per block of 4 warps) fused with
//    the streamed Adam update. The block first starts cp.async copies of its
//    64x64 tiles of the master and both moments (48 KB) into shared memory,
//    then runs the whole MMA loop while they are in flight, and waits for
//    them only before the epilogue: the counterpart of the TPU kernel's three
//    tile DMAs started before its dot and awaited after it. The epilogue
//    reads the master as master * scales[layer] (the previous step's factor,
//    read from device memory so the launch can sit in a CUDA graph), applies
//    Adam with t = count[0] + 1 from the device count, the NonNeg clamp, and
//    writes master, moments and the bf16 copy. The operand tiles themselves
//    are staged with plain loads (they sit in L2; not asynchronous yet).
//  * fs_rescale: the deferred rescale of all layers in one launch. Every
//    block recomputes the scalar recurrence f_i = exp(log(rho / (s_i + eps))
//    / m), s_{i+1} = s_i * f_i from the device sigma up to its own layer (a
//    few expf/logf; all blocks agree bit for bit), multiplies its slice of
//    the layer's bf16 kernel, w16 <- bf16(fp32(w16) * f_i), and block 0 of
//    each layer writes scales[i] = f_i (the first layer's also the unused
//    lanes = 1). The masters are not touched.
//  * fs_fill_ones: scales <- 1 after an unconstrained step (the incoming
//    factors were folded by that step's Adam loads).
//
// What bounds it on an H100: a step moves ~48 MB of state (three fp32
// arrays and the bf16 copies, in and out) and does ~5 GFLOP, tens of
// microseconds of bytes or tensor-core time, but runs as ~20 dependent
// phases plus ~200 power-iteration links, so launch latency and under-filled
// grids bound it, as they do K3. ops/cuda_step.py captures the step once per
// (spec, device) into a CUDA graph and replays it per call.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <atomic>
#include <cstdint>

#include "adam_common.cuh"  // AdamArgs, bias_corrections, adam_step

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int TM = 64, TN = 64, TK = 32;  // dW block tile and depth step
constexpr int NT = 128;                   // 4 warps of 32x32
constexpr int kMaxLayers = 16;
constexpr int kScaleLanes = 128;          // width of the `scales` row
constexpr int kMaxDevices = 64;

struct StepSmem {
  float st[3][TM][TN];  // master, m, v tiles: the cp.async destinations
  bf16 a[TK][TM + 8];   // X tile, depth-major (read transposed)
  bf16 b[TK][TN + 8];   // dZ tile
  float c[TM][TN + 4];  // the dW tile out of the accumulators
};

__global__ void __launch_bounds__(NT)
fs_dw_adam(const bf16* __restrict__ X, const bf16* __restrict__ dZ,
           float* master, float* mw, float* vw, bf16* __restrict__ w16, int M,
           int N, int K, const int* __restrict__ count,
           const float* __restrict__ scales, int layer, AdamArgs ad,
           int nonneg) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  StepSmem& s = *reinterpret_cast<StepSmem*>(smem_raw);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;

  // the three state tiles start their way to shared memory now
  float* const state[3] = {master, mw, vw};
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    for (int e = tid; e < TM * (TN / 4); e += NT) {
      const int r = e / (TN / 4), ch = e % (TN / 4);
      __pipeline_memcpy_async(
          &s.st[t][r][ch * 4],
          state[t] + static_cast<int64_t>(m0 + r) * N + n0 + ch * 4, 16);
    }
  }
  __pipeline_commit();

  const int warp = tid / 32, wm = warp / 2, wn = warp % 2;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += TK) {
    for (int e = tid; e < TK * (TM / 8); e += NT) {
      const int r = e / (TM / 8), ch = e % (TM / 8);
      *reinterpret_cast<uint4*>(&s.a[r][ch * 8]) = *reinterpret_cast<const uint4*>(
          X + static_cast<int64_t>(k0 + r) * M + m0 + ch * 8);
    }
    for (int e = tid; e < TK * (TN / 8); e += NT) {
      const int r = e / (TN / 8), ch = e % (TN / 8);
      *reinterpret_cast<uint4*>(&s.b[r][ch * 8]) = *reinterpret_cast<const uint4*>(
          dZ + static_cast<int64_t>(k0 + r) * N + n0 + ch * 8);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &s.a[kk][wm * 32 + i * 16], TM + 8);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &s.b[kk][wn * 32 + j * 16], TN + 8);
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
                              acc[i][j], TN + 4, wmma::mem_row_major);
  __pipeline_wait_prior(0);  // this thread's copies have landed ...
  __syncthreads();           // ... and every other thread's

  float bc1, bc2;
  bias_corrections(count, 0, ad, bc1, bc2);
  const float s_prev = scales[layer];
  for (int e = tid; e < TM * TN; e += NT) {
    const int r = e / TN, c = e % TN;
    float p = s.st[0][r][c] * s_prev;  // the deferred factor, folded at load
    float mm = s.st[1][r][c], vv = s.st[2][r][c];
    adam_step(p, mm, vv, s.c[r][c], bc1, bc2, ad);
    if (nonneg) p = fmaxf(p, 0.f);
    const int64_t i = static_cast<int64_t>(m0 + r) * N + n0 + c;
    master[i] = p;
    mw[i] = mm;
    vw[i] = vv;
    w16[i] = __float2bfloat16(p);
  }
}

struct LayerTable {
  bf16* w[kMaxLayers];
  long long n[kMaxLayers];
};

__global__ void fs_rescale(LayerTable t, int m, const float* __restrict__ sigma,
                           float* __restrict__ scales, float rho, float eps,
                           float inv_m) {
  const int layer = blockIdx.y;
  float sg = sigma[0], f = 1.f;
  for (int i = 0; i <= layer; ++i) {
    f = expf(logf(rho / (sg + eps)) * inv_m);
    sg = sg * f;
  }
  if (blockIdx.x == 0) {
    if (threadIdx.x == 0) scales[layer] = f;
    if (layer == 0) {
      for (int i = m + threadIdx.x; i < kScaleLanes; i += blockDim.x) {
        scales[i] = 1.f;
      }
    }
  }
  bf16* w = t.w[layer];
  const int64_t n = t.n[layer];
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    w[i] = __float2bfloat16(__bfloat162float(w[i]) * f);
  }
}

__global__ void fs_fill_ones(float* p, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) p[i] = 1.f;
}

// The shared-memory opt-in of fs_dw_adam is per device: set at the first use
// on each one. Setting it twice from racing threads is harmless.
cudaError_t ensure_smem_opt_in() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(fs_dw_adam,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(sizeof(StepSmem)));
    if (err != cudaSuccess) return err;
    done[dev].store(true, std::memory_order_release);
  }
  return cudaSuccess;
}

}  // namespace

// Every entry enqueues on `stream` and returns cudaGetLastError() (0 on
// success); nothing allocates or synchronizes.

// dW (M, N) = X^T . dZ with X stored (K, M) bf16 and dZ (K, N) bf16, fused
// with Adam on master * scales[layer] and the moments (M, N) fp32, NonNeg,
// and the bf16 copy. M, N multiples of 64, K of 32. count (1,) int32 and
// scales (>= layer + 1,) fp32 are device memory.
extern "C" int asr_fs_dw_adam(const void* x, const void* dz, void* mast,
                              void* mw, void* vw, void* w16, int M, int N,
                              int K, const void* count, const void* scales,
                              int layer, const AdamArgs* adam, int nonneg,
                              void* stream) {
  if (M % TM || N % TN || K % TK || M <= 0 || N <= 0 || K <= 0 || layer < 0 ||
      layer >= kScaleLanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = ensure_smem_opt_in();
  if (err != cudaSuccess) return static_cast<int>(err);
  fs_dw_adam<<<dim3(N / TN, M / TM), NT, sizeof(StepSmem),
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dz),
      static_cast<float*>(mast), static_cast<float*>(mw),
      static_cast<float*>(vw), static_cast<bf16*>(w16), M, N, K,
      static_cast<const int*>(count), static_cast<const float*>(scales), layer,
      *adam, nonneg);
  return static_cast<int>(cudaGetLastError());
}

// The deferred simple_norm rescale: ws[i] (numels[i] bf16 values) <-
// bf16(fp32(ws[i]) * f_i) for i < m, scales[i] = f_i, scales[m..128) = 1,
// with f from sigma (1,) fp32 in device memory. m <= 16.
extern "C" int asr_fs_rescale(void* const* ws, const long long* numels, int m,
                              const void* sigma, void* scales, float rho,
                              float eps, float inv_m, void* stream) {
  if (m < 1 || m > kMaxLayers || !(rho > 0.f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LayerTable t;
  for (int i = 0; i < m; ++i) {
    t.w[i] = static_cast<bf16*>(ws[i]);
    t.n[i] = numels[i];
  }
  fs_rescale<<<dim3(128, m), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      t, m, static_cast<const float*>(sigma), static_cast<float*>(scales), rho,
      eps, inv_m);
  return static_cast<int>(cudaGetLastError());
}

// scales[0..128) = 1.
extern "C" int asr_fs_scales_one(void* scales, void* stream) {
  fs_fill_ones<<<1, kScaleLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(scales), kScaleLanes);
  return static_cast<int>(cudaGetLastError());
}

// Loads every kernel of this library into the current context and sets the
// shared-memory opt-in, so that a later CUDA-graph capture does neither.
extern "C" int asr_fs_preload() {
  cudaError_t err = ensure_smem_opt_in();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes a;
  const void* fns[] = {reinterpret_cast<const void*>(fs_dw_adam),
                       reinterpret_cast<const void*>(fs_rescale),
                       reinterpret_cast<const void*>(fs_fill_ones)};
  for (const void* fn : fns) {
    err = cudaFuncGetAttributes(&a, fn);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
