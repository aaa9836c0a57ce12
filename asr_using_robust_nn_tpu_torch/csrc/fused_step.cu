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
// A K6 step is K3's step program with two operations swapped, so the fused
// forward (fe_fwd_bn), the CCE, dX with the BN backward (fused_epoch.cu) and
// the power iteration (product_power_iter.cu) are the same compiled
// functions K3 launches. New here:
//
//  * fs_dw_adam: gemm_sm90.cuh::dw_adam_body with the deferred factors. dW
//    tile = X^T . dZ by the shared Hopper main loop (a 4-stage cp.async ring,
//    wgmma m64n64k16 from 128-byte swizzled tiles, fp32 sums in registers),
//    split over the batch across a thread-block cluster whose partial tiles
//    meet through distributed shared memory in rank order; each rank runs
//    Adam on its own rows of the tile. Before the main loop the block starts
//    cp.async copies of exactly those rows of the master and both moments
//    into shared memory and reads them there in the epilogue: the
//    counterpart of the TPU kernel's three tile DMAs started before its dot
//    and awaited after it. The epilogue reads the master as master *
//    scales[layer] (the previous step's factor, read from device memory so
//    the launch can sit in a CUDA graph), applies Adam with t = count[0] + 1
//    from the device count, the NonNeg clamp, and writes master, moments and
//    the bf16 copy with 16- and 8-byte stores.
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
// arrays and the bf16 copies, in and out; all of it stays in the 50 MB L2)
// and does ~4 GFLOP, tens of microseconds of bytes or tensor-core time, but
// runs as ~20 dependent launches, so launch latency and the fill of each
// grid bound it, as they do K3: hence the cluster split of the narrow dW
// products and the fusions listed in fused_epoch.cu. ops/cuda_step.py
// captures the step once per (spec, device) into a CUDA graph and replays it
// per call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "adam_common.cuh"  // AdamArgs, bias_corrections, adam_step
#include "gemm_sm90.cuh"    // the wgmma main loop and the dW + Adam body

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxLayers = 16;
constexpr int kScaleLanes = 128;          // width of the `scales` row
constexpr int kMaxDevices = 64;
constexpr int kDwSmem = sm90::kDwSmemBytes;

__global__ void __launch_bounds__(sm90::kThreads) fs_dw_adam(sm90::DwArgs a) {
  extern __shared__ unsigned char smem_raw[];
  sm90::dw_adam_body(a, smem_raw);
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
// *max_clusters (when not null): how many 8-block clusters fit at once.
cudaError_t ensure_smem_opt_in(int* max_clusters) {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (max_clusters != nullptr || !done[dev].load(std::memory_order_acquire)) {
    int n = 1 << 30;
    err = sm90::prepare_kernel(fs_dw_adam, kDwSmem, dim3(1, 1, 8), &n);
    if (err != cudaSuccess) return err;
    if (max_clusters != nullptr) *max_clusters = n;
    done[dev].store(true, std::memory_order_release);
  }
  return cudaSuccess;
}

}  // namespace

// Every entry enqueues on `stream` and returns cudaGetLastError() (0 on
// success); nothing allocates or synchronizes.

// dW (M, N) = X^T . dZ with X stored (K, M) bf16 and dZ (K, N) bf16, fused
// with Adam on master * scales[layer] and the moments (M, N) fp32, NonNeg,
// and the bf16 copy. M, N multiples of 64; `dims` is the launch as the host's
// plan states it (sm90::LaunchDims: seven ints): the depth K is split over
// clusters of its grid z blocks (1, 2, 4 or 8; each block's share of K a
// multiple of 64).
// count (1,) int32 and scales (>= layer + 1,) fp32 are device memory.
extern "C" int asr_fs_dw_adam(const void* x, const void* dz, void* mast,
                              void* mw, void* vw, void* w16, int M, int N,
                              int K, const void* count, const void* scales,
                              int layer, const AdamArgs* adam, int nonneg,
                              const int* dims, void* stream) {
  sm90::LaunchDims d;
  if (layer < 0 || layer >= kScaleLanes || !sm90::read_dims(dims, &d) ||
      !sm90::dw_dims_ok(d, M, N, K)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = ensure_smem_opt_in(nullptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  sm90::DwArgs a{static_cast<const bf16*>(x), static_cast<const bf16*>(dz),
                 static_cast<float*>(mast),   static_cast<float*>(mw),
                 static_cast<float*>(vw),     static_cast<bf16*>(w16),
                 M, N, K, static_cast<const int*>(count), 0,
                 static_cast<const float*>(scales), layer, *adam, nonneg};
  return static_cast<int>(sm90::launch_cluster(fs_dw_adam, d, stream, a));
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
// Writes to *max_clusters how many 8-block clusters of fs_dw_adam the device
// can hold at once; 0 means one can never be scheduled.
extern "C" int asr_fs_preload(int* max_clusters) {
  cudaError_t err = ensure_smem_opt_in(max_clusters);
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
