// K2 on Hopper: power iteration for sigma = ||W_m^T ... W_1^T||_2.
//
// Replaces asr_using_robust_nn_tpu/ops/pallas_spectral.py::_pi_kernel (the
// Pallas TPU kernel behind product_spectral_norm_pallas) and the projection
// phase of ops/pallas_train.py::_make_epoch_kernel. Semantics, as there:
// the kernels are cast once (bf16 or fp32), the vector is rounded to bf16
// before every link (bf16 mode), every matvec sums in fp32, nrm(x) =
// x / (||x|| + eps), and
//   u = nrm(u0); repeat n_iter: v = nrm(P^T u), u = nrm(P v);
//   v = nrm(P^T u); sigma = u . (P v); return (sigma, u)
// with P^T x = W_1 ... W_m x and P x = W_m^T ... W_1^T x.
//
// What bounds it on an H100: latency. The work is a chain of 2*m*(n_iter+1)
// dependent matvecs (204 at the digit recipe, n_iter 16), each ~0.1-1.8 MB
// of bf16 weights that stay in the 50 MB L2 for the whole chain, so the time
// is launches and the grid-wide dependency between links, not bytes or FLOPs.
//
// Design: one launch per link on the caller's stream (the simple form; a
// persistent cooperative kernel with grid syncs is later work). Each link
// kernel stages its input vector in shared memory, normalizing it first when
// it is the first link of a pass (every block computes the same norm with
// the same reduction order, so all blocks agree bit for bit), and rounds it
// to bf16 in bf16 mode. P^T links give a warp to each output row (coalesced
// reads of one weight row); P links give a thread to each output column and
// split the depth over the block's 8 warps. A one-block finishing kernel
// forms u = nrm(u_raw), sigma = u . y and, for the simple_norm projection,
// the per-layer factors, which a last kernel per layer applies to the bf16
// kernels and their fp32 masters. No launch allocates or synchronizes, so the
// whole chain can be captured into a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kColsP = 64;          // output columns per block of a P link
constexpr int kMaxDim = 8192;       // a staged vector fits 48 KB of smem

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Sum over the block; every thread gets the total. `red` holds kWarps floats.
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

// xs[0..len) = cast(normalize ? x / (||x|| + eps) : x), cast = bf16 rounding
// when `to_bf16`. Ends with a barrier.
__device__ void stage_vector(const float* __restrict__ x, int len,
                             bool normalize, bool to_bf16, float eps,
                             float* xs, float* red) {
  float ss = 0.f;
  for (int i = threadIdx.x; i < len; i += kThreads) {
    const float v = x[i];
    xs[i] = v;
    ss += v * v;
  }
  float den = 1.f;
  if (normalize) den = sqrtf(block_sum(ss, red)) + eps;
  __syncthreads();
  for (int i = threadIdx.x; i < len; i += kThreads) {
    float v = xs[i];
    if (normalize) v = v / den;
    if (to_bf16) v = round_bf16(v);
    xs[i] = v;
  }
  __syncthreads();
}

// P^T link: y[j] = sum_n W[j, n] * x~[n] for j < din; W is (din, dout).
template <typename T>
__global__ void __launch_bounds__(kThreads)
pi_link_pt(const T* __restrict__ w, int din, int dout,
           const float* __restrict__ x, float* __restrict__ y,
           int normalize, int to_bf16, float eps) {
  extern __shared__ float xs[];
  __shared__ float red[kWarps];
  stage_vector(x, dout, normalize, to_bf16, eps, xs, red);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int j = blockIdx.x * kWarps + warp;
  if (j >= din) return;
  const T* row = w + static_cast<int64_t>(j) * dout;
  float acc = 0.f;
  for (int n = lane; n < dout; n += 32) acc = fmaf(to_f(row[n]), xs[n], acc);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) y[j] = acc;
}

// P link: y[n] = sum_k x~[k] * W[k, n] for n < dout; W is (din, dout).
template <typename T>
__global__ void __launch_bounds__(kThreads)
pi_link_p(const T* __restrict__ w, int din, int dout,
          const float* __restrict__ x, float* __restrict__ y,
          int normalize, int to_bf16, float eps) {
  extern __shared__ float xs[];
  __shared__ float red[kWarps];
  __shared__ float part[kWarps][kColsP + 1];
  stage_vector(x, din, normalize, to_bf16, eps, xs, red);
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int c0 = blockIdx.x * kColsP + tx, c1 = c0 + 32;
  float a0 = 0.f, a1 = 0.f;
  for (int k = ty; k < din; k += kWarps) {
    const T* row = w + static_cast<int64_t>(k) * dout;
    const float xv = xs[k];
    if (c0 < dout) a0 = fmaf(to_f(row[c0]), xv, a0);
    if (c1 < dout) a1 = fmaf(to_f(row[c1]), xv, a1);
  }
  part[ty][tx] = a0;
  part[ty][tx + 32] = a1;
  __syncthreads();
  if (threadIdx.x < kColsP) {
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < kWarps; ++t) s += part[t][threadIdx.x];
    const int c = blockIdx.x * kColsP + threadIdx.x;
    if (c < dout) y[c] = s;
  }
}

// u = nrm(u_raw) -> u_out; sigma = u . y; with f != nullptr also the
// simple_norm factors f_i = exp(log(rho / (s_i + eps)) * inv_m), s_{i+1} =
// s_i * f_i, s_0 = sigma. One block; u_raw may alias u_out.
__global__ void __launch_bounds__(kThreads)
pi_finish(const float* u_raw, const float* __restrict__ y, int len, float eps,
          float* u_out, float* __restrict__ sigma, float* __restrict__ f,
          int m, float rho, float inv_m) {
  extern __shared__ float xs[];
  __shared__ float red[kWarps];
  stage_vector(u_raw, len, true, false, eps, xs, red);
  float d = 0.f;
  for (int i = threadIdx.x; i < len; i += kThreads) d += xs[i] * y[i];
  d = block_sum(d, red);
  for (int i = threadIdx.x; i < len; i += kThreads) u_out[i] = xs[i];
  if (threadIdx.x == 0) {
    sigma[0] = d;
    if (f != nullptr) {
      float s = d;
      for (int i = 0; i < m; ++i) {
        const float fi = expf(logf(rho / (s + eps)) * inv_m);
        f[i] = fi;
        s = s * fi;
      }
    }
  }
}

// w16 <- bf16(f32(w16) * f[layer]); master <- master * f[layer].
__global__ void pi_rescale(bf16* __restrict__ w16, float* __restrict__ master,
                           int64_t n, const float* __restrict__ f, int layer) {
  const float fi = f[layer];
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    w16[i] = __float2bfloat16(__bfloat162float(w16[i]) * fi);
    if (master != nullptr) master[i] *= fi;
  }
}

template <typename T>
cudaError_t run_chain(const void* const* ws, const int* dims, int m, bool bf,
                      const float* u_in, float* u_out, float* sigma,
                      float* scratch, int n_iter, float eps, float rho,
                      float inv_m, void* const* masters, cudaStream_t st) {
  int dmax = 0;
  for (int i = 0; i <= m; ++i) dmax = dims[i] > dmax ? dims[i] : dmax;
  float* U = scratch;             // u_raw between rounds
  float* A = scratch + dmax;      // ping-pong pair of the chain
  float* Bv = scratch + 2 * dmax;
  float* Y = scratch + 3 * dmax;  // P v of the last pass
  float* F = scratch + 4 * dmax;  // simple_norm factors
  const int tb = bf ? 1 : 0;
  cudaError_t err = cudaSuccess;

  // x (width dims[m]) -> P^T x through W_m .. W_1; returns the output buffer.
  auto chain_pt = [&](const float* x) -> const float* {
    float* bufs[2] = {A, Bv};
    int flip = 0;
    for (int j = m - 1; j >= 0 && err == cudaSuccess; --j) {
      float* y = bufs[flip];
      flip ^= 1;
      const int din = dims[j], dout = dims[j + 1];
      pi_link_pt<T><<<(din + kWarps - 1) / kWarps, kThreads,
                      dout * sizeof(float), st>>>(
          static_cast<const T*>(ws[j]), din, dout, x, y, j == m - 1, tb, eps);
      err = cudaGetLastError();
      x = y;
    }
    return x;
  };
  // x (width dims[0], in A or Bv) -> P x through W_1 .. W_m into dst.
  auto chain_p = [&](const float* x, float* dst) {
    for (int j = 0; j < m && err == cudaSuccess; ++j) {
      float* y = (j == m - 1) ? dst : (x == A ? Bv : A);
      const int din = dims[j], dout = dims[j + 1];
      pi_link_p<T><<<(dout + kColsP - 1) / kColsP, kThreads,
                     din * sizeof(float), st>>>(
          static_cast<const T*>(ws[j]), din, dout, x, y, j == 0, tb, eps);
      err = cudaGetLastError();
      x = y;
    }
  };

  const float* cur = u_in;
  for (int it = 0; it < n_iter && err == cudaSuccess; ++it) {
    chain_p(chain_pt(cur), U);
    cur = U;
  }
  chain_p(chain_pt(cur), Y);
  if (err != cudaSuccess) return err;
  const bool project = rho > 0.f;
  pi_finish<<<1, kThreads, dims[m] * sizeof(float), st>>>(
      cur, Y, dims[m], eps, u_out, sigma, project ? F : nullptr, m, rho,
      inv_m);
  err = cudaGetLastError();
  if (!project || err != cudaSuccess) return err;
  for (int i = 0; i < m && err == cudaSuccess; ++i) {
    const int64_t n = static_cast<int64_t>(dims[i]) * dims[i + 1];
    const int blocks = static_cast<int>((n + kThreads * 4 - 1) / (kThreads * 4));
    pi_rescale<<<blocks, kThreads, 0, st>>>(
        static_cast<bf16*>(const_cast<void*>(ws[i])),
        masters != nullptr ? static_cast<float*>(masters[i]) : nullptr, n, F,
        i);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

// Enqueues the whole power iteration on `stream` and returns the first
// cudaGetLastError() that is not 0 (0 on success). ws[i] is a (dims[i],
// dims[i+1]) row-major device array, bf16 when wbf16 else fp32; u_in, u_out
// (dims[m],) fp32, may alias; sigma (1,) fp32; scratch 4*max(dims) + m fp32.
// rho > 0 also applies the simple_norm rescale (bf16 kernels only) and to
// masters[i] (fp32, same shapes) when masters is not null.
extern "C" int asr_pi_run(const void* const* ws, const int* dims, int m,
                          int wbf16, const void* u_in, void* u_out,
                          void* sigma, void* scratch, int n_iter, float eps,
                          float rho, float inv_m, void* const* masters,
                          void* stream) {
  if (m < 1 || n_iter < 0 || (rho > 0.f && !wbf16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i <= m; ++i) {
    if (dims[i] < 1 || dims[i] > kMaxDim) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* ui = static_cast<const float*>(u_in);
  auto* uo = static_cast<float*>(u_out);
  auto* sg = static_cast<float*>(sigma);
  auto* sc = static_cast<float*>(scratch);
  const cudaError_t err =
      wbf16 ? run_chain<bf16>(ws, dims, m, true, ui, uo, sg, sc, n_iter, eps,
                              rho, inv_m, masters, st)
            : run_chain<float>(ws, dims, m, false, ui, uo, sg, sc, n_iter, eps,
                               rho, inv_m, masters, st);
  return static_cast<int>(err);
}

// Loads every kernel of this library into the current context, so that a
// later CUDA-graph capture does not load modules lazily.
extern "C" int asr_pi_preload() {
  cudaFuncAttributes a;
  const void* fns[] = {
      reinterpret_cast<const void*>(pi_link_pt<bf16>),
      reinterpret_cast<const void*>(pi_link_pt<float>),
      reinterpret_cast<const void*>(pi_link_p<bf16>),
      reinterpret_cast<const void*>(pi_link_p<float>),
      reinterpret_cast<const void*>(pi_finish),
      reinterpret_cast<const void*>(pi_rescale)};
  for (const void* fn : fns) {
    const cudaError_t err = cudaFuncGetAttributes(&a, fn);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
