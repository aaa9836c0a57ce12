// K1 on Hopper, mixed body: in-kernel framing -> windowed real FFT of two
// frames at once in float64 -> |.|^2 -> mel projection, for n_fft in
// [32, 4096] that is no power of two and has no prime factor above 7 (the
// speaker preset: n_fft 441 = 3^2 7^2, hop 220, 221 bins).
//
// Replaces asr_using_robust_nn_tpu/ops/pallas_mfcc.py::_dft_power_mel_kernel,
// the Pallas TPU kernel behind mel_power_pallas / mfcc_pallas_batch. It
// computes what mel_power_pallas computes: given the center-padded waveforms
// (B, Lpad) fp32 it writes the fp32 mel power (B*T, 128), frame t of
// utterance b being ypad[b, t*hop : t*hop + n_fft]. Neither the frames nor
// the power spectrogram reach device memory. The sums must be float64 (fp32
// sums put the speaker MFCC ~6e-4 from the oracle on the golden chirp, over
// the 5e-4 bar), and float64 has no fast matrix unit on the H100, so the
// work is cut: the dense body (dft_power_mel.cu) spends 441 x 221 complex
// products a frame, this body ~21 kFLOP.
//
// The decomposition (ops/cuda_mfcc.py::mixed_tables builds every table in
// float64 on the host; mel_power_mixed_plain walks the same steps):
//  1. z[i] = w[i] (x_a[i] + i x_b[i]), i < n: frame rows a = 2q and b = 2q+1
//     of the flattened (B * T) rows packed into one complex transform (n
//     may be odd, so the even/odd packing of the FFT body does not apply);
//     a row past the last one is zero.
//  2. An in-place decimation-in-frequency FFT of length n: stages of radix
//     7, 5, 4, 3 or 2 (7, 7, 3, 3 at 441). A radix-r butterfly is the dense
//     r-point DFT written with its symmetry, y[q] = a0 [+ (-1)^q a_{r/2}] +
//     sum_{p <= (r-1)/2} (a_p + a_{r-p}) Re c^{pq} + i (a_p - a_{r-p})
//     Im c^{pq}, then the twiddles; c^t and every twiddle are entries of
//     one table of exp(-2 pi i k / n) (quarter turns exact); nothing calls
//     sincos. Output k ends at index pos[k], the stages' digit reversal.
//  3. The separation: X_a[k] = (Z[k] + conj Z[n-k]) / 2, X_b[k] = -i (Z[k] -
//     conj Z[n-k]) / 2, k <= n / 2, read through pos; each power |X[k]|^2
//     is rounded to fp32 once, into a row in shared memory.
//  4. The mel bands as runs of consecutive bins (at most 11 of the 221 at
//     the speaker preset), fp32 FMAs over non-negative terms.
//
// What bounds it on an H100: float64 operations and shared-memory passes.
// A speaker frame is ~21 kFLOP (window, four stages, separation), so a
// 1024-row bucket (103 424 frames) is 2.2 GFLOP of float64, 0.064 ms at the
// 34 TFLOP/s peak, against 145 MB of waveform and mel traffic (0.043 ms);
// each stage reads and writes every point of 16 bytes once, ~70 KB of
// shared-memory traffic a pair.
//
// What the design does about it:
//  * Pairs of frames are the unit of work, so every complex point carries
//    two real samples and no arithmetic is spent on a zero imaginary part.
//    A block of 256 threads takes P consecutive pairs, P the most of 8, 4,
//    2, 1 that leaves every SM two blocks (ops/cuda_mfcc.py::
//    pairs_per_block); two blocks share an SM (70 KB of shared memory each
//    at P = 8, n = 441).
//  * A thread takes one (pair, butterfly) item at a time, so a radix-7
//    stage (63 butterflies a pair) still fills the block.
//  * One complex point is one 16-byte shared-memory word. Consecutive
//    threads take consecutive butterflies, whose points are consecutive
//    words or sit an odd stride apart at an odd n: conflict-free without
//    padding. An even n spreads index i to i + i / 8, as the FFT body does.
//  * Stages are in place: one barrier a stage.
// ptxas -v (sm_90a, CUDA 12.8): 128 registers under __launch_bounds__(256,
// 2), no spills, no stack frame; dynamic shared memory P x 8 856 bytes at
// n = 441. Three blocks an SM (80 registers) spill the radix-7 butterfly.

#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxDevices = 64;
constexpr int kThreads = 256;
constexpr int NMEL = 128;        // mel bands (FrontendConfig.n_mels)
constexpr int kMaxStages = 12;
constexpr int kMinN = 32, kMaxN = 4096;
constexpr int kMaxSmem = 232448 / 2;  // two blocks an SM

struct Plan {
  int n_stages;
  int radix[kMaxStages];
};

__device__ __forceinline__ double2 operator+(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ double2 operator-(double2 a, double2 b) {
  return make_double2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ double2 cmul(double2 a, double2 w) {
  return make_double2(fma(a.x, w.x, -a.y * w.y), fma(a.x, w.y, a.y * w.x));
}

// index i of the points; sh = 3 spreads an even n, sh = 31 leaves it
__device__ __forceinline__ int at(int i, int sh) { return i + (i >> sh); }

__host__ __device__ constexpr int pstride(int nf) { return nf + 3; }

// One radix-R stage over the block's P pairs: sub = len / R, the stage's
// twiddle stride tws = n / len.
template <int R>
__device__ __forceinline__ void stage(double2* __restrict__ z, int zlen,
                                      int P, int n, int sub, int tws, int sh,
                                      const double2* __restrict__ tw) {
  constexpr int H = (R - 1) / 2;  // symmetric pairs (p, R - p)
  double2 c[R];                   // c[t] = exp(-2 pi i t / R)
#pragma unroll
  for (int t = 0; t < R; ++t) c[t] = __ldg(tw + t * (n / R));
  const int nb = n / R;
  for (int idx = threadIdx.x; idx < P * nb; idx += kThreads) {
    const int p = idx / nb;
    const int bf = idx - p * nb;
    const int j = bf % sub;
    const int i0 = (bf - j) * R + j;  // block * len + j
    double2* zp = z + p * zlen;
    double2 a[R];
#pragma unroll
    for (int q = 0; q < R; ++q) a[q] = zp[at(i0 + q * sub, sh)];
    double2 s[H + 1], d[H + 1];
#pragma unroll
    for (int q = 1; q <= H; ++q) {
      s[q] = a[q] + a[R - q];
      d[q] = a[q] - a[R - q];
    }
#pragma unroll
    for (int q = 0; q < R; ++q) {
      double2 y = a[0];
      if (R % 2 == 0) y = (q & 1) ? y - a[R / 2] : y + a[R / 2];
#pragma unroll
      for (int k = 1; k <= H; ++k) {
        const double2 w = c[(k * q) % R];
        y.x = fma(s[k].x, w.x, fma(-d[k].y, w.y, y.x));
        y.y = fma(s[k].y, w.x, fma(d[k].x, w.y, y.y));
      }
      zp[at(i0 + q * sub, sh)] = q == 0 ? y : cmul(y, __ldg(tw + q * j * tws));
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
mixed_fft_power_mel_kernel(const float* __restrict__ ypad,
                           const double* __restrict__ window,  // (n)
                           const double2* __restrict__ tw,     // (n)
                           const int* __restrict__ pos,        // (n)
                           const int* __restrict__ band_start,
                           const int* __restrict__ band_off,
                           const float* __restrict__ band_w,
                           float* __restrict__ out, int rows, int lpad,
                           int n_frames, int hop, int n, int P, Plan plan) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int sh = (n & 1) ? 31 : 3;
  const int zlen = at(n - 1, sh) + 1;
  const int nf = n / 2 + 1;
  double2* z = reinterpret_cast<double2*>(smem_raw);
  float* pw = reinterpret_cast<float*>(z + P * zlen);
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * 2 * P;

  // 1. window and pack two rows a point; rows past the last one are 0
  for (int idx = tid; idx < P * n; idx += kThreads) {
    const int p = idx / n;
    const int i = idx - p * n;
    const double w = __ldg(window + i);
    double y[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 2 * p + h;
      const int b = r / n_frames;
      const int o = (r - b * n_frames) * hop + i;
      y[h] = (r < rows && o < lpad)
                 ? static_cast<double>(
                       __ldg(ypad + static_cast<int64_t>(b) * lpad + o))
                 : 0.0;
    }
    z[p * zlen + at(i, sh)] = make_double2(y[0] * w, y[1] * w);
  }
  __syncthreads();

  // 2. in-place decimation-in-frequency stages
  int len = n;
  for (int st = 0; st < plan.n_stages; ++st) {
    const int radix = plan.radix[st];
    const int sub = len / radix;
    const int tws = n / len;
    switch (radix) {
      case 7: stage<7>(z, zlen, P, n, sub, tws, sh, tw); break;
      case 5: stage<5>(z, zlen, P, n, sub, tws, sh, tw); break;
      case 4: stage<4>(z, zlen, P, n, sub, tws, sh, tw); break;
      case 3: stage<3>(z, zlen, P, n, sub, tws, sh, tw); break;
      default: stage<2>(z, zlen, P, n, sub, tws, sh, tw); break;
    }
    __syncthreads();
    len = sub;
  }

  // 3. separate the two rows, power, k = 0 .. n / 2
  for (int idx = tid; idx < P * nf; idx += kThreads) {
    const int p = idx / nf;
    const int k = idx - p * nf;
    const double2 za = z[p * zlen + at(__ldg(pos + k), sh)];
    const double2 zb = z[p * zlen + at(__ldg(pos + (k == 0 ? 0 : n - k)), sh)];
    // X_a = (za + conj zb) / 2, X_b = -i (za - conj zb) / 2
    const double ax = 0.5 * (za.x + zb.x), ay = 0.5 * (za.y - zb.y);
    const double bx = 0.5 * (za.y + zb.y), by = -0.5 * (za.x - zb.x);
    pw[(2 * p) * pstride(nf) + k] = static_cast<float>(ax * ax + ay * ay);
    pw[(2 * p + 1) * pstride(nf) + k] = static_cast<float>(bx * bx + by * by);
  }
  __syncthreads();

  // 4. mel bands: one thread per (row, band), a run of consecutive bins
  for (int idx = tid; idx < 2 * P * NMEL; idx += kThreads) {
    const int f = idx / NMEL, band = idx % NMEL;
    const int r = row0 + f;
    if (r >= rows) continue;
    const int o0 = __ldg(band_off + band);
    const int cnt = __ldg(band_off + band + 1) - o0;
    const float* p = pw + f * pstride(nf) + __ldg(band_start + band);
    float acc = 0.f;
    for (int i = 0; i < cnt; ++i) acc = fmaf(p[i], __ldg(band_w + o0 + i), acc);
    out[static_cast<int64_t>(r) * NMEL + band] = acc;
  }
}

int smem_bytes(int P, int n) {
  const int zlen = (n & 1) ? n : n + (n - 1) / 8;
  return P * (zlen * 16 + 2 * pstride(n / 2 + 1) * 4);
}

}  // namespace

// Launches the mixed body on `stream` and returns cudaGetLastError() (0 on
// success). ypad (batch, lpad) fp32; window (n_fft) f64; tw (n_fft, 2) f64;
// pos (n_fft) i32; band_start (128) i32; band_off (129) i32; band_w
// (band_off[128]) fp32; out (batch * n_frames, 128) fp32; all contiguous
// device arrays. `radices` (host) are the stages, each 7, 5, 4, 3 or 2,
// multiplying to n_fft; pairs_per_block is 1, 2, 4 or 8.
extern "C" int asr_mixed_fft_power_mel(const void* ypad, const void* window,
                                       const void* tw, const void* pos,
                                       const void* band_start,
                                       const void* band_off,
                                       const void* band_w, void* out,
                                       int batch, int lpad, int n_frames,
                                       int hop, int n_fft, const int* radices,
                                       int n_stages, int pairs_per_block,
                                       void* stream) {
  const int P = pairs_per_block;
  if (n_fft < kMinN || n_fft > kMaxN || n_stages < 1 ||
      n_stages > kMaxStages || batch < 0 || n_frames < 0 || hop <= 0 ||
      lpad <= 0 || (P != 1 && P != 2 && P != 4 && P != 8) ||
      static_cast<int64_t>(batch) * lpad > INT_MAX ||
      static_cast<int64_t>(batch) * n_frames > INT_MAX - 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Plan plan;
  plan.n_stages = n_stages;
  int prod = 1;
  for (int s = 0; s < kMaxStages; ++s) {
    plan.radix[s] = s < n_stages ? radices[s] : 1;
    if (s < n_stages) {
      const int r = radices[s];
      if (r != 2 && r != 3 && r != 4 && r != 5 && r != 7) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      prod *= r;
    }
  }
  const int smem = smem_bytes(P, n_fft);
  if (prod != n_fft || smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = batch * n_frames;
  if (rows == 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  // The shared-memory opt-in is per device: set it at the first launch on
  // each one. Setting it twice from racing threads is harmless.
  static std::atomic<bool> smem_set[kMaxDevices];
  if (!smem_set[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(mixed_fft_power_mel_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[dev].store(true, std::memory_order_release);
  }
  const int grid = (rows + 2 * P - 1) / (2 * P);
  mixed_fft_power_mel_kernel<<<grid, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ypad), static_cast<const double*>(window),
      static_cast<const double2*>(tw), static_cast<const int*>(pos),
      static_cast<const int*>(band_start), static_cast<const int*>(band_off),
      static_cast<const float*>(band_w), static_cast<float*>(out), rows, lpad,
      n_frames, hop, n_fft, P, plan);
  return static_cast<int>(cudaGetLastError());
}
