// K1 on Hopper, FFT body: in-kernel framing -> windowed real FFT in float64
// -> |.|^2 -> mel projection, for n_fft a power of two in [32, 4096] (the
// digit preset: n_fft 2048, hop 512, 1025 bins).
//
// Replaces asr_using_robust_nn_tpu/ops/pallas_mfcc.py::_dft_power_mel_kernel,
// the Pallas TPU kernel behind mel_power_pallas / mfcc_pallas_batch. It
// computes what mel_power_pallas computes: given the center-padded waveforms
// (B, Lpad) fp32 it writes the fp32 mel power (B*T, 128), frame t of
// utterance b being ypad[b, t*hop : t*hop + n_fft]. Neither the frames nor
// the power spectrogram reach device memory. The TPU kernel forms the rDFT
// as a dense (n_fft x n_freq) product because its matrix unit makes N^2 work
// cheap; on the H100 the sums must be float64 (fp32 sums miss the 5e-4 MFCC
// bar on the golden chirp) and float64 has no fast matrix unit, so the work
// itself is cut: a frame's transform costs ~66 kFLOP as an FFT against 8.4
// MFLOP as a dense product.
//
// The decomposition (ops/cuda_mfcc.py::fft_tables builds every table in
// float64 on the host; mel_power_fft_plain walks the same steps in PyTorch):
//  1. z[n] = (w[2n] y[2n], w[2n+1] y[2n+1]), n < m = n_fft / 2: the windowed
//     frame's even and odd samples packed into m complex points.
//  2. An in-place decimation-in-frequency FFT of length m: radix-4 stages
//     (five for m = 1024), one radix-2 stage when log2 m is odd. Twiddles
//     come from one table of exp(-2 pi i k / m); nothing calls sincos.
//     Output k ends at index pos[k], the stages' digit reversal.
//  3. The split pass: X[k] = E[k] + exp(-2 pi i k / n_fft) O[k], k <= m, with
//     E = (Z[k] + conj Z[m-k]) / 2, O = -i (Z[k] - conj Z[m-k]) / 2, read
//     through pos; the power |X[k]|^2 is rounded to fp32 once, into a row
//     in shared memory.
//  4. The mel bands. A triangular filterbank has at most two non-zero bands
//     at any bin, so each band is a run of consecutive bins (3..53 of the
//     1025 at the digit preset) and the projection costs ~2 000 fp32 FMAs a
//     frame, not 131 000 (45 056 frames: 0.2 GFLOP instead of 11.8). Terms
//     are non-negative: fp32 sums lose nothing the dB needs.
//
// What bounds it on an H100: shared-memory passes. A digit frame is 16 KB
// of complex float64; load, five stages, split pass and bands move ~225 KB
// through shared memory per frame, ~10 GB per 1024-row bucket, against
// ~3 GFLOP of float64 (0.09 ms at the 34 TFLOP/s peak) and 122 MB of device
// traffic (0.04 ms).
//
// What the design does about it:
//  * Frames are the unit of work. A block of 256 threads takes F
//    consecutive frames (consecutive frames of an utterance overlap by
//    n_fft - hop samples, so their loads hit L1/L2) and runs every stage on
//    all F with one twiddle load per butterfly. F is 4 when that still
//    leaves every SM two blocks (buckets >= 64 rows at the digit preset), 2
//    or 1 below, so a 16-row bucket's 704 frames spread over all 132 SMs
//    (ops/cuda_mfcc.py::frames_per_block). Two blocks share an SM (90 KB of
//    shared memory each at F = 4), so one block's barriers hide behind the
//    other's arithmetic.
//  * One complex point is one 16-byte shared-memory word; index i lives at
//    i + i / 8, which spreads the stride-4 and stride-1 accesses of the last
//    two stages over the banks.
//  * Each stage is in place: a butterfly reads and writes its own four
//    points, so one barrier per stage is enough.
// Later work: radix-16 stages in registers (three passes instead of five).
// An n_fft that is no power of two (the speaker preset's 441) goes to the
// mixed body, csrc/mixed_fft_power_mel.cu, which packs two frames into one
// complex transform instead of one frame's even and odd samples.

#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxDevices = 64;
constexpr int kThreads = 256;
constexpr int NMEL = 128;        // mel bands (FrontendConfig.n_mels)
constexpr int kMaxStages = 6;    // m = 2048 = 4^5 * 2
constexpr int kMinM = 16, kMaxM = 2048;

struct Plan {
  int n_stages;
  int radix[kMaxStages];
};

__device__ __forceinline__ int padded(int i) { return i + (i >> 3); }

__device__ __forceinline__ double2 operator+(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ double2 operator-(double2 a, double2 b) {
  return make_double2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ double2 cmul(double2 a, double2 w) {
  return make_double2(fma(a.x, w.x, -a.y * w.y), fma(a.x, w.y, a.y * w.x));
}

template <int F>
__global__ void __launch_bounds__(kThreads)
fft_power_mel_kernel(const float* __restrict__ ypad,
                     const double2* __restrict__ window,  // (m): w[2n], w[2n+1]
                     const double2* __restrict__ tw,      // (m)
                     const double2* __restrict__ split,   // (m + 1)
                     const int* __restrict__ pos,         // (m)
                     const int* __restrict__ band_start,
                     const int* __restrict__ band_off,
                     const float* __restrict__ band_w,
                     float* __restrict__ out,
                     int rows, int lpad, int n_frames, int hop, int m,
                     Plan plan) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int zstride = m + (m >> 3);
  const int pstride = m + 4;
  double2* z = reinterpret_cast<double2*>(smem_raw);
  float* pw = reinterpret_cast<float*>(z + F * zstride);
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * F;

  // 1. window and pack; reads past the padded waveform or the last row are 0
  int base[F], off[F];
  bool ok[F];
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const int r = row0 + f;
    ok[f] = r < rows;
    const int b = ok[f] ? r / n_frames : 0;
    base[f] = b * lpad;  // < 2^31, checked at launch
    off[f] = (r - b * n_frames) * hop;
  }
  for (int i = tid; i < m; i += kThreads) {
    const double2 w = __ldg(window + i);
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const int p = off[f] + 2 * i;
      const float* src = ypad + (static_cast<int64_t>(base[f]) + p);
      const double y0 = (ok[f] && p < lpad) ? static_cast<double>(__ldg(src)) : 0.0;
      const double y1 = (ok[f] && p + 1 < lpad) ? static_cast<double>(__ldg(src + 1)) : 0.0;
      z[f * zstride + padded(i)] = make_double2(y0 * w.x, y1 * w.y);
    }
  }
  __syncthreads();

  // 2. in-place decimation-in-frequency stages
  int len = m;
  for (int s = 0; s < plan.n_stages; ++s) {
    const int radix = plan.radix[s];
    const int sub = len / radix;
    const int tws = m / len;  // stride of exp(-2 pi i / len) in the table
    if (radix == 4) {
      for (int bf = tid; bf < (m >> 2); bf += kThreads) {
        const int j = bf & (sub - 1);
        const int i0 = (bf - j) * 4 + j;  // block * len + j
        const double2 w1 = __ldg(tw + j * tws);
        const double2 w2 = __ldg(tw + 2 * j * tws);
        const double2 w3 = __ldg(tw + 3 * j * tws);
        const int p0 = padded(i0), p1 = padded(i0 + sub),
                  p2 = padded(i0 + 2 * sub), p3 = padded(i0 + 3 * sub);
#pragma unroll
        for (int f = 0; f < F; ++f) {
          double2* zf = z + f * zstride;
          const double2 a0 = zf[p0], a1 = zf[p1], a2 = zf[p2], a3 = zf[p3];
          const double2 t0 = a0 + a2, t1 = a0 - a2, t2 = a1 + a3, t3 = a1 - a3;
          // -i t3 = (t3.y, -t3.x)
          const double2 y1 = make_double2(t1.x + t3.y, t1.y - t3.x);
          const double2 y3 = make_double2(t1.x - t3.y, t1.y + t3.x);
          zf[p0] = t0 + t2;
          zf[p1] = cmul(y1, w1);
          zf[p2] = cmul(t0 - t2, w2);
          zf[p3] = cmul(y3, w3);
        }
      }
    } else {  // radix 2
      for (int bf = tid; bf < (m >> 1); bf += kThreads) {
        const int j = bf & (sub - 1);
        const int i0 = (bf - j) * 2 + j;
        const double2 w1 = __ldg(tw + j * tws);
        const int p0 = padded(i0), p1 = padded(i0 + sub);
#pragma unroll
        for (int f = 0; f < F; ++f) {
          double2* zf = z + f * zstride;
          const double2 a0 = zf[p0], a1 = zf[p1];
          zf[p0] = a0 + a1;
          zf[p1] = cmul(a0 - a1, w1);
        }
      }
    }
    __syncthreads();
    len = sub;
  }

  // 3. split pass and power, k = 0 .. m
  for (int k = tid; k <= m; k += kThreads) {
    const int pa = padded(__ldg(pos + (k & (m - 1))));
    const int pb = padded(__ldg(pos + ((m - k) & (m - 1))));
    const double2 wk = __ldg(split + k);
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const double2 za = z[f * zstride + pa], zb = z[f * zstride + pb];
      // E = (za + conj zb) / 2, O = -i (za - conj zb) / 2
      const double2 e = make_double2(0.5 * (za.x + zb.x), 0.5 * (za.y - zb.y));
      const double2 o = make_double2(0.5 * (za.y + zb.y), -0.5 * (za.x - zb.x));
      const double2 wo = cmul(o, wk);
      const double re = e.x + wo.x, im = e.y + wo.y;
      pw[f * pstride + k] = static_cast<float>(re * re + im * im);
    }
  }
  __syncthreads();

  // 4. mel bands: one thread per (frame, band), a run of consecutive bins
  for (int idx = tid; idx < F * NMEL; idx += kThreads) {
    const int f = idx / NMEL, band = idx % NMEL;
    const int r = row0 + f;
    if (r >= rows) continue;
    const int o0 = __ldg(band_off + band);
    const int n = __ldg(band_off + band + 1) - o0;
    const float* p = pw + f * pstride + __ldg(band_start + band);
    float acc = 0.f;
    for (int i = 0; i < n; ++i) acc = fmaf(p[i], __ldg(band_w + o0 + i), acc);
    out[static_cast<int64_t>(r) * NMEL + band] = acc;
  }
}

template <int F>
cudaError_t launch(int dev, const float* ypad, const double2* window,
                   const double2* tw, const double2* split, const int* pos,
                   const int* band_start, const int* band_off,
                   const float* band_w, float* out, int rows, int lpad,
                   int n_frames, int hop, int m, const Plan& plan,
                   cudaStream_t stream) {
  const int smem = F * ((m + (m >> 3)) * static_cast<int>(sizeof(double2)) +
                        (m + 4) * static_cast<int>(sizeof(float)));
  // The shared-memory opt-in is per device: set it at the first launch on
  // each one. Setting it twice from racing threads is harmless.
  static std::atomic<bool> smem_set[kMaxDevices];
  if (!smem_set[dev].load(std::memory_order_acquire)) {
    const cudaError_t err = cudaFuncSetAttribute(
        fft_power_mel_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        F * ((kMaxM + (kMaxM >> 3)) * static_cast<int>(sizeof(double2)) +
             (kMaxM + 4) * static_cast<int>(sizeof(float))));
    if (err != cudaSuccess) return err;
    smem_set[dev].store(true, std::memory_order_release);
  }
  fft_power_mel_kernel<F><<<(rows + F - 1) / F, kThreads, smem, stream>>>(
      ypad, window, tw, split, pos, band_start, band_off, band_w, out, rows,
      lpad, n_frames, hop, m, plan);
  return cudaGetLastError();
}

}  // namespace

// Launches the FFT body on `stream` and returns cudaGetLastError() (0 on
// success). ypad (batch, lpad) fp32; window (n_fft) f64; tw (m, 2) f64 with
// m = n_fft / 2; split (m + 1, 2) f64; pos (m) i32; band_start (128) i32;
// band_off (129) i32; band_w (band_off[128]) fp32; out (batch * n_frames,
// 128) fp32; all contiguous device arrays. `radices` (host) are the stages,
// each 4 or 2, multiplying to m; frames_per_block is 1, 2 or 4.
extern "C" int asr_fft_power_mel(const void* ypad, const void* window,
                                 const void* tw, const void* split,
                                 const void* pos, const void* band_start,
                                 const void* band_off, const void* band_w,
                                 void* out, int batch, int lpad, int n_frames,
                                 int hop, int n_fft, const int* radices,
                                 int n_stages, int frames_per_block,
                                 void* stream) {
  const int m = n_fft / 2;
  if (n_fft <= 0 || (n_fft & (n_fft - 1)) != 0 || m < kMinM || m > kMaxM ||
      n_stages < 1 || n_stages > kMaxStages || batch < 0 || n_frames < 0 ||
      hop <= 0 || lpad <= 0 ||
      static_cast<int64_t>(batch) * lpad > INT_MAX ||
      static_cast<int64_t>(batch) * n_frames > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Plan plan;
  plan.n_stages = n_stages;
  int prod = 1;
  for (int s = 0; s < kMaxStages; ++s) {
    plan.radix[s] = s < n_stages ? radices[s] : 1;
    if (s < n_stages) {
      if (radices[s] != 4 && radices[s] != 2) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      prod *= radices[s];
    }
  }
  if (prod != m) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = batch * n_frames;
  if (rows == 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  const auto* y = static_cast<const float*>(ypad);
  const auto* wi = static_cast<const double2*>(window);
  const auto* t = static_cast<const double2*>(tw);
  const auto* sp = static_cast<const double2*>(split);
  const auto* ps = static_cast<const int*>(pos);
  const auto* bs = static_cast<const int*>(band_start);
  const auto* bo = static_cast<const int*>(band_off);
  const auto* bw = static_cast<const float*>(band_w);
  auto* o = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (frames_per_block) {
    case 4:
      err = launch<4>(dev, y, wi, t, sp, ps, bs, bo, bw, o, rows, lpad,
                      n_frames, hop, m, plan, st);
      break;
    case 2:
      err = launch<2>(dev, y, wi, t, sp, ps, bs, bo, bw, o, rows, lpad,
                      n_frames, hop, m, plan, st);
      break;
    case 1:
      err = launch<1>(dev, y, wi, t, sp, ps, bs, bo, bw, o, rows, lpad,
                      n_frames, hop, m, plan, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
