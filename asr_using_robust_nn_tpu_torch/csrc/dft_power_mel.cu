// K1 on Hopper, dense body: in-kernel framing -> windowed rDFT as a dense
// product -> |.|^2 -> mel projection, for every n_fft neither FFT body
// takes: one outside [32, 4096] or with a prime factor above 7, a prime
// n_fft such as 401 among them. Neither preset comes here (digit: the FFT
// body csrc/fft_power_mel.cu; speaker, 441 = 3^2 7^2: the mixed body
// csrc/mixed_fft_power_mel.cu); ops/cuda_mfcc.py::kernel_body picks the
// body from the config alone.
//
// Replaces asr_using_robust_nn_tpu/ops/pallas_mfcc.py::_dft_power_mel_kernel,
// the Pallas TPU kernel behind mel_power_pallas / mfcc_pallas_batch. It
// computes what mel_power_pallas computes, for any (n_fft, hop): given the
// center-padded waveforms (B, Lpad) and the zero-padded constants Cr, Ci
// (n_fft_pad, n_freq_pad) and Mel^T (n_freq_pad, 128), all fp32, it writes
// the fp32 mel power (B*T, 128), frame t of utterance b being
// ypad[b, t*hop : t*hop + n_fft].
//
// What bounds it on an H100: float64 FMAs on the CUDA cores. The rDFT
// products are fp32 x fp32, exact in fp64, and are summed in fp64 (fp32
// sums put the speaker MFCC ~6e-4 from the f64 oracle on the golden chirp,
// over the 5e-4 bar; fp64 sums ~8e-5); the power is rounded to fp32 once
// and the mel projection (non-negative terms) runs in fp32 FMA. A 1024-row
// speaker bucket is 103 424 frames x 441 x 221 x 4 = 40 GFLOP of fp64, 1.2
// ms at the 34 TFLOP/s peak. The digit preset's 378 GFLOP made this body
// the serving path's largest cost, which is why that preset moved to the
// FFT body, and the speaker preset's 40 GFLOP why it moved to the mixed
// body.
//
// What the design does about the bound:
//  * Register tiling. A block of 256 threads owns 64 frame rows. Each thread
//    keeps a 4x4 tile of re and of im in fp64 registers: 32 FMA for every
//    2 + 8 shared-memory loads, the frame values broadcast within a half-warp.
//  * A loop inside the block over 64-bin frequency chunks takes the place of
//    the TPU's sequential freq grid axis. Each chunk's power tile lives only
//    in shared memory and is folded into the (64 x 128) mel tile at once:
//    the (rows x n_freq) power spectrogram never reaches device memory,
//    which is what K1 exists for. The mel tile is thread-private and parked
//    in shared memory between chunks, so the fp64 tiles get the registers.
//  * Framing is address arithmetic on the waveform, so the expanded
//    (B*T, n_fft) frame tensor is never written. Reads past n_fft, past the
//    padded waveform or past the last row are zeros.
//  * The wrapper zero-pads the constants to whole tiles once per (config,
//    device); padded DFT rows and bins contribute exact zeros, so only the
//    frame rows and the n_fft edge of the waveform need masking here.

#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxDevices = 64;

constexpr int BM = 64;         // frame rows per block
constexpr int BN = 64;         // frequency bins per chunk
constexpr int BK = 16;         // n_fft depth per staged step
constexpr int NMEL = 128;      // mel bands (FrontendConfig.n_mels)
constexpr int THREADS = 256;
constexpr int PAD_M = BM + 4;      // padded strides: spread float4/double2
constexpr int PAD_MEL = NMEL + 4;  // accesses over the shared-memory banks

struct Smem {
  double a[BK][PAD_M];     // staged frames, transposed: a[k][row]
  double cr[BK][BN];       // staged rDFT constants
  double ci[BK][BN];
  float p[BN][PAD_M];      // power chunk, transposed: p[bin][row]
  float mel[BN][NMEL];     // Mel^T rows of the chunk
  float acc[BM][PAD_MEL];  // the block's mel tile (each element thread-private)
};

__global__ void __launch_bounds__(THREADS, 2)
dft_power_mel_kernel(const float* __restrict__ ypad,
                     const float* __restrict__ cr,
                     const float* __restrict__ ci,
                     const float* __restrict__ melt,
                     float* __restrict__ out,
                     int rows, int lpad, int n_frames, int hop, int n_fft,
                     int n_fft_pad, int n_freq_pad) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;

  // Staging map of the frame tile: this thread loads depth a_k of rows
  // a_m + 16*i. Row r is frame t of utterance b, starting at b*lpad + t*hop.
  const int a_k = tid % BK;
  const int a_m = tid / BK;
  int a_base[4], a_off[4];  // b*lpad (< 2^31, checked at launch), t*hop
  bool a_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + a_m + 16 * i;
    a_ok[i] = r < rows;
    const int b = a_ok[i] ? r / n_frames : 0;
    a_base[i] = b * lpad;
    a_off[i] = (r - b * n_frames) * hop;
  }
  // Staging map of the constants: four consecutive bins of one depth.
  const int c_k = tid / (BN / 4);
  const int c_n = (tid % (BN / 4)) * 4;

  // Compute map: rows ty*4 + i; DFT bins tx + 16*j; mel bands tx + 16*c.
  const int ty = tid / 16;
  const int tx = tid % 16;

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) s.acc[ty * 4 + i][tx + 16 * c] = 0.f;

  for (int f0 = 0; f0 < n_freq_pad; f0 += BN) {
    double re[4][4], im[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = 0.0;

    for (int k0 = 0; k0 < n_fft_pad; k0 += BK) {
      const int k = k0 + a_k;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int pos = a_off[i] + k;
        const bool in = a_ok[i] && k < n_fft && pos < lpad;
        s.a[a_k][a_m + 16 * i] = in ? static_cast<double>(__ldg(ypad + a_base[i] + pos)) : 0.0;
      }
      const int64_t c_idx = static_cast<int64_t>(k0 + c_k) * n_freq_pad + f0 + c_n;
      const float4 vr = __ldg(reinterpret_cast<const float4*>(cr + c_idx));
      const float4 vi = __ldg(reinterpret_cast<const float4*>(ci + c_idx));
      *reinterpret_cast<double2*>(&s.cr[c_k][c_n]) = make_double2(vr.x, vr.y);
      *reinterpret_cast<double2*>(&s.cr[c_k][c_n + 2]) = make_double2(vr.z, vr.w);
      *reinterpret_cast<double2*>(&s.ci[c_k][c_n]) = make_double2(vi.x, vi.y);
      *reinterpret_cast<double2*>(&s.ci[c_k][c_n + 2]) = make_double2(vi.z, vi.w);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const double2 a01 = *reinterpret_cast<const double2*>(&s.a[kk][ty * 4]);
        const double2 a23 = *reinterpret_cast<const double2*>(&s.a[kk][ty * 4 + 2]);
        const double a[4] = {a01.x, a01.y, a23.x, a23.y};
        double br[4], bi[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          br[j] = s.cr[kk][tx + 16 * j];
          bi[j] = s.ci[kk][tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            re[i][j] = fma(a[i], br[j], re[i][j]);
            im[i][j] = fma(a[i], bi[j], im[i][j]);
          }
      }
      __syncthreads();
    }

    // Power chunk and the matching Mel^T rows into shared memory. The last
    // __syncthreads of the depth loop guarantees no thread still reads
    // s.p or s.mel from the previous chunk.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float4 pv;
      pv.x = static_cast<float>(re[0][j] * re[0][j] + im[0][j] * im[0][j]);
      pv.y = static_cast<float>(re[1][j] * re[1][j] + im[1][j] * im[1][j]);
      pv.z = static_cast<float>(re[2][j] * re[2][j] + im[2][j] * im[2][j]);
      pv.w = static_cast<float>(re[3][j] * re[3][j] + im[3][j] * im[3][j]);
      *reinterpret_cast<float4*>(&s.p[tx + 16 * j][ty * 4]) = pv;
    }
#pragma unroll
    for (int i = 0; i < (BN * NMEL / 4) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int f = idx / (NMEL / 4);
      const int c4 = (idx % (NMEL / 4)) * 4;
      *reinterpret_cast<float4*>(&s.mel[f][c4]) = __ldg(reinterpret_cast<const float4*>(
          melt + static_cast<int64_t>(f0 + f) * NMEL + c4));
    }
    __syncthreads();

    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = s.acc[ty * 4 + i][tx + 16 * c];
#pragma unroll 4
    for (int f = 0; f < BN; ++f) {
      const float4 pv = *reinterpret_cast<const float4*>(&s.p[f][ty * 4]);
      const float p[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float m = s.mel[f][tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], m, acc[i][c]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) s.acc[ty * 4 + i][tx + 16 * c] = acc[i][c];
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r < rows) {
#pragma unroll
      for (int c = 0; c < 8; ++c)
        out[static_cast<int64_t>(r) * NMEL + tx + 16 * c] = s.acc[ty * 4 + i][tx + 16 * c];
    }
  }
}

}  // namespace

// Launches K1 on `stream` and returns cudaGetLastError() (0 on success).
// Shapes: ypad (batch, lpad); cr, ci (n_fft_pad, n_freq_pad); melt
// (n_freq_pad, 128); out (batch * n_frames, 128); all fp32, contiguous.
// n_fft_pad must be a multiple of 16 and n_freq_pad of 64.
extern "C" int asr_dft_power_mel(const void* ypad, const void* cr,
                                 const void* ci, const void* melt, void* out,
                                 int batch, int lpad, int n_frames, int hop,
                                 int n_fft, int n_fft_pad, int n_freq_pad,
                                 void* stream) {
  if (n_fft_pad % BK != 0 || n_freq_pad % BN != 0 || n_fft > n_fft_pad ||
      batch < 0 || n_frames < 0 || hop <= 0 || lpad <= 0 ||
      static_cast<int64_t>(batch) * lpad > INT_MAX ||
      static_cast<int64_t>(batch) * n_frames > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = batch * n_frames;
  if (rows == 0) return 0;
  const int smem = static_cast<int>(sizeof(Smem));
  // The shared-memory opt-in is per device: set it at the first launch on
  // each one. Setting it twice from racing threads is harmless.
  static std::atomic<bool> smem_set[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  if (!smem_set[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(
        dft_power_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[dev].store(true, std::memory_order_release);
  }
  const dim3 grid((rows + BM - 1) / BM);
  dft_power_mel_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ypad), static_cast<const float*>(cr),
      static_cast<const float*>(ci), static_cast<const float*>(melt),
      static_cast<float*>(out), rows, lpad, n_frames, hop, n_fft, n_fft_pad,
      n_freq_pad);
  return static_cast<int>(cudaGetLastError());
}
