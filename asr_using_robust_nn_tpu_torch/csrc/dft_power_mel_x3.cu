// K5 on Hopper: in-kernel framing -> rDFT -> |.|^2 -> mel projection with
// every product as a three-pass bf16 split on the tensor cores.
//
// Replaces asr_using_robust_nn_tpu/ops/pallas_mfcc.py::
// _dft_power_mel_x3_kernel, the Pallas TPU kernel behind
// mel_power_bf16x3_pallas / mfcc_pallas_bf16x3_batch (built for the speaker
// preset's odd n_fft = 441). An fp32 value x is split as hi = bf16(x),
// lo = bf16(x - hi); a product a @ b is hi_a @ hi_b + hi_a @ lo_b +
// lo_a @ hi_b with fp32 sums, the lo @ lo term dropped (~2^-16 relative).
// The frames are split on their way into shared memory, the constants
// arrive split, and the power is split again before the mel products:
// six bf16 products for re and im, three for the mel projection.
//
// Inputs: ypad (batch, lalloc) fp32, the center-padded waveforms, zero
// beyond the signal and long enough for every frame's n_fft_pad samples;
// ct (4, n_freq_pad, n_fft_pad) bf16, the transposed Cr_hi, Cr_lo, Ci_hi,
// Ci_lo (zero rows past n_freq, zero columns past n_fft); melt
// (2, n_freq_pad, 128) bf16, Mel^T hi and lo with zero rows past n_freq.
// Output (rows_pad, 128) fp32 mel power, rows_pad = batch * n_frames rounded
// up to 64; the rows past batch * n_frames are scratch.
//
// What bounds it on an H100: arithmetic. A speaker bucket of 1024 one-second
// windows is 103 424 frames x 448 x 256 bins x 6 products plus 256 x 128 x 3
// = 1.6e11 bf16 FLOP against ~150 MB of waveforms, constants and output:
// ~1000 FLOP per byte, above the ridge, so the bound is the bf16 tensor-core
// rate (989 TFLOP/s dense: 0.17 ms), with the memory time (0.05 ms) behind.
//
// What the design does about it, simply: a block of 8 warps owns 64 frame
// rows and loops over 64-bin frequency chunks (the TPU kernel's sequential
// freq grid axis). Per chunk it stages 64-deep slices of the split frames
// and of the four constant tiles and runs nvcuda::wmma m16n16k16 bf16
// products with fp32 accumulators, all three passes into one accumulator.
// The chunk's power tile goes through shared memory once to be split, and
// the block's (64 x 128) mel tile stays in the warps' accumulator
// fragments over all chunks: neither the frames nor the power spectrogram
// reach device memory. Framing is address arithmetic on the waveform.
// Later work: wgmma with TMA-fed, pipelined stages.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <atomic>
#include <climits>
#include <cstdint>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kMaxDevices = 64;

constexpr int BM = 64;       // frame rows per block
constexpr int BN = 64;       // frequency bins per chunk
constexpr int BK = 64;       // n_fft depth per staged step
constexpr int LDS = BK + 8;  // staged row stride in elements (bank spread)
constexpr int NMEL = 128;    // mel bands (FrontendConfig.n_mels)
constexpr int LDM = NMEL + 8;
constexpr int LDP = BN + 4;
constexpr int THREADS = 256;

struct Stage {          // live during the depth loop
  bf16 a[2][BM][LDS];   // frames hi, lo: a[h][row][k]
  bf16 b[4][BN][LDS];   // Cr_hi, Cr_lo, Ci_hi, Ci_lo, transposed: b[m][bin][k]
};

struct Post {             // live after it; shares the stage's bytes
  bf16 p[2][BM][LDS];     // power hi, lo: p[h][row][bin]
  bf16 mel[2][BN][LDM];   // Mel^T hi, lo rows of the chunk: mel[h][bin][band]
};

struct Smem {
  union {
    Stage st;
    Post po;
  };
  float pf[BM][LDP];  // the chunk's fp32 power tile, before its split
};

__device__ __forceinline__ void split(float x, bf16& hi, bf16& lo) {
  hi = __float2bfloat16_rn(x);
  lo = __float2bfloat16_rn(__fsub_rn(x, __bfloat162float(hi)));
}

__global__ void __launch_bounds__(THREADS)
dft_power_mel_x3_kernel(const float* __restrict__ ypad,
                        const bf16* __restrict__ ct,
                        const bf16* __restrict__ melt,
                        float* __restrict__ out, int rows, int lalloc,
                        int n_frames, int hop, int n_fft_pad, int n_freq_pad) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int row0 = blockIdx.x * BM;

  // Staging map of the frames: depth a_k of rows a_m + 4*i. Row r is frame
  // t of utterance b, starting at b*lalloc + t*hop; rows past the last one
  // read row 0 (valid memory) and land in the output's scratch rows.
  const int a_k = tid % BK;
  const int a_m = tid / BK;
  int a_src[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int r = row0 + a_m + 4 * i;
    const int rr = r < rows ? r : 0;
    const int b = rr / n_frames;
    a_src[i] = b * lalloc + (rr - b * n_frames) * hop + a_k;
  }
  // Staging map of the constants: 8 elements (16 bytes) of bins c_n, c_n+32.
  const int c_n = tid / 8;
  const int c_q = (tid % 8) * 8;
  // Staging map of Mel^T: 8 bands of bins m_n + 16*i.
  const int m_n = tid / 16;
  const int m_q = (tid % 16) * 8;

  // MMA map: rows wr*16..; DFT bins wc*32.. of the chunk; mel bands wc*64..
  const int wr = warp / 2;
  const int wc = warp % 2;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> macc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(macc[j], 0.f);

  for (int f0 = 0; f0 < n_freq_pad; f0 += BN) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int sd = 0; sd < 2; ++sd) wmma::fill_fragment(acc[j][sd], 0.f);

    for (int k0 = 0; k0 < n_fft_pad; k0 += BK) {
      __syncthreads();  // the previous stage (or the mel phase) is consumed
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        bf16 hi, lo;
        split(__ldg(ypad + a_src[i] + k0), hi, lo);
        s.st.a[0][a_m + 4 * i][a_k] = hi;
        s.st.a[1][a_m + 4 * i][a_k] = lo;
      }
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint4*>(&s.st.b[m][c_n + 32 * h][c_q]) =
              __ldg(reinterpret_cast<const uint4*>(
                  ct + (static_cast<int64_t>(m) * n_freq_pad + f0 + c_n +
                        32 * h) * n_fft_pad + k0 + c_q));
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
            fa[2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          wmma::load_matrix_sync(fa[h], &s.st.a[h][wr * 16][kk], LDS);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int sd = 0; sd < 2; ++sd) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
                fb[2];
#pragma unroll
            for (int h = 0; h < 2; ++h)
              wmma::load_matrix_sync(
                  fb[h], &s.st.b[sd * 2 + h][wc * 32 + j * 16][kk], LDS);
            wmma::mma_sync(acc[j][sd], fa[0], fb[0], acc[j][sd]);  // hi hi
            wmma::mma_sync(acc[j][sd], fa[0], fb[1], acc[j][sd]);  // hi lo
            wmma::mma_sync(acc[j][sd], fa[1], fb[0], acc[j][sd]);  // lo hi
          }
      }
    }

    // power = re^2 + im^2, element by element on fragments of one type
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < acc[j][0].num_elements; ++e)
        acc[j][0].x[e] = __fadd_rn(__fmul_rn(acc[j][0].x[e], acc[j][0].x[e]),
                                   __fmul_rn(acc[j][1].x[e], acc[j][1].x[e]));
      wmma::store_matrix_sync(&s.pf[wr * 16][wc * 32 + j * 16], acc[j][0], LDP,
                              wmma::mem_row_major);
    }
    __syncthreads();  // pf is whole; every warp is done with the stage

    // split the power into the mel products' A operand; stage Mel^T
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      bf16 hi, lo;
      split(s.pf[a_m + 4 * i][a_k], hi, lo);
      s.po.p[0][a_m + 4 * i][a_k] = hi;
      s.po.p[1][a_m + 4 * i][a_k] = lo;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<uint4*>(&s.po.mel[h][m_n + 16 * i][m_q]) =
            __ldg(reinterpret_cast<const uint4*>(
                melt + (static_cast<int64_t>(h) * n_freq_pad + f0 + m_n +
                        16 * i) * NMEL + m_q));
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BN; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        wmma::load_matrix_sync(fa[h], &s.po.p[h][wr * 16][kk], LDS);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
            fb[2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          wmma::load_matrix_sync(fb[h], &s.po.mel[h][kk][wc * 64 + j * 16],
                                 LDM);
        wmma::mma_sync(macc[j], fa[0], fb[0], macc[j]);
        wmma::mma_sync(macc[j], fa[0], fb[1], macc[j]);
        wmma::mma_sync(macc[j], fa[1], fb[0], macc[j]);
      }
    }
  }

  // out has whole 64-row tiles, so the fragments store straight to it
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(
        out + static_cast<int64_t>(row0 + wr * 16) * NMEL + wc * 64 + j * 16,
        macc[j], NMEL, wmma::mem_row_major);
}

}  // namespace

// Launches K5 on `stream` and returns cudaGetLastError() (0 on success).
// Shapes: ypad (batch, lalloc) fp32; ct (4, n_freq_pad, n_fft_pad) bf16;
// melt (2, n_freq_pad, 128) bf16; out (rows_pad, 128) fp32 with rows_pad =
// batch * n_frames rounded up to 64; all contiguous. lalloc must be at least
// (n_frames - 1) * hop + n_fft_pad; n_fft_pad and n_freq_pad multiples of 64.
extern "C" int asr_dft_power_mel_x3(const void* ypad, const void* ct,
                                    const void* melt, void* out, int batch,
                                    int lalloc, int n_frames, int hop,
                                    int n_fft_pad, int n_freq_pad,
                                    void* stream) {
  if (n_fft_pad % BK != 0 || n_freq_pad % BN != 0 || n_fft_pad <= 0 ||
      batch < 0 || n_frames < 0 || hop <= 0 || lalloc <= 0 ||
      static_cast<int64_t>(batch) * lalloc > INT_MAX ||
      static_cast<int64_t>(batch) * n_frames > INT_MAX - BM ||
      (n_frames > 0 &&
       static_cast<int64_t>(n_frames - 1) * hop + n_fft_pad > lalloc)) {
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
        dft_power_mel_x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[dev].store(true, std::memory_order_release);
  }
  const dim3 grid((rows + BM - 1) / BM);
  dft_power_mel_x3_kernel<<<grid, THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ypad), static_cast<const bf16*>(ct),
      static_cast<const bf16*>(melt), static_cast<float*>(out), rows, lalloc,
      n_frames, hop, n_fft_pad, n_freq_pad);
  return static_cast<int>(cudaGetLastError());
}
