// K4 on Hopper: in-kernel framing -> int8-digit rDFT on the tensor cores ->
// |.|^2 -> mel projection, with the per-row block scale undone on the output.
//
// Replaces asr_using_robust_nn_tpu/ops/pallas_mfcc.py::
// _int8_dft_power_mel_kernel, the Pallas TPU kernel behind
// mel_power_int8_pallas / mfcc_pallas_int8_batch. The decomposition is the
// one of ops/mfcc_int8.py: the block-scaled waveform is three base-128 int8
// digit signals d0, d1, d2, each rDFT constant three int8 digit matrices
// e0, e1, e2, and
//
//   x @ C = sum over the kept pairs (i, j) of (d_i @ e_j) * w_{i+j},
//
// where the six kept pairs are (0,0) | (0,1), (1,0) | (0,2), (2,0), (1,1)
// and the weight depends only on the digit sum i + j. Every product is an
// exact int32 sum, so pairs with the same digit sum share one accumulator
// (3 * 64 * 64 * n_fft < 2^31 for n_fft < 2^17); the three accumulators per
// side are converted to fp32 and combined smallest weight first, as the
// plain twin (ops/cuda_mfcc_int8.py::mel_power_int8_plain) does, so kernel
// and twin hold bit-equal power spectra and differ only in the order of the
// fp32 mel sums.
//
// Inputs: dig (3, batch, lalloc) int8, the digits of the center-padded,
// block-scaled waveforms, zero beyond the signal and long enough for every
// frame's n_fft_pad samples; ct (6, n_freq_pad, n_fft_pad) int8, the
// transposed digit matrices Cr0, Cr1, Cr2, Ci0, Ci1, Ci2 (zero rows past
// n_freq, zero columns past n_fft); melt (n_freq_pad, 128) fp32 with zero
// rows past n_freq; finv2 (batch) fp32, f^-2 of each row's power-of-two
// block scale f. Output (batch * n_frames, 128) fp32 mel power of the
// unscaled waveform; frame t of utterance b is the lalloc-strided signal at
// t*hop .. t*hop + n_fft_pad (the constants' zero columns blank the tail).
//
// What bounds it on an H100: arithmetic. A digit bucket of 1024 utterances
// is 45 056 frames x 2048 x 1088 bins x 12 int8 products = 2.4e12 int8
// operations against ~10 MB of digits, constants and output, so the bound
// is the int8 tensor-core rate (1 979 TOP/s dense: 1.2 ms), not memory.
//
// What the design does about it, simply: a block of 8 warps owns 64 frame
// rows and loops over 64-bin frequency chunks (the TPU kernel's sequential
// freq grid axis). Per chunk it stages 64-deep slices of the three digit
// frames and the six constant tiles in shared memory and runs
// nvcuda::wmma m16n16k16 s8 x s8 -> s32 products, each warp holding a
// 16 x 32 patch of all six accumulators (96 registers). The chunk's power
// tile lives only in shared memory and is folded into the block's
// (64 x 128) mel tile by fp32 FMAs on the CUDA cores, as in
// dft_power_mel.cu: neither the 4x-expanded digit frames nor the power
// spectrogram reach device memory. Framing is address arithmetic on the
// digit signals. Later work: wgmma with TMA-fed stages and a pipelined
// k loop (the stages here are loaded and consumed in turn), and the mel
// projection on the tensor cores.

#include <cuda_runtime.h>
#include <mma.h>

#include <atomic>
#include <climits>
#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int kMaxDevices = 64;

constexpr int BM = 64;        // frame rows per block
constexpr int BN = 64;        // frequency bins per chunk
constexpr int BK = 64;        // n_fft depth per staged step
constexpr int LDS = BK + 16;  // staged row stride in bytes (bank spread)
constexpr int NMEL = 128;     // mel bands (FrontendConfig.n_mels)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PAD_M = BM + 4;
constexpr int PAD_MEL = NMEL + 4;

struct Stage {                // live during the depth loop
  signed char a[3][BM][LDS];  // digit frames d0, d1, d2: a[d][row][k]
  signed char b[6][BN][LDS];  // Cr0..2, Ci0..2 tiles, transposed: b[m][bin][k]
};

struct Post {                      // live after it; shares the stage's bytes
  int scratch[WARPS][16][32];      // one warp's accumulator patch at a time
  float p[BN][PAD_M];              // power chunk, transposed: p[bin][row]
  float mel[BN][NMEL];             // Mel^T rows of the chunk
};

struct Smem {
  union {
    Stage st;
    Post po;
  };
  float acc[BM][PAD_MEL];  // the block's mel tile (each element thread-private)
};

__device__ __forceinline__ int load_word(const signed char* __restrict__ p,
                                         bool aligned4) {
  if (aligned4) return __ldg(reinterpret_cast<const int*>(p));
  const unsigned b0 = static_cast<unsigned char>(__ldg(p));
  const unsigned b1 = static_cast<unsigned char>(__ldg(p + 1));
  const unsigned b2 = static_cast<unsigned char>(__ldg(p + 2));
  const unsigned b3 = static_cast<unsigned char>(__ldg(p + 3));
  return static_cast<int>(b0 | (b1 << 8) | (b2 << 16) | (b3 << 24));
}

__global__ void __launch_bounds__(THREADS)
int8_dft_power_mel_kernel(const signed char* __restrict__ dig,
                          const signed char* __restrict__ ct,
                          const float* __restrict__ melt,
                          const float* __restrict__ finv2,
                          float* __restrict__ out, int rows, int64_t plane,
                          int lalloc, int n_frames, int hop, int n_fft_pad,
                          int n_freq_pad, float w0, float w1, float w2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int row0 = blockIdx.x * BM;
  const bool aligned4 = (hop % 4) == 0;  // lalloc is a multiple of 16

  // Staging map of the digit frames: this thread loads the 4-byte word at
  // depth a_k of rows a_m + 16*i, for each digit. Row r is frame t of
  // utterance b, starting at b*lalloc + t*hop; rows past the last one read
  // row 0 (valid memory) and are never written out.
  const int a_k = (tid % 16) * 4;
  const int a_m = tid / 16;
  int a_src[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + a_m + 16 * i;
    const int rr = r < rows ? r : 0;
    const int b = rr / n_frames;
    a_src[i] = b * lalloc + (rr - b * n_frames) * hop + a_k;
  }
  // Staging map of the constants: 16 bytes of one bin of each matrix.
  const int c_n = tid / 4;
  const int c_q = (tid % 4) * 16;

  // MMA map: this warp owns rows wr*16.. and bins wc*32.. of the chunk.
  const int wr = warp / 2;
  const int wc = warp % 2;
  // Mel map (as in dft_power_mel.cu): rows ty*4 + i, mel bands tx + 16*c.
  const int ty = tid / 16;
  const int tx = tid % 16;
  // Combine map: one row and 16 bins of the warp's 16 x 32 patch.
  const int q_row = lane / 2;
  const int q_col = (lane % 2) * 16;

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) s.acc[ty * 4 + i][tx + 16 * c] = 0.f;

  const float wg[3] = {w0, w1, w2};

  for (int f0 = 0; f0 < n_freq_pad; f0 += BN) {
    // acc[j][side][g]: bins wc*32 + 16*j, side 0 = re, 1 = im, digit sum g
    wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2][3];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int sd = 0; sd < 2; ++sd)
#pragma unroll
        for (int g = 0; g < 3; ++g) wmma::fill_fragment(acc[j][sd][g], 0);

    for (int k0 = 0; k0 < n_fft_pad; k0 += BK) {
      __syncthreads();  // the previous stage (or the mel phase) is consumed
#pragma unroll
      for (int d = 0; d < 3; ++d)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<int*>(&s.st.a[d][a_m + 16 * i][a_k]) =
              load_word(dig + d * plane + a_src[i] + k0, aligned4);
#pragma unroll
      for (int m = 0; m < 6; ++m)
        *reinterpret_cast<int4*>(&s.st.b[m][c_n][c_q]) =
            __ldg(reinterpret_cast<const int4*>(
                ct + (static_cast<int64_t>(m) * n_freq_pad + f0 + c_n) *
                         n_fft_pad + k0 + c_q));
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                       wmma::row_major> fa[3];
#pragma unroll
        for (int d = 0; d < 3; ++d)
          wmma::load_matrix_sync(fa[d], &s.st.a[d][wr * 16][kk], LDS);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int sd = 0; sd < 2; ++sd) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                           wmma::col_major> fb[3];
#pragma unroll
            for (int e = 0; e < 3; ++e)
              wmma::load_matrix_sync(
                  fb[e], &s.st.b[sd * 3 + e][wc * 32 + j * 16][kk], LDS);
            wmma::mma_sync(acc[j][sd][0], fa[0], fb[0], acc[j][sd][0]);
            wmma::mma_sync(acc[j][sd][1], fa[0], fb[1], acc[j][sd][1]);
            wmma::mma_sync(acc[j][sd][1], fa[1], fb[0], acc[j][sd][1]);
            wmma::mma_sync(acc[j][sd][2], fa[0], fb[2], acc[j][sd][2]);
            wmma::mma_sync(acc[j][sd][2], fa[2], fb[0], acc[j][sd][2]);
            wmma::mma_sync(acc[j][sd][2], fa[1], fb[1], acc[j][sd][2]);
          }
      }
    }
    __syncthreads();  // every warp is done with the stage: Post may overwrite

    // int32 -> fp32 and the combine, smallest weight first. A fragment's
    // element order is opaque, so each accumulator goes through the warp's
    // scratch patch and is read back by position. The products by the
    // power-of-two weights are exact; __fadd_rn / __fmul_rn keep the
    // compiler from contracting, so the power equals the twin's bit for bit.
    float side[2][16];
#pragma unroll
    for (int sd = 0; sd < 2; ++sd)
#pragma unroll
      for (int g = 2; g >= 0; --g) {
        wmma::store_matrix_sync(&s.po.scratch[warp][0][0], acc[0][sd][g], 32,
                                wmma::mem_row_major);
        wmma::store_matrix_sync(&s.po.scratch[warp][0][16], acc[1][sd][g], 32,
                                wmma::mem_row_major);
        __syncwarp();
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const float t = __fmul_rn(
              static_cast<float>(s.po.scratch[warp][q_row][q_col + e]), wg[g]);
          side[sd][e] = g == 2 ? t : __fadd_rn(side[sd][e], t);
        }
        __syncwarp();
      }
#pragma unroll
    for (int e = 0; e < 16; ++e)
      s.po.p[wc * 32 + q_col + e][wr * 16 + q_row] =
          __fadd_rn(__fmul_rn(side[0][e], side[0][e]),
                    __fmul_rn(side[1][e], side[1][e]));
#pragma unroll
    for (int i = 0; i < (BN * NMEL / 4) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int f = idx / (NMEL / 4);
      const int c4 = (idx % (NMEL / 4)) * 4;
      *reinterpret_cast<float4*>(&s.po.mel[f][c4]) =
          __ldg(reinterpret_cast<const float4*>(
              melt + static_cast<int64_t>(f0 + f) * NMEL + c4));
    }
    __syncthreads();

    float macc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) macc[i][c] = s.acc[ty * 4 + i][tx + 16 * c];
#pragma unroll 4
    for (int f = 0; f < BN; ++f) {
      const float4 pv = *reinterpret_cast<const float4*>(&s.po.p[f][ty * 4]);
      const float p[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float m = s.po.mel[f][tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) macc[i][c] = fmaf(p[i], m, macc[i][c]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) s.acc[ty * 4 + i][tx + 16 * c] = macc[i][c];
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r < rows) {
      const float u = __ldg(finv2 + r / n_frames);  // undo the block scale
#pragma unroll
      for (int c = 0; c < 8; ++c)
        out[static_cast<int64_t>(r) * NMEL + tx + 16 * c] =
            s.acc[ty * 4 + i][tx + 16 * c] * u;
    }
  }
}

}  // namespace

// Launches K4 on `stream` and returns cudaGetLastError() (0 on success).
// Shapes: dig (3, batch, lalloc) int8; ct (6, n_freq_pad, n_fft_pad) int8;
// melt (n_freq_pad, 128) fp32; finv2 (batch) fp32; out (batch * n_frames,
// 128) fp32; all contiguous. lalloc must be a multiple of 16 and at least
// (n_frames - 1) * hop + n_fft_pad; n_fft_pad and n_freq_pad multiples of 64.
// w0, w1, w2 are the weights of the digit sums 0, 1, 2.
extern "C" int asr_int8_dft_power_mel(const void* dig, const void* ct,
                                      const void* melt, const void* finv2,
                                      void* out, int batch, int lalloc,
                                      int n_frames, int hop, int n_fft_pad,
                                      int n_freq_pad, float w0, float w1,
                                      float w2, void* stream) {
  if (n_fft_pad % BK != 0 || n_freq_pad % BN != 0 || n_fft_pad <= 0 ||
      n_fft_pad >= (1 << 17) || batch < 0 || n_frames < 0 || hop <= 0 ||
      lalloc <= 0 || lalloc % 16 != 0 ||
      static_cast<int64_t>(batch) * lalloc > INT_MAX ||
      static_cast<int64_t>(batch) * n_frames > INT_MAX ||
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
        int8_dft_power_mel_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[dev].store(true, std::memory_order_release);
  }
  const dim3 grid((rows + BM - 1) / BM);
  int8_dft_power_mel_kernel<<<grid, THREADS, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const signed char*>(dig),
      static_cast<const signed char*>(ct), static_cast<const float*>(melt),
      static_cast<const float*>(finv2), static_cast<float*>(out), rows,
      static_cast<int64_t>(batch) * lalloc, lalloc, n_frames, hop, n_fft_pad,
      n_freq_pad, w0, w1, w2);
  return static_cast<int>(cudaGetLastError());
}
