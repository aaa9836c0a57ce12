// K4 on Hopper: in-kernel framing -> int8-digit rDFT on the tensor cores ->
// |.|^2 -> banded mel fold, with the per-row block scale undone on the
// output.
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
// frame's n_fft_pad samples; ct (3, n_freq_pad / 32, 64, n_fft_pad) int8:
// for digit e and each group of 32 bins, the 32 rows of Cr_e^T then the 32
// rows of Ci_e^T (zero rows past n_freq, zero columns past n_fft); the
// banded mel weights (band_start, band_off, band_w, as the FFT bodies read
// them, ops/cuda_mfcc.py::mel_bands) and chunk_bands (n_freq_pad / 64, 2),
// the bands [lo, hi) that touch each 64-bin chunk; finv2 (batch) fp32, f^-2
// of each row's power-of-two block scale f. Output (batch * n_frames, 128)
// fp32 mel power of the unscaled waveform; frame t of utterance b is the
// lalloc-strided signal at t*hop .. t*hop + n_fft_pad (the constants' zero
// columns blank the tail).
//
// What bounds it on an H100: arithmetic. A digit bucket of 1024 utterances
// is 45 056 frames x 2048 x 1088 bins x 12 int8 products = 2.4e12 int8
// operations against ~10 MB of digits, constants and output, so the bound
// is the int8 tensor-core rate (1 979 TOP/s dense: 1.2 ms), not memory. The
// mel fold is 0.2 GFLOP of fp32 once banded (12.6 dense). What holds this
// design back instead is the staging of its operands: every block re-reads
// its digit frames once a chunk and all the constants once, ~14 GB from L2
// a digit bucket; staged alone that takes about twice what the products
// take alone (tools/k4_split.py, PERF.md). TMA copies, multicast of the
// constant tiles across a cluster, are the next step.
//
// The design:
//  * A block of two warpgroups owns 64 frame rows and walks 64-bin chunks
//    of the spectrum; warpgroup g takes bins 32 g .. 32 g + 31 of a chunk.
//    Each step stages one 128-deep slice: the three digit frames (A, 64
//    rows of 128 bytes each) and, per warpgroup, the three [Cr_e | Ci_e]
//    tiles (B, 64 rows: 32 bins of re, then the same 32 of im). Both
//    operands are K-major, which is what 8-bit wgmma takes.
//  * Products: wgmma.mma_async m64n64k32 .s32.s8.s8 from 128-byte swizzled
//    shared memory, descriptors advanced 32 bytes a k-step, as
//    gemm_sm90.cuh's bf16 tiles (a 128-deep int8 row is 128 bytes, like a
//    64-deep bf16 one). Six products a k-step a warpgroup into three s32
//    accumulators (digit sums 2, 1, 0) of 32 registers: 96 registers a
//    thread. re and im of one bin sit in the same thread (registers j and
//    j + 16), so the power is formed in registers.
//  * The steps (chunks x depth slices, one sequence, so the next chunk's
//    first slices load while this chunk's power is folded) run through
//    gemm_sm90.cuh's ring_loop: two stages of 72 KB, filled by cp.async.
//    Framing is address arithmetic on the digit signals: 16-byte copies
//    when every frame starts 16-byte aligned (hop % 16 == 0: the digit
//    preset), 4-byte copies when hop % 4 == 0 (the speaker preset's 220),
//    byte loads otherwise.
//  * Mel fold: the chunk's power tile (64 bins x 64 rows, fp32) goes to
//    shared memory and is folded through the band tables into the block's
//    resident mel tile (128 x 64); a band that straddles two chunks takes a
//    partial sum from each. Neither the frames nor the power spectrogram
//    reach device memory.
// Shared memory: 2 x 72 KB ring + 17 KB power tile + 34 KB mel tile + 1 KB
// alignment = 199 680 bytes, one block an SM. ptxas -v (sm_90a, CUDA 12.8):
// 148 registers with 16-byte copies, 146 with 4-byte copies, 232 with byte
// loads; no spills, no stack frame.

#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstdint>

#include "gemm_sm90.cuh"

namespace {

constexpr int kMaxDevices = 64;

constexpr int BM = 64;          // frame rows a block
constexpr int BC = 64;          // bins a chunk, 32 a warpgroup
constexpr int BK = 128;         // depth a step (int8 entries = bytes)
constexpr int NMEL = 128;       // mel bands (FrontendConfig.n_mels)
constexpr int THREADS = 256;    // two warpgroups
constexpr int STAGES = 2;
constexpr int TILE = 64 * BK;   // one 64-row operand tile
constexpr int STAGE_BYTES = 9 * TILE;  // A: 3 digits; B: 2 groups x 3 digits
constexpr int PAD_M = BM + 4;
constexpr int RING_BYTES = STAGES * STAGE_BYTES;
constexpr int P_BYTES = BC * PAD_M * 4;
constexpr int MEL_BYTES = NMEL * PAD_M * 4;
constexpr int SMEM_BYTES = sm90::kAlign + RING_BYTES + P_BYTES + MEL_BYTES;
static_assert(SMEM_BYTES <= 232448, "one block an SM");

// d (64 x 64 s32, 32 registers a thread) += A (64 x 32) . B (32 x 64), s8
// operands from shared memory, both K-major.
__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ int load_word(const signed char* __restrict__ p) {
  const unsigned b0 = static_cast<unsigned char>(__ldg(p));
  const unsigned b1 = static_cast<unsigned char>(__ldg(p + 1));
  const unsigned b2 = static_cast<unsigned char>(__ldg(p + 2));
  const unsigned b3 = static_cast<unsigned char>(__ldg(p + 3));
  return static_cast<int>(b0 | (b1 << 8) | (b2 << 16) | (b3 << 24));
}

// byte offset of 16-byte chunk `ch` of row `row` in a swizzled tile
__device__ __forceinline__ uint32_t swz(int row, int ch) {
  return row * 128 + ((ch ^ (row & 7)) << 4);
}

// AL: 16, 4 or 1, the alignment every frame's start has in the digit
// signal (16-byte copies, 4-byte copies, byte loads).
template <int AL>
__global__ void __launch_bounds__(THREADS, 1)
int8_dft_power_mel_kernel(const signed char* __restrict__ dig,
                          const signed char* __restrict__ ct,
                          const int* __restrict__ band_start,
                          const int* __restrict__ band_off,
                          const float* __restrict__ band_w,
                          const int* __restrict__ chunk_bands,
                          const float* __restrict__ finv2,
                          float* __restrict__ out, int rows, int64_t plane,
                          int lalloc, int n_frames, int hop, int n_fft_pad,
                          int n_freq_pad, float w0, float w1, float w2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = sm90::aligned_smem(smem_raw);
  const uint32_t ring = sm90::smem_u32(smem);
  float* ptile = reinterpret_cast<float*>(smem + RING_BYTES);  // [bin][row]
  float* mel = ptile + BC * PAD_M;                            // [band][row]
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int row0 = blockIdx.x * BM;
  const int nk = n_fft_pad / BK;  // step s is slice s % nk of chunk s / nk
  const int groups = n_freq_pad / 32;

  // Copy map of a step: thread tid copies 16-byte chunk tid % 8 of rows
  // tid / 8 and tid / 8 + 32 of each A tile, and of rows tid / 8 + 32 i of
  // the six B tiles. Row r of A is frame row0 + r: utterance b, frame t,
  // at b * lalloc + t * hop; rows past the last one read row 0.
  const int ch = tid % 8;
  const int cr = tid / 8;
  int a_src[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + cr + 32 * h;
    const int rr = r < rows ? r : 0;
    const int b = rr / n_frames;
    a_src[h] = b * lalloc + (rr - b * n_frames) * hop + ch * 16;
  }

  for (int i = tid; i < NMEL * PAD_M; i += THREADS) mel[i] = 0.f;

  auto fill = [&](int s) {
    const int c = s / nk, k0 = (s % nk) * BK;
    const uint32_t st = ring + (s % STAGES) * STAGE_BYTES;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = cr + 32 * h;
        const uint32_t dst = st + d * TILE + swz(row, ch);
        const signed char* src = dig + d * plane + a_src[h] + k0;
        if (AL == 16) {
          sm90::cp_async16(dst, src);
        } else if (AL == 4) {
#pragma unroll
          for (int w = 0; w < 4; ++w) cp_async4(dst + 4 * w, src + 4 * w);
        } else {
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            const int v = load_word(src + 4 * w);
            asm volatile("st.shared.b32 [%0], %1;"
                         :: "r"(dst + 4 * w), "r"(v) : "memory");
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < 6; ++m) {  // group 2c + m / 3, digit m % 3
      const int g = 2 * c + m / 3, e = m % 3;
      const signed char* src =
          ct + ((static_cast<int64_t>(e) * groups + g) * 64) * n_fft_pad + k0 +
          ch * 16;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = cr + 32 * h;
        sm90::cp_async16(st + (3 + m) * TILE + swz(row, ch),
                         src + static_cast<int64_t>(row) * n_fft_pad);
      }
    }
  };

  // acc[g]: digit sum g; register j < 16 is re, j + 16 im of the same bin
  int acc[3][32];
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[g][j] = 0;
  const float wgt[3] = {w0, w1, w2};

  auto consume = [&](int s) {
    const int c = s / nk;
    const uint32_t st = ring + (s % STAGES) * STAGE_BYTES;
    const uint32_t b = st + (3 + 3 * wg) * TILE;
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      uint64_t da[3], db[3];
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        da[e] = sm90::make_desc(st + e * TILE + kk * 32);
        db[e] = sm90::make_desc(b + e * TILE + kk * 32);
      }
      wgmma_s8(acc[2], da[0], db[2]);
      wgmma_s8(acc[2], da[2], db[0]);
      wgmma_s8(acc[2], da[1], db[1]);
      wgmma_s8(acc[1], da[0], db[1]);
      wgmma_s8(acc[1], da[1], db[0]);
      wgmma_s8(acc[0], da[0], db[0]);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait0();
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int j = 0; j < 32; ++j) asm volatile("" : "+r"(acc[g][j])::"memory");
    if (s % nk != nk - 1) return;  // the chunk's last slice

    // The chunk is summed. int32 -> fp32 and the combine, smallest weight
    // first; the products by the power-of-two weights are exact, and
    // __fadd_rn / __fmul_rn keep the compiler from contracting, so the power
    // equals the twin's bit for bit.
    // the fragment map of gemm_sm90.cuh inside this warpgroup
    const int r0 = ((tid % 128) >> 5) * 16 + ((tid & 31) >> 2);
    const int c0 = sm90::frag_col();
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float side[2];
#pragma unroll
      for (int sd = 0; sd < 2; ++sd) {
        const int jj = j + 16 * sd;
        float v = __fmul_rn(static_cast<float>(acc[2][jj]), wgt[2]);
        v = __fadd_rn(v, __fmul_rn(static_cast<float>(acc[1][jj]), wgt[1]));
        v = __fadd_rn(v, __fmul_rn(static_cast<float>(acc[0][jj]), wgt[0]));
        side[sd] = v;
      }
      const int nb = j / 4, h = (j / 2) % 2, q = j % 2;
      ptile[(32 * wg + nb * 8 + c0 + q) * PAD_M + r0 + 8 * h] =
          __fadd_rn(__fmul_rn(side[0], side[0]), __fmul_rn(side[1], side[1]));
    }
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int j = 0; j < 32; ++j) acc[g][j] = 0;
    __syncthreads();  // both warpgroups' halves of the power tile are in

    // Banded fold: one (band, row) item at a time, the band's bins that
    // fall in this chunk; consecutive threads take consecutive rows.
    const int f0 = c * BC;
    const int lo = __ldg(chunk_bands + 2 * c);
    const int hi = __ldg(chunk_bands + 2 * c + 1);
    for (int idx = tid; idx < (hi - lo) * BM; idx += THREADS) {
      const int band = lo + idx / BM, row = idx % BM;
      const int bs = __ldg(band_start + band);
      const int o0 = __ldg(band_off + band);
      const int be = bs + __ldg(band_off + band + 1) - o0;
      const int i0 = max(bs, f0), i1 = min(be, f0 + BC);
      float part = 0.f;
      for (int i = i0; i < i1; ++i) {
        part = fmaf(ptile[(i - f0) * PAD_M + row], __ldg(band_w + o0 + i - bs),
                    part);
      }
      if (i1 > i0) mel[band * PAD_M + row] += part;
    }
  };

  const int n_steps = (n_freq_pad / BC) * nk;
  sm90::ring_loop<STAGES>(n_steps, fill, consume);
  __syncthreads();  // the last fold is done

  for (int idx = tid; idx < BM * NMEL; idx += THREADS) {
    const int row = idx / NMEL, band = idx % NMEL;
    const int r = row0 + row;
    if (r < rows) {
      const float u = __ldg(finv2 + r / n_frames);  // undo the block scale
      out[static_cast<int64_t>(r) * NMEL + band] = mel[band * PAD_M + row] * u;
    }
  }
}

template <int AL>
cudaError_t launch(int dev, dim3 grid, cudaStream_t stream,
                   const signed char* dig, const signed char* ct,
                   const int* band_start, const int* band_off,
                   const float* band_w, const int* chunk_bands,
                   const float* finv2, float* out, int rows, int64_t plane,
                   int lalloc, int n_frames, int hop, int n_fft_pad,
                   int n_freq_pad, float w0, float w1, float w2) {
  // The shared-memory opt-in is per device: set it at the first launch on
  // each one. Setting it twice from racing threads is harmless.
  static std::atomic<bool> smem_set[kMaxDevices];
  if (!smem_set[dev].load(std::memory_order_acquire)) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_dft_power_mel_kernel<AL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return err;
    smem_set[dev].store(true, std::memory_order_release);
  }
  int8_dft_power_mel_kernel<AL><<<grid, THREADS, SMEM_BYTES, stream>>>(
      dig, ct, band_start, band_off, band_w, chunk_bands, finv2, out, rows,
      plane, lalloc, n_frames, hop, n_fft_pad, n_freq_pad, w0, w1, w2);
  return cudaGetLastError();
}

}  // namespace

// Launches K4 on `stream` and returns cudaGetLastError() (0 on success).
// Shapes: dig (3, batch, lalloc) int8; ct (3, n_freq_pad / 32, 64,
// n_fft_pad) int8; band_start (128) i32, band_off (129) i32, band_w
// (band_off[128]) fp32 with every band inside [0, n_freq_pad);
// chunk_bands (n_freq_pad / 64, 2) i32; finv2 (batch) fp32; out (batch *
// n_frames, 128) fp32; all contiguous device arrays. lalloc must be a
// multiple of 16 and at least (n_frames - 1) * hop + n_fft_pad; n_fft_pad a
// multiple of 128, n_freq_pad of 64. w0, w1, w2 are the weights of the
// digit sums 0, 1, 2.
extern "C" int asr_int8_dft_power_mel(const void* dig, const void* ct,
                                      const void* band_start,
                                      const void* band_off,
                                      const void* band_w,
                                      const void* chunk_bands,
                                      const void* finv2, void* out, int batch,
                                      int lalloc, int n_frames, int hop,
                                      int n_fft_pad, int n_freq_pad, float w0,
                                      float w1, float w2, void* stream) {
  if (n_fft_pad % BK != 0 || n_freq_pad % BC != 0 || n_fft_pad <= 0 ||
      n_freq_pad <= 0 || n_fft_pad >= (1 << 17) || batch < 0 ||
      n_frames < 0 || hop <= 0 || lalloc <= 0 || lalloc % 16 != 0 ||
      static_cast<int64_t>(batch) * lalloc > INT_MAX ||
      static_cast<int64_t>(batch) * n_frames > INT_MAX ||
      (n_frames > 0 &&
       static_cast<int64_t>(n_frames - 1) * hop + n_fft_pad > lalloc)) {
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
  const dim3 grid((rows + BM - 1) / BM);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* d = static_cast<const signed char*>(dig);
  const auto* c = static_cast<const signed char*>(ct);
  const auto* bs = static_cast<const int*>(band_start);
  const auto* bo = static_cast<const int*>(band_off);
  const auto* bw = static_cast<const float*>(band_w);
  const auto* cb = static_cast<const int*>(chunk_bands);
  const auto* fi = static_cast<const float*>(finv2);
  auto* o = static_cast<float*>(out);
  const int64_t plane = static_cast<int64_t>(batch) * lalloc;
  if (hop % 16 == 0) {
    err = launch<16>(dev, grid, st, d, c, bs, bo, bw, cb, fi, o, rows, plane,
                     lalloc, n_frames, hop, n_fft_pad, n_freq_pad, w0, w1, w2);
  } else if (hop % 4 == 0) {
    err = launch<4>(dev, grid, st, d, c, bs, bo, bw, cb, fi, o, rows, plane,
                    lalloc, n_frames, hop, n_fft_pad, n_freq_pad, w0, w1, w2);
  } else {
    err = launch<1>(dev, grid, st, d, c, bs, bo, bw, cb, fi, o, rows, plane,
                    lalloc, n_frames, hop, n_fft_pad, n_freq_pad, w0, w1, w2);
  }
  return static_cast<int>(err);
}
