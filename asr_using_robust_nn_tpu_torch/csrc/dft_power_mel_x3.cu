// K5 on Hopper: framing -> rDFT -> |.|^2 -> mel projection with every
// product as a three-pass bf16 split on the tensor cores.
//
// Replaces asr_using_robust_nn_tpu/ops/pallas_mfcc.py::
// _dft_power_mel_x3_kernel, the Pallas TPU kernel behind
// mel_power_bf16x3_pallas / mfcc_pallas_bf16x3_batch (built for the speaker
// preset's odd n_fft = 441). An fp32 value x is split as hi = bf16(x),
// lo = bf16(x - hi); a product a @ b is hi_a @ hi_b + hi_a @ lo_b +
// lo_a @ hi_b with fp32 sums, the lo @ lo term dropped (~2^-16 relative).
// The signal is split once, the constants arrive split, and the power is
// split again before the mel products: six bf16 products for re and im,
// three for the mel projection. The twin (ops/cuda_mfcc_x3.py::
// mel_power_bf16x3_plain) splits the same values, so kernel and twin
// multiply the same bf16 operands and differ only in the order of the fp32
// sums.
//
// Two kernels, one launch each, in asr_dft_power_mel_x3:
//  1. split_pad_kernel: the waves (batch, length) fp32 -> sig (2, batch,
//     lalloc) bf16, the hi and lo planes of the center-padded signal (zeros
//     before `offset` and past the wave). One pass at the memory rate; it
//     takes the place of the pad the wrapper would otherwise make.
//  2. dft_power_mel_x3_kernel: the rest. Output (rows_pad, 128) fp32 mel
//     power, rows_pad = batch * n_frames rounded up to 64; the rows past
//     batch * n_frames are scratch.
// Constants: ct (2, n_freq_pad / 32, 64, n_fft_pad) bf16: for hi and lo and
// each group of 32 bins, the 32 rows of Cr^T, then the same 32 rows of Ci^T
// (zero rows past n_freq, zero columns past n_fft); melt (2, 128,
// n_freq_pad) bf16: Mel hi and lo, bands by bins, zero columns past n_freq.
//
// What bounds it on an H100: arithmetic. A speaker bucket of 1024 one-second
// windows is 103 424 frames x 441 x 221 bins x 6 products plus 221 x 128 x 3
// = 1.4e11 bf16 FLOP (1.6e11 on the padded tiles) against ~100 MB of
// waveforms, constants and output: the bound is the bf16 tensor-core rate
// (989 TFLOP/s dense: 0.14 ms), memory (0.03 ms) far behind.
//
// The design:
//  * A block is one warpgroup and owns 64 frame rows. It walks 64-bin
//    chunks of the spectrum; a chunk is n_fft_pad / 64 depth steps and one
//    mel step. One ring of three shared-memory stages, filled by 16-byte
//    cp.async copies, carries every step's operands. A depth step's products
//    stay in flight while the next step's start: a stage is refilled once the
//    step after it has started and its own products have completed, so the
//    tensor cores do not drain between depth steps (gemm_sm90.cuh::
//    ring_loop, which waits for every step's products, is what K3 and K4
//    use).
//  * Frames. Framing is address arithmetic on the split signal: frame t of
//    utterance b is sig[h, b, t * hop ...]. Where the block's split frames
//    fit (n_fft_pad <= 512: the speaker preset's 448, 64 x 448 x hi/lo =
//    112 KB) they are copied once, depth slice j with step j of the first
//    chunk, and stay in shared memory for every chunk; no sample is split or
//    fetched twice by a block. Else (the digit preset's 2048) each depth step
//    brings its slice of the frames with the constants. A frame starts 2 hop
//    bytes after the last: 16-byte copies when hop % 8 == 0 (digit), 8-byte
//    when hop % 4 == 0 (the speaker preset's 220), 2-byte loads otherwise.
//  * Products: wgmma m64n128k16 bf16 -> fp32 from 128-byte swizzled K-major
//    tiles. A depth step's B tile is two [Cr | Ci] groups (128 rows: 32 bins
//    re, the same 32 im, the next 32 re, im), hi and lo planes; the three
//    passes go into one 64-register accumulator, which a chunk's first
//    product starts (scale-d 0) rather than a zeroing, so that only wgmma
//    defines it and ptxas does not serialize the products in flight. Re and
//    im of a bin are registers j and j + 16 of one thread, and the power
//    forms in registers.
//  * Mel step: the power (64 rows x 64 bins, 32 registers in the layout of
//    a 64-column accumulator) is split and packed into the A fragments of
//    four k16 steps, which is what 16 columns of an accumulator are (as in
//    FlashAttention-3's P.V): wgmma m64n128k16 with A from registers and the
//    chunk's Mel hi / lo tile (128 bands x 64 bins, K-major) from the ring,
//    three passes into the block's 64 x 128 mel tile, which stays in
//    registers over all chunks. Neither the frames nor the power spectrogram
//    reach device memory, and the power never passes through shared memory.
//  * L2 traffic a speaker bucket of 1024 (1 616 blocks): constants 917 504
//    bytes a block, Mel 131 072, frames 114 688 once: 1.88 GB (the wmma
//    kernel before it: 2.45 GB, the frames fetched and split once a chunk).
//    That, not the products, is what holds this design back: staged alone
//    the operands take longer than the products alone (PERF.md,
//    tools/frontend_split.py). TMA copies of the constant tiles, multicast
//    to two-block clusters by a producer warp, halve the constant bytes but
//    measured slower than this ring on the H100 (PERF.md).
// Shared memory: 1 KB alignment + 3 stages x 32 KB (B hi, lo) + the
// resident frames (n_fft_pad / 64 x 16 KB) = 214 016 bytes at the speaker
// preset; streamed frames: 3 x 48 KB + 1 KB = 148 480 bytes (digit). One
// block an SM. ptxas -v (sm_90a, CUDA 12.8): 220 registers with 16-byte
// copies, 230 with 8-byte copies, 255 with 2-byte loads; no spills, no
// stack frame; the split pass 26.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstdint>

#include "gemm_sm90.cuh"

namespace {

using sm90::bf16;

constexpr int kMaxDevices = 64;

constexpr int BM = 64;              // frame rows a block
constexpr int BC = 64;              // bins a chunk: two [Cr | Ci] groups
constexpr int BK = 64;              // depth a step
constexpr int NMEL = 128;           // mel bands (FrontendConfig.n_mels)
constexpr int THREADS = 128;        // one warpgroup
constexpr int STAGES = 3;
constexpr int HALF = 64 * 128;      // 64 rows of 128 bytes
constexpr int B_PLANE = 2 * HALF;   // 128 rows: the hi or the lo plane
constexpr int B_BYTES = 2 * B_PLANE;
constexpr int A_BYTES = 2 * HALF;   // 64 frame rows, hi and lo
constexpr int MAX_RESIDENT_K = 512;
constexpr int MAX_SMEM = 232448;

int smem_bytes(int n_fft_pad, bool resident) {
  const int stage = B_BYTES + (resident ? 0 : A_BYTES);
  return sm90::kAlign + STAGES * stage +
         (resident ? (n_fft_pad / BK) * A_BYTES : 0);
}
static_assert(sm90::kAlign + STAGES * B_BYTES +
                  (MAX_RESIDENT_K / BK) * A_BYTES <= MAX_SMEM,
              "resident frames fit one block an SM");

// byte offset of 16-byte chunk `ch` of row `row` in a swizzled tile
__device__ __forceinline__ uint32_t swz(int row, int ch) {
  return row * 128 + ((ch ^ (row & 7)) << 4);
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void split(float x, bf16& hi, bf16& lo) {
  hi = __float2bfloat16_rn(x);
  lo = __float2bfloat16_rn(__fsub_rn(x, __bfloat162float(hi)));
}

__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// two bf16 in one register, `a` (the lower column) in the low half
__device__ __forceinline__ uint32_t pack(bf16 a, bf16 b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(a)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(b)) << 16);
}

__global__ void __launch_bounds__(256)
split_pad_kernel(const float* __restrict__ x, bf16* __restrict__ sig,
                 int length, int offset, int lalloc, int64_t quads,
                 int64_t plane) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (q >= quads) return;
  const int64_t i0 = 4 * q;
  const int64_t b = i0 / lalloc;
  const int i = static_cast<int>(i0 - b * lalloc) - offset;
  const float* row = x + b * length;
  bf16 hi[4], lo[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = i + e;
    split(j >= 0 && j < length ? __ldg(row + j) : 0.f, hi[e], lo[e]);
  }
  *reinterpret_cast<uint2*>(sig + i0) =
      make_uint2(pack(hi[0], hi[1]), pack(hi[2], hi[3]));
  *reinterpret_cast<uint2*>(sig + plane + i0) =
      make_uint2(pack(lo[0], lo[1]), pack(lo[2], lo[3]));
}

// AL: 16, 8 or 2, the alignment in bytes of every frame's start in the
// split signal (16- and 8-byte cp.async copies, 2-byte loads).
template <int AL>
__global__ void __launch_bounds__(THREADS, 1)
dft_power_mel_x3_kernel(const bf16* __restrict__ sig,
                        const bf16* __restrict__ ct,
                        const bf16* __restrict__ melt,
                        float* __restrict__ out, int rows, int64_t plane,
                        int lalloc, int n_frames, int hop, int n_fft_pad,
                        int n_freq_pad, int resident) {
  // A frame row of a step is 128 bytes in W-byte pieces (4-byte words of
  // two 2-byte loads where AL == 2); a thread takes piece tid % PIECES of
  // rows tid / PIECES + i * (THREADS / PIECES).
  constexpr int W = AL == 2 ? 4 : AL;
  constexpr int PIECES = 128 / W;
  constexpr int RSTEP = THREADS / PIECES;
  constexpr int NR = BM / RSTEP;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t base = sm90::smem_u32(sm90::aligned_smem(smem_raw));
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  const int nk = n_fft_pad / BK;
  const int per_chunk = nk + 1;  // the depth steps, then the mel step
  const int stage_bytes = B_BYTES + (resident ? 0 : A_BYTES);
  const uint32_t res = base + STAGES * stage_bytes;  // resident frames
  const int64_t ct_plane = static_cast<int64_t>(n_freq_pad) * 2 * n_fft_pad;
  const int64_t mel_plane = static_cast<int64_t>(NMEL) * n_freq_pad;

  // Frame rows: row r of the block is utterance b, frame t, at b * lalloc +
  // t * hop of each plane; rows past the last one read row 0 and land in
  // the output's scratch rows.
  const int piece = tid % PIECES;
  int a_src[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int r = row0 + tid / PIECES + i * RSTEP;
    const int rr = r < rows ? r : 0;
    const int b = rr / n_frames;
    a_src[i] = b * lalloc + (rr - b * n_frames) * hop + piece * (W / 2);
  }
  // B rows: 16-byte chunk tid % 8 of rows tid / 8 + 16 i
  const int bch = tid % 8;
  const int brow = tid / 8;

  // 128 rows of `ld` elements from `src` (hi) and `src + pl` (lo) into the
  // two planes of a B tile
  auto fill_b = [&](uint32_t dst, const bf16* src, int ld, int64_t pl) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = brow + 16 * i;
        sm90::cp_async16(dst + h * B_PLANE + swz(row, bch),
                         src + h * pl + static_cast<int64_t>(row) * ld +
                             bch * 8);
      }
    }
  };
  // depth slice j of the block's frames, hi and lo, into an A tile
  auto fill_a = [&](uint32_t dst, int j) {
    const int k0 = j * BK;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int row = tid / PIECES + i * RSTEP;
        const uint32_t d = dst + h * HALF +
                           swz(row, (piece * W) / 16) + (piece * W) % 16;
        const bf16* src = sig + h * plane + a_src[i] + k0;
        if (AL == 16) {
          sm90::cp_async16(d, src);
        } else if (AL == 8) {
          cp_async8(d, src);
        } else {
          const auto* s16 = reinterpret_cast<const unsigned short*>(src);
          const uint32_t v = static_cast<uint32_t>(__ldg(s16)) |
                             (static_cast<uint32_t>(__ldg(s16 + 1)) << 16);
          asm volatile("st.shared.b32 [%0], %1;" :: "r"(d), "r"(v)
                       : "memory");
        }
      }
    }
  };

  auto fill = [&](int s) {
    const int c = s / per_chunk, j = s % per_chunk;
    const uint32_t st = base + (s % STAGES) * stage_bytes;
    if (j == nk) {  // the chunk's Mel hi / lo tile: 128 bands x 64 bins
      fill_b(st, melt + c * BC, n_freq_pad, mel_plane);
      return;
    }
    fill_b(st, ct + static_cast<int64_t>(c) * 2 * BC * n_fft_pad + j * BK,
           n_fft_pad, ct_plane);
    if (!resident) {
      fill_a(st + B_BYTES, j);
    } else if (c == 0) {
      fill_a(res + j * A_BYTES, j);
    }
  };

  // acc: the chunk's [re | im | re | im] sums (64 x 128), started by the
  // chunk's first product; mel: the block's mel tile (64 x 128)
  float acc[64], mel[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = mel[i] = 0.f;

  // Step s's products. A depth step leaves its products in flight; the mel
  // step waits for the chunk's last ones, forms the power and waits for its
  // own (its A operand is registers the compiler may reuse afterwards).
  auto multiply = [&](int s) {
    const int j = s % per_chunk;
    const uint32_t st = base + (s % STAGES) * stage_bytes;
    if (j < nk) {
      const uint32_t a = resident ? res + j * A_BYTES : st + B_BYTES;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t ah = sm90::make_desc(a + kk * 32);
        const uint64_t al = sm90::make_desc(a + HALF + kk * 32);
        const uint64_t bh = sm90::make_desc(st + kk * 32);
        const uint64_t bl = sm90::make_desc(st + B_PLANE + kk * 32);
        sm90::wgmma_m64n128k16(acc, ah, bh, j > 0 || kk > 0);
        sm90::wgmma_m64n128k16(acc, ah, bl);
        sm90::wgmma_m64n128k16(acc, al, bh);
      }
      sm90::wgmma_commit();
#pragma unroll
      for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(acc[i]) :: "memory");
      return;
    }
    sm90::wgmma_wait0();
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(acc[i]) :: "memory");
    // The chunk is summed. power = re^2 + im^2 (bin i of group g: registers
    // 32 g + i and 32 g + 16 + i), each square rounded, as the twin does;
    // split; registers 8 t .. 8 t + 7 of the power are k16 step t's A.
    uint32_t phi[4][4], plo[4][4];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      bf16 h2[2], l2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int g = (i + e) / 16, m = (i + e) % 16;
        const float re = acc[32 * g + m], im = acc[32 * g + 16 + m];
        split(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)), h2[e], l2[e]);
      }
      phi[i / 8][(i % 8) / 2] = pack(h2[0], h2[1]);
      plo[i / 8][(i % 8) / 2] = pack(l2[0], l2[1]);
    }
    sm90::wgmma_fence();
#pragma unroll
    for (int t = 0; t < BC / 16; ++t) {
      const uint64_t bh = sm90::make_desc(st + t * 32);
      const uint64_t bl = sm90::make_desc(st + B_PLANE + t * 32);
      sm90::wgmma_m64n128k16_rs(mel, phi[t], bh);
      sm90::wgmma_m64n128k16_rs(mel, phi[t], bl);
      sm90::wgmma_m64n128k16_rs(mel, plo[t], bh);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait0();
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(mel[i]) :: "memory");
  };

  // The ring, with one step's products left in flight: step s's stage is
  // refilled (with step s + STAGES) once step s + 1's products are started
  // and step s's have completed, so the tensor cores do not drain between
  // depth steps.
  const int n = (n_freq_pad / BC) * per_chunk;
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n) fill(s);
    sm90::cp_commit();
  }
  for (int k = 0; k < n; ++k) {
    sm90::cp_wait<STAGES - 2>();  // this thread's copies of step k landed
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();  // ... everyone's
    multiply(k);
    wgmma_wait1();    // step k - 1's products are done: its stage is free
    __syncthreads();  // ... in every warp
    if (k + STAGES - 1 < n) fill(k + STAGES - 1);
    sm90::cp_commit();
  }
  sm90::wgmma_wait0();
  sm90::cp_wait<0>();
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(mel[i]) :: "memory");

  // out has whole 64-row tiles: the registers store straight to it
  const int r = sm90::frag_row();
  const int c0 = sm90::frag_col();
#pragma unroll
  for (int nb = 0; nb < NMEL / 8; ++nb) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<float2*>(
          out + static_cast<int64_t>(row0 + r + 8 * h) * NMEL + nb * 8 + c0) =
          make_float2(mel[nb * 4 + h * 2], mel[nb * 4 + h * 2 + 1]);
    }
  }
}

template <int AL>
cudaError_t launch(int dev, dim3 grid, int smem, cudaStream_t stream,
                   const bf16* sig, const bf16* ct, const bf16* melt,
                   float* out, int rows, int64_t plane, int lalloc,
                   int n_frames, int hop, int n_fft_pad, int n_freq_pad,
                   int resident) {
  // The shared-memory opt-in is per device: set it at the first launch on
  // each one. Setting it twice from racing threads is harmless.
  static std::atomic<bool> smem_set[kMaxDevices];
  if (!smem_set[dev].load(std::memory_order_acquire)) {
    const cudaError_t err = cudaFuncSetAttribute(
        dft_power_mel_x3_kernel<AL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return err;
    smem_set[dev].store(true, std::memory_order_release);
  }
  dft_power_mel_x3_kernel<AL><<<grid, THREADS, smem, stream>>>(
      sig, ct, melt, out, rows, plane, lalloc, n_frames, hop, n_fft_pad,
      n_freq_pad, resident);
  return cudaGetLastError();
}

}  // namespace

// Launches K5 on `stream` and returns cudaGetLastError() (0 on success).
// Shapes: x (batch, length) fp32 waves, placed at `offset` in each row of
// the split signal; ct (2, n_freq_pad / 32, 64, n_fft_pad) bf16; melt (2,
// 128, n_freq_pad) bf16; sig (2, batch, lalloc) bf16 scratch, written here;
// out (rows_pad, 128) fp32 with rows_pad = batch * n_frames rounded up to
// 64; all contiguous device arrays. lalloc must be a multiple of 8, at least
// offset + length and (n_frames - 1) * hop + n_fft_pad; n_fft_pad and
// n_freq_pad multiples of 64. copy_bytes (16, 8 or 2) must divide 2 * hop;
// resident (0 or 1) keeps the frames in shared memory and needs n_fft_pad
// <= 512. The host's plan (ops/cuda_mfcc_x3.py::launch_plan) picks both.
extern "C" int asr_dft_power_mel_x3(const void* x, const void* ct,
                                    const void* melt, void* sig, void* out,
                                    int batch, int length, int offset,
                                    int lalloc, int n_frames, int hop,
                                    int n_fft_pad, int n_freq_pad,
                                    int copy_bytes, int resident,
                                    void* stream) {
  if (n_fft_pad % BK != 0 || n_freq_pad % BC != 0 || n_fft_pad <= 0 ||
      n_freq_pad <= 0 || batch < 0 || length < 0 || offset < 0 ||
      n_frames < 0 || hop <= 0 || lalloc <= 0 || lalloc % 8 != 0 ||
      static_cast<int64_t>(offset) + length > lalloc ||
      static_cast<int64_t>(batch) * lalloc > INT_MAX ||
      static_cast<int64_t>(batch) * n_frames > INT_MAX - BM ||
      (n_frames > 0 &&
       static_cast<int64_t>(n_frames - 1) * hop + n_fft_pad > lalloc) ||
      (copy_bytes != 16 && copy_bytes != 8 && copy_bytes != 2) ||
      (2 * hop) % copy_bytes != 0 || (resident != 0 && resident != 1) ||
      (resident && n_fft_pad > MAX_RESIDENT_K)) {
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
  const int smem = smem_bytes(n_fft_pad, resident);
  const auto st = static_cast<cudaStream_t>(stream);
  auto* s = static_cast<bf16*>(sig);
  const int64_t plane = static_cast<int64_t>(batch) * lalloc;
  const int64_t quads = plane / 4;
  split_pad_kernel<<<static_cast<unsigned>((quads + 255) / 256), 256, 0,
                     st>>>(static_cast<const float*>(x), s, length, offset,
                           lalloc, quads, plane);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((rows + BM - 1) / BM);
  const auto* c = static_cast<const bf16*>(ct);
  const auto* m = static_cast<const bf16*>(melt);
  auto* o = static_cast<float*>(out);
  if (copy_bytes == 16) {
    err = launch<16>(dev, grid, smem, st, s, c, m, o, rows, plane, lalloc,
                     n_frames, hop, n_fft_pad, n_freq_pad, resident);
  } else if (copy_bytes == 8) {
    err = launch<8>(dev, grid, smem, st, s, c, m, o, rows, plane, lalloc,
                    n_frames, hop, n_fft_pad, n_freq_pad, resident);
  } else {
    err = launch<2>(dev, grid, smem, st, s, c, m, o, rows, plane, lalloc,
                    n_frames, hop, n_fft_pad, n_freq_pad, resident);
  }
  return static_cast<int>(err);
}
