// K7 on Hopper: the FISTA projection (constraints/engine.py::
// make_fista_constraint) of every layer of one training step, in one
// cooperative launch.
//
// It replaces no TPU kernel: the JAX package runs this projection as XLA ops
// inside `lax.while_loop`. It was added so that a fit under the FISTA
// projection runs the fused epoch (K3): K3's step calls it where the
// simple_norm recipe calls K2, on the fp32 masters, and it refreshes their
// bf16 copies.
//
// The algorithm, for layers i = 0 .. m-1 in model order on the live weights
// (W_i is d_i x d_{i+1}, Keras layout; n = d_m classes):
//   A_i = W_{m-1}^T ... W_{i+1}^T (n x d_{i+1}), from the layers not yet
//   projected; B_i = W_{i-1}^T ... W_0^T (d_i x d_0), from the projected
//   ones; gamma = 1 / (||A_i||_2 ||B_i||_2 + eps)^2.
//   Iteration 0 (z = 0): w = relu(W_i), t = A_i w^T B_i (n x d_0); stop when
//   ||w - W_i||_F < 30 and ||max(sigma(t) - rho, 0)|| < 0.01.
//   Else y = gamma sum_{s_k > rho} (s_k - rho) u_k v_k^T over the SVD of t,
//   and iteration 1: z = (1 + eta) y, eta = 1 / (2 + alpha), and
//   W_i <- relu(W_i - B_i z^T A_i). With nit = 2 that is the output; with
//   nit = 1 the output is relu(W_i). Larger nit is refused on the host.
// How it is computed here (the departures are listed in ops/cuda_fista.py):
//   * A_i^T for all i by the suffix chain A_{j-1}^T = W_j A_j^T, n columns.
//   * t^T = W_0 (W_1 ... (W_{i-1} (relu(W_i) A_i^T))): a chain of n-column
//     products from layer i down; B_i is never formed. The chain carries one
//     more column, the power vector v_i of ||B_i||_2, so that the same links
//     give x = B_i^T v_i.
//   * G = t t^T (n x n) in fp64, its eigenpairs by parallel cyclic Jacobi in
//     one warp (fp64); s_k = sqrt(lambda_k); y = gamma C t with C = U
//     diag((s_k - rho)_+ / s_k) U^T.
//   * P = (1 + eta) C t B_i^T = [(1 + eta) C t; x^T] W_0 ... W_{i-1}: a
//     chain of (n + 1)-row products from layer 0 up, whose last row is
//     w = B_i B_i^T v_i: one round of the power iteration for ||B_i||_2,
//     which has converged when ||w - ||x||^2 v_i|| <= tol ||w|| (else more
//     rounds follow, one-column chains down and up); w / ||w|| is kept in
//     the state as the next step's v_i.
//   * ||A_i||_2 from the eigenvalues of A_i A_i^T (fp64 Jacobi).
//   * W_i <- relu(W_i - gamma P^T A_i), its bf16 copy written beside.
//   * With NonNeg masters, an exit leaves W_i as it is, so the next layer's
//     product is the same matrix and exits too: the first exit ends the
//     step (the later layers are counted as exits). ||A_i||_2 is computed
//     only for a layer that updates.
//
// What bounds it: latency. The work is a dependent chain of small products
// (the masters, 6.4 MB at the digit widths, stay in L2), so every link is
// one grid-wide barrier apart from the next. One block per SM; links spread
// a layer's rows (or 32-column chunks) over all blocks; the small reductions
// (norms, Grams, the eigenproblem, the exit test) run redundantly in every
// block, in the same order on the same data, so that every block takes the
// same branch without another barrier. Data written in one phase is read in
// later phases through L2 (`__ldcg`) only.
//
// Barrier: a counter in global memory (`bar[0]`), one arrival per block a
// phase, released at gen * gridDim.x; the last block to leave resets it and
// `bar[1]`, so every launch starts from zeros (the wrapper allocates them
// zeroed). The launch is cooperative, so that all blocks are resident.
// No atomics on data, a fixed partition and fixed summation orders: replays
// of a captured graph give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

// 384 threads a block leave a thread 168 registers: the register Jacobi
// (below) spills under the 128 that 512 threads would leave
constexpr int kThreads = 384;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLayers = 16;
constexpr int kMaxN = 10;            // classes: the last width
constexpr int kLd = kMaxN + 1;       // row stride of the n x n fp64 matrices
constexpr int kMaxSweeps = 40;
constexpr int kMaxGrid = 512;        // blocks (crit's partials fit `gp`)

struct FistaArgs {
  float* w[kMaxLayers];   // fp32 masters: rows of ld[i] floats, true region
  bf16* w16[kMaxLayers];  // their bf16 copies, same layout
  int dims[kMaxLayers + 1];
  int ld[kMaxLayers];
  int at_off[kMaxLayers];  // A_i^T (dims[i+1] x n, row stride n) in `at`
  int m, n, nit, max_rounds, v_ld, q_ld;
  int nonneg;  // the masters are >= 0 (NonNeg): relu leaves them as they are
  float rho, eta1;  // eta1 = 1 / (2 + alpha)
  double tol, eps;
  float* v;              // power vectors: v_i at v + i * v_ld (dims[i])
  double* u;             // eigenvectors of the step before, n x n each:
                         // 2 i: t t^T of layer i; 2 i + 1: A_i A_i^T
  double* u_next;        // this step's, copied to `u` once all blocks are
                         // past their last read of it
  long long* counters;   // projections, iterations, rounds, unconverged
  float* at;             // the suffix chain; A_{m-1}^T = I set by the wrapper
  float* r[2];           // column chains: rows x (n + 1), row stride n + 1
  float* q[2];           // row chains: n + 1 rows of stride q_ld
  float* pw[2];          // the power iteration's vectors (q_ld each)
  float* vb[2];          // its v of the round after the first
  float* v_next;         // v_i for the next step, copied to `v` at the end
  double* crit;          // per block: sum of min(w, 0)^2 of a layer's rows
  unsigned int* bar;     // arrivals, departures
};

struct Smem {
  double ja[kMaxN * kLd];  // the Jacobi matrix; eigenvalues on its diagonal
  double jv[kMaxN * kLd];  // eigenvectors (columns)
  float cf[kMaxN * kLd];   // (1 + eta) C, fp32
  double gp[kMaxGrid];      // Gram partials, crit's partials, G U
  double red[kWarps];
  double fk[kMaxN];
  double scal[4];
  int flag;
};

__device__ __forceinline__ unsigned int ld_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// All blocks meet; writes before it are visible (through L2) after it.
__device__ void grid_sync(unsigned int* bar, unsigned int& gen) {
  __syncthreads();
  ++gen;
  if (threadIdx.x == 0) {
    // release: the block's writes (ordered before by __syncthreads) are
    // visible to any block whose acquire load sees this arrival
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;"
                 :
                 : "l"(bar)
                 : "memory");
    const unsigned int want = gen * gridDim.x;
    while (ld_acquire(bar) < want) {
    }
  }
  __syncthreads();
}

// The sum of every thread's v, the same bits in every thread (warp xor
// trees, then the warps in order).
__device__ double block_sum(double v, double* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
  for (int k = 0; k < kWarps; ++k) s += red[k];
  return s;
}

// sum x[e * stride]^2 for e < len in fp64, fixed order.
__device__ double block_sumsq(const float* x, int len, int stride,
                              double* red) {
  double acc = 0.0;
  for (int e = threadIdx.x; e < len; e += kThreads) {
    const double t = __ldcg(x + static_cast<int64_t>(e) * stride);
    acc = fma(t, t, acc);
  }
  return block_sum(acc, red);
}

// ---------------------------------------------------------------------------
// staging: kBatch independent L2 loads in flight a thread
// ---------------------------------------------------------------------------

constexpr int kBatch = 8;

// S[r * sp + c] = scale * src[r * ss + c] for r < rows, c < cols; with
// `trans`, S[c * sp + r] instead (a row chain's input, k-major).
__device__ void stage(float* S, int sp, const float* src, int ss, int rows,
                      int cols, float scale, bool trans) {
  const int total = rows * cols;
  if (!trans && ss == cols && total % 4 == 0 &&
      reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    for (int base = threadIdx.x; base < total / 4;
         base += kThreads * kBatch) {
      float4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = base + u * kThreads;
        if (e < total / 4) v[u] = __ldcg(s4 + e);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e4 = base + u * kThreads;
        if (e4 < total / 4) {
          const float x[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const int e = 4 * e4 + h, r = e / cols, c = e - r * cols;
            S[r * sp + c] = scale * x[h];
          }
        }
      }
    }
    return;
  }
  for (int base = threadIdx.x; base < total; base += kThreads * kBatch) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = base + u * kThreads;
      v[u] = 0.f;
      if (e < total) {
        const int r = e / cols, c = e - r * cols;
        v[u] = __ldcg(src + static_cast<int64_t>(r) * ss + c);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = base + u * kThreads;
      if (e < total) {
        const int r = e / cols, c = e - r * cols;
        S[trans ? c * sp + r : r * sp + c] = scale * v[u];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// links
// ---------------------------------------------------------------------------

// out[r * so + c] = sum_k w(r, k) in(k, c) for r < R, c < nc, k < K, with
// w(r, k) = W[r * ld + k] (relu'd when `relu`) and in(k, c) = scale *
// in[k * si + c]. Row r belongs to block r % G, then to a warp; its lanes
// take k lane-strided, in order, and add by an xor tree. `in` is staged in
// the block's shared memory at an odd row stride. With `crit`, each block
// writes the sum of min(w, 0)^2 over its rows to crit[block].
template <int NC>
__device__ void f_link_t(const float* W, int ld, int R, int K,
                         const float* in, int si, float scale, int nc,
                         bool relu, float* out, int so, float* S,
                         double* crit, double* red) {
  const int G = gridDim.x, b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int sp = nc | 1;
  if (b < R) stage(S, sp, in, si, K, nc, scale, false);
  __syncthreads();
  double neg = 0.0;
  for (int r = b + G * warp; r < R; r += G * kWarps) {
    float acc[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] = 0.f;
    const float* wr = W + static_cast<int64_t>(r) * ld;
    for (int k0 = lane; k0 < K; k0 += 32 * kBatch) {
      float wv[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int k = k0 + 32 * u;
        wv[u] = k < K ? __ldcg(wr + k) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int k = k0 + 32 * u;
        if (k >= K) break;
        float w = wv[u];
        if (relu) {
          if (w < 0.f) neg = fma(static_cast<double>(w),
                                 static_cast<double>(w), neg);
          w = fmaxf(w, 0.f);
        }
        const float* s = S + k * sp;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          if (c < nc) acc[c] = fmaf(w, s[c], acc[c]);
        }
      }
    }
    float mine = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (c < nc) {
        float x = acc[c];
#pragma unroll
        for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
        if (lane == c) mine = x;
      }
    }
    if (lane < nc) out[static_cast<int64_t>(r) * so + lane] = mine;
  }
  if (crit != nullptr) {
    const double tot = block_sum(neg, red);
    if (tid == 0) crit[b] = tot;
  }
  __syncthreads();
}

__device__ void f_link(const float* W, int ld, int R, int K, const float* in,
                       int si, float scale, int nc, bool relu, float* out,
                       int so, float* S, double* crit, double* red) {
  if (nc <= 1) {
    f_link_t<1>(W, ld, R, K, in, si, scale, nc, relu, out, so, S, crit, red);
  } else {
    f_link_t<kMaxN + 1>(W, ld, R, K, in, si, scale, nc, relu, out, so, S,
                        crit, red);
  }
}

// out[a * so + c] = sum_k in(a, k) W[k * ld + c] for a < nr, c < C, k < K.
// The input is held in shared memory as S[k * tp + a] (tp = nr | 1): staged
// here from in[a * si + k] unless `staged`. Columns go in chunks of 32 (a
// lane each) to blocks (chunk % G); the block's warps take contiguous
// sixteenths of K, summed in order, and their partials are added in warp
// order.
template <int NR>
__device__ void p_link_t(const float* W, int ld, int K, int C,
                         const float* in, int si, int nr, bool staged,
                         float* out, int so, float* S) {
  const int G = gridDim.x, b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int tp = nr | 1;
  const int nchunk = (C + 31) / 32;
  if (b < nchunk && !staged) stage(S, tp, in, si, nr, K, 1.f, true);
  __syncthreads();
  float* part = S + K * tp;  // kWarps x nr x 32
  const int k0 = (K * warp) / kWarps, k1 = (K * (warp + 1)) / kWarps;
  for (int ch = b; ch < nchunk; ch += G) {
    const int c = ch * 32 + lane;
    float acc[NR];
#pragma unroll
    for (int a = 0; a < NR; ++a) acc[a] = 0.f;
    for (int kb = k0; kb < k1; kb += kBatch) {
      float wv[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int k = kb + u;
        wv[u] = c < C && k < k1
                    ? __ldcg(W + static_cast<int64_t>(k) * ld + c)
                    : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int k = kb + u;
        if (k >= k1) break;
        const float* s = S + k * tp;
#pragma unroll
        for (int a = 0; a < NR; ++a) {
          if (a < nr) acc[a] = fmaf(s[a], wv[u], acc[a]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < NR; ++a) {
      if (a < nr) part[(warp * nr + a) * 32 + lane] = acc[a];
    }
    __syncthreads();
    for (int e = tid; e < nr * 32; e += kThreads) {
      const int a = e >> 5, l = e & 31, cc = ch * 32 + l;
      float s = 0.f;
      for (int w2 = 0; w2 < kWarps; ++w2) s += part[(w2 * nr + a) * 32 + l];
      if (cc < C) out[static_cast<int64_t>(a) * so + cc] = s;
    }
    __syncthreads();
  }
  __syncthreads();
}

__device__ void p_link(const float* W, int ld, int K, int C, const float* in,
                       int si, int nr, bool staged, float* out, int so,
                       float* S) {
  if (nr <= 1) {
    p_link_t<1>(W, ld, K, C, in, si, nr, staged, out, so, S);
  } else {
    p_link_t<kMaxN + 1>(W, ld, K, C, in, si, nr, staged, out, so, S);
  }
}

// ---------------------------------------------------------------------------
// the small dense algebra, the same in every block
// ---------------------------------------------------------------------------

// sm.ja <- X^T X (fp64, n x n) for X = S[r * sp + c], r < rows, c < n, the
// upper triangle summed row-strided by slices, slices added in order; with
// `sq`, also returns sum_r S[r * sp + n]^2.
__device__ double block_gram(const float* S, int sp, int rows, int n,
                             bool sq, Smem& sm) {
  const int tid = threadIdx.x;
  const int tri = n * (n + 1) / 2;
  const int E = tri + (sq ? 1 : 0);
  const int slices = kThreads / E > 0 ? kThreads / E : 1;
  for (int t = tid; t < E * slices; t += kThreads) {
    const int e = t % E, s = t / E;
    int ia = n, ib = n;
    if (e < tri) {  // e -> (ia <= ib), row-major upper triangle
      int rem = e;
      ia = 0;
      while (rem >= n - ia) {
        rem -= n - ia;
        ++ia;
      }
      ib = ia + rem;
    }
    double acc = 0.0;
    for (int r = s; r < rows; r += slices) {
      acc = fma(static_cast<double>(S[r * sp + ia]),
                static_cast<double>(S[r * sp + ib]), acc);
    }
    sm.gp[s * E + e] = acc;
  }
  __syncthreads();
  for (int e = tid; e < tri; e += kThreads) {
    int rem = e, ia = 0;
    while (rem >= n - ia) {
      rem -= n - ia;
      ++ia;
    }
    const int ib = ia + rem;
    double acc = 0.0;
    for (int s = 0; s < slices; ++s) acc += sm.gp[s * E + e];
    sm.ja[ia * kLd + ib] = acc;
    sm.ja[ib * kLd + ia] = acc;
  }
  if (sq && tid == 0) {
    double acc = 0.0;
    for (int s = 0; s < slices; ++s) acc += sm.gp[s * E + tri];
    sm.scal[3] = acc;
  }
  __syncthreads();
  return sq ? sm.scal[3] : 0.0;
}

// The rotation that annihilates apq against app, aqq: t = tan(phi) from
// theta = (aqq - app) / (2 apq) in fp32 (a fast root; the angle need not be
// exact, the next sweep takes what it leaves; a theta past fp32's range
// rounds to inf and gives t = 0), then c = 1 / sqrt(1 + t^2) refined in
// fp64 by two Newton steps and s = t c, so that c^2 + s^2 = 1 to fp64 and
// the accumulated V stays orthogonal.
__device__ __forceinline__ void rotation(double app, double aqq, double apq,
                                         double& c, double& s) {
  const float theta =
      static_cast<float>((aqq - app) * __drcp_rn(2.0 * apq));
  const float at = fabsf(theta);
  float tf = at > 1e18f ? 0.5f / at : 1.f / (at + sqrtf(at * at + 1.f));
  if (theta < 0.f) tf = -tf;
  const double t = tf, q = fma(t, t, 1.0);
  double y = rsqrtf(static_cast<float>(q));
  y = y * fma(-0.5 * q, y * y, 1.5);
  y = y * fma(-0.5 * q, y * y, 1.5);
  c = y;
  s = t * y;
}

// The eigenpairs of the symmetric sm.ja (n x n, n <= NJ, NJ even) by
// parallel cyclic Jacobi in one warp (call from all 32 lanes of it), one
// row of A and of V a lane, in registers: rounds of disjoint rotations in
// the round-robin order, whose pairs are compile-time constants (pair k of
// round r is (r + k, r - k) mod NJ - 1, and (NJ - 1, r)), so that a column
// update touches fixed registers; a row update takes the partner lane's row
// by shuffles; each pair's rotation is the one its lower lane computes.
// Rows and columns n .. NJ - 1 are zero and never rotate. Sweeps until the
// off-diagonal part is below 1e-14 of the diagonal's in Frobenius norm (or
// the goal is met early). Eigenvalues on sm.ja's diagonal; the rotations
// are applied to sm.jv from the right (its columns are the eigenvectors when
// it starts as the basis sm.ja is written in).
// How far a Jacobi must go: to convergence (the eigenvectors are needed);
// until the exit test is certain (kExit: Weyl's bound lambda_k <= d_k +
// ||E||_F, E the off-diagonal part, already puts ||max(sqrt(lambda) - rho,
// 0)|| under `limit`, so the exit fires whatever is left); or until the top
// eigenvalue is pinned to 1e-8 relative (kTop: ||E||_F <= 1e-8 max d_k).
enum JacobiGoal { kAll = 0, kExit = 1, kTop = 2 };

template <int NJ>
__device__ __noinline__ void jacobi_reg(Smem& sm, int n, int goal,
                                        double rho, double limit) {
  const int lane = threadIdx.x & 31;
  const bool row = lane < n;
  constexpr bool vec = true;
  double a[NJ], v[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    a[j] = row && j < n ? sm.ja[lane * kLd + j] : 0.0;
    v[j] = row && j < n ? sm.jv[lane * kLd + j] : (lane == j ? 1.0 : 0.0);
  }
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    double off = 0.0, dg = 0.0;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j == lane) dg = fma(a[j], a[j], dg);
      if (j > lane && lane < NJ) off = fma(a[j], a[j], off);
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      off += __shfl_xor_sync(0xffffffffu, off, o);
      dg += __shfl_xor_sync(0xffffffffu, dg, o);
    }
    if (!(off > 1e-28 * dg)) break;
    if (goal != kAll) {
      const double e = sqrt(2.0 * off);
      double d = 0.0;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j == lane && row) d = a[j];
      }
      double x = 0.0;
      if (goal == kExit) {
        const double ex = row ? sqrt(fmax(d + e, 0.0)) - rho : 0.0;
        x = ex > 0.0 ? ex * ex : 0.0;
      } else {
        x = row ? d : 0.0;
      }
#pragma unroll
      for (int o = 16; o; o >>= 1) {
        const double y = __shfl_xor_sync(0xffffffffu, x, o);
        x = goal == kExit ? x + y : fmax(x, y);
      }
      if (goal == kExit ? sqrt(x) < limit : e <= 1e-8 * x) break;
    }
#pragma unroll
    for (int r = 0; r < NJ - 1; ++r) {
      int partner = (2 * r - lane + 2 * (NJ - 1)) % (NJ - 1);
      if (lane == NJ - 1) partner = r;
      if (lane == r) partner = NJ - 1;
      if (lane >= NJ) partner = lane;
      double self_d = 0.0, apq = 0.0;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j == lane) self_d = a[j];
        if (j == partner) apq = a[j];
      }
      const double part_d = __shfl_sync(0xffffffffu, self_d, partner);
      double c = 1.0, s = 0.0;
      if (lane < partner && apq * apq > 1e-32 * fabs(self_d * part_d)) {
        rotation(self_d, part_d, apq, c, s);
      }
      double pc[NJ / 2], ps[NJ / 2];
#pragma unroll
      for (int k = 0; k < NJ / 2; ++k) {
        const int p0 = k == 0 ? r : (r + k) % (NJ - 1);
        const int q0 = k == 0 ? NJ - 1 : (r - k + NJ - 1) % (NJ - 1);
        const int lo = p0 < q0 ? p0 : q0;
        pc[k] = __shfl_sync(0xffffffffu, c, lo);
        ps[k] = __shfl_sync(0xffffffffu, s, lo);
      }
#pragma unroll
      for (int k = 0; k < NJ / 2; ++k) {  // A <- A J, V <- V J
        const int p0 = k == 0 ? r : (r + k) % (NJ - 1);
        const int q0 = k == 0 ? NJ - 1 : (r - k + NJ - 1) % (NJ - 1);
        const int p = p0 < q0 ? p0 : q0, q = p0 < q0 ? q0 : p0;
        const double x = a[p], y = a[q];
        a[p] = pc[k] * x - ps[k] * y;
        a[q] = ps[k] * x + pc[k] * y;
        if (vec) {
          const double xv = v[p], yv = v[q];
          v[p] = pc[k] * xv - ps[k] * yv;
          v[q] = ps[k] * xv + pc[k] * yv;
        }
      }
      // A <- J^T A: this lane's row with its partner's
      const int lo = lane < partner ? lane : partner;
      const double cm = __shfl_sync(0xffffffffu, c, lo);
      const double sm_ = __shfl_sync(0xffffffffu, s, lo);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const double other = __shfl_sync(0xffffffffu, a[j], partner);
        a[j] = lane < partner ? cm * a[j] - sm_ * other
                              : sm_ * other + cm * a[j];
      }
    }
  }
  if (row) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j < n) {
        if (j == lane) sm.ja[lane * kLd + j] = a[j];
        sm.jv[lane * kLd + j] = v[j];
      }
    }
  }
  __syncwarp();
}

__device__ void eig(Smem& sm, int n, int goal = kAll, double rho = 0.0,
                    double limit = 0.0) {
  jacobi_reg<kMaxN>(sm, n, goal, rho, limit);
}

// Starts the eigenproblem of G (sm.ja) from the eigenvectors U of the step
// before (u, n x n, global): sm.ja <- U^T G U, sm.jv <- U, so that Jacobi
// finds the few rotations that are left. Every thread of the block.
__device__ void warm_start(Smem& sm, int n, const double* u) {
  const int tid = threadIdx.x;
  for (int e = tid; e < n * n; e += kThreads) {
    sm.jv[(e / n) * kLd + e % n] = __ldcg(u + e);
  }
  __syncthreads();
  for (int e = tid; e < n * n; e += kThreads) {  // T = G U
    const int r = e / n, c = e - r * n;
    double acc = 0.0;
    for (int k = 0; k < n; ++k) {
      acc = fma(sm.ja[r * kLd + k], sm.jv[k * kLd + c], acc);
    }
    sm.gp[e] = acc;
  }
  __syncthreads();
  for (int e = tid; e < n * n; e += kThreads) {  // U^T T
    const int r = e / n, c = e - r * n;
    double acc = 0.0;
    for (int k = 0; k < n; ++k) {
      acc = fma(sm.jv[k * kLd + r], sm.gp[k * n + c], acc);
    }
    sm.ja[r * kLd + c] = acc;
  }
  __syncthreads();
}

// ||A_j||_2 from the top eigenvalue of A_j A_j^T (1 for the last layer),
// the same bits in every block; `S` is scratch; block 0 keeps the
// eigenvectors for the next step. Overwrites sm.ja and sm.jv.
__device__ double sigma_a(const FistaArgs& a, int j, float* S, Smem& sm) {
  const int n = a.n, rows = a.dims[j + 1], sp = n | 1;
  if (j == a.m - 1) return 1.0;
  stage(S, sp, a.at + a.at_off[j], n, rows, n, 1.f, false);
  __syncthreads();
  block_gram(S, sp, rows, n, false, sm);
  warm_start(sm, n, a.u + (2 * j + 1) * n * n);
  if (threadIdx.x < 32) eig(sm, n, kTop);
  __syncthreads();
  if (blockIdx.x == 0) {
    double* un = a.u_next + (2 * j + 1) * n * n;
    for (int e = threadIdx.x; e < n * n; e += kThreads) {
      un[e] = sm.jv[(e / n) * kLd + e % n];
    }
  }
  double big = 0.0;
  for (int k = 0; k < n; ++k) big = fmax(big, sm.ja[k * kLd + k]);
  __syncthreads();
  return sqrt(big);
}

// W_i <- relu(W_i - g P^T A_i) on its true region and its bf16 copy; P(k, r)
// is Ps[r * tp + k] (shared memory) or Pg[k * pld + r]; with `zero` only the
// relu. A_i^T is staged at `sa`.
__device__ void apply_layer(const FistaArgs& a, int i, float g, bool zero,
                            const float* Ps, int tp, const float* Pg, int pld,
                            float* sa) {
  constexpr int N = kMaxN;
  const int G = gridDim.x, b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int n = a.n, R = a.dims[i], Cn = a.dims[i + 1], ld = a.ld[i];
  const int spa = n | 1;
  float* W = a.w[i];
  bf16* W16 = a.w16[i];
  if (!zero && b < R) stage(sa, spa, a.at + a.at_off[i], n, Cn, n, 1.f, false);
  __syncthreads();
  for (int r = b + G * warp; r < R; r += G * kWarps) {
    float p[N];
    if (!zero) {
      float mine = 0.f;
      if (lane < n) {
        mine = Ps != nullptr ? Ps[r * tp + lane]
                             : __ldcg(Pg + static_cast<int64_t>(lane) * pld + r);
      }
#pragma unroll
      for (int k = 0; k < N; ++k) p[k] = __shfl_sync(0xffffffffu, mine, k);
    }
    float* wr = W + static_cast<int64_t>(r) * ld;
    bf16* hr = W16 + static_cast<int64_t>(r) * ld;
    for (int c0 = lane; c0 < Cn; c0 += 32 * kBatch) {
      float wv[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int c = c0 + 32 * u;
        wv[u] = c < Cn ? __ldcg(wr + c) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int c = c0 + 32 * u;
        if (c >= Cn) break;
        float w = wv[u];
        if (!zero) {
          float dot = 0.f;
#pragma unroll
          for (int k = 0; k < N; ++k) {
            if (k < n) dot = fmaf(p[k], sa[c * spa + k], dot);
          }
          w = w - g * dot;
        }
        w = fmaxf(w, 0.f);
        wr[c] = w;
        hr[c] = __float2bfloat16(w);
      }
    }
  }
  __syncthreads();
}

// The first link of layer i's chain: R = [relu(W_i) A_i^T | v_i] (v_i only
// for i > 0) into r[0] at row stride n + 1, and crit[] for W_i.
__device__ void first_link(const FistaArgs& a, int i, float* S, double* red) {
  const int n = a.n;
  f_link(a.w[i], a.ld[i], a.dims[i], a.dims[i + 1], a.at + a.at_off[i], n,
         1.f, n, true, a.r[0], n + 1, S, a.crit, red);
  if (i > 0) {
    const float* v = a.v + static_cast<int64_t>(i) * a.v_ld;
    for (int r = blockIdx.x * kThreads + threadIdx.x; r < a.dims[i];
         r += gridDim.x * kThreads) {
      a.r[0][static_cast<int64_t>(r) * (n + 1) + n] = v[r];
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
fista_kernel(const __grid_constant__ FistaArgs a) {
  constexpr int N = kMaxN;
  extern __shared__ __align__(16) float S[];
  __shared__ Smem sm;
  unsigned int gen = 0;
  unsigned int vmask = 0;  // the layers whose v_i this launch renews
  unsigned int umask = 0;  // the eigenvector sets it renews
  const int m = a.m, n = a.n, G = gridDim.x, b = blockIdx.x;
  const int tid = threadIdx.x, d0 = a.dims[0];
  const int tp = (n + 1) | 1;

  // the suffix chain A_{j-1}^T = W_j A_j^T
  for (int j = m - 1; j >= 1; --j) {
    f_link(a.w[j], a.ld[j], a.dims[j], a.dims[j + 1], a.at + a.at_off[j], n,
           1.f, n, false, a.at + a.at_off[j - 1], n, S, nullptr, sm.red);
    grid_sync(a.bar, gen);
  }
  first_link(a, 0, S, sm.red);
  grid_sync(a.bar, gen);

  bool ended = false;  // by an exit that leaves every later layer as it is
  for (int i = 0; i < m; ++i) {
    const int nct = i > 0 ? n + 1 : n;
    int cur = 0;
    for (int j = i - 1; j >= 0; --j) {  // R_j = W_j R_{j+1}
      f_link(a.w[j], a.ld[j], a.dims[j], a.dims[j + 1], a.r[cur], n + 1, 1.f,
             nct, false, a.r[cur ^ 1], n + 1, S, nullptr, sm.red);
      cur ^= 1;
      grid_sync(a.bar, gen);
    }
    // t^T (and x = B_i^T v_i) in r[cur]: staged, Gram, eigenpairs, exit
    stage(S, tp, a.r[cur], n + 1, d0, nct, 1.f, false);
    for (int k = tid; k < G; k += kThreads) sm.gp[k] = __ldcg(a.crit + k);
    __syncthreads();
    if (tid == 0) {
      double crit = 0.0;
      for (int k = 0; k < G; ++k) crit += sm.gp[k];
      sm.scal[0] = crit;
    }
    __syncthreads();
    const double xsq = block_gram(S, tp, d0, n, i > 0, sm);
    warm_start(sm, n, a.u + 2 * i * n * n);
    if (tid < 32) {  // kExit: once the exit is certain, no vectors needed
      eig(sm, n, sm.scal[0] < 900.0 ? kExit : kAll, a.rho, 0.01);
    }
    __syncthreads();
    if (b == 0) {
      double* un = a.u_next + 2 * i * n * n;
      for (int e = tid; e < n * n; e += kThreads) {
        un[e] = sm.jv[(e / n) * kLd + e % n];
      }
    }
    umask |= 1u << (2 * i);
    if (tid == 0) {
      double c2 = 0.0;
      const double crit = sm.scal[0];
      for (int k = 0; k < n; ++k) {
        const double s = sqrt(fmax(sm.ja[k * kLd + k], 0.0));
        const double ex = s > a.rho ? s - a.rho : 0.0;
        c2 = fma(ex, ex, c2);
        sm.fk[k] = s > a.rho ? (s - a.rho) / s : 0.0;
      }
      const bool stop = a.nit < 2 || (sqrt(crit) < 30.0 && sqrt(c2) < 0.01);
      sm.flag = stop ? 1 : 0;
      if (b == 0) {
        a.counters[0] += 1;
        a.counters[1] += stop ? 1 : 2;
      }
    }
    __syncthreads();
    const bool stop = sm.flag != 0;
    if (stop && a.nonneg) {
      // W_i stays as it is (relu of a NonNeg master), so layer i + 1's
      // product A W B is this one: it exits too, and so on to the last
      if (b == 0 && tid == 0) {
        a.counters[0] += m - 1 - i;
        a.counters[1] += m - 1 - i;
      }
      ended = true;
      break;
    }
    float g = 0.f;
    int qcur = 0;
    double sig_a_i = 1.0;
    if (!stop) {
      for (int e = tid; e < n * n; e += kThreads) {  // (1 + eta) C
        const int ra = e / n, rb = e - ra * n;
        double acc = 0.0;
        for (int k = 0; k < n; ++k) {
          acc = fma(sm.jv[ra * kLd + k] * sm.fk[k], sm.jv[rb * kLd + k], acc);
        }
        sm.cf[ra * kLd + rb] = static_cast<float>((1.0 + a.eta1) * acc);
      }
      __syncthreads();
      sig_a_i = sigma_a(a, i, S + d0 * tp, sm);
      if (i < m - 1) umask |= 1u << (2 * i + 1);
      for (int r = tid; r < d0; r += kThreads) {  // t -> (1 + eta) C t
        float t[N];
#pragma unroll
        for (int l = 0; l < N; ++l) t[l] = l < n ? S[r * tp + l] : 0.f;
        for (int ra = 0; ra < n; ++ra) {
          float z = 0.f;
#pragma unroll
          for (int l = 0; l < N; ++l) {
            if (l < n) z = fmaf(sm.cf[ra * kLd + l], t[l], z);
          }
          S[r * tp + ra] = z;
        }
      }
      __syncthreads();
      double sig_b = 1.0;
      if (i > 0) {
        // P = [(1 + eta) C t; x^T] W_0 ... W_{i-1}
        p_link(a.w[0], a.ld[0], d0, a.dims[1], nullptr, 0, n + 1, true,
               a.q[0], a.q_ld, S);
        grid_sync(a.bar, gen);
        for (int j = 1; j < i; ++j) {
          p_link(a.w[j], a.ld[j], a.dims[j], a.dims[j + 1], a.q[qcur],
                 a.q_ld, n + 1, false, a.q[qcur ^ 1], a.q_ld, S);
          qcur ^= 1;
          grid_sync(a.bar, gen);
        }
        // the power iteration for ||B_i||_2. Round 1 rode in the chains:
        // x = B_i^T v_i (s0 = ||x||), w = B_i B_i^T v_i. A round has
        // converged when ||w - s0^2 v|| <= tol ||w||: v is then that close
        // to the top eigenvector, and sigma_B = s0. Else the next round
        // starts from v = w / ||w||, one-column chains down and up.
        double s0 = sqrt(xsq);
        const float* vv = a.v + static_cast<int64_t>(i) * a.v_ld;
        const float* wv = a.q[qcur] + static_cast<int64_t>(n) * a.q_ld;
        int pcur = 0;
        for (int round = 1;; ++round) {
          double res = 0.0, wn = 0.0;
          const double s02 = s0 * s0;
          for (int e = tid; e < a.dims[i]; e += kThreads) {
            const double w = __ldcg(wv + e), v = __ldcg(vv + e);
            const double r = w - s02 * v;
            res = fma(r, r, res);
            wn = fma(w, w, wn);
          }
          res = block_sum(res, sm.red);
          wn = block_sum(wn, sm.red);
          const float scale =
              wn > 0.0 ? static_cast<float>(1.0 / sqrt(wn)) : 0.f;
          const bool conv = sqrt(res) <= a.tol * sqrt(wn);
          if (b == 0 && tid == 0) a.counters[2] += 1;
          if (conv || round >= a.max_rounds) {
            if (b == 0) {  // the next step's v_i, copied at the end
              float* vn = a.v_next + static_cast<int64_t>(i) * a.v_ld;
              for (int e = tid; e < a.dims[i]; e += kThreads) {
                vn[e] = scale * __ldcg(wv + e);
              }
              if (!conv && tid == 0) a.counters[3] += 1;
            }
            vmask |= 1u << i;
            sig_b = s0;
            break;
          }
          float* vb = a.vb[round & 1];  // v of the next round, kept
          for (int e = b * kThreads + tid; e < a.dims[i]; e += G * kThreads) {
            vb[e] = scale * __ldcg(wv + e);
          }
          const float* in = wv;
          float sc = scale;
          int rcur = 0;
          for (int j = i - 1; j >= 0; --j) {  // x = B_i^T v
            f_link(a.w[j], a.ld[j], a.dims[j], a.dims[j + 1], in, 1, sc, 1,
                   false, a.r[rcur], 1, S, nullptr, sm.red);
            in = a.r[rcur];
            sc = 1.f;
            rcur ^= 1;
            grid_sync(a.bar, gen);
          }
          s0 = sqrt(block_sumsq(in, d0, 1, sm.red));
          const float* pin = in;  // w = x^T W_0 ... W_{i-1}
          for (int j = 0; j < i; ++j) {
            p_link(a.w[j], a.ld[j], a.dims[j], a.dims[j + 1], pin, 0, 1,
                   false, a.pw[pcur], a.q_ld, S);
            pin = a.pw[pcur];
            pcur ^= 1;
            grid_sync(a.bar, gen);
          }
          vv = vb;
          wv = pin;
        }
      }
      const double sa = sig_a_i * sig_b + a.eps;
      g = static_cast<float>(1.0 / (sa * sa));
    }
    // W_i's update, and layer i + 1's first link in the same phase
    if (i == 0) {
      apply_layer(a, 0, g, stop, S, tp, nullptr, 0, S + d0 * tp);
    } else {
      apply_layer(a, i, g, stop, nullptr, 0, a.q[qcur], a.q_ld, S);
    }
    if (i + 1 < m) first_link(a, i + 1, S, sm.red);
    grid_sync(a.bar, gen);
  }
  if (ended) grid_sync(a.bar, gen);
  if (b == 0) {  // every block is past its last read of `u` and `v`
    for (int k = 0; k < 2 * m; ++k) {
      if (!((umask >> k) & 1u)) continue;
      for (int e = tid; e < n * n; e += kThreads) {
        a.u[k * n * n + e] = __ldcg(a.u_next + k * n * n + e);
      }
    }
    for (int i = 0; i < m; ++i) {
      if (!((vmask >> i) & 1u)) continue;
      const int64_t off = static_cast<int64_t>(i) * a.v_ld;
      for (int e = tid; e < a.dims[i]; e += kThreads) {
        a.v[off + e] = __ldcg(a.v_next + off + e);
      }
    }
  }
  if (tid == 0) {
    const unsigned int k = atomicAdd(a.bar + 1, 1u);
    if (k == gridDim.x - 1) {
      a.bar[0] = 0u;
      a.bar[1] = 0u;
      __threadfence();
    }
  }
}

constexpr int kSmemLimit = 232448;  // shared memory a block may use (H100)

// Opt the kernel in to all the dynamic shared memory its static part leaves.
cudaError_t set_attributes(int* static_bytes) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, fista_kernel);
  if (err != cudaSuccess) return err;
  *static_bytes = static_cast<int>(fa.sharedSizeBytes);
  return cudaFuncSetAttribute(fista_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmemLimit - *static_bytes);
}

}  // namespace

// Enqueues one step's projection on `stream` as one cooperative launch of
// `grid` blocks with `smem` bytes of dynamic shared memory (the plan of
// ops/cuda_fista.py::fista_plan) and returns the launch's error (0 on
// success). masters[i] / w16[i]: fp32 / bf16 buffers of rows of ld[i]
// entries whose (dims[i], dims[i+1]) block is layer i (the rest is zero
// and stays so). The scratch pointers are the wrapper's `fista_scratch`.
extern "C" int asr_fista_run(void* const* masters, void* const* w16,
                             const int* dims, const int* ld,
                             const int* at_off, int m, float rho, float eta1,
                             int nit, double tol, int max_rounds, double eps,
                             void* v, int v_ld, void* u, void* u_next,
                             void* counters, void* at,
                             void* r0, void* r1, void* q0, void* q1,
                             void* pw0, void* pw1, void* vb0, void* vb1,
                             void* v_next, int q_ld, void* crit, int nonneg,
                             void* bar, int grid,
                             int smem, void* stream) {
  if (m < 1 || m > kMaxLayers || grid < 1 || grid > kMaxGrid) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FistaArgs a{};
  for (int i = 0; i < m; ++i) {
    a.w[i] = static_cast<float*>(masters[i]);
    a.w16[i] = static_cast<bf16*>(w16[i]);
    a.ld[i] = ld[i];
    a.at_off[i] = at_off[i];
  }
  for (int i = 0; i <= m; ++i) a.dims[i] = dims[i];
  a.m = m;
  a.n = dims[m];
  if (a.n < 1 || a.n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  a.nit = nit;
  a.max_rounds = max_rounds;
  a.v_ld = v_ld;
  a.q_ld = q_ld;
  a.rho = rho;
  a.eta1 = eta1;
  a.tol = tol;
  a.eps = eps;
  a.v = static_cast<float*>(v);
  a.u = static_cast<double*>(u);
  a.u_next = static_cast<double*>(u_next);
  a.counters = static_cast<long long*>(counters);
  a.at = static_cast<float*>(at);
  a.r[0] = static_cast<float*>(r0);
  a.r[1] = static_cast<float*>(r1);
  a.q[0] = static_cast<float*>(q0);
  a.q[1] = static_cast<float*>(q1);
  a.pw[0] = static_cast<float*>(pw0);
  a.pw[1] = static_cast<float*>(pw1);
  a.vb[0] = static_cast<float*>(vb0);
  a.vb[1] = static_cast<float*>(vb1);
  a.v_next = static_cast<float*>(v_next);
  a.crit = static_cast<double*>(crit);
  a.nonneg = nonneg;
  a.bar = static_cast<unsigned int*>(bar);

  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, fista_kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Loads the kernel into the current context and opts it in to the dynamic
// shared memory its static part leaves, before a capture. Writes the
// device's SM count, how many blocks an SM holds with `smem` dynamic bytes
// (0: it cannot run), and the kernel's static shared memory in bytes. Fails
// on a device without cooperative launches.
extern "C" int asr_fista_preload(int smem, int* sms, int* per_sm,
                                 int* static_bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int coop = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  err = set_attributes(static_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  *per_sm = 0;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, fista_kernel, kThreads, smem));
}
