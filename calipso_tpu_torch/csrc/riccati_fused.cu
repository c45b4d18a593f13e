// Batched block-tridiagonal solve S x = b in one kernel: factor, forward
// sweep and backward sweep fused, so the factor never leaves the kernel.
//
// Replaces the TPU kernels calipso_tpu/ops/pallas_riccati.py
// _riccati_kernel (solve_batched_fused here) and _riccati_lanes_kernel
// (solve_batched_lanes). Both compute, for each lane, with S the
// symmetric block-tridiagonal matrix of diagonal blocks D_t and
// sub-diagonal blocks O_t:
//   factor:  S_t = D_t - M_{t-1}' M_{t-1},  L_t = chol(S_t),
//            M_t = L_t^{-1} O_t'
//   fwd:     u_t = L_t^{-1} (b_t - M_{t-1}' u_{t-1})      (t = 0..T-1)
//   bwd:     x_t = L_t^{-T} (u_t - M_t x_{t+1})          (t = T-1..0)
// D (B, T, d, d), O (B, T-1, d, d) and b (B, T, d) go in, x (B, T, d)
// comes out. A stage whose S_t is not positive definite (a pivot <= 0 or
// not finite) ends the lane: every entry of its x is written as NaN (what
// the plain version gives by propagation through both sweeps). The other
// lanes are untouched. 1 <= d <= 64, T >= 1.
//
// Bound (H100 SXM: 3.35 TB/s HBM, 67 TFLOP/s float32; D read as its lower
// triangles): at the batched rocket's shape (B=1024, T=31, d=9, float32)
// the solve moves 18.0 MB (5.4 us) against 70 MFLOP (1.0 us), at the
// quadruped's (B=128, T=8, d=54) 17.0 MB (5.1 us) against 0.35 GFLOP
// (5.3 us): bound by memory traffic at the first and by operations at the
// second, in principle. In practice the stages and the pivots of a stage
// are a chain of dependent steps, and the designs keep that chain short.
//
// fused (kernel 8), the TPU ran one grid program per scenario with the
// horizon's L, M and u in VMEM scratch. For d <= 32 (the rocket's d = 9;
// solve_batched_reg_kernel, templated widths 12, 16 and 32 as
// factor_lanes) one warp owns one lane and walks its horizon twice:
//  - forward, a stage as factor_lanes' register stage does it, with the
//    same device code (riccati_reg.cuh): thread i holds row i of S_t and
//    of O_t in registers, S_t = D_t - M_{t-1}' M_{t-1} is a Gram product
//    of the previous stage's o rows (gram_update), and one right-looking
//    Cholesky of the stacked panel [S_t ; O_t] gives L_t and M_t' together
//    (panel_pivots), a shuffle a pivot and a shuffle an l_jk, no barrier.
//    The forward sweep folds in: thread i's previous o row is column i of
//    M_{t-1}, so r_t = b_t - M_{t-1}' u_{t-1} is that row dotted with
//    u_{t-1} (broadcast 16-byte reads, four partial sums), and u_t =
//    L_t^{-1} r_t takes d shuffles from the register rows, with the
//    reciprocal pivots the factor already took. Each thread keeps its row
//    of L_t (1 / l_ii on the diagonal, zeros above it), its o row and u_t.
//    D_{t+1}, O_{t+1} and b_{t+1} land a few stages ahead in a ring of
//    shared-memory slots by cp.async, flat as they lie in device memory
//    (16-byte pieces where the sizes and addresses allow it, at d = 9
//    element by element);
//  - backward, as solve_lanes' backward sweep: thread i reads column i of
//    L_t and row i of M_t (column i of the kept o rows) from the warp's
//    store, takes the coupling M_t x_{t+1} in four partial sums, and each
//    pivot is one multiply, one shuffle and one FMA.
// The kept rows are at a row stride of d rounded up to odd, so that the
// warp's row writes and column reads hit distinct banks. Where eight
// warps' shares of the horizon's L, M and u fit in a block's shared
// memory (a warp's (2T - 1) d (d|1) + T d words and its slots: 25 KB at
// (31, 9) in float32), D, O and b are read once, x is written once, and L
// and M never reach device memory; past that (float64 at (31, 9), d = 32
// at T = 31) L and M go to the workspace the caller allocates
// (calipso_solve_batched_fused_workspace says how many words a lane needs)
// and u_t to x, and the kernel's registers, not its shared memory, set how
// many warps an SM holds: float64 at (1024, 31, 9) took 0.220 ms on chip
// (4 warps an SM, two waves) and 0.154 in the workspace (one wave) on an
// H100, float32 0.0995 on chip and 0.118 in the workspace. No barrier, no division
// and no integer division runs in any loop; the failure test is
// warp-uniform. A block holds up to 4 warps, fewer where the batch would
// leave SMs idle. d in 33..64 (the quadruped's d = 54) keeps the first
// design (solve_batched_fused_wide_kernel): one thread block a lane, the
// horizon's L and M in shared memory where they fit ((2T - 1) d (d+1)
// words plus two vectors, 178 KB at the quadruped's T=8, d=54; else the
// workspace), the work of a stage spread over the block with one
// __syncthreads() per pivot, M_t and u_t out of one substitution.
//
// lanes (kernel 9): the TPU put the batch on the 128-wide lane axis,
// (T, d, d, B) blocks, and ran every scenario's sequence in lockstep on
// the vector unit. Here one thread owns one scenario and runs the
// sequence alone; the batch stays the fastest axis of every array, so
// neighbouring threads read and write neighbouring words and every access
// coalesces. The caller hands in its own transposed copies, D (T, d, d,
// B), O' (T-1, d, d, B) with O'_t = O_t' and b (T, d, B); the kernel turns
// D_t into L_t and O'_t into M_t in place and keeps u_t in x (T, d, B).
// It is latency-bound by design: the d^3 dependent loads a stage of one
// thread, at a few warps for the whole card.
//
// Plain C interface, loaded with ctypes: every entry point launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include "riccati_reg.cuh"

namespace {

constexpr int kMaxThreads = 256;  // fused, d > 32: threads per block
constexpr int kLanesThreads = 32;  // lanes: one warp per block, so lanes spread over SMs
constexpr int kMaxD = 64;
constexpr int kMaxFusedWarps = 4;  // fused, d <= 32: at most this many warps a block
// fused, d <= 32: the horizon's factor stays on chip where this many warps
// can hold theirs in a block's shared memory (two blocks of 4 an SM: the
// rocket batch's 1024 lanes over 132 SMs in one wave)
constexpr int kOnChipWarps = 8;

template <typename T>
__device__ __forceinline__ bool pivot_ok(T p) {
  return p > T(0) && p - p == T(0);  // positive and finite
}

// Words of a stage slot of solve_batched_reg_kernel: D_t, O_t (d x d each)
// and b_t, rounded to 16 bytes
template <typename T>
__host__ __device__ constexpr int fused_slot_words(int d) {
  return round16<T>(2 * d * d + d);
}

// Stage n's inputs of solve_batched_reg_kernel (D_n, O_n but for the last
// stage, b_n) into slot n & (kSlots - 1); one batch committed a stage,
// empty past the last, so that a wait counts stages.
template <int kSlots, typename T>
__device__ __forceinline__ void copy_fused_stage(int n, T* ring, int slot_words, const T* Dl, const T* Ol,
                                                 const T* bl, int T_, int d, bool vec, bool vecb, int lane) {
  if (n < T_) {
    const int blk = d * d;
    T* slot = ring + (n & (kSlots - 1)) * slot_words;
    warp_copy_async(slot, Dl + n * blk, blk, vec, lane);
    if (n < T_ - 1) warp_copy_async(slot + blk, Ol + n * blk, blk, vec, lane);
    warp_copy_async(slot + 2 * blk, bl + n * d, d, vecb, lane);
  }
  __pipeline_commit();
}

// fused for d <= kMax (12, 16 or 32): one warp a lane (see the file
// comment). Shared memory per warp (per_warp words, fused_reg_words): the
// ring of stage slots, stage n in slot n & (kSlots - 1), copied kSlots - 1
// stages ahead; the o rows in two buffers (stage t's in buffer t & 1, read
// by stage t + 1), row stride ldg = kMax + 16 / sizeof(T); the vector V in
// two buffers; and, where kOnChip, the kept rows and u. Without kOnChip the
// kept rows are the lane's part of `work` ((2T - 1) d (d|1) words) and u_t
// waits in x.
template <typename T, int kMax, bool kOnChip>
__global__ void __launch_bounds__(kMaxFusedWarps * kWarp, 1)
    solve_batched_reg_kernel(const T* __restrict__ D, const T* __restrict__ O, const T* __restrict__ bv,
                             T* __restrict__ x, T* __restrict__ work, int B, int T_, int d, int per_warp,
                             int vec, int vecb) {
  constexpr int kSlots = factor_slots(kMax);
  constexpr int ldg = kMax + 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int blk = d * d, ldw = d | 1, hblk = d * ldw;
  const int slot_words = fused_slot_words<T>(d);
  T* const ring = reinterpret_cast<T*>(smem_raw) + static_cast<size_t>(warp) * per_warp;
  T* const G = ring + kSlots * slot_words;
  T* const V = G + 2 * kMax * ldg;
  const long long b = static_cast<long long>(blockIdx.x) * warps + warp;
  if (b >= B) return;  // ragged batch edge; the kernel has no block barrier
  const T* Dl = D + b * T_ * blk;
  const T* Ol = O + b * (T_ - 1) * blk;
  const T* bl = bv + b * T_ * d;
  T* const xl = x + b * T_ * d;
  // the kept rows: L_t's at Lh + t hblk, M_t''s at Mh + t hblk, row i at i ldw
  T* const Lh = kOnChip ? V + 2 * kMax : work + b * (2LL * T_ - 1) * hblk;
  T* const Mh = Lh + static_cast<long long>(T_) * hblk;
  T* const uh = kOnChip ? Mh + static_cast<long long>(T_ - 1) * hblk : xl;  // u_t at uh + t d
  const int c = min(lane, d - 1);  // this thread's row, clamped to a real one to read
  const bool own = lane < d;
  for (int n = 0; n < kSlots - 1; ++n)
    copy_fused_stage<kSlots>(n, ring, slot_words, Dl, Ol, bl, T_, d, vec, vecb, lane);

  // s[j]: S_t[c][j], then L_t[c][j]; o[k]: O_t[c][k], then M_t[k][c]
  // (zero past d); r: this thread's entry of r_t, then of u_t. The threads
  // past d hold zero rows and r = 0, as in factor_lanes.
  T s[kMax], o[kMax];
#pragma unroll
  for (int k = 0; k < kMax; ++k) s[k] = o[k] = T(0);
  T r = T(0);
  bool ok = true;
  for (int t = 0; t < T_; ++t) {
    const T* Ds = ring + (t & (kSlots - 1)) * slot_words;
    const T* Os = Ds + blk;
    const T* bs = Os + blk;
    __pipeline_wait_prior(kSlots - 2);
    __syncwarp();  // stage t's inputs have landed; stage t-1's slot is free
    copy_fused_stage<kSlots>(t + kSlots - 1, ring, slot_words, Dl, Ol, bl, T_, d, vec, vecb, lane);

    // S_t = D_t - M_{t-1}' M_{t-1} and r_t = b_t - M_{t-1}' u_{t-1}, both
    // from this thread's o row of stage t-1
#pragma unroll
    for (int j = 0; j < kMax; ++j) s[j] = Ds[c * d + j];
    r = own ? bs[c] : T(0);
    if (t > 0) {
      gram_update<T, kMax>(s, o, G + ((t - 1) & 1) * kMax * ldg, ldg);
      r -= dot_bcast<T, kMax>(o, V + ((t - 1) & 1) * kMax);
    }
#pragma unroll
    for (int k = 0; k < kMax; ++k) {
      o[k] = own && k < d && t < T_ - 1 ? Os[c * d + k] : T(0);
      if (!own) s[k] = T(0);
    }

    // the stacked panel [S_t ; O_t] into L_t and M_t'; then L_t u_t = r_t
    // from the top: u_j = r_j / l_jj by the reciprocal, broadcast, the rows
    // below take column j (this thread's row)
    T inv = T(0);  // 1 / l_cc
    panel_pivots<true>(s, o, d, lane, ok, inv);
    if (!ok) break;
#pragma unroll
    for (int j = 0; j < kMax; ++j) {
      if (j >= d) break;
      const T uj = __shfl_sync(kFull, r * inv, j);
      r = lane == j ? uj : (lane > j ? r - s[j] * uj : r);
    }

    // keep L_t's row (1 / l_cc on the diagonal, zeros above it), the o
    // row and u_t; the o row into G for stage t+1's Gram product, u_t into V
    if (own) {
      T* const Lr = Lh + static_cast<long long>(t) * hblk + lane * ldw;
#pragma unroll
      for (int j = 0; j < kMax; ++j)
        if (j < d) Lr[j] = j < lane ? s[j] : (j == lane ? inv : T(0));
      if (t < T_ - 1) {
        T* const Mr = Mh + static_cast<long long>(t) * hblk + lane * ldw;
        T* const Gc = G + (t & 1) * kMax * ldg + lane * ldg;
#pragma unroll
        for (int k = 0; k < kMax; ++k)
          if (k < d) Mr[k] = o[k];
#pragma unroll
        for (int k = 0; k < kMax; k += 4) store4(Gc + k, o[k], o[k + 1], o[k + 2], o[k + 3]);
      }
      uh[t * d + lane] = r;
    }
    if (lane < kMax) V[(t & 1) * kMax + lane] = r;
    __syncwarp();  // the o rows are in G, u_t in V
  }
  __pipeline_wait_prior(0);  // no copy is in flight past here

  if (!ok) {  // uniform over the warp
    const T nan = quiet_nan<T>();
    for (int e = lane; e < T_ * d; e += kWarp) xl[e] = nan;
    return;
  }

  // x_t = L_t^{-T} (u_t - M_t x_{t+1}) from the last stage, r = u_{T-1}:
  // thread i takes column i of L_t and row i of M_t (column i of the kept o
  // rows: consecutive words across the warp), the coupling in four partial
  // sums; the rows above pivot j take row j of L_t
  for (int t = T_ - 1; t >= 0; --t) {
    const T* const Lt = Lh + static_cast<long long>(t) * hblk;
    const T* const Mt = Mh + static_cast<long long>(t) * hblk;
    T l[kMax];
#pragma unroll
    for (int j = 0; j < kMax; ++j) l[j] = j < d ? Lt[j * ldw + c] : T(0);
    const T inv = own ? Lt[c * ldw + c] : T(0);
    if (t < T_ - 1) {
      T m[kMax];
#pragma unroll
      for (int k = 0; k < kMax; ++k) m[k] = k < d ? Mt[k * ldw + c] : T(0);
      r = own ? uh[t * d + lane] - dot_bcast<T, kMax>(m, V + ((t + 1) & 1) * kMax) : T(0);
    }
#pragma unroll
    for (int j = kMax - 1; j >= 0; --j) {
      if (j >= d) continue;
      const T xj = __shfl_sync(kFull, r * inv, j);
      r = lane == j ? xj : (lane < j ? r - l[j] * xj : r);
    }
    if (own) xl[t * d + lane] = r;
    if (lane < kMax) V[(t & 1) * kMax + lane] = r;
    __syncwarp();  // x_t is in V
  }
}

// fused for d in 33..64 (the first design): one block per lane. Lf[t]
// (t < T) holds S_t, factored in place into L_t; Mf[t] (t < T-1) holds O_t row-major, i.e. column c of O_t' in row
// c, turned in place into M_t with column c in row c (the carry the next
// stage's Schur update reads); each d rows of ld = d + 1. Both live in
// shared memory when `work` is null, else in the lane's part of `work`.
// Shared memory always holds v (the carry: u_{t-1} forward, x_{t+1}
// backward) and r (the stage's right-hand side); u_t waits in x.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    solve_batched_fused_wide_kernel(const T* __restrict__ D, const T* __restrict__ O,
                                    const T* __restrict__ bv, T* x, T* work, int T_, int d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = d + 1;
  const int blk = d * ld;
  T* const v = reinterpret_cast<T*>(smem_raw);
  T* const r = v + ld;
  const long long lane = blockIdx.x;
  const long long nblk = 2LL * T_ - 1;
  T* const Lf = work == nullptr ? r + ld : work + lane * nblk * blk;
  T* const Mf = Lf + static_cast<long long>(T_) * blk;
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long dd = static_cast<long long>(d) * d;
  const int nn = d * d;
  const T* Dl = D + lane * T_ * dd;
  const T* Ol = O + lane * (T_ - 1) * dd;
  const T* bl = bv + lane * T_ * d;
  T* xl = x + lane * T_ * d;

  bool ok = true;
  for (int t = 0; t < T_ && ok; ++t) {
    T* S = Lf + static_cast<long long>(t) * blk;
    T* R = Mf + static_cast<long long>(t) * blk;
    const T* C = Mf + static_cast<long long>(t - 1) * blk;  // M_{t-1}, read for t > 0
    const bool coupled = t < T_ - 1;

    // S_t = D_t - M_{t-1}' M_{t-1} (lower triangle), O_t into R, and
    // r = b_t - M_{t-1}' u_{t-1}
    for (int e = tid; e < nn; e += nt) {
      const int i = e / d, j = e % d;
      if (j <= i) {
        T s = Dl[t * dd + e];
        if (t > 0)
          for (int k = 0; k < d; ++k) s -= C[i * ld + k] * C[j * ld + k];
        S[i * ld + j] = s;
      }
      if (coupled) R[i * ld + j] = Ol[t * dd + e];
    }
    for (int i = tid; i < d; i += nt) {
      T s = bl[t * d + i];
      if (t > 0)
        for (int k = 0; k < d; ++k) s -= C[i * ld + k] * v[k];
      r[i] = s;
    }
    __syncthreads();

    // right-looking Cholesky of the lower triangle, in place; every thread
    // reads the same pivot after a barrier, so the failure test (and the
    // break) is uniform over the block
    T prev = T(0);
    for (int k = 0; k < d; ++k) {
      const T pkk = S[k * ld + k];
      if (!pivot_ok(pkk)) {
        ok = false;
        break;
      }
      if (k > 0) {
        const T lp = sqrt(prev);
        for (int i = k - 1 + tid; i < d; i += nt)
          S[i * ld + k - 1] = i == k - 1 ? lp : S[i * ld + k - 1] / lp;
      }
      const T inv = T(1) / pkk;
      const int w = d - k - 1;
      for (int e = tid; e < w * w; e += nt) {
        const int i = k + 1 + e / w, j = k + 1 + e % w;
        if (j <= i) S[i * ld + j] -= S[i * ld + k] * S[j * ld + k] * inv;
      }
      prev = pkk;
      __syncthreads();
    }
    if (!ok) break;
    if (tid == 0) S[(d - 1) * ld + d - 1] = sqrt(prev);
    __syncthreads();

    // [M_t u_t] = L_t^{-1} [O_t' r] by (column, row) element, r the last
    // column: pivot j updates the rows below it with the unscaled row j
    // and scales row j - 1
    const int ncol = coupled ? d + 1 : 1;
    const int nr = ncol * d;
    for (int j = 0; j < d; ++j) {
      const T inv = T(1) / S[j * ld + j];
      for (int e = tid; e < nr; e += nt) {
        const int c = e / d, i = e % d;
        T* col = c == ncol - 1 ? r : R + c * ld;
        if (i > j)
          col[i] -= S[i * ld + j] * col[j] * inv;
        else if (i == j - 1)
          col[i] /= S[i * ld + i];
      }
      __syncthreads();
    }
    for (int c = tid; c < ncol; c += nt) {
      T* col = c == ncol - 1 ? r : R + c * ld;
      col[d - 1] /= S[(d - 1) * ld + d - 1];
    }
    __syncthreads();
    for (int i = tid; i < d; i += nt) {
      v[i] = r[i];
      xl[t * d + i] = r[i];  // u_t, read back by the same thread below
    }
    __syncthreads();
  }

  if (!ok) {
    const T nan = quiet_nan<T>();
    for (int e = tid; e < T_ * d; e += nt) xl[e] = nan;
    return;  // uniform over the block: no barrier follows
  }

  for (int t = T_ - 1; t >= 0; --t) {
    const T* Lt = Lf + static_cast<long long>(t) * blk;
    const T* Ct = Mf + static_cast<long long>(t) * blk;  // row k = column k of M_t
    // r = u_t - M_t x_{t+1}
    for (int i = tid; i < d; i += nt) {
      T s = xl[t * d + i];
      if (t < T_ - 1)
        for (int k = 0; k < d; ++k) s -= Ct[k * ld + i] * v[k];
      r[i] = s;
    }
    __syncthreads();
    // L_t' x_t = r from the bottom: pivot j updates the rows above it and
    // scales row j + 1
    for (int j = d - 1; j >= 0; --j) {
      const T inv = T(1) / Lt[j * ld + j];
      for (int i = tid; i < d; i += nt) {
        if (i < j)
          r[i] -= Lt[j * ld + i] * r[j] * inv;
        else if (i == j + 1)
          r[i] /= Lt[i * ld + i];
      }
      __syncthreads();
    }
    if (tid == 0) r[0] /= Lt[0];
    __syncthreads();
    for (int i = tid; i < d; i += nt) {
      v[i] = r[i];
      xl[t * d + i] = r[i];
    }
    __syncthreads();
  }
}

// One thread per lane b. Element (t, i, j) of a (., d, d, B) array is at
// ((t d + i) d + j) B + b, element (t, i) of a (., d, B) array at
// (t d + i) B + b.
template <typename T>
__global__ void __launch_bounds__(kLanesThreads)
    solve_batched_lanes_kernel(T* DL, T* OM, const T* __restrict__ bv, T* x, int B, int T_,
                               int d) {
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;  // ragged batch edge; the kernel has no barrier
  const long long sB = B;
  const long long blk = static_cast<long long>(d) * d * sB;  // one (d, d, B) block
  const long long vec = static_cast<long long>(d) * sB;      // one (d, B) vector

  bool ok = true;
  for (int t = 0; t < T_ && ok; ++t) {
    T* S = DL + t * blk + b;                       // S[(i d + j) B]
    const T* C = OM + (t - 1) * blk + b;           // M_{t-1}[k][i] at C[(k d + i) B]
    T* ut = x + t * vec + b;                       // u_t[i] at ut[i B]
    const T* up = x + (t - 1) * vec + b;

    // S_t = D_t - M_{t-1}' M_{t-1}, lower triangle, in place
    if (t > 0) {
      for (int i = 0; i < d; ++i)
        for (int j = 0; j <= i; ++j) {
          T s = S[(i * d + j) * sB];
          for (int k = 0; k < d; ++k) s -= C[(k * d + i) * sB] * C[(k * d + j) * sB];
          S[(i * d + j) * sB] = s;
        }
    }
    // right-looking Cholesky in place
    for (int k = 0; k < d; ++k) {
      const T pkk = S[(k * d + k) * sB];
      if (!pivot_ok(pkk)) {
        ok = false;
        break;
      }
      const T lkk = sqrt(pkk);
      S[(k * d + k) * sB] = lkk;
      for (int i = k + 1; i < d; ++i) S[(i * d + k) * sB] /= lkk;
      for (int j = k + 1; j < d; ++j) {
        const T ljk = S[(j * d + k) * sB];
        for (int i = j; i < d; ++i) S[(i * d + j) * sB] -= S[(i * d + k) * sB] * ljk;
      }
    }
    if (!ok) break;

    // M_t = L_t^{-1} O_t', column by column, in place
    if (t < T_ - 1) {
      T* X = OM + t * blk + b;
      for (int c = 0; c < d; ++c)
        for (int j = 0; j < d; ++j) {
          T s = X[(j * d + c) * sB];
          for (int k = 0; k < j; ++k) s -= S[(j * d + k) * sB] * X[(k * d + c) * sB];
          X[(j * d + c) * sB] = s / S[(j * d + j) * sB];
        }
    }
    // u_t = L_t^{-1} (b_t - M_{t-1}' u_{t-1}), into x_t
    for (int i = 0; i < d; ++i) {
      T s = bv[t * vec + i * sB + b];
      if (t > 0)
        for (int k = 0; k < d; ++k) s -= C[(k * d + i) * sB] * up[k * sB];
      for (int k = 0; k < i; ++k) s -= S[(i * d + k) * sB] * ut[k * sB];
      ut[i * sB] = s / S[(i * d + i) * sB];
    }
  }

  if (!ok) {
    const T nan = quiet_nan<T>();
    for (long long e = 0; e < static_cast<long long>(T_) * d; ++e) x[e * sB + b] = nan;
    return;
  }

  // x_t = L_t^{-T} (u_t - M_t x_{t+1}), in place over u_t
  for (int t = T_ - 1; t >= 0; --t) {
    const T* Lt = DL + t * blk + b;
    const T* Mt = OM + t * blk + b;  // M_t[i][k] at Mt[(i d + k) B]
    T* xt = x + t * vec + b;
    const T* xn = x + (t + 1) * vec + b;
    if (t < T_ - 1)
      for (int i = 0; i < d; ++i) {
        T s = xt[i * sB];
        for (int k = 0; k < d; ++k) s -= Mt[(i * d + k) * sB] * xn[k * sB];
        xt[i * sB] = s;
      }
    for (int i = d - 1; i >= 0; --i) {
      T s = xt[i * sB];
      for (int k = i + 1; k < d; ++k) s -= Lt[(k * d + i) * sB] * xt[k * sB];
      xt[i * sB] = s / Lt[(i * d + i) * sB];
    }
  }
}

bool shape_ok(int B, int T_, int d) { return B >= 0 && T_ >= 1 && d >= 1 && d <= kMaxD; }

// Shared memory of solve_batched_fused_wide_kernel with the horizon
// resident, in bytes.
template <typename T>
size_t resident_smem(int T_, int d) {
  const size_t ld = static_cast<size_t>(d) + 1;
  return sizeof(T) * (2 * ld + (2 * static_cast<size_t>(T_) - 1) * d * ld);
}

// The register kernel's width for d <= 32
int reg_width(int d) { return d <= 12 ? 12 : (d <= 16 ? 16 : kWarp); }

// Words of a warp's shared memory in solve_batched_reg_kernel at width kMax:
// the ring of stage slots; two buffers of kMax o rows of kMax + 16 /
// sizeof(T) words (the Gram coupling's); two vectors of kMax (u_{t-1}
// forward, x_{t+1} backward); and, on chip, the kept rows of L_t (T d rows
// of d|1 words) and of M_t' ((T-1) d rows) and u (T d), rounded to 16 bytes
template <typename T>
size_t fused_reg_words(int kMax, int T_, int d, bool on_chip) {
  constexpr size_t per = 16 / sizeof(T);
  size_t words = static_cast<size_t>(factor_slots(kMax)) * fused_slot_words<T>(d) +
                 2 * static_cast<size_t>(kMax) * (kMax + per) + 2 * static_cast<size_t>(kMax);
  if (on_chip) words += (2 * static_cast<size_t>(T_) - 1) * d * (d | 1) + static_cast<size_t>(T_) * d;
  return (words + per - 1) / per * per;
}

// Words of device-memory workspace a lane needs: 0 when the horizon's
// factor stays in the current device's shared memory (for d <= 32 where
// kOnChipWarps warps' shares fit in a block's limit; for the first design
// where a block's does), else (2T - 1) d (d|1) for d <= 32 and (2T - 1) d
// (d + 1) past it.
template <typename T>
int fused_workspace(int T_, int d) {
  if (!shape_ok(0, T_, d)) return -static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (d <= kWarp)
    return kOnChipWarps * sizeof(T) * fused_reg_words<T>(reg_width(d), T_, d, true) <= static_cast<size_t>(optin)
               ? 0 : (2 * T_ - 1) * d * (d | 1);
  if (resident_smem<T>(T_, d) <= static_cast<size_t>(optin)) return 0;
  return (2 * T_ - 1) * d * (d + 1);
}

// solve_batched_reg_kernel<T, kMax>, on chip where `work` is null: warps a
// block B / SMs, at least one (so that every SM has a lane where the batch
// allows) and at most kMaxFusedWarps
template <typename T, int kMax>
cudaError_t launch_fused_reg(const T* D, const T* O, const T* b, T* x, T* work, int B, int T_, int d,
                             cudaStream_t stream) {
  int want = B / sm_count();
  if (want > kMaxFusedWarps) want = kMaxFusedWarps;
  const bool on_chip = work == nullptr;
  const size_t words = fused_reg_words<T>(kMax, T_, d, on_chip);
  auto kernel = on_chip ? solve_batched_reg_kernel<T, kMax, true> : solve_batched_reg_kernel<T, kMax, false>;
  int warps;
  size_t smem;
  cudaError_t err = configure(kernel, sizeof(T) * words, &warps, &smem, kMaxSmem, want < 1 ? 1 : want);
  if (err != cudaSuccess) return err;
  const int vec = (sizeof(T) * d * d) % 16 == 0 && aligned16(D) && aligned16(O);
  const int vecb = vec && (sizeof(T) * d) % 16 == 0 && aligned16(b);
  kernel<<<(B + warps - 1) / warps, warps * kWarp, smem, stream>>>(D, O, b, x, work, B, T_, d,
                                                                  static_cast<int>(words), vec, vecb);
  return cudaGetLastError();
}

// The fused solve: the register kernel up to d = 32 (width 12, 16 or 32),
// a block a lane past it; L and M in shared memory where `work` is null
template <typename T>
int solve_batched_fused(const void* D, const void* O, const void* b, void* x, void* work, int B,
                        int T_, int d, void* stream) {
  if (!shape_ok(B, T_, d)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const T* Dp = static_cast<const T*>(D);
  const T* Op = static_cast<const T*>(O);
  const T* bp = static_cast<const T*>(b);
  T* xp = static_cast<T*>(x);
  T* wp = static_cast<T*>(work);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 12) return static_cast<int>(launch_fused_reg<T, 12>(Dp, Op, bp, xp, wp, B, T_, d, st));
  if (d <= 16) return static_cast<int>(launch_fused_reg<T, 16>(Dp, Op, bp, xp, wp, B, T_, d, st));
  if (d <= kWarp) return static_cast<int>(launch_fused_reg<T, kWarp>(Dp, Op, bp, xp, wp, B, T_, d, st));
  const size_t smem =
      work == nullptr ? resident_smem<T>(T_, d) : sizeof(T) * 2 * (static_cast<size_t>(d) + 1);
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(solve_batched_fused_wide_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int threads = (d * d + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  solve_batched_fused_wide_kernel<T><<<B, threads, smem, st>>>(Dp, Op, bp, xp, wp, T_, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int solve_batched_lanes(void* DL, void* OM, const void* b, void* x, int B, int T_, int d,
                        void* stream) {
  if (!shape_ok(B, T_, d)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const int grid = (B + kLanesThreads - 1) / kLanesThreads;
  solve_batched_lanes_kernel<T><<<grid, kLanesThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(DL), static_cast<T*>(OM), static_cast<const T*>(b), static_cast<T*>(x), B,
      T_, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int calipso_solve_batched_fused_workspace_f32(int T, int d) {
  return fused_workspace<float>(T, d);
}

int calipso_solve_batched_fused_workspace_f64(int T, int d) {
  return fused_workspace<double>(T, d);
}

int calipso_solve_batched_fused_f32(const void* D, const void* O, const void* b, void* x,
                                    void* work, int B, int T, int d, void* stream) {
  return solve_batched_fused<float>(D, O, b, x, work, B, T, d, stream);
}

int calipso_solve_batched_fused_f64(const void* D, const void* O, const void* b, void* x,
                                    void* work, int B, int T, int d, void* stream) {
  return solve_batched_fused<double>(D, O, b, x, work, B, T, d, stream);
}

int calipso_solve_batched_lanes_f32(void* D, void* O, const void* b, void* x, int B, int T,
                                    int d, void* stream) {
  return solve_batched_lanes<float>(D, O, b, x, B, T, d, stream);
}

int calipso_solve_batched_lanes_f64(void* D, void* O, const void* b, void* x, int B, int T,
                                    int d, void* stream) {
  return solve_batched_lanes<double>(D, O, b, x, B, T, d, stream);
}

}  // extern "C"
