// Batched block-tridiagonal Cholesky factor and solve over trajectory
// stages: the whole linear algebra of the riccati KKT backend.
//
// Replaces the TPU kernels calipso_tpu/ops/pallas_riccati.py
// _factor_lanes_kernel (factor_lanes here) and _solve_lanes_kernel
// (solve_lanes here). The TPU versions put the batch on the 128-wide
// lane axis, held the whole horizon (T, d, d, Bt) in VMEM and wrote a
// transposed factor that their wrapper un-transposed. Here one warp owns
// one lane (one problem), walks its horizon in a loop and reads and writes
// the public row-major (B, T, d, d) layout directly. 1 <= d <= 64, T >= 1.
//
// For each lane, with S the symmetric block-tridiagonal matrix of
// diagonal blocks D_t and sub-diagonal blocks O_t:
//   factor:  S_t = D_t - M_{t-1}' M_{t-1},  L_t = chol(S_t),
//            M_t = L_t^{-1} O_t'
//   solve:   u_t = L_t^{-1} (b_t - M_{t-1}' u_{t-1})      (t = 0..T-1)
//            x_t = L_t^{-T} (u_t - M_t x_{t+1})          (t = T-1..0)
// A stage whose S_t is not positive definite (a pivot <= 0 or not
// finite) ends the lane's factorization: the lower triangle of L_t and
// of every later L, and every later M from M_t on, are written as NaN --
// the inertia signal the solver reads, and what the reference scan gives
// by propagation.
//
// Bound (H100 SXM: 3.35 TB/s HBM, 67 TFLOP/s float32): every input is read
// once (a symmetric D and a triangular L as their lower triangles) and
// every output written once. At the batched rocket shape (B=1024, T=31,
// d=9, float32) the factor moves 35.9 MB (10.7 us) against 55 MFLOP
// (0.8 us), and the solve moves 18.0 MB (5.4 us): both are bound by
// memory traffic in principle. In practice the T stages and the d pivots
// of each stage are a chain of dependent steps, and 1024 lanes are about
// 8 warps an SM, too few to hide the latency of whatever sits on the
// chain, so the kernels are latency-bound: every step stays inside one
// warp (no block barriers, __syncwarp only).
//
// factor_lanes, for d <= 32 (every lane the lanes route sends it, since
// ops/riccati.route takes d >= 33 to the stream kernels): thread i holds
// row i of S_t and row i of O_t in registers, and one right-looking
// Cholesky of the stacked panel [S_t ; O_t] gives L_t (top rows) and
// O_t L_t^{-T} = M_t' (bottom rows) together, as factor_stream does at the
// scale of a block. At pivot k every thread takes the diagonal by one
// shuffle from thread k (the failure test is warp-uniform), the same
// correctly rounded sqrt and one reciprocal, scales its column-k entries,
// and takes each l_jk (j > k) by one shuffle from thread j: independent
// within a pivot, so they pipeline, and no barrier. The coupling D_{t+1}
// - M_t' M_t is a Gram product of the bottom rows (its (i, j) entry is
// o_i . o_j): each thread writes its o row to shared memory once and
// reads the others' as broadcasts in 16-byte pieces, in four partial
// sums. D_{t+1} and O_{t+1} land a few stages ahead in a ring of
// shared-memory slots, by cp.async, flat as they lie in device memory (in
// 16-byte pieces where d^2 sizeof(T) and the addresses allow it; at d = 9
// element by element), and thread i reads its rows at a row stride of d
// (no bank twice at d = 9). L_t goes out flat through shared memory, upper
// zeros included; M_t[k][i] is thread i's o_i[k], so for each k the warp
// writes d consecutive words. The pivots and the Gram product are
// riccati_reg.cuh's panel_pivots and gram_update, which the fused solve
// (riccati_fused.cu) runs too. The register rows are indexed only by
// compile-time indices: the loops run to a templated width (12, 16 or
// 32), the threads past d holding zero rows (the panel padded with
// identity), so that no branch splits a pivot's shuffles or the Gram
// product's reads; only the pivot loop stops at d. No integer division
// runs in any loop. A block holds up to 4 warps, fewer where the batch
// would leave SMs idle (one at the bench's B = 128). d in 33..64, which no
// route sends here but the contract takes, keeps the first design
// (factor_lanes_wide_kernel): the stage in padded shared memory, a
// separate forward substitution for M_t.
//
// solve_lanes keeps nothing on the chain but the pivots. A lane's 2T
// stage steps (the forward sweep's, then the backward one's) take their L
// and M from a ring of four shared-memory slots (two at d > 32), filled
// with cp.async three steps ahead, across the turn between the sweeps, as
// the blocks lie in device memory (in 16-byte pieces where d^2 sizeof(T)
// and the addresses allow it; at the rocket's d = 9 a block is 324 bytes,
// so element by element, with no division: the block is copied flat and
// indexed with a row stride of d); b_{t+1} and u_{t-1} are read into
// registers a stage ahead. Each thread computes the
// reciprocal of its row's pivot once a stage, in parallel; pivot j's owner
// scales its row by it, __shfl_sync broadcasts the value, and the other
// rows update with column j of L_t (forward) or row j (backward), loaded
// a step ahead. The coupling with the neighbouring stage (a per-warp
// shared copy of its solution) runs as four independent partial sums.
// u_t stays in shared memory between the sweeps (T d words a warp: 279
// at the rocket's shape, copied in as b with the first step) where a
// warp's share fits in a block's limit; past that it goes to x in device
// memory and comes back a stage ahead.
// d <= 32 takes one row a thread, 33..64 two (a second instantiation).
//
// Plain C interface, loaded with ctypes: every entry point launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include "riccati_reg.cuh"

namespace {

constexpr int kMaxD = 64;
// factor_lanes for d <= 32: at most this many warps a block, fewer where
// the batch would otherwise leave SMs idle
constexpr int kMaxFactorWarps = 4;

// Words of a warp's shared memory in factor_lanes_reg_kernel: the ring of
// stage slots (D_t then O_t, d x d each), rounded to 16 bytes; two
// buffers of kMax o rows of kMax + 16 / sizeof(T) words; L_t, rounded.
template <typename T>
__host__ __device__ constexpr int factor_ring_words(int kMax, int d) {
  return round16<T>(factor_slots(kMax) * 2 * d * d);
}
template <typename T>
__host__ __device__ constexpr int factor_reg_words(int kMax, int d) {
  return factor_ring_words<T>(kMax, d) + 2 * kMax * (kMax + 16 / static_cast<int>(sizeof(T))) +
         round16<T>(d * d);
}

// Stage n's blocks of factor_lanes (D_n and, but for the last stage, O_n)
// into slot n & (kSlots - 1); one batch committed a stage, empty past the
// last, so that a wait counts stages.
template <int kSlots, typename T>
__device__ __forceinline__ void copy_factor_stage(int n, T* ring, const T* Dl, const T* Ol, int T_,
                                                  int blk, bool vec, int lane) {
  if (n < T_) {
    T* slot = ring + (n & (kSlots - 1)) * 2 * blk;
    warp_copy_async(slot, Dl + n * blk, blk, vec, lane);
    if (n < T_ - 1) warp_copy_async(slot + blk, Ol + n * blk, blk, vec, lane);
  }
  __pipeline_commit();
}

// factor_lanes for d <= kMax (12, 16 or 32): one warp a lane, thread i holding
// row i of S_t (s) and of O_t (o, then M_t') in registers (see the file
// comment). Shared memory per warp (per_warp words, factor_reg_words):
// the ring of stage slots, stage n in slot n & (kSlots - 1), copied kSlots
// - 1 stages ahead; the o rows in two buffers (stage t's in buffer t & 1,
// read by stage t + 1), row stride ldg = kMax + 16 / sizeof(T) so that
// rows are 16-byte aligned and 16-byte writes by a quarter warp hit
// distinct banks; and L_t on its way out.
template <typename T, int kMax>
__global__ void __launch_bounds__(kMaxFactorWarps * kWarp, 1)
    factor_lanes_reg_kernel(const T* __restrict__ D, const T* __restrict__ O, T* __restrict__ L,
                            T* __restrict__ M, int B, int T_, int d, int per_warp, int vec) {
  constexpr int kSlots = factor_slots(kMax);
  constexpr int ldg = kMax + 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int blk = d * d;
  T* const ring = reinterpret_cast<T*>(smem_raw) + static_cast<size_t>(warp) * per_warp;
  T* const G = ring + factor_ring_words<T>(kMax, d);
  T* const Ls = G + 2 * kMax * ldg;
  const long long b = static_cast<long long>(blockIdx.x) * warps + warp;
  if (b >= B) return;  // ragged batch edge; the kernel has no block barrier
  const T* Dl = D + b * T_ * blk;
  const T* Ol = O + b * (T_ - 1) * blk;
  T* Ll = L + b * T_ * blk;
  T* Ml = M + b * (T_ - 1) * blk;
  const int c = min(lane, d - 1);  // this thread's row, clamped to a real one to read
  const bool own = lane < d;
  for (int n = 0; n < kSlots - 1; ++n) copy_factor_stage<kSlots>(n, ring, Dl, Ol, T_, blk, vec, lane);

  // s[j]: S_t[c][j], then L_t[c][j] (j <= c; the rest is never read);
  // o[k]: O_t[c][k], then M_t[k][c]; o[k] = 0 for k >= d throughout. The
  // threads past d hold zero rows: with them the panel is [S_t ; O_t]
  // padded to kMax with identity, whose extra pivots are never taken, so
  // every loop but the pivots' runs to kMax with no branch and the
  // shuffles of a pivot pipeline (what they add is an exact zero).
  T s[kMax], o[kMax];
#pragma unroll
  for (int k = 0; k < kMax; ++k) s[k] = o[k] = T(0);
  bool ok = true;
  int t = 0;
  for (; t < T_; ++t) {
    const T* Ds = ring + (t & (kSlots - 1)) * 2 * blk;
    const T* Os = Ds + blk;
    __pipeline_wait_prior(kSlots - 2);
    __syncwarp();  // stage t's blocks have landed; stage t-1's slot is free
    copy_factor_stage<kSlots>(t + kSlots - 1, ring, Dl, Ol, T_, blk, vec, lane);

    // S_t = D_t - M_{t-1}' M_{t-1}: entry (c, j) takes the dot of this
    // thread's o row (M_{t-1}' row c) with o row j, read as a broadcast
    // (entries j >= d read past row c: never used)
#pragma unroll
    for (int j = 0; j < kMax; ++j) s[j] = Ds[c * d + j];
    if (t > 0) gram_update<T, kMax>(s, o, G + ((t - 1) & 1) * kMax * ldg, ldg);
#pragma unroll
    for (int k = 0; k < kMax; ++k) {
      o[k] = own && k < d && t < T_ - 1 ? Os[c * d + k] : T(0);
      if (!own) s[k] = T(0);
    }

    // right-looking Cholesky of the stacked panel [S_t ; O_t], row c of
    // each half in this thread's registers (panel_pivots)
    T inv_own = T(0);  // not read here
    panel_pivots<true>(s, o, d, lane, ok, inv_own);
    if (!ok) break;

    if (own) {
#pragma unroll
      for (int j = 0; j < kMax; ++j)
        if (j < d) Ls[lane * d + j] = j <= lane ? s[j] : T(0);
      if (t < T_ - 1) {
        T* Gc = G + (t & 1) * kMax * ldg;
        T* Mt = Ml + t * blk;
#pragma unroll
        for (int k = 0; k < kMax; k += 4) store4(Gc + lane * ldg + k, o[k], o[k + 1], o[k + 2], o[k + 3]);
#pragma unroll
        for (int k = 0; k < kMax; ++k)
          if (k < d) Mt[k * d + lane] = o[k];
      }
    }
    __syncwarp();  // L_t's rows are in Ls, the o rows in G
    warp_store(Ll + t * blk, Ls, blk, vec, lane);
  }
  __pipeline_wait_prior(0);  // no copy is in flight past here

  // a stage that is not positive definite: NaN over the lower triangle of
  // L_t and of every later L, and over every M from M_t on
  if (!ok && own) {
    const T nan = quiet_nan<T>();
    for (int st = t; st < T_; ++st) {
      T* Lr = Ll + st * blk + lane * d;
      for (int j = 0; j < d; ++j) Lr[j] = j > lane ? T(0) : nan;
      if (st < T_ - 1)
        for (int k = 0; k < d; ++k) Ml[st * blk + k * d + lane] = nan;
    }
  }
}

// factor_lanes for d in 33..64 (the first design): one warp per lane.
// Shared memory per warp: S (the stage's Schur block, factored in place)
// and Mb (M_{t-1} while S_t is formed, then M_t), each d rows of ld = d +
// 1 entries.
template <typename T>
__global__ void factor_lanes_wide_kernel(const T* __restrict__ D, const T* __restrict__ O,
                                    T* __restrict__ L, T* __restrict__ M, int B,
                                    int T_, int d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int ld = d + 1;
  T* S = reinterpret_cast<T*>(smem_raw) + static_cast<size_t>(warp) * 2 * d * ld;
  T* Mb = S + d * ld;
  const long long b = static_cast<long long>(blockIdx.x) * warps + warp;
  if (b >= B) return;  // ragged batch edge; the kernel has no block barrier
  const long long dd = static_cast<long long>(d) * d;
  const int nn = d * d;
  const T* Db = D + b * T_ * dd;
  const T* Ob = O + b * (T_ - 1) * dd;
  T* Lb = L + b * T_ * dd;
  T* Mo = M + b * (T_ - 1) * dd;

  int t = 0;
  for (; t < T_; ++t) {
    // S_t = D_t - M_{t-1}' M_{t-1}; only the lower triangle is read later
    const T* Dt = Db + t * dd;
    for (int e = lane; e < nn; e += kWarp) {
      const int i = e / d, j = e % d;
      T v = Dt[e];
      if (t > 0 && j <= i) {
        for (int k = 0; k < d; ++k) v -= Mb[k * ld + i] * Mb[k * ld + j];
      }
      S[i * ld + j] = v;
    }
    __syncwarp();

    // right-looking Cholesky of the lower triangle, in place; every
    // thread reads the same pivot, so the failure test is warp-uniform
    bool ok = true;
    for (int k = 0; k < d; ++k) {
      const T pkk = S[k * ld + k];
      if (!(pkk > T(0) && pkk - pkk == T(0))) {  // not positive, or not finite
        ok = false;
        break;
      }
      const T lkk = sqrt(pkk);
      __syncwarp();  // every thread has read S[k][k] before it is rewritten
      if (lane == 0) S[k * ld + k] = lkk;
      for (int i = k + 1 + lane; i < d; i += kWarp) S[i * ld + k] /= lkk;
      __syncwarp();
      const int w = d - k - 1;  // trailing block, lower triangle only
      for (int e = lane; e < w * w; e += kWarp) {
        const int i = k + 1 + e / w, j = k + 1 + e % w;
        if (j <= i) S[i * ld + j] -= S[i * ld + k] * S[j * ld + k];
      }
      __syncwarp();
    }
    if (!ok) break;

    T* Lt = Lb + t * dd;
    for (int e = lane; e < nn; e += kWarp) {
      const int i = e / d, j = e % d;
      Lt[e] = j > i ? T(0) : S[i * ld + j];
    }
    if (t < T_ - 1) {
      // M_t = L_t^{-1} O_t': Mb takes O_t' (M_{t-1} is no longer read),
      // then each thread forward-substitutes the columns it owns, with
      // no synchronisation between threads
      const T* Ot = Ob + t * dd;
      for (int e = lane; e < nn; e += kWarp) Mb[(e % d) * ld + e / d] = Ot[e];
      __syncwarp();
      for (int c = lane; c < d; c += kWarp) {
        for (int j = 0; j < d; ++j) {
          const T xj = Mb[j * ld + c] / S[j * ld + j];
          Mb[j * ld + c] = xj;
          for (int i = j + 1; i < d; ++i) Mb[i * ld + c] -= S[i * ld + j] * xj;
        }
      }
      __syncwarp();
      T* Mt = Mo + t * dd;
      for (int e = lane; e < nn; e += kWarp) Mt[e] = Mb[(e / d) * ld + e % d];
    }
    __syncwarp();
  }

  // a stage that is not positive definite: NaN over the lower triangle of
  // L_t and of every later L, and over every M from M_t on
  const T nan = quiet_nan<T>();
  for (int s = t; s < T_; ++s) {
    T* Ls = Lb + s * dd;
    for (int e = lane; e < nn; e += kWarp) Ls[e] = (e % d) > (e / d) ? T(0) : nan;
    if (s < T_ - 1) {
      T* Ms = Mo + s * dd;
      for (int e = lane; e < nn; e += kWarp) Ms[e] = nan;
    }
  }
}

// sum_k a[k stride] v[k] over k < n in four partial sums (k = 0, 4, 8, ...;
// 1, 5, ...; 2, 6, ...; 3, 7, ...), added pairwise: a dependent chain of
// about n / 4 FMAs instead of n.
template <typename T>
__device__ __forceinline__ T dot4(const T* a, int stride, const T* v, int n) {
  T s0 = T(0), s1 = T(0), s2 = T(0), s3 = T(0);
  int k = 0;
  for (; k + 4 <= n; k += 4) {
    s0 += a[k * stride] * v[k];
    s1 += a[(k + 1) * stride] * v[k + 1];
    s2 += a[(k + 2) * stride] * v[k + 2];
    s3 += a[(k + 3) * stride] * v[k + 3];
  }
  if (k < n) s0 += a[k * stride] * v[k];
  if (k + 1 < n) s1 += a[(k + 1) * stride] * v[k + 1];
  if (k + 2 < n) s2 += a[(k + 2) * stride] * v[k + 2];
  return (s0 + s1) + (s2 + s3);
}

// solve_lanes' slots of stage blocks in flight (a power of 2): four for
// one row a thread, two for two rows (d > 32: a stage's pivots take
// longer than a copy, and four slots of 64 x 64 float64 blocks would not
// fit in a block's shared memory).
__host__ __device__ constexpr int slots_for(int rows) { return rows == 1 ? 4 : 2; }

// The stage blocks of step n of solve_lanes' 2T steps (forward stage n,
// then backward stage 2T-1-n) into slot n & (kSlots - 1): L_t with M_{t-1}
// forward, L_t with M_t backward. Commits one batch a step, empty past the
// last, so that a wait counts steps.
template <int kSlots, typename T>
__device__ __forceinline__ void copy_step(int n, T* Lb, T* Mb, const T* Ll, const T* Ml, int T_,
                                          int blk, bool vec, int lane) {
  if (n < 2 * T_) {
    const bool fwd = n < T_;
    const int t = fwd ? n : 2 * T_ - 1 - n;
    const int tm = fwd ? t - 1 : t;
    const int slot = n & (kSlots - 1);
    warp_copy_async(Lb + slot * blk, Ll + t * blk, blk, vec, lane);
    if (tm >= 0 && tm < T_ - 1) warp_copy_async(Mb + slot * blk, Ml + tm * blk, blk, vec, lane);
  }
  __pipeline_commit();
}

// One warp per lane; kRows = 1 for d <= 32 (row `lane` of each stage
// vector, in a register), 2 for d in 33..64 (rows lane and lane + 32).
// Shared memory per warp (per_warp words): kSlots = slots_for(kRows)
// slots of L and of M, d x d row-major each as in device memory, step n's
// blocks in slot n & (kSlots - 1), copied kSlots - 1 steps ahead across
// the turn from the forward to the backward sweep; the neighbouring
// stage's solution twice (2 d words, slot t & 1 written at stage t); and,
// where `u_on_chip`, a T d vector that holds b, copied in with the first
// step, and takes u_t over b_t stage by stage. Without it b is read from
// device memory and u_t goes to x there. Either way b_{t+1} and u_{t-1}
// are loaded into registers a stage ahead.
template <typename T, int kRows>
__global__ void solve_lanes_kernel(const T* __restrict__ L, const T* __restrict__ M,
                                   const T* __restrict__ bv, T* __restrict__ x, int B, int T_,
                                   int d, int per_warp, int u_on_chip, int vec) {
  constexpr int kSlots = slots_for(kRows);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int blk = d * d;
  T* const Lb = reinterpret_cast<T*>(smem_raw) + static_cast<size_t>(warp) * per_warp;
  T* const Mb = Lb + kSlots * blk;
  T* const vb = Mb + kSlots * blk;
  const long long b = static_cast<long long>(blockIdx.x) * warps + warp;
  if (b >= B) return;  // ragged batch edge; the kernel has no block barrier
  const T* Ll = L + b * T_ * blk;
  const T* Ml = M + b * (T_ - 1) * blk;
  const T* bl = bv + b * T_ * d;
  T* xl = x + b * T_ * d;
  T* const us = vb + 2 * d;
  T* const uk = u_on_chip ? us : xl;        // u_t until the backward sweep
  const T* const bk = u_on_chip ? us : bl;  // b_t, in shared memory where u is
  // this thread's rows, clamped to a real row to read
  const int i0 = lane, i1 = lane + kWarp;
  const bool h0 = i0 < d, h1 = kRows > 1 && i1 < d;
  const int c0 = min(i0, d - 1), c1 = min(i1, d - 1);
  const int m0 = c0 * d, m1 = c1 * d;

  if (u_on_chip) warp_copy_async(us, bl, T_ * d, false, lane);  // joins step 0's batch
  for (int n = 0; n < kSlots - 1; ++n) copy_step<kSlots>(n, Lb, Mb, Ll, Ml, T_, blk, vec, lane);

  // forward: u_t = L_t^{-1} (b_t - M_{t-1}' u_{t-1})
  T r0 = T(0), r1 = T(0);  // b_t, then r, then u_t
  T n0 = T(0), n1 = T(0);  // b_{t+1}
  for (int t = 0; t < T_; ++t) {
    const int slot = t & (kSlots - 1);
    const T* Ls = Lb + slot * blk;
    const T* Ms = Mb + slot * blk;
    __pipeline_wait_prior(kSlots - 2);
    __syncwarp();  // step t's blocks have landed; step t-1's slot is free
    copy_step<kSlots>(t + kSlots - 1, Lb, Mb, Ll, Ml, T_, blk, vec, lane);
    if (t == 0) {
      if (h0) r0 = bk[i0];
      if (h1) r1 = bk[i1];
    } else {
      r0 = n0;
      r1 = n1;
    }
    if (t + 1 < T_) {  // b_{t+1}, loaded under this stage's work
      if (h0) n0 = bk[(t + 1) * d + i0];
      if (h1) n1 = bk[(t + 1) * d + i1];
    }
    // every thread's reciprocal pivots, off the chain
    const T inv0 = h0 ? T(1) / Ls[m0 + i0] : T(0);
    const T inv1 = h1 ? T(1) / Ls[m1 + i1] : T(0);
    if (t > 0) {  // row i takes column i of M_{t-1}
      const T* v = vb + ((t - 1) & 1) * d;
      r0 -= dot4(Ms + c0, d, v, d);
      if (kRows > 1) r1 -= dot4(Ms + c1, d, v, d);
    }
    // L_t u_t = r from the top: pivot j's owner scales its row, the
    // shuffle broadcasts u_j, the rows below take column j of L_t (loaded
    // a step ahead)
    T l0 = Ls[m0], l1 = Ls[m1];
    for (int j = 0; j < min(d, kWarp); ++j) {
      const int jn = min(j + 1, d - 1);
      const T n0l = Ls[m0 + jn], n1l = Ls[m1 + jn];
      const T uj = __shfl_sync(kFull, r0 * inv0, j);
      if (i0 == j)
        r0 = uj;
      else if (i0 > j)
        r0 -= l0 * uj;
      if (kRows > 1) r1 -= l1 * uj;
      l0 = n0l;
      l1 = n1l;
    }
    if (kRows > 1) {
      for (int j = kWarp; j < d; ++j) {
        const int jn = min(j + 1, d - 1);
        const T n1l = Ls[m1 + jn];
        const T uj = __shfl_sync(kFull, r1 * inv1, j - kWarp);
        if (i1 == j)
          r1 = uj;
        else if (i1 > j)
          r1 -= l1 * uj;
        l1 = n1l;
      }
    }
    if (h0) vb[(t & 1) * d + i0] = uk[t * d + i0] = r0;
    if (h1) vb[(t & 1) * d + i1] = uk[t * d + i1] = r1;
  }

  // backward: x_t = L_t^{-T} (u_t - M_t x_{t+1}); r holds u_{T-1}
  for (int t = T_ - 1; t >= 0; --t) {
    const int n = 2 * T_ - 1 - t;
    const int slot = n & (kSlots - 1);
    const T* Ls = Lb + slot * blk;
    const T* Ms = Mb + slot * blk;
    __pipeline_wait_prior(kSlots - 2);
    __syncwarp();  // step n's blocks have landed; step n-1's slot is free
    copy_step<kSlots>(n + kSlots - 1, Lb, Mb, Ll, Ml, T_, blk, vec, lane);
    if (t < T_ - 1) {
      r0 = n0;
      r1 = n1;
    }
    if (t > 0) {  // u_{t-1}, loaded a stage ahead
      if (h0) n0 = uk[(t - 1) * d + i0];
      if (h1) n1 = uk[(t - 1) * d + i1];
    }
    const T inv0 = h0 ? T(1) / Ls[m0 + i0] : T(0);
    const T inv1 = h1 ? T(1) / Ls[m1 + i1] : T(0);
    if (t < T_ - 1) {  // row i of M_t
      const T* v = vb + ((t + 1) & 1) * d;
      r0 -= dot4(Ms + m0, 1, v, d);
      if (kRows > 1) r1 -= dot4(Ms + m1, 1, v, d);
    }
    // L_t' x_t = r from the bottom: the rows above pivot j take row j of
    // L_t (consecutive words across the lanes, loaded a step ahead)
    T l0 = Ls[(d - 1) * d + c0], l1 = Ls[(d - 1) * d + c1];
    if (kRows > 1) {
      for (int j = d - 1; j >= kWarp; --j) {
        const T n0l = Ls[(j - 1) * d + c0], n1l = Ls[(j - 1) * d + c1];
        const T xj = __shfl_sync(kFull, r1 * inv1, j - kWarp);
        if (i1 == j)
          r1 = xj;
        else if (i1 < j)
          r1 -= l1 * xj;
        r0 -= l0 * xj;
        l0 = n0l;
        l1 = n1l;
      }
    }
    for (int j = min(d, kWarp) - 1; j >= 0; --j) {
      const T n0l = j > 0 ? Ls[(j - 1) * d + c0] : T(0);
      const T xj = __shfl_sync(kFull, r0 * inv0, j);
      if (i0 == j)
        r0 = xj;
      else if (i0 < j)
        r0 -= l0 * xj;
      l0 = n0l;
    }
    if (h0) vb[(t & 1) * d + i0] = xl[t * d + i0] = r0;
    if (h1) vb[(t & 1) * d + i1] = xl[t * d + i1] = r1;
  }
  __pipeline_wait_prior(0);  // the empty batches past the last step
}

bool shape_ok(int B, int T_, int d) { return B >= 0 && T_ >= 1 && d >= 1 && d <= kMaxD; }

template <typename T, int kMax>
cudaError_t launch_factor_reg(const T* D, const T* O, T* L, T* M, int B, int T_, int d,
                              cudaStream_t stream) {
  // warps a block: B / SMs, at least one (so that every SM has a lane
  // where the batch allows) and at most kMaxFactorWarps
  int want = B / sm_count();
  if (want > kMaxFactorWarps) want = kMaxFactorWarps;
  const int words = factor_reg_words<T>(kMax, d);
  auto kernel = factor_lanes_reg_kernel<T, kMax>;
  int warps;
  size_t smem;
  cudaError_t err = configure(kernel, sizeof(T) * words, &warps, &smem, kMaxSmem, want < 1 ? 1 : want);
  if (err != cudaSuccess) return err;
  const int vec = (sizeof(T) * d * d) % 16 == 0 && aligned16(D) && aligned16(O) && aligned16(L);
  kernel<<<(B + warps - 1) / warps, warps * kWarp, smem, stream>>>(D, O, L, M, B, T_, d, words, vec);
  return cudaGetLastError();
}

// The factor: the register kernel up to d = 32 (width 12, 16 or 32), the
// shared-memory kernel past it.
template <typename T>
int factor_lanes(const void* D, const void* O, void* L, void* M, int B, int T_, int d,
                 void* stream) {
  if (!shape_ok(B, T_, d)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const T* Dp = static_cast<const T*>(D);
  const T* Op = static_cast<const T*>(O);
  T* Lp = static_cast<T*>(L);
  T* Mp = static_cast<T*>(M);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 12) return static_cast<int>(launch_factor_reg<T, 12>(Dp, Op, Lp, Mp, B, T_, d, st));
  if (d <= 16) return static_cast<int>(launch_factor_reg<T, 16>(Dp, Op, Lp, Mp, B, T_, d, st));
  if (d <= kWarp) return static_cast<int>(launch_factor_reg<T, kWarp>(Dp, Op, Lp, Mp, B, T_, d, st));
  int warps;
  size_t smem;
  const size_t per_warp = sizeof(T) * 2 * static_cast<size_t>(d) * (d + 1);
  cudaError_t err = configure(factor_lanes_wide_kernel<T>, per_warp, &warps, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (B + warps - 1) / warps;
  factor_lanes_wide_kernel<T><<<grid, warps * kWarp, smem, st>>>(Dp, Op, Lp, Mp, B, T_, d);
  return static_cast<int>(cudaGetLastError());
}

// The solve: one warp a lane; u stays in shared memory where a warp's
// share fits in a block's limit, and the stage blocks land in 16-byte
// pieces where their size and the arrays' addresses allow it.
template <typename T>
int solve_lanes(const void* L, const void* M, const void* b, void* x, int B, int T_, int d,
                void* stream) {
  if (!shape_ok(B, T_, d)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  constexpr size_t per16 = 16 / sizeof(T);  // words a warp's share is rounded to
  const int rows = d > kWarp ? 2 : 1;
  const size_t base = 2 * static_cast<size_t>(slots_for(rows)) * d * d + 2 * d;
  const size_t with_u = base + static_cast<size_t>(T_) * d;
  const int u_on_chip = sizeof(T) * with_u <= kMaxSmem;
  const size_t words = ((u_on_chip ? with_u : base) + per16 - 1) / per16 * per16;
  const int vec = (sizeof(T) * d * d) % 16 == 0 && aligned16(L) && aligned16(M);
  auto kernel = rows == 2 ? solve_lanes_kernel<T, 2> : solve_lanes_kernel<T, 1>;
  int warps;
  size_t smem;
  cudaError_t err = configure(kernel, sizeof(T) * words, &warps, &smem, kMaxSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (B + warps - 1) / warps;
  kernel<<<grid, warps * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(L), static_cast<const T*>(M), static_cast<const T*>(b),
      static_cast<T*>(x), B, T_, d, static_cast<int>(words), u_on_chip, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int calipso_factor_lanes_f32(const void* D, const void* O, void* L, void* M, int B, int T,
                             int d, void* stream) {
  return factor_lanes<float>(D, O, L, M, B, T, d, stream);
}

int calipso_factor_lanes_f64(const void* D, const void* O, void* L, void* M, int B, int T,
                             int d, void* stream) {
  return factor_lanes<double>(D, O, L, M, B, T, d, stream);
}

int calipso_solve_lanes_f32(const void* L, const void* M, const void* b, void* x, int B,
                            int T, int d, void* stream) {
  return solve_lanes<float>(L, M, b, x, B, T, d, stream);
}

int calipso_solve_lanes_f64(const void* L, const void* M, const void* b, void* x, int B,
                            int T, int d, void* stream) {
  return solve_lanes<double>(L, M, b, x, B, T, d, stream);
}

}  // extern "C"
