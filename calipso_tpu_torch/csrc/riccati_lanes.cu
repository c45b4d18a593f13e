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
// The factor keeps one stage's working set in shared memory (O(d^2) per
// warp, not O(T d^2), padded rows against bank conflicts).
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

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxD = 64;
constexpr int kMaxWarpsPerBlock = 8;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;  // a block's opt-in limit on Hopper
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T quiet_nan();
template <>
__device__ __forceinline__ float quiet_nan<float>() {
  return __int_as_float(0x7fc00000);
}
template <>
__device__ __forceinline__ double quiet_nan<double>() {
  return __longlong_as_double(0x7ff8000000000000ULL);
}

// One warp per lane. Shared memory per warp: S (the stage's Schur block,
// factored in place) and Mb (M_{t-1} while S_t is formed, then M_t),
// each d rows of ld = d + 1 entries.
template <typename T>
__global__ void factor_lanes_kernel(const T* __restrict__ D, const T* __restrict__ O,
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

// Asynchronous copy of n contiguous elements from device to shared memory
// by one warp, in 16-byte pieces when `vec` (both addresses 16-byte
// aligned, n sizeof(T) a multiple of 16), else element by element. The
// caller commits the batch.
template <typename T>
__device__ __forceinline__ void warp_copy_async(T* dst, const T* src, int n, bool vec, int lane) {
  if (vec) {
    constexpr int per = 16 / sizeof(T);
    for (int e = lane; e * per < n; e += kWarp) __pipeline_memcpy_async(dst + e * per, src + e * per, 16);
  } else {
    for (int e = lane; e < n; e += kWarp) __pipeline_memcpy_async(dst + e, src + e, sizeof(T));
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

// Warps per block so that a block's shared memory stays within `budget`
// (the default 48 KB unless given) where it can; a larger share runs one
// warp per block. Above 48 KB the kernel's opt-in shared-memory limit is
// raised.
template <typename K>
cudaError_t configure(K kernel, size_t per_warp, int* warps, size_t* smem,
                      size_t budget = kDefaultSmem) {
  size_t w = budget / per_warp;
  if (w > kMaxWarpsPerBlock) w = kMaxWarpsPerBlock;
  if (w < 1) w = 1;
  *warps = static_cast<int>(w);
  *smem = per_warp * w;
  if (*smem > kDefaultSmem)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(*smem));
  return cudaSuccess;
}

bool shape_ok(int B, int T_, int d) { return B >= 0 && T_ >= 1 && d >= 1 && d <= kMaxD; }

bool aligned16(const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; }

template <typename T>
int factor_lanes(const void* D, const void* O, void* L, void* M, int B, int T_, int d,
                 void* stream) {
  if (!shape_ok(B, T_, d)) return static_cast<int>(cudaErrorInvalidValue);
  int warps;
  size_t smem;
  const size_t per_warp = sizeof(T) * 2 * static_cast<size_t>(d) * (d + 1);
  cudaError_t err = configure(factor_lanes_kernel<T>, per_warp, &warps, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (B + warps - 1) / warps;
  factor_lanes_kernel<T><<<grid, warps * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(D), static_cast<const T*>(O), static_cast<T*>(L),
      static_cast<T*>(M), B, T_, d);
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
