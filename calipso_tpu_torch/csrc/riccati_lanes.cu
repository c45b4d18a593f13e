// Batched block-tridiagonal Cholesky factor and solve over trajectory
// stages: the whole linear algebra of the riccati KKT backend.
//
// Replaces the TPU kernels calipso_tpu/ops/pallas_riccati.py
// _factor_lanes_kernel (factor_lanes here) and _solve_lanes_kernel
// (solve_lanes here). The TPU versions put the batch on the 128-wide
// lane axis, held the whole horizon (T, d, d, Bt) in VMEM and wrote a
// transposed factor that their wrapper un-transposed. Here one warp owns
// one lane (one problem), walks its horizon in a loop, keeps one stage's
// working set in shared memory (O(d^2) per warp, not O(T d^2), padded
// rows against bank conflicts), and reads and writes the public
// row-major (B, T, d, d) layout directly. 1 <= d <= 64, T >= 1.
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
// (0.8 us), and the solve moves 18.0 MB (5.4 us): both are
// bound by memory traffic in principle. In practice the T stages and the
// d pivots of each stage are a chain of dependent steps, so at small d
// the kernels are latency-bound: the design keeps every step inside one
// warp (no block barriers, __syncwarp only), spreads the O(d^2) and
// O(d^3) parts of each step over the warp's 32 threads, and runs many
// lanes per SM to hide the latency of the chain.
//
// Plain C interface, loaded with ctypes: every entry point launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxD = 64;
constexpr int kRowsPerLane = kMaxD / kWarp;  // rows of a stage vector each thread owns
constexpr int kMaxWarpsPerBlock = 8;
constexpr size_t kDefaultSmem = 48 * 1024;
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

// The value of row j of a stage vector whose rows are spread over the
// warp (thread j % 32 holds it in slot j / 32), broadcast to every thread
// after `scale` is applied by its owner.
template <typename T>
__device__ __forceinline__ T owner_value(const T (&r)[kRowsPerLane], int j, T scale) {
  T rj = r[0];
#pragma unroll
  for (int q = 1; q < kRowsPerLane; ++q)
    if (j / kWarp == q) rj = r[q];
  return __shfl_sync(kFull, rj / scale, j % kWarp);
}

// One warp per lane. Thread `lane` owns rows lane and lane + 32 of each
// stage vector, in registers. Shared memory per warp: L_t and M (d rows
// of ld = d + 1 entries each) and v, the neighbouring stage's solution.
// The forward sweep keeps u_t in the output buffer; the backward sweep
// reads it back and overwrites it with x_t.
template <typename T>
__global__ void solve_lanes_kernel(const T* __restrict__ L, const T* __restrict__ M,
                                   const T* __restrict__ bv, T* __restrict__ x, int B,
                                   int T_, int d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int ld = d + 1;
  T* Ls = reinterpret_cast<T*>(smem_raw) + static_cast<size_t>(warp) * (2 * d * ld + d);
  T* Ms = Ls + d * ld;
  T* v = Ms + d * ld;
  const long long b = static_cast<long long>(blockIdx.x) * warps + warp;
  if (b >= B) return;
  const long long dd = static_cast<long long>(d) * d;
  const int nn = d * d;
  const T* Lb = L + b * T_ * dd;
  const T* Mb = M + b * (T_ - 1) * dd;
  const T* bb = bv + b * T_ * d;
  T* xb = x + b * T_ * d;
  T r[kRowsPerLane];

  // forward: u_t = L_t^{-1} (b_t - M_{t-1}' u_{t-1}), column sweep
  for (int t = 0; t < T_; ++t) {
    const T* Lt = Lb + t * dd;
    for (int e = lane; e < nn; e += kWarp) Ls[(e / d) * ld + e % d] = Lt[e];
    if (t > 0) {
      const T* Mt = Mb + (t - 1) * dd;
      for (int e = lane; e < nn; e += kWarp) Ms[(e / d) * ld + e % d] = Mt[e];
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < kRowsPerLane; ++q) {
      const int i = lane + q * kWarp;
      T ri = T(0);
      if (i < d) {
        ri = bb[t * d + i];
        if (t > 0)
          for (int k = 0; k < d; ++k) ri -= Ms[k * ld + i] * v[k];
      }
      r[q] = ri;
    }
    for (int j = 0; j < d; ++j) {
      const T uj = owner_value(r, j, Ls[j * ld + j]);
#pragma unroll
      for (int q = 0; q < kRowsPerLane; ++q) {
        const int i = lane + q * kWarp;
        if (i == j)
          r[q] = uj;
        else if (i > j && i < d)
          r[q] -= Ls[i * ld + j] * uj;
      }
    }
    __syncwarp();  // every thread has read v and Ls before they are rewritten
#pragma unroll
    for (int q = 0; q < kRowsPerLane; ++q) {
      const int i = lane + q * kWarp;
      if (i < d) {
        v[i] = r[q];
        xb[t * d + i] = r[q];
      }
    }
    __syncwarp();
  }

  // backward: x_t = L_t^{-T} (u_t - M_t x_{t+1}), row sweep from the bottom
  for (int t = T_ - 1; t >= 0; --t) {
    const T* Lt = Lb + t * dd;
    for (int e = lane; e < nn; e += kWarp) Ls[(e / d) * ld + e % d] = Lt[e];
    if (t < T_ - 1) {
      const T* Mt = Mb + t * dd;
      for (int e = lane; e < nn; e += kWarp) Ms[(e / d) * ld + e % d] = Mt[e];
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < kRowsPerLane; ++q) {
      const int i = lane + q * kWarp;
      T ri = T(0);
      if (i < d) {
        ri = xb[t * d + i];  // u_t, written by this thread in the forward sweep
        if (t < T_ - 1)
          for (int k = 0; k < d; ++k) ri -= Ms[i * ld + k] * v[k];
      }
      r[q] = ri;
    }
    for (int j = d - 1; j >= 0; --j) {
      const T xj = owner_value(r, j, Ls[j * ld + j]);
#pragma unroll
      for (int q = 0; q < kRowsPerLane; ++q) {
        const int i = lane + q * kWarp;
        if (i == j)
          r[q] = xj;
        else if (i < j)
          r[q] -= Ls[j * ld + i] * xj;
      }
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < kRowsPerLane; ++q) {
      const int i = lane + q * kWarp;
      if (i < d) {
        v[i] = r[q];
        xb[t * d + i] = r[q];
      }
    }
    __syncwarp();
  }
}

// Warps per block so that a block's shared memory stays within the
// default 48 KB where it can; a larger stage runs one warp per block
// with the opt-in shared-memory limit raised for that kernel.
template <typename K>
cudaError_t configure(K kernel, size_t per_warp, int* warps, size_t* smem) {
  size_t w = kDefaultSmem / per_warp;
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

template <typename T>
int solve_lanes(const void* L, const void* M, const void* b, void* x, int B, int T_, int d,
                void* stream) {
  if (!shape_ok(B, T_, d)) return static_cast<int>(cudaErrorInvalidValue);
  int warps;
  size_t smem;
  const size_t per_warp = sizeof(T) * (2 * static_cast<size_t>(d) * (d + 1) + d);
  cudaError_t err = configure(solve_lanes_kernel<T>, per_warp, &warps, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (B + warps - 1) / warps;
  solve_lanes_kernel<T><<<grid, warps * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(L), static_cast<const T*>(M), static_cast<const T*>(b),
      static_cast<T*>(x), B, T_, d);
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
