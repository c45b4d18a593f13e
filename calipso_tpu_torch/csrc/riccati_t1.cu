// Batched dense Cholesky factor and L L^T substitution for small n:
// the T=1 case of the block-tridiagonal Riccati factorization, which is
// the whole linear algebra of the schur KKT backend.
//
// Replaces the TPU kernels calipso_tpu/ops/pallas_riccati.py
// _factor_lanes_t1_kernel and _solve_lanes_t1_kernel. The TPU versions put
// the batch on the 128-lane vector axis and emitted a transposed factor;
// here one warp owns one matrix, stages it in shared memory, and reads
// and writes the public row-major (B, n, n) layout directly.
//
// Bound: per factorization 2*n^2 elements are read and written and
// n^3/3 flops are done, so at n=32 the kernel is memory- and
// latency-bound (about 2.7 flops per byte in float32). The pivot chain is
// sequential, so each warp spends most of its time on the n dependent
// pivot steps; several warps per block and several blocks per SM hide
// that latency.
//
// Plain C interface, loaded with ctypes: every entry point launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarpsPerBlock = 8;
constexpr size_t kDefaultSmem = 48 * 1024;

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

// First row >= start that `lane` owns (a lane owns the rows i with
// i % 32 == lane).
__device__ __forceinline__ int first_row(int lane, int start) {
  return start + ((lane - start) % kWarp + kWarp) % kWarp;
}

// One warp per matrix. For each pivot k the owner lane takes sqrt(S_kk)
// and a shuffle broadcasts it; each lane scales its rows of column k and
// applies the rank-1 update to its rows of the lower trailing block. A
// pivot that is <= 0 or not finite marks the matrix as not positive
// definite: its whole lower triangle is written as NaN (the inertia
// signal the solver reads). The strict upper triangle is always 0.
template <typename T>
__global__ void factor_t1_kernel(const T* __restrict__ S, T* __restrict__ L,
                                 int B, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int ld = n + 1;  // padded rows: a column walk hits distinct banks
  T* A = reinterpret_cast<T*>(smem_raw) + static_cast<size_t>(warp) * n * ld;
  const long long b = static_cast<long long>(blockIdx.x) * warps + warp;
  if (b >= B) return;  // ragged batch edge; the kernel has no block barrier
  const long long nn = static_cast<long long>(n) * n;
  const T* src = S + b * nn;
  for (int e = lane; e < n * n; e += kWarp) A[(e / n) * ld + e % n] = src[e];
  __syncwarp();

  bool bad = false;
  for (int k = 0; k < n; ++k) {
    const int owner = k % kWarp;
    T piv = T(0);
    int ok = 0;
    if (lane == owner) {
      const T d = A[k * ld + k];
      ok = (d > T(0)) && (d - d == T(0));  // positive and finite
      piv = ok ? sqrt(d) : T(0);
    }
    ok = __shfl_sync(0xffffffffu, ok, owner);
    piv = __shfl_sync(0xffffffffu, piv, owner);
    if (!ok) {
      bad = true;
      break;
    }
    if (lane == owner) A[k * ld + k] = piv;
    for (int i = first_row(lane, k + 1); i < n; i += kWarp) A[i * ld + k] /= piv;
    __syncwarp();
    for (int i = first_row(lane, k + 1); i < n; i += kWarp) {
      const T lik = A[i * ld + k];
      for (int j = k + 1; j <= i; ++j) A[i * ld + j] -= lik * A[j * ld + k];
    }
    __syncwarp();
  }

  T* dst = L + b * nn;
  const T nan = quiet_nan<T>();
  for (int e = lane; e < n * n; e += kWarp) {
    const int i = e / n, j = e % n;
    dst[e] = j > i ? T(0) : (bad ? nan : A[i * ld + j]);
  }
}

// One warp per system L L^T x = b: forward substitution L u = b by
// columns, then backward substitution L^T x = u, with L and x in shared
// memory and the same row ownership as factor_t1_kernel.
template <typename T>
__global__ void solve_t1_kernel(const T* __restrict__ Lg, const T* __restrict__ bg,
                                T* __restrict__ xg, int B, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int ld = n + 1;
  T* A = reinterpret_cast<T*>(smem_raw) + static_cast<size_t>(warp) * (n * ld + n);
  T* x = A + n * ld;
  const long long b = static_cast<long long>(blockIdx.x) * warps + warp;
  if (b >= B) return;
  const long long nn = static_cast<long long>(n) * n;
  const T* src = Lg + b * nn;
  for (int e = lane; e < n * n; e += kWarp) A[(e / n) * ld + e % n] = src[e];
  for (int i = lane; i < n; i += kWarp) x[i] = bg[b * n + i];
  __syncwarp();

  for (int j = 0; j < n; ++j) {
    const T xj = x[j] / A[j * ld + j];
    __syncwarp();  // every lane has read x[j] before its owner rewrites it
    if (lane == j % kWarp) x[j] = xj;
    for (int i = first_row(lane, j + 1); i < n; i += kWarp) x[i] -= A[i * ld + j] * xj;
    __syncwarp();
  }
  for (int j = n - 1; j >= 0; --j) {
    const T xj = x[j] / A[j * ld + j];
    __syncwarp();
    if (lane == j % kWarp) x[j] = xj;
    for (int i = lane; i < j; i += kWarp) x[i] -= A[j * ld + i] * xj;
    __syncwarp();
  }
  for (int i = lane; i < n; i += kWarp) xg[b * n + i] = x[i];
}

// Warps per block so that a block's shared memory stays within the
// default 48 KB where it can; a larger matrix runs one warp per block
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

template <typename T>
int factor_t1(const void* S, void* L, int B, int n, void* stream) {
  int warps;
  size_t smem;
  const size_t per_warp = sizeof(T) * static_cast<size_t>(n) * (n + 1);
  cudaError_t err = configure(factor_t1_kernel<T>, per_warp, &warps, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (B + warps - 1) / warps;
  factor_t1_kernel<T><<<grid, warps * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(S), static_cast<T*>(L), B, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int solve_t1(const void* L, const void* b, void* x, int B, int n, void* stream) {
  int warps;
  size_t smem;
  const size_t per_warp = sizeof(T) * (static_cast<size_t>(n) * (n + 1) + n);
  cudaError_t err = configure(solve_t1_kernel<T>, per_warp, &warps, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (B + warps - 1) / warps;
  solve_t1_kernel<T><<<grid, warps * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(L), static_cast<const T*>(b), static_cast<T*>(x), B, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int calipso_factor_t1_f32(const void* S, void* L, int B, int n, void* stream) {
  return factor_t1<float>(S, L, B, n, stream);
}

int calipso_factor_t1_f64(const void* S, void* L, int B, int n, void* stream) {
  return factor_t1<double>(S, L, B, n, stream);
}

int calipso_solve_t1_f32(const void* L, const void* b, void* x, int B, int n,
                         void* stream) {
  return solve_t1<float>(L, b, x, B, n, stream);
}

int calipso_solve_t1_f64(const void* L, const void* b, void* x, int B, int n,
                         void* stream) {
  return solve_t1<double>(L, b, x, B, n, stream);
}

}  // extern "C"
