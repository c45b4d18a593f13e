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
// fused (kernel 8): the TPU ran one grid program per scenario with the
// horizon's L, M and u in VMEM scratch. Here one thread block owns one
// lane and walks its horizon; every L_t and M_t stays in shared memory
// where the whole horizon fits ((2T - 1) d (d+1) words plus two vectors:
// 22 KB at the batched rocket's T=31, d=9 in float32, 178 KB at the
// quadruped's T=8, d=54, above 48 KB only with the raised dynamic
// shared-memory limit). Then D, O and b are read once and x written once,
// which is the point of fusing. Where the horizon does not fit (the
// quadruped's shape in float64), L and M go to a workspace in device
// memory that the caller allocates (calipso_solve_batched_fused_workspace
// says how many words a lane needs). Inside a stage the work is spread
// over the block with one __syncthreads() per pivot, as in
// riccati_stream.cu: a pivot step updates with the unscaled column and
// scales the previous pivot's column, which no thread reads in that step.
// M_t and u_t come out of one substitution, u_t as the (d+1)-th column.
//
// lanes (kernel 9): the TPU put the batch on the 128-wide lane axis,
// (T, d, d, B) blocks, and ran every scenario's sequence in lockstep on
// the vector unit. Here one thread owns one scenario and runs the
// sequence alone; the batch stays the fastest axis of every array, so
// neighbouring threads read and write neighbouring words and every access
// coalesces. The caller hands in its own transposed copies, D (T, d, d,
// B), O' (T-1, d, d, B) with O'_t = O_t' and b (T, d, B); the kernel turns
// D_t into L_t and O'_t into M_t in place and keeps u_t in x (T, d, B).
//
// Bound (H100 SXM: 3.35 TB/s HBM, 67 TFLOP/s float32; D read as its lower
// triangles): at the batched rocket's shape (B=1024, T=31, d=9, float32)
// the solve moves 18.0 MB (5.4 us) against 70 MFLOP (1.0 us), at the
// quadruped's (B=128, T=8, d=54) 17.0 MB (5.1 us) against 0.35 GFLOP
// (5.3 us): bound by memory traffic at the first and by operations at the
// second, in principle. In practice the stages and the pivots of a stage are a chain
// of dependent steps: the fused kernel's ~2d barriers a stage, the lanes
// kernel's d^3 dependent loads a stage from one thread, at a few warps
// for the whole card. Both are latency-bound by design; speed is for
// later work.
//
// Plain C interface, loaded with ctypes: every entry point launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;  // fused: threads per block
constexpr int kLanesThreads = 32;  // lanes: one warp per block, so lanes spread over SMs
constexpr int kMaxD = 64;
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

template <typename T>
__device__ __forceinline__ bool pivot_ok(T p) {
  return p > T(0) && p - p == T(0);  // positive and finite
}

// One block per lane. Lf[t] (t < T) holds S_t, factored in place into
// L_t; Mf[t] (t < T-1) holds O_t row-major, i.e. column c of O_t' in row
// c, turned in place into M_t with column c in row c (the carry the next
// stage's Schur update reads); each d rows of ld = d + 1. Both live in
// shared memory when `work` is null, else in the lane's part of `work`.
// Shared memory always holds v (the carry: u_{t-1} forward, x_{t+1}
// backward) and r (the stage's right-hand side); u_t waits in x.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    solve_batched_fused_kernel(const T* __restrict__ D, const T* __restrict__ O,
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

// Shared memory of the fused kernel with the horizon resident, in bytes.
template <typename T>
size_t resident_smem(int T_, int d) {
  const size_t ld = static_cast<size_t>(d) + 1;
  return sizeof(T) * (2 * ld + (2 * static_cast<size_t>(T_) - 1) * d * ld);
}

// Words of device-memory workspace a lane needs: 0 when the horizon fits
// in the current device's shared memory, else (2T - 1) d (d + 1).
template <typename T>
int fused_workspace(int T_, int d) {
  if (!shape_ok(0, T_, d)) return -static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (resident_smem<T>(T_, d) <= static_cast<size_t>(optin)) return 0;
  return (2 * T_ - 1) * d * (d + 1);
}

template <typename T>
int solve_batched_fused(const void* D, const void* O, const void* b, void* x, void* work, int B,
                        int T_, int d, void* stream) {
  if (!shape_ok(B, T_, d)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const size_t smem =
      work == nullptr ? resident_smem<T>(T_, d) : sizeof(T) * 2 * (static_cast<size_t>(d) + 1);
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(solve_batched_fused_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int threads = (d * d + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  solve_batched_fused_kernel<T><<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(D), static_cast<const T*>(O), static_cast<const T*>(b),
      static_cast<T*>(x), static_cast<T*>(work), T_, d);
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
