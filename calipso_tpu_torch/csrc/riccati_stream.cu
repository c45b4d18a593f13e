// Batched block-tridiagonal Cholesky factor and solve over trajectory
// stages for wide stage blocks (the contact class, d = 54): the linear
// algebra of the riccati KKT backend on its "stream" route.
//
// Replaces the TPU kernels calipso_tpu/ops/pallas_riccati.py
// _factor_stream_kernel (factor_stream here), _solve_fwd_stream_kernel
// (solve_fwd_stream) and _solve_bwd_stream_kernel (solve_bwd_stream). The
// TPU versions put 128 lanes on the vector axis and streamed (d, d, 128)
// stage blocks from HBM through a double-buffered make_async_copy
// pipeline, because the horizon did not fit in VMEM. Here one thread block
// of 256 threads owns one lane and walks its horizon; stage t+1's blocks
// are copied into a second shared-memory buffer with cp.async
// (__pipeline_memcpy_async) while stage t computes, and L_t, M_t, u_t and
// x_t go back to device memory as soon as they are computed. The public
// row-major (B, T, d, d) layout is read and written directly. 1 <= d <= 64,
// T >= 1; the solves take K right-hand sides per lane, b (B, T, d, K), in
// chunks of at most 32 columns (blockIdx.y).
//
// For each lane, with S the symmetric block-tridiagonal matrix of
// diagonal blocks D_t and sub-diagonal blocks O_t:
//   factor:  S_t = D_t - M_{t-1}' M_{t-1},  L_t = chol(S_t),
//            M_t = L_t^{-1} O_t'
//   fwd:     u_t = L_t^{-1} (b_t - M_{t-1}' u_{t-1})      (t = 0..T-1)
//   bwd:     x_t = L_t^{-T} (u_t - M_t x_{t+1})          (t = T-1..0)
// A stage whose S_t is not positive definite (a pivot <= 0 or not finite)
// ends the lane's factorization: the lower triangle of L_t and of every
// later L, and every M from M_t on, are written as NaN, as factor_lanes
// does (the inertia signal the solver reads).
//
// Work inside a stage is spread over the whole block, one
// __syncthreads() per pivot: the Schur update by element of the lower
// triangle, the right-looking Cholesky by element of the trailing
// triangle, the substitutions by (row, column) element. Each pivot step
// applies the pivot's update with the unscaled column (S_ij -= S_ik S_jk /
// S_kk) and scales the previous pivot's column, which no thread reads in
// that step, so a step needs no second barrier.
//
// Bound (H100 SXM: 3.35 TB/s HBM, 67 TFLOP/s float32): at the batched
// quadruped's shape (B=128, T=8, d=54, float32) the factor moves 44.8 MB
// (13.4 us) against 0.54 GFLOP (8.0 us), and the solve of one column moves
// 22.8 MB (6.8 us): memory traffic bounds them in principle. In practice
// the stages and the d pivots of each stage are a chain of dependent
// steps and 128 lanes fill 128 of the 132 SMs with one block each, so the
// chain's latency (about 2d barriers a stage) sets the time. The copy of
// the next stage's blocks runs under the current stage's chain.
//
// Shared memory: the factor holds D and O of two stages (4 d (d+1)
// words: 46.5 KB at d=54 in float32, 93 KB in float64), the solves L and
// M of two stages and two column buffers (4 d (d+1) + 2 Kc (d+1) words).
// Above 48 KB a launch needs the raised dynamic shared-memory limit, set
// before it; a refused launch returns its error.
//
// Plain C interface, loaded with ctypes: every entry point launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxD = 64;
constexpr int kMaxCols = 32;  // right-hand sides per block in the solves
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

// Asynchronous copy of a rows x cols block, element (i, j) from src[i * gs
// + j] in device memory to dst[i * ls + j] in shared memory (or, with
// `transpose`, to dst[j * ls + i]). The caller commits the batch.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, int ls, const T* src, long long gs, int rows,
                                           int cols, bool transpose) {
  for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
    const int i = e / cols, j = e % cols;
    T* to = transpose ? dst + j * ls + i : dst + i * ls + j;
    __pipeline_memcpy_async(to, src + i * gs + j, sizeof(T));
  }
}

// One block per lane. Shared memory: Db[2] (D_t, then S_t and L_t in
// place) and Ob[2] (O_t row-major, i.e. column c of O_t' in row c; the
// substitution turns it in place into M_t with column c in row c, which
// is the carry the next stage's Schur update reads), each d rows of
// ld = d + 1 entries.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    factor_stream_kernel(const T* __restrict__ D, const T* __restrict__ O, T* __restrict__ L,
                         T* __restrict__ M, int T_, int d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = d + 1;
  const int blk = d * ld;
  // slot s of a buffer pair (s = stage parity), by offset: an array of
  // pointers indexed at run time would live in local memory
  T* const Db = reinterpret_cast<T*>(smem_raw);
  T* const Ob = Db + 2 * blk;
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long lane = blockIdx.x;
  const long long dd = static_cast<long long>(d) * d;
  const int nn = d * d;
  const T* Dl = D + lane * T_ * dd;
  const T* Ol = O + lane * (T_ - 1) * dd;
  T* Ll = L + lane * T_ * dd;
  T* Ml = M + lane * (T_ - 1) * dd;

  copy_async(Db, ld, Dl, d, d, d, false);
  if (T_ > 1) copy_async(Ob, ld, Ol, d, d, d, false);
  __pipeline_commit();

  int t = 0;
  bool ok = true;
  for (; t < T_; ++t) {
    const int s = t & 1;
    T* S = Db + s * blk;
    T* R = Ob + s * blk;
    __pipeline_wait_prior(0);
    __syncthreads();  // stage t's blocks have landed, from every thread's copies

    // S_t = D_t - M_{t-1}' M_{t-1}, lower triangle: rows i and j of the
    // carry are columns i and j of M_{t-1}
    if (t > 0) {
      const T* C = Ob + (1 - s) * blk;
      for (int e = tid; e < nn; e += nt) {
        const int i = e / d, j = e % d;
        if (j <= i) {
          T v = S[i * ld + j];
          for (int k = 0; k < d; ++k) v -= C[i * ld + k] * C[j * ld + k];
          S[i * ld + j] = v;
        }
      }
    }
    __syncthreads();  // the carry is consumed: its buffers take stage t+1
    if (t + 1 < T_) {
      copy_async(Db + (1 - s) * blk, ld, Dl + (t + 1) * dd, d, d, d, false);
      if (t + 1 < T_ - 1) copy_async(Ob + (1 - s) * blk, ld, Ol + (t + 1) * dd, d, d, d, false);
    }
    __pipeline_commit();

    // right-looking Cholesky of the lower triangle, in place; every thread
    // reads the same pivot after a barrier, so the failure test (and the
    // break) is uniform over the block
    T prev = T(0);
    for (int k = 0; k < d; ++k) {
      const T pkk = S[k * ld + k];
      if (!(pkk > T(0) && pkk - pkk == T(0))) {  // not positive, or not finite
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

    T* Lt = Ll + t * dd;
    for (int e = tid; e < nn; e += nt) {
      const int i = e / d, j = e % d;
      Lt[e] = j > i ? T(0) : S[i * ld + j];
    }
    if (t < T_ - 1) {
      // M_t = L_t^{-1} O_t' by (column, row) element: pivot j updates the
      // rows below it with the unscaled row j and scales row j - 1
      for (int j = 0; j < d; ++j) {
        const T inv = T(1) / S[j * ld + j];
        for (int e = tid; e < nn; e += nt) {
          const int c = e / d, i = e % d;
          if (i > j)
            R[c * ld + i] -= S[i * ld + j] * R[c * ld + j] * inv;
          else if (i == j - 1)
            R[c * ld + i] /= S[i * ld + i];
        }
        __syncthreads();
      }
      for (int c = tid; c < d; c += nt) R[c * ld + d - 1] /= S[(d - 1) * ld + d - 1];
      __syncthreads();
      T* Mt = Ml + t * dd;
      for (int e = tid; e < nn; e += nt) Mt[e] = R[(e % d) * ld + e / d];
    }
  }

  // a stage that is not positive definite: NaN over the lower triangle of
  // L_t and of every later L, and over every M from M_t on
  if (!ok) {
    const T nan = quiet_nan<T>();
    for (int s = t; s < T_; ++s) {
      T* Ls = Ll + s * dd;
      for (int e = tid; e < nn; e += nt) Ls[e] = (e % d) > (e / d) ? T(0) : nan;
      if (s < T_ - 1) {
        T* Ms = Ml + s * dd;
        for (int e = tid; e < nn; e += nt) Ms[e] = nan;
      }
    }
  }
  __pipeline_wait_prior(0);  // no copy may still be landing when the block exits
}

// Forward sweep, one block per (lane, chunk of <= 32 columns). Shared
// memory: Lb[2] (L_t), Mb[2] (M_{t-1}), each d rows of ld = d + 1, and
// Rb[2], the chunk's columns of b_t with column c in row c (ld entries),
// turned in place into u_t; the previous stage's Rb is the carry u_{t-1}.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    solve_fwd_stream_kernel(const T* __restrict__ L, const T* __restrict__ M,
                            const T* __restrict__ bv, T* __restrict__ u, int T_, int d, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = d + 1;
  const int c0 = blockIdx.y * kMaxCols;
  const int kc = min(kMaxCols, K - c0);
  const int blk = d * ld, rblk = kMaxCols * ld;
  T* const Lb = reinterpret_cast<T*>(smem_raw);  // slots by offset, as in the factor
  T* const Mb = Lb + 2 * blk;
  T* const Rb = Lb + 4 * blk;
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long lane = blockIdx.x;
  const long long dd = static_cast<long long>(d) * d, dk = static_cast<long long>(d) * K;
  const T* Ll = L + lane * T_ * dd;
  const T* Ml = M + lane * (T_ - 1) * dd;
  const T* bl = bv + lane * T_ * dk + c0;
  T* ul = u + lane * T_ * dk + c0;
  const int nr = kc * d;

  copy_async(Lb, ld, Ll, d, d, d, false);
  copy_async(Rb, ld, bl, K, d, kc, true);
  __pipeline_commit();

  for (int t = 0; t < T_; ++t) {
    const int s = t & 1;
    T* Ls = Lb + s * blk;
    T* R = Rb + s * rblk;
    __pipeline_wait_prior(0);
    __syncthreads();

    // r = b_t - M_{t-1}' u_{t-1}
    if (t > 0) {
      const T* Mp = Mb + s * blk;
      const T* U = Rb + (1 - s) * rblk;
      for (int e = tid; e < nr; e += nt) {
        const int c = e / d, i = e % d;
        T v = R[c * ld + i];
        for (int k = 0; k < d; ++k) v -= Mp[k * ld + i] * U[c * ld + k];
        R[c * ld + i] = v;
      }
    }
    __syncthreads();
    if (t + 1 < T_) {
      copy_async(Lb + (1 - s) * blk, ld, Ll + (t + 1) * dd, d, d, d, false);
      copy_async(Mb + (1 - s) * blk, ld, Ml + t * dd, d, d, d, false);
      copy_async(Rb + (1 - s) * rblk, ld, bl + (t + 1) * dk, K, d, kc, true);
    }
    __pipeline_commit();

    // L_t u_t = r: pivot j updates the rows below it and scales row j - 1
    for (int j = 0; j < d; ++j) {
      const T inv = T(1) / Ls[j * ld + j];
      for (int e = tid; e < nr; e += nt) {
        const int c = e / d, i = e % d;
        if (i > j)
          R[c * ld + i] -= Ls[i * ld + j] * R[c * ld + j] * inv;
        else if (i == j - 1)
          R[c * ld + i] /= Ls[i * ld + i];
      }
      __syncthreads();
    }
    for (int c = tid; c < kc; c += nt) R[c * ld + d - 1] /= Ls[(d - 1) * ld + d - 1];
    __syncthreads();
    T* ut = ul + t * dk;
    for (int e = tid; e < nr; e += nt) {
      const int i = e / kc, c = e % kc;
      ut[i * K + c] = R[c * ld + i];
    }
  }
  __pipeline_wait_prior(0);
}

// Backward sweep from u, one block per (lane, chunk of <= 32 columns),
// stages in descending order; the same buffers as the forward sweep with
// Mb holding M_t, and the previous (later) stage's Rb the carry x_{t+1}.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    solve_bwd_stream_kernel(const T* __restrict__ L, const T* __restrict__ M,
                            const T* __restrict__ u, T* __restrict__ x, int T_, int d, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = d + 1;
  const int c0 = blockIdx.y * kMaxCols;
  const int kc = min(kMaxCols, K - c0);
  const int blk = d * ld, rblk = kMaxCols * ld;
  T* const Lb = reinterpret_cast<T*>(smem_raw);  // slots by offset, as in the factor
  T* const Mb = Lb + 2 * blk;
  T* const Rb = Lb + 4 * blk;
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long lane = blockIdx.x;
  const long long dd = static_cast<long long>(d) * d, dk = static_cast<long long>(d) * K;
  const T* Ll = L + lane * T_ * dd;
  const T* Ml = M + lane * (T_ - 1) * dd;
  const T* ulane = u + lane * T_ * dk + c0;
  T* xl = x + lane * T_ * dk + c0;
  const int nr = kc * d;

  copy_async(Lb, ld, Ll + (T_ - 1) * dd, d, d, d, false);
  copy_async(Rb, ld, ulane + (T_ - 1) * dk, K, d, kc, true);
  __pipeline_commit();

  for (int it = 0; it < T_; ++it) {
    const int t = T_ - 1 - it;
    const int s = it & 1;
    T* Ls = Lb + s * blk;
    T* R = Rb + s * rblk;
    __pipeline_wait_prior(0);
    __syncthreads();

    // r = u_t - M_t x_{t+1}
    if (t < T_ - 1) {
      const T* Mt = Mb + s * blk;
      const T* X = Rb + (1 - s) * rblk;
      for (int e = tid; e < nr; e += nt) {
        const int c = e / d, i = e % d;
        T v = R[c * ld + i];
        for (int k = 0; k < d; ++k) v -= Mt[i * ld + k] * X[c * ld + k];
        R[c * ld + i] = v;
      }
    }
    __syncthreads();
    if (t > 0) {
      copy_async(Lb + (1 - s) * blk, ld, Ll + (t - 1) * dd, d, d, d, false);
      copy_async(Mb + (1 - s) * blk, ld, Ml + (t - 1) * dd, d, d, d, false);
      copy_async(Rb + (1 - s) * rblk, ld, ulane + (t - 1) * dk, K, d, kc, true);
    }
    __pipeline_commit();

    // L_t' x_t = r from the bottom: pivot j updates the rows above it and
    // scales row j + 1
    for (int j = d - 1; j >= 0; --j) {
      const T inv = T(1) / Ls[j * ld + j];
      for (int e = tid; e < nr; e += nt) {
        const int c = e / d, i = e % d;
        if (i < j)
          R[c * ld + i] -= Ls[j * ld + i] * R[c * ld + j] * inv;
        else if (i == j + 1)
          R[c * ld + i] /= Ls[i * ld + i];
      }
      __syncthreads();
    }
    for (int c = tid; c < kc; c += nt) R[c * ld] /= Ls[0];
    __syncthreads();
    T* xt = xl + t * dk;
    for (int e = tid; e < nr; e += nt) {
      const int i = e / kc, c = e % kc;
      xt[i * K + c] = R[c * ld + i];
    }
  }
  __pipeline_wait_prior(0);
}

bool shape_ok(int B, int T_, int d, int K) {
  return B >= 0 && T_ >= 1 && d >= 1 && d <= kMaxD && K >= 1;
}

// Raise the kernel's dynamic shared-memory limit when it needs more than
// the default 48 KB.
template <typename Kern>
cudaError_t allow_smem(Kern kernel, size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T>
int factor_stream(const void* D, const void* O, void* L, void* M, int B, int T_, int d,
                  void* stream) {
  if (!shape_ok(B, T_, d, 1)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = sizeof(T) * 4 * static_cast<size_t>(d) * (d + 1);
  cudaError_t err = allow_smem(factor_stream_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  factor_stream_kernel<T><<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(D), static_cast<const T*>(O), static_cast<T*>(L),
      static_cast<T*>(M), T_, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename Kern>
int solve_sweep(Kern kernel, const void* L, const void* M, const void* in, void* out, int B,
                int T_, int d, int K, void* stream) {
  if (!shape_ok(B, T_, d, K)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = sizeof(T) * (4 * static_cast<size_t>(d) + 2 * kMaxCols) * (d + 1);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B, (K + kMaxCols - 1) / kMaxCols);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(L), static_cast<const T*>(M), static_cast<const T*>(in),
      static_cast<T*>(out), T_, d, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int calipso_factor_stream_f32(const void* D, const void* O, void* L, void* M, int B, int T,
                              int d, void* stream) {
  return factor_stream<float>(D, O, L, M, B, T, d, stream);
}

int calipso_factor_stream_f64(const void* D, const void* O, void* L, void* M, int B, int T,
                              int d, void* stream) {
  return factor_stream<double>(D, O, L, M, B, T, d, stream);
}

int calipso_solve_fwd_stream_f32(const void* L, const void* M, const void* b, void* u, int B,
                                 int T, int d, int K, void* stream) {
  return solve_sweep<float>(solve_fwd_stream_kernel<float>, L, M, b, u, B, T, d, K, stream);
}

int calipso_solve_fwd_stream_f64(const void* L, const void* M, const void* b, void* u, int B,
                                 int T, int d, int K, void* stream) {
  return solve_sweep<double>(solve_fwd_stream_kernel<double>, L, M, b, u, B, T, d, K, stream);
}

int calipso_solve_bwd_stream_f32(const void* L, const void* M, const void* u, void* x, int B,
                                 int T, int d, int K, void* stream) {
  return solve_sweep<float>(solve_bwd_stream_kernel<float>, L, M, u, x, B, T, d, K, stream);
}

int calipso_solve_bwd_stream_f64(const void* L, const void* M, const void* u, void* x, int B,
                                 int T, int d, int K, void* stream) {
  return solve_sweep<double>(solve_bwd_stream_kernel<double>, L, M, u, x, B, T, d, K, stream);
}

}  // extern "C"
