// Batched dense Cholesky factor and L L^T substitution for small n:
// the T=1 case of the block-tridiagonal Riccati factorization, which is
// the whole linear algebra of the schur KKT backend.
//
// Replaces the TPU kernels calipso_tpu/ops/pallas_riccati.py
// _factor_lanes_t1_kernel and _solve_lanes_t1_kernel. The TPU versions put
// the batch on the 128-lane vector axis and emitted a transposed factor;
// here one warp owns one matrix and reads and writes the public row-major
// (B, n, n) layout directly.
//
// Bound: the factor reads S's lower triangle and writes L whole (its
// upper zeros too, which the contract writes), 22.2 MB at the flagship's
// B=8192, n=32 in float32 (15.2 us at 3.35 TB/s), against n^3/3 flops a
// matrix (89 MFLOP); the solve reads L's lower triangle and b and writes
// x, 19.4 MB (5.8 us) against 4.2 MFLOP. Both are bound by memory traffic
// in principle and by the chain of n dependent pivot steps in practice,
// which the designs below keep free of barriers, divisions and
// shared-memory round trips.
//
// Both kernels for n <= 32 (the flagship's n = 32) are a warp a system,
// thread i owning row i in registers (riccati_reg.cuh), on a grid of as
// many warps as are resident at once (4 a block), each walking the
// systems b, b + stride, ... with the next system's lower triangle in
// flight into the other of two shared-memory slots, so that a batch of
// 8192 does not end on a part-full second wave. The copy (copy_lower)
// takes only the 16-byte pieces of each row that hold columns <= the row
// (576 of 1024 words at n = 32; element by element where n sizeof(T) or
// the address is not a multiple of 16), at a row stride of n rounded up
// to 16 bytes plus 16 bytes (36 words at n = 32 in float32), so that
// 16-byte row accesses by a quarter warp and column reads by the warp hit
// distinct banks. Threads past n hold rows of the identity, so every loop
// runs to 32 with no branch. No integer division runs in any loop.
//
// factor_t1 (factor_t1_reg_kernel): thread i reads its row's copied
// pieces into registers. At pivot k the diagonal comes by one shuffle
// from thread k; every thread takes the same correctly rounded sqrt and
// one reciprocal, scales its s_ik and takes each l_jk (j > k) by one
// shuffle from thread j for s_ij -= s_ik l_jk (panel_pivots): n(n-1)/2 =
// 496 shuffles a matrix at n = 32, independent within a pivot, with no
// barrier and no division on the chain. All 32 pivots run, the identity
// rows' too: a pivot loop that stops at n puts a branch between pivots,
// which keeps ptxas from overlapping one pivot's tail with the next one's
// head (0.0542 against 0.0488 ms in float32, 0.1047 against 0.0797 in
// float64 at (8192, 32) on an H100). The failure test (a pivot not
// positive, or not finite) is warp-uniform and read after the loop. L
// goes out through the system's own slot: each thread writes its row
// (upper zeros, or NaN over the lower triangle of a matrix that is not
// positive definite) in 16-byte pieces, then the warp stores the slot
// flat, in 16-byte pieces where n sizeof(T) and L's address allow it (at
// n = 32 a row is one 128-byte line), else element by element.
//
// solve_t1 (solve_t1_reg_kernel): each thread takes 1 / L_ii once, off
// the chain. The forward sweep runs from registers: thread i reads its
// row into them in 16-byte pieces, and each pivot is one multiply, one
// __shfl_sync of u_j and one FMA (a select keeps the rows it does not
// touch). The backward sweep runs the same way on column i of L, L[j][i]
// for j > i (consecutive words of row j across the warp), read into the
// same registers before its first step. b is read into a register and x
// written from one.
//
// n in 33..128 keeps the first kernels (factor_t1_wide_kernel,
// solve_t1_wide_kernel): the system in padded shared memory, staged whole,
// a division and two __syncwarp a pivot, one warp a system on a grid of
// ceil(B / warps) blocks.
//
// Plain C interface, loaded with ctypes: every entry point launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include "riccati_reg.cuh"

namespace {

constexpr int kT1Warps = 4;  // warps a block of the register kernels
constexpr int kMaxN = 128;   // the widest system the T=1 kernels take

// First row >= start that `lane` owns (a lane owns the rows i with
// i % 32 == lane).
__device__ __forceinline__ int first_row(int lane, int start) {
  return start + ((lane - start) % kWarp + kWarp) % kWarp;
}

// factor_t1 for n in 33..128 (the first design): one warp per matrix. For
// each pivot k the owner lane takes sqrt(S_kk) and a shuffle broadcasts
// it; each lane scales its rows of column k and applies the rank-1 update
// to its rows of the lower trailing block. A pivot that is <= 0 or not
// finite marks the matrix as not positive definite: its whole lower
// triangle is written as NaN (the inertia signal the solver reads). The
// strict upper triangle is always 0.
template <typename T>
__global__ void factor_t1_wide_kernel(const T* __restrict__ S, T* __restrict__ L,
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

// 16 bytes of shared memory at p into r[j..] where `in`, else zeros
template <int N>
__device__ __forceinline__ void load16(const float* p, float (&r)[N], int j, bool in) {
  const float4 v = in ? *reinterpret_cast<const float4*>(p) : make_float4(0.f, 0.f, 0.f, 0.f);
  r[j] = v.x, r[j + 1] = v.y, r[j + 2] = v.z, r[j + 3] = v.w;
}
template <int N>
__device__ __forceinline__ void load16(const double* p, double (&r)[N], int j, bool in) {
  const double2 v = in ? *reinterpret_cast<const double2*>(p) : make_double2(0.0, 0.0);
  r[j] = v.x, r[j + 1] = v.y;
}

// The lower triangle of the n x n row-major L at src into dst at row
// stride ld, by one warp's cp.async: in `vec` (n sizeof(T) a multiple of
// 16, src 16-byte aligned) the 16-byte pieces that hold a column <= their
// row, kWarp / (kMaxN / per) rows at a time, else element by element, a
// row at a time. The caller commits the batch.
template <typename T, int kMaxN>
__device__ __forceinline__ void copy_lower(T* dst, const T* src, int n, int ld, bool vec, int lane) {
  if (vec) {
    constexpr int per = 16 / sizeof(T);
    constexpr int pieces = kMaxN / per;  // of a row of kMaxN
    constexpr int rows = kWarp / pieces;
    const int pc = (lane % pieces) * per;
    for (int r = lane / pieces; r < n; r += rows)
      if (pc <= r) __pipeline_memcpy_async(dst + r * ld + pc, src + r * n + pc, 16);
  } else {
    for (int r = 0; r < n; ++r)
      if (lane <= r) __pipeline_memcpy_async(dst + r * ld + lane, src + r * n + lane, sizeof(T));
  }
}

// 16 bytes at p (16-byte aligned) from r[j..]
template <int N>
__device__ __forceinline__ void store16(float* p, const float (&r)[N], int j) {
  *reinterpret_cast<float4*>(p) = make_float4(r[j], r[j + 1], r[j + 2], r[j + 3]);
}
template <int N>
__device__ __forceinline__ void store16(double* p, const double (&r)[N], int j) {
  *reinterpret_cast<double2*>(p) = make_double2(r[j], r[j + 1]);
}

// factor_t1 for n <= kMaxN = 32 (see the file comment). Shared memory per
// warp: two slots of slot_words (n rows of ld words: n rounded up to 16
// bytes, plus 16 bytes); system number k of this warp in slot k & 1, which
// also takes its L on the way out. In float32, 5 blocks an SM cap ptxas
// at 102 registers (it takes 80), so that 6 fit by shared memory where
// the uncapped kernel took 145 registers and 3 blocks; float64 takes 158
// uncapped (3 blocks, what its shared memory allows).
template <typename T, int kMaxN>
__global__ void __launch_bounds__(kT1Warps * kWarp, sizeof(T) == 4 ? 5 : 1)
    factor_t1_reg_kernel(const T* __restrict__ Sg, T* __restrict__ Lg, int B, int n, int slot_words, int vec) {
  constexpr int per = 16 / sizeof(T);
  constexpr int pieces = kMaxN / per;    // 16-byte pieces of a row of kMaxN
  constexpr int rows = kWarp / pieces;   // rows the warp stores at once
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ld = round16<T>(n) + per;  // 16-byte rows
  T* const slots = reinterpret_cast<T*>(smem_raw) + static_cast<size_t>(warp) * 2 * slot_words;
  const long long stride = static_cast<long long>(gridDim.x) * warps;
  long long b = static_cast<long long>(blockIdx.x) * warps + warp;
  if (b >= B) return;  // ragged batch edge; the kernel has no block barrier
  const long long nn = static_cast<long long>(n) * n;
  const bool own = lane < n;
  const T nan = quiet_nan<T>();
  copy_lower<T, kMaxN>(slots, Sg + b * nn, n, ld, vec, lane);
  __pipeline_commit();

  for (int k = 0; b < B; b += stride, ++k) {
    T* const Ss = slots + (k & 1) * slot_words;
    const long long nb = b + stride;
    if (nb < B) copy_lower<T, kMaxN>(slots + ((k + 1) & 1) * slot_words, Sg + nb * nn, n, ld, vec, lane);
    __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncwarp();  // system b's S has landed

    // this thread's row: the copied pieces (columns up to the diagonal,
    // and what shares a piece with it), zeros past them and past n; the
    // entries above the diagonal never reach one below it. The threads
    // past n hold rows of the identity, whose pivots are 1 and change
    // nothing, so that all kMaxN pivots run with no branch between them
    T* const row = Ss + lane * ld;
    T s[kMaxN];
#pragma unroll
    for (int j = 0; j < kMaxN; j += per) load16(row + j, s, j, own && j <= lane);
#pragma unroll
    for (int j = 0; j < kMaxN; ++j)
      if (!own) s[j] = j == lane ? T(1) : T(0);
    bool ok = true;
    T inv = T(0);  // not read
    panel_pivots<false>(s, s, kMaxN, lane, ok, inv);

    // L's row into the slot (it is this thread's own row of S, read
    // above): zeros above the diagonal, NaN below it where S is not
    // positive definite; then the slot flat to device memory
    if (own) {
#pragma unroll
      for (int j = 0; j < kMaxN; ++j) s[j] = j > lane ? T(0) : (ok ? s[j] : nan);
#pragma unroll
      for (int j = 0; j < kMaxN; j += per)
        if (j < n) store16(row + j, s, j);
    }
    __syncwarp();  // L's rows are in the slot
    T* const dst = Lg + b * nn;
    if (vec) {
      const int pc = (lane & (pieces - 1)) * per;
      for (int r = lane / pieces; r < n; r += rows)
        if (pc < n) *reinterpret_cast<int4*>(dst + r * n + pc) = *reinterpret_cast<const int4*>(Ss + r * ld + pc);
    } else if (own) {
      for (int r = 0; r < n; ++r) dst[r * n + lane] = Ss[r * ld + lane];
    }
    __syncwarp();  // every thread is done with this slot before it is refilled
  }
  __pipeline_wait_prior(0);
}

// solve_t1 for n <= kMaxN = 32 (see the file comment). Shared memory per
// warp: two slots of slot_words (n rows of ld words: n rounded up to 16
// bytes, plus 16 bytes); system number k of this warp in slot k & 1.
template <typename T, int kMaxN>
__global__ void __launch_bounds__(kT1Warps * kWarp)
    solve_t1_reg_kernel(const T* __restrict__ Lg, const T* __restrict__ bg, T* __restrict__ xg,
                        int B, int n, int slot_words, int vec) {
  constexpr int per = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ld = ((n + per - 1) & ~(per - 1)) + per;  // 16-byte rows
  T* const slots = reinterpret_cast<T*>(smem_raw) + static_cast<size_t>(warp) * 2 * slot_words;
  const long long stride = static_cast<long long>(gridDim.x) * warps;
  long long b = static_cast<long long>(blockIdx.x) * warps + warp;
  if (b >= B) return;  // ragged batch edge; the kernel has no block barrier
  const long long nn = static_cast<long long>(n) * n;
  const int c = min(lane, n - 1);  // this thread's row, clamped to a real one to read
  const bool own = lane < n;
  copy_lower<T, kMaxN>(slots, Lg + b * nn, n, ld, vec, lane);
  __pipeline_commit();
  T bn = own ? bg[b * n + lane] : T(0);  // b of this warp's next system

  for (int k = 0; b < B; b += stride, ++k) {
    const T* Ls = slots + (k & 1) * slot_words;
    const long long nb = b + stride;
    if (nb < B) copy_lower<T, kMaxN>(slots + ((k + 1) & 1) * slot_words, Lg + nb * nn, n, ld, vec, lane);
    __pipeline_commit();
    T r = bn;
    if (nb < B && own) bn = bg[nb * n + lane];
    __pipeline_wait_prior(1);
    __syncwarp();  // system b's L has landed

    // L u = b from the top: u_j = r_j / L_jj by the reciprocal, broadcast;
    // the rows below take column j (this thread's row, in registers). The
    // threads past n hold rows of the identity and b = 0, so that every
    // loop runs to kMaxN with no branch (what they add is an exact zero).
    const T* row = Ls + c * ld;
    const T inv = own ? recip(row[c]) : T(1);
    T l[kMaxN];
#pragma unroll
    for (int j = 0; j < kMaxN; j += per) load16(row + j, l, j, j < n);
#pragma unroll
    for (int j = 0; j < kMaxN; ++j) {
      if (!own) l[j] = j == lane ? T(1) : T(0);
      const T uj = __shfl_sync(kFull, r * inv, j);
      r = lane == j ? uj : (lane > j ? r - l[j] * uj : r);
    }
    // L' x = u from the bottom: the rows above take row j of L (column
    // `lane` of L', consecutive words across the warp), read into the
    // same registers before the first step
#pragma unroll
    for (int j = 0; j < kMaxN; ++j) l[j] = j < n ? Ls[j * ld + c] : T(0);
#pragma unroll
    for (int j = kMaxN - 1; j >= 0; --j) {
      const T xj = __shfl_sync(kFull, r * inv, j);
      r = lane == j ? xj : (lane < j ? r - l[j] * xj : r);
    }
    if (own) xg[b * n + lane] = r;
    __syncwarp();  // every thread is done with this slot before it is refilled
  }
  __pipeline_wait_prior(0);
}

// solve_t1 for n in 33..128 (the first design): one warp per system L L^T x
// = b, forward substitution L u = b by columns, then backward substitution
// L^T x = u, with L and x in shared memory and the same row ownership as
// factor_t1_wide_kernel.
template <typename T>
__global__ void solve_t1_wide_kernel(const T* __restrict__ Lg, const T* __restrict__ bg,
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

// How a T=1 kernel launches at n: its warps a block, shared memory a
// block, its resident blocks an SM, and the device's SMs.
struct T1Plan {
  bool reg;  // the register kernel (n <= 32), else the wide kernel
  int warps, slot_words, blocks_per_sm, sms;
  size_t smem;
};

// Shared memory a block of a register kernel takes at n: two slots a warp
// of n rows of ld words (n rounded up to 16 bytes, plus 16 bytes).
template <typename T>
constexpr int reg_slot_words(int n) {
  return n * (round16<T>(n) + 16 / static_cast<int>(sizeof(T)));
}
template <typename T>
constexpr size_t reg_smem(int n) {
  return sizeof(T) * 2 * static_cast<size_t>(reg_slot_words<T>(n)) * kT1Warps;
}

// The residency of a register kernel at n on the current device, asked
// once a device, kernel and n: the launch reads it every call. The
// kernel's shared-memory limit is raised on the way to what n = 32 takes,
// where that is more than 48 KB, so that no later n lowers it below what
// an earlier one was launched with.
template <typename T, typename K>
cudaError_t reg_residency(K kernel, int n, size_t smem, int* blocks_per_sm, int* sms) {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> cached[kMaxDevices][kWarp + 1][2];  // blocks an SM, SMs; 0: not asked
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool keep = dev >= 0 && dev < kMaxDevices;
  if (keep && (*blocks_per_sm = cached[dev][n][0].load(std::memory_order_acquire)) > 0) {
    *sms = cached[dev][n][1].load(std::memory_order_relaxed);
    return cudaSuccess;
  }
  if (reg_smem<T>(kWarp) > kDefaultSmem) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(reg_smem<T>(kWarp)));
    if (err != cudaSuccess) return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kT1Warps * kWarp, smem);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (*blocks_per_sm < 1) return cudaErrorInvalidConfiguration;  // the launch would be refused
  if (keep) {
    cached[dev][n][1].store(*sms, std::memory_order_relaxed);
    cached[dev][n][0].store(*blocks_per_sm, std::memory_order_release);
  }
  return cudaSuccess;
}

// The plan of the register kernel `reg` up to n = 32, else of the wide
// kernel `wide`, whose warps take wide_per_warp bytes of shared memory
template <typename T, typename K, typename W>
cudaError_t plan_t1(K reg, W wide, size_t wide_per_warp, int n, T1Plan* p) {
  p->reg = n <= kWarp;
  if (p->reg) {
    p->slot_words = reg_slot_words<T>(n);
    p->warps = kT1Warps;
    p->smem = reg_smem<T>(n);
    return reg_residency<T>(reg, n, p->smem, &p->blocks_per_sm, &p->sms);
  }
  p->slot_words = p->blocks_per_sm = p->sms = 0;  // the launch does not read them
  return configure(wide, wide_per_warp, &p->warps, &p->smem);
}

// Blocks of a launch by plan p: every warp resident at once, each walking
// its systems, for the register kernels; a warp a system for the wide ones
int t1_grid(const T1Plan& p, int B) {
  const long long blocks = (B + p.warps - 1) / p.warps;
  const long long resident = static_cast<long long>(p.blocks_per_sm) * p.sms;
  return static_cast<int>(p.reg && resident < blocks ? resident : blocks);
}

// (warps a block, resident blocks an SM) of plan p
template <typename W>
int t1_layout(cudaError_t err, const T1Plan& p, W wide, int* warps, int* blocks_per_sm) {
  int blocks = p.blocks_per_sm;
  if (err == cudaSuccess && !p.reg)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, wide, p.warps * kWarp, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  *warps = p.warps;
  *blocks_per_sm = blocks;
  return static_cast<int>(cudaSuccess);
}

template <typename T>
cudaError_t plan_factor_t1(int n, T1Plan* p) {
  return plan_t1<T>(factor_t1_reg_kernel<T, kWarp>, factor_t1_wide_kernel<T>,
                    sizeof(T) * static_cast<size_t>(n) * (n + 1), n, p);
}

template <typename T>
cudaError_t plan_solve_t1(int n, T1Plan* p) {
  return plan_t1<T>(solve_t1_reg_kernel<T, kWarp>, solve_t1_wide_kernel<T>,
                    sizeof(T) * (static_cast<size_t>(n) * (n + 1) + n), n, p);
}

bool aligned_rows(size_t word, int n, const void* p) { return (word * n) % 16 == 0 && aligned16(p); }

template <typename T>
int factor_t1(const void* S, void* L, int B, int n, void* stream) {
  if (n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  T1Plan p;
  cudaError_t err = plan_factor_t1<T>(n, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* Sp = static_cast<const T*>(S);
  T* Lp = static_cast<T*>(L);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.reg) {
    const int vec = aligned_rows(sizeof(T), n, S) && aligned16(L);
    factor_t1_reg_kernel<T, kWarp><<<t1_grid(p, B), p.warps * kWarp, p.smem, st>>>(Sp, Lp, B, n, p.slot_words, vec);
  } else {
    factor_t1_wide_kernel<T><<<t1_grid(p, B), p.warps * kWarp, p.smem, st>>>(Sp, Lp, B, n);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int solve_t1(const void* L, const void* b, void* x, int B, int n, void* stream) {
  if (n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  T1Plan p;
  cudaError_t err = plan_solve_t1<T>(n, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* Lp = static_cast<const T*>(L);
  const T* bp = static_cast<const T*>(b);
  T* xp = static_cast<T*>(x);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.reg) {
    const int vec = aligned_rows(sizeof(T), n, L);
    solve_t1_reg_kernel<T, kWarp><<<t1_grid(p, B), p.warps * kWarp, p.smem, st>>>(Lp, bp, xp, B, n, p.slot_words, vec);
  } else {
    solve_t1_wide_kernel<T><<<t1_grid(p, B), p.warps * kWarp, p.smem, st>>>(Lp, bp, xp, B, n);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int factor_t1_layout(int n, int* warps, int* blocks_per_sm) {
  if (n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  T1Plan p;
  const cudaError_t err = plan_factor_t1<T>(n, &p);
  return t1_layout(err, p, factor_t1_wide_kernel<T>, warps, blocks_per_sm);
}

template <typename T>
int solve_t1_layout(int n, int* warps, int* blocks_per_sm) {
  if (n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  T1Plan p;
  const cudaError_t err = plan_solve_t1<T>(n, &p);
  return t1_layout(err, p, solve_t1_wide_kernel<T>, warps, blocks_per_sm);
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

// How factor_t1 and solve_t1 launch at n: warps a block and resident
// blocks an SM.
int calipso_factor_t1_layout_f32(int n, int* warps, int* blocks_per_sm) {
  return factor_t1_layout<float>(n, warps, blocks_per_sm);
}

int calipso_factor_t1_layout_f64(int n, int* warps, int* blocks_per_sm) {
  return factor_t1_layout<double>(n, warps, blocks_per_sm);
}

int calipso_solve_t1_layout_f32(int n, int* warps, int* blocks_per_sm) {
  return solve_t1_layout<float>(n, warps, blocks_per_sm);
}

int calipso_solve_t1_layout_f64(int n, int* warps, int* blocks_per_sm) {
  return solve_t1_layout<double>(n, warps, blocks_per_sm);
}

}  // extern "C"
