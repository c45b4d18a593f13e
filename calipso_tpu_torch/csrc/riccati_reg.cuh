// Device code shared by the kernels that keep a warp's rows in registers
// (riccati_t1.cu, riccati_lanes.cu, riccati_fused.cu): one warp owns one
// system, thread i holds row i of it, and the loops over a row run to a
// compile-time width kMax (12, 16 or 32), so that a row is indexed only
// at compile time and stays in registers; and the host side's launch
// helpers. ops/_build.py hashes this file into the key of every library,
// so an edit rebuilds all of them.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarpsPerBlock = 8;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;  // a block's opt-in limit on Hopper

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

// 1 / x, correctly rounded, without the division routine
__device__ __forceinline__ float recip(float x) { return __frcp_rn(x); }
__device__ __forceinline__ double recip(double x) { return __drcp_rn(x); }

// `words` rounded up to a multiple of 16 bytes
template <typename T>
__host__ __device__ constexpr int round16(int words) {
  return (words + 16 / static_cast<int>(sizeof(T)) - 1) & ~(16 / static_cast<int>(sizeof(T)) - 1);
}

// Four consecutive words at p (16-byte aligned) in 16-byte accesses
__device__ __forceinline__ void load4(const float* p, float& a, float& b, float& c, float& d) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  a = v.x, b = v.y, c = v.z, d = v.w;
}
__device__ __forceinline__ void load4(const double* p, double& a, double& b, double& c, double& d) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  const double2 w = *reinterpret_cast<const double2*>(p + 2);
  a = v.x, b = v.y, c = w.x, d = w.y;
}
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(double* p, double a, double b, double c, double d) {
  *reinterpret_cast<double2*>(p) = make_double2(a, b);
  *reinterpret_cast<double2*>(p + 2) = make_double2(c, d);
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

// n contiguous elements from shared to device memory by one warp, in
// 16-byte pieces when `vec` (as for warp_copy_async)
template <typename T>
__device__ __forceinline__ void warp_store(T* dst, const T* src, int n, bool vec, int lane) {
  if (vec) {
    constexpr int per = 16 / sizeof(T);
    for (int e = lane; e * per < n; e += kWarp)
      *reinterpret_cast<int4*>(dst + e * per) = *reinterpret_cast<const int4*>(src + e * per);
  } else {
    for (int e = lane; e < n; e += kWarp) dst[e] = src[e];
  }
}

// sum_k a[k] v[k] over k < kMax, v read from shared memory as 16-byte
// broadcasts (16-byte aligned), in four partial sums (k = 0, 4, 8, ...; 1,
// 5, ...; 2, ...; 3, ...) added pairwise
template <typename T, int kMax>
__device__ __forceinline__ T dot_bcast(const T (&a)[kMax], const T* v) {
  T p0 = T(0), p1 = T(0), p2 = T(0), p3 = T(0);
#pragma unroll
  for (int k = 0; k < kMax; k += 4) {
    T g0, g1, g2, g3;
    load4(v + k, g0, g1, g2, g3);
    p0 += a[k] * g0;
    p1 += a[k + 1] * g1;
    p2 += a[k + 2] * g2;
    p3 += a[k + 3] * g3;
  }
  return (p0 + p1) + (p2 + p3);
}

// The Gram coupling S_t = D_t - M_{t-1}' M_{t-1} of the block-tridiagonal
// factor: entry (c, j) of this thread's row s takes the dot of its o row
// (M_{t-1}' row c) with o row j of G (row stride ldg), read as broadcasts
template <typename T, int kMax>
__device__ __forceinline__ void gram_update(T (&s)[kMax], const T (&o)[kMax], const T* G, int ldg) {
#pragma unroll
  for (int j = 0; j < kMax; ++j) s[j] -= dot_bcast<T, kMax>(o, G + j * ldg);
}

// Right-looking Cholesky of the rows the warp holds: this thread's row s
// of the n x n block (and, where kPanel, its row o of the block below it,
// the stacked panel [S ; O], which ends as O L^{-T}). At pivot k every
// thread takes the diagonal by one shuffle from thread k, the same
// correctly rounded sqrt and one reciprocal, scales its column-k entries
// and takes each l_jk (j > k) by one shuffle from thread j: independent
// within a pivot, so they pipeline, with no barrier. Threads past n hold
// zero rows, so every loop but the pivots' runs to kMax with no branch
// (what they add is an exact zero); or, with n = kMax, rows of the
// identity, whose pivots change nothing. A pivot that is not positive, or not
// finite, clears `ok` (the same test in every thread), read by the caller
// once the loop is done, so that no branch on it splits the pivots.
// inv_own ends as 1 / l_cc of this thread's row c (unchanged past n).
template <bool kPanel, typename T, int kMax>
__device__ __forceinline__ void panel_pivots(T (&s)[kMax], T (&o)[kMax], int n, int lane, bool& ok, T& inv_own) {
#pragma unroll
  for (int k = 0; k < kMax; ++k) {
    if (k >= n) break;
    const T pkk = __shfl_sync(kFull, s[k], k);
    ok = ok && pkk > T(0) && pkk - pkk == T(0);
    const T lkk = sqrt(pkk);
    const T inv = recip(lkk);
    s[k] = lane == k ? lkk : s[k] * inv;
    if (kPanel) o[k] *= inv;
    inv_own = lane == k ? inv : inv_own;
#pragma unroll
    for (int j = k + 1; j < kMax; ++j) {
      const T ljk = __shfl_sync(kFull, s[k], j);
      s[j] -= s[k] * ljk;
      if (kPanel) o[j] -= o[k] * ljk;
    }
  }
}

// The stage slots of a register kernel that walks T stages, for a width
// kMax (a power of 2 of them): four up to 16, copied three stages ahead;
// two past it (a 32 x 32 float64 slot pair is 16 KB a warp)
__host__ __device__ constexpr int factor_slots(int kMax) { return kMax <= 16 ? 4 : 2; }

// Warps per block so that a block's shared memory stays within `budget`
// (the default 48 KB unless given) where it can; a larger share runs one
// warp per block. Above 48 KB the kernel's opt-in shared-memory limit is
// raised. At most max_warps a block.
template <typename K>
cudaError_t configure(K kernel, size_t per_warp, int* warps, size_t* smem,
                      size_t budget = kDefaultSmem, int max_warps = kMaxWarpsPerBlock) {
  size_t w = budget / per_warp;
  if (w > static_cast<size_t>(max_warps)) w = max_warps;
  if (w < 1) w = 1;
  *warps = static_cast<int>(w);
  *smem = per_warp * w;
  if (*smem > kDefaultSmem)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(*smem));
  return cudaSuccess;
}

inline bool aligned16(const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; }

// The SMs of the current device, asked once a device.
inline int sm_count() {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> cached[kMaxDevices];  // 0: not asked
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  const bool keep = dev >= 0 && dev < kMaxDevices;
  if (keep && (n = cached[dev].load(std::memory_order_relaxed)) > 0) return n;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1) return 1;
  if (keep) cached[dev].store(n, std::memory_order_relaxed);
  return n;
}

}  // namespace
