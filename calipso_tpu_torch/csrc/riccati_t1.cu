// Batched dense Cholesky factor and L L^T substitution for n <= 288 in
// float32 and n <= 192 in float64: the T=1 case of the block-tridiagonal
// Riccati factorization, which is the whole linear algebra of the schur
// KKT backend.
//
// Replaces the TPU kernels calipso_tpu/ops/pallas_riccati.py
// _factor_lanes_t1_kernel (:633; its pallas_call at :704) and
// _solve_lanes_t1_kernel (:661; :764). The TPU versions put the batch on
// the 128-lane vector axis and emitted a transposed factor; here a warp
// (n <= 32) or a thread block (n past 32) owns one matrix and reads and
// writes the public row-major (B, n, n) layout directly. Wider systems
// take the library route one layer up (ops/riccati.t1_route), as the
// reference takes XLA's Cholesky where no Pallas tile fits (its resident
// tile reaches n = 221 at B = 32 in float32).
//
// Bound: the factor reads S's lower triangle and writes L whole (its
// upper zeros too, which the contract writes), 22.2 MB at the flagship's
// B=8192, n=32 in float32 (15.2 us at 3.35 TB/s), against n^3/3 flops a
// matrix (89 MFLOP); the solve reads L's lower triangle and b and writes
// x, 19.4 MB (5.8 us) against 4.2 MFLOP. Both are bound by memory traffic
// in principle and by the chain of n dependent pivot steps in practice,
// which the designs below keep free of divisions and shared-memory round
// trips, and, within a 32-wide panel, of barriers.
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
// for j > i (consecutive words across the warp), read into the same
// registers before its first step. b is read into a register and x
// written from one.
//
// n in 33..128 (the bunny hop's n = 110): a thread block of 4 warps a
// system, one block a system (grid = B), so that one system is no longer
// one warp's serial chain and a batch fills the card with as many blocks
// as fit an SM (shared memory sets it: below). The system is cut into P =
// ceil(n / 32) panels of 32 columns and held in shared memory as its
// lower 32 x 32 blocks only (P(P+1)/2 of them, 10 at n = 128: 45 KB in
// float32, 85 KB in float64), each at a row stride of 32 words plus 16
// bytes, so that a quarter warp's 16-byte accesses to 8 consecutive rows
// hit distinct banks. Rows past n are rows of the identity (the factor) or
// zero (the solve), so every panel is 32 wide and every loop runs to 32
// with no branch. The lower triangle comes in by cp.async, in 16-byte
// pieces where n sizeof(T) and the address allow, else 8-byte, else
// element by element (copy_panels), panel 0's columns as one batch and
// the rest as a second, so that panel 0's chain starts while the rest is
// in flight.
//
// factor_t1 (factor_t1_panel_kernel), right-looking: at panel p every
// warp w that has a strip below the diagonal block (the 32 rows of block
// row p + 1 + w; at most 3 at n <= 128), and warp 0, read the diagonal
// block as rows s and their strip as rows o into registers and run
// panel_pivots: the diagonal pivots by shuffles, repeated in each warp
// (the same arithmetic, no barrier), the strip ending as L21 = A21
// L11^-T, no division (reciprocal pivots). The last panel has no strip;
// warp 0 runs all 32 of its pivots (a second, strip-less pivot loop that
// stopped at the real rows doubled the unrolled code and made the float64
// factor at B=1024 up to 1.9x slower on an H100). Then one barrier,
// __syncthreads_and of the warps' failure flags, so a bad pivot in any
// panel stops the block and the matrix comes out NaN over its lower
// triangle; warp 0 writes L11 only after it, once every warp has read the
// diagonal block. Then the trailing update A22 -= L21 L21' over the lower
// blocks, in half blocks of 32 x 16 shared by the warps, each thread a 4 x
// 4 register tile (rows ty + 8 ii, columns tx + 4 jj, so that a quarter
// warp's 16-byte reads of L21 touch consecutive rows: no bank conflict)
// reading L21 in 16-byte pieces; then a second barrier. Two barriers a
// panel (8 at n = 128) where the first design took two __syncwarp and a
// division a pivot. Full float32 on the FMA pipes, no TF32. L goes out a
// row a warp, in 16-byte pieces where n sizeof(T) and L's address allow.
//
// solve_t1 (solve_t1_panel_kernel), blocked substitution: the forward
// sweep solves panel p's diagonal block by warp 0 from registers, as the
// register kernel's sweep does (1 / L_ii, one shuffle and one FMA a step),
// then all threads take the rows below, b_r -= L[r][panel] u_panel, a
// thread a row (16-byte reads of the row, 16-byte broadcasts of u); the
// backward sweep solves the diagonal block's transpose the same way from
// the bottom, then all threads take the columns left of it, u_t -=
// sum_j L[j][t] x_j, a thread a column. Two barriers a panel a sweep where
// the first design took two __syncwarp and a division a step.
//
// n past 128 (the wide panel kernels): the same two kernels, instances of
// 8 warps a block (kWideWarps) whose factor loops over the strips with the
// most panels it takes as a compile-time bound (kMaxP), so that every warp
// takes one strip of the widest factor's 8 at p = 0 where 4 warps took two,
// each repeating the diagonal pivots. The limits are set by shared memory
// alone: the lower blocks of P panels and the solve's u must fit a
// block's 227 KB (wide_panels: float32 P = 9, 208.5 KB; float64 P = 6,
// 184.3 KB), one block an SM. Everything the n <= 128 design keeps stays: the
// reciprocal pivots and no division, __syncthreads_and of the failure
// flags (a lane not positive definite comes out NaN over its lower
// triangle), two barriers a panel, cp.async of panel 0 ahead of the rest,
// full float32 on the FMA pipes.
//
// Plain C interface, loaded with ctypes: every entry point launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include "riccati_reg.cuh"

namespace {

constexpr int kT1Warps = 4;  // warps a block, of every T=1 kernel up to n = 128
constexpr int kMaxN = 128;   // the widest system the register and panel kernels take
// warps a block of the wide panel kernels (n past 128): 8, one strip of
// the widest factor's 7 or 8 a warp, where 4 warps took two strips each
// (PERF.md has the times of both)
constexpr int kWideWarps = 8;
constexpr int kMaxWideN = 288;  // the widest system of any dtype (float32; see wide_panels)

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

// ---- n in 33..128: a thread block a system, 32-wide panels ------------

__host__ __device__ constexpr int panels(int n) { return (n + kWarp - 1) / kWarp; }

// Row stride of a 32 x 32 block: 32 words plus 16 bytes
template <typename T>
__host__ __device__ constexpr int panel_ld() {
  return kWarp + 16 / static_cast<int>(sizeof(T));
}

// Words of the lower blocks of an n x n system
template <typename T>
__host__ __device__ constexpr int panel_words(int n) {
  return panels(n) * (panels(n) + 1) / 2 * kWarp * panel_ld<T>();
}

// Block (bi, bj), bi >= bj, of the lower blocks at A (stored by block rows)
template <typename T>
__device__ __forceinline__ T* blk(T* A, int bi, int bj) {
  return A + (bi * (bi + 1) / 2 + bj) * (kWarp * panel_ld<T>());
}

// Entry (r, c), c>>5 <= r>>5, of the lower blocks at A
template <typename T>
__device__ __forceinline__ T at(T* A, int r, int c) {
  return blk(A, r >> 5, c >> 5)[(r & 31) * panel_ld<T>() + (c & 31)];
}

// The pieces of the lower triangle of the n x n row-major src in column
// panels [p_lo, p_hi) into the lower blocks at A, G bytes a piece, by the
// block's warps (rows from the panel's first column on); the caller
// commits the batch
template <int G, int kWarps, typename T>
__device__ __forceinline__ void copy_panels(T* A, const T* src, int n, int p_lo, int p_hi, int warp, int lane) {
  constexpr int per = G / sizeof(T);    // words a piece
  constexpr int pieces = kWarp / per;   // pieces of a panel's row
  constexpr int rows = kWarp / pieces;  // rows a warp copies at once
  const int pc = (lane & (pieces - 1)) * per;
  for (int bj = p_lo; bj < p_hi; ++bj) {
    const int c = bj * kWarp + pc;
    for (int r = bj * kWarp + warp * rows + lane / pieces; r < n; r += kWarps * rows)
      if (c <= r)
        __pipeline_memcpy_async(blk(A, r >> 5, bj) + (r & 31) * panel_ld<T>() + pc,
                                src + static_cast<long long>(r) * n + c, G);
  }
}

// copy_panels in pieces of `bytes` (16, 8, or sizeof(T): what n sizeof(T)
// and src's address allow)
template <int kWarps, typename T>
__device__ __forceinline__ void copy_panels_of(int bytes, T* A, const T* src, int n, int p_lo, int p_hi, int warp,
                                               int lane) {
  if (bytes == 16)
    copy_panels<16, kWarps>(A, src, n, p_lo, p_hi, warp, lane);
  else if (bytes == 8)
    copy_panels<8, kWarps>(A, src, n, p_lo, p_hi, warp, lane);
  else
    copy_panels<sizeof(T), kWarps>(A, src, n, p_lo, p_hi, warp, lane);
}

// The rows past n (all in the last block row) of every lower block: the
// identity's where `unit`, else zeros
template <int kWarps, typename T>
__device__ __forceinline__ void pad_rows(T* A, int n, bool unit, int warp, int lane) {
  const int P = panels(n);
  for (int r = n + warp; r < P * kWarp; r += kWarps)
    for (int bj = 0; bj < P; ++bj)
      blk(A, P - 1, bj)[(r & 31) * panel_ld<T>() + lane] = unit && bj == P - 1 && (r & 31) == lane ? T(1) : T(0);
}

// sum_k a[k] v[k] over k < 32, both in shared memory (16-byte aligned),
// in four partial sums added pairwise
template <typename T>
__device__ __forceinline__ T dot32(const T* a, const T* v) {
  T p0 = T(0), p1 = T(0), p2 = T(0), p3 = T(0);
#pragma unroll
  for (int k = 0; k < kWarp; k += 4) {
    T a0, a1, a2, a3, g0, g1, g2, g3;
    load4(a + k, a0, a1, a2, a3);
    load4(v + k, g0, g1, g2, g3);
    p0 += a0 * g0;
    p1 += a1 * g1;
    p2 += a2 * g2;
    p3 += a3 * g3;
  }
  return (p0 + p1) + (p2 + p3);
}

// factor_t1 for n in 33..128 (kWarps = 4, kMaxP = 4) and past 128 (the
// wide instance: kWideWarps, kMaxP = wide_panels<T>()); see the file
// comment. Shared memory: panel_words(n) words. copy_bytes: the piece of
// the copy in (16, 8 or sizeof(T)); vec_out: L's rows go out in 16-byte
// pieces. A warp takes the strips warp, warp + kWarps, ... (one pass where
// kWarps >= kMaxP - 1), the diagonal pivots again for each.
template <typename T, int kWarps, int kMaxP>
__global__ void __launch_bounds__(kWarps * kWarp, 1)
    factor_t1_panel_kernel(const T* __restrict__ Sg, T* __restrict__ Lg, int n, int copy_bytes, int vec_out) {
  constexpr int per = 16 / sizeof(T);
  constexpr int ld = panel_ld<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const A = reinterpret_cast<T*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int P = panels(n);
  const long long nn = static_cast<long long>(n) * n;
  const T* const S = Sg + blockIdx.x * nn;
  T* const L = Lg + blockIdx.x * nn;
  copy_panels_of<kWarps>(copy_bytes, A, S, n, 0, 1, warp, lane);
  __pipeline_commit();
  copy_panels_of<kWarps>(copy_bytes, A, S, n, 1, P, warp, lane);
  __pipeline_commit();
  pad_rows<kWarps>(A, n, true, warp, lane);
  __pipeline_wait_prior(1);
  __syncthreads();  // panel 0's columns have landed

  bool all_ok = true;
  const int ty = lane >> 2, tx = lane & 3;
  for (int p = 0; p < P; ++p) {
    const int strips = P - 1 - p;  // block rows below the diagonal block
    T* const drow = blk(A, p, p) + lane * ld;
    T s[kWarp];
    bool ok = true;
#pragma unroll
    for (int pass = 0; pass < (kMaxP - 2) / kWarps + 1; ++pass) {
      const int st = warp + pass * kWarps;  // this pass's strip
      if (st < max(strips, 1)) {
        // the diagonal block's row `lane` (its copied pieces: the entries
        // above the diagonal never reach one below it) and the strip's;
        // rows past n are the identity's
        T* const orow = blk(A, p + 1 + st, p) + lane * ld;
        T o[kWarp];
#pragma unroll
        for (int j = 0; j < kWarp; j += per) load16(drow + j, s, j, j <= lane);
#pragma unroll
        for (int j = 0; j < kWarp; j += per) load16(orow + j, o, j, st < strips);
        T inv = T(0);  // not read
        panel_pivots<true>(s, o, kWarp, lane, ok, inv);
        if (st < strips) {
#pragma unroll
          for (int j = 0; j < kWarp; j += per) store16(orow + j, o, j);
        }
      }
    }
    if (p == 0) __pipeline_wait_prior(0);  // every column, before the first update
    all_ok = __syncthreads_and(ok);         // L21 is in place; every warp has read the diagonal block
    if (!all_ok) break;
    if (warp == 0) {  // L11 over the diagonal block, which the update does not read
#pragma unroll
      for (int j = 0; j < kWarp; j += per) store16(drow + j, s, j);
    }
    if (strips == 0) break;

    // A22 -= L21 L21' over the lower blocks (bi, bj) right of the panel,
    // in half blocks (32 rows, columns h*16 ..): unit u is half u & 1 of
    // lower block u >> 1, counted by block rows
    const int units = strips * (strips + 1);
    for (int u = warp; u < units; u += kWarps) {
      int k = u >> 1, row = 0;
      while (k > row) k -= ++row;
      const int bi = p + 1 + row, bj = p + 1 + k, c0 = (u & 1) * 16 + tx;
      T* const C = blk(A, bi, bj);
      const T* const Li = blk(A, bi, p);
      const T* const Lj = blk(A, bj, p);
      T acc[4][4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = C[(ty + 8 * ii) * ld + c0 + 4 * jj];
#pragma unroll
      for (int k4 = 0; k4 < kWarp; k4 += 4) {
        T a[4][4], b[4][4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) load4(Li + (ty + 8 * ii) * ld + k4, a[ii][0], a[ii][1], a[ii][2], a[ii][3]);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) load4(Lj + (c0 + 4 * jj) * ld + k4, b[jj][0], b[jj][1], b[jj][2], b[jj][3]);
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[ii][jj] -= a[ii][q] * b[jj][q];
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) C[(ty + 8 * ii) * ld + c0 + 4 * jj] = acc[ii][jj];
    }
    __syncthreads();  // the trailing blocks are updated
  }

  __syncthreads();  // the last L11 is in place

  // L a row a warp: zeros above the diagonal, NaN below it where S is not
  // positive definite
  const T nan = quiet_nan<T>();
  for (int r = warp; r < n; r += kWarps) {
    T* const dst = L + static_cast<long long>(r) * n;
    if (vec_out) {
      for (int c = lane * per; c < n; c += kWarp * per) {
        T v[per];
#pragma unroll
        for (int e = 0; e < per; ++e) v[e] = c + e > r ? T(0) : (all_ok ? at(A, r, c + e) : nan);
        store16(dst + c, v, 0);
      }
    } else {
      for (int c = lane; c < n; c += kWarp) dst[c] = c > r ? T(0) : (all_ok ? at(A, r, c) : nan);
    }
  }
}

// solve_t1 for n in 33..128 (kWarps = 4) and past 128 (kWideWarps); see
// the file comment. Shared memory: panel_words(n) words of L, then u (32 P
// words).
template <typename T, int kWarps>
__global__ void __launch_bounds__(kWarps * kWarp, 1)
    solve_t1_panel_kernel(const T* __restrict__ Lg, const T* __restrict__ bg, T* __restrict__ xg, int n,
                          int copy_bytes) {
  constexpr int per = 16 / sizeof(T);
  constexpr int ld = panel_ld<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const A = reinterpret_cast<T*>(smem_raw);
  T* const u = A + panel_words<T>(n);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int P = panels(n), N = P * kWarp;
  const long long nn = static_cast<long long>(n) * n;
  copy_panels_of<kWarps>(copy_bytes, A, Lg + blockIdx.x * nn, n, 0, 1, warp, lane);
  __pipeline_commit();
  copy_panels_of<kWarps>(copy_bytes, A, Lg + blockIdx.x * nn, n, 1, P, warp, lane);
  __pipeline_commit();
  pad_rows<kWarps>(A, n, false, warp, lane);
  const T* const b = bg + static_cast<long long>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < N; i += kWarps * kWarp) u[i] = i < n ? b[i] : T(0);
  __pipeline_wait_prior(1);
  __syncthreads();  // panel 0's columns and b have landed

  // L u = b: panel p's diagonal block by warp 0 from the top (row c0 +
  // lane in registers; rows past n those of the identity, b = 0, so that
  // every step runs with no branch: what they add is an exact zero), then
  // the rows below the panel
  for (int p = 0; p < P; ++p) {
    const int c0 = p * kWarp;
    if (warp == 0) {
      const bool own = c0 + lane < n;
      const T* const row = blk(A, p, p) + lane * ld;
      const T inv = own ? recip(row[lane]) : T(1);
      T l[kWarp];
#pragma unroll
      for (int j = 0; j < kWarp; j += per) load16(row + j, l, j, own);
      T r = u[c0 + lane];
#pragma unroll
      for (int j = 0; j < kWarp; ++j) {
        if (!own) l[j] = j == lane ? T(1) : T(0);
        const T uj = __shfl_sync(kFull, r * inv, j);
        r = lane == j ? uj : (lane > j ? r - l[j] * uj : r);
      }
      u[c0 + lane] = r;
    }
    if (p == 0) __pipeline_wait_prior(0);
    __syncthreads();  // u of the panel (and, from panel 0 on, every column of L)
    for (int t = threadIdx.x; c0 + kWarp + t < N; t += kWarps * kWarp) {
      const int r = c0 + kWarp + t;
      u[r] -= dot32(blk(A, r >> 5, p) + (r & 31) * ld, u + c0);
    }
    __syncthreads();  // the rows below are updated
  }

  // L' x = u: panel p's diagonal block by warp 0 from the bottom (column
  // c0 + lane of the block in registers), then the columns left of it
  for (int p = P - 1; p >= 0; --p) {
    const int c0 = p * kWarp;
    if (warp == 0) {
      const bool own = c0 + lane < n;
      const T* const d = blk(A, p, p);
      const T inv = own ? recip(d[lane * ld + lane]) : T(1);
      T l[kWarp];
#pragma unroll
      for (int j = 0; j < kWarp; ++j) l[j] = d[j * ld + lane];
      T r = u[c0 + lane];
#pragma unroll
      for (int j = kWarp - 1; j >= 0; --j) {
        const T xj = __shfl_sync(kFull, r * inv, j);
        r = lane == j ? xj : (lane < j ? r - l[j] * xj : r);
      }
      u[c0 + lane] = r;
    }
    __syncthreads();  // x of the panel
    for (int t = threadIdx.x; t < c0; t += kWarps * kWarp) {
      const T* const col = blk(A, p, t >> 5) + (t & 31);
      T p0 = T(0), p1 = T(0), p2 = T(0), p3 = T(0);
#pragma unroll
      for (int j = 0; j < kWarp; j += 4) {
        T x0, x1, x2, x3;
        load4(u + c0 + j, x0, x1, x2, x3);
        p0 += col[j * ld] * x0;
        p1 += col[(j + 1) * ld] * x1;
        p2 += col[(j + 2) * ld] * x2;
        p3 += col[(j + 3) * ld] * x3;
      }
      u[t] -= (p0 + p1) + (p2 + p3);
    }
    __syncthreads();  // the columns left of the panel are updated
  }
  T* const x = xg + static_cast<long long>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += kWarps * kWarp) x[i] = u[i];
}

// The most panels of the wide panel kernels: the most P whose lower
// blocks and the solve's right-hand side (the larger of the two kernels'
// shares) fit a block's 227 KB (kMaxSmem): float32 P = 9, n <= 288 (45
// blocks of 32 x 36 words, 207,360 B, and u 1,152 B; P = 10 takes 254,720
// B); float64 P = 6, n <= 192 (21 blocks of 32 x 34 words, 182,784 B, and
// u 1,536 B; P = 7 takes 245,504 B).
template <typename T>
__host__ __device__ constexpr int wide_panels() {
  int P = 1;
  while (sizeof(T) * (static_cast<size_t>((P + 1) * (P + 2) / 2) * kWarp * panel_ld<T>() + (P + 1) * kWarp) <= kMaxSmem)
    ++P;
  return P;
}

// The widest system the T=1 kernels take (ops/cuda_riccati.MAX_N)
template <typename T>
constexpr int max_n() {
  return wide_panels<T>() * kWarp;
}
static_assert(max_n<float>() == kMaxWideN && max_n<double>() <= kMaxWideN, "kMaxWideN");

// How a T=1 kernel launches at n: the kernel (the register kernel up to n =
// 32, the panel kernel up to 128, the wide panel kernel past it), its warps
// a block, shared memory a block, its resident blocks an SM, and the
// device's SMs.
enum T1Kind { kReg, kPanel, kWide };
struct T1Plan {
  T1Kind kind;
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

// Shared memory a block of a panel kernel takes at n: the lower blocks,
// and for the solve (`vec`) the right-hand side of 32 P words
template <typename T>
constexpr size_t panel_smem(int n, bool vec) {
  return sizeof(T) * (static_cast<size_t>(panel_words<T>(n)) + (vec ? panels(n) * kWarp : 0));
}

// The residency of `kernel` at n, with `warps` warps a block and its
// shared memory `smem`, on the current device, asked once a device and n
// (a cache per kernel, kTag): the launch reads it every call. The
// kernel's shared-memory limit is raised on the way to `max_smem`, what
// its widest n takes, where that is more than 48 KB, so that no later n
// lowers it below what an earlier one was launched with.
template <int kTag, typename K>
cudaError_t residency(K kernel, int n, int warps, size_t smem, size_t max_smem, int* blocks_per_sm, int* sms) {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> cached[kMaxDevices][kMaxWideN + 1][2];  // blocks an SM, SMs; 0: not asked
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool keep = dev >= 0 && dev < kMaxDevices;
  if (keep && (*blocks_per_sm = cached[dev][n][0].load(std::memory_order_acquire)) > 0) {
    *sms = cached[dev][n][1].load(std::memory_order_relaxed);
    return cudaSuccess;
  }
  if (max_smem > kDefaultSmem) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(max_smem));
    if (err != cudaSuccess) return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, warps * kWarp, smem);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (*blocks_per_sm < 1) return cudaErrorInvalidConfiguration;  // the launch would be refused
  if (keep) {
    cached[dev][n][1].store(*sms, std::memory_order_relaxed);
    cached[dev][n][0].store(*blocks_per_sm, std::memory_order_release);
  }
  return cudaSuccess;
}

// The plan of the register kernel `reg` up to n = 32, of the panel kernel
// `panel` up to kMaxN and of the wide panel kernel `wide` past it (the
// solve's with its right-hand side: `vec`)
template <int kTag, typename T, typename K, typename W, typename V>
cudaError_t plan_t1(K reg, W panel, V wide, bool vec, int n, T1Plan* p) {
  p->slot_words = 0;
  if (n <= kWarp) {
    p->kind = kReg;
    p->warps = kT1Warps;
    p->slot_words = reg_slot_words<T>(n);
    p->smem = reg_smem<T>(n);
    return residency<kTag>(reg, n, p->warps, p->smem, reg_smem<T>(kWarp), &p->blocks_per_sm, &p->sms);
  }
  p->smem = panel_smem<T>(n, vec);
  if (n <= kMaxN) {
    p->kind = kPanel;
    p->warps = kT1Warps;
    return residency<kTag + 1>(panel, n, p->warps, p->smem, panel_smem<T>(kMaxN, vec), &p->blocks_per_sm, &p->sms);
  }
  p->kind = kWide;
  p->warps = kWideWarps;
  return residency<kTag + 2>(wide, n, p->warps, p->smem, panel_smem<T>(max_n<T>(), vec), &p->blocks_per_sm, &p->sms);
}

// Blocks of a launch by plan p: every warp resident at once, each walking
// its systems, for the register kernels; a block a system for the panel
// kernels (a block that ends frees its SM's share for the next)
int t1_grid(const T1Plan& p, int B) {
  if (p.kind != kReg) return B;
  const long long blocks = (B + kT1Warps - 1) / kT1Warps;
  const long long resident = static_cast<long long>(p.blocks_per_sm) * p.sms;
  return static_cast<int>(resident < blocks ? resident : blocks);
}

template <typename T>
cudaError_t plan_factor_t1(int n, T1Plan* p) {
  return plan_t1<0, T>(factor_t1_reg_kernel<T, kWarp>, factor_t1_panel_kernel<T, kT1Warps, panels(kMaxN)>,
                       factor_t1_panel_kernel<T, kWideWarps, wide_panels<T>()>, false, n, p);
}

template <typename T>
cudaError_t plan_solve_t1(int n, T1Plan* p) {
  return plan_t1<3, T>(solve_t1_reg_kernel<T, kWarp>, solve_t1_panel_kernel<T, kT1Warps>,
                       solve_t1_panel_kernel<T, kWideWarps>, true, n, p);
}

bool aligned_rows(size_t word, int n, const void* p) { return (word * n) % 16 == 0 && aligned16(p); }

// The piece a panel kernel copies its input in: 16 bytes where n sizeof(T)
// and p allow it, else 8, else a word
template <typename T>
int copy_bytes(int n, const void* p) {
  if (aligned_rows(sizeof(T), n, p)) return 16;
  const bool even = (sizeof(T) * n) % 8 == 0 && reinterpret_cast<size_t>(p) % 8 == 0;
  return even ? 8 : static_cast<int>(sizeof(T));
}

template <typename T>
int factor_t1(const void* S, void* L, int B, int n, void* stream) {
  if (n < 1 || n > max_n<T>()) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  T1Plan p;
  cudaError_t err = plan_factor_t1<T>(n, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* Sp = static_cast<const T*>(S);
  T* Lp = static_cast<T*>(L);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = t1_grid(p, B), threads = p.warps * kWarp;
  if (p.kind == kReg) {
    const int vec = aligned_rows(sizeof(T), n, S) && aligned16(L);
    factor_t1_reg_kernel<T, kWarp><<<grid, threads, p.smem, st>>>(Sp, Lp, B, n, p.slot_words, vec);
  } else if (p.kind == kPanel) {
    const int vec = aligned_rows(sizeof(T), n, L);
    factor_t1_panel_kernel<T, kT1Warps, panels(kMaxN)><<<grid, threads, p.smem, st>>>(Sp, Lp, n, copy_bytes<T>(n, S),
                                                                                       vec);
  } else {
    const int vec = aligned_rows(sizeof(T), n, L);
    factor_t1_panel_kernel<T, kWideWarps, wide_panels<T>()><<<grid, threads, p.smem, st>>>(
        Sp, Lp, n, copy_bytes<T>(n, S), vec);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int solve_t1(const void* L, const void* b, void* x, int B, int n, void* stream) {
  if (n < 1 || n > max_n<T>()) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  T1Plan p;
  cudaError_t err = plan_solve_t1<T>(n, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* Lp = static_cast<const T*>(L);
  const T* bp = static_cast<const T*>(b);
  T* xp = static_cast<T*>(x);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = t1_grid(p, B), threads = p.warps * kWarp;
  if (p.kind == kReg) {
    const int vec = aligned_rows(sizeof(T), n, L);
    solve_t1_reg_kernel<T, kWarp><<<grid, threads, p.smem, st>>>(Lp, bp, xp, B, n, p.slot_words, vec);
  } else if (p.kind == kPanel) {
    solve_t1_panel_kernel<T, kT1Warps><<<grid, threads, p.smem, st>>>(Lp, bp, xp, n, copy_bytes<T>(n, L));
  } else {
    solve_t1_panel_kernel<T, kWideWarps><<<grid, threads, p.smem, st>>>(Lp, bp, xp, n, copy_bytes<T>(n, L));
  }
  return static_cast<int>(cudaGetLastError());
}

// (warps a block, resident blocks an SM) of a plan
int t1_layout(cudaError_t err, const T1Plan& p, int* warps, int* blocks_per_sm) {
  if (err != cudaSuccess) return static_cast<int>(err);
  *warps = p.warps;
  *blocks_per_sm = p.blocks_per_sm;
  return static_cast<int>(cudaSuccess);
}

template <typename T>
int factor_t1_layout(int n, int* warps, int* blocks_per_sm) {
  if (n < 1 || n > max_n<T>()) return static_cast<int>(cudaErrorInvalidValue);
  T1Plan p;
  return t1_layout(plan_factor_t1<T>(n, &p), p, warps, blocks_per_sm);
}

template <typename T>
int solve_t1_layout(int n, int* warps, int* blocks_per_sm) {
  if (n < 1 || n > max_n<T>()) return static_cast<int>(cudaErrorInvalidValue);
  T1Plan p;
  return t1_layout(plan_solve_t1<T>(n, &p), p, warps, blocks_per_sm);
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
