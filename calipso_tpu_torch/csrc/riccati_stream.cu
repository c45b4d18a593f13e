// Batched block-tridiagonal Cholesky factor and solve over trajectory
// stages for wide stage blocks (the contact class, d = 54): the linear
// algebra of the riccati KKT backend on its "stream" route.
//
// Replaces the TPU kernels calipso_tpu/ops/pallas_riccati.py
// _factor_stream_kernel (factor_stream here), _solve_fwd_stream_kernel
// (solve_fwd_stream) and _solve_bwd_stream_kernel (solve_bwd_stream). The
// TPU versions put 128 lanes on the vector axis and streamed (d, d, 128)
// stage blocks from HBM through a double-buffered make_async_copy
// pipeline, because the horizon did not fit in VMEM. Here each lane walks
// its horizon inside one thread block; stage t+1's blocks are copied into
// a second shared-memory buffer with cp.async (__pipeline_memcpy_async)
// while stage t computes, and L_t, M_t, u_t and x_t go back to device
// memory as soon as they are computed. The public row-major (B, T, d, d)
// layout is read and written directly. T >= 1 and 1 <= d <= 169 in float32,
// d <= 120 in float64 (the kernels below for d <= 64; past it the wide
// instances at the end of this file); the solves take K right-hand sides
// per lane, b (B, T, d, K).
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
// Bound (H100 SXM: 3.35 TB/s HBM, 67 TFLOP/s float32; a symmetric D and a
// triangular L read as their lower triangles, L written whole): at the
// batched quadruped's shape (B=128, T=8, d=54, float32) the factor moves
// 38.9 MB (11.6 us) against 0.34 GFLOP (5.1 us), and one sweep of one
// column moves 17.0 MB (5.1 us): memory traffic bounds them in principle. In
// practice each lane is a chain of dependent steps (the stages, and the
// pivots inside a stage) and 128 lanes give one block to each of 128 of
// the 132 SMs, so the chain's latency sets the time: the block barriers on
// it, and what each step between them costs. On this card a cp.async of
// 4 bytes an element was found to cost more than the arithmetic it fed,
// so the two redesigned kernels copy a stage's blocks as they lie in
// device memory, d x d row-major, in 16-byte pieces (element by element
// only where d d sizeof(T) or an array's address is not a multiple of 16).
//
// factor_stream: one block of 256 threads per lane, a right-looking
// blocked Cholesky of the 2d x d stacked panel P = [S_t ; O_t]. Its top d
// rows become L_t and its bottom d rows O_t L_t^{-T} = M_t', the carry the
// next stage's Schur update reads, so the Cholesky and the substitution
// are one loop of d pivots. Panels are 8 columns wide (the last one
// d - 8 floor((d-1)/8) wide, padded to 8 with identity in registers):
// every thread factors the panel's 8 x 8 diagonal block in registers and
// solves one strip row below it, with no shuffle and no barrier; then the
// block applies the panel's rank-8 update to the trailing columns. The
// trailing update and the Schur update S_{t+1} = D_{t+1} - M_t' M_t (a
// symmetric rank-d update of the lower triangle from the bottom rows) are
// register-tiled products: each warp owns up to two fixed blocks of 8 x 4
// tiles of 4 x 4 outputs, mapped once before the stage loop, and reads
// rows of P from shared memory. Barriers a stage: 3 (stage's blocks
// landed; the carry consumed; O_t in place, the staging free) plus 2 a
// panel but the last, 2 ceil(d/8) + 2: 16 at d = 54, where the
// one-pivot-a-barrier design it replaces took about 3d = 165. No integer
// division runs inside a loop.
//
// solve_fwd_stream and solve_bwd_stream: one warp per right-hand-side
// column, the warps of a block that lane's columns in a chunk of <= 32
// (blockIdx.y over the chunks; a block is one warp at K = 1). A warp holds
// the stage vector's rows in registers, rows lane and lane + 32 of each
// thread, and the next stage's right-hand side (b_{t+1} or u_{t-1}) is read
// from device memory into registers a stage ahead. The coupling goes
// through a per-warp shared buffer of the neighbouring stage's solution:
// the forward sweep's r = b_t - M_{t-1}' u_{t-1} walks column i of M_{t-1}
// (consecutive lanes read consecutive words), the backward sweep's r = u_t
// - M_t x_{t+1} row i of M_t from column i on (wrapping, so that the lanes'
// reads fall in distinct banks when d is even). The substitution runs
// pivot by pivot, from the top (L_t u_t = r) or from the bottom (L_t' x_t
// = r): the pivot's owner scales its row by 1 / L_jj, a reciprocal each
// thread computes for its rows once a stage, off the chain; __shfl_sync
// broadcasts the value, and every other thread updates its rows with
// column j of L_t (forward) or row j (backward), loaded a step ahead. One
// block barrier a stage (the next stage's L and M have landed), none in
// the substitution: T d dependent warp steps a lane. The forward sweep's
// column loads are strided by d in shared memory, so at d = 54 lanes i and
// i + 16 share a bank (a 2-way conflict, 8-way at d = 56); they are loaded
// a step ahead, off the chain. chip_smoke.py --stream-times times both
// sweeps at d = 50..58: on an H100 the forward sweep's time a pivot stays
// flat across 2-, 4- and 8-way conflicts and below the backward sweep's,
// whose row reads have none, so L_t stays row-major, as it lands.
//
// Shared memory: the factor holds the stacked panel (2d (d+1) words), the
// staging of the next stage's D and O (2 d^2) and the diagonal blocks of
// L_t (512): 48.0 KB at d=54 in float32, 96 KB in float64; each sweep L
// and M of two stages and a column of d words per warp ((4 d + min(K,
// 32)) d words: 45.8 KiB at d=54, K=1 in float32, 50.2 KiB at K=22).
// Above 48 KiB a launch needs the raised dynamic shared-memory limit, set
// before it; a refused launch returns its error.
//
// Past d = 64 (factor_stream_wide_kernel) the factor is the wide stage of
// riccati_wide.cuh, shared with the fused solve: one block a lane, the
// stacked panel alone in shared memory (2d rows of panel_ld(d) words:
// 231 KB at d = 168 in float32), D and O read where the Schur update and
// the first panels consume them, the columns in blocks of 32 of 8-wide
// panels with reciprocal-square-root pivots. Its bound past d = 64 is the
// operations' (35.85 us at (32, 8, 165) in float32), but each lane's
// stages are a chain on one SM. The sweeps past d = 64 are blocked
// substitutions over 32-row diagonal blocks (sweep_wide, below): a warp a
// column solves a diagonal block by shuffles while every warp's loads of a
// 32 x 32 tile of L_t or M fly, then the tiles take the block's columns
// off the rows still to solve and off the next stage's right-hand side.
//
// Plain C interface, loaded with ctypes: every entry point launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "riccati_wide.cuh"

namespace {

constexpr int kThreads = 256;  // the factor
constexpr int kMaxD = 64;
constexpr int kMaxCols = 32;  // right-hand sides per block in the solves
constexpr int kPanel = 8;     // factor panel width
constexpr int kTile = 4;      // factor output tiles are kTile x kTile
// the factor's warps take blocks of 8 x 4 output tiles: at most 14 blocks
// at d <= 64, two a warp
constexpr int kTilesPerThread = 2;
constexpr unsigned kFull = 0xffffffffu;
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

// Asynchronous copy of n contiguous elements from device to shared
// memory by the whole block, in 16-byte pieces when `vec` (both addresses
// 16-byte aligned, n * sizeof(T) a multiple of 16), else element by
// element. The caller commits the batch.
template <typename T>
__device__ __forceinline__ void copy_flat_async(T* dst, const T* src, int n, bool vec) {
  if (vec) {
    constexpr int per = 16 / sizeof(T);
    for (int e = threadIdx.x; e * per < n; e += blockDim.x)
      __pipeline_memcpy_async(dst + e * per, src + e * per, 16);
  } else {
    for (int e = threadIdx.x; e < n; e += blockDim.x) __pipeline_memcpy_async(dst + e, src + e, sizeof(T));
  }
}

// One 4 x 4 output tile of the factor's stacked panel, rows r0.. and
// columns c0..: rows below d are S's (lower triangle only), the rest O's.
struct Tile {
  int r0, c0;
  bool on;
};

// out[r][c] = src[r][c] - sum_{k < kn} A[r][k] A[c][k] over the tile's
// elements with r < rlim, cmin <= c < d, and r >= c where r < d (rows of
// out and A are ld apart, those of src sld). A tile with no such element
// returns at once.
template <typename T>
__device__ __forceinline__ void tile_update(T* out, const T* src, int sld, const T* A, int ld, int kn,
                                            const Tile& tl, int cmin, int rlim, int d) {
  const int rl = tl.r0 + kTile - 1;  // the tile's last row
  if (!tl.on || tl.r0 >= rlim || tl.c0 + kTile - 1 < cmin || (rl < d && (rl < tl.c0 || rl < cmin)))
    return;
  int ro[kTile], co[kTile];
#pragma unroll
  for (int i = 0; i < kTile; ++i) {
    ro[i] = min(tl.r0 + i, rlim - 1) * ld;  // clamped: a row past the edge reads a real one
    co[i] = min(tl.c0 + i, d - 1) * ld;
  }
  T acc[kTile][kTile];
#pragma unroll
  for (int i = 0; i < kTile; ++i)
#pragma unroll
    for (int j = 0; j < kTile; ++j) acc[i][j] = T(0);
#pragma unroll 8
  for (int k = 0; k < kn; ++k) {
    T a[kTile], b[kTile];
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      a[i] = A[ro[i] + k];
      b[i] = A[co[i] + k];
    }
#pragma unroll
    for (int i = 0; i < kTile; ++i)
#pragma unroll
      for (int j = 0; j < kTile; ++j) acc[i][j] += a[i] * b[j];
  }
#pragma unroll
  for (int i = 0; i < kTile; ++i) {
    const int r = tl.r0 + i;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const int c = tl.c0 + j;
      if (r < rlim && c < d && c >= cmin && (r >= d || r >= c)) out[r * ld + c] = src[r * sld + c] - acc[i][j];
    }
  }
}

// One block per lane. Shared memory: the stacked panel P = [S_t ; O_t],
// 2d rows of ld = d + 1 entries, and a staging area where D_{t+1} and
// O_{t+1} land row-major, as in device memory (in 16-byte pieces where
// `vec`), while stage t computes. S_t goes from the staging into P's top
// rows and becomes L_t in place (its lower triangle); O_t goes to the
// bottom rows and becomes M_t' in place, row c holding column c of M_t,
// which is the carry the next stage's Schur update reads.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    factor_stream_kernel(const T* __restrict__ D, const T* __restrict__ O, T* __restrict__ L,
                         T* __restrict__ M, int T_, int d, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = d + 1;
  const int blk = d * d;
  T* const P = reinterpret_cast<T*>(smem_raw);
  T* const stg = P + 2 * d * ld;  // D_t, then O_t
  T* const Ld = stg + 2 * blk;     // L_t's 8 x 8 diagonal blocks, panel by panel
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nw = nt >> 5;
  const long long lane_id = blockIdx.x;
  const long long dd = static_cast<long long>(d) * d;
  const T* Dl = D + lane_id * T_ * dd;
  const T* Ol = O + lane_id * (T_ - 1) * dd;
  T* Ll = L + lane_id * T_ * dd;
  T* Ml = M + lane_id * (T_ - 1) * dd;

  // this thread's output tiles. A warp takes blocks of 8 x 4 tiles (32
  // rows, 16 columns; lane -> row tile lane & 7, column tile lane >> 3),
  // so a warp's loads of A's rows hit 8 rows ld apart (distinct banks for
  // an odd ld) and 4 columns (broadcasts). Blocks above S's diagonal are
  // skipped; the rest go to the warps in turn, the last columns' first, so
  // the warps' second blocks are ones the trailing updates leave early.
  Tile tiles[kTilesPerThread];
#pragma unroll
  for (int q = 0; q < kTilesPerThread; ++q) tiles[q] = Tile{0, 0, false};
  {
    const int nrt = (2 * d + kTile - 1) / kTile, nct = (d + kTile - 1) / kTile;
    const int rt = lane & 7, ct = lane >> 3;
    int blk_id = 0;
    for (int cb = (nct - 1) >> 2; cb >= 0; --cb) {
      for (int rb = 0; rb <= (nrt - 1) >> 3; ++rb) {
        if (32 * rb + 31 < 16 * cb) continue;  // above S's diagonal
        const int r = 8 * rb + rt, c = 4 * cb + ct;
#pragma unroll
        for (int q = 0; q < kTilesPerThread; ++q)
          if (blk_id == warp + q * nw) tiles[q] = Tile{r * kTile, c * kTile, r < nrt && c < nct};
        ++blk_id;
      }
    }
  }

  copy_flat_async(stg, Dl, blk, vec);
  if (T_ > 1) copy_flat_async(stg + blk, Ol, blk, vec);
  __pipeline_commit();

  int t = 0;
  bool ok = true;
  for (; t < T_; ++t) {
    const int nrow = t < T_ - 1 ? 2 * d : d;  // the last stage has no O
    __pipeline_wait_prior(0);
    __syncthreads();  // stage t's blocks have landed, from every thread's copies

    // S_t = D_t - M_{t-1}' M_{t-1}, lower triangle, into P's top rows: rows
    // i and j of P's bottom rows are columns i and j of M_{t-1}
#pragma unroll
    for (int q = 0; q < kTilesPerThread; ++q)
      tile_update(P, stg, d, P + d * ld, ld, t > 0 ? d : 0, tiles[q], 0, d, d);
    __syncthreads();  // the carry is consumed
    if (t < T_ - 1)
      for (int i = warp; i < d; i += nw)
        for (int j = lane; j < d; j += 32) P[(d + i) * ld + j] = stg[blk + i * d + j];
    __syncthreads();  // the staging is consumed: it takes stage t+1
    if (t + 1 < T_) {
      copy_flat_async(stg, Dl + (t + 1) * dd, blk, vec);
      if (t + 1 < T_ - 1) copy_flat_async(stg + blk, Ol + (t + 1) * dd, blk, vec);
    }
    __pipeline_commit();

    for (int j0 = 0; j0 < d; j0 += kPanel) {
      const int w = min(kPanel, d - j0);
      {
        // every thread factors the panel's 8 x 8 diagonal block in
        // registers (a ragged last panel padded with identity rows and
        // columns, which decouple) and keeps it apart in Ld, then solves
        // one row below it, row j0 + w + tid of the strip: no shuffle, and
        // every thread sees the same pivots, so a failure needs no flag
        T a[kPanel][kPanel];
#pragma unroll
        for (int i = 0; i < kPanel; ++i)
#pragma unroll
          for (int k = 0; k <= i; ++k)
            a[i][k] = i < w ? P[(j0 + i) * ld + j0 + k] : T(i == k ? 1 : 0);
        const int r = j0 + w + tid;
        const bool has_row = r < nrow;
        T v[kPanel];
#pragma unroll
        for (int k = 0; k < kPanel; ++k) v[k] = (has_row && k < w) ? P[r * ld + j0 + k] : T(0);
        bool bad = false;
#pragma unroll
        for (int k = 0; k < kPanel; ++k) {
          const T piv = a[k][k];
          bad |= !(piv > T(0) && piv - piv == T(0));  // not positive, or not finite
          a[k][k] = sqrt(piv);  // correctly rounded, as the divisions below
#pragma unroll
          for (int i = k + 1; i < kPanel; ++i) a[i][k] /= a[k][k];
#pragma unroll
          for (int i = k + 1; i < kPanel; ++i)
#pragma unroll
            for (int m = k + 1; m <= i; ++m) a[i][m] -= a[i][k] * a[m][k];
        }
        if (bad) {
          ok = false;
          break;
        }
#pragma unroll
        for (int k = 0; k < kPanel; ++k) {
          v[k] /= a[k][k];
#pragma unroll
          for (int m = k + 1; m < kPanel; ++m) v[m] -= v[k] * a[m][k];
        }
        if (tid == 0) {
          T* Lp = Ld + j0 * kPanel;
#pragma unroll
          for (int i = 0; i < kPanel; ++i)
#pragma unroll
            for (int k = 0; k <= i; ++k) Lp[i * kPanel + k] = a[i][k];
        }
        if (has_row) {
#pragma unroll
          for (int k = 0; k < kPanel; ++k)
            if (k < w) P[r * ld + j0 + k] = v[k];
        }
      }
      __syncthreads();  // the panel's rows are in place
      const int jt = j0 + kPanel;
      if (jt < d) {
        // rank-8 update of the trailing columns from the panel's columns
#pragma unroll
        for (int q = 0; q < kTilesPerThread; ++q)
          tile_update(P, P, ld, P + j0, ld, kPanel, tiles[q], jt, nrow, d);
        __syncthreads();
      }
    }
    if (!ok) break;

    // L_t: the panels' diagonal blocks from Ld, the rest from P
    T* Lt = Ll + t * dd;
    for (int i = warp; i < d; i += nw) {
      const int p0 = i & ~(kPanel - 1);
      for (int j = lane; j < d; j += 32)
        Lt[i * d + j] = j > i ? T(0) : j >= p0 ? Ld[p0 * kPanel + (i - p0) * kPanel + j - p0] : P[i * ld + j];
    }
    if (t < T_ - 1) {
      T* Mt = Ml + t * dd;
      for (int i = warp; i < d; i += nw)
        for (int j = lane; j < d; j += 32) Mt[i * d + j] = P[(d + j) * ld + i];
    }
  }

  // a stage that is not positive definite: NaN over the lower triangle of
  // L_t and of every later L, and over every M from M_t on
  if (!ok) {
    const T nan = quiet_nan<T>();
    for (int s = t; s < T_; ++s) {
      T* Ls = Ll + s * dd;
      for (int i = warp; i < d; i += nw)
        for (int j = lane; j < d; j += 32) Ls[i * d + j] = j > i ? T(0) : nan;
      if (s < T_ - 1) {
        T* Ms = Ml + s * dd;
        for (int i = warp; i < d; i += nw)
          for (int j = lane; j < d; j += 32) Ms[i * d + j] = nan;
      }
    }
  }
  __pipeline_wait_prior(0);  // no copy may still be landing when the block exits
}

// Forward sweep, one warp per right-hand-side column: block (lane, chunk
// of <= 32 columns), warp w the chunk's column w (a warp past K only helps
// with the copies), stages in ascending order; the mirror of the backward
// sweep below. Shared memory: Lb[2] (L_t) and Mb[2] (M_{t-1}), each d x d
// row-major as in device memory (so a stage's blocks land in 16-byte
// pieces), then one column of d entries per warp (u_{t-1} for the
// coupling). Slot t & 1 holds stage t's L_t and M_{t-1}.
template <typename T>
__global__ void __launch_bounds__(kMaxCols * 32)
    solve_fwd_stream_kernel(const T* __restrict__ L, const T* __restrict__ M,
                            const T* __restrict__ bv, T* __restrict__ u, int T_, int d, int K,
                            int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int blk = d * d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.y * kMaxCols + warp;  // this warp's column
  const bool has_col = c < K;                  // uniform over the warp
  T* const Lb = reinterpret_cast<T*>(smem_raw);  // slots by offset, as in the factor
  T* const Mb = Lb + 2 * blk;
  T* const ub = Lb + 4 * blk + warp * d;
  const long long lane_id = blockIdx.x;
  const long long dk = static_cast<long long>(d) * K;
  const T* Ll = L + lane_id * T_ * blk;
  const T* Ml = M + lane_id * (T_ - 1) * blk;
  const T* bl = bv + lane_id * T_ * dk + c;
  T* ul = u + lane_id * T_ * dk + c;
  // this thread's rows lane and lane + 32, clamped to a real row to read
  const int i0 = lane, i1 = lane + 32;
  const bool h0 = i0 < d, h1 = i1 < d;
  const int c0 = min(i0, d - 1), c1 = min(i1, d - 1);
  const int m0 = c0 * d, m1 = c1 * d;

  copy_flat_async(Lb, Ll, blk, vec);
  __pipeline_commit();
  T r0 = T(0), r1 = T(0);  // b_t, then r, then u_t
  if (has_col) {
    if (h0) r0 = bl[i0 * K];
    if (h1) r1 = bl[i1 * K];
  }
  T p0 = T(0), p1 = T(0);  // u_{t-1}

  for (int t = 0; t < T_; ++t) {
    const int s = t & 1;
    const T* Ls = Lb + s * blk;
    const T* Ms = Mb + s * blk;
    __pipeline_wait_prior(0);
    __syncthreads();  // L_t and M_{t-1} have landed; every warp is done with stage t-1's slot
    if (t + 1 < T_) {
      copy_flat_async(Lb + (1 - s) * blk, Ll + (t + 1) * blk, blk, vec);
      copy_flat_async(Mb + (1 - s) * blk, Ml + t * blk, blk, vec);
    }
    __pipeline_commit();
    T n0 = T(0), n1 = T(0);  // b_{t+1}, loaded under this stage's work
    if (has_col && t + 1 < T_) {
      if (h0) n0 = bl[(t + 1) * dk + i0 * K];
      if (h1) n1 = bl[(t + 1) * dk + i1 * K];
    }
    if (has_col) {
      // r = b_t - M_{t-1}' u_{t-1}: row i takes column i of M_{t-1}, so the
      // lanes read consecutive words
      if (t > 0) {
        if (h0) ub[i0] = p0;
        if (h1) ub[i1] = p1;
        __syncwarp();
        T a0 = T(0), a1 = T(0);
#pragma unroll 8
        for (int k = 0; k < d; ++k) {
          const T v = ub[k];
          a0 += Ms[k * d + c0] * v;
          a1 += Ms[k * d + c1] * v;
        }
        r0 -= a0;
        r1 -= a1;
      }
      // L_t u_t = r from the top: pivot j's owner (lane j & 31) scales its
      // row by 1 / L_jj, the shuffle broadcasts u_j, and the rows below it
      // take column j of L_t, whose entries each thread loads a step ahead
      const T inv0 = h0 ? T(1) / Ls[m0 + i0] : T(0);
      const T inv1 = h1 ? T(1) / Ls[m1 + i1] : T(0);
      T l0 = Ls[m0], l1 = Ls[m1];
      const int dl = min(d, 32);
      for (int j = 0; j < dl; ++j) {
        const int jn = min(j + 1, d - 1);
        const T n0l = Ls[m0 + jn], n1l = Ls[m1 + jn];
        const T uj = __shfl_sync(kFull, r0 * inv0, j);
        if (i0 == j)
          r0 = uj;
        else if (i0 > j)
          r0 -= l0 * uj;
        r1 -= l1 * uj;
        l0 = n0l;
        l1 = n1l;
      }
      for (int j = 32; j < d; ++j) {
        const int jn = min(j + 1, d - 1);
        const T n1l = Ls[m1 + jn];
        const T uj = __shfl_sync(kFull, r1 * inv1, j - 32);
        if (i1 == j)
          r1 = uj;
        else if (i1 > j)
          r1 -= l1 * uj;
        l1 = n1l;
      }
      T* ut = ul + t * dk;
      if (h0) ut[i0 * K] = r0;
      if (h1) ut[i1 * K] = r1;
      p0 = r0;
      p1 = r1;
      r0 = n0;
      r1 = n1;
    }
  }
  __pipeline_wait_prior(0);
}

// Backward sweep from u, one warp per right-hand-side column, stages in
// descending order; shared memory as in the forward sweep, with M_t beside
// L_t and x_{t+1} in the warp's column.
template <typename T>
__global__ void __launch_bounds__(kMaxCols * 32)
    solve_bwd_stream_kernel(const T* __restrict__ L, const T* __restrict__ M,
                            const T* __restrict__ u, T* __restrict__ x, int T_, int d, int K,
                            int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int blk = d * d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.y * kMaxCols + warp;  // this warp's column
  const bool has_col = c < K;                  // uniform over the warp
  T* const Lb = reinterpret_cast<T*>(smem_raw);  // slots by offset, as in the factor
  T* const Mb = Lb + 2 * blk;
  T* const xb = Lb + 4 * blk + warp * d;
  const long long lane_id = blockIdx.x;
  const long long dk = static_cast<long long>(d) * K;
  const T* Ll = L + lane_id * T_ * blk;
  const T* Ml = M + lane_id * (T_ - 1) * blk;
  const T* ul = u + lane_id * T_ * dk + c;
  T* xl = x + lane_id * T_ * dk + c;
  // this thread's rows lane and lane + 32, clamped to a real row to read
  const int i0 = lane, i1 = lane + 32;
  const bool h0 = i0 < d, h1 = i1 < d;
  const int c0 = min(i0, d - 1), c1 = min(i1, d - 1);
  const int m0 = c0 * d, m1 = c1 * d;
  // the coupling walks row i of M_t from column i on (wrapping), so that
  // the lanes' reads fall in distinct banks when d is even; from column 0
  // when d is odd, where the row stride alone does that
  const int k0 = (d & 1) ? 0 : c0, k1 = (d & 1) ? 0 : c1;

  copy_flat_async(Lb, Ll + (T_ - 1) * blk, blk, vec);
  __pipeline_commit();
  T r0 = T(0), r1 = T(0);  // u_t, then r, then x_t
  if (has_col) {
    if (h0) r0 = ul[(T_ - 1) * dk + i0 * K];
    if (h1) r1 = ul[(T_ - 1) * dk + i1 * K];
  }
  T x0 = T(0), x1 = T(0);  // x_{t+1}

  for (int it = 0; it < T_; ++it) {
    const int t = T_ - 1 - it;
    const int s = it & 1;
    const T* Ls = Lb + s * blk;
    const T* Ms = Mb + s * blk;
    __pipeline_wait_prior(0);
    __syncthreads();  // L_t and M_t have landed; every warp is done with stage t+1's slot
    if (t > 0) {
      copy_flat_async(Lb + (1 - s) * blk, Ll + (t - 1) * blk, blk, vec);
      copy_flat_async(Mb + (1 - s) * blk, Ml + (t - 1) * blk, blk, vec);
    }
    __pipeline_commit();
    T n0 = T(0), n1 = T(0);  // u_{t-1}, loaded under this stage's work
    if (has_col && t > 0) {
      if (h0) n0 = ul[(t - 1) * dk + i0 * K];
      if (h1) n1 = ul[(t - 1) * dk + i1 * K];
    }
    if (has_col) {
      // r = u_t - M_t x_{t+1}
      if (t < T_ - 1) {
        if (h0) xb[i0] = x0;
        if (h1) xb[i1] = x1;
        __syncwarp();
        T a0 = T(0), a1 = T(0);
        int ka = k0, kb = k1;
#pragma unroll 8
        for (int k = 0; k < d; ++k) {
          a0 += Ms[m0 + ka] * xb[ka];
          a1 += Ms[m1 + kb] * xb[kb];
          ka = ka + 1 == d ? 0 : ka + 1;
          kb = kb + 1 == d ? 0 : kb + 1;
        }
        r0 -= a0;
        r1 -= a1;
      }
      // L_t' x_t = r from the bottom: pivot j's owner (lane j & 31) scales
      // its row by 1 / L_jj, the shuffle broadcasts x_j, and the rows above
      // it take row j of L_t, whose entries each thread loads a step ahead
      const T inv0 = h0 ? T(1) / Ls[m0 + i0] : T(0);
      const T inv1 = h1 ? T(1) / Ls[m1 + i1] : T(0);
      T l0 = Ls[(d - 1) * d + c0], l1 = Ls[(d - 1) * d + c1];
      for (int j = d - 1; j >= 32; --j) {
        const T n0 = Ls[(j - 1) * d + c0], n1 = Ls[(j - 1) * d + c1];
        const T xj = __shfl_sync(kFull, r1 * inv1, j - 32);
        if (i1 == j)
          r1 = xj;
        else if (i1 < j)
          r1 -= l1 * xj;
        r0 -= l0 * xj;
        l0 = n0;
        l1 = n1;
      }
      for (int j = min(d, 32) - 1; j >= 0; --j) {
        const T n0 = j > 0 ? Ls[(j - 1) * d + c0] : T(0);
        const T xj = __shfl_sync(kFull, r0 * inv0, j);
        if (i0 == j)
          r0 = xj;
        else if (i0 < j)
          r0 -= l0 * xj;
        l0 = n0;
      }
      T* xt = xl + t * dk;
      if (h0) xt[i0 * K] = r0;
      if (h1) xt[i1 * K] = r1;
      x0 = r0;
      x1 = r1;
      r0 = n0;
      r1 = n1;
    }
  }
  __pipeline_wait_prior(0);
}

// ---- d past 64: the wide factor and sweeps ---------------------------

// The wide factor's shared memory at d: the stacked panel, 2d rows of
// wide::panel_ld(d, vec) words, and the failure flag
template <typename T>
__host__ __device__ constexpr size_t factor_wide_smem(int d, bool vec) {
  return sizeof(T) * 2 * static_cast<size_t>(d) * wide::panel_ld<T>(d, vec) + wide::kFlagBytes;
}

// The widest stage the wide factor takes: the largest d whose shared
// memory fits a block's 227 KB, the limit of the stream kernels
// (ops/cuda_riccati.MAX_D), with 16-byte loads (vec) to float32 d = 168
// (231,184 B) and float64 d = 119 (232,304 B), with scalar loads past
// them: float32 d <= 169 (228,504 B; 170 takes 232,576 B), float64 d <=
// 120 (232,336 B; 121 takes 234,272 B)
template <typename T>
__host__ __device__ constexpr int wide_max_d(bool vec = false) {
  int d = kMaxD;
  while (factor_wide_smem<T>(d + 1, vec) <= kMaxSmem) ++d;
  return d;
}
static_assert(wide_max_d<float>() == 169 && wide_max_d<double>() == 120, "cuda_riccati.MAX_D");
static_assert(wide_max_d<float>(true) == 168 && wide_max_d<double>(true) == 119, "the 16-byte plan's edge");

static_assert(wide_max_d<float>() <= 32 * 6 && wide_max_d<double>() <= 32 * 4, "the sweeps' diagonal blocks");

// factor_stream past d = 64: one block a lane (wide::Threads: 12 warps in
// float32, 8 in float64), each stage wide::factor_stage on the stacked
// panel [S_t ; O_t] in shared memory (riccati_wide.cuh: D_t and O_t read
// from device memory where the Schur update and the first updates consume
// them, no staging copy; 32-column blocks of 8-wide panels; the products
// dealt to the warps anew for each update), its rows 16-byte aligned where
// that fits (kVec: to d = 168 / 119). Then L_t out (thread 0 wrote its
// diagonal blocks), M_t out from the bottom rows (row c of them is column
// c of M_t: a warp's reads are ld apart, distinct banks for an odd ld, a
// 4-way conflict for the 16-byte plan's), one barrier. A stage that is
// not positive definite: NaN as factor_stream_kernel.
template <typename T, bool kVec>
__global__ void __launch_bounds__(wide::Threads<T>::value, 1)
    factor_stream_wide_kernel(const T* __restrict__ D, const T* __restrict__ O, T* __restrict__ L,
                              T* __restrict__ M, int T_, int d, unsigned long long* parts) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = wide::panel_ld<T>(d, kVec);
  T* const P = reinterpret_cast<T*>(smem_raw);
  int* const flag = reinterpret_cast<int*>(P + 2 * d * ld);
  if (kVec) wide::zero_padding(P, 2 * d, ld, d);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const long long lane_id = blockIdx.x;
  const long long dd = static_cast<long long>(d) * d;
  const T* Dl = D + lane_id * T_ * dd;
  const T* Ol = O + lane_id * (T_ - 1) * dd;
  T* Ll = L + lane_id * T_ * dd;
  T* Ml = M + lane_id * (T_ - 1) * dd;

  wide::Stamps stamp{parts, clock64()};
  int t = 0;
  bool ok = true;
  for (; t < T_; ++t) {
    const int nO = t < T_ - 1 ? d : 0;  // the last stage has no O
    T* const Lt = Ll + t * dd;
    const wide::Inputs<T> in{Dl + t * dd, Ol + t * dd, nullptr, 1, d, 1};
    if (!wide::factor_stage<kVec, T>(P, nullptr, flag, ld, d, nO, 0, t > 0, in, Lt, d, stamp)) {
      ok = false;
      break;
    }
    // L_t: zeros above the diagonal, the rest from P but the diagonal
    // blocks' lower triangles, which thread 0 wrote
    for (int i = warp; i < d; i += nw) {
      const int p0 = i & ~(wide::kPanel - 1);
      for (int j = lane; j < d; j += 32)
        if (j > i || j < p0) Lt[i * d + j] = j > i ? T(0) : P[i * ld + j];
    }
    if (nO > 0) {
      T* const Mt = Ml + t * dd;
      for (int i = warp; i < d; i += nw)
        for (int j = lane; j < d; j += 32) Mt[i * d + j] = P[(d + j) * ld + i];
    }
    __syncthreads();  // L_t and M_t are out: the next Schur update takes the top rows
    stamp(3);
  }

  if (!ok) {
    const T nan = quiet_nan<T>();
    for (int s = t; s < T_; ++s) {
      T* Ls = Ll + s * dd;
      for (int i = warp; i < d; i += nw)
        for (int j = lane; j < d; j += 32) Ls[i * d + j] = j > i ? T(0) : nan;
      if (s < T_ - 1) {
        T* Ms = Ml + s * dd;
        for (int i = warp; i < d; i += nw)
          for (int j = lane; j < d; j += 32) Ms[i * d + j] = nan;
      }
    }
  }
}

// The wide sweeps (d past 64): a block of kSweepWarps(NB) = 2 NB warps a
// lane and a chunk of up to that many right-hand-side columns, NB =
// ceil(d / 32) the diagonal blocks of a stage (3..6 in float32, 3..4 in
// float64: only the instances a dtype's MAX_D reaches are built). A stage
// is a blocked substitution over its 32-row diagonal blocks, q = 0..NB-1
// forward, NB-1..0 backward (rows 32 q.., the last one ragged, padded with
// identity rows). Each block takes two parts and a barrier after each:
//  1. warp c (c < the chunk's columns) solves column c's diagonal block
//     from registers: lane i holds row i, pivot j's owner scales its row by
//     1 / l_jj (each lane's reciprocal computed once, off the chain), a
//     shuffle broadcasts the value, the other rows take column j
//     (forward) or row j (backward) of the block from shared memory, one
//     register a lane and no loop over rows; the column's values go out.
//     (On an NVIDIA H100 80GB HBM3 at 700 W a pivot step costs ~75 cycles
//     in float32; forming l_ij / l_jj off the chain, so that a step is a
//     shuffle and a multiply-add, made float32 slower and float64 ~10%
//     faster: PERF.md, section 6.)
//     Meanwhile every warp has issued the loads of its tile (below) into
//     registers, and the warps without a column put the next stage's
//     right-hand side in place (in a stage's first block);
//  2. every warp consumes its tile with the block's solution: the next
//     diagonal block into shared memory (lower triangle, identity past d),
//     the block's columns off the rows still to solve, or its share of the
//     coupling into the next stage's right-hand side, accumulated block by
//     block as the solution comes, so that the next stage starts with it
//     done. A tile is 32 x 32 words of L_t or M read coalesced: a row tile
//     (lane along a row of the block, 32 rows; lane l ends with row l's sum
//     by a butterfly of 31 shuffles) for the forward update (rows i >= j1
//     of L_t, columns of the block) and the backward coupling (rows of
//     M_{t-1}); a column tile (lane l reads column l of 32 rows, a word a
//     row, and sums its own) for the backward update (rows j of L_t in the
//     block, columns i < j0) and the forward coupling (rows of M_t in the
//     block). The widest block has 1 + (NB - 1) + NB = 2 NB tiles, one a
//     warp, so nothing waits for a second round of loads.
// Nothing is staged a stage ahead and no copy's wait is exposed: a tile's
// loads fly under the diagonal solve, and the diagonal blocks are the only
// shared copies of L. Shared memory: the two diagonal blocks (rows kLdb
// apart: a lane's row or column reads fall in distinct banks) and two
// right-hand sides of 2 NB columns of 32 NB rows (rows past d zero, never
// written): 26.9 KB at NB = 6 in float32, 33.3 KB at NB = 4 in float64.
constexpr int kBlk = 32;        // rows a diagonal block
constexpr int kLdb = kBlk + 1;  // a staged diagonal block's row stride

template <int NB>
__host__ __device__ constexpr int sweep_warps() {
  return 2 * NB;
}

template <typename T, int NB>
__host__ __device__ constexpr size_t sweep_wide_smem() {
  return sizeof(T) * (2 * kBlk * kLdb + 2 * sweep_warps<NB>() * kBlk * NB);
}
static_assert(sweep_wide_smem<float, 6>() <= kDefaultSmem && sweep_wide_smem<double, 4>() <= kDefaultSmem,
              "the wide sweeps need no raised shared-memory limit");

// One level of row_sums: lanes with bit S keep the upper S of w's first 2S
// terms and take their partner's (lane ^ S) upper S, the others the lower
template <int S, typename T>
__device__ __forceinline__ void fold(T (&w)[kBlk], bool up) {
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const T send = up ? w[k] : w[k + S];
    const T keep = up ? w[k + S] : w[k];
    w[k] = keep + __shfl_xor_sync(kFull, send, S);
  }
}

// Lane l's share of 32 rows' sums: w[r] holds lane l's term of row r; after
// 16 + 8 + 4 + 2 + 1 shuffles lane l holds the sum over the lanes of row l
// (each level's index compile-time, so that w stays in registers)
template <typename T>
__device__ __forceinline__ T row_sums(T (&w)[kBlk], int lane) {
  fold<16>(w, lane & 16);
  fold<8>(w, lane & 8);
  fold<4>(w, lane & 4);
  fold<2>(w, lane & 2);
  fold<1>(w, lane & 1);
  return w[0];
}

// A warp's tile in a block of the sweeps
enum TileKind { kNoTile, kDiagTile, kRowTile, kColTile };

template <bool kFwd, typename T, int NB>
__device__ __forceinline__ void sweep_wide(const T* __restrict__ L, const T* __restrict__ M,
                                           const T* __restrict__ in, T* __restrict__ out, int T_, int d, int K) {
  constexpr int NW = sweep_warps<NB>();
  constexpr int ldr = kBlk * NB;  // a right-hand-side column's rows in shared memory
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nt = blockDim.x;
  const int c0 = blockIdx.y * NW;    // the chunk's first column
  const int KC = min(NW, K - c0);    // its columns, one a warp
  const int first = KC < NW ? 32 * KC : 0;  // the threads that place the next right-hand side
  T* const Lb = reinterpret_cast<T*>(smem_raw);  // slot s: the block solved next, slot s ^ 1 staged
  T* rc = Lb + 2 * kBlk * kLdb;                  // the stage's right-hand side, solved in place
  T* rn = rc + NW * ldr;                         // the next stage's
  const long long lane_id = blockIdx.x;
  const long long dd = static_cast<long long>(d) * d, dk = static_cast<long long>(d) * K;
  const T* const Ll = L + lane_id * T_ * dd;
  const T* const Ml = M + lane_id * (T_ - 1) * dd;
  const T* const il = in + lane_id * T_ * dk + c0;
  T* const ol = out + lane_id * T_ * dk + c0;
  const int t_first = kFwd ? 0 : T_ - 1, q_first = kFwd ? 0 : NB - 1;

  // the first stage's right-hand side and first diagonal block; rows past d zero
  for (int c = 0; c < NW; ++c)
    for (int i = threadIdx.x; i < ldr; i += nt) {
      rc[c * ldr + i] = c < KC && i < d ? il[t_first * dk + i * K + c] : T(0);
      rn[c * ldr + i] = T(0);
    }
  for (int e = threadIdx.x; e < kBlk * kBlk; e += nt) {
    const int rr = e >> 5, l = e & 31, i = kBlk * q_first + rr;
    Lb[rr * kLdb + l] = l <= rr && i < d ? Ll[t_first * dd + i * d + kBlk * q_first + l] : T(l == rr ? 1 : 0);
  }
  __syncthreads();

  int s = 0;
  for (int it = 0; it < T_; ++it) {
    const int t = kFwd ? it : T_ - 1 - it;
    const bool couple = it + 1 < T_;  // a next stage to couple into
    const T* const Lt = Ll + t * dd;
    // forward: M_t (r_{t+1} = b_{t+1} - M_t' u_t); backward: M_{t-1} (r_{t-1} = u_{t-1} - M_{t-1} x_t)
    const T* const Mc = Ml + (kFwd ? t : t - 1) * dd;
    for (int qq = 0; qq < NB; ++qq) {
      const int q = kFwd ? qq : NB - 1 - qq;
      const int j0 = kBlk * q;
      const bool has_next = qq + 1 < NB || couple;
      const int n_upd = NB - 1 - qq;  // the diagonal blocks still to solve in this stage

      // this warp's tile: the next diagonal block, an update of rows still
      // to solve (the block's row group g), or a share of the coupling
      int kind = kNoTile, g = 0;
      bool coupling = false;
      {
        const int k = NW - 1 - warp - (has_next ? 1 : 0);
        if (k == -1) {
          kind = kDiagTile;
        } else if (k >= 0 && k < n_upd) {
          kind = kFwd ? kRowTile : kColTile;
          g = kFwd ? q + 1 + k : k;
        } else if (k >= n_upd && couple && k - n_upd < NB) {
          kind = kFwd ? kColTile : kRowTile;
          g = k - n_upd;
          coupling = true;
        }
      }
      const T* A = coupling ? Mc : Lt;  // the tile's matrix: rows of A are d apart
      int i0 = kBlk * g;
      if (kind == kDiagTile) {
        const bool same = kFwd ? q + 1 < NB : q > 0;  // the next block is in this stage
        i0 = kBlk * (same ? (kFwd ? q + 1 : q - 1) : q_first);
        A = (same ? Lt : Ll + (kFwd ? t + 1 : t - 1) * dd) + i0 * d + i0;
      }
      T val[kBlk];
      if (kind == kDiagTile) {
#pragma unroll
        for (int r = 0; r < kBlk; ++r) val[r] = lane <= r && i0 + r < d ? A[r * d + lane] : T(lane == r ? 1 : 0);
      } else if (kind == kRowTile) {  // rows i0 + r, the block's columns
#pragma unroll
        for (int r = 0; r < kBlk; ++r) val[r] = i0 + r < d && j0 + lane < d ? A[(i0 + r) * d + j0 + lane] : T(0);
      } else if (kind == kColTile) {  // the block's rows j0 + r, columns i0 + lane
#pragma unroll
        for (int r = 0; r < kBlk; ++r) val[r] = j0 + r < d && i0 + lane < d ? A[(j0 + r) * d + i0 + lane] : T(0);
      }

      if (warp < KC) {
        // column warp's diagonal block, from registers
        const T* const Lq = Lb + s * kBlk * kLdb;
        T* const rq = rc + warp * ldr + j0;
        const bool own = j0 + lane < d;
        T v = rq[lane];
        const T inv = T(1) / Lq[lane * kLdb + lane];
        if (kFwd) {
#pragma unroll
          for (int jj = 0; jj < kBlk; ++jj) {
            const T l = Lq[lane * kLdb + jj];  // row lane, column jj
            const T uj = __shfl_sync(kFull, v * inv, jj);
            v = lane == jj ? uj : (lane > jj ? v - l * uj : v);
          }
        } else {
#pragma unroll
          for (int jj = kBlk - 1; jj >= 0; --jj) {
            const T l = Lq[jj * kLdb + lane];  // row jj, column lane
            const T xj = __shfl_sync(kFull, v * inv, jj);
            v = lane == jj ? xj : (lane < jj ? v - l * xj : v);
          }
        }
        rq[lane] = own ? v : T(0);
        if (own) ol[t * dk + (j0 + lane) * K + warp] = v;
      }
      if (qq == 0 && couple && threadIdx.x >= first) {
        // the next stage's right-hand side, which the coupling tiles take from
        const int tn = kFwd ? t + 1 : t - 1;
        for (int c = 0; c < KC; ++c)
          for (int i = threadIdx.x - first; i < d; i += nt - first) rn[c * ldr + i] = il[tn * dk + i * K + c];
      }
      __syncthreads();  // the block's solution is in rc, the next right-hand side in rn

      if (kind == kDiagTile) {
        T* const Ln = Lb + (s ^ 1) * kBlk * kLdb;
#pragma unroll
        for (int r = 0; r < kBlk; ++r) Ln[r * kLdb + lane] = val[r];
      } else if (kind != kNoTile) {
        T* const dst = coupling ? rn : rc;
        for (int c = 0; c < KC; ++c) {
          const T* const uq = rc + c * ldr + j0;  // the block's solution (rows past d zero)
          T sum;
          if (kind == kRowTile) {
            const T ul = uq[lane];
            T w[kBlk];
#pragma unroll
            for (int r = 0; r < kBlk; ++r) w[r] = val[r] * ul;
            sum = row_sums(w, lane);
          } else {
            sum = T(0);
#pragma unroll
            for (int r = 0; r < kBlk; ++r) sum += val[r] * uq[r];
          }
          if (i0 + lane < d) dst[c * ldr + i0 + lane] -= sum;
        }
      }
      __syncthreads();  // the rows are updated, the next diagonal block staged
      s ^= 1;
    }
    T* const tmp = rc;  // the next stage's right-hand side is complete
    rc = rn;
    rn = tmp;
  }
}

template <typename T, int NB>
__global__ void __launch_bounds__(64 * NB, 1)
    solve_fwd_stream_wide_kernel(const T* __restrict__ L, const T* __restrict__ M,
                                 const T* __restrict__ bv, T* __restrict__ u, int T_, int d, int K) {
  sweep_wide<true, T, NB>(L, M, bv, u, T_, d, K);
}

template <typename T, int NB>
__global__ void __launch_bounds__(64 * NB, 1)
    solve_bwd_stream_wide_kernel(const T* __restrict__ L, const T* __restrict__ M,
                                 const T* __restrict__ u, T* __restrict__ x, int T_, int d, int K) {
  sweep_wide<false, T, NB>(L, M, u, x, T_, d, K);
}

// The widest stage the stream kernels take: kMaxD for the d <= 64 kernels,
// past it the wide factor's unstaged plan (ops/cuda_riccati.MAX_D)
template <typename T>
bool shape_ok(int B, int T_, int d, int K) {
  return B >= 0 && T_ >= 1 && d >= 1 && d <= wide_max_d<T>() && K >= 1;
}

bool aligned16(const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; }

// Raise the kernel's dynamic shared-memory limit when it needs more than
// the default 48 KB.
template <typename Kern>
cudaError_t allow_smem(Kern kernel, size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// parts: null, or 4 words that take factor_stream_wide_kernel's clock
// (wide::Stamps; d > 64 only)
template <typename T>
int factor_stream(const void* D, const void* O, void* L, void* M, int B, int T_, int d, void* stream,
                  void* parts = nullptr) {
  if (!shape_ok<T>(B, T_, d, 1)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const int vec = (sizeof(T) * d * d) % 16 == 0 && aligned16(D) && aligned16(O);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (parts != nullptr && d <= kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  if (d <= kMaxD) {
    const size_t smem = sizeof(T) * (2 * static_cast<size_t>(d) * (2 * d + 1) + kPanel * kMaxD);
    cudaError_t err = allow_smem(factor_stream_kernel<T>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    factor_stream_kernel<T><<<B, kThreads, smem, st>>>(static_cast<const T*>(D), static_cast<const T*>(O),
                                                       static_cast<T*>(L), static_cast<T*>(M), T_, d, vec);
  } else {
    const bool vec = d <= wide_max_d<T>(true);
    const auto kernel = vec ? factor_stream_wide_kernel<T, true> : factor_stream_wide_kernel<T, false>;
    const size_t smem = factor_wide_smem<T>(d, vec);
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<B, wide::Threads<T>::value, smem, st>>>(static_cast<const T*>(D), static_cast<const T*>(O),
                                                     static_cast<T*>(L), static_cast<T*>(M), T_, d,
                                                     static_cast<unsigned long long*>(parts));
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch a d <= 64 sweep kernel: grid (B, chunks of kMaxCols columns), a
// warp a column; the stage blocks land in 16-byte pieces where their size
// and the arrays' addresses allow it.
template <typename T, typename Kern>
int sweep(Kern kernel, const void* L, const void* M, const void* in, void* out, int B, int T_,
          int d, int K, void* stream) {
  const int warps = K < kMaxCols ? K : kMaxCols;
  const size_t smem = sizeof(T) * (4 * static_cast<size_t>(d) + warps) * d;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = (sizeof(T) * d * d) % 16 == 0 && aligned16(L) && aligned16(M);
  const dim3 grid(B, (K + kMaxCols - 1) / kMaxCols);
  kernel<<<grid, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(L), static_cast<const T*>(M), static_cast<const T*>(in),
      static_cast<T*>(out), T_, d, K, vec);
  return static_cast<int>(cudaGetLastError());
}

// The forward (kFwd) or backward wide sweep of NB diagonal blocks a stage:
// grid (B, chunks of 2 NB columns), 2 NB warps a block
template <bool kFwd, typename T, int NB>
int sweep_rows(const void* L, const void* M, const void* in, void* out, int B, int T_, int d, int K, void* stream) {
  constexpr int NW = sweep_warps<NB>();
  const dim3 grid(B, (K + NW - 1) / NW);
  const auto kernel = kFwd ? solve_fwd_stream_wide_kernel<T, NB> : solve_bwd_stream_wide_kernel<T, NB>;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<grid, 32 * NW, sweep_wide_smem<T, NB>(), st>>>(static_cast<const T*>(L), static_cast<const T*>(M),
                                                          static_cast<const T*>(in), static_cast<T*>(out), T_, d, K);
  return static_cast<int>(cudaGetLastError());
}

// A sweep at d: the d <= 64 kernel, else the wide instance of ceil(d / 32)
// diagonal blocks (up to 6 in float32, 4 in float64: only the instances a
// dtype's MAX_D reaches are built)
template <bool kFwd, typename T>
int sweep_at(const void* L, const void* M, const void* in, void* out, int B, int T_, int d, int K, void* stream) {
  if (!shape_ok<T>(B, T_, d, K)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  switch ((d + 31) / 32) {
    case 1:
    case 2:
      if constexpr (kFwd)
        return sweep<T>(solve_fwd_stream_kernel<T>, L, M, in, out, B, T_, d, K, stream);
      else
        return sweep<T>(solve_bwd_stream_kernel<T>, L, M, in, out, B, T_, d, K, stream);
    case 3:
      return sweep_rows<kFwd, T, 3>(L, M, in, out, B, T_, d, K, stream);
    case 4:
      return sweep_rows<kFwd, T, 4>(L, M, in, out, B, T_, d, K, stream);
  }
  if constexpr (sizeof(T) == 4) {
    if (d <= 160) return sweep_rows<kFwd, T, 5>(L, M, in, out, B, T_, d, K, stream);
    return sweep_rows<kFwd, T, 6>(L, M, in, out, B, T_, d, K, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int solve_fwd(const void* L, const void* M, const void* b, void* u, int B, int T_, int d, int K,
              void* stream) {
  return sweep_at<true, T>(L, M, b, u, B, T_, d, K, stream);
}

template <typename T>
int solve_bwd(const void* L, const void* M, const void* u, void* x, int B, int T_, int d, int K,
              void* stream) {
  return sweep_at<false, T>(L, M, u, x, B, T_, d, K, stream);
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

// factor_stream past d = 64 with its parts' clock summed over the lanes
// into parts (4 words of cycles: Schur updates, panels, trailing updates,
// stores; chip_smoke.py's split)
int calipso_factor_stream_parts_f32(const void* D, const void* O, void* L, void* M, int B, int T, int d,
                                    void* parts, void* stream) {
  return factor_stream<float>(D, O, L, M, B, T, d, stream, parts);
}

int calipso_factor_stream_parts_f64(const void* D, const void* O, void* L, void* M, int B, int T, int d,
                                    void* parts, void* stream) {
  return factor_stream<double>(D, O, L, M, B, T, d, stream, parts);
}

int calipso_solve_fwd_stream_f32(const void* L, const void* M, const void* b, void* u, int B,
                                 int T, int d, int K, void* stream) {
  return solve_fwd<float>(L, M, b, u, B, T, d, K, stream);
}

int calipso_solve_fwd_stream_f64(const void* L, const void* M, const void* b, void* u, int B,
                                 int T, int d, int K, void* stream) {
  return solve_fwd<double>(L, M, b, u, B, T, d, K, stream);
}

int calipso_solve_bwd_stream_f32(const void* L, const void* M, const void* u, void* x, int B,
                                 int T, int d, int K, void* stream) {
  return solve_bwd<float>(L, M, u, x, B, T, d, K, stream);
}

int calipso_solve_bwd_stream_f64(const void* L, const void* M, const void* u, void* x, int B,
                                 int T, int d, int K, void* stream) {
  return solve_bwd<double>(L, M, u, x, B, T, d, K, stream);
}

}  // extern "C"
