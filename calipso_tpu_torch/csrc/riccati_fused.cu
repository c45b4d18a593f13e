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
// Both entry points' wrappers take D (B, T, d, d), O (B, T-1, d, d) and b
// (B, T, d) and give x (B, T, d). A stage whose S_t is not positive definite (a pivot <= 0 or
// not finite) ends the lane: every entry of its x is written as NaN (what
// the plain version gives by propagation through both sweeps). The other
// lanes are untouched. Any d >= 1 and T >= 1 with T d (d + 1) < 2^31
// (shape_ok).
//
// Bound (H100 SXM: 3.35 TB/s HBM, 67 TFLOP/s float32; D read as its lower
// triangles): at the batched rocket's shape (B=1024, T=31, d=9, float32)
// the solve moves 18.0 MB (5.4 us) against 70 MFLOP (1.0 us), at the
// quadruped's (B=128, T=8, d=54) 17.0 MB (5.1 us) against 0.35 GFLOP
// (5.3 us): bound by memory traffic at the first and by operations at the
// second, in principle. In practice the stages and the pivots of a stage
// are a chain of dependent steps, and the designs keep that chain short.
//
// The TPU ran kernel 8 (fused) as one grid program per scenario with the
// horizon's L, M and u in VMEM scratch, and kernel 9 (lanes) with the
// batch on the 128-wide lane axis, (T, d, d, B) blocks, every scenario's
// sequence in lockstep on the vector unit. Here both are one kernel
// template with the address map as its parameter (kBatchLast): the
// batch-first arrays D (B, T, d, d), O (B, T-1, d, d), b and x (B, T, d)
// hold a lane's stages one after the other; the batch-last ones, D (T, d,
// d, B), O' (T-1, d, d, B) with O'_t = O_t' and b, x (T, d, B), which the
// lanes wrapper makes with permute(...).contiguous() as the reference's
// wrapper transposes outside its kernel, hold element e of a stage of
// every lane side by side, lane b's at e B + b. Only three things differ
// between the two: how a stage's blocks reach shared memory, how a
// thread reads its row of O_t (O_t's row c is O'_t's column c), and where
// x goes (and, in the workspace, u). The arithmetic, the kept rows, the
// shared-memory plans, the workspace rule and the NaN fill are the same
// device code.
//
// For d <= 32 (the rocket's d = 9; solve_batched_reg_kernel, templated
// widths 12, 16 and 32 as factor_lanes) one warp owns one lane and walks
// its horizon twice:
//  - forward, a stage as factor_lanes' register stage does it, with the
//    same device code (riccati_reg.cuh): thread i holds row i of S_t and
//    of O_t in registers, S_t = D_t - M_{t-1}' M_{t-1} is a Gram product
//    of the previous stage's o rows (gram_update), and one right-looking
//    Cholesky of the stacked panel [S_t ; O_t] gives L_t and M_t' together
//    (panel_pivots), a shuffle a pivot and a shuffle an l_jk, no barrier.
//    The forward sweep folds in: thread i's previous o row is column i of
//    M_{t-1}, so r_t = b_t - M_{t-1}' u_{t-1} is that row dotted with
//    u_{t-1} (broadcast 16-byte reads, four partial sums), and u_t =
//    L_t^{-1} r_t takes d shuffles from the register rows, with the
//    reciprocal pivots the factor already took. Each thread keeps its row
//    of L_t (1 / l_ii on the diagonal, zeros above it), its o row and u_t.
//    D_{t+1}, O_{t+1} and b_{t+1} land a few stages ahead in a ring of
//    shared-memory slots by cp.async. Batch-first, a stage's blocks are
//    copied flat as they lie in device memory (16-byte pieces where the
//    sizes and addresses allow it, at d = 9 element by element).
//    Batch-last, element e of a block is gathered from e B + b, element
//    by element, an index linear in e; the slot then holds O'_t flat, so
//    thread c reads its o row as column c of the slot, consecutive words
//    across the warp. A block's warps own consecutive lanes, so their
//    gathers share 32-byte sectors (8 float32 lanes each) in L1 and L2,
//    and device memory is read about once;
//  - backward, as solve_lanes' backward sweep: thread i reads column i of
//    L_t and row i of M_t (column i of the kept o rows) from the warp's
//    store, takes the coupling M_t x_{t+1} in four partial sums, and each
//    pivot is one multiply, one shuffle and one FMA.
// The kept rows are at a row stride of d rounded up to odd, so that the
// warp's row writes and column reads hit distinct banks. Where eight
// warps' shares of the horizon's L, M and u fit in a block's shared
// memory (a warp's (2T - 1) d (d|1) + T d words and its slots: 25 KB at
// (31, 9) in float32), D, O and b are read once, x is written once, and L
// and M never reach device memory; past that (float64 at (31, 9), d = 32
// at T = 31) L and M go to the workspace the caller allocates
// (calipso_solve_batched_fused_workspace says how many words a lane needs,
// the same for both layouts) and u_t to x, and the kernel's registers, not
// its shared memory, set how many warps an SM holds: float64 at (1024, 31,
// 9) took 0.220 ms on chip (4 warps an SM, two waves) and 0.154 in the
// workspace (one wave) on an H100, float32 0.0995 on chip and 0.118 in the
// workspace. No barrier, no division and no integer division runs in any
// loop; the failure test is warp-uniform. A block holds up to 4 warps,
// fewer where the batch would leave SMs idle.
//
// Past d = 32 (the quadruped's d = 54, and any width past it:
// solve_batched_fused_wide_kernel) one thread block owns one lane. Forward,
// each stage is the wide stage of riccati_wide.cuh, factor_stream's stage
// with one more row: the Cholesky of the stacked panel [S_t ; O_t ; r_t']
// gives L_t, M_t' and, as its last row, u_t' = r_t' L_t^{-T}, the forward
// sweep, with r_t = b_t - M_{t-1}' u_{t-1} the Schur update's last row;
// L_t and M_t' go to the workspace and u_t to x. Backward, x_t = L_t^{-T}
// (u_t - M_t x_{t+1}): the coupling a row a thread over M_t''s rows, then
// L_t' x_t = r in blocks of 32 rows from the bottom, warp 0 solving the
// diagonal block by shuffles from shared memory while the other warps
// stage the next block, then every thread taking the block's columns off
// the rows above; no barrier a pivot. The panel ((2d + 1) rows) lies in
// shared memory where it fits a block's opt-in limit (232,448 B on an
// H100: float32 to d = 169, float64 to 119, with 16-byte loads to 167 /
// 118), else in the lane's workspace. Past d = 64 the bound is the
// operations' (36 us at (32, 8, 165) in float32), but a lane's stages and
// the panels of a stage are a chain on one SM (PERF.md). Batch-last, the
// stage's inputs and x take the same address map, each element its own
// sector, which consecutive lanes' blocks share in L2.
//
// The lanes wrapper's layout moves (batch-first into batch-last, x back)
// are transpose_kernel's: 32 x 32 tiles through shared memory, one launch
// each way. torch's strided copies (permute(...).contiguous()) read or
// write one word a sector and took 0.050-0.093 ms for the four moves at
// the rocket's shape in float32 on an H100, a third to a half of the
// wrapper's time.
//
// Plain C interface, loaded with ctypes: every entry point launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include "riccati_reg.cuh"
#include "riccati_wide.cuh"

namespace {

constexpr long long kMaxIndex = 0x7fffffffLL;  // T d (d + 1) at most this (shape_ok)
constexpr int kMaxFusedWarps = 4;  // d <= 32: at most this many warps a block
// d <= 32: the horizon's factor stays on chip where this many warps
// can hold theirs in a block's shared memory (two blocks of 4 an SM: the
// rocket batch's 1024 lanes over 132 SMs in one wave)
constexpr int kOnChipWarps = 8;

// Words of a stage slot of solve_batched_reg_kernel: D_t, O_t (d x d each)
// and b_t, rounded to 16 bytes
template <typename T>
__host__ __device__ constexpr int fused_slot_words(int d) {
  return round16<T>(2 * d * d + d);
}

// Offset of lane b's first element in an array of `per_lane` elements a
// lane: batch-first arrays hold a lane's elements together, batch-last
// ones element e of every lane side by side, lane b's at e B + b (the
// lane's elements sB = B words apart)
template <bool kBatchLast>
__device__ __forceinline__ long long lane_offset(long long b, long long per_lane) {
  return kBatchLast ? b : b * per_lane;
}

// n elements `stride` words apart in device memory into n consecutive
// shared-memory words, element by element, by one warp; the caller
// commits the batch
template <typename T>
__device__ __forceinline__ void warp_gather_async(T* dst, const T* src, int n, long long stride, int lane) {
  for (int e = lane; e < n; e += kWarp) __pipeline_memcpy_async(dst + e, src + e * stride, sizeof(T));
}

// Stage n's inputs of solve_batched_reg_kernel (D_n, O_n but for the last
// stage, b_n; batch-last, O'_n) into slot n & (kSlots - 1), each block flat
// as it is row-major; one batch committed a stage, empty past the last, so
// that a wait counts stages. sB: the words between a lane's consecutive
// elements (1 batch-first, B batch-last)
template <int kSlots, bool kBatchLast, typename T>
__device__ __forceinline__ void copy_fused_stage(int n, T* ring, int slot_words, const T* Dl, const T* Ol,
                                                 const T* bl, long long sB, int T_, int d, bool vec, bool vecb,
                                                 int lane) {
  if (n < T_) {
    const int blk = d * d;
    T* slot = ring + (n & (kSlots - 1)) * slot_words;
    if (kBatchLast) {
      warp_gather_async(slot, Dl + n * blk * sB, blk, sB, lane);
      if (n < T_ - 1) warp_gather_async(slot + blk, Ol + n * blk * sB, blk, sB, lane);
      warp_gather_async(slot + 2 * blk, bl + n * d * sB, d, sB, lane);
    } else {
      warp_copy_async(slot, Dl + n * blk, blk, vec, lane);
      if (n < T_ - 1) warp_copy_async(slot + blk, Ol + n * blk, blk, vec, lane);
      warp_copy_async(slot + 2 * blk, bl + n * d, d, vecb, lane);
    }
  }
  __pipeline_commit();
}

// The fused solve for d <= kMax (12, 16 or 32): one warp a lane (see the
// file comment), on batch-first or, where kBatchLast, batch-last arrays
// (O then holds O_t'). Shared memory per warp (per_warp words,
// fused_reg_words): the ring of stage slots, stage n in slot n & (kSlots -
// 1), copied kSlots - 1 stages ahead; the o rows in two buffers (stage t's
// in buffer t & 1, read by stage t + 1), row stride ldg = kMax + 16 /
// sizeof(T); the vector V in two buffers; and, where kOnChip, the kept
// rows and u. Without kOnChip the kept rows are the lane's part of `work`
// ((2T - 1) d (d|1) words) and u_t waits in x, where x_t goes.
template <typename T, int kMax, bool kOnChip, bool kBatchLast>
__global__ void __launch_bounds__(kMaxFusedWarps * kWarp, 1)
    solve_batched_reg_kernel(const T* __restrict__ D, const T* __restrict__ O, const T* __restrict__ bv,
                             T* __restrict__ x, T* __restrict__ work, int B, int T_, int d, int per_warp,
                             int vec, int vecb) {
  constexpr int kSlots = factor_slots(kMax);
  constexpr int ldg = kMax + 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int blk = d * d, ldw = d | 1, hblk = d * ldw;
  const int slot_words = fused_slot_words<T>(d);
  T* const ring = reinterpret_cast<T*>(smem_raw) + static_cast<size_t>(warp) * per_warp;
  T* const G = ring + kSlots * slot_words;
  T* const V = G + 2 * kMax * ldg;
  const long long b = static_cast<long long>(blockIdx.x) * warps + warp;
  if (b >= B) return;  // ragged batch edge; the kernel has no block barrier
  const long long sB = kBatchLast ? B : 1;  // words between a lane's consecutive elements
  const T* Dl = D + lane_offset<kBatchLast>(b, static_cast<long long>(T_) * blk);
  const T* Ol = O + lane_offset<kBatchLast>(b, static_cast<long long>(T_ - 1) * blk);
  const T* bl = bv + lane_offset<kBatchLast>(b, static_cast<long long>(T_) * d);
  T* const xl = x + lane_offset<kBatchLast>(b, static_cast<long long>(T_) * d);  // x_t[i] at xl[(t d + i) sB]
  // the kept rows: L_t's at Lh + t hblk, M_t''s at Mh + t hblk, row i at i ldw
  T* const Lh = kOnChip ? V + 2 * kMax : work + b * (2LL * T_ - 1) * hblk;
  T* const Mh = Lh + static_cast<long long>(T_) * hblk;
  // u_t[i] at uh[(t d + i) su]: on chip after the kept rows, else in x
  T* const uh = kOnChip ? Mh + static_cast<long long>(T_ - 1) * hblk : xl;
  const long long su = kOnChip ? 1 : sB;
  const int c = min(lane, d - 1);  // this thread's row, clamped to a real one to read
  const bool own = lane < d;
  for (int n = 0; n < kSlots - 1; ++n)
    copy_fused_stage<kSlots, kBatchLast>(n, ring, slot_words, Dl, Ol, bl, sB, T_, d, vec, vecb, lane);

  // s[j]: S_t[c][j], then L_t[c][j]; o[k]: O_t[c][k], then M_t[k][c]
  // (zero past d); r: this thread's entry of r_t, then of u_t. The threads
  // past d hold zero rows and r = 0, as in factor_lanes.
  T s[kMax], o[kMax];
#pragma unroll
  for (int k = 0; k < kMax; ++k) s[k] = o[k] = T(0);
  T r = T(0);
  bool ok = true;
  for (int t = 0; t < T_; ++t) {
    const T* Ds = ring + (t & (kSlots - 1)) * slot_words;
    const T* Os = Ds + blk;
    const T* bs = Os + blk;
    __pipeline_wait_prior(kSlots - 2);
    __syncwarp();  // stage t's inputs have landed; stage t-1's slot is free
    copy_fused_stage<kSlots, kBatchLast>(t + kSlots - 1, ring, slot_words, Dl, Ol, bl, sB, T_, d, vec, vecb, lane);

    // S_t = D_t - M_{t-1}' M_{t-1} and r_t = b_t - M_{t-1}' u_{t-1}, both
    // from this thread's o row of stage t-1; then row c of O_t (batch-last,
    // column c of the slot's O_t')
#pragma unroll
    for (int j = 0; j < kMax; ++j) s[j] = Ds[c * d + j];
    r = own ? bs[c] : T(0);
    if (t > 0) {
      gram_update<T, kMax>(s, o, G + ((t - 1) & 1) * kMax * ldg, ldg);
      r -= dot_bcast<T, kMax>(o, V + ((t - 1) & 1) * kMax);
    }
#pragma unroll
    for (int k = 0; k < kMax; ++k) {
      o[k] = own && k < d && t < T_ - 1 ? Os[kBatchLast ? k * d + c : c * d + k] : T(0);
      if (!own) s[k] = T(0);
    }

    // the stacked panel [S_t ; O_t] into L_t and M_t'; then L_t u_t = r_t
    // from the top: u_j = r_j / l_jj by the reciprocal, broadcast, the rows
    // below take column j (this thread's row)
    T inv = T(0);  // 1 / l_cc
    panel_pivots<true>(s, o, d, lane, ok, inv);
    if (!ok) break;
#pragma unroll
    for (int j = 0; j < kMax; ++j) {
      if (j >= d) break;
      const T uj = __shfl_sync(kFull, r * inv, j);
      r = lane == j ? uj : (lane > j ? r - s[j] * uj : r);
    }

    // keep L_t's row (1 / l_cc on the diagonal, zeros above it), the o
    // row and u_t; the o row into G for stage t+1's Gram product, u_t into V
    if (own) {
      T* const Lr = Lh + static_cast<long long>(t) * hblk + lane * ldw;
#pragma unroll
      for (int j = 0; j < kMax; ++j)
        if (j < d) Lr[j] = j < lane ? s[j] : (j == lane ? inv : T(0));
      if (t < T_ - 1) {
        T* const Mr = Mh + static_cast<long long>(t) * hblk + lane * ldw;
        T* const Gc = G + (t & 1) * kMax * ldg + lane * ldg;
#pragma unroll
        for (int k = 0; k < kMax; ++k)
          if (k < d) Mr[k] = o[k];
#pragma unroll
        for (int k = 0; k < kMax; k += 4) store4(Gc + k, o[k], o[k + 1], o[k + 2], o[k + 3]);
      }
      uh[(t * d + lane) * su] = r;
    }
    if (lane < kMax) V[(t & 1) * kMax + lane] = r;
    __syncwarp();  // the o rows are in G, u_t in V
  }
  __pipeline_wait_prior(0);  // no copy is in flight past here

  if (!ok) {  // uniform over the warp
    const T nan = quiet_nan<T>();
    for (int e = lane; e < T_ * d; e += kWarp) xl[e * sB] = nan;
    return;
  }

  // x_t = L_t^{-T} (u_t - M_t x_{t+1}) from the last stage, r = u_{T-1}:
  // thread i takes column i of L_t and row i of M_t (column i of the kept o
  // rows: consecutive words across the warp), the coupling in four partial
  // sums; the rows above pivot j take row j of L_t
  for (int t = T_ - 1; t >= 0; --t) {
    const T* const Lt = Lh + static_cast<long long>(t) * hblk;
    const T* const Mt = Mh + static_cast<long long>(t) * hblk;
    T l[kMax];
#pragma unroll
    for (int j = 0; j < kMax; ++j) l[j] = j < d ? Lt[j * ldw + c] : T(0);
    const T inv = own ? Lt[c * ldw + c] : T(0);
    if (t < T_ - 1) {
      T m[kMax];
#pragma unroll
      for (int k = 0; k < kMax; ++k) m[k] = k < d ? Mt[k * ldw + c] : T(0);
      r = own ? uh[(t * d + lane) * su] - dot_bcast<T, kMax>(m, V + ((t + 1) & 1) * kMax) : T(0);
    }
#pragma unroll
    for (int j = kMax - 1; j >= 0; --j) {
      if (j >= d) continue;
      const T xj = __shfl_sync(kFull, r * inv, j);
      r = lane == j ? xj : (lane < j ? r - l[j] * xj : r);
    }
    if (own) xl[(t * d + lane) * sB] = r;
    if (lane < kMax) V[(t & 1) * kMax + lane] = r;
    __syncwarp();  // x_t is in V
  }
}

// Words of the fused solve's stacked panel past d = 32: 2d + 1 rows of
// wide::panel_ld(d, vec) words (S_t, O_t and r_t), then r_t as the Schur
// update leaves it (d words)
template <typename T>
__host__ __device__ inline long long fused_panel_words(int d, bool vec) {
  return (2LL * d + 1) * wide::panel_ld<T>(d, vec) + d;
}

// The panel's bytes where it lies in shared memory, rounded to 16, and the
// failure flag after them
template <typename T>
__host__ __device__ inline long long fused_panel_bytes(int d, bool vec) {
  return (static_cast<long long>(sizeof(T)) * fused_panel_words<T>(d, vec) + 15) / 16 * 16;
}

// Where the workspace keeps the panel (!on_chip): after L_t and M_t', at a
// multiple of 16 bytes
template <typename T>
__host__ __device__ inline long long fused_panel_offset(int T_, int d) {
  constexpr long long per = 16 / sizeof(T);
  return ((2LL * T_ - 1) * d * d + per - 1) / per * per;
}

// The fused solve past d = 32: one block a lane (wide::Threads), on
// batch-first or, where kBatchLast, batch-last arrays (O then holds O_t').
// The lane's part of `work` (`words` words) keeps L_t (t d^2 on, row-major,
// its lower triangle) and M_t' ((T + t) d^2 on; row c is column c of M_t),
// and, where the panel does not fit in shared memory (!on_chip), the panel
// and r_t after them. Forward, each stage is wide::factor_stage on the
// stacked panel [S_t ; O_t ; r_t'] (riccati_wide.cuh): the forward sweep is
// the panel's last row, u_t' = r_t' L_t^{-T}, and r_t = b_t - M_{t-1}' u_{t-1}
// the Schur update's last row; then L_t and M_t' out to the workspace and
// u_t to x, one barrier. Backward, x_t = L_t^{-T} (u_t - M_t x_{t+1}): the
// coupling a row a thread over the rows of M_t' (consecutive words across
// a warp), then L_t' x_t = r in blocks of 32 rows from the bottom: warp 0
// solves the diagonal block from registers (lane i holds column i of it,
// the pivot broadcast by shuffle, no barrier a pivot), then the block's
// threads take its columns off the rows above (row j of L_t: consecutive
// words across a warp); two barriers a block.
template <typename T, bool kBatchLast, bool kVec>
__global__ void __launch_bounds__(wide::Threads<T>::value, 1)
    solve_batched_fused_wide_kernel(const T* __restrict__ D, const T* __restrict__ O,
                                    const T* __restrict__ bv, T* x, T* work, long long words, int B, int T_,
                                    int d, int on_chip, unsigned long long* parts) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = wide::panel_ld<T>(d, kVec);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & (kWarp - 1), nw = nt >> 5;
  const long long b = blockIdx.x;
  const long long dd = static_cast<long long>(d) * d;
  T* const WL = work + b * words;
  T* const WM = WL + T_ * dd;
  T* const P = on_chip ? reinterpret_cast<T*>(smem_raw) : WL + fused_panel_offset<T>(T_, d);
  T* const rb = P + (2LL * d + 1) * ld;
  int* const flag = reinterpret_cast<int*>(smem_raw + (on_chip ? fused_panel_bytes<T>(d, kVec) : 0));
  if (kVec) wide::zero_padding(P, 2 * d + 1, ld, d);
  const long long sB = kBatchLast ? B : 1;  // words between a lane's consecutive elements
  const T* Dl = D + lane_offset<kBatchLast>(b, T_ * dd);
  const T* Ol = O + lane_offset<kBatchLast>(b, (T_ - 1) * dd);
  const T* bl = bv + lane_offset<kBatchLast>(b, static_cast<long long>(T_) * d);
  T* const xl = x + lane_offset<kBatchLast>(b, static_cast<long long>(T_) * d);  // x_t[i] at xl[(t d + i) sB]
  // O_t (c, j): batch-first at c d + j; batch-last O'_t (j, c) at (j d + c) B
  const long long sOr = kBatchLast ? sB : d, sOc = kBatchLast ? d * sB : 1;

  wide::Stamps stamp{parts, clock64()};
  bool ok = true;
  for (int t = 0; t < T_; ++t) {
    const int nO = t < T_ - 1 ? d : 0;  // the last stage has no O; its r row is row d
    T* const Lt = WL + t * dd;
    const wide::Inputs<T> in{Dl + t * dd * sB, Ol + t * dd * sB, bl + t * d * sB, sB, sOr, sOc};
    if (!wide::factor_stage<kVec, T>(P, rb, flag, ld, d, nO, 1, t > 0, in, Lt, d, stamp)) {
      ok = false;
      break;
    }
    // L_t's rows left of their diagonal blocks (thread 0 wrote those), M_t'
    // and u_t
    for (int i = warp; i < d; i += nw) {
      const int p0 = i & ~(wide::kPanel - 1);
      for (int j = lane; j < p0; j += kWarp) Lt[i * d + j] = wide::row(P, i, ld)[j];
    }
    if (nO > 0) {
      T* const Mt = WM + t * dd;
      for (int c = warp; c < d; c += nw)
        for (int j = lane; j < d; j += kWarp) Mt[c * d + j] = wide::row(P, d + c, ld)[j];
    }
    for (int i = tid; i < d; i += nt) xl[(t * d + i) * sB] = wide::row(P, d + nO, ld)[i];
    __syncthreads();  // the next Schur update takes the top rows
    stamp(3);
  }

  if (!ok) {
    const T nan = quiet_nan<T>();
    for (int e = tid; e < T_ * d; e += nt) xl[static_cast<long long>(e) * sB] = nan;
    return;  // uniform over the block: no barrier follows
  }

  T* const xv = P;     // x_{t+1} (the panel is free)
  T* const r = P + d;  // the stage's right-hand side, then x_t
  constexpr int ldb = kWarp + 1;
  T* const Lb = P + 2 * d;  // two diagonal blocks (the one solved, the next), rows ldb apart
  // the lower triangle of L_t's diagonal block at rows j0.. (up to kWarp of
  // them, ending at j1) into buffer q of Lb, by the threads from `first`
  const auto stage_block = [&](const T* Lt, int j0, int j1, int q, int first) {
    T* const dst = Lb + q * kWarp * ldb;
    for (int e = tid - first; e < kWarp * kWarp; e += nt - first) {
      const int jj = e >> 5, ii = e & (kWarp - 1);
      if (ii <= jj && j0 + jj < j1) dst[jj * ldb + ii] = Lt[(j0 + jj) * d + j0 + ii];
    }
  };
  for (int t = T_ - 1; t >= 0; --t) {
    const T* const Lt = WL + t * dd;
    const T* const Mt = WM + t * dd;
    // r = u_t - M_t x_{t+1}: row i walks column i of M_t, row k of M_t';
    // the bottom diagonal block into Lb
    for (int i = tid; i < d; i += nt) {
      T s = xl[(t * d + i) * sB];
      if (t < T_ - 1)
        for (int k = 0; k < d; ++k) s -= Mt[k * d + i] * xv[k];
      r[i] = s;
    }
    stage_block(Lt, max(d - kWarp, 0), d, 0, 0);
    __syncthreads();
    stamp(4);
    // L_t' x_t = r from the bottom, kWarp rows at a time: warp 0 solves a
    // block while the other warps stage the next one
    for (int j1 = d, q = 0; j1 > 0; j1 -= kWarp, q ^= 1) {
      const int j0 = max(j1 - kWarp, 0);
      if (warp == 0) {
        // lane i holds row i of the block and reads column i of Lb; x_j =
        // r_j / l_jj by the reciprocal, broadcast, and the rows above j
        // take row j
        const T* const Lq = Lb + q * kWarp * ldb;
        const int i = j0 + lane;
        const bool own = i < j1;
        T v = own ? r[i] : T(0);
        const T inv = own ? recip(Lq[lane * ldb + lane]) : T(0);
#pragma unroll
        for (int jj = kWarp - 1; jj >= 0; --jj) {
          if (j0 + jj < j1) {  // uniform over the warp
            const T l = Lq[jj * ldb + lane];
            const T xj = __shfl_sync(kFull, v * inv, jj);
            v = lane == jj ? xj : (lane < jj ? v - l * xj : v);
          }
        }
        if (own) r[i] = v;
      } else if (j0 > 0) {
        stage_block(Lt, max(j0 - kWarp, 0), j0, q ^ 1, kWarp);
      }
      __syncthreads();  // x of the block is in r, the next block in Lb
      // the block's columns off the rows above it (row j of L_t: consecutive
      // words across a warp)
      for (int i = tid; i < j0; i += nt) {
        T s = r[i];
        for (int j = j0; j < j1; ++j) s -= Lt[j * d + i] * r[j];
        r[i] = s;
      }
      __syncthreads();
    }
    for (int i = tid; i < d; i += nt) {
      xv[i] = r[i];
      xl[(t * d + i) * sB] = r[i];
    }
    __syncthreads();  // x_t is in xv
    stamp(5);
  }
}

// The lanes wrapper's layout moves, the transposes that the reference
// leaves to XLA around its kernel. A job is out (C, R) = in (R, C)', where
// d > 0 with each d x d block of a row of `in` transposed on the way
// (input column c = t d^2 + j d + i lands in output row t d^2 + i d + j:
// O (B, T-1, d, d) into O' (T-1, d, d, B)); its 32 x 32 tiles, row-major
// over ceil(R / 32) x col_tiles, are the blocks from the previous job's
// `end` to its own. One launch takes up to three jobs (D, O and b on the
// way in), so that the wrapper's host cost is one launch a way.
constexpr int kTile = 32, kTileRows = 8;

template <typename T>
struct TransposeJob {
  const T* in;
  T* out;
  int R, C, d, col_tiles;
  long long end;
};

// A 32 x 32 tile a block through shared memory, so that a warp reads 32
// consecutive words of a row of `in` and writes 32 consecutive words of a
// row of `out` (a strided copy reads or writes one word a sector); the
// padded tile row keeps the column reads free of bank conflicts
template <typename T>
__global__ void __launch_bounds__(kTile * kTileRows)
    transpose_kernel(TransposeJob<T> j0, TransposeJob<T> j1, TransposeJob<T> j2) {
  __shared__ T tile[kTile][kTile + 1];
  const long long bid = blockIdx.x;
  const bool first = bid < j0.end, second = !first && bid < j1.end;
  const TransposeJob<T> j = first ? j0 : (second ? j1 : j2);
  const int q = static_cast<int>(bid - (first ? 0 : (second ? j0.end : j1.end)));
  const int tr = q / j.col_tiles;
  const int r0 = tr * kTile, c0 = (q - tr * j.col_tiles) * kTile;
  for (int k = threadIdx.y; k < kTile; k += kTileRows) {
    const int r = r0 + k, c = c0 + threadIdx.x;
    if (r < j.R && c < j.C) tile[k][threadIdx.x] = j.in[static_cast<long long>(r) * j.C + c];
  }
  __syncthreads();
  const int dd = j.d * j.d;
  for (int k = threadIdx.y; k < kTile; k += kTileRows) {
    int c = c0 + k;
    const int r = r0 + threadIdx.x;
    if (c >= j.C || r >= j.R) continue;
    if (j.d > 0) {
      const int t = c / dd, e = c - t * dd, row = e / j.d;
      c = t * dd + (e - row * j.d) * j.d + row;
    }
    j.out[static_cast<long long>(c) * j.R + r] = tile[threadIdx.x][k];
  }
}

// The job of an (R, C) `in`, its tiles after block `start`
template <typename T>
TransposeJob<T> transpose_job(const void* in, void* out, long long R, long long C, int d, long long start) {
  const long long col_tiles = (C + kTile - 1) / kTile;
  return {static_cast<const T*>(in), static_cast<T*>(out), static_cast<int>(R), static_cast<int>(C), d,
          static_cast<int>(col_tiles), start + (R + kTile - 1) / kTile * col_tiles};
}

template <typename T>
int launch_transposes(const TransposeJob<T>& j0, const TransposeJob<T>& j1, const TransposeJob<T>& j2,
                      void* stream) {
  if (j2.end == 0) return static_cast<int>(cudaSuccess);
  dim3 block;
  block.x = kTile;
  block.y = kTileRows;
  const unsigned grid = static_cast<unsigned>(j2.end);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  transpose_kernel<T><<<grid, block, 0, st>>>(j0, j1, j2);
  return static_cast<int>(cudaGetLastError());
}

// A job's sizes fit the kernel's int indices and a launch's blocks
bool transpose_fits(long long R, long long C) {
  constexpr long long kMax = 0x7fffffffLL;
  return R <= kMax && C <= kMax && (R + kTile - 1) / kTile * ((C + kTile - 1) / kTile) <= kMax / 4;
}

// Any d >= 1 and T >= 1 whose T d (d + 1) stays in an int: the largest
// index the kernels and the transposes compute in int (t d + i, i ld + j,
// a row of T d^2 words); the workspace's words a lane are counted in 64 bits
bool shape_ok(int B, int T_, int d) {
  return B >= 0 && T_ >= 1 && d >= 1 && static_cast<long long>(T_) * d * (d + 1) <= kMaxIndex;
}

// The way in: D (B, T d^2) into Dl (T d^2, B), O (B, (T-1) d^2) into Ol,
// each block transposed, b (B, T d) into bl (T d, B); one launch
template <typename T>
int batch_last(const void* D, const void* O, const void* b, void* Dl, void* Ol, void* bl, int B, int T_, int d,
               void* stream) {
  const long long dd = static_cast<long long>(d) * d;
  if (!shape_ok(B, T_, d) || !transpose_fits(B, T_ * dd)) return static_cast<int>(cudaErrorInvalidValue);
  const auto jD = transpose_job<T>(D, Dl, B, T_ * dd, 0, 0);
  const auto jO = transpose_job<T>(O, Ol, B, (T_ - 1) * dd, d, jD.end);
  const auto jb = transpose_job<T>(b, bl, B, static_cast<long long>(T_) * d, 0, jO.end);
  return launch_transposes(jD, jO, jb, stream);
}

// The way back: xl (T d, B) into x (B, T d); one launch
template <typename T>
int batch_first(const void* xl, void* x, int B, int T_, int d, void* stream) {
  const long long Td = static_cast<long long>(T_) * d;
  if (!shape_ok(B, T_, d) || !transpose_fits(Td, B)) return static_cast<int>(cudaErrorInvalidValue);
  const auto j = transpose_job<T>(xl, x, Td, B, 0, 0);
  return launch_transposes(j, j, j, stream);
}

// Where the fused solve past d = 32 keeps its panel: 2, in shared memory
// with 16-byte loads (float32 to d = 167, float64 to d = 118); 1, in
// shared memory with scalar loads (float32 d = 168-169, float64 d = 119);
// 0, in the workspace, with 16-byte loads (232,448 B a block on an H100).
// Plan 1 took 0.78 ms at (4, 5, 169) float32 and 0.52 at (4, 5, 119)
// float64 where the workspace took 1.08 and 0.77 (H100 80GB HBM3, 700 W,
// replayed from a CUDA graph)
template <typename T>
int wide_plan(int d, size_t optin) {
  const long long limit = static_cast<long long>(optin) - wide::kFlagBytes;
  return fused_panel_bytes<T>(d, true) <= limit ? 2 : (fused_panel_bytes<T>(d, false) <= limit ? 1 : 0);
}

// Words of workspace a lane past d = 32: L_t and M_t' (2T - 1 blocks of
// d^2), and the panel where it does not fit in shared memory; a multiple
// of 16 bytes
template <typename T>
long long fused_wide_words(int T_, int d, int plan) {
  constexpr long long per = 16 / sizeof(T);
  const long long words = plan ? (2LL * T_ - 1) * d * d : fused_panel_offset<T>(T_, d) + fused_panel_words<T>(d, true);
  return (words + per - 1) / per * per;
}

// The current device's opt-in shared memory a block, in bytes
cudaError_t smem_optin(size_t* bytes) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *bytes = static_cast<size_t>(optin);
  return err;
}

// The register kernel's width for d <= 32
int reg_width(int d) { return d <= 12 ? 12 : (d <= 16 ? 16 : kWarp); }

// Words of a warp's shared memory in solve_batched_reg_kernel at width kMax:
// the ring of stage slots; two buffers of kMax o rows of kMax + 16 /
// sizeof(T) words (the Gram coupling's); two vectors of kMax (u_{t-1}
// forward, x_{t+1} backward); and, on chip, the kept rows of L_t (T d rows
// of d|1 words) and of M_t' ((T-1) d rows) and u (T d), rounded to 16 bytes
template <typename T>
size_t fused_reg_words(int kMax, int T_, int d, bool on_chip) {
  constexpr size_t per = 16 / sizeof(T);
  size_t words = static_cast<size_t>(factor_slots(kMax)) * fused_slot_words<T>(d) +
                 2 * static_cast<size_t>(kMax) * (kMax + per) + 2 * static_cast<size_t>(kMax);
  if (on_chip) words += (2 * static_cast<size_t>(T_) - 1) * d * (d | 1) + static_cast<size_t>(T_) * d;
  return (words + per - 1) / per * per;
}

// Words of device-memory workspace a lane needs, in 64 bits: for d <= 32,
// 0 when the horizon's factor stays in the current device's shared memory
// (kOnChipWarps warps' shares fit in a block's limit), else (2T - 1) d
// (d|1); past d = 32 always fused_wide_words
template <typename T>
long long fused_workspace(int T_, int d) {
  if (!shape_ok(0, T_, d)) return -static_cast<long long>(cudaErrorInvalidValue);
  size_t optin = 0;
  const cudaError_t err = smem_optin(&optin);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  if (d <= kWarp)
    return kOnChipWarps * sizeof(T) * fused_reg_words<T>(reg_width(d), T_, d, true) <= optin
               ? 0
               : (2LL * T_ - 1) * d * (d | 1);
  return fused_wide_words<T>(T_, d, wide_plan<T>(d, optin));
}

// solve_batched_reg_kernel<T, kMax, ., kBatchLast>, on chip where `work`
// is null: warps a block B / SMs, at least one (so that every SM has a
// lane where the batch allows) and at most kMaxFusedWarps; 16-byte copies
// batch-first where the sizes and addresses allow them
template <typename T, int kMax, bool kBatchLast>
cudaError_t launch_fused_reg(const T* D, const T* O, const T* b, T* x, T* work, int B, int T_, int d,
                             cudaStream_t stream) {
  int want = B / sm_count();
  if (want > kMaxFusedWarps) want = kMaxFusedWarps;
  const bool on_chip = work == nullptr;
  const size_t words = fused_reg_words<T>(kMax, T_, d, on_chip);
  auto kernel = on_chip ? solve_batched_reg_kernel<T, kMax, true, kBatchLast>
                        : solve_batched_reg_kernel<T, kMax, false, kBatchLast>;
  int warps;
  size_t smem;
  cudaError_t err = configure(kernel, sizeof(T) * words, &warps, &smem, kMaxSmem, want < 1 ? 1 : want);
  if (err != cudaSuccess) return err;
  const int vec = !kBatchLast && (sizeof(T) * d * d) % 16 == 0 && aligned16(D) && aligned16(O);
  const int vecb = vec && (sizeof(T) * d) % 16 == 0 && aligned16(b);
  kernel<<<(B + warps - 1) / warps, warps * kWarp, smem, stream>>>(D, O, b, x, work, B, T_, d,
                                                                  static_cast<int>(words), vec, vecb);
  return cudaGetLastError();
}

// The fused solve on batch-first or, where kBatchLast, batch-last arrays:
// the register kernel up to d = 32 (width 12, 16 or 32), a block a lane
// past it; L and M in shared memory where `work` is null
template <typename T, bool kBatchLast>
int solve_batched_fused(const void* D, const void* O, const void* b, void* x, void* work, int B,
                        int T_, int d, void* stream, void* parts = nullptr) {
  if (!shape_ok(B, T_, d)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const T* Dp = static_cast<const T*>(D);
  const T* Op = static_cast<const T*>(O);
  const T* bp = static_cast<const T*>(b);
  T* xp = static_cast<T*>(x);
  T* wp = static_cast<T*>(work);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (parts != nullptr && d <= kWarp) return static_cast<int>(cudaErrorInvalidValue);
  if (d <= 12) return static_cast<int>(launch_fused_reg<T, 12, kBatchLast>(Dp, Op, bp, xp, wp, B, T_, d, st));
  if (d <= 16) return static_cast<int>(launch_fused_reg<T, 16, kBatchLast>(Dp, Op, bp, xp, wp, B, T_, d, st));
  if (d <= kWarp) return static_cast<int>(launch_fused_reg<T, kWarp, kBatchLast>(Dp, Op, bp, xp, wp, B, T_, d, st));
  // past d = 32 the workspace keeps L and M (fused_workspace), and the panel
  // where it does not fit in shared memory
  if (wp == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  size_t optin = 0;
  cudaError_t err = smem_optin(&optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int plan = wide_plan<T>(d, optin);
  const size_t smem = plan ? fused_panel_bytes<T>(d, plan == 2) + wide::kFlagBytes : wide::kFlagBytes;
  const auto kernel = plan == 1 ? solve_batched_fused_wide_kernel<T, kBatchLast, false>
                                : solve_batched_fused_wide_kernel<T, kBatchLast, true>;
  if (smem > kDefaultSmem) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long words = fused_wide_words<T>(T_, d, plan);
  auto* const clock = static_cast<unsigned long long*>(parts);
  kernel<<<B, wide::Threads<T>::value, smem, st>>>(Dp, Op, bp, xp, wp, words, B, T_, d, plan > 0, clock);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

long long calipso_solve_batched_fused_workspace_f32(int T, int d) {
  return fused_workspace<float>(T, d);
}

long long calipso_solve_batched_fused_workspace_f64(int T, int d) {
  return fused_workspace<double>(T, d);
}

int calipso_solve_batched_fused_f32(const void* D, const void* O, const void* b, void* x,
                                    void* work, int B, int T, int d, void* stream) {
  return solve_batched_fused<float, false>(D, O, b, x, work, B, T, d, stream);
}

int calipso_solve_batched_fused_f64(const void* D, const void* O, const void* b, void* x,
                                    void* work, int B, int T, int d, void* stream) {
  return solve_batched_fused<double, false>(D, O, b, x, work, B, T, d, stream);
}

// solve_batched_fused past d = 32 with its parts' clock summed over the
// lanes into parts (6 words of cycles, wide::Stamps; chip_smoke.py's split)
int calipso_solve_batched_fused_parts_f32(const void* D, const void* O, const void* b, void* x, void* work, int B,
                                          int T, int d, void* parts, void* stream) {
  return solve_batched_fused<float, false>(D, O, b, x, work, B, T, d, stream, parts);
}

int calipso_solve_batched_fused_parts_f64(const void* D, const void* O, const void* b, void* x, void* work, int B,
                                          int T, int d, void* parts, void* stream) {
  return solve_batched_fused<double, false>(D, O, b, x, work, B, T, d, stream, parts);
}

// D (T, d, d, B), O' (T-1, d, d, B) with O'_t = O_t', b and x (T, d, B)
int calipso_solve_batched_lanes_f32(const void* D, const void* O, const void* b, void* x,
                                    void* work, int B, int T, int d, void* stream) {
  return solve_batched_fused<float, true>(D, O, b, x, work, B, T, d, stream);
}

int calipso_solve_batched_lanes_f64(const void* D, const void* O, const void* b, void* x,
                                    void* work, int B, int T, int d, void* stream) {
  return solve_batched_fused<double, true>(D, O, b, x, work, B, T, d, stream);
}

// solve_batched_lanes' layout moves: D (B, T, d, d), O (B, T-1, d, d), b
// (B, T, d) into D (T, d, d, B), O' (T-1, d, d, B), b (T, d, B); and x
// (T, d, B) back into x (B, T, d)
int calipso_batch_last_f32(const void* D, const void* O, const void* b, void* Dl, void* Ol, void* bl, int B, int T,
                           int d, void* stream) {
  return batch_last<float>(D, O, b, Dl, Ol, bl, B, T, d, stream);
}

int calipso_batch_last_f64(const void* D, const void* O, const void* b, void* Dl, void* Ol, void* bl, int B, int T,
                           int d, void* stream) {
  return batch_last<double>(D, O, b, Dl, Ol, bl, B, T, d, stream);
}

int calipso_batch_first_f32(const void* xl, void* x, int B, int T, int d, void* stream) {
  return batch_first<float>(xl, x, B, T, d, stream);
}

int calipso_batch_first_f64(const void* xl, void* x, int B, int T, int d, void* stream) {
  return batch_first<double>(xl, x, B, T, d, stream);
}

}  // extern "C"
