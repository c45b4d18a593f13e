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
// solve_batched_fused_wide_kernel) one thread block owns one lane, with
// one __syncthreads() per pivot, M_t and u_t out of one substitution. The
// factor lives in one of three tiers (wide_tier), the first whose shared
// memory fits a block's opt-in limit (232,448 B on an H100): the
// horizon's L and M in shared memory ((2T - 1) d (d+1) words plus two
// vectors, 178 KB at the quadruped's T=8, d=54 in float32); else L and M
// in the workspace and the stage being factored, S_t, in shared memory
// ((d+1)(d+2) words: float32 to d = 239, float64 to d = 168), kept into the
// workspace once factored; else all of it in the workspace, read and
// written through L1 and L2 (at (16, 8, 256) in float32 the workspace is
// 63 MB). Batch-last, its reads and writes take the same address map,
// each element its own sector, which consecutive lanes' blocks share in L2.
// Past d = 64 the bound is the operations' (36 us at (32, 8, 165) in
// float32), but a lane's pivots are a chain of dependent steps, a barrier
// each, on one SM: 23.3 ms there on an H100, where factor_stream and
// solve_stream take 3.1 ms (ops/cuda_riccati.solve_batched takes those
// between d = 64 and their limit).
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

namespace {

constexpr int kMaxThreads = 256;  // d > 32: threads per block
constexpr long long kMaxIndex = 0x7fffffffLL;  // T d (d + 1) at most this (shape_ok)
constexpr int kMaxFusedWarps = 4;  // d <= 32: at most this many warps a block
// d <= 32: the horizon's factor stays on chip where this many warps
// can hold theirs in a block's shared memory (two blocks of 4 an SM: the
// rocket batch's 1024 lanes over 132 SMs in one wave)
constexpr int kOnChipWarps = 8;

template <typename T>
__device__ __forceinline__ bool pivot_ok(T p) {
  return p > T(0) && p - p == T(0);  // positive and finite
}

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

// The fused solve past d = 32: one block per lane, on batch-first or,
// where kBatchLast, batch-last arrays (O then holds O_t'). Lf[t] (t < T)
// keeps L_t; Mf[t] (t < T-1) holds O_t row-major, i.e. column c of O_t' in
// row c, turned in place into M_t with column c in row c (the carry the
// next stage's Schur update reads); each d rows of ld = d + 1. Shared
// memory always holds v (the carry: u_{t-1} forward, x_{t+1} backward) and
// r (the stage's right-hand side); u_t waits in x. Three tiers
// (wide_tier): the whole horizon's Lf and Mf in shared memory (`work`
// null); else Lf and Mf in the lane's part of `work`, and S_t factored in
// shared memory (kept into Lf[t] once factored) where `stage_on_chip`,
// else in place in Lf[t]. The work of a stage is spread over the block
// without integer division: the Schur update S_t = D_t - M_{t-1}' M_{t-1}
// and each pivot's trailing update a row a warp, a column a thread; the
// substitution [M_t u_t] = L_t^{-1} [O_t' r] a column a warp, a row a
// thread, each column's pivots apart from the others' (a __syncwarp a
// pivot); one __syncthreads() a pivot of the factor and of the backward
// sweep. An element's operations come in the same order in every tier.
template <typename T, bool kBatchLast>
__global__ void __launch_bounds__(kMaxThreads)
    solve_batched_fused_wide_kernel(const T* __restrict__ D, const T* __restrict__ O,
                                    const T* __restrict__ bv, T* x, T* work, int B, int T_, int d,
                                    int stage_on_chip) {
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
  const int warp = tid >> 5, q = tid & (kWarp - 1), nw = nt >> 5;
  const long long dd = static_cast<long long>(d) * d;
  const long long sB = kBatchLast ? B : 1;  // words between a lane's consecutive elements
  const T* Dl = D + lane_offset<kBatchLast>(lane, T_ * dd);
  const T* Ol = O + lane_offset<kBatchLast>(lane, (T_ - 1) * dd);
  const T* bl = bv + lane_offset<kBatchLast>(lane, static_cast<long long>(T_) * d);
  T* xl = x + lane_offset<kBatchLast>(lane, static_cast<long long>(T_) * d);  // x_t[i] at xl[(t d + i) sB]

  bool ok = true;
  for (int t = 0; t < T_ && ok; ++t) {
    T* const Lt = Lf + static_cast<long long>(t) * blk;
    T* const S = stage_on_chip ? r + ld : Lt;  // where S_t is factored
    T* const R = Mf + static_cast<long long>(t) * blk;
    const T* C = Mf + static_cast<long long>(t - 1) * blk;  // M_{t-1}, read for t > 0
    const bool coupled = t < T_ - 1;

    // S_t = D_t - M_{t-1}' M_{t-1} (lower triangle), O_t into R (element
    // (i, j) of O_t' is O_t's (j, i)), and r = b_t - M_{t-1}' u_{t-1}. With
    // M_{t-1} in shared memory a thread takes an entry, its sum in order of
    // k; in the workspace a warp takes an entry, its threads k, so that
    // their reads of the two rows of C are coalesced, then a reduction
    for (int i = warp; i < d; i += nw) {
      for (int j = q; j < d; j += kWarp) {
        const long long e = t * dd + static_cast<long long>(i) * d + j;
        if (j <= i && (t == 0 || work == nullptr)) {
          T s = Dl[e * sB];
          if (t > 0)
            for (int k = 0; k < d; ++k) s -= C[i * ld + k] * C[j * ld + k];
          S[i * ld + j] = s;
        }
        if (coupled) R[kBatchLast ? j * ld + i : i * ld + j] = Ol[e * sB];
      }
      if (t == 0 || work == nullptr) continue;
      for (int j = 0; j <= i; ++j) {
        T p = T(0);
        for (int k = q; k < d; k += kWarp) p += C[i * ld + k] * C[j * ld + k];
        for (int o = kWarp / 2; o > 0; o >>= 1) p += __shfl_xor_sync(kFull, p, o);
        if (q == (j & (kWarp - 1))) S[i * ld + j] = Dl[(t * dd + static_cast<long long>(i) * d + j) * sB] - p;
      }
    }
    for (int i = tid; i < d; i += nt) {
      T s = bl[(t * d + i) * sB];
      if (t > 0)
        for (int k = 0; k < d; ++k) s -= C[i * ld + k] * v[k];
      r[i] = s;
    }
    __syncthreads();

    // right-looking Cholesky of the lower triangle, in place, column k
    // scaled one pivot late; every thread reads the same pivot after a
    // barrier, so the failure test (and the break) is uniform over the block
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
      for (int i = k + 1 + warp; i < d; i += nw) {
        const T sik = S[i * ld + k];
        for (int j = k + 1 + q; j <= i; j += kWarp) S[i * ld + j] -= sik * S[j * ld + k] * inv;
      }
      prev = pkk;
      __syncthreads();
    }
    if (!ok) break;
    if (tid == 0) S[(d - 1) * ld + d - 1] = sqrt(prev);
    __syncthreads();

    // keep L_t where S_t was factored on its own (both only read S here)
    if (stage_on_chip)
      for (int i = warp; i < d; i += nw)
        for (int j = q; j <= i; j += kWarp) Lt[i * ld + j] = S[i * ld + j];
    // [M_t u_t] = L_t^{-1} [O_t' r], column c of them by warp c mod nw, r
    // the last column: pivot j updates the rows below it with the unscaled
    // entry j and scales entry j - 1
    const int ncol = coupled ? d + 1 : 1;
    for (int c = warp; c < ncol; c += nw) {
      T* const col = c == ncol - 1 ? r : R + c * ld;
      for (int j = 0; j < d; ++j) {
        const T inv = T(1) / S[j * ld + j];
        const T cj = col[j];
        for (int i = j + 1 + q; i < d; i += kWarp) col[i] -= S[i * ld + j] * cj * inv;
        if (q == 0 && j > 0) col[j - 1] /= S[(j - 1) * ld + j - 1];
        __syncwarp();
      }
      if (q == 0) col[d - 1] /= S[(d - 1) * ld + d - 1];
      __syncwarp();
    }
    __syncthreads();
    for (int i = tid; i < d; i += nt) {
      v[i] = r[i];
      xl[(t * d + i) * sB] = r[i];  // u_t, read back by the same thread below
    }
    __syncthreads();
  }

  if (!ok) {
    const T nan = quiet_nan<T>();
    for (int e = tid; e < T_ * d; e += nt) xl[static_cast<long long>(e) * sB] = nan;
    return;  // uniform over the block: no barrier follows
  }

  for (int t = T_ - 1; t >= 0; --t) {
    const T* Lt = Lf + static_cast<long long>(t) * blk;
    const T* Ct = Mf + static_cast<long long>(t) * blk;  // row k = column k of M_t
    // r = u_t - M_t x_{t+1}
    for (int i = tid; i < d; i += nt) {
      T s = xl[(t * d + i) * sB];
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
      xl[(t * d + i) * sB] = r[i];
    }
    __syncthreads();
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

// Shared memory of solve_batched_fused_wide_kernel in bytes, by tier: 1,
// the horizon resident (v, r and (2T - 1) blocks of d (d + 1) words); 2,
// the stage alone (v, r and S_t: (d + 1)(d + 2) words); 3, v and r
template <typename T>
size_t wide_smem(int tier, int T_, int d) {
  const size_t ld = static_cast<size_t>(d) + 1;
  const size_t blocks = tier == 1 ? 2 * static_cast<size_t>(T_) - 1 : (tier == 2 ? 1 : 0);
  return sizeof(T) * (2 * ld + blocks * d * ld);
}

// The first tier of solve_batched_fused_wide_kernel whose shared memory
// fits `optin` bytes: float32 stages fit on chip to d = 239, float64 to
// d = 168 (232,448 B on an H100); tier 3 always fits
template <typename T>
int wide_tier(int T_, int d, size_t optin) {
  return wide_smem<T>(1, T_, d) <= optin ? 1 : (wide_smem<T>(2, T_, d) <= optin ? 2 : 3);
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

// Words of device-memory workspace a lane needs: 0 when the horizon's
// factor stays in the current device's shared memory (for d <= 32 where
// kOnChipWarps warps' shares fit in a block's limit; past it where the
// wide kernel's tier 1 does), else (2T - 1) d (d|1) for d <= 32 and (2T -
// 1) d (d + 1) past it, in 64 bits (past d = 32 it can pass 2^31)
template <typename T>
long long fused_workspace(int T_, int d) {
  if (!shape_ok(0, T_, d)) return -static_cast<long long>(cudaErrorInvalidValue);
  size_t optin = 0;
  const cudaError_t err = smem_optin(&optin);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  const long long blocks = (2LL * T_ - 1) * d;
  if (d <= kWarp)
    return kOnChipWarps * sizeof(T) * fused_reg_words<T>(reg_width(d), T_, d, true) <= optin ? 0 : blocks * (d | 1);
  return wide_tier<T>(T_, d, optin) == 1 ? 0 : blocks * (d + 1);
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
                        int T_, int d, void* stream) {
  if (!shape_ok(B, T_, d)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const T* Dp = static_cast<const T*>(D);
  const T* Op = static_cast<const T*>(O);
  const T* bp = static_cast<const T*>(b);
  T* xp = static_cast<T*>(x);
  T* wp = static_cast<T*>(work);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 12) return static_cast<int>(launch_fused_reg<T, 12, kBatchLast>(Dp, Op, bp, xp, wp, B, T_, d, st));
  if (d <= 16) return static_cast<int>(launch_fused_reg<T, 16, kBatchLast>(Dp, Op, bp, xp, wp, B, T_, d, st));
  if (d <= kWarp) return static_cast<int>(launch_fused_reg<T, kWarp, kBatchLast>(Dp, Op, bp, xp, wp, B, T_, d, st));
  // tier 1 where the caller gave no workspace, else 2 where the stage fits
  size_t optin = 0;
  cudaError_t err = smem_optin(&optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tier = work == nullptr ? 1 : (wide_tier<T>(T_, d, optin) == 3 ? 3 : 2);
  const size_t smem = wide_smem<T>(tier, T_, d);
  if (smem > kDefaultSmem) {
    err = cudaFuncSetAttribute(solve_batched_fused_wide_kernel<T, kBatchLast>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int threads = (d * d + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  solve_batched_fused_wide_kernel<T, kBatchLast><<<B, threads, smem, st>>>(Dp, Op, bp, xp, wp, B, T_, d, tier == 2);
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
