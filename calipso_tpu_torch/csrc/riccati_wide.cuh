// The wide stage of the block-tridiagonal factor, shared by
// factor_stream past d = 64 (riccati_stream.cu, TPU kernel 5,
// calipso_tpu/ops/pallas_riccati.py:813) and the fused solve past d = 32
// (riccati_fused.cu, TPU kernels 8 and 9, :117 and :245): one thread block
// factors one stage of one lane,
//   S_t = D_t - M_{t-1}' M_{t-1},  L_t = chol(S_t),  M_t = L_t^{-1} O_t',
// and, for the fused solve, the forward sweep's u_t = L_t^{-1} r_t with
// r_t = b_t - M_{t-1}' u_{t-1}, all as one right-looking Cholesky of the
// stacked panel
//   P = [S_t ; O_t ; r_t'],
// whose rows end as L_t (top d rows), M_t' (the next d, row c column c of
// M_t) and u_t' (the last). The last stage has no O rows; factor_stream
// has no r row.
//
// P lies in shared memory, or, where it does not fit (the fused solve past
// d = 169 in float32, 119 in float64), in the lane's part of the caller's
// workspace, read and written through L1 and L2 by the same code. Its rows
// are panel_ld(d) words apart: with 16-byte loads an odd number of 16-byte
// pieces, else an odd number of words, so that the 8 consecutive rows a
// warp reads at once fall in distinct banks. A stage:
//  - the Schur update: S_t (lower triangle) and r_t from the carry, the
//    previous stage's bottom rows (M_{t-1}' and u_{t-1}'), which stay in
//    P; D_t and b_t are read from device memory, each element once, loaded
//    before the tile's products so that the read overlaps them. One barrier;
//  - the columns in blocks of 32 (kBlock), each block in 8-wide panels
//    (the last one padded to 8 with identity): every thread that has a
//    strip row factors the panel's 8 x 8 diagonal block in registers (one
//    reciprocal square root a pivot, no division) and solves its strip
//    row, one of the rows below the block; thread 0 writes the block's L to
//    device memory. One barrier. Then the rank-8 update of the block's
//    later columns, and one barrier; after the block's last panel one
//    rank-32 update of the columns past the block, and one barrier, so that
//    most of the trailing work reads and writes each element once every 32
//    columns. The first update to touch an element of O_t or r_t reads it
//    where it lies (device memory, the Schur update's r_t), so O_t takes no
//    copy of its own and no copy's wait is exposed;
//  - the products are dealt in blocks of 32 rows x 16 columns to the warps
//    in turn, anew for each update, so that the warps stay busy as the
//    trailing region shrinks: lane l takes the rows r0 + (l & 7) + 8 i and
//    the columns c0 + (l >> 3) + 4 j (i, j < 4) of its block, 16 sums in
//    registers, reading 4 rows of A and 4 columns' rows of A 16 bytes at a
//    time: a warp's row loads fall in distinct banks and its column loads
//    are broadcasts.
// A pivot that is not positive, or not finite, is seen by every thread
// that factors the block; thread 0 writes it to a flag that every thread
// reads after the barrier, so a failed stage ends the same way in every
// thread. About 2 ceil(d/8) barriers a stage and no integer division in a
// stage.
//
// Bound (H100 SXM: 67 TFLOP/s float32, 34 float64): the stage's 2d^3/3 +
// d^2 (d + 1)/2 multiply-adds (d = 165: 5.3 M) take at least 24 us on one
// SM's 128 float32 lanes at 1.755 GHz, however many lanes run beside it.
// The panels' chain of dependent pivots and the barriers between the
// parts are latency no SM count shortens: spreading a lane over a cluster
// of CTAs would divide the products alone and add a gather and a cluster
// barrier to every update (PERF.md, section 6).

#pragma once

#include <cuda_runtime.h>

namespace {
namespace wide {

constexpr int kPanel = 8;       // panel width
constexpr int kBlock = 32;      // the columns a block of panels spans
constexpr int kFlagBytes = 16;  // the failure flag, after the panel (16-byte granule)

// The block a lane: 12 warps in float32 (16 leave 128 registers a thread,
// and the kernels spilled there; 12 were as fast or faster on an H100); 8
// in float64, whose 8 x 8 diagonal block takes 72 registers
template <typename T>
struct Threads;
template <>
struct Threads<float> {
  static constexpr int value = 384;
};
template <>
struct Threads<double> {
  static constexpr int value = 256;
};

// P's row stride. Scalar loads (kVec false): odd, so that a warp's 8
// consecutive rows fall in 8 distinct banks. 16-byte loads along k (kVec):
// a multiple of 16 bytes, an odd number of them, so that the 8 rows' 16-byte
// pieces fall in 8 distinct groups of 4 banks; d rounded up so (f32 165 ->
// 172, f64 116 -> 118), the padding columns zero
template <typename T>
__host__ __device__ constexpr int panel_ld(int d, bool vec) {
  return vec ? ((d * static_cast<int>(sizeof(T)) + 15) / 16 | 1) * (16 / static_cast<int>(sizeof(T))) : d | 1;
}

// 16 / sizeof(T) consecutive words from p (16-byte aligned)
__device__ __forceinline__ void load16(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}
__device__ __forceinline__ void load16(const double* p, double (&x)[2]) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  x[0] = v.x, x[1] = v.y;
}

// Row r of an array of rows ld apart (64-bit: a panel in the workspace can
// pass 2^31 words)
template <typename T>
__device__ __forceinline__ T* row(T* P, int r, int ld) {
  return P + static_cast<long long>(r) * ld;
}

// Zero the columns d..ld-1 of P's `rows` rows: the 16-byte loads of the
// Schur update read them (as zeros) up to d rounded up to 16 bytes
template <typename T>
__device__ __forceinline__ void zero_padding(T* P, int rows, int ld, int d) {
  const int pad = ld - d;
  for (int e = threadIdx.x; e < rows * pad; e += blockDim.x) {
    const int r = e / pad;  // once, before the stages
    row(P, r, ld)[d + e - r * pad] = T(0);
  }
}

// The parts' clock (chip_smoke.py prints the split): where `parts` is not
// null, thread 0 adds the cycles since its last stamp to parts[k] at each
// stamp, which follows a block barrier, so that a part is the block's time
// between two barriers: 0 the Schur update, 1 the panels' diagonal blocks
// and strips, 2 the trailing updates, 3 the stores of a stage, 4 the fused
// solve's backward coupling, 5 its backward substitutions. Null on every
// path but that measurement.
struct Stamps {
  unsigned long long* parts;
  long long last;
  __device__ __forceinline__ void operator()(int k) {
    if (parts != nullptr && threadIdx.x == 0) {
      const long long now = clock64();
      atomicAdd(parts + k, static_cast<unsigned long long>(now - last));
      last = now;
    }
  }
};

// Where a stage's inputs lie: D_t (i, j) at D[(i d + j) sB], O_t (c, j) at
// O[c sOr + j sOc], b_t (j) at b[j sB] (batch-first sB = 1, sOr = d, sOc =
// 1; the fused solve's batch-last arrays sB = B, and O' holds O_t', so sOr
// = B, sOc = d B)
template <typename T>
struct Inputs {
  const T* D;
  const T* O;
  const T* b;
  long long sB, sOr, sOc;
};

// A row of a product's sources: element c at base[c stride]
template <typename T>
struct SrcRow {
  const T* base;
  long long stride;
};

// The Schur update's operands: the output rows i < d are S_t's (into P,
// from D_t), row d is r_t's (into rb, from b_t); the A row of output row i
// (and of column i) is P's row d + i, the carry (row 2d: u_{t-1})
template <typename T>
struct SchurOp {
  static constexpr bool kPrefetch = true;  // D_t and b_t in device memory, a d-deep product
  T* P;
  T* rb;
  int ld, d;
  Inputs<T> in;
  __device__ __forceinline__ const T* arow(int i) const { return row(P, d + i, ld); }
  __device__ __forceinline__ SrcRow<T> src_row(int i) const {
    return i < d ? SrcRow<T>{in.D + static_cast<long long>(i) * d * in.sB, in.sB} : SrcRow<T>{in.b, in.sB};
  }
  __device__ __forceinline__ T* out_row(int i) const { return i < d ? row(P, i, ld) : rb; }
};

// A trailing update from the columns a0.. of P: the A row of output row r
// (and of column r) is P's row r from column a0. Where `first` (the first
// update of the stage to touch its elements), the rows below the top d
// start from the stage's inputs where they lie: O_t's rows in device
// memory, r_t's in rb; else every element starts from P.
template <typename T>
struct TrailOp {
  static constexpr bool kPrefetch = false;  // mostly P in place, a product 8 or 32 deep
  T* P;
  const T* rb;
  int ld, d, nO, a0;
  bool first;
  Inputs<T> in;
  __device__ __forceinline__ const T* arow(int r) const { return row(P, r, ld) + a0; }
  __device__ __forceinline__ SrcRow<T> src_row(int r) const {
    if (!first || r < d) return SrcRow<T>{row(P, r, ld), 1};
    if (r < d + nO) return SrcRow<T>{in.O + (r - d) * in.sOr, in.sOc};
    return SrcRow<T>{rb, 1};
  }
  __device__ __forceinline__ T* out_row(int r) const { return row(P, r, ld); }
};

// out(r, c) = src(r, c) - sum_{k < kn} A_r[k] A_c[k] over this thread's
// elements of one block: the rows r0 + 8 i and the columns c0 + 4 j (i, j
// < 4); only those with r < R, c < cend and, for r < d, r >= c. Where the
// op says so (Op::kPrefetch: sources in device memory) the sources are
// loaded before the products, else after them; with kVec the rows of A are
// read 16 bytes at a time (kn a multiple of 16 bytes), in the same order
// of k.
template <int kKn, bool kVec, typename T, typename Op>
__device__ __forceinline__ void tile(const Op& op, int r0, int c0, int R, int cend, int d, int kn) {
  if (r0 >= R || c0 >= cend) return;
  const int rl = r0 + 24;  // this thread's last row
  if (rl < d && rl < c0) return;  // wholly above the diagonal
  const T* a[4];
  const T* b[4];
  T acc[4][4], s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a[i] = op.arow(min(r0 + 8 * i, R - 1));  // clamped: a row past the edge reads a real one
    b[i] = op.arow(min(c0 + 4 * i, cend - 1));
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = s[i][j] = T(0);
  }
  const auto live = [&](int i, int j) {
    const int r = r0 + 8 * i, c = c0 + 4 * j;
    return r < R && c < cend && (r >= d || r >= c);
  };
  const auto load_sources = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const SrcRow<T> sr = op.src_row(min(r0 + 8 * i, R - 1));
      const T* const sp = sr.base + c0 * sr.stride;
      const long long step = 4 * sr.stride;
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = live(i, j) ? sp[j * step] : T(0);
    }
  };
  if (Op::kPrefetch) load_sources();
  const int n = kKn > 0 ? kKn : kn;
  if constexpr (kVec) {
    constexpr int per = 16 / sizeof(T);
#pragma unroll 2
    for (int k = 0; k < n; k += per) {
      T x[4][per];
#pragma unroll
      for (int i = 0; i < 4; ++i) load16(a[i] + k, x[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        T y[per];
        load16(b[j] + k, y);
#pragma unroll
        for (int q = 0; q < per; ++q)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] += x[i][q] * y[q];
      }
    }
  } else {
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      T x[4], y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i] = a[i][k];
        y[i] = b[i][k];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += x[i] * y[j];
    }
  }
  if (!Op::kPrefetch) load_sources();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    T* const out = op.out_row(min(r0 + 8 * i, R - 1));
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (live(i, j)) out[c0 + 4 * j] = s[i][j] - acc[i][j];
  }
}

// The region rows [j, R) x columns [j, cend) (lower triangle where the
// row is below d) in blocks of 32 rows x 16 columns: column group g
// (columns j + 16 g ..) has ceil((R - j - 16 g) / 32) blocks from its
// diagonal down; block m of the walk, group by group, goes to warp m mod
// (warps); lane l takes the rows r0 + (l & 7) + 8 i and the columns c0 +
// (l >> 3) + 4 j of its block
template <int kKn, bool kVec, typename T, typename Op>
__device__ __forceinline__ void update(const Op& op, int j, int R, int cend, int d, int kn) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const int rt = lane & 7, ct = lane >> 3;
  int c0 = j, nb = (R - j + 31) >> 5, m = warp;
  while (c0 < cend) {
    if (m >= nb) {
      m -= nb;
      c0 += 16;
      nb = (R - c0 + 31) >> 5;
      continue;
    }
    tile<kKn, kVec, T>(op, c0 + 32 * m + rt, c0 + ct, R, cend, d, kn);
    m += nw;
  }
}

// One stage (see the file comment): P holds the carry in rows d.. (where
// `carry`), rb takes r_t (rrow), Ld receives the diagonal blocks of L_t
// (row stride ldL), flag is a word of shared memory, stamp the parts'
// clock; kVec: P's rows 16-byte aligned at panel_ld(d, true), its padding
// zero. nO: O rows this stage (d or 0); rrow: 1 for the fused solve's r
// row, at row d + nO. The columns go in blocks of kBlock: in each, 8-wide
// panels, each followed by the update of the block's later columns; then
// one update of the columns past the block, kBlock deep. Returns false, in
// every thread, where a pivot was not positive or not finite; the stage's
// rows are then partly factored.
template <bool kVec, typename T>
__device__ bool factor_stage(T* P, T* rb, int* flag, int ld, int d, int nO, int rrow, bool carry,
                             const Inputs<T>& in, T* Ld, int ldL, Stamps& stamp) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int R = d + nO + rrow;
  constexpr int per = kVec ? 16 / sizeof(T) : 1;
  update<0, kVec, T>(SchurOp<T>{P, rb, ld, d, in}, 0, d + rrow, d, d, carry ? (d + per - 1) / per * per : 0);
  __syncthreads();  // S_t and r_t are in place; the carry is consumed
  stamp(0);
  for (int p0 = 0; p0 < d; p0 += kBlock) {
    const int p1 = min(p0 + kBlock, d);
    for (int j0 = p0; j0 < p1; j0 += kPanel) {
      const int w = min(kPanel, d - j0);
      const int ns = R - j0 - w;  // strip rows
      if (tid == 0 || (tid & ~31) < ns) {
        // the diagonal block's lower triangle, rows past w identity
        T a[kPanel][kPanel], inv[kPanel];
#pragma unroll
        for (int i = 0; i < kPanel; ++i)
#pragma unroll
          for (int k = 0; k <= i; ++k) a[i][k] = i < w ? row(P, j0 + i, ld)[j0 + k] : T(i == k ? 1 : 0);
        bool bad = false;
#pragma unroll
        for (int k = 0; k < kPanel; ++k) {
          const T piv = a[k][k];
          bad |= !(piv > T(0) && piv - piv == T(0));  // not positive, or not finite
          inv[k] = rsqrt(piv);  // 1 / l_kk; l_kk = piv / l_kk
          a[k][k] = piv * inv[k];
#pragma unroll
          for (int i = k + 1; i < kPanel; ++i) a[i][k] *= inv[k];
#pragma unroll
          for (int i = k + 1; i < kPanel; ++i)
#pragma unroll
            for (int m = k + 1; m <= i; ++m) a[i][m] -= a[i][k] * a[m][k];
        }
        if (tid == 0) *flag = bad;
        if (!bad) {
          const TrailOp<T> op{P, rb, ld, d, nO, j0, j0 == 0, in};
          for (int r = j0 + w + tid; r < R; r += nt) {
            const SrcRow<T> sr = op.src_row(r);
            T v[kPanel];
#pragma unroll
            for (int k = 0; k < kPanel; ++k) v[k] = k < w ? sr.base[(j0 + k) * sr.stride] : T(0);
#pragma unroll
            for (int k = 0; k < kPanel; ++k) {
              v[k] *= inv[k];
#pragma unroll
              for (int m = k + 1; m < kPanel; ++m) v[m] -= v[k] * a[m][k];
            }
            T* const Pr = row(P, r, ld) + j0;
#pragma unroll
            for (int k = 0; k < kPanel; ++k)
              if (k < w) Pr[k] = v[k];
          }
          if (tid == 0) {
            T* const Lp = Ld + static_cast<long long>(j0) * ldL + j0;
#pragma unroll
            for (int i = 0; i < kPanel; ++i)
#pragma unroll
              for (int k = 0; k <= i; ++k)
                if (i < w) Lp[i * ldL + k] = a[i][k];
          }
        }
      }
      __syncthreads();  // the strip's rows are in place, and the flag
      stamp(1);
      if (*flag) return false;
      if (j0 + kPanel < p1) {  // the block's later columns
        update<kPanel, kVec, T>(TrailOp<T>{P, rb, ld, d, nO, j0, j0 == 0, in}, j0 + kPanel, R, p1, d, kPanel);
        __syncthreads();
        stamp(2);
      }
    }
    if (p1 < d) {  // the columns past the block, kBlock deep
      update<kBlock, kVec, T>(TrailOp<T>{P, rb, ld, d, nO, p0, p0 == 0, in}, p1, R, d, d, kBlock);
      __syncthreads();
      stamp(2);
    }
  }
  return true;
}

}  // namespace wide
}  // namespace
