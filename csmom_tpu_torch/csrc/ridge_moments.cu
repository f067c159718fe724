// The intraday ridge fit with its expanding time-series CV from segment
// co-moments: K4.
//
// Replaces no TPU kernel.  The JAX package leaves its ridge to XLA
// (csmom_tpu/models/ridge.py: masked einsums over the [A*R, F] design per
// fold).  The port's harness (models/ridge.py::time_series_cv_harness with
// _masked_ridge) passes over the materialised f64 design about thirty
// times a fit: the scaler's two passes, a scaled copy, and per solve a
// masked mean, a centred masked copy, a [F, A*R] x [A*R, F] DGEMM, a gemv,
// the prediction over every row and a masked MSE.  Yet the fit depends on
// few numbers.  Let the training rows be the valid rows whose global row
// ordinal (the count of valid rows before them in (asset, row) order) is
// below n_train, and let ts = n_train / (n_splits + 1).  They fall into
// S = n_splits + 1 segments of ordinals: S0 = [0, n_train - n_splits ts)
// and S1..S_{n_splits}, ts ordinals each.  Fold i trains on S0..S_i and
// tests on S_{i+1}; the final fit and the scaler use every segment.  Each
// segment's row count n, mean of z = [x (F = 5 features), y] and centred
// co-moment matrix M2 = sum (z - mean)(z - mean)^T (21 values) give, in
// closed form:
//   - the scaler: mean m and std s (ddof 0) of the final union, s -> 1
//     where s <= 1e-12 max(|m|, 1);
//   - each fit on a union U: G = D^-1 M2_xx D^-1 + alpha I, b = D^-1 M2_xy
//     (D = diag(s)), beta = G^-1 b (Cholesky), intercept = ybar - ((xbar -
//     m) / s) . beta;
//   - each fold's CV MSE on its test segment T (n_t rows), with b' =
//     beta / s and d = ((xbar_t - m) / s) . beta + intercept - ybar_t:
//     (b'^T M2_xx b' - 2 b'^T M2_xy + M2_yy) / n_t + d^2, and 0 for an
//     empty test segment (the harness's sum / clamp(n, 1)).
// Features are read with nan_to_num (NaN -> 0, +-inf -> +-max), as the
// harness's design is; so is the label.
//
// What bounds it on the H100: bytes.  The moments pass reads the [A*R, 5]
// features, the label and the validity of the training rows once, and the
// score pass reads the features and the validity of every row and writes
// the [A, R] scores once: at the intraday cell's 11.5M rows in f64, 564 MB
// and 563 MB (0.336 ms at 3.35 TB/s; the moments pass stops at the last
// training row, so it reads ~70% of its share).  The arithmetic, 27
// multiply-adds a training row and five quotients a scored row, is far
// under the f64 rate.
//
// Four kernels in one entry call, all on the caller's stream, no host
// sync, no atomics: the same bits on every run.
//   1. ridge_count_kernel: block b counts the valid rows of its chunk of
//      `per` tiles of kTile = 1024 rows (16-byte loads of the validity).
//   2. ridge_moments_kernel: block b sums the counts before its chunk, so
//      it knows the ordinal of its first valid row and n_train (every
//      block reads the same B counts, which are integers).  It walks its
//      chunk a tile at a time, staged into shared memory with cp.async
//      (16-byte copies, the next tile in flight while this one is summed;
//      a row is 40 bytes, so a thread's own row would not coalesce).  A
//      tile's ordinals come from one ballot a warp and a 32-entry scan.
//      Thread t takes rows t, t + 256, t + 512 and t + 768 of each tile
//      and keeps for the current segment its count, a shift K (its first
//      training row of that segment) and the shifted sums sum (z - K)
//      (6) and sum (z - K)(z - K)^T (21): the features run to 1e8 against
//      their spread, so raw sums of squares would cancel.  When the
//      segment changes (block-uniform, at most S times a block), every
//      thread turns its sums into (n, mean, M2) and the block merges them
//      with Chan's pairwise formula (mean_ab = mean_a + d n_b / n, M2_ab
//      = M2_a + M2_b + d d^T n_a n_b / n, d = mean_b - mean_a) in a fixed
//      tree: warp shuffles 16, 8, 4, 2, 1, then the 8 warps in order.  A
//      block stops at its first tile past n_train and writes its S
//      partials (zeros for segments it never met).
//   3. ridge_solve_kernel (one block): merges each segment's B partials
//      in a fixed tree (thread t takes partials t, t + 256, ... in order,
//      then the block tree of step 2); thread 0 the scaler from the union
//      of every segment, then thread k the union S0..S_k (merged in the
//      same order), fit k (5 x 5 Cholesky) and fold k's CV MSE, the last
//      thread the final fit.  Writes [coef 5, intercept, mean 5, std 5,
//      cv_mse n_splits] and n_train (int32).
//   4. ridge_score_kernel: a block a tile, staged the same way; writes
//      ((x - m) / s) . coef + intercept at valid rows, NaN elsewhere.
// f32 inputs accumulate in f32 (counts are integers), as the harness's do.
//
// Layout: features T[N, 5], label T[N], valid bool[N], N = A * R, rows in
// (asset, row) order, each base 16-byte aligned (ops/kernels.py copies a
// misaligned input).  The plan (B blocks of `per` tiles) comes from
// ops/kernels.py::_ridge_plan and is re-checked here: a mismatch returns
// cudaErrorInvalidValue.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kF = 5;                     // features
constexpr int kC = kF + 1;                // columns of z: features, label
constexpr int kM2 = kC * (kC + 1) / 2;    // co-moments, upper triangle
constexpr int kVals = kC + kM2;           // a partial's floats: mean, M2
constexpr int kThreads = 256;
constexpr int kRows = 4;                  // rows a thread takes of a tile
constexpr int kTile = kThreads * kRows;   // 1024 rows a tile
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = kTile / 32;       // 32-row groups of a tile
constexpr int kMaxBlocks = 528;           // four on each of 132 SMs
constexpr int kMaxSegments = 33;          // n_splits <= 32

// upper-triangle index of (i, j), i <= j < kC, row by row
__host__ __device__ constexpr int tri(int i, int j) {
  return i * kC - i * (i - 1) / 2 + (j - i);
}

template <typename T>
__device__ __forceinline__ T clean(T v) {
  const T big = sizeof(T) == 8 ? static_cast<T>(DBL_MAX) : static_cast<T>(FLT_MAX);
  return isnan(v) ? T(0) : (isinf(v) ? (v > T(0) ? big : -big) : v);
}

template <typename T>
__device__ __forceinline__ T quiet_nan();
template <>
__device__ __forceinline__ float quiet_nan<float>() {
  return __int_as_float(0x7FC00000);
}
template <>
__device__ __forceinline__ double quiet_nan<double>() {
  return __longlong_as_double(0x7FF8000000000000ll);
}

// (n, mean, M2) of a set of rows; an empty set is all zeros
template <typename T>
struct Mom {
  long long n;
  T v[kVals];  // mean [kC], then M2 [kM2]
};

template <typename T>
__device__ __forceinline__ void zero(Mom<T>& m) {
  m.n = 0;
#pragma unroll
  for (int i = 0; i < kVals; ++i) m.v[i] = T(0);
}

// a <- a merged with b (Chan et al.); exact for an empty side
template <typename T>
__device__ __forceinline__ void merge(Mom<T>& a, const Mom<T>& b) {
  const long long n = a.n + b.n;
  const T nn = n > 0 ? static_cast<T>(n) : T(1);
  const T f = static_cast<T>(b.n) / nn;
  const T g = static_cast<T>(a.n) * f;
  T d[kC];
#pragma unroll
  for (int i = 0; i < kC; ++i) d[i] = b.v[i] - a.v[i];
#pragma unroll
  for (int i = 0; i < kC; ++i) {
#pragma unroll
    for (int j = i; j < kC; ++j)
      a.v[kC + tri(i, j)] = a.v[kC + tri(i, j)] + b.v[kC + tri(i, j)] + d[i] * d[j] * g;
  }
#pragma unroll
  for (int i = 0; i < kC; ++i) a.v[i] = a.v[i] + d[i] * f;
  a.n = n;
}

template <typename T>
__device__ __forceinline__ Mom<T> shfl_down(const Mom<T>& m, int off) {
  Mom<T> o;
  o.n = __shfl_down_sync(0xFFFFFFFFu, m.n, off);
#pragma unroll
  for (int i = 0; i < kVals; ++i) o.v[i] = __shfl_down_sync(0xFFFFFFFFu, m.v[i], off);
  return o;
}

// Merges every thread's m in a fixed tree (lanes 16, 8, 4, 2, 1, then the
// warps in order) into *out (merged after its value).  Called by the
// whole block; slots holds kWarps partials in shared memory.
template <typename T>
__device__ void block_merge(Mom<T> m, Mom<T>* slots, Mom<T>* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Mom<T> o = shfl_down(m, off);
    if (lane + off < 32) merge(m, o);
  }
  if (lane == 0) slots[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    Mom<T> r = slots[0];
    for (int w = 1; w < kWarps; ++w) merge(r, slots[w]);
    merge(*out, r);
  }
  __syncthreads();
}

// a thread's running sums of one segment about its shift K
template <typename T>
struct Acc {
  long long n;
  T k[kC], s1[kC], s2[kM2];

  __device__ __forceinline__ void reset() {
    n = 0;
#pragma unroll
    for (int i = 0; i < kC; ++i) k[i] = s1[i] = T(0);
#pragma unroll
    for (int i = 0; i < kM2; ++i) s2[i] = T(0);
  }

  __device__ __forceinline__ void add(const T (&z)[kC]) {
    if (n == 0) {
#pragma unroll
      for (int i = 0; i < kC; ++i) k[i] = z[i];
    }
    T d[kC];
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      d[i] = z[i] - k[i];
      s1[i] += d[i];
    }
#pragma unroll
    for (int i = 0; i < kC; ++i) {
#pragma unroll
      for (int j = i; j < kC; ++j) s2[tri(i, j)] += d[i] * d[j];
    }
    ++n;
  }

  __device__ __forceinline__ Mom<T> moments() const {
    Mom<T> m;
    m.n = n;
    const T nn = n > 0 ? static_cast<T>(n) : T(1);
#pragma unroll
    for (int i = 0; i < kC; ++i) m.v[i] = n > 0 ? k[i] + s1[i] / nn : T(0);
#pragma unroll
    for (int i = 0; i < kC; ++i) {
#pragma unroll
      for (int j = i; j < kC; ++j)
        m.v[kC + tri(i, j)] = s2[tri(i, j)] - s1[i] * s1[j] / nn;
    }
    return m;
  }
};

// n_train = floor(n_total * frac) in T, frac by the small-panel rule: the
// harness's arithmetic in the features' dtype
template <typename T>
__device__ __forceinline__ long long train_rows(long long total, double frac,
                                                double frac_small,
                                                long long small_threshold) {
  const T f = total > small_threshold ? static_cast<T>(frac) : static_cast<T>(frac_small);
  const T p = static_cast<T>(total) * f;
  return static_cast<long long>(floor(p));
}

// Sum over threads of v, on every thread (block-wide; uses red[kWarps]).
__device__ __forceinline__ long long block_sum(long long v, long long* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, off);
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  long long s = 0;
  for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int n) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Issue the copy of nbytes from 16-byte-aligned src to 16-byte-aligned
// shared dst, 16 bytes a piece (the last piece zero-filled past nbytes).
__device__ __forceinline__ void stage(unsigned char* dst, const unsigned char* src,
                                      long long nbytes) {
  const int pieces = static_cast<int>((nbytes + 15) >> 4);
  for (int p = threadIdx.x; p < pieces; p += kThreads) {
    const long long o = static_cast<long long>(p) << 4;
    const long long left = nbytes - o;
    cp_async16(dst + o, src + o, left < 16 ? static_cast<int>(left) : 16);
  }
}

// A tile's shared-memory image: features [kTile][kF], then the label
// [kTile] where the pass reads it, then validity [kTile] bytes; each part
// 16-byte aligned.
template <typename T>
struct TileBuf {
  static constexpr size_t kX = sizeof(T) * kTile * kF;
  static constexpr size_t kY = sizeof(T) * kTile;
  static __host__ __device__ constexpr size_t bytes(bool label) {
    return kX + (label ? kY : 0) + kTile;
  }
  static __device__ __forceinline__ T* x(unsigned char* b) { return reinterpret_cast<T*>(b); }
  static __device__ __forceinline__ T* y(unsigned char* b) { return reinterpret_cast<T*>(b + kX); }
  static __device__ __forceinline__ unsigned char* v(unsigned char* b, bool label) {
    return b + kX + (label ? kY : 0);
  }
};

// Issue the copies of one tile into buf (the label only where label) as
// one cp.async group.
template <typename T>
__device__ __forceinline__ void stage_tile(unsigned char* buf, const T* x, const T* y,
                                           const unsigned char* valid, long long tile,
                                           long long N, bool label) {
  using B = TileBuf<T>;
  const long long r0 = tile * kTile;
  const long long rows = min(static_cast<long long>(kTile), N - r0);
  stage(buf, reinterpret_cast<const unsigned char*>(x + r0 * kF), rows * kF * sizeof(T));
  if (label)
    stage(reinterpret_cast<unsigned char*>(B::y(buf)),
          reinterpret_cast<const unsigned char*>(y + r0), rows * sizeof(T));
  stage(B::v(buf, label), valid + r0, rows);
  cp_async_commit();
}

// -- 1. valid rows of each block's chunk -----------------------------------

__global__ void __launch_bounds__(kThreads)
    ridge_count_kernel(const unsigned char* __restrict__ valid, int* __restrict__ counts,
                       long long N, int per) {
  __shared__ long long red[kWarps];
  const long long start = static_cast<long long>(blockIdx.x) * per * kTile;
  const long long end = min(N, start + static_cast<long long>(per) * kTile);
  long long c = 0;
  const long long body = start + ((end - start) & ~15ll);
  for (long long i = start + 16ll * threadIdx.x; i < body; i += 16ll * kThreads) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(valid + i));
    c += (__popc(__vcmpne4(q.x, 0u)) + __popc(__vcmpne4(q.y, 0u)) +
          __popc(__vcmpne4(q.z, 0u)) + __popc(__vcmpne4(q.w, 0u))) >> 3;
  }
  for (long long i = body + threadIdx.x; i < end; i += kThreads) c += valid[i] != 0;
  c = block_sum(c, red);
  if (threadIdx.x == 0) counts[blockIdx.x] = static_cast<int>(c);
}

// -- 2. segment partials of each block's chunk ------------------------------

template <typename T>
struct MomentsSmem {
  static size_t bytes(int n_seg) {
    return 2 * TileBuf<T>::bytes(true) + sizeof(Mom<T>) * (kWarps + n_seg);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    ridge_moments_kernel(const T* __restrict__ x, const T* __restrict__ y,
                         const unsigned char* __restrict__ valid,
                         const int* __restrict__ counts, T* __restrict__ part,
                         long long* __restrict__ part_n, long long N, int per,
                         int n_seg, double frac, double frac_small,
                         long long small_threshold) {
  using B = TileBuf<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  Mom<T>* slots = reinterpret_cast<Mom<T>*>(smem + 2 * B::bytes(true));
  Mom<T>* seg_part = slots + kWarps;
  __shared__ long long red[kWarps];
  __shared__ int gcnt[kGroups];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b = blockIdx.x, nb = gridDim.x;
  for (int s = t; s < n_seg; s += kThreads) zero(seg_part[s]);

  // the ordinal of this chunk's first valid row, and the panel's total
  long long before = 0, total = 0;
  for (int i = t; i < nb; i += kThreads) {
    total += counts[i];
    if (i < b) before += counts[i];
  }
  before = block_sum(before, red);
  total = block_sum(total, red);
  const long long n_train = train_rows<T>(total, frac, frac_small, small_threshold);
  const long long ts = n_train / n_seg;
  const long long b1 = n_train - (n_seg - 1) * ts;  // S1's first ordinal
  auto seg_of = [&](long long o) -> int {
    return o < b1 ? 0 : 1 + static_cast<int>((o - b1) / ts);
  };

  const long long n_tiles = (N + kTile - 1) / kTile;
  const long long tile0 = static_cast<long long>(b) * per;
  const long long tile_end = min(n_tiles, tile0 + per);
  long long base = before;
  int cur = -1;
  Acc<T> acc;
  acc.reset();
  // two tile buffers: tile i in buffer i & 1
  if (tile0 < tile_end && base < n_train) stage_tile(smem, x, y, valid, tile0, N, true);
  for (long long tile = tile0; tile < tile_end && base < n_train; ++tile) {
    const int k = static_cast<int>(tile - tile0) & 1;
    cp_async_wait_all();
    __syncthreads();  // this tile is staged; every thread is done with the other buffer
    if (tile + 1 < tile_end)
      stage_tile(smem + (k ^ 1) * B::bytes(true), x, y, valid, tile + 1, N, true);
    unsigned char* buf = smem + k * B::bytes(true);
    const long long r0 = tile * kTile;

    // each row's ordinal: a ballot a 32-row group, then the groups' scan
    bool v[kRows];
    unsigned mask[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int row = q * kThreads + t;
      v[q] = r0 + row < N && B::v(buf, true)[row] != 0;
      mask[q] = __ballot_sync(0xFFFFFFFFu, v[q]);
      if (lane == 0) gcnt[q * kWarps + warp] = __popc(mask[q]);
    }
    __syncthreads();
    const int gc = gcnt[lane];  // kGroups == 32: one group a lane
    int incl = gc;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xFFFFFFFFu, incl, off);
      if (lane >= off) incl += o;
    }
    const int tile_cnt = __shfl_sync(0xFFFFFFFFu, incl, 31);
    long long ord[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int g = q * kWarps + warp;
      const int excl = __shfl_sync(0xFFFFFFFFu, incl - gc, g);
      ord[q] = base + excl + __popc(mask[q] & ((1u << lane) - 1u));
    }

    // the segments of this tile's training rows (block-uniform)
    const long long last = min(base + tile_cnt, n_train) - 1;
    if (tile_cnt > 0) {
      const int lo = seg_of(base), hi = seg_of(last);
      for (int s = lo; s <= hi; ++s) {
        if (s != cur) {
          if (cur >= 0) block_merge(acc.moments(), slots, &seg_part[cur]);
          acc.reset();
          cur = s;
        }
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          if (v[q] && ord[q] < n_train && (lo == hi || seg_of(ord[q]) == s)) {
            const int row = q * kThreads + t;
            T z[kC];
#pragma unroll
            for (int f = 0; f < kF; ++f) z[f] = clean(B::x(buf)[row * kF + f]);
            z[kF] = clean(B::y(buf)[row]);
            acc.add(z);
          }
        }
      }
    }
    base += tile_cnt;
  }
  cp_async_wait_all();  // a prefetch past the last training row lands unused
  if (cur >= 0) block_merge(acc.moments(), slots, &seg_part[cur]);
  __syncthreads();
  for (int i = t; i < n_seg * (kVals + 1); i += kThreads) {
    const int s = i / (kVals + 1), c = i % (kVals + 1);
    const size_t p = static_cast<size_t>(s) * nb + b;
    if (c == kVals)
      part_n[p] = seg_part[s].n;
    else
      part[p * kVals + c] = seg_part[s].v[c];
  }
}

// -- 3. segments, unions, scaler, fits, CV ----------------------------------

// Solves G beta = rhs for symmetric positive definite G (5 x 5, upper
// triangle used) by Cholesky.
template <typename T>
__device__ void spd_solve(const T (&G)[kF][kF], const T (&rhs)[kF], T (&beta)[kF]) {
  T L[kF][kF];
#pragma unroll
  for (int j = 0; j < kF; ++j) {
    T d = G[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) d -= L[j][k] * L[j][k];
    L[j][j] = sqrt(d);
#pragma unroll
    for (int i = j + 1; i < kF; ++i) {
      T e = G[j][i];
#pragma unroll
      for (int k = 0; k < j; ++k) e -= L[i][k] * L[j][k];
      L[i][j] = e / L[j][j];
    }
  }
  T w[kF];
#pragma unroll
  for (int i = 0; i < kF; ++i) {
    T e = rhs[i];
#pragma unroll
    for (int k = 0; k < i; ++k) e -= L[i][k] * w[k];
    w[i] = e / L[i][i];
  }
#pragma unroll
  for (int i = kF - 1; i >= 0; --i) {
    T e = w[i];
#pragma unroll
    for (int k = i + 1; k < kF; ++k) e -= L[k][i] * beta[k];
    beta[i] = e / L[i][i];
  }
}

// The ridge fit on union U under the scaler (m, s): beta and intercept.
template <typename T>
__device__ void fit_union(const Mom<T>& U, const T (&m)[kF], const T (&s)[kF], T alpha,
                          T (&beta)[kF], T& icept) {
  T G[kF][kF], rhs[kF];
#pragma unroll
  for (int i = 0; i < kF; ++i) {
#pragma unroll
    for (int j = i; j < kF; ++j)
      G[i][j] = U.v[kC + tri(i, j)] / (s[i] * s[j]) + (i == j ? alpha : T(0));
    rhs[i] = U.v[kC + tri(i, kF)] / s[i];
  }
  spd_solve(G, rhs, beta);
  T xb = T(0);
#pragma unroll
  for (int i = 0; i < kF; ++i) xb += (U.v[i] - m[i]) / s[i] * beta[i];
  icept = U.v[kF] - xb;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ridge_solve_kernel(const int* __restrict__ counts, const T* __restrict__ part,
                       const long long* __restrict__ part_n, int nb, int n_seg, T alpha,
                       double frac, double frac_small, long long small_threshold,
                       T* __restrict__ fit, int* __restrict__ n_train_out) {
  __shared__ Mom<T> seg[kMaxSegments];
  __shared__ Mom<T> slots[kWarps];
  __shared__ long long red[kWarps];
  const int t = threadIdx.x;

  long long total = 0;
  for (int i = t; i < nb; i += kThreads) total += counts[i];
  total = block_sum(total, red);

  for (int s = 0; s < n_seg; ++s) {
    if (t == 0) zero(seg[s]);
    Mom<T> m;
    zero(m);
    for (int i = t; i < nb; i += kThreads) {
      const size_t p = static_cast<size_t>(s) * nb + i;
      Mom<T> o;
      o.n = part_n[p];
#pragma unroll
      for (int c = 0; c < kVals; ++c) o.v[c] = part[p * kVals + c];
      merge(m, o);
    }
    __syncthreads();  // seg[s] zeroed before thread 0 merges into it
    block_merge(m, slots, &seg[s]);
  }
  // the scaler, from the union of every segment (thread 0)
  __shared__ T m_s[kF], sd_s[kF];
  if (t == 0) {
    n_train_out[0] = static_cast<int>(train_rows<T>(total, frac, frac_small, small_threshold));
    Mom<T> U = seg[0];
    for (int s = 1; s < n_seg; ++s) merge(U, seg[s]);
    const T nn = U.n > 0 ? static_cast<T>(U.n) : T(1);
#pragma unroll
    for (int f = 0; f < kF; ++f) {
      const T sf = sqrt(U.v[kC + tri(f, f)] / nn);
      const T tiny = T(1e-12) * fmax(fabs(U.v[f]), T(1));
      m_s[f] = U.v[f];
      sd_s[f] = sf > tiny ? sf : T(1);
      fit[kF + 1 + f] = m_s[f];
      fit[2 * kF + 1 + f] = sd_s[f];
    }
  }
  __syncthreads();
  if (t >= n_seg) return;

  // thread k: fit k on the union S0..S_k (merged in the scaler's order),
  // then fold k's MSE on S_{k+1}, or the final fit where k = S - 1
  const int k = t;
  T m[kF], sd[kF];
#pragma unroll
  for (int f = 0; f < kF; ++f) {
    m[f] = m_s[f];
    sd[f] = sd_s[f];
  }
  Mom<T> U = seg[0];
  for (int s = 1; s <= k; ++s) merge(U, seg[s]);
  T beta[kF], icept;
  fit_union(U, m, sd, alpha, beta, icept);
  if (k == n_seg - 1) {
#pragma unroll
    for (int f = 0; f < kF; ++f) fit[f] = beta[f];
    fit[kF] = icept;
    return;
  }
  const Mom<T>& te = seg[k + 1];
  T mse = T(0);
  if (te.n > 0) {
    T bp[kF], d = icept - te.v[kF], q = te.v[kC + tri(kF, kF)];
#pragma unroll
    for (int i = 0; i < kF; ++i) {
      bp[i] = beta[i] / sd[i];
      d += (te.v[i] - m[i]) / sd[i] * beta[i];
    }
#pragma unroll
    for (int i = 0; i < kF; ++i) {
      q -= T(2) * bp[i] * te.v[kC + tri(i, kF)];
      q += bp[i] * bp[i] * te.v[kC + tri(i, i)];
#pragma unroll
      for (int j = i + 1; j < kF; ++j) q += T(2) * bp[i] * bp[j] * te.v[kC + tri(i, j)];
    }
    mse = fmax(q, T(0)) / static_cast<T>(te.n) + d * d;
  }
  fit[3 * kF + 1 + k] = mse;
}

// -- 4. scores ----------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ridge_score_kernel(const T* __restrict__ x, const unsigned char* __restrict__ valid,
                       const T* __restrict__ fit, T* __restrict__ scores, long long N) {
  using B = TileBuf<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const long long tile = blockIdx.x;
  stage_tile(smem, x, static_cast<const T*>(nullptr), valid, tile, N, false);
  T coef[kF], m[kF], sd[kF];
#pragma unroll
  for (int f = 0; f < kF; ++f) {
    coef[f] = __ldg(fit + f);
    m[f] = __ldg(fit + kF + 1 + f);
    sd[f] = __ldg(fit + 2 * kF + 1 + f);
  }
  const T icept = __ldg(fit + kF);
  cp_async_wait_all();
  __syncthreads();
  const long long r0 = tile * kTile;
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int row = q * kThreads + threadIdx.x;
    if (r0 + row < N) {
      T s = T(0);
#pragma unroll
      for (int f = 0; f < kF; ++f) s += (clean(B::x(smem)[row * kF + f]) - m[f]) / sd[f] * coef[f];
      scores[r0 + row] = B::v(smem, false)[row] != 0 ? s + icept : quiet_nan<T>();
    }
  }
}

// -- launch -------------------------------------------------------------------

// the plan: B blocks of `per` tiles, at most kMaxBlocks blocks
void plan(long long N, int* blocks, int* per) {
  const long long tiles = (N + kTile - 1) / kTile;
  if (tiles == 0) {
    *blocks = 1;
    *per = 0;
    return;
  }
  const long long b0 = tiles < kMaxBlocks ? tiles : kMaxBlocks;
  const long long p = (tiles + b0 - 1) / b0;
  *per = static_cast<int>(p);
  *blocks = static_cast<int>((tiles + p - 1) / p);
}

template <typename T>
int launch(const void* x, const void* y, const void* valid, void* counts, void* part,
           void* part_n, void* fit, void* n_train, void* scores, long long N, int n_seg,
           int blocks, int per, double alpha, double frac, double frac_small,
           long long small_threshold, int device, void* stream) {
  int want_blocks = 0, want_per = 0;
  plan(N, &want_blocks, &want_per);
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
                          reinterpret_cast<uintptr_t>(valid);
  if (N < 0 || n_seg < 2 || n_seg > kMaxSegments || blocks != want_blocks ||
      per != want_per || device < 0 || (align & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  // the moments kernel's dynamic shared memory cap (two blocks an SM),
  // and both staged kernels' preference for shared memory over L1, set
  // once per device
  constexpr int kDevices = 64;
  static bool raised[kDevices] = {};
  if (device >= kDevices || !raised[device]) {
    err = cudaFuncSetAttribute(ridge_moments_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(MomentsSmem<T>::bytes(kMaxSegments)));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ridge_moments_kernel<T>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ridge_score_kernel<T>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < kDevices) raised[device] = true;
  }
  const size_t smem = MomentsSmem<T>::bytes(n_seg);
  const auto* xv = static_cast<const T*>(x);
  const auto* yv = static_cast<const T*>(y);
  const auto* vv = static_cast<const unsigned char*>(valid);
  ridge_count_kernel<<<blocks, kThreads, 0, st>>>(vv, static_cast<int*>(counts), N, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ridge_moments_kernel<T><<<blocks, kThreads, smem, st>>>(
      xv, yv, vv, static_cast<const int*>(counts), static_cast<T*>(part),
      static_cast<long long*>(part_n), N, per, n_seg, frac, frac_small, small_threshold);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ridge_solve_kernel<T><<<1, kThreads, 0, st>>>(
      static_cast<const int*>(counts), static_cast<const T*>(part),
      static_cast<const long long*>(part_n), blocks, n_seg, static_cast<T>(alpha), frac,
      frac_small, small_threshold, static_cast<T*>(fit), static_cast<int*>(n_train));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (N + kTile - 1) / kTile;
  if (tiles > 0) {
    if (tiles > 0x7FFFFFFFll) return static_cast<int>(cudaErrorInvalidValue);
    // x and valid of one tile: under the 48 KB a block may take unasked
    const size_t score_smem = TileBuf<T>::bytes(false);
    ridge_score_kernel<T><<<static_cast<unsigned>(tiles), kThreads, score_smem, st>>>(
        xv, vv, static_cast<const T*>(fit), static_cast<T*>(scores), N);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

int csmom_ridge_moments_f32(const void* x, const void* y, const void* valid, void* counts,
                            void* part, void* part_n, void* fit, void* n_train,
                            void* scores, long long N, int n_seg, int blocks, int per,
                            double alpha, double frac, double frac_small,
                            long long small_threshold, int device, void* stream) {
  return launch<float>(x, y, valid, counts, part, part_n, fit, n_train, scores, N, n_seg,
                       blocks, per, alpha, frac, frac_small, small_threshold, device,
                       stream);
}

int csmom_ridge_moments_f64(const void* x, const void* y, const void* valid, void* counts,
                            void* part, void* part_n, void* fit, void* n_train,
                            void* scores, long long N, int n_seg, int blocks, int per,
                            double alpha, double frac, double frac_small,
                            long long small_threshold, int device, void* stream) {
  return launch<double>(x, y, valid, counts, part, part_n, fit, n_train, scores, N,
                        n_seg, blocks, per, alpha, frac, frac_small, small_threshold,
                        device, stream);
}

const char* csmom_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
