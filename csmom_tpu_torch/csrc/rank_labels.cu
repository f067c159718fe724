// Rank-mode decile labels for every (lead, month) cross-section of a
// [..., A, M] panel, in one launch: K3.
//
// Replaces no TPU kernel.  The JAX package's rank mode sorts in XLA
// (csmom_tpu/ops/ranking.py); the port's plain version,
// ops/ranking.py::_rank_labels, transposes the panel into rows, builds
// int64 keys, runs one stable torch.sort and nine rounds of gathers and
// compares over the keys: about 150 launches and 2.6 ms at the north star
// ([4, 3000, 696] f32, the grid's ranking phase).  K3 computes the same
// labels, bit for bit:
//   - a row is the cross-section (l, m): lanes a = 0..A-1 at x[l, a, m],
//     read in place through the panel's strides (a stride-0 lead axis, as
//     the sector path's expand gives, included);
//   - valid lanes are ordered by the key of ops/ranking.py::sortable_bits
//     (-0.0 folded onto +0.0, a negative float's magnitude bits flipped;
//     32-bit keys for f32, 64-bit for f64), ties by lane position;
//     invalid lanes never enter the order;
//   - a valid lane of 0-based rank r in a row of n valid lanes gets
//     #{k in 1..B-1 : r + 1 >= ceil(k n / B)} = min(B - 1, (r + 1) B / n)
//     (integer division), an invalid lane -1, and the row's n_eff is
//     min(n, B).
//
// What bounds it on the H100: bytes.  The panel and its validity are read
// once and the int32 labels written once: 75.18 MB at the north star in
// f32, 0.0224 ms at 3.35 TB/s.  A row's lanes lie M elements apart, so a
// read of one lane uses 4 of a 32-byte sector, and a row's sort is a
// chain of block-wide steps.  The design:
//   - a block ranks a tile of G consecutive months of one lead (G = 2, or
//     1 where two months do not fit in shared memory).  It first stages
//     the tile's keys and validity in shared memory with loads in which
//     neighbouring threads take neighbouring months of one asset, all of a
//     thread's kStageUnroll loads issued before their stores; consecutive
//     blocks take consecutive tiles, so the sectors they share come from
//     L2.  The labels go out the same way at the end;
//   - for each month, each thread takes ITEMS consecutive lanes from the
//     tile; a block-wide exclusive sum of the valid counts places the
//     valid lanes, in lane order, first in a shared-memory row with their
//     16-bit positions beside the keys; pad slots follow.  No int64 key
//     array reaches device memory;
//   - CUB's BlockRadixSort (a header building block) sorts the row's
//     (key, position) pairs, 4 bits a pass, stably.  The valid lanes
//     precede the pads in its input, so they are its first n outputs in
//     (key, position) order even where a valid NaN's key equals the pads'
//     all-ones key: stability, not a sentinel, decides.  Thread t then
//     holds ranks t * ITEMS .. t * ITEMS + ITEMS - 1 and writes each valid
//     lane's label into the tile, over that month's keys;
//   - the row width picks the instance (threads, items): the smallest of
//     kPlans whose threads * items holds A, so a 128-lane serving row and
//     the 3000-lane north star run the same code with other parameters.
//     Rows wider than kMaxLanes = 8192 are not launched here
//     (ops/kernels.py routes them to the plain sort and counts them).
// Measured at the north star in f32 (NVIDIA H100 80GB HBM3, 700 W; PERF.md,
// PR 25): one block a row reading the panel in place, 0.295 ms (without
// its loads 0.208, its stores 0.233, its sort 0.266); tiles of 2, 4 and 8
// months 0.253, 0.268 and 0.355 (fewer blocks fit an SM as the tile
// grows); selecting the B - 1 boundaries by 8-bit radix histograms in
// shared memory instead of sorting, 0.40 to 0.97.
//
// Layout: grid.x = L * ceil(M / G) tiles, tile = l * ceil(M / G) + m / G;
// labels i32[L, A, M] contiguous; n_eff i32[L, M].  The plan comes from
// ops/kernels.py::_rank_plan and is re-checked here: a mismatch returns
// cudaErrorInvalidValue.

#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLanes = 8192;  // the widest plan's row
constexpr int kMaxTile = 2;      // months a block ranks, at most
constexpr int kStageUnroll = 8;  // tile elements a thread loads at once

// (threads, items) instances, by capacity; ops/kernels.py::_RANK_PLANS
// holds the same list
constexpr int kPlans[][2] = {{128, 1},  {128, 4},  {256, 4}, {256, 8},
                             {256, 12}, {512, 8}, {512, 16}};
constexpr int kNumPlans = sizeof(kPlans) / sizeof(kPlans[0]);

template <typename T>
struct Key;
template <>
struct Key<float> {
  using U = uint32_t;
  static __device__ __forceinline__ U of(float x) {
    U b = __float_as_uint(x);
    if ((b & 0x7FFFFFFFu) == 0) b = 0;  // -0.0 -> +0.0
    return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  }
};
template <>
struct Key<double> {
  using U = unsigned long long;
  static __device__ __forceinline__ U of(double x) {
    U b = static_cast<U>(__double_as_longlong(x));
    if ((b & 0x7FFFFFFFFFFFFFFFull) == 0) b = 0;
    return (b & 0x8000000000000000ull) ? ~b : (b | 0x8000000000000000ull);
  }
};

template <typename T, int THREADS, int ITEMS>
struct Plan {
  using U = typename Key<T>::U;
  using Sort = cub::BlockRadixSort<U, THREADS, ITEMS, uint16_t>;
  using Scan = cub::BlockScan<int, THREADS>;
  static constexpr int kCap = THREADS * ITEMS;
  // the row buffer: the compaction's keys and positions, then the sort's
  // storage, rounded to 16 bytes; the month tile follows it
  static constexpr size_t kRow = kCap * sizeof(U) + kCap * sizeof(uint16_t);
  static constexpr size_t kSort = sizeof(typename Sort::TempStorage);
  static constexpr size_t kRowSmem = ((kRow > kSort ? kRow : kSort) + 15) / 16 * 16;
  // the tile of G months: keys U[G][A], then valid bytes [G][A]
  static size_t tile_bytes(int A, int G) {
    return static_cast<size_t>(G) * A * (sizeof(U) + 1);
  }
};

template <typename T, int THREADS, int ITEMS>
__global__ void __launch_bounds__(THREADS)
    rank_labels_kernel(const T* __restrict__ x,
                       const unsigned char* __restrict__ valid,
                       int32_t* __restrict__ labels,
                       int32_t* __restrict__ n_eff, int A, int M, int n_bins,
                       int lg, int tiles, long long xs_l, long long xs_a,
                       long long xs_m, long long vs_l, long long vs_a,
                       long long vs_m, unsigned row_bytes) {
  using P = Plan<T, THREADS, ITEMS>;
  using U = typename P::U;
  using Scan = typename P::Scan;
  using Sort = typename P::Sort;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ typename Scan::TempStorage scan_tmp;
  // the host sized the row buffer from its own view of CUB's types
  if (sizeof(typename Sort::TempStorage) > row_bytes || P::kRow > row_bytes)
    __trap();

  const int G = 1 << lg;
  const long long l = blockIdx.x / tiles;
  const int m0 = static_cast<int>(blockIdx.x % tiles) << lg;
  const int gn = min(G, M - m0);  // months of this tile
  U* kt = reinterpret_cast<U*>(smem + row_bytes);
  unsigned char* vt = reinterpret_cast<unsigned char*>(kt + (static_cast<size_t>(A) << lg));
  const int t = threadIdx.x;

  // stage the tile: element i is (a, g) = (i >> lg, i & (G - 1)), so a
  // warp reads G consecutive months of 32 / G consecutive assets; all of
  // a round's loads are issued before its stores
  {
    const T* xl = x + l * xs_l + m0 * xs_m;
    const unsigned char* vl = valid + l * vs_l + m0 * vs_m;
    const int n_el = A << lg;
    for (int i0 = t; i0 < n_el; i0 += THREADS * kStageUnroll) {
      T xv[kStageUnroll];
      unsigned char vv[kStageUnroll];
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        const int i = i0 + u * THREADS, a = i >> lg, g = i & (G - 1);
        const bool in = i < n_el && g < gn;
        vv[u] = in ? __ldg(vl + a * vs_a + g * vs_m) : 0;
        xv[u] = in ? __ldg(xl + a * xs_a + g * xs_m) : T(0);
      }
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        const int i = i0 + u * THREADS, a = i >> lg, g = i & (G - 1);
        if (i < n_el) {
          vt[g * A + a] = vv[u];
          kt[g * A + a] = Key<T>::of(xv[u]);
        }
      }
    }
  }

  U* rk = reinterpret_cast<U*>(smem);
  uint16_t* rp = reinterpret_cast<uint16_t*>(rk + P::kCap);
  const unsigned long long nb = static_cast<unsigned long long>(n_bins);
  for (int g = 0; g < gn; ++g) {
    __syncthreads();  // the tile is staged; the last month's sort is done
    U* krow = kt + g * A;  // this month's keys, then its labels
    const unsigned char* vrow = vt + g * A;
    U key[ITEMS];
    bool ok[ITEMS];
    int cnt = 0;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int a = t * ITEMS + i;
      ok[i] = a < A && vrow[a] != 0;
      if (ok[i]) {
        key[i] = krow[a];
        ++cnt;
      }
    }
    int off, n;
    Scan(scan_tmp).ExclusiveSum(cnt, off, n);
    if (t == 0) n_eff[l * M + m0 + g] = n < n_bins ? n : n_bins;
    // invalid lanes' labels: each thread overwrites only its own lanes,
    // whose keys it has read
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int a = t * ITEMS + i;
      if (a < A && !ok[i]) krow[a] = static_cast<U>(static_cast<uint32_t>(-1));
    }
    if (n == 0) continue;  // block-uniform

    // the valid lanes first, in lane order; pads after
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      if (ok[i]) {
        rk[off] = key[i];
        rp[off] = static_cast<uint16_t>(t * ITEMS + i);
        ++off;
      }
    }
    __syncthreads();
    uint16_t pos[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int j = t * ITEMS + i;
      key[i] = j < n ? rk[j] : ~U(0);
      pos[i] = j < n ? rp[j] : uint16_t(0);
    }
    __syncthreads();  // the sort reuses the row buffer

    Sort(*reinterpret_cast<typename Sort::TempStorage*>(smem)).Sort(key, pos);

#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int r = t * ITEMS + i;
      if (r < n) {
        const unsigned long long q =
            (static_cast<unsigned long long>(r) + 1) * nb /
            static_cast<unsigned long long>(n);
        krow[pos[i]] = static_cast<U>(static_cast<uint32_t>(q < nb - 1 ? q : nb - 1));
      }
    }
  }
  __syncthreads();

  // the tile's labels out, G consecutive months of an asset together
  int32_t* out = labels + l * static_cast<long long>(A) * M + m0;
  const int n_el = A << lg;
  for (int i = t; i < n_el; i += THREADS) {
    const int a = i >> lg, g = i & (G - 1);
    if (g < gn)
      out[static_cast<long long>(a) * M + g] =
          static_cast<int32_t>(static_cast<uint32_t>(kt[g * A + a]));
  }
}

template <typename T, int THREADS, int ITEMS>
int launch_plan(const void* x, const void* valid, void* labels, void* n_eff,
                int L, int A, int M, int n_bins, const long long* xs,
                const long long* vs, int device, cudaStream_t stream) {
  using P = Plan<T, THREADS, ITEMS>;
  // the instance's dynamic shared-memory cap, raised once per device to
  // all that a block may opt into beside the scan's static memory
  constexpr int kDevices = 64;
  static int caps[kDevices] = {};
  int cap = device < kDevices ? caps[device] : 0;
  if (cap == 0) {
    int optin = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, rank_labels_kernel<T, THREADS, ITEMS>);
    if (err != cudaSuccess) return static_cast<int>(err);
    cap = optin - static_cast<int>(fa.sharedSizeBytes);
    err = cudaFuncSetAttribute(rank_labels_kernel<T, THREADS, ITEMS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               cap);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < kDevices) caps[device] = cap;
  }
  // months a block: the largest power of two up to kMaxTile whose tile
  // fits beside the row buffer
  int lg = 0;
  while ((1 << (lg + 1)) <= kMaxTile &&
         P::kRowSmem + P::tile_bytes(A, 1 << (lg + 1)) <= static_cast<size_t>(cap))
    ++lg;
  const size_t smem = P::kRowSmem + P::tile_bytes(A, 1 << lg);
  if (smem > static_cast<size_t>(cap))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (M + (1 << lg) - 1) >> lg;
  const long long blocks = static_cast<long long>(L) * tiles;
  if (blocks > 0x7FFFFFFFll) return static_cast<int>(cudaErrorInvalidValue);
  rank_labels_kernel<T, THREADS, ITEMS>
      <<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
          static_cast<const T*>(x), static_cast<const unsigned char*>(valid),
          static_cast<int32_t*>(labels), static_cast<int32_t*>(n_eff), A, M,
          n_bins, lg, tiles, xs[0], xs[1], xs[2], vs[0], vs[1], vs[2],
          static_cast<unsigned>(P::kRowSmem));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* valid, void* labels, void* n_eff,
           int L, int A, int M, int n_bins, long long xs_l, long long xs_a,
           long long xs_m, long long vs_l, long long vs_a, long long vs_m,
           int threads, int items, int device, void* stream) {
  // the plan must be the smallest instance that holds a row
  int p = 0;
  while (p < kNumPlans && kPlans[p][0] * kPlans[p][1] < A) ++p;
  if (p == kNumPlans || A < 1 || A > kMaxLanes || L < 1 || M < 1 ||
      n_bins < 1 || device < 0 || threads != kPlans[p][0] ||
      items != kPlans[p][1])
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long xs[3] = {xs_l, xs_a, xs_m};
  const long long vs[3] = {vs_l, vs_a, vs_m};
  switch (p) {
    case 0:
      return launch_plan<T, 128, 1>(x, valid, labels, n_eff, L, A, M,
                                    n_bins, xs, vs, device, st);
    case 1:
      return launch_plan<T, 128, 4>(x, valid, labels, n_eff, L, A, M,
                                    n_bins, xs, vs, device, st);
    case 2:
      return launch_plan<T, 256, 4>(x, valid, labels, n_eff, L, A, M,
                                    n_bins, xs, vs, device, st);
    case 3:
      return launch_plan<T, 256, 8>(x, valid, labels, n_eff, L, A, M,
                                    n_bins, xs, vs, device, st);
    case 4:
      return launch_plan<T, 256, 12>(x, valid, labels, n_eff, L, A, M,
                                     n_bins, xs, vs, device, st);
    case 5:
      return launch_plan<T, 512, 8>(x, valid, labels, n_eff, L, A, M,
                                    n_bins, xs, vs, device, st);
    default:
      return launch_plan<T, 512, 16>(x, valid, labels, n_eff, L, A, M,
                                     n_bins, xs, vs, device, st);
  }
}

}  // namespace

extern "C" {

int csmom_rank_labels_f32(const void* x, const void* valid, void* labels,
                          void* n_eff, int L, int A, int M, int n_bins,
                          long long xs_l, long long xs_a, long long xs_m,
                          long long vs_l, long long vs_a, long long vs_m,
                          int threads, int items, int device, void* stream) {
  return launch<float>(x, valid, labels, n_eff, L, A, M, n_bins, xs_l, xs_a,
                       xs_m, vs_l, vs_a, vs_m, threads, items, device, stream);
}

int csmom_rank_labels_f64(const void* x, const void* valid, void* labels,
                          void* n_eff, int L, int A, int M, int n_bins,
                          long long xs_l, long long xs_a, long long xs_m,
                          long long vs_l, long long vs_a, long long vs_m,
                          int threads, int items, int device, void* stream) {
  return launch<double>(x, valid, labels, n_eff, L, A, M, n_bins, xs_l, xs_a,
                        xs_m, vs_l, vs_a, vs_m, threads, items, device, stream);
}

const char* csmom_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
