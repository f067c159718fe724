// Per-(bin, month) return sums and member counts over the asset axis: the
// monthly engine's portfolio aggregation, in one launch.
//
// Replaces: csmom_tpu/ops/pallas_kernels.py:153-202,
// decile_partial_sums_pallas (body _kernel, :136).  Same contract: labels
// i32[A, M] where -1, or any label outside [0, n_bins), joins no bin; ret
// f[A, M] zeroed at non-members; out sums f[B, M] and counts f[B, M] in
// ret's dtype; any n_bins >= 1.
//
// What bounds it on the H100: bytes.  Each label and return is read once
// and each output written once: 16.76 MB in f32 at the north star
// (A = 3000, M = 696, B = 10), 0.0050 ms at 3.35 TB/s.  The adds (3.4 M)
// are far below the f32 rate.
//
// What held the first version back, and what this design does about it:
//   1. two kernels, with [86, 10, 696] chunk partials (4.79 MB, 29% of
//      the input) written by the first and read back by the second.  Here
//      one launch: the asset slices of a month tile form a thread block
//      cluster of C = 8 blocks, the asset groups of a block are added in
//      shared memory and the C ranks add each other's partials through
//      distributed shared memory.  No partials reach device memory and
//      there are no float atomics: the order of every add is fixed by the
//      shapes, so the sums repeat bit for bit;
//   2. few bytes in flight (one 4-byte load per array per step of a
//      35-asset loop, about 4 KB per SM).  Here each thread takes V
//      consecutive months of a row with one 16-byte load of returns
//      (float4 in f32, V = 4; double2 in f64, V = 2) and one 4V-byte load
//      of labels (int4, int2), kUnroll = 8 assets a round, and issues the
//      next round's loads before it adds this round's: 256 B per thread
//      per round in f32, up to two rounds in flight.  At the north star
//      (f32 plan: 8 lanes x 16 asset groups = 128 threads a block, a warp
//      reading 128 B of each of 4 rows per array, 32-month tiles, 22
//      tiles x 8 ranks = 176 blocks, 704 warps, 5.3 a SM) that is 8-16 KB
//      per warp, 43-85 KB per SM, over the 16-20 KB that 3.35 TB/s needs
//      at 0.6-0.8 us of DRAM latency; each thread walks about 23 assets.
//      202 registers a thread in f32: two blocks an SM, all 176 resident.
//      More, smaller blocks were slower: 64-byte row pieces (4 lanes, 352
//      blocks) by 2-13%, 32-byte ones (2 lanes) by 85% (python -m
//      csmom_tpu_torch.k1_sweep).  Where M leaves rows not 16-byte
//      aligned (M % V != 0) or a pointer is not aligned, every load is a
//      scalar one, V of them per asset;
//   3. sixteen bin tests per element at B = 10 (and a first redesign with
//      the bins in registers spent about 45 instructions per element on
//      its B tests).  Here no bin is tested: each thread owns one slot per
//      (bin, month) in shared memory, [bin][month][thread], and adds an
//      element into the slot its label names (one load, two adds, one
//      store, conflict-free since a thread owns its column).  The V slots
//      one asset touches are distinct, so their loads issue together.
//      A block holds nb = min(B, 16) bins; more go in groups on gridDim.y.
//      Labels outside [bin0, bin0 + nb) and >= B take no slot.  Counts
//      are int32 until stored;
//   4. four device allocations a call, and the chunk plan recomputed on
//      every call.  The wrapper allocates sums and counts only, and the
//      plan comes from ops/kernels.py::_decile_plan (cached by shape),
//      re-checked here: a mismatch returns cudaErrorInvalidValue.
//
// Layout: block x = month tile * C + rank (the cluster spans x), y = bin
// group.  Thread (g, l) of a block: lane l takes months m0 .. m0+V-1 of the
// tile, group g the assets a_lo + g, a_lo + g + groups, ... of the rank's
// slice [a_lo, a_hi) of ceil(A / C) assets.  A lane whose m0 >= M, and an
// asset past the slice, take nothing.  Reduction, in a fixed order: each
// thread adds its assets in asset order into its slots; each output of
// the block adds the slots of the groups in group order; the C ranks add
// in rank order 0..C-1, each rank finishing 1/C of the tile's outputs.
// Every block, including one whose slice is empty, reaches both
// cluster.sync()s.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kUnroll = 8;       // assets whose loads are issued together
constexpr int kThreadsMax = 256;
constexpr int kLanesMax = 32;
constexpr int kClusterMax = 8;   // the portable cluster size
constexpr int kGroupBins = 16;   // bins per block, at most
constexpr int kGridYMax = 65535;

// months per thread: one 16-byte load of returns
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int V = 4;
  using R = float4;
  using L = int4;
};
template <>
struct Vec<double> {
  static constexpr int V = 2;
  using R = double2;
  using L = int2;
};

__device__ __forceinline__ void unpack(int4 x, int32_t (&o)[4]) {
  o[0] = x.x, o[1] = x.y, o[2] = x.z, o[3] = x.w;
}
__device__ __forceinline__ void unpack(int2 x, int32_t (&o)[2]) {
  o[0] = x.x, o[1] = x.y;
}
__device__ __forceinline__ void unpack(float4 x, float (&o)[4]) {
  o[0] = x.x, o[1] = x.y, o[2] = x.z, o[3] = x.w;
}
__device__ __forceinline__ void unpack(double2 x, double (&o)[2]) {
  o[0] = x.x, o[1] = x.y;
}

// one (bin, month) slot of one thread
template <typename T>
struct __align__(2 * sizeof(T)) Slot {
  T s;
  int32_t c;
};

// shared memory: the slots [nb][V][threads], then the block's sums
// T[nb][tm] and counts i32[nb][tm] for the cluster's reduction
template <typename T>
size_t smem_need(int nb, int lanes, int groups) {
  const size_t threads = static_cast<size_t>(lanes) * groups;
  const size_t tm = static_cast<size_t>(lanes) * Vec<T>::V;
  return nb * Vec<T>::V * threads * sizeof(Slot<T>) +
         nb * tm * (sizeof(T) + 4);
}

// Loads assets i .. i+kUnroll-1 of this thread (those < n) from row
// pointers lp / rp a step of `step` elements apart; the others get label
// -1.  VEC: the lane's V months with one load each; else V scalar loads,
// month v only where v < nv.
template <typename T, bool VEC>
__device__ __forceinline__ void load_round(const int32_t* lp, const T* rp,
                                           size_t step, int i, int n, int nv,
                                           int32_t (&lab)[kUnroll][Vec<T>::V],
                                           T (&r)[kUnroll][Vec<T>::V]) {
  constexpr int V = Vec<T>::V;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      lab[u][v] = -1;
      r[u][v] = T(0);
    }
    if (i + u < n) {
      const size_t off = static_cast<size_t>(i + u) * step;
      if constexpr (VEC) {
        unpack(__ldg(reinterpret_cast<const typename Vec<T>::L*>(lp + off)),
               lab[u]);
        unpack(__ldg(reinterpret_cast<const typename Vec<T>::R*>(rp + off)),
               r[u]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          if (v < nv) {
            lab[u][v] = __ldg(lp + off + v);
            r[u][v] = __ldg(rp + off + v);
          }
        }
      }
    }
  }
}

// Adds one round of loaded assets, in asset order, into this thread's
// slots (`slots` is its slot of bin 0, month 0; `nt` threads apart): month
// v of bin bin0 + k at slots[(k * V + v) * nt], for 0 <= k < nbg.
template <typename T>
__device__ __forceinline__ void add_round(
    const int32_t (&lab)[kUnroll][Vec<T>::V], const T (&r)[kUnroll][Vec<T>::V],
    int bin0, int nbg, Slot<T>* slots, int nt) {
  constexpr int V = Vec<T>::V;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    bool hit[V];
    Slot<T>* p[V];
    Slot<T> x[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const unsigned k = static_cast<unsigned>(lab[u][v] - bin0);
      hit[v] = k < static_cast<unsigned>(nbg);
      p[v] = slots + (hit[v] ? (k * V + v) * nt : 0);
    }
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (hit[v]) x[v] = *p[v];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (hit[v]) {
        x[v].s += r[u][v];
        x[v].c += 1;
        *p[v] = x[v];
      }
    }
  }
}

// Adds this thread's n assets into its slots, in asset order.  Two rounds
// of registers: the loads of the next kUnroll assets are issued before the
// adds of this round, so a thread has loads in flight while it adds.
template <typename T, bool VEC>
__device__ __forceinline__ void walk(const int32_t* lp, const T* rp,
                                     size_t step, int n, int nv, int bin0,
                                     int nbg, Slot<T>* slots, int nt) {
  constexpr int V = Vec<T>::V;
  int32_t lab[2][kUnroll][V];
  T r[2][kUnroll][V];
  load_round<T, VEC>(lp, rp, step, 0, n, nv, lab[0], r[0]);
  for (int i = 0; i < n; i += 2 * kUnroll) {
    load_round<T, VEC>(lp, rp, step, i + kUnroll, n, nv, lab[1], r[1]);
    add_round<T>(lab[0], r[0], bin0, nbg, slots, nt);
    if (i + kUnroll >= n) break;
    load_round<T, VEC>(lp, rp, step, i + 2 * kUnroll, n, nv, lab[0], r[0]);
    add_round<T>(lab[1], r[1], bin0, nbg, slots, nt);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreadsMax)
    decile_tile_kernel(const int32_t* __restrict__ labels,
                       const T* __restrict__ ret, T* __restrict__ sums,
                       T* __restrict__ counts, int A, int M, int n_bins,
                       int nb, int lanes, int vec) {
  constexpr int V = Vec<T>::V;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, nt = blockDim.x;
  const int groups = nt / lanes;
  const int tm = lanes * V;  // months per tile
  const int mt0 = (blockIdx.x / C) * tm;
  const int bin0 = blockIdx.y * nb;
  const int nbg = min(nb, n_bins - bin0);  // this block's bins
  const int l = tid % lanes, g = tid / lanes;
  const int m0 = mt0 + l * V;
  const int per = (A + C - 1) / C;
  const int a_lo = min(A, rank * per);
  const int a_hi = min(A, a_lo + per);

  // this thread's slots, zeroed (it alone touches them until the sync)
  Slot<T>* slots = reinterpret_cast<Slot<T>*>(smem);
  for (int j = 0; j < nbg * V; ++j) slots[j * nt + tid] = Slot<T>{T(0), 0};
  // this thread's assets a_lo + g + i * groups, i < n; none past the panel
  const int a0 = a_lo + g;
  const int n = (a0 < a_hi && m0 < M) ? (a_hi - a0 + groups - 1) / groups : 0;
  const int nv = min(V, M - m0);
  const size_t row0 = static_cast<size_t>(n > 0 ? a0 : 0) * M + (n > 0 ? m0 : 0);
  const size_t step = static_cast<size_t>(groups) * M;
  if (vec)
    walk<T, true>(labels + row0, ret + row0, step, n, V, bin0, nbg,
                  slots + tid, nt);
  else
    walk<T, false>(labels + row0, ret + row0, step, n, nv, bin0, nbg,
                   slots + tid, nt);
  __syncthreads();

  // the block's outputs o = k * tm + l * V + v, each adding the groups'
  // slots in group order
  const int n_out = nbg * tm;
  T* red_s = reinterpret_cast<T*>(smem + size_t(nb) * V * nt * sizeof(Slot<T>));
  int32_t* red_c = reinterpret_cast<int32_t*>(red_s + size_t(nb) * tm);
  for (int o = tid; o < n_out; o += nt) {
    const int k = o / tm, lv = o % tm;
    const Slot<T>* p = slots + (k * V + lv % V) * nt + lv / V;
    T acc = T(0);
    int32_t cnt = 0;
#pragma unroll 4
    for (int gg = 0; gg < groups; ++gg) {
      const Slot<T> x = p[gg * lanes];
      acc += x.s;
      cnt += x.c;
    }
    red_s[o] = acc;
    red_c[o] = cnt;
  }
  cluster.sync();

  // rank r finishes outputs [r * share, (r + 1) * share) of the tile,
  // adding the C ranks in rank order; all C loads issued before the first
  // add
  const int share = (n_out + C - 1) / C;
  const int lo = rank * share;
  const int hi = min(n_out, lo + share);
  for (int o = lo + tid; o < hi; o += blockDim.x) {
    T ps[kClusterMax];
    int32_t pc[kClusterMax];
#pragma unroll
    for (int q = 0; q < kClusterMax; ++q) {
      if (q < C) {
        ps[q] = cluster.map_shared_rank(red_s, q)[o];
        pc[q] = cluster.map_shared_rank(red_c, q)[o];
      }
    }
    T acc = T(0);
    int32_t cnt = 0;
#pragma unroll
    for (int q = 0; q < kClusterMax; ++q) {
      if (q < C) {
        acc += ps[q];
        cnt += pc[q];
      }
    }
    const int m = mt0 + o % tm;
    if (m < M) {
      const size_t out = static_cast<size_t>(bin0 + o / tm) * M + m;
      sums[out] = acc;
      counts[out] = static_cast<T>(cnt);
    }
  }
  cluster.sync();  // peers may still read this block's shared memory
}

template <typename T>
int launch_kernel(const void* labels, const void* ret, void* sums,
                  void* counts, int A, int M, int n_bins, int nb, int lanes,
                  int groups, int c, int gx, int gy, int smem, int vec,
                  int device, cudaStream_t stream) {
  // raise the kernel's shared-memory limit once per device and size
  constexpr int kDevices = 64;
  static int raised[kDevices] = {};
  cudaError_t err;
  if (smem > 48 * 1024 && (device >= kDevices || raised[device] < smem)) {
    err = cudaFuncSetAttribute(decile_tile_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < kDevices) raised[device] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(gx, gy, 1);
  cfg.blockDim = dim3(lanes * groups);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, decile_tile_kernel<T>,
                           static_cast<const int32_t*>(labels),
                           static_cast<const T*>(ret), static_cast<T*>(sums),
                           static_cast<T*>(counts), A, M, n_bins, nb, lanes,
                           vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, int n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

template <typename T>
int launch(const void* labels, const void* ret, void* sums, void* counts,
           int A, int M, int n_bins, int v, int lanes, int groups, int nb,
           int c, int gx, int gy, int smem, int device, void* stream) {
  constexpr int V = Vec<T>::V;
  const int threads = lanes * groups;
  // the plan must be the one this kernel was written for
  if (v != V || lanes < 1 || lanes > kLanesMax || 32 % lanes != 0 ||
      groups < 1 || threads % 32 != 0 || threads > kThreadsMax || c < 1 ||
      c > kClusterMax || A < 1 || M < 1 || n_bins < 1 || device < 0 ||
      nb != (n_bins < kGroupBins ? n_bins : kGroupBins) ||
      gx != c * ((M + lanes * V - 1) / (lanes * V)) ||
      gy != (n_bins + nb - 1) / nb || gy > kGridYMax || smem < 0 ||
      static_cast<size_t>(smem) < smem_need<T>(nb, lanes, groups))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 16-byte loads where every row and both arrays allow them
  const int vec = M % V == 0 && aligned(labels, 4 * V) && aligned(ret, 16);
  return launch_kernel<T>(labels, ret, sums, counts, A, M, n_bins, nb, lanes,
                          groups, c, gx, gy, smem, vec, device, st);
}

}  // namespace

extern "C" {

int csmom_decile_partial_sums_f32(const void* labels, const void* ret,
                                  void* sums, void* counts, int A, int M,
                                  int n_bins, int v, int lanes, int groups,
                                  int nb, int c, int gx, int gy, int smem,
                                  int device, void* stream) {
  return launch<float>(labels, ret, sums, counts, A, M, n_bins, v, lanes,
                       groups, nb, c, gx, gy, smem, device, stream);
}

int csmom_decile_partial_sums_f64(const void* labels, const void* ret,
                                  void* sums, void* counts, int A, int M,
                                  int n_bins, int v, int lanes, int groups,
                                  int nb, int c, int gx, int gy, int smem,
                                  int device, void* stream) {
  return launch<double>(labels, ret, sums, counts, A, M, n_bins, v, lanes,
                        groups, nb, c, gx, gy, smem, device, stream);
}

const char* csmom_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
