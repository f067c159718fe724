// Cohort x horizon partial sums for the J x K grid engine, every J in one
// launch.
//
// Replaces: csmom_tpu/ops/pallas_kernels.py:64-133,
// cohort_partial_sums_pallas (body _cohort_kernel, :33), which runs once
// per J under vmap.  Here labels i32[nJ, A, M] share one ret f[A, M] and
// one valid bool[A, M].  For formation month s, horizon h = 1..H and
// side 0 (label 0) / side 1 (label n_bins-1):
//   sums[j, side, s, h-1]   = sum_a member(a, s) * r(a, s+h)
//   counts[j, side, s, h-1] = sum_a member(a, s) * valid(a, s+h)
// with r = nan_to_num(ret) (+-inf -> +-max) zeroed where invalid, and
// s+h >= M contributing nothing (the Pallas kernel's dead padded tile).
//
// What bounds it on the H100: bytes.  Each label read once plus ret and
// valid read once and both outputs written once: 44.38 MB in f32 at the
// north star (nJ=4, A=3000, M=696, H=12), 0.0132 ms at 3.35 TB/s.  The
// adds (about 33 M) are far below the f32 rate.
//
// What held the first version back (one thread per (j, s, 4 horizons)
// walking 375 assets, then a second pass over chunk partials):
//   - latency: one label load, then dependent loads at s+h, a few hundred
//     KB in flight on the whole card, where about 3 MB are needed;
//   - labels (75% of the bytes) read once per horizon chunk;
//   - 56 of 128 lanes of the last month block idle;
//   - the member skip skipped nothing (almost every warp has a member);
//   - 4.3 MB of partials written, read back by a second launch.
//
// This design:
//   - a block owns TS = 32 formation months x a group of Jg Js x a chunk
//     of up to 16 horizons x one slice of the asset axis.  Its threads are
//     G x Jg x TS, one per (asset group, j, s): neighbouring threads take
//     neighbouring months (conflict-free shared-memory reads), and the G
//     groups split each tile's assets, so no thread walks the whole slice
//     in one dependent chain;
//   - the block walks its slice in tiles of TA = 32 assets and stages
//     labels [Jg, TA, TS], ret [TA, W] and valid [TA, W] (W = TS + the
//     chunk's horizons, rounded up to 16) into shared memory with
//     cp.async, kStages tiles in flight: 16-byte copies where the address
//     allows, else 8-, 4- or 1-byte pieces (valid rows are M bytes, so at
//     M = 696 every other row starts 8-byte aligned only).  Labels are
//     read from device memory once; ret and valid once per J group plus a
//     halo that the neighbouring month tile also reads (served by L2);
//   - months >= M and assets outside the slice are staged as zeros:
//     valid 0 and r 0 add nothing, and no output is stored for s >= M.  A
//     thread whose s >= M (or j >= nJ) takes no members: its zero labels
//     would make every asset a member of side 0 and its warp the slowest;
//   - r = live_return(ret, valid) is applied once per staged element, and
//     the tile in use is kept as (r, valid) pairs: one shared-memory load
//     per horizon;
//   - each thread first reads its labels of the tile into two 32-bit
//     masks (side 0, side 1) and then adds only its members' rows, lowest
//     asset first: about 2 in 10 (j, a, s) are members, and labels
//     persist from month to month, so the lanes of a warp have similar
//     masks and idle little.  Both sides' counts share one uint32 (side
//     1 in the high 16 bits), so an asset slice holds at most 65535
//     assets and A is at most 8 * 65535 = 524280 (ops/kernels.py refuses
//     more on every device); the horizon count is a template argument
//     (4, 8, 12 or 16), so the horizon loop unrolls into independent
//     loads and adds;
//   - the asset slices of one (month tile, J group, horizon chunk) form a
//     thread block cluster of C <= 8 blocks.  Each block adds its groups'
//     sums in group order in its own shared memory; after cluster.sync()
//     each rank adds 1/C of the outputs from the C blocks' shared memory
//     in rank order 0..C-1 (distributed shared memory, all C loads issued
//     before the first add), converts counts once and stores; a second
//     cluster.sync() keeps every
//     block's shared memory alive until its peers are done.  One launch,
//     no partials in device memory, no float atomics: the same bits on
//     every run.  No thread returns early: every block, including one
//     whose slice is empty, reaches both syncs;
//   - the plan (tiles, J group, asset groups, horizon chunk, C, grid,
//     shared memory) is made from the shapes alone by
//     ops/kernels.py::_cohort_plan and checked here against the shapes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTS = 32;         // formation months per block
constexpr int kTA = 32;         // assets per staged tile: one bit each
constexpr int kHMax = 16;       // horizons per chunk, held in registers
constexpr int kThreadsMax = 256;
constexpr int kClusterMax = 8;  // the portable cluster size
constexpr int kStages = 2;      // staged tiles in flight
static_assert(kTA <= 32, "a thread's members of a tile are one uint32");
// staged months per ret/valid row: the tile's months plus up to kHMax
// horizons, a multiple of 16 so that every row starts 16-byte aligned
constexpr int kW = 48;
static_assert(kTS + kHMax <= kW && kW % 16 == 0, "staged row width");
// counts of both sides share one uint32 (side 1 in the high half), so one
// thread may see at most 65535 members of a side: an asset slice holds at
// most that many assets
constexpr int kCountMax = 65535;

template <typename T>
struct Limits;
template <>
struct Limits<float> {
  __device__ static float max() { return FLT_MAX; }
};
template <>
struct Limits<double> {
  __device__ static double max() { return DBL_MAX; }
};

// jnp.where(valid, jnp.nan_to_num(x), 0)
template <typename T>
__device__ __forceinline__ T live_return(T x, bool v) {
  if (!v || isnan(x)) return T(0);
  if (isinf(x)) return x > T(0) ? Limits<T>::max() : -Limits<T>::max();
  return x;
}

// a staged (month, asset) after live_return: one shared-memory load each
template <typename T>
struct __align__(2 * sizeof(T)) Live {
  T r;
  int32_t v;
};

// one stage: ret [kTA][kW] T, labels [jg][kTA][kTS] i32, valid [kTA][kW] u8
template <typename T>
__host__ __device__ inline size_t stage_bytes(int jg) {
  return kTA * kW * sizeof(T) + size_t(jg) * kTA * kTS * 4 + kTA * kW;
}

// the stages, then two tiles in use as Live<T> [kTA][kW]; afterwards the
// cluster reduction's buffers over the same bytes: sums T[n], counts i32[n]
// for the groups' n = groups * jg * 2 * kTS * hc outputs
template <typename T>
size_t smem_need(int jg, int hc, int groups) {
  const size_t tiles =
      kStages * stage_bytes<T>(jg) + 2 * size_t(kTA) * kW * sizeof(Live<T>);
  const size_t red = size_t(groups) * jg * 2 * kTS * hc * (sizeof(T) + 4);
  return tiles > red ? tiles : red;
}

template <int N>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int n) {
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(N), "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies 16 bytes to 16-byte-aligned shared memory at dst.  The first n
// (0 <= n <= 16) come from src, the rest are zeros: one 16-byte cp.async
// where src is 16-byte aligned, else 8- or 4-byte cp.async pieces, else
// plain byte loads.
template <int P>
__device__ __forceinline__ void copy_pieces(unsigned char* dst,
                                            const unsigned char* src, int n) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
#pragma unroll
  for (int o = 0; o < 16; o += P) {
    const int m = min(max(n - o, 0), P);
    if (m > 0) {
      cp_async<P>(d + o, src + o, m);
    } else if constexpr (P == 8) {
      *reinterpret_cast<uint2*>(dst + o) = make_uint2(0, 0);
    } else {
      *reinterpret_cast<uint32_t*>(dst + o) = 0;
    }
  }
}

__device__ __forceinline__ void copy16(unsigned char* dst,
                                       const unsigned char* src, int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  if (n <= 0) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  } else if ((a & 15) == 0) {
    cp_async<16>(static_cast<uint32_t>(__cvta_generic_to_shared(dst)), src, n);
  } else if ((a & 7) == 0) {
    copy_pieces<8>(dst, src, n);
  } else if ((a & 3) == 0) {
    copy_pieces<4>(dst, src, n);
  } else {
#pragma unroll
    for (int b = 0; b < 16; ++b) dst[b] = b < n ? src[b] : 0;
  }
}

struct Tile {
  int nJ, A, M;
  int j0, jg;   // the block's Js: j0 .. j0+jg-1
  int m0;       // first formation month of the block
  int cb;       // first staged month of ret/valid: m0 + h0
  int a_end;    // end of the block's asset slice
};

// Issue the copies of the kTA assets from a0 into one stage.
template <typename T>
__device__ void stage_tile(unsigned char* stage, const int32_t* labels,
                           const T* ret, const bool* valid, const Tile& tl,
                           int a0) {
  const int tid = threadIdx.x, nt = blockDim.x;
  unsigned char* sr = stage;
  unsigned char* sl = sr + kTA * kW * sizeof(T);
  unsigned char* sv = sl + tl.jg * kTA * kTS * 4;
  const unsigned char* gl = reinterpret_cast<const unsigned char*>(labels);
  const unsigned char* gr = reinterpret_cast<const unsigned char*>(ret);
  const unsigned char* gv = reinterpret_cast<const unsigned char*>(valid);

  // labels [jg][kTA][kTS], 4 per 16 bytes
  constexpr int kLV = kTS / 4;
  for (int i = tid; i < tl.jg * kTA * kLV; i += nt) {
    const int row = i / kLV, v = i % kLV;
    const int j = tl.j0 + row / kTA, a = a0 + row % kTA, col = tl.m0 + v * 4;
    int n = 0;
    const unsigned char* src = gl;
    if (j < tl.nJ && a < tl.a_end && col < tl.M) {
      n = min(4, tl.M - col) * 4;
      src = gl + ((static_cast<size_t>(j) * tl.A + a) * tl.M + col) * 4;
    }
    copy16(sl + (row * kTS + v * 4) * 4, src, n);
  }
  // ret [kTA][kW], 16 / sizeof(T) per 16 bytes
  constexpr int kRE = 16 / sizeof(T);
  constexpr int rv = kW / kRE;
  for (int i = tid; i < kTA * rv; i += nt) {
    const int r = i / rv, v = i % rv;
    const int a = a0 + r, col = tl.cb + v * kRE;
    int n = 0;
    const unsigned char* src = gr;
    if (a < tl.a_end && col < tl.M) {
      n = min(kRE, tl.M - col) * static_cast<int>(sizeof(T));
      src = gr + (static_cast<size_t>(a) * tl.M + col) * sizeof(T);
    }
    copy16(sr + (r * kW + v * kRE) * sizeof(T), src, n);
  }
  // valid [kTA][kW], 16 per 16 bytes
  constexpr int vv = kW / 16;
  for (int i = tid; i < kTA * vv; i += nt) {
    const int r = i / vv, v = i % vv;
    const int a = a0 + r, col = tl.cb + v * 16;
    int n = 0;
    const unsigned char* src = gv;
    if (a < tl.a_end && col < tl.M) {
      n = min(16, tl.M - col);
      src = gv + static_cast<size_t>(a) * tl.M + col;
    }
    copy16(sv + r * kW + v * 16, src, n);
  }
}

// Turn one landed stage into the tile in use: Live pairs for every staged
// (asset, month), and this thread's member masks (bit a: asset a of the
// tile has label 0, resp. n_bins-1, at the thread's (j, s); none for a
// thread whose s >= M or j >= nJ, whose labels are staged as zeros).
// After this the stage is no longer read.
template <typename T>
__device__ __forceinline__ void take_tile(const unsigned char* stage,
                                          Live<T>* live, int jg, int g,
                                          int groups, int jl, int t, int na,
                                          bool lane_live, int n_bins,
                                          uint32_t& mk0, uint32_t& mk1) {
  constexpr int kRE = 16 / sizeof(T);  // returns per 16 bytes
  const unsigned char* sr = stage;
  const int32_t* sl =
      reinterpret_cast<const int32_t*>(stage + kTA * kW * sizeof(T));
  const unsigned char* sv = stage + kTA * kW * sizeof(T) + jg * kTA * kTS * 4;
  for (int u = threadIdx.x; u < kTA * kW / kRE; u += blockDim.x) {
    union {
      uint4 raw;
      T x[kRE];
    } r;
    r.raw = *reinterpret_cast<const uint4*>(sr + u * 16);
#pragma unroll
    for (int e = 0; e < kRE; ++e) {
      const bool v = sv[u * kRE + e] != 0;
      live[u * kRE + e].r = live_return(r.x[e], v);
      live[u * kRE + e].v = v ? 1 : 0;
    }
  }
  const int32_t* lab = sl + jl * kTA * kTS + t;
  mk0 = mk1 = 0;
  for (int a = g; lane_live && a < na; a += groups) {
    const int l = lab[a * kTS];
    mk0 |= (l == 0 ? 1u : 0u) << a;
    mk1 |= (l == n_bins - 1 ? 1u : 0u) << a;
  }
}

template <typename T, int KH>
__global__ void __launch_bounds__(kThreadsMax)
    cohort_tile_kernel(const int32_t* __restrict__ labels,
                       const T* __restrict__ ret,
                       const bool* __restrict__ valid, T* __restrict__ sums,
                       T* __restrict__ counts, int nJ, int A, int M, int H,
                       int n_bins, int jg, int hc, int groups,
                       size_t stage_sz) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned C = cluster.num_blocks();
  const unsigned rank = cluster.block_rank();
  const int tid = threadIdx.x;
  const int n_hc = (H + hc - 1) / hc;

  Tile tl;
  tl.nJ = nJ;
  tl.A = A;
  tl.M = M;
  tl.jg = jg;
  tl.j0 = (blockIdx.z / n_hc) * jg;
  const int h0 = (blockIdx.z % n_hc) * hc;  // horizons h0+1 .. h0+hc
  tl.m0 = blockIdx.y * kTS;
  tl.cb = tl.m0 + h0;
  const int per = (A + static_cast<int>(C) - 1) / static_cast<int>(C);
  const int a_lo = min(A, static_cast<int>(rank) * per);
  tl.a_end = min(A, a_lo + per);
  const int n_tiles = (tl.a_end - a_lo + kTA - 1) / kTA;
  // kStages staged tiles, then two tiles in use (Live pairs), alternating
  Live<T>* live0 = reinterpret_cast<Live<T>*>(smem + kStages * stage_sz);
  Live<T>* live1 = live0 + kTA * kW;

  // thread (g, jl, t): month m0 + t of J j0 + jl, assets g, g + groups, ...
  // of every tile
  const int t = tid % kTS;
  const int jl = (tid / kTS) % jg;
  const int g = tid / (kTS * jg);
  const bool lane_live = tl.m0 + t < M && tl.j0 + jl < nJ;
  T s0[KH], s1[KH];
  uint32_t c01[KH];  // side 0 in the low 16 bits, side 1 in the high 16
#pragma unroll
  for (int k = 0; k < KH; ++k) {
    s0[k] = s1[k] = T(0);
    c01[k] = 0;
  }

  const auto rows = [&](int it) {  // assets of tile `it`
    return min(kTA, tl.a_end - (a_lo + it * kTA));
  };
  uint32_t mk0 = 0, mk1 = 0;  // this thread's members of the tile in use
#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    if (st < n_tiles)
      stage_tile<T>(smem + st * stage_sz, labels, ret, valid, tl,
                    a_lo + st * kTA);
    cp_async_commit();
  }
  if (n_tiles > 0) {  // the same for every thread of the block
    cp_async_wait<kStages - 1>();
    __syncthreads();
    take_tile<T>(smem, live0, jg, g, groups, jl, t, rows(0), lane_live,
                 n_bins, mk0, mk1);
  }
  // One barrier per tile.  Between two barriers a thread issues the copies
  // of tile it + kStages into the stage that tile `it` left, takes tile
  // it + 1 from its stage into the other Live buffer, and sums tile `it`.
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile it+1 landed, tile `it` taken, tile it-1 summed
    const int nx = it + kStages;
    if (nx < n_tiles)
      stage_tile<T>(smem + (it % kStages) * stage_sz, labels, ret, valid, tl,
                    a_lo + nx * kTA);
    cp_async_commit();
    const Live<T>* live = (it & 1) ? live1 : live0;
    const uint32_t cur0 = mk0, cur1 = mk1;
    if (it + 1 < n_tiles)
      take_tile<T>(smem + ((it + 1) % kStages) * stage_sz,
                   (it & 1) ? live0 : live1, jg, g, groups, jl, t,
                   rows(it + 1), lane_live, n_bins, mk0, mk1);
    // month s + h sits at column t + (h - h0) of the staged row
    for (uint32_t m = cur0; m; m &= m - 1) {
      const Live<T>* x = live + (__ffs(m) - 1) * kW + t + 1;
#pragma unroll
      for (int k = 0; k < KH; ++k) {
        const Live<T> e = x[k];
        s0[k] += e.r;
        c01[k] += static_cast<uint32_t>(e.v);
      }
    }
    for (uint32_t m = cur1; m; m &= m - 1) {
      const Live<T>* x = live + (__ffs(m) - 1) * kW + t + 1;
#pragma unroll
      for (int k = 0; k < KH; ++k) {
        const Live<T> e = x[k];
        s1[k] += e.r;
        c01[k] += static_cast<uint32_t>(e.v) << 16;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the tiles are free: reuse them for the reduction

  // this block's sums and counts, [g][o] with
  // o = ((jl * 2 + side) * kTS + t) * hc + k
  const int n_out = jg * 2 * kTS * hc;
  T* red_s = reinterpret_cast<T*>(smem);
  int32_t* red_c =
      reinterpret_cast<int32_t*>(smem + size_t(groups) * n_out * sizeof(T));
  const int o0 = g * n_out + ((jl * 2) * kTS + t) * hc;
  const int o1 = o0 + kTS * hc;
#pragma unroll
  for (int k = 0; k < KH; ++k) {
    if (k < hc) {
      red_s[o0 + k] = s0[k];
      red_c[o0 + k] = static_cast<int32_t>(c01[k] & 0xffffu);
      red_s[o1 + k] = s1[k];
      red_c[o1 + k] = static_cast<int32_t>(c01[k] >> 16);
    }
  }
  __syncthreads();
  // the groups' partials, added in group order into group 0's slots
  for (int o = tid; o < n_out; o += blockDim.x) {
    T acc = red_s[o];
    int32_t cnt = red_c[o];
    for (int gg = 1; gg < groups; ++gg) {
      acc += red_s[gg * n_out + o];
      cnt += red_c[gg * n_out + o];
    }
    red_s[o] = acc;
    red_c[o] = cnt;
  }
  cluster.sync();

  // rank r adds outputs [r * share, (r + 1) * share) over the C blocks in
  // rank order; all C loads are issued before the first add
  const int share = (n_out + static_cast<int>(C) - 1) / static_cast<int>(C);
  const int lo = static_cast<int>(rank) * share;
  const int hi = min(n_out, lo + share);
  for (int o = lo + tid; o < hi; o += blockDim.x) {
    T ps[kClusterMax];
    int32_t pc[kClusterMax];
#pragma unroll
    for (int q = 0; q < kClusterMax; ++q) {
      if (q < static_cast<int>(C)) {
        ps[q] = cluster.map_shared_rank(red_s, q)[o];
        pc[q] = cluster.map_shared_rank(red_c, q)[o];
      }
    }
    T acc = T(0);
    int32_t cnt = 0;
#pragma unroll
    for (int q = 0; q < kClusterMax; ++q) {
      if (q < static_cast<int>(C)) {
        acc += ps[q];
        cnt += pc[q];
      }
    }
    const int k = o % hc;
    const int rest = o / hc;
    const int s = tl.m0 + rest % kTS;
    const int side = (rest / kTS) % 2;
    const int j = tl.j0 + rest / (2 * kTS);
    const int h = h0 + k;
    if (j < nJ && s < M && h < H) {
      const size_t out = ((static_cast<size_t>(j) * 2 + side) * M + s) * H + h;
      sums[out] = acc;
      counts[out] = static_cast<T>(cnt);
    }
  }
  cluster.sync();  // peers may still read this block's shared memory
}

template <typename T, int KH>
int launch_kh(const void* labels, const void* ret, const void* valid,
              void* sums, void* counts, int nJ, int A, int M, int H,
              int n_bins, int jg, int hc, int groups, int c, int gx, int gy,
              int gz, int smem, int device, cudaStream_t stream) {
  // raise the kernel's shared-memory limit once per device and size
  constexpr int kDevices = 64;
  static int raised[kDevices] = {};
  cudaError_t err;
  if (device >= kDevices || raised[device] < smem) {
    err = cudaFuncSetAttribute(cohort_tile_kernel<T, KH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < kDevices) raised[device] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(gx, gy, gz);
  cfg.blockDim = dim3(groups * jg * kTS);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, cohort_tile_kernel<T, KH>,
                           static_cast<const int32_t*>(labels),
                           static_cast<const T*>(ret),
                           static_cast<const bool*>(valid),
                           static_cast<T*>(sums), static_cast<T*>(counts), nJ,
                           A, M, H, n_bins, jg, hc, groups,
                           stage_bytes<T>(jg));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* labels, const void* ret, const void* valid, void* sums,
           void* counts, int nJ, int A, int M, int H, int n_bins, int ts,
           int ta, int jg, int hc, int groups, int c, int gx, int gy, int gz,
           int smem, int device, void* stream) {
  // the plan must be the one this kernel was written for
  if (ts != kTS || ta != kTA || jg < 1 || groups < 1 || device < 0 ||
      groups * jg * kTS > kThreadsMax || hc < 1 || hc > kHMax || c < 1 ||
      c > kClusterMax || gx != c || nJ < 1 || A < 1 || M < 1 || H < 1 ||
      (A + c - 1) / c > kCountMax || gy != (M + kTS - 1) / kTS ||
      gz != ((nJ + jg - 1) / jg) * ((H + hc - 1) / hc) || smem < 0 ||
      static_cast<size_t>(smem) < smem_need<T>(jg, hc, groups))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // registers for the chunk's horizons, rounded up to 4
  switch ((hc + 3) / 4) {
    case 1:
      return launch_kh<T, 4>(labels, ret, valid, sums, counts, nJ, A, M, H,
                              n_bins, jg, hc, groups, c, gx, gy, gz, smem,
                              device, st);
    case 2:
      return launch_kh<T, 8>(labels, ret, valid, sums, counts, nJ, A, M, H,
                              n_bins, jg, hc, groups, c, gx, gy, gz, smem,
                              device, st);
    case 3:
      return launch_kh<T, 12>(labels, ret, valid, sums, counts, nJ, A, M, H,
                              n_bins, jg, hc, groups, c, gx, gy, gz, smem,
                              device, st);
    default:
      return launch_kh<T, 16>(labels, ret, valid, sums, counts, nJ, A, M, H,
                              n_bins, jg, hc, groups, c, gx, gy, gz, smem,
                              device, st);
  }
}

}  // namespace

extern "C" {

int csmom_cohort_partial_sums_f32(const void* labels, const void* ret,
                                  const void* valid, void* sums, void* counts,
                                  int nJ, int A, int M, int H, int n_bins,
                                  int ts, int ta, int jg, int hc, int groups,
                                  int c, int gx, int gy, int gz, int smem,
                                  int device, void* stream) {
  return launch<float>(labels, ret, valid, sums, counts, nJ, A, M, H, n_bins,
                       ts, ta, jg, hc, groups, c, gx, gy, gz, smem, device,
                       stream);
}

int csmom_cohort_partial_sums_f64(const void* labels, const void* ret,
                                  const void* valid, void* sums, void* counts,
                                  int nJ, int A, int M, int H, int n_bins,
                                  int ts, int ta, int jg, int hc, int groups,
                                  int c, int gx, int gy, int gz, int smem,
                                  int device, void* stream) {
  return launch<double>(labels, ret, valid, sums, counts, nJ, A, M, H, n_bins,
                        ts, ta, jg, hc, groups, c, gx, gy, gz, smem, device,
                        stream);
}

const char* csmom_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
