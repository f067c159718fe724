// Cohort x horizon partial sums for the J x K grid engine, every J in one
// launch.
//
// Replaces: csmom_tpu/ops/pallas_kernels.py::cohort_partial_sums_pallas
// (body _cohort_kernel), which runs once per J under vmap.  Here J is a
// grid axis: labels i32[nJ, A, M] share one ret f[A, M] and one
// valid bool[A, M].  For formation month s, horizon h = 1..H and side 0
// (label 0) / side 1 (label n_bins-1):
//   sums[j, side, s, h-1]   = sum_a member(a, s) * r(a, s+h)
//   counts[j, side, s, h-1] = sum_a member(a, s) * valid(a, s+h)
// with r = nan_to_num(ret) zeroed where invalid, and s+h >= M contributing
// nothing (the Pallas kernel's dead padded tile).
//
// What bounds it on the H100: bytes.  The least traffic is each label
// read once plus ret and valid read once (about 44 MB in f32 at the north
// star, nJ=4, A=3000, M=696); the adds are a few per member lane.
//
// Design:
//   - one thread per (j, formation month s, chunk of kHChunk horizons),
//     looping over a fixed chunk of assets; threads of a warp take
//     neighbouring months, so the label load and the r/valid loads at
//     s+h are coalesced lines;
//   - a lane whose label is neither 0 nor n_bins-1 is skipped after its
//     label load (only about 2/10 of lanes are members with deciles);
//   - the shifted reads r(a, s+h) of one block overlap its neighbours' by
//     H months, and ret/valid (10 MB) stay resident in the 50 MB L2, so
//     re-reads across horizons and J are served from L2, not HBM;
//   - the asset axis is cut into chunks across blocks to give the card
//     enough blocks, and a second pass adds the chunk partials in chunk
//     order: no float atomics, bit-for-bit repeatable sums;
//   - counts are summed as integers and converted once.
//   - H <= 128 (the Pallas kernel's limit at its default tile) is checked
//     by the caller; any H up to that works here.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // formation months per block
constexpr int kHChunk = 4;     // horizons held in registers by one thread

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

template <typename T>
__global__ void cohort_partial_kernel(const int32_t* __restrict__ labels,
                                      const T* __restrict__ ret,
                                      const bool* __restrict__ valid,
                                      T* __restrict__ part_sums,
                                      int32_t* __restrict__ part_counts,
                                      int nJ, int A, int M, int H, int n_bins,
                                      int chunk_a, int n_chunks) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= M) return;
  const int h0 = blockIdx.y * kHChunk;  // this thread's horizons: h0+1 ..
  const int j = blockIdx.z / n_chunks;
  const int chunk = blockIdx.z % n_chunks;
  const int a0 = chunk * chunk_a;
  const int a1 = min(A, a0 + chunk_a);
  const int32_t* lab = labels + static_cast<size_t>(j) * A * M;

  T s0[kHChunk], s1[kHChunk];
  int32_t c0[kHChunk], c1[kHChunk];
#pragma unroll
  for (int k = 0; k < kHChunk; ++k) {
    s0[k] = s1[k] = T(0);
    c0[k] = c1[k] = 0;
  }
  for (int a = a0; a < a1; ++a) {
    const size_t row = static_cast<size_t>(a) * M;
    const int l = lab[row + s];
    const bool m0 = (l == 0);
    const bool m1 = (l == n_bins - 1);
    if (!(m0 || m1)) continue;
#pragma unroll
    for (int k = 0; k < kHChunk; ++k) {
      const int h = h0 + k + 1;
      const int col = s + h;
      if (h <= H && col < M) {
        const bool v = valid[row + col];
        const T r = live_return(ret[row + col], v);
        if (m0) {
          s0[k] += r;
          c0[k] += v ? 1 : 0;
        }
        if (m1) {
          s1[k] += r;
          c1[k] += v ? 1 : 0;
        }
      }
    }
  }
  // partials layout [chunk][j][side][h][s]: coalesced along s
  const size_t side0 = ((static_cast<size_t>(chunk) * nJ + j) * 2) * H;
  const size_t side1 = side0 + H;
#pragma unroll
  for (int k = 0; k < kHChunk; ++k) {
    const int h = h0 + k;  // 0-based horizon slot
    if (h < H) {
      part_sums[(side0 + h) * M + s] = s0[k];
      part_counts[(side0 + h) * M + s] = c0[k];
      part_sums[(side1 + h) * M + s] = s1[k];
      part_counts[(side1 + h) * M + s] = c1[k];
    }
  }
}

// out[j, side, s, h] = sum over chunks, in chunk order, of the partials
template <typename T>
__global__ void cohort_reduce_kernel(const T* __restrict__ part_sums,
                                     const int32_t* __restrict__ part_counts,
                                     T* __restrict__ sums,
                                     T* __restrict__ counts, int nJ, int M,
                                     int H, int n_chunks) {
  const size_t n_out = static_cast<size_t>(nJ) * 2 * M * H;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  const int h = static_cast<int>(i % H);
  const size_t rest = i / H;
  const int s = static_cast<int>(rest % M);
  const size_t js = rest / M;  // j * 2 + side
  const size_t off = (js * H + h) * M + s;
  T acc = T(0);
  long long cnt = 0;
  for (int ch = 0; ch < n_chunks; ++ch) {
    acc += part_sums[static_cast<size_t>(ch) * n_out + off];
    cnt += part_counts[static_cast<size_t>(ch) * n_out + off];
  }
  sums[i] = acc;
  counts[i] = static_cast<T>(cnt);
}

template <typename T>
int launch(const void* labels, const void* ret, const void* valid,
           void* part_sums, void* part_counts, void* sums, void* counts,
           int nJ, int A, int M, int H, int n_bins, int chunk_a, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_chunks = (A + chunk_a - 1) / chunk_a;
  dim3 grid((M + kThreads - 1) / kThreads, (H + kHChunk - 1) / kHChunk,
            nJ * n_chunks);
  cohort_partial_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const int32_t*>(labels), static_cast<const T*>(ret),
      static_cast<const bool*>(valid), static_cast<T*>(part_sums),
      static_cast<int32_t*>(part_counts), nJ, A, M, H, n_bins, chunk_a,
      n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n_out = static_cast<size_t>(nJ) * 2 * M * H;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n_out + threads - 1) / threads);
  cohort_reduce_kernel<T><<<blocks, threads, 0, st>>>(
      static_cast<const T*>(part_sums),
      static_cast<const int32_t*>(part_counts), static_cast<T*>(sums),
      static_cast<T*>(counts), nJ, M, H, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int csmom_cohort_partial_sums_f32(const void* labels, const void* ret,
                                  const void* valid, void* part_sums,
                                  void* part_counts, void* sums, void* counts,
                                  int nJ, int A, int M, int H, int n_bins,
                                  int chunk_a, int device, void* stream) {
  return launch<float>(labels, ret, valid, part_sums, part_counts, sums,
                       counts, nJ, A, M, H, n_bins, chunk_a, device, stream);
}

int csmom_cohort_partial_sums_f64(const void* labels, const void* ret,
                                  const void* valid, void* part_sums,
                                  void* part_counts, void* sums, void* counts,
                                  int nJ, int A, int M, int H, int n_bins,
                                  int chunk_a, int device, void* stream) {
  return launch<double>(labels, ret, valid, part_sums, part_counts, sums,
                        counts, nJ, A, M, H, n_bins, chunk_a, device, stream);
}

const char* csmom_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
