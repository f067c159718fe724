// Per-(bin, month) return sums and member counts over the asset axis: the
// monthly engine's portfolio aggregation.
//
// Replaces: csmom_tpu/ops/pallas_kernels.py::decile_partial_sums_pallas
// (body _kernel).  Same contract: labels i32[A, M] with -1 for "no bin"
// (the caller folds invalid lanes in), ret f[A, M] zeroed at non-members;
// out sums f[B, M] and counts f[B, M] in ret's dtype.
//
// What bounds it on the H100: bytes.  Each label and return is read once
// (8 bytes per panel slot in f32) and each lane does at most two adds, so
// the kernel sits far below the card's compute rate; at A=3000, M=696 the
// 16.7 MB of input is a few microseconds of HBM time.
//
// Design:
//   - threads walk the contiguous month axis, so every load of a warp is
//     one coalesced 128-byte line per array;
//   - each thread loops over a fixed chunk of assets and keeps one group
//     of kBinGroup bins in registers (the bin test is unrolled, so the
//     accumulators never spill to local memory); more bins take more
//     groups on the grid's z axis, so any n_bins >= 1 works;
//   - M alone gives too few blocks for 132 SMs (696 months = 6 blocks),
//     so the asset axis is cut into chunks across gridDim.y and a second
//     pass adds the per-chunk partials in chunk order;
//   - no float atomics: the summation order is fixed by the launch shape
//     alone, so results repeat bit for bit from run to run;
//   - counts are summed as integers and converted once at the end.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // months per block
constexpr int kBinGroup = 16;  // bins held in registers by one thread

template <typename T>
__global__ void decile_partial_kernel(const int32_t* __restrict__ labels,
                                      const T* __restrict__ ret,
                                      T* __restrict__ part_sums,
                                      int32_t* __restrict__ part_counts,
                                      int A, int M, int n_bins, int chunk_a) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= M) return;
  const int chunk = blockIdx.y;
  const int g0 = blockIdx.z * kBinGroup;
  const int a0 = chunk * chunk_a;
  const int a1 = min(A, a0 + chunk_a);

  T s[kBinGroup];
  int32_t c[kBinGroup];
#pragma unroll
  for (int k = 0; k < kBinGroup; ++k) {
    s[k] = T(0);
    c[k] = 0;
  }
  for (int a = a0; a < a1; ++a) {
    const size_t off = static_cast<size_t>(a) * M + t;
    const int b = labels[off] - g0;
    const T r = ret[off];
#pragma unroll
    for (int k = 0; k < kBinGroup; ++k) {
      const bool m = (b == k);
      s[k] += m ? r : T(0);
      c[k] += m ? 1 : 0;
    }
  }
  // partials layout [chunk][bin][month]
  const int nb = min(kBinGroup, n_bins - g0);
  const size_t base = (static_cast<size_t>(chunk) * n_bins + g0) * M + t;
#pragma unroll
  for (int k = 0; k < kBinGroup; ++k) {
    if (k < nb) {
      part_sums[base + static_cast<size_t>(k) * M] = s[k];
      part_counts[base + static_cast<size_t>(k) * M] = c[k];
    }
  }
}

template <typename T>
__global__ void decile_reduce_kernel(const T* __restrict__ part_sums,
                                     const int32_t* __restrict__ part_counts,
                                     T* __restrict__ sums,
                                     T* __restrict__ counts,
                                     int n_chunks, int n_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  T acc = T(0);
  long long cnt = 0;
  for (int ch = 0; ch < n_chunks; ++ch) {  // fixed order: deterministic
    const size_t off = static_cast<size_t>(ch) * n_out + i;
    acc += part_sums[off];
    cnt += part_counts[off];
  }
  sums[i] = acc;
  counts[i] = static_cast<T>(cnt);
}

template <typename T>
int launch(const void* labels, const void* ret, void* part_sums,
           void* part_counts, void* sums, void* counts, int A, int M,
           int n_bins, int chunk_a, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_chunks = (A + chunk_a - 1) / chunk_a;
  const int n_groups = (n_bins + kBinGroup - 1) / kBinGroup;
  dim3 grid((M + kThreads - 1) / kThreads, n_chunks, n_groups);
  decile_partial_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const int32_t*>(labels), static_cast<const T*>(ret),
      static_cast<T*>(part_sums), static_cast<int32_t*>(part_counts), A, M,
      n_bins, chunk_a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_out = n_bins * M;
  const int threads = 256;
  decile_reduce_kernel<T><<<(n_out + threads - 1) / threads, threads, 0, st>>>(
      static_cast<const T*>(part_sums),
      static_cast<const int32_t*>(part_counts), static_cast<T*>(sums),
      static_cast<T*>(counts), n_chunks, n_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int csmom_decile_partial_sums_f32(const void* labels, const void* ret,
                                  void* part_sums, void* part_counts,
                                  void* sums, void* counts, int A, int M,
                                  int n_bins, int chunk_a, int device,
                                  void* stream) {
  return launch<float>(labels, ret, part_sums, part_counts, sums, counts, A,
                       M, n_bins, chunk_a, device, stream);
}

int csmom_decile_partial_sums_f64(const void* labels, const void* ret,
                                  void* part_sums, void* part_counts,
                                  void* sums, void* counts, int A, int M,
                                  int n_bins, int chunk_a, int device,
                                  void* stream) {
  return launch<double>(labels, ret, part_sums, part_counts, sums, counts, A,
                        M, n_bins, chunk_a, device, stream);
}

const char* csmom_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
