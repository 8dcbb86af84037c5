// Hash-partition kernel: the shuffle build side (paper §4.2).
//
// Replaces the Pallas kernel src/repro/kernels/hash_partition.py
// (hash_partition, bodies _kernel_dest_only and _kernel). Per row it runs
// lowbias32 on every key column, folds the columns with the boost combine
// h ^ (x + 0x9E3779B9 + (h << 6) + (h >> 2)) and writes dest = h % P.
//
// Bound: bytes. Each row reads 4 * n_cols bytes and writes a 4-byte dest;
// the arithmetic is a few integer ops per byte. Design: one thread per row in
// a grid-stride loop, rows read as int32 bit patterns from a row-major
// (n_rows, n_cols) array, so a warp reads one contiguous span. The ragged
// edge is masked here, so the wrapper pads nothing.
//
// The optional histogram counts destinations in shared-memory int counters
// per block, then adds each block's counts into a global (P,) int32 with
// atomicAdd. Integer atomics make the totals deterministic. The TPU kernel
// instead wrote a one-hot (block x P) sum per block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kM1 = 0x7FEB352Du;
constexpr uint32_t kM2 = 0x846CA68Bu;
constexpr uint32_t kGolden = 0x9E3779B9u;

__device__ __forceinline__ uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= kM1;
  x ^= x >> 15;
  x *= kM2;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ int32_t row_dest(const int32_t* __restrict__ keys,
                                            int64_t row, int n_cols,
                                            uint32_t num_partitions) {
  uint32_t h = 0u;
  const int32_t* k = keys + row * n_cols;
  for (int c = 0; c < n_cols; ++c) {
    uint32_t x = lowbias32(static_cast<uint32_t>(k[c]));
    h ^= x + kGolden + (h << 6) + (h >> 2);
  }
  return static_cast<int32_t>(h % num_partitions);
}

__global__ void hash_dest_kernel(const int32_t* __restrict__ keys, int64_t n_rows,
                                 int n_cols, uint32_t num_partitions,
                                 int32_t* __restrict__ dest) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_rows; i += stride) {
    dest[i] = row_dest(keys, i, n_cols, num_partitions);
  }
}

__global__ void hash_dest_hist_kernel(const int32_t* __restrict__ keys,
                                      int64_t n_rows, int n_cols,
                                      uint32_t num_partitions,
                                      int32_t* __restrict__ dest,
                                      int32_t* __restrict__ hist) {
  extern __shared__ int32_t counts[];
  for (uint32_t p = threadIdx.x; p < num_partitions; p += blockDim.x) counts[p] = 0;
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_rows; i += stride) {
    int32_t d = row_dest(keys, i, n_cols, num_partitions);
    dest[i] = d;
    atomicAdd(&counts[d], 1);
  }
  __syncthreads();
  for (uint32_t p = threadIdx.x; p < num_partitions; p += blockDim.x) {
    if (counts[p] != 0) atomicAdd(&hist[p], counts[p]);
  }
}

}  // namespace

extern "C" int hash_partition_launch(const void* keys, int64_t n_rows, int n_cols,
                                     int num_partitions, void* dest, void* hist,
                                     void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  const int threads = 256;
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int64_t want = (n_rows + threads - 1) / threads;
  int64_t cap = static_cast<int64_t>(sms) * 8;
  int blocks = static_cast<int>(want < cap ? want : cap);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* k = static_cast<const int32_t*>(keys);
  int32_t* d = static_cast<int32_t*>(dest);
  if (hist == nullptr) {
    hash_dest_kernel<<<blocks, threads, 0, s>>>(k, n_rows, n_cols,
                                                static_cast<uint32_t>(num_partitions), d);
  } else {
    size_t smem = static_cast<size_t>(num_partitions) * sizeof(int32_t);
    hash_dest_hist_kernel<<<blocks, threads, smem, s>>>(
        k, n_rows, n_cols, static_cast<uint32_t>(num_partitions), d,
        static_cast<int32_t*>(hist));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
