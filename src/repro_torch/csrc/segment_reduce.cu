// Segment-reduce kernel: the combine and merge legs of every groupby
// (Combine-Shuffle-Reduce, paper §5.3.4).
//
// Replaces the Pallas kernel src/repro/kernels/segment_reduce.py
// (segment_reduce_partials, body _kernel) together with the partials merge
// that src/repro/kernels/ops.py (segment_reduce) ran after it. Rows arrive
// sorted by segment id; out[s] = sum | min | max of the rows of segment s,
// in the value dtype (int32, uint32 or float32). Segments with no rows keep
// the identity the wrapper filled in (0, or the min/max sentinel). Ids
// outside [0, num_segments) are dropped.
//
// Bound: bytes. Each row reads 4 * width value bytes and a 4-byte id, and
// each segment's result is written once. Design: the TPU kernel's
// (block x max_segments) one-hot matmul has no use here. Instead the merge is
// fused: every warp takes 32 consecutive rows and reduces each run of equal
// ids with a segmented shuffle reduction, then the first lane of each run
// writes its result. A run that lies wholly inside the warp is the whole
// segment and is stored directly; only a run that continues into the
// neighbouring warp's rows is combined with an atomic. So atomics are at most
// two per warp, whatever the segment sizes.
//
// Integer sums run in uint32 arithmetic and wrap like jax's segment_sum.
// Float sums combine in another order than the reference, and atomics make
// that order vary from run to run: they are exact only on integer-valued
// floats. Float min/max use a compare-and-swap loop.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;

enum Op { kSum = 0, kMin = 1, kMax = 2 };

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float neg_inf() { return __int_as_float(static_cast<int>(0xff800000u)); }

__device__ __forceinline__ int32_t lowest(int32_t) { return INT_MIN; }
__device__ __forceinline__ uint32_t lowest(uint32_t) { return 0u; }
__device__ __forceinline__ float lowest(float) { return neg_inf(); }
__device__ __forceinline__ int32_t highest(int32_t) { return INT_MAX; }
__device__ __forceinline__ uint32_t highest(uint32_t) { return 0xFFFFFFFFu; }
__device__ __forceinline__ float highest(float) { return pos_inf(); }

__device__ __forceinline__ void atomic_min(int32_t* p, int32_t v) { atomicMin(p, v); }
__device__ __forceinline__ void atomic_min(uint32_t* p, uint32_t v) { atomicMin(p, v); }
__device__ __forceinline__ void atomic_min(float* p, float v) {
  int* pi = reinterpret_cast<int*>(p);
  int old = *pi;
  while (v < __int_as_float(old)) {
    const int assumed = old;
    old = atomicCAS(pi, assumed, __float_as_int(v));
    if (old == assumed) break;
  }
}

__device__ __forceinline__ void atomic_max(int32_t* p, int32_t v) { atomicMax(p, v); }
__device__ __forceinline__ void atomic_max(uint32_t* p, uint32_t v) { atomicMax(p, v); }
__device__ __forceinline__ void atomic_max(float* p, float v) {
  int* pi = reinterpret_cast<int*>(p);
  int old = *pi;
  while (v > __int_as_float(old)) {
    const int assumed = old;
    old = atomicCAS(pi, assumed, __float_as_int(v));
    if (old == assumed) break;
  }
}

template <typename T, int OP> struct Reduce;

template <typename T> struct Reduce<T, kSum> {
  __device__ static T identity() { return T(0); }
  __device__ static T combine(T a, T b) { return a + b; }
  __device__ static void atomic(T* p, T v) { atomicAdd(p, v); }
};

template <typename T> struct Reduce<T, kMin> {
  __device__ static T identity() { return highest(T()); }
  __device__ static T combine(T a, T b) { return b < a ? b : a; }
  __device__ static void atomic(T* p, T v) { atomic_min(p, v); }
};

template <typename T> struct Reduce<T, kMax> {
  __device__ static T identity() { return lowest(T()); }
  __device__ static T combine(T a, T b) { return b > a ? b : a; }
  __device__ static void atomic(T* p, T v) { atomic_max(p, v); }
};

template <typename T, int OP>
__global__ void segment_reduce_kernel(const T* __restrict__ vals,
                                      const int32_t* __restrict__ seg,
                                      int64_t n_rows, int width, int64_t num_segments,
                                      T* __restrict__ out) {
  using R = Reduce<T, OP>;
  const int lane = threadIdx.x & 31;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t nwarps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  // every lane of a warp runs the same iterations, so the shuffles below
  // always see all 32 lanes
  for (int64_t base = warp * 32; base < n_rows; base += nwarps * 32) {
    const int64_t row = base + lane;
    const bool active = row < n_rows;
    const int32_t s = active ? seg[row] : -1;
    const int32_t s_up = __shfl_up_sync(kFull, s, 1);
    const bool head = lane == 0 || s_up != s;
    const unsigned heads = __ballot_sync(kFull, head);
    // heads strictly above this lane (2u << 31 wraps to 0: none)
    const unsigned above = heads & ~((2u << lane) - 1u);
    const int run_end = above ? __ffs(static_cast<int>(above)) - 2 : 31;
    bool crosses = false;
    if (head && lane == 0 && base > 0) crosses = seg[base - 1] == s;
    if (head && run_end == 31 && base + 32 < n_rows) crosses |= seg[base + 32] == s;
    const bool emit = head && active && s >= 0 && s < num_segments;
    for (int c = 0; c < width; ++c) {
      T v = active ? vals[row * width + c] : R::identity();
      for (int off = 1; off < 32; off <<= 1) {
        const T o = __shfl_down_sync(kFull, v, off);
        const int32_t so = __shfl_down_sync(kFull, s, off);
        if (lane + off < 32 && so == s) v = R::combine(v, o);
      }
      if (emit) {
        T* dst = out + static_cast<int64_t>(s) * width + c;
        if (crosses) {
          R::atomic(dst, v);
        } else {
          *dst = v;
        }
      }
    }
  }
}

template <typename T, int OP>
void launch(const void* vals, const int32_t* seg, int64_t n_rows, int width,
            int64_t num_segments, void* out, int blocks, cudaStream_t s) {
  segment_reduce_kernel<T, OP><<<blocks, 256, 0, s>>>(
      static_cast<const T*>(vals), seg, n_rows, width, num_segments,
      static_cast<T*>(out));
}

}  // namespace

// dtype: 0 int32, 1 uint32, 2 float32. op: 0 sum, 1 min, 2 max.
extern "C" int segment_reduce_launch(const void* vals, const void* seg_ids,
                                     int64_t n_rows, int width, int64_t num_segments,
                                     int dtype, int op, void* out, void* stream) {
  if (n_rows <= 0 || width <= 0) return static_cast<int>(cudaGetLastError());
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int64_t want = (n_rows + 255) / 256;
  int64_t cap = static_cast<int64_t>(sms) * 8;
  int blocks = static_cast<int>(want < cap ? want : cap);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* seg = static_cast<const int32_t*>(seg_ids);
  if (op == kSum) {
    // int32 and uint32 sums are the same wrapping uint32 sum
    if (dtype == 2) {
      launch<float, kSum>(vals, seg, n_rows, width, num_segments, out, blocks, s);
    } else {
      launch<uint32_t, kSum>(vals, seg, n_rows, width, num_segments, out, blocks, s);
    }
  } else if (op == kMin) {
    if (dtype == 0) launch<int32_t, kMin>(vals, seg, n_rows, width, num_segments, out, blocks, s);
    else if (dtype == 1) launch<uint32_t, kMin>(vals, seg, n_rows, width, num_segments, out, blocks, s);
    else launch<float, kMin>(vals, seg, n_rows, width, num_segments, out, blocks, s);
  } else {
    if (dtype == 0) launch<int32_t, kMax>(vals, seg, n_rows, width, num_segments, out, blocks, s);
    else if (dtype == 1) launch<uint32_t, kMax>(vals, seg, n_rows, width, num_segments, out, blocks, s);
    else launch<float, kMax>(vals, seg, n_rows, width, num_segments, out, blocks, s);
  }
  return static_cast<int>(cudaGetLastError());
}
