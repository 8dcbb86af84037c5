// Segment-reduce kernel: the combine and merge legs of every groupby
// (Combine-Shuffle-Reduce, paper §5.3.4).
//
// Replaces the Pallas kernel src/repro/kernels/segment_reduce.py:89
// (segment_reduce_partials, body _kernel) together with the partials merge
// that src/repro/kernels/ops.py:150 (segment_reduce) ran after it. Rows arrive
// sorted by segment id; out[s] = sum | min | max of the rows of segment s, in
// the value dtype (int32, uint32, float32, bool, int8, uint8, int16 or
// float16). Segments with no rows hold the identity (0, or the dtype's
// largest / smallest value, +-inf for floats). Ids outside
// [0, num_segments) are dropped.
//
// Bound: bytes. N * (4 + width * esize) are read once and
// num_segments * width * esize written once; the arithmetic is a few
// integer operations per row. The TPU kernel's (block x max_segments) one-hot
// matmul and its separate merge have no use here. The design, and what each
// part does about the bound (PERF.md has the kernel's times):
//
// 1. Many rows per thread, loads always in flight. A block of 256 threads
//    takes a tile of 4096 rows, 16 consecutive rows per thread. Blocks are
//    persistent, 2 per SM (the registers allow 2; three ring slots and the
//    window fill the shared memory), and take every gridDim.x-th tile. While
//    a block reduces one tile, cp.async copies its next two into the ring:
//    64 KB in flight per block for int32, 128 KB per SM, against the ~25 KB
//    per SM that Little's law asks for (3.35 TB/s x ~1 us / 132 SMs). The
//    copy is coalesced (a warp takes 512 contiguous bytes) and swizzled in
//    shared memory: 16-byte loads of each thread's own 64 bytes would touch
//    every sector twice.
// 2. Dense tiles (width 1, all ids within 4096 of the tile's first: every
//    tile of the groupby's ids) reduce through shared atomics: each thread
//    reduces its runs in order and adds each into a 32-bit accumulator per
//    id, one atomic per run (one per warp when the warp holds a single id).
//    The atomics merge runs that threads split, so no scan is needed. The
//    block writes the accumulators out coalesced, decoded and narrowed.
// 3. Other tiles (width above 1, gaps, the ragged last tile) reduce runs in
//    the thread, join the partial runs at thread edges in a block-level
//    segmented scan (one round of shuffles per thread, then the 8 warp
//    totals) and stage their results in the same 16 KB window. Their rare
//    paths (empty runs, results past the window) are out of line, so that
//    the unrolled row loops stay short.
// 4. Tiles never wait on each other. Each writes one word per column: the
//    run open at its end, flagged when a segment starts in the tile. A
//    segment that runs into a tile from earlier tiles and ends there is
//    listed, and a second kernel of the same launch finishes it, walking back
//    over the words 256 tiles a step to the tile where it starts: a segment
//    over millions of rows costs a word per tile and one walk. (A decoupled
//    look-back would make tiles wait on their predecessors.) The only
//    atomics on global memory count the listed segments and long gaps.
// 5. Every output element written once. Tile t owns the ids from its first
//    id up to the next tile's first (tile 0 from 0, the last tile up to
//    num_segments): the segments that end in it and the empty ids after its
//    rows. Empty ids in the window take the identity the window is filled
//    with; past it, runs up to 1024 ids are written by the thread that finds
//    them and longer ones (the groupby's empty tail of each worker is tens of
//    millions of ids) are listed and written by the second kernel, spread
//    over the grid in 16-byte stores. The wrapper allocates the output with
//    torch.empty: there is no fill pass.
// 6. Min/max without compare-and-swap, with the reference's semantics. They
//    compare order-preserving int32 keys: integers as themselves (uint32
//    with the top bit flipped), floats (float16 widened exactly) by their
//    bits with the magnitude bits flipped when negative, so -0.0 < +0.0. A
//    NaN becomes the key that wins (INT_MIN for min, INT_MAX for max), so
//    any NaN gives NaN. Keys travel through the atomics, the scan and the
//    tile words and are decoded once, at the store: the output holds values,
//    never keys, and needs no second pass.
// 7. Sums add into the identity (+0.0 for floats), so rows of -0.0 sum to
//    +0.0. Integer sums wrap in uint32 and narrow at the store (mod 2^bits);
//    float16 sums accumulate in float32 and round once. Float sums combine in
//    another order than the reference, and the shared atomics' order varies
//    from run to run: they are exact only on integer-valued floats.
// 8. Which NaN a float min/max keeps is the reference's, whatever order the
//    atomics ran in: the thread that stores a NaN result looks up the
//    segment's rows (a binary search over the sorted ids, within the rows
//    of its tile where the segment starts there) and walks them in order;
//    max keeps the first NaN with the sign bit set, or else the last NaN,
//    min the first with it clear, or else the last. It then stores that
//    row's own bits, still once. Only NaN results pay for the search and
//    the walk.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;  // consecutive rows per thread
constexpr int64_t kTileRows = static_cast<int64_t>(kThreads) * kRows;
constexpr int kWindowBytes = 16384;  // outputs staged in shared memory per tile
constexpr int kDenseIds = kWindowBytes / 4;  // 32-bit accumulators of a dense tile
constexpr int64_t kShortGap = 1024;  // longer empty runs past the window go to pass 2
constexpr int kBlocksPerSm = 2;  // persistent tile blocks: registers and the ring allow 2
constexpr int kSlots = 3;        // ring slots: two tiles in flight while one is reduced
constexpr int kFinishBlocksPerSm = 4;
constexpr unsigned kFull = 0xFFFFFFFFu;
// a tile's word per column: bit 32 set when a segment starts in the tile, the
// low half the partial of the run open at the tile's end
constexpr unsigned long long kHasHead = 1ull << 32;

enum Op { kSum = 0, kMin = 1, kMax = 2 };

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }

// order-preserving key of float bits: -0.0 < +0.0; the map is its own inverse
__device__ __forceinline__ int32_t float_key(float f) {
  const int32_t b = __float_as_int(f);
  return b ^ ((b >> 31) & 0x7FFFFFFF);
}
__device__ __forceinline__ float key_float(int32_t k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7FFFFFFF));
}

// Column types: storage S, the min/max key and its range (the keys of the
// dtype's smallest and largest values), and the type sums accumulate in.
template <typename T, int32_t LO, int32_t HI>
struct ColInt {
  using S = T;
  using SumT = uint32_t;
  static constexpr bool kFloat = false;
  static constexpr int32_t kLo = LO, kHi = HI;
  __device__ static bool nan(S) { return false; }
  __device__ static int32_t key(S x) { return static_cast<int32_t>(x); }
  __device__ static S unkey(int32_t k) { return static_cast<S>(k); }
  __device__ static SumT widen(S x) { return static_cast<uint32_t>(static_cast<int32_t>(x)); }
  __device__ static S narrow(SumT a) { return static_cast<S>(a); }
};
using ColI32 = ColInt<int32_t, INT_MIN, INT_MAX>;
using ColI16 = ColInt<int16_t, -32768, 32767>;
using ColI8 = ColInt<int8_t, -128, 127>;
using ColU8 = ColInt<uint8_t, 0, 255>;
using ColBool = ColInt<uint8_t, 0, 1>;  // min is AND, max is OR

struct ColU32 {
  using S = uint32_t;
  using SumT = uint32_t;
  static constexpr bool kFloat = false;
  static constexpr int32_t kLo = INT_MIN, kHi = INT_MAX;
  __device__ static bool nan(S) { return false; }
  __device__ static int32_t key(S x) { return static_cast<int32_t>(x ^ 0x80000000u); }
  __device__ static S unkey(int32_t k) { return static_cast<uint32_t>(k) ^ 0x80000000u; }
  __device__ static SumT widen(S x) { return x; }
  __device__ static S narrow(SumT a) { return a; }
};

// keys of -inf and +inf
constexpr int32_t kNegInfKey = INT_MIN + 0x007FFFFF;
constexpr int32_t kPosInfKey = 0x7F800000;

struct ColF32 {
  using S = float;
  using SumT = float;
  static constexpr bool kFloat = true;
  static constexpr int32_t kLo = kNegInfKey, kHi = kPosInfKey;
  __device__ static bool nan(S x) { return x != x; }
  __device__ static bool sign(S x) { return __float_as_uint(x) >> 31; }
  __device__ static int32_t key(S x) { return float_key(x); }
  __device__ static S unkey(int32_t k) { return key_float(k); }
  __device__ static SumT widen(S x) { return x; }
  __device__ static S narrow(SumT a) { return a; }
};

struct ColF16 {
  using S = __half;
  using SumT = float;
  static constexpr bool kFloat = true;
  static constexpr int32_t kLo = kNegInfKey, kHi = kPosInfKey;
  __device__ static bool nan(S x) { return __hisnan(x); }
  __device__ static bool sign(S x) { return __half_as_ushort(x) >> 15; }
  __device__ static int32_t key(S x) { return float_key(__half2float(x)); }
  __device__ static S unkey(int32_t k) { return __float2half_rn(key_float(k)); }
  __device__ static SumT widen(S x) { return __half2float(x); }
  __device__ static S narrow(SumT a) { return __float2half_rn(a); }
};

// The reduction: accumulator A, its identity, load (widen or key), combine,
// store (narrow or decode).
template <typename C, int OP>
struct Red;

template <typename C>
struct Red<C, kSum> {
  using A = typename C::SumT;
  __device__ static A identity() { return A(0); }
  __device__ static A load(typename C::S x) { return C::widen(x); }
  __device__ static A combine(A a, A b) { return a + b; }
  __device__ static void atomic(A* p, A v) { atomicAdd(p, v); }
  __device__ static typename C::S store(A a) { return C::narrow(a); }
};

template <typename C>
struct Red<C, kMin> {
  using A = int32_t;
  __device__ static A identity() { return C::kHi; }
  __device__ static A load(typename C::S x) { return C::nan(x) ? INT_MIN : C::key(x); }
  __device__ static A combine(A a, A b) { return a < b ? a : b; }
  __device__ static void atomic(A* p, A v) { atomicMin(p, v); }
  __device__ static typename C::S store(A a) { return C::unkey(a); }
};

template <typename C>
struct Red<C, kMax> {
  using A = int32_t;
  __device__ static A identity() { return C::kLo; }
  __device__ static A load(typename C::S x) { return C::nan(x) ? INT_MAX : C::key(x); }
  __device__ static A combine(A a, A b) { return a > b ? a : b; }
  __device__ static void atomic(A* p, A v) { atomicMax(p, v); }
  __device__ static typename C::S store(A a) { return C::unkey(a); }
};

// The NaN that float min/max keeps for segment sid, column c (item 8): the
// segment's rows in order, max the first NaN with the sign bit set or else
// the last NaN, min the first with the sign bit clear or else the last.
// Rows [lo, end) hold all of the segment's rows. Called only for a segment
// whose result is NaN, so one is found.
template <typename C, int OP>
__device__ __noinline__ typename C::S kept_nan(const typename C::S* __restrict__ vals,
                                               const int32_t* __restrict__ seg, int64_t lo,
                                               int64_t end, int width, int64_t sid, int c) {
  for (int64_t hi = end; lo < hi;) {  // the segment's first row
    const int64_t mid = lo + (hi - lo) / 2;
    if (seg[mid] < sid) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  typename C::S last{};
  for (int64_t r = lo; r < end && seg[r] == sid; ++r) {
    const typename C::S x = vals[r * width + c];
    if (C::nan(x)) {
      if (C::sign(x) == (OP == kMax)) return x;
      last = x;
    }
  }
  return last;
}

// A segment's result from its accumulator: decoded, and for float min/max a
// NaN replaced by the reference's (item 8); rows [lo, end) hold the segment.
template <typename C, int OP>
__device__ __forceinline__ typename C::S result(typename Red<C, OP>::A a,
                                                const typename C::S* __restrict__ vals,
                                                const int32_t* __restrict__ seg, int64_t lo,
                                                int64_t end, int width, int64_t sid, int c) {
  const typename C::S x = Red<C, OP>::store(a);
  if constexpr (C::kFloat && OP != kSum) {
    if (C::nan(x)) return kept_nan<C, OP>(vals, seg, lo, end, width, sid, c);
  }
  return x;
}

__device__ __forceinline__ uint32_t to_bits(uint32_t a) { return a; }
__device__ __forceinline__ uint32_t to_bits(int32_t a) { return static_cast<uint32_t>(a); }
__device__ __forceinline__ uint32_t to_bits(float a) { return __float_as_uint(a); }
template <typename A>
__device__ A from_bits(uint32_t b);
template <>
__device__ __forceinline__ uint32_t from_bits<uint32_t>(uint32_t b) { return b; }
template <>
__device__ __forceinline__ int32_t from_bits<int32_t>(uint32_t b) {
  return static_cast<int32_t>(b);
}
template <>
__device__ __forceinline__ float from_bits<float>(uint32_t b) { return __uint_as_float(b); }

// an element of S from the low bits of a 32-bit word
template <typename S>
__device__ __forceinline__ S from_raw(uint32_t w) { return static_cast<S>(w); }
template <>
__device__ __forceinline__ float from_raw<float>(uint32_t w) { return __uint_as_float(w); }
template <>
__device__ __forceinline__ __half from_raw<__half>(uint32_t w) {
  return __ushort_as_half(static_cast<unsigned short>(w));
}

// One slot of the shared-memory ring: a tile's ids in 16-byte chunks, then a
// width-1 column's values alike, then the ids just before and just after the
// tile. The tile is copied in order, a warp taking 512 contiguous bytes, and
// chunk g is stored at swizzle(g) so that the 8 threads of each quarter-warp
// read 8 distinct bank groups when they take back their own rows.
template <typename S>
struct Stage {
  static constexpr int kIdVecs = kRows / 4;  // chunks per thread
  static constexpr int kValVecs = kRows * static_cast<int>(sizeof(S)) / 16;
  static constexpr int kVecs = (kIdVecs + kValVecs) * kThreads + 1;
  static constexpr int kBytes = kVecs * 16;
};

// chunk g of an array with per_thread chunks per thread (1, 2 or 4)
template <int per_thread>
__device__ __forceinline__ int swizzle(int g) {
  return per_thread == 1 ? g : g ^ ((g / per_thread) & 7);
}

// cp.async: global to shared memory without passing through registers
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most n of this thread's copy groups are still in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// start copying a whole tile into a ring slot, coalesced
template <typename S>
__device__ __forceinline__ void prefetch_tile(uint4* slot, const int32_t* seg, const S* vals,
                                              int64_t tile, int64_t n_rows, bool with_vals,
                                              int tid) {
  using St = Stage<S>;
  const int64_t start = tile * kTileRows;
  const uint4* gs = reinterpret_cast<const uint4*>(seg + start);
#pragma unroll
  for (int r = 0; r < St::kIdVecs; ++r) {
    const int g = r * kThreads + tid;
    cp_async16(slot + swizzle<St::kIdVecs>(g), gs + g);
  }
  if (with_vals) {
    const uint4* gv = reinterpret_cast<const uint4*>(vals + start);
    uint4* sv = slot + St::kIdVecs * kThreads;
#pragma unroll
    for (int r = 0; r < St::kValVecs; ++r) {
      const int g = r * kThreads + tid;
      cp_async16(sv + swizzle<St::kValVecs>(g), gv + g);
    }
  }
  int32_t* around = reinterpret_cast<int32_t*>(slot + St::kVecs - 1);
  if (tid == 0 && tile > 0) cp_async4(around, seg + start - 1);
  if (tid == 1 && start + kTileRows < n_rows) cp_async4(around + 1, seg + start + kTileRows);
}

// the kRows consecutive elements of thread tid from a staged array, unpacked
// with constant indices only, so that nothing lands in local memory
template <typename S>
__device__ __forceinline__ void unpack_rows(const uint4* p, int tid, S (&v)[kRows]) {
  constexpr int kPerWord = 4 / static_cast<int>(sizeof(S));
  constexpr int kPerVec = 4 * kPerWord;
  constexpr int kVecs = kRows / kPerVec;
  uint4 q[kVecs];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) q[i] = p[swizzle<kVecs>(tid * kVecs + i)];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const uint4 u = q[j / kPerVec];
    const int k = (j % kPerVec) / kPerWord;
    const uint32_t w = k == 0 ? u.x : k == 1 ? u.y : k == 2 ? u.z : u.w;
    v[j] = from_raw<S>(w >> (8 * static_cast<int>(sizeof(S)) * (j % kPerWord)));
  }
}

// row j of thread t from the staged ids
__device__ __forceinline__ int32_t staged_id(const uint4* slot, int t, int j) {
  constexpr int kVecs = kRows / 4;
  return reinterpret_cast<const int32_t*>(slot + swizzle<kVecs>(t * kVecs + j / 4))[j % 4];
}

// The empty ids strictly between ids a and b (a row's id and the next row's,
// or -1 / num_segments at the ends), clipped to [0, num_segments). The part
// past the staging window is written here when short and listed for pass 2
// when long; returns whether part lies in the window (the identity fill
// writes that). Kept out of line: dense ids never get here.
template <typename S>
__device__ __noinline__ bool empty_run(int64_t a, int64_t b, int64_t num_segments,
                                       int64_t win_hi, int width, S fill, S* out,
                                       unsigned long long* counters, int64_t* gaps,
                                       int64_t gap_cap) {
  const int64_t g0 = max64(a + 1, 0), g1 = min64(b, num_segments);
  if (g0 >= g1) return false;
  const int64_t p0 = max64(g0, win_hi);
  if (p0 < g1 && g1 - p0 <= kShortGap) {
    for (int64_t i = p0 * width; i < g1 * width; ++i) out[i] = fill;
  } else if (p0 < g1) {
    const unsigned long long k = atomicAdd(counters, 1ull);
    if (static_cast<int64_t>(k) < gap_cap) {
      gaps[2 * k] = p0;
      gaps[2 * k + 1] = g1;
    }
  }
  return g0 < win_hi;
}

// A segment's result outside the staging window (or a dropped id)
template <typename S>
__device__ __noinline__ void store_far(int32_t sid, int64_t off, S x, int64_t num_segments,
                                      S* out) {
  if (sid >= 0 && sid < num_segments) out[off] = x;
}

// Pass 1: every tile reduces its rows and writes its segments, except a
// first segment that began in an earlier tile; for that one it leaves its
// partial and a note for pass 2. Tiles never wait on each other.
template <typename C, int OP>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
segment_tiles(const typename C::S* __restrict__ vals, const int32_t* __restrict__ seg,
              int64_t n_rows, int width, int64_t num_segments, typename C::S* __restrict__ out,
              unsigned long long* __restrict__ counters, unsigned long long* __restrict__ tiles,
              uint32_t* __restrict__ pend, int2* __restrict__ pend_list,
              int64_t* __restrict__ gaps, int64_t gap_cap) {
  using R = Red<C, OP>;
  using S = typename C::S;
  using A = typename R::A;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* ring = reinterpret_cast<uint4*>(smem);
  S* window = reinterpret_cast<S*>(smem + kSlots * Stage<S>::kBytes);
  __shared__ A warp_total[kWarps];
  __shared__ int warp_head[kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t n_tiles = (n_rows + kTileRows - 1) / kTileRows;
  const bool stage_vals = width == 1;
  // A persistent block takes every gridDim.x-th tile and keeps the rows of
  // its next kSlots - 1 tiles loading into the ring while it reduces the
  // current one. Only whole tiles are staged. A slot is refilled only after
  // the barriers that follow every read of it.
  int64_t tile = blockIdx.x;
#pragma unroll
  for (int i = 0; i < kSlots - 1; ++i) {
    const int64_t t = tile + static_cast<int64_t>(i) * gridDim.x;
    if ((t + 1) * kTileRows <= n_rows) {
      prefetch_tile(ring + i * Stage<S>::kVecs, seg, vals, t, n_rows, stage_vals, tid);
    }
    cp_async_commit();
  }
  for (int k = 0; tile < n_tiles; ++k, tile += gridDim.x) {
    const int64_t ahead = tile + static_cast<int64_t>(kSlots - 1) * gridDim.x;
    if ((ahead + 1) * kTileRows <= n_rows) {
      prefetch_tile(ring + ((k + kSlots - 1) % kSlots) * Stage<S>::kVecs, seg, vals, ahead,
                    n_rows, stage_vals, tid);
    }
    cp_async_commit();
    cp_async_wait<kSlots - 1>();
    __syncthreads();  // every thread's copies of this tile have landed

    const uint4* slot = ring + (k % kSlots) * Stage<S>::kVecs;
    const int32_t* around = reinterpret_cast<const int32_t*>(slot + Stage<S>::kVecs - 1);
    const int64_t tile_start = tile * kTileRows, tile_end = tile_start + kTileRows;
    const bool staged = tile_end <= n_rows;
    const int64_t row0 = tile_start + static_cast<int64_t>(tid) * kRows;
    const int nv = static_cast<int>(max64(0, min64(kRows, n_rows - row0)));

    // ids, and a width-1 column's values; a ragged last tile from global
    // memory
    int32_t s[kRows];
    S v1[kRows];
    int32_t first_id, before = 0, after = 0;  // ids of the tile's first row and its neighbours
    if (staged) {
      unpack_rows(slot, tid, s);
      if (width == 1) unpack_rows(slot + Stage<S>::kIdVecs * kThreads, tid, v1);
      first_id = staged_id(slot, 0, 0);
      if (tile > 0) before = around[0];
      if (tile_end < n_rows) after = around[1];
    } else {
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        s[j] = j < nv ? seg[row0 + j] : 0;
        if (width == 1 && j < nv) v1[j] = vals[row0 + j];
      }
      first_id = seg[tile_start];
      if (tile > 0) before = seg[tile_start - 1];
    }
    const bool tile_continues = tile > 0 && before == first_id;
    // The ids this tile writes: [lo, hi). A first segment that began in an
    // earlier tile is finished by pass 2, so the window of staged outputs
    // starts after it.
    const int64_t lo = tile == 0 ? 0 : max64(0, min64(first_id, num_segments));
    const int64_t hi =
        max64(lo, tile_end < n_rows ? max64(0, min64(after, num_segments)) : num_segments);
    const bool first_valid = first_id >= 0 && first_id < num_segments;
    const int64_t win_lo = lo + (tile_continues && first_valid);
    const int64_t win_ids = kWindowBytes / (static_cast<int64_t>(width) * sizeof(S));
    const int64_t win_hi = max64(win_lo, min64(hi, win_lo + win_ids));

    // A dense tile of a width-1 column, the groupby's case: all its ids lie
    // within kDenseIds of the first. Each thread reduces its runs in order and
    // adds each into a 32-bit accumulator per id in shared memory, one
    // atomic per run (one per warp when the warp holds a single id); the
    // atomics merge runs split between threads, so no scan is needed. The
    // block then writes the accumulators out, decoded and narrowed.
    const int32_t last_id = staged ? staged_id(slot, kThreads - 1, kRows - 1) : 0;
    if (staged && width == 1 && last_id >= first_id &&
        static_cast<int64_t>(last_id) - first_id < kDenseIds) {
      A* acc_win = reinterpret_cast<A*>(window);
      const int64_t base = first_id;
      const uint32_t span = static_cast<uint32_t>(last_id - base + 1);
      const int64_t w_end = min64(hi, base + kDenseIds);  // the window's ids: [base, w_end)
      const int n_init = static_cast<int>(max64(span, w_end - base));
      for (int i = tid; i < n_init; i += kThreads) acc_win[i] = R::identity();
      __syncthreads();
      const int32_t warp_first = __shfl_sync(kFull, s[0], 0);
      A acc = R::identity();
      if (__all_sync(kFull, s[0] == warp_first && s[kRows - 1] == warp_first)) {
#pragma unroll
        for (int j = 0; j < kRows; ++j) acc = R::combine(acc, R::load(v1[j]));
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          acc = R::combine(acc, __shfl_xor_sync(kFull, acc, off));
        }
        if (lane == 0) R::atomic(acc_win + (warp_first - base), acc);
      } else {
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          acc = R::combine(acc, R::load(v1[j]));
          if (j == kRows - 1 || s[(j + 1) & (kRows - 1)] != s[j]) {
            const uint32_t off = static_cast<uint32_t>(s[j] - base);
            if (off < span) R::atomic(acc_win + off, acc);  // always, for sorted ids
            acc = R::identity();
          }
        }
      }
      __syncthreads();
      if (tid == 0) {
        const bool has_head = !tile_continues || first_id != last_id;
        tiles[tile] = (has_head ? kHasHead : 0ull) | to_bits(acc_win[last_id - base]);
        const bool first_ends = first_id != last_id || tile_end == n_rows || after != first_id;
        if (tile_continues && first_valid && first_ends) {  // finished by pass 2
          pend[tile] = to_bits(acc_win[0]);
          const unsigned long long e = atomicAdd(counters + 1, 1ull);
          pend_list[e] = make_int2(static_cast<int>(tile), first_id);
        }
        const S fill = R::store(R::identity());
        if (tile == 0) empty_run(-1, base, num_segments, 0, 1, fill, out, counters, gaps, gap_cap);
        empty_run(last_id, hi, num_segments, base + kDenseIds, 1, fill, out, counters, gaps,
                  gap_cap);
      }
      // the segments it stores lie in the tile's rows: one that runs in from
      // an earlier tile or on into a later one is pass 2's
      const int64_t w0 = max64(win_lo, base);
      for (int64_t id = w0 + tid; id < w_end; id += kThreads) {
        out[id] = result<C, OP>(acc_win[id - base], vals, seg, tile_start, tile_end, 1, id, 0);
      }
      continue;
    }

    // The general case: width above 1, ids with gaps, the ragged last tile.
    // The ids of the rows just before and after this thread's
    int32_t last = s[0];
#pragma unroll
    for (int j = 1; j < kRows; ++j) last = j < nv ? s[j] : last;
    int32_t prev = __shfl_up_sync(kFull, last, 1);
    int32_t next = __shfl_down_sync(kFull, s[0], 1);
    if (lane == 0 && nv > 0) {
      if (tid == 0) {
        prev = before;
      } else if (staged) {
        prev = staged_id(slot, tid - 1, kRows - 1);
      } else {
        prev = seg[row0 - 1];
      }
    }
    if (lane == 31 && row0 + kRows < n_rows) {
      if (tid == kThreads - 1) {
        next = after;
      } else if (staged) {
        next = staged_id(slot, tid + 1, 0);
      } else {
        next = seg[row0 + kRows];
      }
    }
    const bool at_end = row0 + nv >= n_rows;  // holds the last row

    // bit j: row j starts a run / ends a run
    unsigned heads = 0, ends = 0;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (j < nv) {
        const bool h = j == 0 ? (row0 == 0 || prev != s[0]) : s[j] != s[j - 1];
        const int32_t nx = j + 1 < kRows ? s[(j + 1) & (kRows - 1)] : next;
        const bool e = j + 1 < nv ? nx != s[j] : (at_end || next != s[j]);
        heads |= static_cast<unsigned>(h) << j;
        ends |= static_cast<unsigned>(e) << j;
      }
    }

    // Empty ids: each thread takes the ids strictly between each of its rows'
    // ids and the next row's (before row 0 too, and up to num_segments after
    // the last row). Inside the window the identity fill below writes them.
    // Bit j of `gap` marks a jump of more than one id after row j: rare in
    // dense ids, so only that test is unrolled.
    const S fill = R::store(R::identity());
    unsigned gap = 0;
#pragma unroll
    for (int j = 0; j + 1 < kRows; ++j) {
      if (j + 1 < nv) {
        gap |= static_cast<unsigned>(static_cast<uint32_t>(s[j + 1] - s[j]) > 1u) << j;
      }
    }
    bool window_gap = false;
    if (nv > 0) {  // after the last row: the next thread's first id, or num_segments
      const int64_t b = at_end ? num_segments : next;
      gap |= static_cast<unsigned>(b - last > 1) << (nv - 1);
      if (row0 == 0) window_gap = empty_run(-1, s[0], num_segments, win_hi, width, fill, out,
                                            counters, gaps, gap_cap);
    }
    // the ids are read again from the ring or from memory
    auto id_at = [&](int j) -> int64_t {
      return staged ? staged_id(slot, tid, j) : seg[row0 + j];
    };
    for (unsigned g = gap; g; g &= g - 1) {
      const int j = __ffs(static_cast<int>(g)) - 1;
      const int64_t b = j + 1 < nv ? id_at(j + 1) : (at_end ? num_segments : next);
      window_gap |= empty_run(id_at(j), b, num_segments, win_hi, width, fill, out, counters,
                              gaps, gap_cap);
    }
    if (__syncthreads_or(window_gap)) {
      const int64_t n = (win_hi - win_lo) * width;
      for (int64_t i = tid; i < n; i += kThreads) window[i] = fill;
      __syncthreads();
    }

    const bool head0 = heads & 1u;
    const unsigned hmask = __ballot_sync(kFull, heads != 0);
    const unsigned upto = hmask & (kFull >> (31 - lane));  // heads in lanes 0..lane
    const int head_lane = upto ? 31 - __clz(static_cast<int>(upto)) : -1;
    const bool head_below = (hmask & ((1u << lane) - 1u)) != 0;

    // window offsets in 32 bits: win_lo lies in [0, 2^31] and a tile's ids
    // are at least its first id, so an id below win_lo wraps past win_n
    const uint32_t win_n = static_cast<uint32_t>(win_hi - win_lo);
    const uint32_t win_lo32 = static_cast<uint32_t>(win_lo);
    // rows that end a run whose result is whole in this thread: all of them,
    // except the first when the thread's first run began before it
    const unsigned emit = head0 ? ends : ends & (ends - 1);
    const bool first_pending = !head0 && ends != 0;
    for (int c = 0; c < width; ++c) {
      // a segment's result: into the staging window when it lies there
      auto put = [&](int32_t sid, S x) {
        const uint32_t off = static_cast<uint32_t>(sid) - win_lo32;
        if (off < win_n) {
          window[off * width + c] = x;
        } else {
          store_far(sid, static_cast<int64_t>(sid) * width + c, x, num_segments, out);
        }
      };
      if (width != 1) {
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          if (j < nv) v1[j] = vals[(row0 + j) * width + c];
        }
      }
      // runs inside the thread, in order; the first one waits for the carry
      // unless it starts here
      A acc = R::identity(), first = R::identity();
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (j < nv) {
          acc = R::combine(acc, R::load(v1[j]));
          if ((ends >> j) & 1u) {
            if ((emit >> j) & 1u) {
              put(s[j], result<C, OP>(acc, vals, seg, tile_start, row0 + nv, width, s[j], c));
            } else {
              first = acc;
            }
            acc = R::identity();
          }
        }
      }
      // segmented scan of the open runs: within the warp, then over the warps
      A incl = acc;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const A o = __shfl_up_sync(kFull, incl, off);
        if (lane >= off && lane - off >= head_lane) incl = R::combine(o, incl);
      }
      const A excl = __shfl_up_sync(kFull, incl, 1);
      if (lane == 31) {
        warp_total[warp] = incl;
        warp_head[warp] = hmask != 0;
      }
      __syncthreads();
      A warp_in = R::identity();
      bool warp_closed = false;
      for (int w = warp - 1; w >= 0 && !warp_closed; --w) {
        warp_in = R::combine(warp_total[w], warp_in);
        warp_closed = warp_head[w];
      }
      if (tid == 0) {  // the run open at the tile's end, for pass 2
        A agg = R::identity();
        bool tile_head = false;
        for (int w = kWarps - 1; w >= 0 && !tile_head; --w) {
          agg = R::combine(warp_total[w], agg);
          tile_head = warp_head[w];
        }
        tiles[tile * width + c] = (tile_head ? kHasHead : 0ull) | to_bits(agg);
      }
      const A carry = head_below ? excl : (lane == 0 ? warp_in : R::combine(warp_in, excl));
      if (first_pending) {
        const A v = R::combine(carry, first);
        if (head_below || warp_closed || !tile_continues) {
          put(s[0], result<C, OP>(v, vals, seg, tile_start, row0 + nv, width, s[0], c));
        } else if (first_valid) {  // the tile's first segment ends here: pass 2 finishes it
          pend[tile * width + c] = to_bits(v);
          if (c == 0) {
            const unsigned long long e = atomicAdd(counters + 1, 1ull);
            pend_list[e] = make_int2(static_cast<int>(tile), first_id);
          }
        }
      }
      __syncthreads();
    }

    const int n_win = static_cast<int>(win_n) * width;
    S* dst = out + win_lo * width;
    for (int i = tid; i < n_win; i += kThreads) dst[i] = window[i];
  }
}

// the combination over the block of one value per thread, in every thread
template <typename R>
__device__ __forceinline__ typename R::A block_combine(typename R::A v, typename R::A* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = R::combine(v, __shfl_xor_sync(kFull, v, off));
  if (lane == 0) part[warp] = v;
  __syncthreads();
  typename R::A all = part[0];
  for (int w = 1; w < kWarps; ++w) all = R::combine(all, part[w]);
  __syncthreads();
  return all;
}

// Pass 2. (a) Each segment that ran into a tile from earlier tiles and ends in
// it: the block walks back over the tiles' words, 256 tiles a step, down to
// the nearest tile where a segment starts, and writes the segment once.
// (b) The long empty runs the tiles listed, each spread over the whole grid
// in 16-byte stores.
template <typename C, int OP>
__global__ void __launch_bounds__(kThreads)
segment_finish(const typename C::S* __restrict__ vals, const int32_t* __restrict__ seg,
               int64_t n_rows, typename C::S* __restrict__ out, int width, int64_t n_tiles,
               const unsigned long long* __restrict__ counters,
               const unsigned long long* __restrict__ tiles, const uint32_t* __restrict__ pend,
               const int2* __restrict__ pend_list, const int64_t* __restrict__ gaps,
               int64_t gap_cap) {
  using S = typename C::S;
  using R = Red<C, OP>;
  using A = typename R::A;
  __shared__ A part[kWarps];
  __shared__ int nearest[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int64_t n_pend = min64(static_cast<int64_t>(counters[1]), n_tiles);
  for (int64_t e = blockIdx.x; e < n_pend; e += gridDim.x) {
    const int2 entry = pend_list[e];
    const int64_t tile = entry.x;
    for (int c = 0; c < width; ++c) {
      A acc = R::identity();
      for (int64_t top = tile - 1;; top -= kThreads) {
        const int64_t t = top - tid;
        const unsigned long long w = t >= 0 ? tiles[t * width + c] : kHasHead;
        // the nearest tile with a segment start among these 256
        const unsigned heads = __ballot_sync(kFull, (w & kHasHead) != 0ull);
        if (lane == 0) nearest[warp] = heads ? warp * 32 + __ffs(static_cast<int>(heads)) - 1
                                             : kThreads;
        __syncthreads();
        int stop = kThreads;
        for (int i = 0; i < kWarps; ++i) stop = min(stop, nearest[i]);
        const A v = tid <= stop ? from_bits<A>(static_cast<uint32_t>(w)) : R::identity();
        acc = R::combine(block_combine<R>(v, part), acc);
        if (stop < kThreads) break;
      }
      if (tid == 0) {
        const A v = R::combine(acc, from_bits<A>(pend[tile * width + c]));
        out[static_cast<int64_t>(entry.y) * width + c] =
            result<C, OP>(v, vals, seg, 0, min64((tile + 1) * kTileRows, n_rows), width,
                          entry.y, c);
      }
    }
  }

  constexpr int64_t kPer = 16 / static_cast<int64_t>(sizeof(S));
  const S fill = R::store(R::identity());
  S fills[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) fills[i] = fill;
  uint4 pattern;
  memcpy(&pattern, fills, sizeof(pattern));
  const int64_t n_gaps = min64(static_cast<int64_t>(counters[0]), gap_cap);
  const int64_t gtid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  uint4* body = reinterpret_cast<uint4*>(out);
  for (int64_t k = 0; k < n_gaps; ++k) {
    const int64_t a = gaps[2 * k] * width, b = gaps[2 * k + 1] * width;
    const int64_t a16 = min64(b, (a + kPer - 1) / kPer * kPer);
    const int64_t b16 = max64(a16, b / kPer * kPer);
    for (int64_t i = a + gtid; i < a16; i += stride) out[i] = fill;
    for (int64_t i = a16 / kPer + gtid; i < b16 / kPer; i += stride) __stcs(body + i, pattern);
    for (int64_t i = b16 + gtid; i < b; i += stride) out[i] = fill;
  }
}

int64_t tiles_of(int64_t n_rows) { return (n_rows + kTileRows - 1) / kTileRows; }

// Long gaps are disjoint runs of more than kShortGap ids, one per row
// boundary at most.
int64_t gap_capacity(int64_t n_rows, int64_t num_segments) {
  const int64_t by_ids = num_segments / (kShortGap + 1);
  return (n_rows + 1 < by_ids ? n_rows + 1 : by_ids) + 1;
}

// Scratch, in 8-byte words: the long-gap and pending counts, a word and a
// pending partial (4 bytes) per (tile, column), a pending entry per tile,
// the long-gap list.
struct Scratch {
  unsigned long long* counters;
  unsigned long long* tiles;
  uint32_t* pend;
  int2* pend_list;
  int64_t* gaps;
  int64_t words;
};

Scratch carve(void* scratch, int64_t n_rows, int width, int64_t num_segments) {
  const int64_t n_tiles = tiles_of(n_rows), per = n_tiles * width;
  auto* base = static_cast<unsigned long long*>(scratch);
  Scratch sc;
  sc.counters = base;
  sc.tiles = base + 2;
  sc.pend = reinterpret_cast<uint32_t*>(sc.tiles + per);
  sc.pend_list = reinterpret_cast<int2*>(sc.tiles + per + (per + 1) / 2);
  sc.gaps = reinterpret_cast<int64_t*>(sc.tiles + per + (per + 1) / 2 + n_tiles);
  sc.words = 2 + per + (per + 1) / 2 + n_tiles + 2 * gap_capacity(n_rows, num_segments);
  return sc;
}

template <typename C, int OP>
cudaError_t run(const void* vals, const int32_t* seg, int64_t n_rows, int width,
                int64_t num_segments, void* out, void* scratch, cudaStream_t s) {
  using S = typename C::S;
  const int64_t n_tiles = tiles_of(n_rows);
  const Scratch sc = carve(scratch, n_rows, width, num_segments);
  const int64_t cap = gap_capacity(n_rows, num_segments);
  cudaError_t err = cudaMemsetAsync(sc.counters, 0, 2 * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int smem = kSlots * Stage<S>::kBytes + kWindowBytes;
  err = cudaFuncSetAttribute(segment_tiles<C, OP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const int64_t slots = static_cast<int64_t>(sms) * kBlocksPerSm;
  const unsigned blocks = static_cast<unsigned>(n_tiles < slots ? n_tiles : slots);
  segment_tiles<C, OP><<<blocks, kThreads, smem, s>>>(
      static_cast<const S*>(vals), seg, n_rows, width, num_segments, static_cast<S*>(out),
      sc.counters, sc.tiles, sc.pend, sc.pend_list, sc.gaps, cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  segment_finish<C, OP><<<sms * kFinishBlocksPerSm, kThreads, 0, s>>>(
      static_cast<const S*>(vals), seg, n_rows, static_cast<S*>(out), width, n_tiles, sc.counters, sc.tiles, sc.pend, sc.pend_list,
      sc.gaps, cap);
  return cudaGetLastError();
}

template <typename C>
cudaError_t run_op(int op, const void* vals, const int32_t* seg, int64_t n_rows, int width,
                   int64_t num_segments, void* out, void* scratch, cudaStream_t s) {
  if (op == kSum) return run<C, kSum>(vals, seg, n_rows, width, num_segments, out, scratch, s);
  if (op == kMin) return run<C, kMin>(vals, seg, n_rows, width, num_segments, out, scratch, s);
  return run<C, kMax>(vals, seg, n_rows, width, num_segments, out, scratch, s);
}

}  // namespace

// Bytes of scratch segment_reduce_launch needs.
extern "C" int64_t segment_reduce_scratch_bytes(int64_t n_rows, int width, int64_t num_segments) {
  return carve(nullptr, n_rows, width, num_segments).words *
         static_cast<int64_t>(sizeof(unsigned long long));
}

// dtype: 0 int32, 1 uint32, 2 float32, 3 bool, 4 int8, 5 uint8, 6 int16,
// 7 float16. op: 0 sum, 1 min, 2 max (bool takes min and max only). Values
// and ids 16-byte aligned; scratch of segment_reduce_scratch_bytes.
extern "C" int segment_reduce_launch(const void* vals, const void* seg_ids, int64_t n_rows,
                                     int width, int64_t num_segments, int dtype, int op,
                                     void* out, void* scratch, void* stream) {
  if (n_rows <= 0 || width <= 0 || num_segments <= 0) return static_cast<int>(cudaGetLastError());
  const int32_t* seg = static_cast<const int32_t*>(seg_ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(run_op<ColI32>(op, vals, seg, n_rows, width, num_segments,
                                                   out, scratch, s));
    case 1: return static_cast<int>(run_op<ColU32>(op, vals, seg, n_rows, width, num_segments,
                                                   out, scratch, s));
    case 2: return static_cast<int>(run_op<ColF32>(op, vals, seg, n_rows, width, num_segments,
                                                   out, scratch, s));
    case 3:
      if (op == kSum) return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(
          op == kMin ? run<ColBool, kMin>(vals, seg, n_rows, width, num_segments, out, scratch, s)
                     : run<ColBool, kMax>(vals, seg, n_rows, width, num_segments, out, scratch, s));
    case 4: return static_cast<int>(run_op<ColI8>(op, vals, seg, n_rows, width, num_segments,
                                                  out, scratch, s));
    case 5: return static_cast<int>(run_op<ColU8>(op, vals, seg, n_rows, width, num_segments,
                                                  out, scratch, s));
    case 6: return static_cast<int>(run_op<ColI16>(op, vals, seg, n_rows, width, num_segments,
                                                   out, scratch, s));
    case 7: return static_cast<int>(run_op<ColF16>(op, vals, seg, n_rows, width, num_segments,
                                                   out, scratch, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
