// Flash attention: causal or bidirectional GQA attention with an online
// softmax, an optional sliding window and an optional logit softcap.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py
// (flash_attention, body _kernel). q is (B, S, H, hd), k and v are
// (B, S, KV, hd), in bf16 or float32; the output has q's dtype. Query head h
// reads K/V head h / (H / KV), so grouped heads never broadcast K/V in
// memory. Scores are s = scale * q.k, then softcap * tanh(s / softcap) when a
// softcap is given; key t is visible to query r when t < S, t <= r (causal)
// and t > r - window (window).
//
// Bound: operations. Attention does 4 * B * H * S * S * hd flops (half of it
// when causal) on 2 * B * S * (H + 2 KV) * hd elements, far above the card's
// balance of about 295 bf16 flops per byte: 0.278 ms at zamba2's prefill
// (4, 4096, 32, 64) causal on 989 TFLOP/s.
//
// Two kernels, chosen by dtype.
//
// bf16 (flash_bf16_kernel): both products on the tensor cores with wgmma, in
// the shape of FlashAttention-3, simplified. A block owns one (batch, query
// head) and 128 query rows: two consumer warpgroups of 64 rows and one
// producer warpgroup, of which one thread issues every load. The producer
// keeps K/V tiles (128 key rows for hd 64 and 128, 64 for hd 256) in flight
// in a ring of shared-memory stages (4 for hd 64, 2 above), each guarded by a
// full/empty mbarrier pair. Loads are TMA copies through 4-D tensor maps
// (hd, heads, S, B) with boxes (64, 1, rows, 1) and the 128-byte swizzle, so
// a ragged tail zero-fills inside its own batch; hd above 64 is loaded as
// 64-column atoms side by side. S = Q K^T is wgmma m64n{BK}k16 with Q and K
// from shared memory (both K-major, as stored). The online softmax (max,
// rescale, row sums from the float32 probabilities) runs in float32 on the
// accumulator fragments, in base 2: one FFMA and one ex2 per score, the mask
// only on tiles that cross the diagonal, the window edge or S. P is rounded
// to bf16 in registers, where its accumulator layout is already wgmma's A
// fragment layout, and O += P V is wgmma m64n64k16 per 64 output columns
// with V read from shared memory through the transpose bit (V stays as
// stored). The score product of tile j and the PV product of tile j - 1 are
// in flight together, and the softmax of tile j runs while the PV product
// finishes. Only tiles some query of the block can see are visited, and the
// heaviest query tiles are scheduled first. The output is divided by the
// row sum in float32 and stored as bf16. Rounding P to bf16 before the PV
// product follows the reference model (src/repro/models/attention.py:106);
// the TPU kernel kept it in float32.
//
// float32 (flash_attention_kernel): the products run on the CUDA cores in
// float32, the TPU kernel's arithmetic. A block owns one (batch, head) and 64
// query rows and walks the K/V tiles in a loop, which takes the place of the
// TPU's sequential kv grid axis; the running max, sum and output rows stay in
// registers, the Q, K, V and probability tiles in shared memory (float32,
// rows padded so that the column reads hit distinct banks). Each thread
// holds 4 query rows; 16 threads share a row and combine its max and sum
// with shuffles. Like the bf16 kernel it visits only tiles some query can
// see and schedules the heaviest query tiles first. Tiles: 64 query rows;
// 64 key rows for head_dim 64 and 128, 32 for 256 (the float32 Q, K and V
// tiles of hd 256 at 64 rows would need 197 KB).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// float32: CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kBQ = 64;          // query rows per block
constexpr float kNeg = -1e30f;   // the TPU kernel's mask value

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, S, H, KV;
  int causal;
  long long window;  // <= 0: no window
  float softcap;     // <= 0: no softcap
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }

template <int BK, int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (HD + 1) + BK * (HD + 1) + BK * HD + kBQ * (BK + 1));
}

template <typename T, int HD, int BK>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const Params p) {
  constexpr int QS = HD + 1;   // row stride of the Q and K tiles
  constexpr int PS = BK + 1;   // row stride of the probability tile
  constexpr int CJ = BK / 16;  // score columns per thread
  constexpr int DJ = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;            // kBQ x QS
  float* Ks = Qs + kBQ * QS;   // BK x QS
  float* Vs = Ks + BK * QS;    // BK x HD
  float* Ps = Vs + BK * HD;    // kBQ x PS

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest query tiles first
  const int q_start = qt * kBQ;
  const int S = p.S;

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  T* o = static_cast<T*>(p.o);
  const long long q_row = static_cast<long long>(p.H) * HD;   // elements between rows
  const long long kv_row = static_cast<long long>(p.KV) * HD;
  const T* qb = q + static_cast<long long>(b) * S * q_row + static_cast<long long>(h) * HD;
  const T* kb = k + static_cast<long long>(b) * S * kv_row + static_cast<long long>(kvh) * HD;
  const T* vb = v + static_cast<long long>(b) * S * kv_row + static_cast<long long>(kvh) * HD;
  T* ob = o + static_cast<long long>(b) * S * q_row + static_cast<long long>(h) * HD;

  for (int idx = tid; idx < kBQ * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int s = q_start + r;
    Qs[r * QS + d] = s < S ? to_f32(qb[s * q_row + d]) : 0.f;
  }

  // the K/V tiles some query of this tile can see
  int kt_begin = 0;
  int kt_end = (S + BK - 1) / BK;
  if (p.causal) {
    const int last = min(q_start + kBQ - 1, S - 1);
    kt_end = min(kt_end, last / BK + 1);
  }
  if (p.window > 0) {
    // live when k_start + BK - 1 > q_start - window
    const long long lo = static_cast<long long>(q_start) - p.window - BK + 2;
    if (lo > 0) kt_begin = static_cast<int>((lo + BK - 1) / BK);
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k_start = kt * BK;
    __syncthreads();  // the last tile's K, V and P reads are done
    for (int idx = tid; idx < BK * HD; idx += kThreads) {
      const int c = idx / HD, d = idx % HD;
      const int t = k_start + c;
      const bool in = t < S;
      Ks[c * QS + d] = in ? to_f32(kb[t * kv_row + d]) : 0.f;
      Vs[c * HD + d] = in ? to_f32(vb[t * kv_row + d]) : 0.f;
    }
    __syncthreads();

    float s[4][CJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * QS + d];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = Ks[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const long long q_pos = q_start + r;
      bool live[CJ];
      float row_max = kNeg;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int k_pos = k_start + tx + 16 * j;
        float x = s[i][j] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        bool ok = k_pos < S;
        if (p.causal) ok = ok && k_pos <= q_pos;
        if (p.window > 0) ok = ok && k_pos > q_pos - p.window;
        live[j] = ok;
        s[i][j] = ok ? x : kNeg;
        row_max = fmaxf(row_max, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float e = live[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[r * PS + tx + 16 * j] = e;
        row_sum += e;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float vv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[c * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pv = Ps[(ty * 4 + i) * PS + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q_start + ty * 4 + i;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      store_as(&ob[row * q_row + tx + 16 * j], acc[i][j] * inv);
  }
}

template <typename T, int HD, int BK>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<BK, HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, HD, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H, (p.S + kBQ - 1) / kBQ);
  flash_attention_kernel<T, HD, BK><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const Params& p, int head_dim, cudaStream_t stream) {
  switch (head_dim) {
    case 64: return launch<T, 64, 64>(p, stream);
    case 128: return launch<T, 128, 64>(p, stream);
    case 256: return launch<T, 256, 32>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma kernel fed by TMA
// ---------------------------------------------------------------------------

namespace wg {

constexpr int kBQ = 128;         // query rows per block
constexpr int kConsumers = 256;  // two warpgroups of 64 query rows
constexpr int kThreads = 384;    // plus the producer warpgroup
constexpr int kAtom = 64 * 2;    // bytes of one swizzled row: 64 bf16 columns
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Cfg {
  static constexpr int BK = HD == 256 ? 64 : 128;  // key rows per K/V tile
  static constexpr int STAGES = HD == 64 ? 4 : 2;
  static constexpr int ATOMS = HD / 64;           // 64-column atoms across hd
  static constexpr int Q_BYTES = kBQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;    // one K or one V tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int BAR_BYTES = 8 * (2 * STAGES + 1);
  // 1024 bytes of slack to align the tiles to the swizzle's 1024-byte period
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * STAGE_BYTES + BAR_BYTES;
};

struct Params {
  void* o;
  int S, H, KV;
  int causal;
  long long window;  // <= 0: no window
  float softcap;     // <= 0: no softcap
  float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// One TMA box of a 4-D tensor map into shared memory; completion is counted
// on the mbarrier in bytes.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled tile: start address,
// leading byte offset (between 64-column atoms; unused by the K-major
// operands), stride byte offset (between groups of 8 rows: 1024 bytes).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
       | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
       | static_cast<uint64_t>(1024 >> 4) << 32
       | static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Keep the compiler from moving reads of accumulators above the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x 128, float32) (+)= A (64 x 16, smem) * B (128 x 16, smem)^T, bf16 operands,
// both K-major; scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 64, float32) (+)= A (64 x 16, smem) * B (64 x 16, smem)^T, bf16 operands,
// both K-major; scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 64, float32) += A (64 x 16, registers) * B (16 x 64, smem), bf16 operands,
// B stored N-major (transposed: the rows of B are contiguous in N).
__device__ __forceinline__ void wgmma_m64n64k16_rs_tb(float (&d)[32], const uint32_t (&a)[4],
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int BK>
__device__ __forceinline__ void wgmma_qk(float (&s)[BK / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (BK == 128) wgmma_m64n128k16_ss(s, da, db, scale_d);
  else wgmma_m64n64k16_ss(s, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// S = Q K^T over hd in steps of 16 (32 bytes inside a 128-byte atom row).
template <int HD>
__device__ __forceinline__ void issue_qk(float (&s)[Cfg<HD>::BK / 2], uint32_t q_addr,
                                         uint32_t k_addr) {
  constexpr int BK = Cfg<HD>::BK;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_qk<BK>(s, desc_sw128(q_addr + (kk / 4) * kBQ * kAtom + off, 0),
                 desc_sw128(k_addr + (kk / 4) * BK * kAtom + off, 0), kk > 0);
  }
}

// O += P V over the tile's keys in steps of 16 rows of V (2048 bytes), one
// 64-column atom of V at a time.
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[Cfg<HD>::ATOMS][32],
                                         const uint32_t (&pa)[Cfg<HD>::BK / 16][4],
                                         uint32_t v_addr) {
  constexpr int BK = Cfg<HD>::BK;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int a = 0; a < Cfg<HD>::ATOMS; ++a)
      wgmma_m64n64k16_rs_tb(o[a], pa[kk],
                            desc_sw128(v_addr + a * BK * kAtom + kk * 16 * kAtom, BK * kAtom));
}

// This thread's two query rows (row_lo and row_lo + 8): running max in base
// 2 and its share of the row sums.
struct Rows {
  int lo;
  float m_lo, m_hi, l_lo, l_hi;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Logits of one score tile: softcap (in natural units, then to base 2), and
// the mask on tiles that cross an edge. Masked entries become -inf.
template <int BK, bool CAP, bool EDGE>
__device__ __forceinline__ void logits(float (&s)[BK / 2], const Params& p, int k_start, int row,
                                       int t) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e];
      if (CAP) x = p.softcap * kLog2e * tanhf(x * (p.scale / p.softcap));
      if (EDGE) {
        const int kp = k_start + 8 * j + 2 * t + (e & 1);
        const int r = e < 2 ? row : row + 8;
        bool ok = kp < p.S;
        if (p.causal) ok = ok && kp <= r;
        if (p.window > 0) ok = ok && static_cast<long long>(kp) > static_cast<long long>(r) - p.window;
        if (!ok) x = -INFINITY;
      }
      s[4 * j + e] = x;
    }
  }
}

// Online softmax of one score tile held in accumulator fragments, in base 2:
// p = 2^(s * scale - m) as one FFMA and one ex2 per score (scale = log2(e)
// times the score scale, or 1 once a softcap has mapped s to base 2). P becomes bf16 A
// fragments; the row sums take the float32 p. Returns the factors that
// rescale the output rows.
template <int HD>
__device__ __forceinline__ float2 softmax_tile(float (&s)[Cfg<HD>::BK / 2],
                                               uint32_t (&pa)[Cfg<HD>::BK / 16][4], Rows& r,
                                               const Params& p, int k_start, int q_lo, int t) {
  constexpr int BK = Cfg<HD>::BK;
  const bool edge = k_start + BK > p.S || (p.causal && k_start + BK - 1 > q_lo) ||
                    (p.window > 0 && static_cast<long long>(k_start) <=
                                         static_cast<long long>(q_lo + 63) - p.window);
  const bool cap = p.softcap > 0.f;
  if (cap) {
    if (edge) logits<BK, true, true>(s, p, k_start, r.lo, t);
    else logits<BK, true, false>(s, p, k_start, r.lo, t);
  } else if (edge) {
    logits<BK, false, true>(s, p, k_start, r.lo, t);
  }
  const float scale = cap ? 1.f : p.scale * kLog2e;
  float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    mx_lo = fmaxf(mx_lo, fmaxf(s[4 * j], s[4 * j + 1]));
    mx_hi = fmaxf(mx_hi, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
  }
  const float mn_lo = fmaxf(r.m_lo, mx_lo * scale), mn_hi = fmaxf(r.m_hi, mx_hi * scale);
  // a row with nothing visible yet keeps exponent base 0: its p are 0
  const float mu_lo = mn_lo == -INFINITY ? 0.f : mn_lo;
  const float mu_hi = mn_hi == -INFINITY ? 0.f : mn_hi;
  const float2 alpha = make_float2(ex2(r.m_lo - mu_lo), ex2(r.m_hi - mu_hi));
  r.m_lo = mn_lo;
  r.m_hi = mn_hi;
  float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    const float p0 = ex2(fmaf(s[4 * j], scale, -mu_lo));
    const float p1 = ex2(fmaf(s[4 * j + 1], scale, -mu_lo));
    const float p2 = ex2(fmaf(s[4 * j + 2], scale, -mu_hi));
    const float p3 = ex2(fmaf(s[4 * j + 3], scale, -mu_hi));
    sum_lo += p0 + p1;
    sum_hi += p2 + p3;
    // accumulator columns 8 j .. 8 j + 7 are half of A fragment k step j / 2
    pa[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
    pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
  }
  r.l_lo = r.l_lo * alpha.x + sum_lo;
  r.l_hi = r.l_hi * alpha.y + sum_hi;
  return alpha;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const Params p) {
  using C = Cfg<HD>;
  constexpr int BK = C::BK;
  constexpr int STAGES = C::STAGES;
  constexpr int ATOMS = C::ATOMS;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base;                    // ATOMS x (kBQ rows x 128 bytes)
  const uint32_t sKV = base + C::Q_BYTES;      // STAGES x (K tile, V tile)
  const uint32_t bars = sKV + STAGES * C::STAGE_BYTES;
  // full[s] = bars + 8 s, empty[s] = bars + 8 (STAGES + s), Q's = bars + 16 STAGES

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const int S = p.S;
  const int q_start = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest query tiles first

  // the K/V tiles some query of this block can see
  int kt_begin = 0;
  int kt_end = (S + BK - 1) / BK;
  if (p.causal) kt_end = min(kt_end, min(q_start + kBQ - 1, S - 1) / BK + 1);
  if (p.window > 0) {
    // live when k_start + BK - 1 > q_start - window
    const long long lo = static_cast<long long>(q_start) - p.window - BK + 2;
    if (lo > 0) kt_begin = static_cast<int>((lo + BK - 1) / BK);
  }

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (STAGES + s), kConsumers);
    }
    mbar_init(bars + 16 * STAGES, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer warpgroup: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == kConsumers) {
      const uint32_t qbar = bars + 16 * STAGES;
      mbar_expect_tx(qbar, C::Q_BYTES);
#pragma unroll
      for (int a = 0; a < ATOMS; ++a)
        tma_load_4d(sQ + a * kBQ * kAtom, &tq, qbar, a * 64, h, q_start, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = kt_begin; kt < kt_end; ++kt) {
        const uint32_t full = bars + 8 * stage;
        mbar_wait(bars + 8 * (STAGES + stage), phase ^ 1);  // the consumers freed the stage
        mbar_expect_tx(full, C::STAGE_BYTES);
        const uint32_t kdst = sKV + stage * C::STAGE_BYTES;
#pragma unroll
        for (int a = 0; a < ATOMS; ++a) {
          tma_load_4d(kdst + a * BK * kAtom, &tk, full, a * 64, kvh, kt * BK, b);
          tma_load_4d(kdst + C::KV_BYTES + a * BK * kAtom, &tv, full, a * 64, kvh, kt * BK, b);
        }
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
    }
  } else {
    // consumer warpgroups: 64 query rows each. The score product of tile j
    // and the PV product of tile j - 1 are in flight together, and the
    // softmax of tile j runs while the PV product finishes.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wgi = tid / 128;
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    const int t = lane % 4;
    const int q_lo = q_start + wgi * 64;  // this warpgroup's rows: q_lo .. q_lo + 63
    Rows r{q_lo + warp * 16 + lane / 4, -INFINITY, -INFINITY, 0.f, 0.f};

    float o[ATOMS][32];
#pragma unroll
    for (int a = 0; a < ATOMS; ++a)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[a][i] = 0.f;
    float s[BK / 2];
    uint32_t pa[BK / 16][4], pa_next[BK / 16][4];  // P in bf16 as wgmma A fragments

    const uint32_t q_addr = sQ + wgi * 64 * kAtom;
    mbar_wait(bars + 16 * STAGES, 0);

    if (kt_begin < kt_end) {
      int stage = 0;
      uint32_t phase = 0;
      mbar_wait(bars, 0);
      wgmma_fence();
      issue_qk<HD>(s, q_addr, sKV);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      softmax_tile<HD>(s, pa, r, p, kt_begin * BK, q_lo, t);  // o is 0: no rescale
      int prev = 0;
      if (++stage == STAGES) { stage = 0; phase ^= 1; }
      for (int kt = kt_begin + 1; kt < kt_end; ++kt) {
        const uint32_t k_addr = sKV + stage * C::STAGE_BYTES;
        mbar_wait(bars + 8 * stage, phase);
        wgmma_fence();
        issue_qk<HD>(s, q_addr, k_addr);
        wgmma_commit();
        issue_pv<HD>(o, pa, sKV + prev * C::STAGE_BYTES + C::KV_BYTES);
        wgmma_commit();
        wgmma_wait<1>();  // the score product is done; PV may still run
        fence_regs(s);
        const float2 alpha = softmax_tile<HD>(s, pa_next, r, p, kt * BK, q_lo, t);
        wgmma_wait<0>();
#pragma unroll
        for (int a = 0; a < ATOMS; ++a) fence_regs(o[a]);
        mbar_arrive(bars + 8 * (STAGES + prev));  // this thread is done with tile j - 1
#pragma unroll
        for (int a = 0; a < ATOMS; ++a)
#pragma unroll
          for (int i = 0; i < 32; i += 4) {
            o[a][i] *= alpha.x;
            o[a][i + 1] *= alpha.x;
            o[a][i + 2] *= alpha.y;
            o[a][i + 3] *= alpha.y;
          }
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) pa[kk][e] = pa_next[kk][e];
        prev = stage;
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
      wgmma_fence();
      issue_pv<HD>(o, pa, sKV + prev * C::STAGE_BYTES + C::KV_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int a = 0; a < ATOMS; ++a) fence_regs(o[a]);
      mbar_arrive(bars + 8 * (STAGES + prev));
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      r.l_lo += __shfl_xor_sync(0xffffffffu, r.l_lo, off);
      r.l_hi += __shfl_xor_sync(0xffffffffu, r.l_hi, off);
    }
    const float inv_lo = 1.f / fmaxf(r.l_lo, 1e-30f), inv_hi = 1.f / fmaxf(r.l_hi, 1e-30f);
    const int row_lo = r.lo, row_hi = r.lo + 8;
    __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o);
    const long long q_row = static_cast<long long>(p.H) * HD;
    const long long head = static_cast<long long>(b) * S * q_row + static_cast<long long>(h) * HD;
#pragma unroll
    for (int a = 0; a < ATOMS; ++a)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = a * 64 + 8 * j + 2 * t;
        if (row_lo < S)
          *reinterpret_cast<uint32_t*>(ob + head + row_lo * q_row + col) =
              pack_bf16(o[a][4 * j] * inv_lo, o[a][4 * j + 1] * inv_lo);
        if (row_hi < S)
          *reinterpret_cast<uint32_t*>(ob + head + row_hi * q_row + col) =
              pack_bf16(o[a][4 * j + 2] * inv_hi, o[a][4 * j + 3] * inv_hi);
      }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found through the runtime, so the
// library needs no link against libcuda.
EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// (hd, heads, S, B) bf16, row-major (B, S, heads, hd); box (64, 1, rows, 1),
// 128-byte swizzle; out-of-bounds elements read as zero.
bool make_map(CUtensorMap* map, const void* ptr, int hd, int heads, int S, int B, int rows) {
  EncodeTiledFn encode = encode_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(heads) * hd * 2;
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(hd) * 2, row,
                                 row * static_cast<cuuint64_t>(S)};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const Params& p, int B,
                   cudaStream_t stream) {
  using C = Cfg<HD>;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, HD, p.H, p.S, B, kBQ) || !make_map(&tk, k, HD, p.KV, p.S, B, C::BK) ||
      !make_map(&tv, v, HD, p.KV, p.S, B, C::BK))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_bf16_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * p.H, (p.S + kBQ - 1) / kBQ);
  flash_bf16_kernel<HD><<<grid, kThreads, C::SMEM, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

cudaError_t launch_hd(const void* q, const void* k, const void* v, const Params& p, int B,
                      int head_dim, cudaStream_t stream) {
  switch (head_dim) {
    case 64: return launch<64>(q, k, v, p, B, stream);
    case 128: return launch<128>(q, k, v, p, B, stream);
    case 256: return launch<256>(q, k, v, p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace wg

}  // namespace

// dtype: 0 float32, 1 bfloat16. window <= 0 and softcap <= 0 mean none.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int B, int S, int H, int KV, int head_dim, int dtype,
                                      int causal, long long window, float softcap, float scale,
                                      void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    Params p{q, k, v, out, B, S, H, KV, causal, window, softcap, scale};
    err = launch_hd<float>(p, head_dim, s);
  } else if (dtype == 1) {
    wg::Params p{out, S, H, KV, causal, window, softcap, scale};
    err = wg::launch_hd(q, k, v, p, B, head_dim, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Dynamic shared memory of one block of the kernel for this head_dim and
// dtype (0 float32, 1 bfloat16), or -1; for build reports.
extern "C" int flash_attention_smem_bytes(int head_dim, int dtype) {
  switch (head_dim) {
    case 64: return dtype == 1 ? wg::Cfg<64>::SMEM : static_cast<int>(smem_bytes<64, 64>());
    case 128: return dtype == 1 ? wg::Cfg<128>::SMEM : static_cast<int>(smem_bytes<64, 128>());
    case 256: return dtype == 1 ? wg::Cfg<256>::SMEM : static_cast<int>(smem_bytes<32, 256>());
    default: return -1;
  }
}
