// Flash attention: causal or bidirectional GQA attention with an online
// softmax, an optional sliding window and an optional logit softcap.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py
// (flash_attention, body _kernel). q is (B, S, H, hd), k and v are
// (B, S, KV, hd), in bf16 or float32; arithmetic is float32 inside and the
// output has q's dtype. Query head h reads K/V head h / (H / KV), so grouped
// heads never broadcast K/V in memory. Scores are s = scale * q.k, then
// softcap * tanh(s / softcap) when a softcap is given; key t is visible to
// query r when t < S, t <= r (causal) and t > r - window (window).
//
// Bound: operations. Attention does 4 * B * H * S * S * hd flops (half of it
// when causal) on 2 * B * S * (H + 2 KV) * hd elements, far above the card's
// balance of about 295 flops per byte. Design, simple first: a block owns one
// (batch, head) and one tile of 64 query rows, and walks the K/V tiles in a
// loop, which takes the place of the TPU's sequential kv grid axis. The
// running max, sum and output rows stay in registers; the Q, K, V and
// probability tiles stay in shared memory (float32, rows padded so that the
// column reads hit distinct banks). Tiles that the causal or window mask
// hides completely are never visited. The products run on the CUDA cores in
// float32, the TPU kernel's arithmetic; moving them onto the tensor cores
// (mma / wgmma, TMA loads) is later work. Each thread holds 4 query rows;
// 16 threads share a row and combine its max and sum with shuffles. The
// latest query tiles, which see the most keys, are scheduled first.
//
// Tiles: 64 query rows; 64 key rows for head_dim 64 and 128, 32 for 256
// (the float32 Q, K and V tiles of hd 256 at 64 rows would need 197 KB).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

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

}  // namespace

// dtype: 0 float32, 1 bfloat16. window <= 0 and softcap <= 0 mean none.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int B, int S, int H, int KV, int head_dim, int dtype,
                                      int causal, long long window, float softcap, float scale,
                                      void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, out, B, S, H, KV, causal, window, softcap, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? launch_hd<float>(p, head_dim, s)
                  : dtype == 1 ? launch_hd<__nv_bfloat16>(p, head_dim, s)
                               : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
