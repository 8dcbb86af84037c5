// Mamba-2 SSD chunked scan (state-space duality, arXiv:2405.21060).
//
// Replaces the Pallas kernel src/repro/kernels/ssd_scan.py (ssd_scan, body
// _kernel). Inputs are float32: x (b, L, H, dh), dt (b, L, H), A and D (H,),
// B and C (b, L, G, ds), where head h reads group h / (H / G) of B and C.
// Per chunk c of Q steps, with a = A * dt and acum its inclusive cumsum
// inside the chunk:
//   y[i]  = sum_{j <= i} (C[i].B[j]) exp(acum[i] - acum[j]) dt[j] x[j]   (intra-chunk)
//         + exp(acum[i]) C[i] . in[c]                                  (incoming state)
//         + D x[i]
//   in[c+1] = exp(acum[Q-1]) in[c] + S_c,
//   S_c     = sum_j exp(acum[Q-1] - acum[j]) dt[j] x[j] B[j]^T          (dh, ds)
// Outputs are y (b, L, H, dh) and the final state (b, H, dh, ds), which the
// TPU kernel kept only in scratch and the model's ssd_forward returns. Steps
// past L count as dt = 0 and x = 0, which leave the state unchanged, so L
// need not be a multiple of the chunk.
//
// Bound: bytes at the model's shapes (x read and y written dominate: 545 MB,
// 0.165 ms at zamba2's prefill (4, 4096, 64, 64), ds 64, chunk 256). The
// 5.17e10 flops there are 0.77 ms on the float32 CUDA cores and 0.31 ms as
// 3xTF32 on the tensor cores.
//
// Design: chunk-parallel in three launches, the plain version's own
// decomposition (models/ssm.py::ssd_scan_ref), where the TPU kernel walked
// the chunks in order.
//   1. ssd_chunk_state. One block of eight warps per (b, h, chunk) computes
//      acum with a warp scan (written to scratch with dt, so that pass 3
//      reads both contiguously), then the chunk's own state S_c = Xw^T B
//      with Xw[j] = exp(acum[Q-1] - acum[j]) dt[j] x[j], in 64-row tiles
//      with the next tile's rows loaded into registers during the products. Extra blocks form the group's scores C_I B_J^T once per
//      (b, group, chunk) and 64 x 64 tile pair J <= I, into scratch: they do
//      not depend on the head, so the H / G heads of a group share them.
//   2. ssd_state_passing, one thread per 4 state elements: walks the chunks
//      and replaces S_c in place with the state entering chunk c, then
//      writes the final state.
//   3. ssd_chunk_scan, one block per (b, h, chunk, 64-row tile I), the tiles
//      of one chunk in consecutive blocks so that their dt x rows come from
//      L2: y_I = exp(acum_I) C_I in[c]^T, plus for each J <= I the scores
//      times exp(acum_i - acum_j) times (dt x)_J, plus D x_I. Below the
//      diagonal tile the decay factors into exp(acum_i - acum_i0) and
//      exp(acum_i0 - acum_j), both at most 1, so those tiles take no exp per
//      element: the column part scales the rows of dt x, the row part the
//      sum. On the diagonal tile exp is evaluated only for j <= i. D x_I
//      takes tile I's x rows from shared memory, where the diagonal pair
//      left them.
// Arithmetic is 3xTF32: each float32 operand is split into a TF32 high part
// and a TF32 residual (both with the 13 low mantissa bits cleared), and
// three products, lo*hi + hi*lo + hi*hi, accumulate in float32. That keeps
// about 21 bits of each product, where single TF32 (10 bits) would miss the
// reference's 3e-5 tolerance over 256-term sums, at a floor 2.5x below the
// float32 CUDA cores'. Pass 3's main product y += scores (dt x)_J runs on
// wgmma m64n{dh}k8: the decayed scores are the register A operand (their
// accumulator fragment is TF32's A fragment once the k positions t and t + 4
// stand for columns 2 t and 2 t + 1), and (dt x)_J^T is stored hi and lo in
// shared memory, K-major in the 128-byte swizzle. Pass 1's products and the
// incoming-state term are mma.sync.m16n8k8, with the B operands split once
// into (hi, lo) pairs in shared memory.
// The wrapper allocates the scratch: the chunk states (b, H, n_chunks, dh,
// ds), acum and dt (b, H, n_chunks, 2, Q) and the scores (b, G, n_chunks,
// pairs, 64, 64), float32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // pass 3: one warpgroup
constexpr int kThreads1 = 256;  // pass 1: eight warps
constexpr int kT = 64;         // rows of a chunk per tile

struct Params {
  const float* x;
  const float* dt;
  const float* A;
  const float* B;
  const float* C;
  const float* D;
  float* y;
  float* state;   // (b, H, dh, ds): the final state
  float* states;  // (b, H, nc, dh, ds) scratch: S_c, then the state entering chunk c
  float* acum;    // (b, H, nc, 2, Q) scratch: acum, then dt (0 past L)
  float* scores;  // (b, G, nc, n_pairs, 64, 64) scratch: C_I B_J^T for J <= I
  int b, L, H, G, chunk, nc, n_pairs;
};

// 3xTF32 operand: high part and residual, each a float32 with the 13 low
// mantissa bits cleared (TF32's 10-bit mantissa).
struct Split {
  uint32_t hi, lo;
};

__device__ __forceinline__ Split split(float v) {
  const uint32_t hi = __float_as_uint(v) & 0xFFFFE000u;
  const uint32_t lo = __float_as_uint(v - __uint_as_float(hi)) & 0xFFFFE000u;
  return {hi, lo};
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d[n] += a * b[n] for N n8 tiles, with a (16 x 8) and each b[n] (8 x 8)
// given as split fragments: a[0..3] are rows (g, g+8, g, g+8) at columns
// (t, t, t+4, t+4); b[n][0..1] are rows (t, t+4) at column g, for
// g = lane / 4 and t = lane % 4. The three products go out term by term
// over the tiles, so that no product waits on the one before it.
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (&d)[N][4], const Split (&a)[4],
                                           const Split (&b)[N][2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[n], a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[n][0].hi, b[n][1].hi);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[n], a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[n][0].lo, b[n][1].lo);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[n], a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[n][0].hi, b[n][1].hi);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Inclusive scan of v[0..n) in place by one warp, 32 steps at a time.
__device__ __forceinline__ void warp_scan(float* v, int n, int lane) {
  float carry = 0.f;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    float a = i < n ? v[i] : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, a, off);
      if (lane >= off) a += u;
    }
    a += carry;
    if (i < n) v[i] = a;
    carry = __shfl_sync(0xffffffffu, a, 31);
  }
}

// Two float32 values as split (hi, lo) pairs, for one 16-byte store.
__device__ __forceinline__ float4 split2(float a, float b) {
  const Split x = split(a), y = split(b);
  return make_float4(__uint_as_float(x.hi), __uint_as_float(x.lo), __uint_as_float(y.hi),
                     __uint_as_float(y.lo));
}

__device__ __forceinline__ Split unpack(float2 v) {
  return {__float_as_uint(v.x), __float_as_uint(v.y)};
}

// The first kT rows of a (rows, W) slice with row stride `ld` (floats) in
// the registers of T threads: each holds kT * W / 4 / T float4, zero at or
// past row n.
template <int W, int T>
struct Rows4 {
  static constexpr int N = kT * W / 4 / T;
  float4 v[N];
};

template <int W, int T>
__device__ __forceinline__ void fetch(Rows4<W, T>& f, const float* src, long long ld, int n, int tid) {
#pragma unroll
  for (int u = 0; u < Rows4<W, T>::N; ++u) {
    const int idx = tid + u * T;
    const int r = idx / (W / 4), d = (idx % (W / 4)) * 4;
    f.v[u] = r < n ? __ldg(reinterpret_cast<const float4*>(src + r * ld + d))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The fetched rows, times scale[r] when given, into shared memory as split
// (hi, lo) pairs with row stride S pairs.
template <int W, int S, int T>
__device__ __forceinline__ void store_split(float2* dst, const Rows4<W, T>& f, const float* scale,
                                            int tid) {
#pragma unroll
  for (int u = 0; u < Rows4<W, T>::N; ++u) {
    const int idx = tid + u * T;
    const int r = idx / (W / 4), d = (idx % (W / 4)) * 4;
    const float w = scale != nullptr ? scale[r] : 1.f;
    const float4 v = f.v[u];
    float4* out = reinterpret_cast<float4*>(dst + r * S + d);
    out[0] = split2(v.x * w, v.y * w);
    out[1] = split2(v.z * w, v.w * w);
  }
}

// The fetched rows, times scale[r] when given, as plain float32 with row
// stride S floats.
template <int W, int S, int T>
__device__ __forceinline__ void store_rows(float* dst, const Rows4<W, T>& f, const float* scale,
                                           int tid) {
#pragma unroll
  for (int u = 0; u < Rows4<W, T>::N; ++u) {
    const int idx = tid + u * T;
    const int r = idx / (W / 4), d = (idx % (W / 4)) * 4;
    const float w = scale != nullptr ? scale[r] : 1.f;
    const float4 v = f.v[u];
    float* out = dst + r * S + d;
    out[0] = v.x * w; out[1] = v.y * w; out[2] = v.z * w; out[3] = v.w * w;
  }
}

// ---------------------------------------------------------------------------
// pass 1: the group's scores C_I B_J^T of each chunk (64 x 64 tiles, J <= I),
// and each (b, h, chunk)'s own state contribution S_c (dh, ds) and acum
// ---------------------------------------------------------------------------

template <int DH, int DS>
struct Pass1 {
  static constexpr int BS = DS + 4;  // pairs per row of split B: rows g, columns t distinct banks
  static constexpr int CS = DS + 4;  // floats per row of C
  static constexpr int XS = DH + 8;  // floats per row of Xw: rows t, columns g distinct banks
  static size_t smem(int chunk) {
    const size_t padded = static_cast<size_t>((chunk + kT - 1) / kT) * kT;
    const size_t rest = static_cast<size_t>(kT) * XS + 2 * padded;
    return sizeof(float2) * kT * BS + sizeof(float) * (rest > kT * CS ? rest : kT * CS);
  }
};

template <int DH, int DS>
__device__ __forceinline__ void chunk_scores(const Params& p, int blk, float2* Bs, float* Cs) {
  using P1 = Pass1<DH, DS>;
  const int Q = p.chunk;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int pair = blk % p.n_pairs;
  const int bgc = blk / p.n_pairs;  // (b * G + grp) * nc + c
  const int c = bgc % p.nc;
  const int bg = bgc / p.nc;
  const int b = bg / p.G, grp = bg % p.G;
  int I = 0;
  while ((I + 1) * (I + 2) / 2 <= pair) ++I;
  const int J = pair - I * (I + 1) / 2;
  const long long c0 = static_cast<long long>(c) * Q;
  const long long bc_row = static_cast<long long>(p.G) * DS;
  const long long base = (static_cast<long long>(b) * p.L + c0) * bc_row + static_cast<long long>(grp) * DS;
  const int rows = static_cast<int>(min(static_cast<long long>(Q), p.L - c0));  // valid rows of the chunk
  {
    Rows4<DS, kThreads1> f;
    fetch(f, p.C + base + I * kT * bc_row, bc_row, rows - I * kT, tid);
    store_rows<DS, P1::CS>(Cs, f, nullptr, tid);
    fetch(f, p.B + base + J * kT * bc_row, bc_row, rows - J * kT, tid);
    store_split<DS, P1::BS>(Bs, f, nullptr, tid);
  }
  __syncthreads();

  const int r0 = (warp % 4) * 16, n0 = (warp / 4) * 32;  // this warp's 16 x 32 of the tile
  float acc[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DS / 8; ++kk) {
    const float* cr = Cs + (r0 + g) * P1::CS + kk * 8 + t;
    const Split a[4] = {split(cr[0]), split(cr[8 * P1::CS]), split(cr[4]), split(cr[8 * P1::CS + 4])};
    Split bf[4][2];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const float2* br = Bs + (n0 + n * 8 + g) * P1::BS + kk * 8 + t;  // B[k = s][n = j] = B_J[j][s]
      bf[n][0] = unpack(br[0]);
      bf[n][1] = unpack(br[4]);
    }
    mma_3xtf32(acc, a, bf);
  }
  float* out = p.scores + (static_cast<long long>(bgc) * p.n_pairs + pair) * kT * kT;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int col = n0 + n * 8 + 2 * t;
    *reinterpret_cast<float2*>(out + (r0 + g) * kT + col) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(out + (r0 + g + 8) * kT + col) = make_float2(acc[n][2], acc[n][3]);
  }
}

template <int DH, int DS>
__device__ __forceinline__ void chunk_state(const Params& p, int bhc, float2* Bs, float* F) {
  using P1 = Pass1<DH, DS>;
  constexpr int WM = DH / 16;                           // warps along dh
  constexpr int WN = 8 / WM;                            // warps along ds
  constexpr int NT = DS / 8 / WN > 0 ? DS / 8 / WN : 1;  // n8 tiles per warp
  const int Q = p.chunk;
  float* Xs = F;                   // kT x XS: Xw rows of the tile
  const int Qp = (Q + kT - 1) / kT * kT;
  float* acs = Xs + kT * P1::XS;   // Q: A dt, then its inclusive cumsum
  float* wts = acs + Qp;           // Qp: dt[j] exp(acum[Q-1] - acum[j]), 0 past Q

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int c = bhc % p.nc;
  const int bh = bhc / p.nc;
  const int b = bh / p.H, h = bh % p.H;
  const int grp = h / (p.H / p.G);
  const long long c0 = static_cast<long long>(c) * Q;
  const float A = p.A[h];
  const float* dtb = p.dt + static_cast<long long>(b) * p.L * p.H + h;

  const long long x_row = static_cast<long long>(p.H) * DH;
  const long long bc_row = static_cast<long long>(p.G) * DS;
  const float* xb = p.x + (static_cast<long long>(b) * p.L + c0) * x_row + static_cast<long long>(h) * DH;
  const float* Bb = p.B + (static_cast<long long>(b) * p.L + c0) * bc_row + static_cast<long long>(grp) * DS;
  const int rows = static_cast<int>(min(static_cast<long long>(Q), p.L - c0));  // valid rows of the chunk
  Rows4<DH, kThreads1> xf;
  Rows4<DS, kThreads1> bf_rows;
  fetch(xf, xb, x_row, rows, tid);  // the first tile is in flight during the scan
  fetch(bf_rows, Bb, bc_row, rows, tid);

  for (int i = tid; i < Qp; i += kThreads1) {
    const float d = i < rows ? dtb[(c0 + i) * p.H] : 0.f;
    wts[i] = d;
    if (i < Q) acs[i] = A * d;
  }
  __syncthreads();
  if (warp == 0) warp_scan(acs, Q, lane);
  __syncthreads();
  const float total = acs[Q - 1];
  float* acum_out = p.acum + static_cast<long long>(bhc) * 2 * Q;  // acum, then dt
  for (int i = tid; i < Q; i += kThreads1) {
    acum_out[i] = acs[i];
    acum_out[Q + i] = wts[i];
    wts[i] *= expf(total - acs[i]);
  }

  const int m0 = (warp % WM) * 16;      // this warp's rows of S_c (dh)
  const int n0 = (warp / WM) * NT * 8;  // and its columns (ds); none when dh x ds is small
  const bool active = n0 < DS;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int k0 = 0; k0 < Q; k0 += kT) {
    __syncthreads();  // wts is complete; the last tile's reads are done
    store_rows<DH, P1::XS>(Xs, xf, wts + k0, tid);
    store_split<DS, P1::BS>(Bs, bf_rows, nullptr, tid);
    __syncthreads();
    if (k0 + kT < Q) {  // the next tile is in flight during this one's products
      fetch(xf, xb + (k0 + kT) * x_row, x_row, rows - k0 - kT, tid);
      fetch(bf_rows, Bb + (k0 + kT) * bc_row, bc_row, rows - k0 - kT, tid);
    }
    const int steps = active ? (min(kT, Q - k0) + 7) / 8 : 0;
    for (int kk = 0; kk < steps; ++kk) {
      const float* xr = Xs + (kk * 8 + t) * P1::XS + m0 + g;  // A[m][k] = Xw[k][m]
      const Split a[4] = {split(xr[0]), split(xr[8]), split(xr[4 * P1::XS]), split(xr[4 * P1::XS + 8])};
      const float2* br = Bs + (kk * 8 + t) * P1::BS + n0 + g;  // B[k][n] = B[j = k][s = n]
      Split bf[NT][2];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        bf[n][0] = unpack(br[n * 8]);
        bf[n][1] = unpack(br[4 * P1::BS + n * 8]);
      }
      mma_3xtf32(acc, a, bf);
    }
  }

  if (!active) return;
  float* out = p.states + static_cast<long long>(bhc) * DH * DS;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n0 + n * 8 + 2 * t;
    *reinterpret_cast<float2*>(out + (m0 + g) * DS + col) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(out + (m0 + g + 8) * DS + col) = make_float2(acc[n][2], acc[n][3]);
  }
}

// Blocks [0, n_score_blocks) form score tiles, the rest one chunk state each.
template <int DH, int DS>
__global__ void __launch_bounds__(kThreads1)
ssd_chunk_state(const Params p, int n_score_blocks) {
  using P1 = Pass1<DH, DS>;
  extern __shared__ float4 smem4[];
  float2* Bs = reinterpret_cast<float2*>(smem4);  // kT x BS split pairs
  float* F = reinterpret_cast<float*>(Bs + kT * P1::BS);
  const int blk = blockIdx.x;
  if (blk < n_score_blocks) chunk_scores<DH, DS>(p, blk, Bs, F);
  else chunk_state<DH, DS>(p, blk - n_score_blocks, Bs, F);
}

// ---------------------------------------------------------------------------
// pass 2: in[c] = exp(acum[c-1][Q-1]) in[c-1] + S_{c-1}, in place; final state
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256)
ssd_state_passing(const Params p, int state_size) {
  // one thread per 4 consecutive state elements; 4 chunks' loads in flight
  const int quads = state_size / 4;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(p.b) * p.H * quads) return;
  const long long bh = idx / quads;
  const int e = static_cast<int>(idx % quads);
  float4* __restrict__ st = reinterpret_cast<float4*>(p.states) + bh * p.nc * quads + e;
  const float* __restrict__ last = p.acum + bh * p.nc * 2 * p.chunk + (p.chunk - 1);
  float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < p.nc; c0 += 4) {
    float4 own[4];
    float decay[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (c0 + u < p.nc) {
        own[u] = st[static_cast<long long>(c0 + u) * quads];
        decay[u] = __ldg(last + static_cast<long long>(c0 + u) * 2 * p.chunk);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (c0 + u < p.nc) {
        st[static_cast<long long>(c0 + u) * quads] = run;
        const float d = expf(decay[u]);
        run = make_float4(d * run.x + own[u].x, d * run.y + own[u].y, d * run.z + own[u].z,
                          d * run.w + own[u].w);
      }
    }
  }
  reinterpret_cast<float4*>(p.state)[idx] = run;
}

// ---------------------------------------------------------------------------
// pass 3: the outputs of one 64-row tile I of one chunk
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle:
// rows of 128 bytes, groups of 8 rows 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>(1024 >> 4) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// D (64 x 64, float32, as [n8 tile][4]) += A (64 x 8, registers) * B (8 x 64,
// shared memory, K-major), TF32.
__device__ __forceinline__ void wgmma_m64n64k8_tf32(float (&d)[8][4], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 32, float32, as [n8 tile][4]) += A (64 x 8, registers) * B (8 x 32,
// shared memory, K-major), TF32.
__device__ __forceinline__ void wgmma_m64n32k8_tf32(float (&d)[4][4], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 8][4], const uint32_t (&a)[4], uint64_t desc) {
  if constexpr (N == 64) wgmma_m64n64k8_tf32(d, a, desc);
  else wgmma_m64n32k8_tf32(d, a, desc);
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(r[i][e]) :: "memory");
}

// A (dt x)_J tile, transposed for wgmma: thread tid holds row j = tid % 64
// and half the DH columns (DH / 8 float4) of the (64, DH) tile.
template <int DH>
struct RowsT {
  float4 v[DH / 8];
};

template <int DH>
__device__ __forceinline__ void fetch_t(RowsT<DH>& f, const float* src, long long ld, int n, int tid) {
  const int j = tid % 64, p0 = (tid / 64) * (DH / 2);
#pragma unroll
  for (int u = 0; u < DH / 8; ++u)
    f.v[u] = j < n ? __ldg(reinterpret_cast<const float4*>(src + j * ld + p0 + 4 * u))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
}

// Row j of the tile times `scale` as column j of the K-major B operand
// (DH rows p, 64 columns j, two 128-byte atoms of 32 columns), split into a
// high tile and a residual tile XT bytes later. Columns are permuted in
// groups of 8 (k position t holds column 2 t, t + 4 holds 2 t + 1) to match
// the score fragments that serve as A; the 16-byte chunks of each row are
// XOR-swizzled by row, as the 128-byte swizzle reads them. A warp stores
// one row p's 32 columns at once, so no two lanes share a bank.
template <int DH>
__device__ __forceinline__ void store_t(uint8_t* hi, const RowsT<DH>& f, float scale, int tid) {
  constexpr int XT = DH * 64 * 4;
  const int j = tid % 64, p0 = (tid / 64) * (DH / 2);
  const int jj = j % 32, q = jj % 8;
  const int kp = (jj & ~7) | ((q & 1) ? 4 + (q >> 1) : (q >> 1));
  const int atom = (j / 32) * DH * 128;
#pragma unroll
  for (int u = 0; u < DH / 8; ++u) {
    const float vals[4] = {f.v[u].x, f.v[u].y, f.v[u].z, f.v[u].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = p0 + 4 * u + e;
      const int off = atom + row * 128 + (((kp >> 2) ^ (row & 7)) << 4) + (kp & 3) * 4;
      const Split sp = split(vals[e] * scale);
      *reinterpret_cast<uint32_t*>(hi + off) = sp.hi;
      *reinterpret_cast<uint32_t*>(hi + XT + off) = sp.lo;
    }
  }
}

// Rows r and r + 8 of a 64 x 64 score tile at the accumulator fragment's
// columns 8 n + 2 t, + 1.
__device__ __forceinline__ void fetch_scores(float2 (&lo)[8], float2 (&hi)[8], const float* tile,
                                             int r) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    lo[n] = __ldg(reinterpret_cast<const float2*>(tile + r * kT + n * 8 + 2 * t));
    hi[n] = __ldg(reinterpret_cast<const float2*>(tile + (r + 8) * kT + n * 8 + 2 * t));
  }
}

template <int DH, int DS>
struct Pass3 {
  static constexpr int CS = DS + 4;         // floats per row of C and of the state: rows g, columns t
  static constexpr int XT = DH * 64 * 4;    // bytes of one (dt x)^T tile
  static constexpr int R_BYTES = 2 * XT > DH * CS * 4 ? 2 * XT : DH * CS * 4;
  static size_t smem(int chunk) {
    const int n_tiles = (chunk + kT - 1) / kT;
    // 1024 bytes of slack to align the tiles to the swizzle's 1024-byte period
    return 1024 + R_BYTES + sizeof(float) * (kT * CS + 2 * n_tiles * kT);
  }
};

template <int DH, int DS>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_scan(const Params p) {
  using P3 = Pass3<DH, DS>;
  constexpr int CS = P3::CS;
  constexpr int NX = DH / 8;  // n8 tiles of y per warp
  extern __shared__ __align__(1024) uint8_t smem_bytes[];
  const int Q = p.chunk;
  const int n_tiles = (Q + kT - 1) / kT;
  uint8_t* base = smem_bytes + ((1024 - (smem_u32(smem_bytes) & 1023)) & 1023);
  float* R = reinterpret_cast<float*>(base);  // the state (DH x CS), then (dt x)_J^T hi and lo
  float* Cs = reinterpret_cast<float*>(base + P3::R_BYTES);  // kT x CS: C rows of tile I
  float* acs = Cs + kT * CS;                  // n_tiles * kT: acum, held past Q
  float* dts = acs + n_tiles * kT;            // n_tiles * kT: dt (times a decay), 0 past Q
  const uint32_t xt = smem_u32(base);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  // consecutive blocks are the tiles of one chunk, heaviest first, so that
  // its dt x rows are read from L2
  const int bhc = blockIdx.x / n_tiles;  // (b * H + h) * nc + c
  const int I = n_tiles - 1 - static_cast<int>(blockIdx.x % n_tiles);
  const int c = bhc % p.nc;
  const int bh = bhc / p.nc;
  const int b = bh / p.H, h = bh % p.H;
  const int grp = h / (p.H / p.G);
  const int i0 = I * kT;
  const long long c0 = static_cast<long long>(c) * Q;
  const int rows = static_cast<int>(min(static_cast<long long>(Q), p.L - c0));

  const long long x_row = static_cast<long long>(p.H) * DH;
  const long long bc_row = static_cast<long long>(p.G) * DS;
  const float* xb = p.x + (static_cast<long long>(b) * p.L + c0) * x_row + static_cast<long long>(h) * DH;
  const float* Cb = p.C + (static_cast<long long>(b) * p.L + c0) * bc_row + static_cast<long long>(grp) * DS;
  const float* acum = p.acum + static_cast<long long>(bhc) * 2 * Q;  // acum, then dt
  const float* scores = p.scores +
      ((static_cast<long long>(b) * p.G + grp) * p.nc + c) * p.n_pairs * kT * kT;

  RowsT<DH> xf;
  fetch_t(xf, xb, x_row, rows, tid);  // tile J = 0, in flight during the state term

  // Below the diagonal tile the decay factors into row and column parts,
  // exp(acum[i] - acum[j]) = exp(acum[i] - acum[i0]) exp(acum[i0] - acum[j]),
  // both at most 1 for j < i0 <= i, so those tiles take no exp per element:
  // the column part scales the rows of dt x, the row part the sum.
  const float a0 = acum[i0];
  for (int i = tid; i < i0 + kT; i += kThreads) {
    const float a = acum[min(i, Q - 1)];
    acs[i] = a;
    const float d = i < rows ? acum[Q + i] : 0.f;
    dts[i] = i < i0 ? d * expf(a0 - a) : d;  // dt, times the column part below the diagonal
  }
  {
    Rows4<DS, kThreads> f;
    fetch(f, Cb + i0 * bc_row, bc_row, rows - i0, tid);
    store_rows<DS, CS>(Cs, f, nullptr, tid);
  }
  const float e0 = expf(a0);  // the incoming state's decay to row i0
  const float* in = p.states + static_cast<long long>(bhc) * DH * DS;
  for (int idx = tid; idx < DH * DS / 4; idx += kThreads) {
    const int r = idx / (DS / 4), d = (idx % (DS / 4)) * 4;
    const float4 v = *reinterpret_cast<const float4*>(in + r * DS + d);
    float* o = R + r * CS + d;
    o[0] = e0 * v.x; o[1] = e0 * v.y; o[2] = e0 * v.z; o[3] = e0 * v.w;
  }
  __syncthreads();

  const int r0 = warp * 16;                 // this warp's rows of the tile
  const int il = i0 + r0 + g, ih = il + 8;  // this thread's rows in the chunk
  float y[NX][4];
#pragma unroll
  for (int n = 0; n < NX; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) y[n][e] = 0.f;

  // incoming state, decayed to row i0: C[i] . (exp(acum[i0]) in[c]), on mma.sync
#pragma unroll
  for (int kk = 0; kk < DS / 8; ++kk) {
    const float* cr = Cs + (r0 + g) * CS + kk * 8 + t;
    const Split a[4] = {split(cr[0]), split(cr[8 * CS]), split(cr[4]), split(cr[8 * CS + 4])};
    Split bf[NX][2];
#pragma unroll
    for (int n = 0; n < NX; ++n) {
      const float* sr = R + (n * 8 + g) * CS + kk * 8 + t;  // B[k = s][n = p] = in[p][s]
      bf[n][0] = split(sr[0]);
      bf[n][1] = split(sr[4]);
    }
    mma_3xtf32(y, a, bf);
  }

  for (int J = 0; J <= I; ++J) {
    const int j0 = J * kT;
    const bool diag = J == I;
    // raw scores of rows il, ih at columns j0 + 8 n + 2 t, + 1 (from L2)
    const float* sc = scores + static_cast<long long>(I * (I + 1) / 2 + J) * kT * kT;
    float2 s_lo[8], s_hi[8];
    fetch_scores(s_lo, s_hi, sc, r0 + g);
    __syncthreads();  // the last reads of R (the state, or the wgmma of tile J - 1) are done
    store_t<DH>(base, xf, dts[j0 + tid % 64], tid);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    __syncthreads();
    if (J < I) fetch_t(xf, xb + (j0 + kT) * x_row, x_row, rows - j0 - kT, tid);  // in flight meanwhile
    if (diag) {
      // everything so far takes the row part of the decay
      const float ul = expf(acs[il] - a0), uh = expf(acs[ih] - a0);
#pragma unroll
      for (int n = 0; n < NX; ++n) {
        y[n][0] *= ul;
        y[n][1] *= ul;
        y[n][2] *= uh;
        y[n][3] *= uh;
      }
    }
    // the score fragment of columns 8 n .. 8 n + 7 is the A fragment of k
    // step n (k positions t and t + 4 stand for columns 2 t and 2 t + 1)
    uint32_t ah[8][4], al[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float v[4] = {s_lo[n].x, s_lo[n].y, s_hi[n].x, s_hi[n].y};
      if (diag) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e < 2 ? il : ih;
          const int j = j0 + n * 8 + 2 * t + (e & 1);
          v[e] = i < Q && j <= i ? v[e] * __expf(acs[i] - acs[j]) : 0.f;
        }
      }
      const Split s0 = split(v[0]), s1 = split(v[2]), s2 = split(v[1]), s3 = split(v[3]);
      ah[n][0] = s0.hi; ah[n][1] = s1.hi; ah[n][2] = s2.hi; ah[n][3] = s3.hi;
      al[n][0] = s0.lo; al[n][1] = s1.lo; al[n][2] = s2.lo; al[n][3] = s3.lo;
    }
    // y += scores (dt x)_J as 3xTF32 wgmma m64n{DH}k8 per k step
    wgmma_fence();
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const uint32_t kaddr = xt + (n / 4) * DH * 128 + (n % 4) * 32;
      wgmma_tf32<DH>(y, al[n], desc_sw128(kaddr));
      wgmma_tf32<DH>(y, ah[n], desc_sw128(kaddr + P3::XT));
      wgmma_tf32<DH>(y, ah[n], desc_sw128(kaddr));
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(y);
  }

  // D x from tile I's x rows, still in registers from the diagonal pair
  constexpr int XR = DH + 8;  // floats per row: float2 at rows g, columns 2 t hit distinct banks
  float* xr = reinterpret_cast<float*>(base);
  __syncthreads();  // every wgmma read of tile I is done
  {
    const int j = tid % 64, c0x = (tid / 64) * (DH / 2);
#pragma unroll
    for (int u = 0; u < DH / 8; ++u)
      *reinterpret_cast<float4*>(xr + j * XR + c0x + 4 * u) = xf.v[u];
  }
  __syncthreads();
  const float D = p.D[h];
  float* yb = p.y + (static_cast<long long>(b) * p.L + c0) * x_row + static_cast<long long>(h) * DH;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = half ? ih : il;
    if (i >= rows) continue;
#pragma unroll
    for (int n = 0; n < NX; ++n) {
      const int col = n * 8 + 2 * t;
      const float2 xv = *reinterpret_cast<const float2*>(xr + (i - i0) * XR + col);
      *reinterpret_cast<float2*>(yb + i * x_row + col) =
          make_float2(y[n][2 * half] + D * xv.x, y[n][2 * half + 1] + D * xv.y);
    }
  }
}

template <int DH, int DS>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int n_tiles = (p.chunk + kT - 1) / kT;
  const long long bhc = static_cast<long long>(p.b) * p.H * p.nc;
  const long long n_score = static_cast<long long>(p.b) * p.G * p.nc * p.n_pairs;

  const size_t smem1 = Pass1<DH, DS>::smem(p.chunk);
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_state<DH, DS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem1));
  if (err != cudaSuccess) return err;
  ssd_chunk_state<DH, DS><<<static_cast<unsigned>(n_score + bhc), kThreads1, smem1, stream>>>(
      p, static_cast<int>(n_score));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const long long n_quads = static_cast<long long>(p.b) * p.H * DH * DS / 4;
  ssd_state_passing<<<static_cast<unsigned>((n_quads + 255) / 256), 256, 0, stream>>>(p, DH * DS);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem3 = Pass3<DH, DS>::smem(p.chunk);
  err = cudaFuncSetAttribute(ssd_chunk_scan<DH, DS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem3));
  if (err != cudaSuccess) return err;
  ssd_chunk_scan<DH, DS><<<static_cast<unsigned>(bhc * n_tiles), kThreads, smem3, stream>>>(p);
  return cudaGetLastError();
}

template <int DH>
int smem_ds(int ds, int chunk, int pass) {
  switch (ds) {
    case 16: return static_cast<int>(pass == 1 ? Pass1<DH, 16>::smem(chunk) : Pass3<DH, 16>::smem(chunk));
    case 32: return static_cast<int>(pass == 1 ? Pass1<DH, 32>::smem(chunk) : Pass3<DH, 32>::smem(chunk));
    case 64: return static_cast<int>(pass == 1 ? Pass1<DH, 64>::smem(chunk) : Pass3<DH, 64>::smem(chunk));
    case 128: return static_cast<int>(pass == 1 ? Pass1<DH, 128>::smem(chunk) : Pass3<DH, 128>::smem(chunk));
    default: return -1;
  }
}

template <int DH>
cudaError_t launch_ds(const Params& p, int ds, cudaStream_t stream) {
  switch (ds) {
    case 16: return launch<DH, 16>(p, stream);
    case 32: return launch<DH, 32>(p, stream);
    case 64: return launch<DH, 64>(p, stream);
    case 128: return launch<DH, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Scratch, float32, n_chunks = ceil(L / chunk) and n_tiles = ceil(chunk / 64):
// states (b, H, n_chunks, dh, ds), acum (b, H, n_chunks, 2, chunk) and scores
// (b, G, n_chunks, n_tiles (n_tiles + 1) / 2, 64, 64).
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A, const void* B,
                               const void* C, const void* D, void* y, void* state, void* states,
                               void* acum, void* scores, int b, int L, int H, int G, int dh,
                               int ds, int chunk, void* stream) {
  if (b <= 0 || L <= 0 || H <= 0 || G <= 0 || H % G != 0 || chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = (L + chunk - 1) / chunk;
  const int n_tiles = (chunk + kT - 1) / kT;
  Params p{static_cast<const float*>(x), static_cast<const float*>(dt),
           static_cast<const float*>(A), static_cast<const float*>(B),
           static_cast<const float*>(C), static_cast<const float*>(D),
           static_cast<float*>(y), static_cast<float*>(state), static_cast<float*>(states),
           static_cast<float*>(acum), static_cast<float*>(scores), b, L, H, G, chunk, nc,
           n_tiles * (n_tiles + 1) / 2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dh) {
    case 32: err = launch_ds<32>(p, ds, s); break;
    case 64: err = launch_ds<64>(p, ds, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Dynamic shared memory of one block of pass 1 (ssd_chunk_state) or pass 3
// (ssd_chunk_scan) at these widths and chunk, or -1; for build reports.
extern "C" int ssd_scan_smem_bytes(int dh, int ds, int chunk, int pass) {
  if (chunk <= 0 || (pass != 1 && pass != 3)) return -1;
  switch (dh) {
    case 32: return smem_ds<32>(ds, chunk, pass);
    case 64: return smem_ds<64>(ds, chunk, pass);
    default: return -1;
  }
}
