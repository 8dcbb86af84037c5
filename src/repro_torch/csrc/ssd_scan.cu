// Mamba-2 SSD chunked scan (state-space duality, arXiv:2405.21060).
//
// Replaces the Pallas kernel src/repro/kernels/ssd_scan.py (ssd_scan, body
// _kernel). Inputs are float32: x (b, L, H, dh), dt (b, L, H), A and D (H,),
// B and C (b, L, G, ds), where head h reads group h / (H / G) of B and C.
// Per chunk of Q steps, with a = A * dt and acum its inclusive cumsum:
//   y[i]    = sum_{j <= i} (C[i].B[j]) exp(acum[i] - acum[j]) dt[j] x[j]   (intra-chunk)
//           + exp(acum[i]) C[i] . state                                  (incoming state)
//           + D x[i]
//   state' = exp(acum[Q-1]) state + sum_j exp(acum[Q-1] - acum[j]) dt[j] x[j] B[j]^T
// with state (dh, ds) carried from chunk to chunk. Outputs are y (b, L, H, dh)
// and the final state (b, H, dh, ds), which the TPU kernel kept only in
// scratch (as (ds, dh)) and the model's ssd_forward returns. Steps past L
// count as dt = 0 and x = 0, which leave the state unchanged, so L need not
// be a multiple of the chunk.
//
// Bound: bytes at the model's shapes (x read and y written dominate; per
// (b, h) the scan does about Q (dh + ds) flops per element, near the card's
// balance). Design, simple first: blocks run in no order, so one block owns
// one (b, h) and walks its chunks in a loop, carrying the state in shared
// memory; the loop takes the place of the TPU's sequential chunk grid axis.
// A chunk's rows are cut into tiles of 64, so shared memory holds one 64-row
// tile of C, of B and of dt * x, one 64 x 64 tile of the decay-weighted scores,
// and the state: 134 KB at dh 64, ds 128, where the TPU kernel staged whole
// (chunk, chunk) and (chunk, ds) blocks. exp(acum[i] - acum[j]) is computed
// only for j <= i (above the diagonal the difference is positive and would
// overflow), and score tiles above the diagonal are never formed. The
// products run on the CUDA cores in float32; more blocks per (b, h) and the
// tensor cores are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;  // rows of a chunk per tile

struct Params {
  const float* x;
  const float* dt;
  const float* A;
  const float* B;
  const float* C;
  const float* D;
  float* y;
  float* state;
  int b, L, H, G, chunk;
};

template <int DH, int DS>
constexpr size_t smem_floats() {
  return static_cast<size_t>(DH) * (DS + 1) + 2 * kT * (DS + 1) + kT * DH + kT * (kT + 1);
}

template <int DH, int DS>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const Params p) {
  constexpr int BS = DS + 1;  // row stride of the state, B and C tiles
  constexpr int GS = kT + 1;  // row stride of the score tile
  constexpr int YJ = DH / 16; // y columns per thread
  constexpr int SS = DS / 16; // state columns per thread
  constexpr int SP = DH / 16; // state rows per thread
  extern __shared__ float smem[];
  float* st = smem;               // DH x BS: the carried state [p][s]
  float* Cs = st + DH * BS;       // kT x BS: C rows of tile I
  float* Bs = Cs + kT * BS;       // kT x BS: B rows of tile J
  float* Xs = Bs + kT * BS;       // kT x DH: dt * x rows of tile J
  float* Gs = Xs + kT * DH;       // kT x GS: scores of tiles (I, J)
  float* acum = Gs + kT * GS;     // chunk: inclusive cumsum of A * dt
  float* dts = acum + p.chunk;    // chunk: dt

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int g = h / (p.H / p.G);
  const int chunk = p.chunk;
  const int L = p.L;
  const float A = p.A[h];
  const float D = p.D[h];

  const long long x_row = static_cast<long long>(p.H) * DH;  // elements between steps
  const long long bc_row = static_cast<long long>(p.G) * DS;
  const float* xb = p.x + static_cast<long long>(b) * L * x_row + static_cast<long long>(h) * DH;
  float* yb = p.y + static_cast<long long>(b) * L * x_row + static_cast<long long>(h) * DH;
  const float* dtb = p.dt + static_cast<long long>(b) * L * p.H + h;
  const float* Bb = p.B + static_cast<long long>(b) * L * bc_row + static_cast<long long>(g) * DS;
  const float* Cb = p.C + static_cast<long long>(b) * L * bc_row + static_cast<long long>(g) * DS;

  for (int idx = tid; idx < DH * BS; idx += kThreads) st[idx] = 0.f;

  const int n_chunks = (L + chunk - 1) / chunk;
  const int n_tiles = (chunk + kT - 1) / kT;
  for (int c = 0; c < n_chunks; ++c) {
    const int c0 = c * chunk;
    __syncthreads();  // the last chunk's state update and tile reads are done
    for (int i = tid; i < chunk; i += kThreads) {
      const int t = c0 + i;
      dts[i] = t < L ? dtb[static_cast<long long>(t) * p.H] : 0.f;
    }
    __syncthreads();
    if (tid < 32) {  // one warp: inclusive scan of A * dt, 32 steps at a time
      float carry = 0.f;
      for (int base = 0; base < chunk; base += 32) {
        const int i = base + tid;
        float a = i < chunk ? A * dts[i] : 0.f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float n = __shfl_up_sync(0xffffffffu, a, off);
          if (tid >= off) a += n;
        }
        a += carry;
        if (i < chunk) acum[i] = a;
        carry = __shfl_sync(0xffffffffu, a, 31);
      }
    }
    __syncthreads();
    const float total = acum[chunk - 1];

    float upd[SP][SS];
#pragma unroll
    for (int i = 0; i < SP; ++i)
#pragma unroll
      for (int j = 0; j < SS; ++j) upd[i][j] = 0.f;

    for (int I = 0; I < n_tiles; ++I) {
      const int i0 = I * kT;
      for (int idx = tid; idx < kT * DS; idx += kThreads) {
        const int r = idx / DS, s = idx % DS;
        const int i = i0 + r;
        const int t = c0 + i;
        Cs[r * BS + s] = (i < chunk && t < L) ? Cb[t * bc_row + s] : 0.f;
      }
      __syncthreads();

      // incoming state: exp(acum[i]) * C[i] . state[p]
      float yacc[4][YJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < YJ; ++j) yacc[i][j] = 0.f;
#pragma unroll 4
      for (int s = 0; s < DS; ++s) {
        float cv[4], sv[YJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty * 4 + i) * BS + s];
#pragma unroll
        for (int j = 0; j < YJ; ++j) sv[j] = st[(tx + 16 * j) * BS + s];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < YJ; ++j) yacc[i][j] = fmaf(cv[i], sv[j], yacc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ii = i0 + ty * 4 + i;
        const float e = ii < chunk ? expf(acum[ii]) : 0.f;
#pragma unroll
        for (int j = 0; j < YJ; ++j) yacc[i][j] *= e;
      }

      for (int J = 0; J <= I; ++J) {
        const int j0 = J * kT;
        __syncthreads();  // the last (I, J) reads of Bs, Xs and Gs are done
        for (int idx = tid; idx < kT * DS; idx += kThreads) {
          const int r = idx / DS, s = idx % DS;
          const int j = j0 + r;
          const int t = c0 + j;
          Bs[r * BS + s] = (j < chunk && t < L) ? Bb[t * bc_row + s] : 0.f;
        }
        for (int idx = tid; idx < kT * DH; idx += kThreads) {
          const int r = idx / DH, d = idx % DH;
          const int j = j0 + r;
          const int t = c0 + j;
          Xs[idx] = (j < chunk && t < L) ? xb[t * x_row + d] * dts[j] : 0.f;
        }
        __syncthreads();

        // scores (C[i].B[j]) exp(acum[i] - acum[j]) for j <= i, else 0
        float sc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
        for (int s = 0; s < DS; ++s) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty * 4 + i) * BS + s];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = Bs[(tx + 16 * j) * BS + s];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(cv[i], bv[j], sc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ii = i0 + ty * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int jj = j0 + tx + 16 * j;
            const bool keep = jj <= ii && ii < chunk;
            Gs[(ty * 4 + i) * GS + tx + 16 * j] =
                keep ? sc[i][j] * expf(acum[ii] - acum[jj]) : 0.f;
          }
        }
        __syncthreads();

#pragma unroll 4
        for (int r = 0; r < kT; ++r) {
          float xv[YJ];
#pragma unroll
          for (int j = 0; j < YJ; ++j) xv[j] = Xs[r * DH + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float gv = Gs[(ty * 4 + i) * GS + r];
#pragma unroll
            for (int j = 0; j < YJ; ++j) yacc[i][j] = fmaf(gv, xv[j], yacc[i][j]);
          }
        }

        if (J == I) {  // each tile's B and dt * x feed the state update once
          for (int r = 0; r < kT; ++r) {
            const int j = j0 + r;
            if (j >= chunk) break;
            const float w = expf(total - acum[j]);
            float bv[SS];
#pragma unroll
            for (int s = 0; s < SS; ++s) bv[s] = Bs[r * BS + tx + 16 * s];
#pragma unroll
            for (int q = 0; q < SP; ++q) {
              const float xw = Xs[r * DH + ty + 16 * q] * w;
#pragma unroll
              for (int s = 0; s < SS; ++s) upd[q][s] = fmaf(bv[s], xw, upd[q][s]);
            }
          }
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ii = i0 + ty * 4 + i;
        const int t = c0 + ii;
        if (ii >= chunk || t >= L) continue;
#pragma unroll
        for (int j = 0; j < YJ; ++j) {
          const int d = tx + 16 * j;
          yb[t * x_row + d] = yacc[i][j] + D * xb[t * x_row + d];
        }
      }
      __syncthreads();  // Cs is reloaded by the next tile
    }

    const float decay = expf(total);
#pragma unroll
    for (int q = 0; q < SP; ++q)
#pragma unroll
      for (int s = 0; s < SS; ++s) {
        float* cell = &st[(ty + 16 * q) * BS + tx + 16 * s];
        *cell = decay * *cell + upd[q][s];
      }
  }
  __syncthreads();
  float* out = p.state + static_cast<long long>(bh) * DH * DS;
  for (int idx = tid; idx < DH * DS; idx += kThreads) {
    const int q = idx / DS, s = idx % DS;
    out[idx] = st[q * BS + s];
  }
}

template <int DH, int DS>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (smem_floats<DH, DS>() + 2 * static_cast<size_t>(p.chunk));
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<DH, DS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<DH, DS><<<p.b * p.H, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
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

extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A, const void* B,
                               const void* C, const void* D, void* y, void* state,
                               int b, int L, int H, int G, int dh, int ds, int chunk,
                               void* stream) {
  if (b <= 0 || L <= 0 || H <= 0 || G <= 0 || H % G != 0 || chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<const float*>(x), static_cast<const float*>(dt),
           static_cast<const float*>(A), static_cast<const float*>(B),
           static_cast<const float*>(C), static_cast<const float*>(D),
           static_cast<float*>(y), static_cast<float*>(state), b, L, H, G, chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dh) {
    case 32: err = launch_ds<32>(p, ds, s); break;
    case 64: err = launch_ds<64>(p, ds, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
