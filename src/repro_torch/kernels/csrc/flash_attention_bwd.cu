// Flash attention backward for Hopper (sm_90a): dq, dk and dv of blockwise
// softmax attention with grouped kv heads (GQA / MQA), a causal mask, a
// sliding window and an absolute q offset, from (q, k, v, out, lse, dout).
//
// Replaces the backward of the TPU path: `_flash_bwd`
// (src/repro/kernels/flash_xla.py:76), the custom VJP the reference wraps
// around its attention for training lengths; the TPU kernel itself
// (`flash_attention_pallas`, src/repro/kernels/flash_attention.py:99) has no
// backward of its own.  The math is `_flash_bwd`'s:
//
//   delta_i = sum_c dO_ic O_ic
//   s_ij = (scale q_i) . k_j,  p_ij = exp(s_ij - lse_i)  (0 where masked)
//   dv_j += p_ij dO_i,  dp_ij = dO_i . v_j,  ds_ij = p_ij (dp_ij - delta_i)
//   dq_i = scale sum_j ds_ij k_j,  dk_j += ds_ij (scale q_i)
//
// with the kv head's dk and dv summed over its group of q heads.  A masked
// entry has p exactly 0 (a bit mask decides, not the score), so a row that
// sees no key gets zero gradient and adds nothing to dk or dv, as the forward
// gives it zeros.
//
// What bounds it on this card: operations.  At recurrentgemma-2b's training
// shape (1 x 4096, 10 q heads over 1 kv head, d 256, window 2048) the visible
// (q, k) pairs need about 1.6e11 FLOP against ~60 MB of traffic, far above
// the balance point: ~0.16 ms at the bf16 tensor-core peak.  Every path is
// deterministic: no floating-point atomics, every sum in a fixed order.
//
// Four kernels a call, in this order, for either input type:
//
//   1. `flash_bwd_delta_kernel`: a warp per (batch, position, head) row, delta in fp32.
//   2. dk / dv: a block per (kv tile, q head, batch) walks the q tiles that can
//      see its kv rows (causal bound and window) and accumulates that head's
//      share of dk and dv in registers, written to an fp32 scratch (B, Skv, H,
//      D): a block per q head, not per kv head, so MQA still has H times the
//      blocks (640 at the training shape for 132 SMs).
//   3. `flash_bwd_reduce_kernel`: dk and dv of each kv head are the sum of its
//      group's shares, in head order (a fixed order: the result does not depend
//      on scheduling), rounded once to the input type.
//   4. dq: a block of q rows walks the visible kv tiles and accumulates dq in
//      registers, rounded once to the input type.
//
// Passes 2 and 4 both recompute s and p from the saved lse.
//
// * bfloat16 -> `flash_bwd_dkdv_mma_kernel` and `flash_bwd_dq_mma_kernel`, on
//   the tensor cores: warp-level mma.sync m16n8k16 bf16 -> fp32 fed by
//   ldmatrix (.trans where the product runs along the rows of a tile), tiles
//   staged by 16-byte cp.async, double-buffered (the tile after next loads
//   while this one computes), exponentials in ex2 with scale * log2 e folded in.
//   - dk / dv pass: 8 warps, 64 kv rows (K and V resident), q tiles of 64
//     rows.  S^T = K Q^T and dP^T = V dO^T in fp32 registers, a warp per 16 kv
//     rows x 32 q columns; P^T = exp(scale s - lse) (exactly 0 where the bit
//     mask says masked) and dS^T = P^T (dP^T - delta) are rounded to bf16 once
//     and staged in shared memory, because the accumulation splits the other
//     way: dV += P^T dO and dK += dS^T Q over all 8 warps, a warp per 32 kv
//     rows x 64 columns at d 256 (64 x 256 x 2 fp32 over 256 threads = 128
//     accumulator registers a thread; a warp that held 16 rows x 256 columns
//     of both would need 256).  Shared memory at d 256: K, V, two stages of
//     (Q, dO), P^T, dS^T and two stages of (lse, delta): 222,208 B, one block
//     per SM.  Blocks with the most q tiles launch first.
//   - dq pass: laid out as the forward is: a block per 128 (position, head)
//     rows of one kv group, position-major, so every head of the group reads
//     each kv tile from one shared-memory copy; a warp per 16 rows.  Per kv
//     tile of 32 keys: dP = dO V^T and S = Q K^T (16 x 32 a warp), dS = P (dP -
//     delta) rounded to bf16 in the A-fragment registers (the layout of S),
//     dQ += dS K in fp32 registers (16 x 256: 128 a thread at d 256).  32-key
//     tiles keep S, dP and the fragments beside dQ under 255 registers, and
//     leave room for two stages of (K, V): (2 x 128 + 2 x 2 x 32) x 264 x 2 B =
//     202,752 B at d 256.  Blocks start in reverse order (most kv tiles first).
//   - D not a multiple of 16 is padded with zeros in shared memory (the
//     products run over pad16(d) columns); rows whose global address is not
//     16-byte aligned (d not a multiple of 8, or a base pointer) are loaded by
//     a slower path inside the same kernels, element by element.  Only tiles
//     that are not wholly visible take the per-element mask.
//   - Rounding: the products of bf16 inputs are exact in fp32; P and dS are
//     rounded to bf16 once before the products that take them, dk and dv
//     are summed in fp32 and rounded once in pass 3, dq once at its store.
//
// * float32 -> `flash_bwd_dkdv_kernel` and `flash_bwd_dq_kernel`, on the CUDA
//   cores: fp32 FMAs from fp32 tiles in shared memory, because the 1e-5 check
//   against the plain version needs fp32 products.  Tiles are 32 x 32 with 256
//   threads: a thread computes 4 rows x 1 column of the score tile and a 4-row
//   x d/32-column slice of the d-wide products.  Shared memory rows are padded
//   to d + 1 floats, so the 32 rows a warp reads at one column fall in 32
//   different banks: 4 x 32 x 257 x 4 B + the p and ds tiles = 140 KB at d 256.
//
// The wrapper hands dense (B, S, H, D) tensors.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "sm90_mma.cuh"

namespace {

constexpr int BT = 32;        // rows of a q tile and of a kv tile
constexpr int THREADS = 256;  // 8 row groups (ty) x 32 columns (tx)
constexpr int RM = 4;         // tile rows per thread
constexpr int LDT = BT + 1;   // row stride of the p and ds tiles

__host__ __device__ __forceinline__ long long lmin(long long a, long long b) {
  return a < b ? a : b;
}
__host__ __device__ __forceinline__ long long lmax(long long a, long long b) {
  return a > b ? a : b;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;    // (B, Sq, H)
  float* delta;        // (B, Sq, H) scratch
  float* dk_part;      // (B, Skv, H, D) fp32 scratch: each q head's share
  float* dv_part;
  void* dq;
  void* dk;
  void* dv;
  int b, sq, skv, h, kvh, d;
  int causal, window, q_offset;  // window <= 0: no window
  float scale;
};

__device__ __forceinline__ bool visible(const Params& p, int i, int j) {
  if (i >= p.sq || j >= p.skv) return false;
  const long long qp = (long long)p.q_offset + i;
  if (p.causal && j > qp) return false;
  if (p.window > 0 && j <= qp - p.window) return false;
  return true;
}

// rows [row0, row0 + BT) of one head's (seq, d) slice, widened to fp32 and
// multiplied by `mul`, zeros past the sequence end
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* base,
                                          long long row_stride, int row0, int n_rows,
                                          int d, float mul) {
  for (int i = threadIdx.x; i < BT * d; i += THREADS) {
    const int r = i / d, c = i - r * d;
    const int s = row0 + r;
    dst[r * ld + c] = s < n_rows ? to_f(base[(long long)s * row_stride + c]) * mul : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) flash_bwd_delta_kernel(Params p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (THREADS / 32) + warp;
  if (row >= (long long)p.b * p.sq * p.h) return;
  const T* o = static_cast<const T*>(p.o) + row * p.d;
  const T* g = static_cast<const T*>(p.dout) + row * p.d;
  float acc = 0.f;
  for (int c = lane; c < p.d; c += 32) acc = fmaf(to_f(g[c]), to_f(o[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[row] = acc;
}

// s, dp -> p and ds of the (BT x BT) tile at (i0, j0) for this thread's 4 rows
// and column tx; q rows in qs (scaled), dout rows in gs, k and v rows in ks, vs
__device__ __forceinline__ void score_tile(const Params& p, const float* qs, const float* gs,
                                           const float* ks, const float* vs, int ld,
                                           const float* lse_s, const float* del_s,
                                           float* ps, float* dss, int i0, int j0) {
  const int ty = threadIdx.x >> 5, tx = threadIdx.x & 31;
  float s[RM], dp[RM];
#pragma unroll
  for (int m = 0; m < RM; ++m) s[m] = dp[m] = 0.f;
  for (int c = 0; c < p.d; ++c) {
    const float kc = ks[tx * ld + c], vc = vs[tx * ld + c];
#pragma unroll
    for (int m = 0; m < RM; ++m) {
      const int r = RM * ty + m;
      s[m] = fmaf(qs[r * ld + c], kc, s[m]);
      dp[m] = fmaf(gs[r * ld + c], vc, dp[m]);
    }
  }
#pragma unroll
  for (int m = 0; m < RM; ++m) {
    const int r = RM * ty + m;
    const float pv = visible(p, i0 + r, j0 + tx) ? expf(s[m] - lse_s[r]) : 0.f;
    ps[r * LDT + tx] = pv;
    dss[r * LDT + tx] = pv * (dp[m] - del_s[r]);
  }
}

__device__ __forceinline__ void load_stats(const Params& p, float* lse_s, float* del_s,
                                           int bb, int hh, int i0) {
  if (threadIdx.x < BT) {
    const int i = i0 + threadIdx.x;
    const long long at = ((long long)bb * p.sq + i) * p.h + hh;
    lse_s[threadIdx.x] = i < p.sq ? p.lse[at] : 0.f;
    del_s[threadIdx.x] = i < p.sq ? p.delta[at] : 0.f;
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkdv_kernel(Params p) {
  constexpr int CJ = DMAX / 32;  // accumulator columns per thread: tx + 32 jj
  extern __shared__ float smem[];
  const int d = p.d, ld = d + 1;
  float* ks = smem;
  float* vs = ks + BT * ld;
  float* qs = vs + BT * ld;
  float* gs = qs + BT * ld;
  float* ps = gs + BT * ld;
  float* dss = ps + BT * LDT;
  float* lse_s = dss + BT * LDT;
  float* del_s = lse_s + BT;

  const int ty = threadIdx.x >> 5, tx = threadIdx.x & 31;
  const int j0 = blockIdx.x * BT, hh = blockIdx.y, bb = blockIdx.z;
  const int kh = hh / (p.h / p.kvh);
  const long long qrow = (long long)p.h * d, krow = (long long)p.kvh * d;
  const T* qg = static_cast<const T*>(p.q) + ((long long)bb * p.sq * p.h + hh) * d;
  const T* gg = static_cast<const T*>(p.dout) + ((long long)bb * p.sq * p.h + hh) * d;
  const T* kg = static_cast<const T*>(p.k) + ((long long)bb * p.skv * p.kvh + kh) * d;
  const T* vg = static_cast<const T*>(p.v) + ((long long)bb * p.skv * p.kvh + kh) * d;

  float dk[RM][CJ], dv[RM][CJ];
#pragma unroll
  for (int m = 0; m < RM; ++m)
#pragma unroll
    for (int jj = 0; jj < CJ; ++jj) dk[m][jj] = dv[m][jj] = 0.f;

  load_rows(ks, ld, kg, krow, j0, p.skv, d, 1.f);
  load_rows(vs, ld, vg, krow, j0, p.skv, d, 1.f);

  // q rows that can see a key of this tile
  const long long j_max = lmin(p.skv, j0 + BT) - 1;
  long long i_lo = 0, i_hi = p.sq - 1;
  if (p.causal) i_lo = lmax(i_lo, (long long)j0 - p.q_offset);
  if (p.window > 0) i_hi = lmin(i_hi, j_max + p.window - 1 - p.q_offset);
  for (long long i0l = (i_lo / BT) * BT; i0l <= i_hi; i0l += BT) {
    const int i0 = (int)i0l;
    __syncthreads();  // the previous tile's readers are done
    load_rows(qs, ld, qg, qrow, i0, p.sq, d, p.scale);
    load_rows(gs, ld, gg, qrow, i0, p.sq, d, 1.f);
    load_stats(p, lse_s, del_s, bb, hh, i0);
    __syncthreads();
    score_tile(p, qs, gs, ks, vs, ld, lse_s, del_s, ps, dss, i0, j0);
    __syncthreads();
    for (int r = 0; r < BT; ++r) {
      float pr[RM], dsr[RM];
#pragma unroll
      for (int m = 0; m < RM; ++m) {
        pr[m] = ps[r * LDT + RM * ty + m];
        dsr[m] = dss[r * LDT + RM * ty + m];
      }
#pragma unroll
      for (int jj = 0; jj < CJ; ++jj) {
        const int c = tx + 32 * jj;
        if (c < d) {
          const float gv = gs[r * ld + c], qv = qs[r * ld + c];
#pragma unroll
          for (int m = 0; m < RM; ++m) {
            dv[m][jj] = fmaf(pr[m], gv, dv[m][jj]);
            dk[m][jj] = fmaf(dsr[m], qv, dk[m][jj]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < RM; ++m) {
    const int j = j0 + RM * ty + m;
    if (j >= p.skv) continue;
    const long long at = (((long long)bb * p.skv + j) * p.h + hh) * d;
#pragma unroll
    for (int jj = 0; jj < CJ; ++jj) {
      const int c = tx + 32 * jj;
      if (c < d) {
        p.dk_part[at + c] = dk[m][jj];
        p.dv_part[at + c] = dv[m][jj];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) flash_bwd_reduce_kernel(Params p) {
  const int g = p.h / p.kvh;
  const long long n = (long long)p.b * p.skv * p.kvh * p.d;
  for (long long e = (long long)blockIdx.x * THREADS + threadIdx.x; e < n;
       e += (long long)gridDim.x * THREADS) {
    const long long c = e % p.d, row = e / p.d;  // row = (b * skv + s) * kvh + kh
    const long long kh = row % p.kvh, bs = row / p.kvh;
    const long long base = (bs * p.h + kh * g) * p.d + c;
    float sk = 0.f, sv = 0.f;
    for (int j = 0; j < g; ++j) {
      sk += p.dk_part[base + (long long)j * p.d];
      sv += p.dv_part[base + (long long)j * p.d];
    }
    static_cast<T*>(p.dk)[e] = from_f<T>(sk);
    static_cast<T*>(p.dv)[e] = from_f<T>(sv);
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(Params p) {
  constexpr int CJ = DMAX / 32;
  extern __shared__ float smem[];
  const int d = p.d, ld = d + 1;
  float* ks = smem;
  float* vs = ks + BT * ld;
  float* qs = vs + BT * ld;
  float* gs = qs + BT * ld;
  float* ps = gs + BT * ld;
  float* dss = ps + BT * LDT;
  float* lse_s = dss + BT * LDT;
  float* del_s = lse_s + BT;

  const int ty = threadIdx.x >> 5, tx = threadIdx.x & 31;
  const int i0 = blockIdx.x * BT, hh = blockIdx.y, bb = blockIdx.z;
  const int kh = hh / (p.h / p.kvh);
  const long long qrow = (long long)p.h * d, krow = (long long)p.kvh * d;
  const T* qg = static_cast<const T*>(p.q) + ((long long)bb * p.sq * p.h + hh) * d;
  const T* gg = static_cast<const T*>(p.dout) + ((long long)bb * p.sq * p.h + hh) * d;
  const T* kg = static_cast<const T*>(p.k) + ((long long)bb * p.skv * p.kvh + kh) * d;
  const T* vg = static_cast<const T*>(p.v) + ((long long)bb * p.skv * p.kvh + kh) * d;

  float dq[RM][CJ];
#pragma unroll
  for (int m = 0; m < RM; ++m)
#pragma unroll
    for (int jj = 0; jj < CJ; ++jj) dq[m][jj] = 0.f;

  load_rows(qs, ld, qg, qrow, i0, p.sq, d, p.scale);
  load_rows(gs, ld, gg, qrow, i0, p.sq, d, 1.f);
  load_stats(p, lse_s, del_s, bb, hh, i0);

  // kv rows that some q row of this tile can see
  const long long i_max = lmin(p.sq, i0 + BT) - 1;
  long long j_lo = 0, j_hi = p.skv - 1;
  if (p.causal) j_hi = lmin(j_hi, (long long)p.q_offset + i_max);
  if (p.window > 0) j_lo = lmax(j_lo, (long long)p.q_offset + i0 - p.window + 1);
  for (long long j0l = (j_lo / BT) * BT; j0l <= j_hi; j0l += BT) {
    const int j0 = (int)j0l;
    __syncthreads();
    load_rows(ks, ld, kg, krow, j0, p.skv, d, 1.f);
    load_rows(vs, ld, vg, krow, j0, p.skv, d, 1.f);
    __syncthreads();
    score_tile(p, qs, gs, ks, vs, ld, lse_s, del_s, ps, dss, i0, j0);
    __syncthreads();
    for (int j = 0; j < BT; ++j) {
#pragma unroll
      for (int jj = 0; jj < CJ; ++jj) {
        const int c = tx + 32 * jj;
        if (c < d) {
          const float kv = ks[j * ld + c];
#pragma unroll
          for (int m = 0; m < RM; ++m)
            dq[m][jj] = fmaf(dss[(RM * ty + m) * LDT + j], kv, dq[m][jj]);
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < RM; ++m) {
    const int i = i0 + RM * ty + m;
    if (i >= p.sq) continue;
    T* out = static_cast<T*>(p.dq) + (((long long)bb * p.sq + i) * p.h + hh) * d;
#pragma unroll
    for (int jj = 0; jj < CJ; ++jj) {
      const int c = tx + 32 * jj;
      if (c < d) out[c] = from_f<T>(p.scale * dq[m][jj]);
    }
  }
}

inline size_t smem_bytes(int d) {
  return sizeof(float) * (4 * (size_t)BT * (d + 1) + 2 * BT * LDT + 2 * BT);
}

// float32: the CUDA-core kernels
template <int DMAX>
int launch_dmax(const Params& p, cudaStream_t s) {
  using T = float;
  const size_t smem = smem_bytes(p.d);
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, DMAX>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long rows = (long long)p.b * p.sq * p.h;
  flash_bwd_delta_kernel<T><<<(unsigned)((rows + THREADS / 32 - 1) / (THREADS / 32)), THREADS, 0, s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkdv_kernel<T, DMAX><<<dim3((p.skv + BT - 1) / BT, p.h, p.b), THREADS, smem, s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n = (long long)p.b * p.skv * p.kvh * p.d;
  const long long blocks = lmin((n + THREADS - 1) / THREADS, 65535LL * 8);
  flash_bwd_reduce_kernel<T><<<(unsigned)blocks, THREADS, 0, s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq_kernel<T, DMAX><<<dim3((p.sq + BT - 1) / BT, p.h, p.b), THREADS, smem, s>>>(p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- bf16, tensor cores
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int THREADS = 256;  // 8 warps
constexpr int BN = 64;        // kv rows of a dk / dv block
constexpr int BQ = 64;        // q rows of a tile of the dk / dv pass
constexpr int BM = 128;       // (position, head) rows of a dq block, 16 a warp
constexpr int BK = 32;        // kv rows of a tile of the dq pass
constexpr int LDS = BQ + 8;   // row stride of the P^T and dS^T tiles
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ inline int pad16(int d) { return (d + 15) & ~15; }

// bf16 rows are padded to pad16(d) + 8 elements, so the 8 row addresses of an
// ldmatrix fall in 8 different 16-byte bank groups
__host__ __device__ inline size_t dkdv_smem_bytes(int d) {
  return sizeof(bf16) * ((size_t)(pad16(d) + 8) * (2 * BN + 2 * 2 * BQ) + 2 * BN * LDS) +
         sizeof(float) * 2 * 2 * BQ;
}

__host__ __device__ inline size_t dq_smem_bytes(int d) {
  return sizeof(bf16) * (size_t)(pad16(d) + 8) * (2 * BM + 2 * 2 * BK);
}

// rows [row0, row0 + n) of a (seq, d) slice with row stride rs into dst (row
// stride ld), zeros past n_rows: 16-byte cp.async when aligned, else element
// by element
__device__ __forceinline__ void stage_rows(bf16* dst, int ld, const bf16* src, long long rs,
                                           int row0, int n, int n_rows, int d, bool aligned) {
  if (aligned) {
    const int cpr = d / 8;  // 16-byte chunks a row
    for (int i = threadIdx.x; i < n * cpr; i += THREADS) {
      const int r = i / cpr, c = i - r * cpr;
      const bool ok = row0 + r < n_rows;
      sm90::cp_async16(sm90::smem_addr(dst + r * ld + 8 * c),
                       ok ? src + (row0 + r) * rs + 8 * c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < n * d; i += THREADS) {
      const int r = i / d, c = i - r * d;
      dst[r * ld + c] = row0 + r < n_rows ? src[(row0 + r) * rs + c] : __float2bfloat16(0.f);
    }
  }
}

// rows [m0, m0 + BM) of a kv group: row m is position m / g, head m % g of the
// group whose first head's rows start at src; zeros past the sequence end
__device__ __forceinline__ void stage_group_rows(bf16* dst, int ld, const bf16* src,
                                                 const Params& p, int m0, int g, bool aligned) {
  const long long rs = (long long)p.h * p.d;
  if (aligned) {
    const int cpr = p.d / 8;
    for (int i = threadIdx.x; i < BM * cpr; i += THREADS) {
      const int r = i / cpr, c = i - r * cpr;
      const int s = (m0 + r) / g, j = (m0 + r) - s * g;
      const bool ok = s < p.sq;
      sm90::cp_async16(sm90::smem_addr(dst + r * ld + 8 * c),
                       ok ? src + s * rs + (long long)j * p.d + 8 * c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < BM * p.d; i += THREADS) {
      const int r = i / p.d, c = i - r * p.d;
      const int s = (m0 + r) / g, j = (m0 + r) - s * g;
      dst[r * ld + c] =
          s < p.sq ? src[s * rs + (long long)j * p.d + c] : __float2bfloat16(0.f);
    }
  }
}

// the A and B fragments of one 16-deep step of A B^T
template <int NJ>
__device__ __forceinline__ void load_abt(uint32_t (&fa)[4], uint32_t (&fb)[NJ][4], uint32_t a_row,
                                         uint32_t b_row, int ld, int kk) {
  sm90::ldsm_x4(fa, a_row + kk * 32);
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) sm90::ldsm_x4(fb[jj], b_row + (jj * 16 * ld + kk * 16) * 2);
}

// acc (16 x 16 NJ, fp32) += A B^T over the first 16 nk columns of A's 16 rows
// and B's 16 NJ rows, both row-major in shared memory with row stride ld.
// Accumulator element (n, e) is row lane / 4 + 8 (e >> 1), column 8 n + 2
// (lane % 4) + (e & 1).  The asm of ldmatrix and mma is volatile, so source
// order is issue order: the fragments of step kk + 1 are loaded before the
// products of step kk.
template <int NJ, int KMAX>
__device__ __forceinline__ void mma_abt(float (&acc)[2 * NJ][4], const bf16* a, const bf16* b,
                                        int ld, int nk) {
  const int lane = threadIdx.x & 31, mi = lane >> 3;
  const uint32_t a_row = sm90::smem_addr(a + (lane & 15) * ld + (lane >> 4) * 8);
  const uint32_t b_row = sm90::smem_addr(b + ((mi >> 1) * 8 + (lane & 7)) * ld + (mi & 1) * 8);
  uint32_t fa[2][4], fb[2][NJ][4];
  load_abt<NJ>(fa[0], fb[0], a_row, b_row, ld, 0);
#pragma unroll
  for (int kk = 0; kk < KMAX; ++kk) {
    if (kk < nk) {
      if (kk + 1 < nk) load_abt<NJ>(fa[(kk + 1) & 1], fb[(kk + 1) & 1], a_row, b_row, ld, kk + 1);
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        sm90::mma_bf16(acc[2 * jj], fa[kk & 1], fb[kk & 1][jj][0], fb[kk & 1][jj][1]);
        sm90::mma_bf16(acc[2 * jj + 1], fa[kk & 1], fb[kk & 1][jj][2], fb[kk & 1][jj][3]);
      }
    }
  }
}

// q tile t of the dk / dv pass into stage st: q and dO rows, lse and delta
__device__ __forceinline__ void stage_q_tile(bf16* sQ, bf16* sG, float* sL, float* sD, int ld,
                                             int st, int t, const bf16* qg, const bf16* gg,
                                             const float* lg, const float* dg, const Params& p,
                                             bool aligned) {
  const int i0 = t * BQ;
  const long long rs = (long long)p.h * p.d;
  stage_rows(sQ + st * BQ * ld, ld, qg, rs, i0, BQ, p.sq, p.d, aligned);
  stage_rows(sG + st * BQ * ld, ld, gg, rs, i0, BQ, p.sq, p.d, aligned);
  if (threadIdx.x < BQ) {
    const int i = i0 + threadIdx.x;
    const bool ok = i < p.sq;
    const long long at = ok ? (long long)i * p.h : 0;
    sm90::cp_async4(sm90::smem_addr(sL + st * BQ + threadIdx.x), lg + at, ok);
    sm90::cp_async4(sm90::smem_addr(sD + st * BQ + threadIdx.x), dg + at, ok);
  }
}

template <int DMAX>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dkdv_mma_kernel(const Params p, int aligned) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d = p.d, d16 = pad16(d), ld = d16 + 8, nk = d16 / 16;
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);         // BN x ld
  bf16* sV = sK + BN * ld;                               // BN x ld
  bf16* sQ = sV + BN * ld;                               // 2 stages of BQ x ld
  bf16* sG = sQ + 2 * BQ * ld;                           // 2 stages of BQ x ld: dO
  bf16* sP = sG + 2 * BQ * ld;                           // BN x LDS: P^T
  bf16* sS = sP + BN * LDS;                              // BN x LDS: dS^T
  float* sL = reinterpret_cast<float*>(sS + BN * LDS);  // 2 stages of BQ: lse
  float* sD = sL + 2 * BQ;                               // 2 stages of BQ: delta

  const int n_tiles = (p.skv + BN - 1) / BN;
  const int idx = blockIdx.x / p.h, hh = blockIdx.x - idx * p.h, bb = blockIdx.y;
  // under a causal mask the first kv tiles see the most q rows: they go first
  const int j0 = (p.causal ? idx : n_tiles - 1 - idx) * BN;
  const int g = p.h / p.kvh, kh = hh / g;
  const long long q_at = ((long long)bb * p.sq * p.h + hh) * p.d;
  const long long k_at = ((long long)bb * p.skv * p.kvh + kh) * p.d;
  const long long krs = (long long)p.kvh * p.d;
  const bf16* qg = static_cast<const bf16*>(p.q) + q_at;
  const bf16* gg = static_cast<const bf16*>(p.dout) + q_at;
  const float* lg = p.lse + (long long)bb * p.sq * p.h + hh;  // a position is h floats
  const float* dg = p.delta + (long long)bb * p.sq * p.h + hh;

  // q tiles with a row that can see a key of this tile
  const long long j_max = lmin(p.skv, j0 + BN) - 1;
  long long i_lo = 0, i_hi = p.sq - 1;
  if (p.causal) i_lo = lmax(i_lo, (long long)j0 - p.q_offset);
  if (p.window > 0) i_hi = lmin(i_hi, j_max + p.window - 1 - p.q_offset);
  const int t_begin = i_lo <= i_hi ? (int)(i_lo / BQ) : 0;
  const int t_end = i_lo <= i_hi ? (int)(i_hi / BQ) + 1 : 0;

  if (d != d16) {  // the products read columns [d, d16): zeros, once
    const int n16 = (int)(dkdv_smem_bytes(d) / 16);
    for (int i = threadIdx.x; i < n16; i += THREADS)
      reinterpret_cast<uint4*>(smem_raw)[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
  }
  stage_rows(sK, ld, static_cast<const bf16*>(p.k) + k_at, krs, j0, BN, p.skv, d, aligned);
  stage_rows(sV, ld, static_cast<const bf16*>(p.v) + k_at, krs, j0, BN, p.skv, d, aligned);
  if (t_begin < t_end) stage_q_tile(sQ, sG, sL, sD, ld, 0, t_begin, qg, gg, lg, dg, p, aligned);
  sm90::cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, c2 = 2 * (lane & 3), mi = lane >> 3;
  // S^T and dP^T: warp (wm, wn) computes kv rows 16 wm + [0, 16) x q columns 32 wn + [0, 32)
  const int wm = warp & 3, wn = warp >> 2;
  // dK and dV: warp (am, an) holds kv rows 16 MT am + [0, 16 MT) x columns WN an + [0, WN)
  constexpr int WN = DMAX >= 128 ? 64 : 32;
  constexpr int WARPS_N = DMAX / WN;           // 4, 2, 2 at DMAX 256, 128, 64
  constexpr int MT = BN / 16 / (8 / WARPS_N);  // 2, 1, 1
  constexpr int NT = WN / 8;
  constexpr int UG = NT / 2 < 4 ? NT / 2 : 4;  // 16-column groups loaded before their products
  const int am = warp / WARPS_N, an = warp % WARPS_N;
  const float sl2 = p.scale * LOG2E;

  float dk[MT][NT][4], dv[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[mt][n][e] = dv[mt][n][e] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int st = (t - t_begin) & 1, i0 = t * BQ;
    sm90::cp_async_wait_all();
    __syncthreads();  // stage st is in; every warp is done with stage st ^ 1, P^T and dS^T
    if (t + 1 < t_end) stage_q_tile(sQ, sG, sL, sD, ld, st ^ 1, t + 1, qg, gg, lg, dg, p, aligned);
    sm90::cp_async_commit();
    const bf16* cQ = sQ + st * BQ * ld;
    const bf16* cG = sG + st * BQ * ld;
    const float* cL = sL + st * BQ;
    const float* cD = sD + st * BQ;

    float s[4][4], dp[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_abt<2, DMAX / 16>(s, sK + wm * 16 * ld, cQ + wn * 32 * ld, ld, nk);
    mma_abt<2, DMAX / 16>(dp, sV + wm * 16 * ld, cG + wn * 32 * ld, ld, nk);

    // P^T and dS^T, rounded to bf16 once; element (n, e) is kv row
    // 16 wm + lane / 4 + 8 (e >> 1), q column 32 wn + 8 n + c2 + (e & 1)
    const bool interior =
        i0 + BQ <= p.sq && j0 + BN <= p.skv &&
        (!p.causal || (long long)j0 + BN - 1 <= (long long)p.q_offset + i0) &&
        (p.window <= 0 || (long long)j0 > (long long)p.q_offset + i0 + BQ - 1 - p.window);
    const int row = wm * 16 + gq;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int col = wn * 32 + 8 * n + c2;
      float pv[4], dsv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = col + (e & 1);
        const bool ok = interior || visible(p, i0 + c, j0 + row + 8 * (e >> 1));
        const float pe = ok ? sm90::ex2(fmaf(s[n][e], sl2, -cL[c] * LOG2E)) : 0.f;
        pv[e] = pe;
        dsv[e] = pe * (dp[n][e] - cD[c]);
      }
      *reinterpret_cast<uint32_t*>(sP + row * LDS + col) = sm90::pack_bf16(pv[0], pv[1]);
      *reinterpret_cast<uint32_t*>(sP + (row + 8) * LDS + col) = sm90::pack_bf16(pv[2], pv[3]);
      *reinterpret_cast<uint32_t*>(sS + row * LDS + col) = sm90::pack_bf16(dsv[0], dsv[1]);
      *reinterpret_cast<uint32_t*>(sS + (row + 8) * LDS + col) = sm90::pack_bf16(dsv[2], dsv[3]);
    }
    __syncthreads();  // P^T and dS^T are complete

    // dV += P^T dO and dK += dS^T Q over the tile's BQ q rows
#pragma unroll
    for (int kq = 0; kq < BQ / 16; ++kq) {
      uint32_t pa[MT][4], sa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int off = ((am * MT + mt) * 16 + (lane & 15)) * LDS + kq * 16 + (lane >> 4) * 8;
        sm90::ldsm_x4(pa[mt], sm90::smem_addr(sP + off));
        sm90::ldsm_x4(sa[mt], sm90::smem_addr(sS + off));
      }
      const int b_row = kq * 16 + (mi & 1) * 8 + (lane & 7);
#pragma unroll
      for (int u0 = 0; u0 < NT / 2; u0 += UG) {
        uint32_t gb[UG][4], qb[UG][4];
#pragma unroll
        for (int u = 0; u < UG; ++u) {
          const int n16 = an * (WN / 16) + u0 + u;
          if (n16 < nk) {
            const int off = b_row * ld + n16 * 16 + (mi >> 1) * 8;
            sm90::ldsm_x4_t(gb[u], sm90::smem_addr(cG + off));
            sm90::ldsm_x4_t(qb[u], sm90::smem_addr(cQ + off));
          }
        }
#pragma unroll
        for (int u = 0; u < UG; ++u) {
          if (an * (WN / 16) + u0 + u < nk) {
            const int n = 2 * (u0 + u);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              sm90::mma_bf16(dv[mt][n], pa[mt], gb[u][0], gb[u][1]);
              sm90::mma_bf16(dv[mt][n + 1], pa[mt], gb[u][2], gb[u][3]);
              sm90::mma_bf16(dk[mt][n], sa[mt], qb[u][0], qb[u][1]);
              sm90::mma_bf16(dk[mt][n + 1], sa[mt], qb[u][2], qb[u][3]);
            }
          }
        }
      }
    }
  }
  sm90::cp_async_wait_all();  // with no visible q tile the k and v copies may still be in flight

  // this head's shares (dk times scale) into the fp32 scratch (B, Skv, H, D)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + (am * MT + mt) * 16 + gq + 8 * (e >> 1);
        const int c = an * WN + 8 * n + c2 + (e & 1);
        if (j < p.skv && c < d) {
          const long long at = (((long long)bb * p.skv + j) * p.h + hh) * d + c;
          p.dk_part[at] = p.scale * dk[mt][n][e];
          p.dv_part[at] = dv[mt][n][e];
        }
      }
}

template <int DMAX>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dq_mma_kernel(const Params p, int aligned) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d = p.d, d16 = pad16(d), ld = d16 + 8, nk = d16 / 16;
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // BM x ld, later the dq tile
  bf16* sG = sQ + BM * ld;                        // BM x ld: dO
  bf16* sK = sG + BM * ld;                        // 2 stages of BK x ld
  bf16* sV = sK + 2 * BK * ld;                    // 2 stages of BK x ld

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = p.h / p.kvh;
  const int rows = p.sq * g;
  const int m0 = (gridDim.x - 1 - blockIdx.x) * BM;  // most kv tiles first
  const int kh = blockIdx.y, bb = blockIdx.z;
  const long long q_at = ((long long)bb * p.sq * p.h + (long long)kh * g) * d;
  const long long k_at = ((long long)bb * p.skv * p.kvh + kh) * d;
  const long long krs = (long long)p.kvh * d;
  const bf16* kg = static_cast<const bf16*>(p.k) + k_at;
  const bf16* vg = static_cast<const bf16*>(p.v) + k_at;

  // kv tiles some row of this block can see
  const int q_lo = p.q_offset + m0 / g;
  const int q_hi = p.q_offset + (min(m0 + BM, rows) - 1) / g;
  int kv_end = p.skv;
  if (p.causal) kv_end = min(kv_end, q_hi + 1);
  int kv_begin = 0;
  if (p.window > 0) kv_begin = max(0, q_lo - p.window + 1);
  const int t_begin = kv_begin / BK;
  const int t_end = kv_end > kv_begin ? (kv_end + BK - 1) / BK : t_begin;

  if (d != d16) {  // the products read columns [d, d16): zeros, once
    const int n16 = (int)(dq_smem_bytes(d) / 16);
    for (int i = threadIdx.x; i < n16; i += THREADS)
      reinterpret_cast<uint4*>(smem_raw)[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
  }
  stage_group_rows(sQ, ld, static_cast<const bf16*>(p.q) + q_at, p, m0, g, aligned);
  stage_group_rows(sG, ld, static_cast<const bf16*>(p.dout) + q_at, p, m0, g, aligned);
  if (t_begin < t_end) {
    stage_rows(sK, ld, kg, krs, t_begin * BK, BK, p.skv, d, aligned);
    stage_rows(sV, ld, vg, krs, t_begin * BK, BK, p.skv, d, aligned);
  }
  sm90::cp_async_commit();

  // this thread's rows: r0 = 16 warp + lane / 4 and r0 + 8
  const int r0 = warp * 16 + (lane >> 2);
  const int c2 = 2 * (lane & 3), mi = lane >> 3;
  int qpos[2];
  bool live[2];
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + r0 + 8 * i, s = m / g;
    live[i] = s < p.sq;
    qpos[i] = p.q_offset + s;
    const long long at = ((long long)bb * p.sq + s) * p.h + (long long)kh * g + (m - s * g);
    lse2[i] = live[i] ? p.lse[at] * LOG2E : 0.f;
    dl[i] = live[i] ? p.delta[at] : 0.f;
  }
  const float sl2 = p.scale * LOG2E;

  float acc[DMAX / 8][4];
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int st = (t - t_begin) & 1, k0 = t * BK;
    sm90::cp_async_wait_all();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1's stage
    if (t + 1 < t_end) {
      stage_rows(sK + (st ^ 1) * BK * ld, ld, kg, krs, k0 + BK, BK, p.skv, d, aligned);
      stage_rows(sV + (st ^ 1) * BK * ld, ld, vg, krs, k0 + BK, BK, p.skv, d, aligned);
    }
    sm90::cp_async_commit();
    const bf16* cK = sK + st * BK * ld;
    const bf16* cV = sV + st * BK * ld;

    // dP = dO V^T and S = Q K^T: 16 rows x BK keys a warp
    float dp[BK / 8][4], s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = s[j][e] = 0.f;
    mma_abt<BK / 16, DMAX / 16>(dp, sG + warp * 16 * ld, cV, ld, nk);
    mma_abt<BK / 16, DMAX / 16>(s, sQ + warp * 16 * ld, cK, ld, nk);

    // dS = P (dP - delta) in place of S: element (j, e) is key
    // k0 + 8 j + c2 + (e & 1) of row r0 + 8 (e >> 1)
    const bool interior = m0 + BM <= rows && k0 + BK <= p.skv &&
                          (!p.causal || k0 + BK - 1 <= q_lo) &&
                          (p.window <= 0 || k0 > q_hi - p.window);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + c2 + (e & 1), i = e >> 1;
        bool ok = interior;
        if (!ok) {
          ok = live[i] && key < p.skv;
          if (p.causal) ok = ok && key <= qpos[i];
          if (p.window > 0) ok = ok && key > qpos[i] - p.window;
        }
        const float pe = ok ? sm90::ex2(fmaf(s[j][e], sl2, -lse2[i])) : 0.f;
        s[j][e] = pe * (dp[j][e] - dl[i]);
      }

    // dQ += dS K: dS rounded to bf16 in the A fragments; four K fragments
    // loaded (.trans: the product runs along K's rows), then their products
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t da[4] = {sm90::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              sm90::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              sm90::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              sm90::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int d4 = 0; d4 < DMAX / 64; ++d4) {
        if (d4 * 4 < nk) {
          uint32_t b[4][4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (d4 * 4 + u < nk)
              sm90::ldsm_x4_t(b[u], sm90::smem_addr(cK + (kk * 16 + (mi & 1) * 8 + (lane & 7)) *
                                                        ld + (d4 * 4 + u) * 16 + (mi >> 1) * 8));
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (d4 * 4 + u < nk) {
              sm90::mma_bf16(acc[2 * (d4 * 4 + u)], da, b[u][0], b[u][1]);
              sm90::mma_bf16(acc[2 * (d4 * 4 + u) + 1], da, b[u][2], b[u][3]);
            }
        }
      }
    }
  }

  // epilogue: scale dq, rounded once to bf16 into this warp's own q rows, then out
  sm90::cp_async_wait_all();
  __syncthreads();  // with no visible tile the q and dO copies may still be in flight
  bf16* sO = sQ;
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n) {
    if (n < d16 / 8) {
      *reinterpret_cast<uint32_t*>(sO + r0 * ld + 8 * n + c2) =
          sm90::pack_bf16(p.scale * acc[n][0], p.scale * acc[n][1]);
      *reinterpret_cast<uint32_t*>(sO + (r0 + 8) * ld + 8 * n + c2) =
          sm90::pack_bf16(p.scale * acc[n][2], p.scale * acc[n][3]);
    }
  }
  __syncwarp();
  bf16* og = static_cast<bf16*>(p.dq);
  const long long head0 = (long long)kh * g;
  if (d % 8 == 0 && (reinterpret_cast<uintptr_t>(og) & 15) == 0) {  // 16-byte stores
    const int cpr = d / 8;
    for (int i = lane; i < 16 * cpr; i += 32) {
      const int r = warp * 16 + i / cpr, c = i % cpr;
      const int s = (m0 + r) / g;
      if (s >= p.sq) continue;
      const long long orow = ((long long)bb * p.sq + s) * p.h + head0 + (m0 + r) - s * g;
      *reinterpret_cast<uint4*>(og + orow * d + 8 * c) =
          *reinterpret_cast<const uint4*>(sO + r * ld + 8 * c);
    }
  } else {
    for (int i = lane; i < 16 * d; i += 32) {
      const int r = warp * 16 + i / d, c = i % d;
      const int s = (m0 + r) / g;
      if (s >= p.sq) continue;
      const long long orow = ((long long)bb * p.sq + s) * p.h + head0 + (m0 + r) - s * g;
      og[orow * d + c] = sO[r * ld + c];
    }
  }
}

template <int DMAX>
int launch_mma(const Params& p, cudaStream_t s) {
  const size_t smem_kv = dkdv_smem_bytes(p.d), smem_q = dq_smem_bytes(p.d);
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkdv_mma_kernel<DMAX>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_bwd_dq_mma_kernel<DMAX>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (e != cudaSuccess) return (int)e;
  // 16-byte cp.async needs every row start 16-byte aligned (the rows are dense)
  const bool aligned =
      p.d % 8 == 0 && ((reinterpret_cast<uintptr_t>(p.q) | reinterpret_cast<uintptr_t>(p.k) |
                        reinterpret_cast<uintptr_t>(p.v) | reinterpret_cast<uintptr_t>(p.dout)) &
                       15) == 0;
  const long long rows = (long long)p.b * p.sq * p.h;
  flash_bwd_delta_kernel<bf16><<<(unsigned)((rows + THREADS / 32 - 1) / (THREADS / 32)), THREADS, 0, s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n_tiles = (p.skv + BN - 1) / BN;
  flash_bwd_dkdv_mma_kernel<DMAX><<<dim3(n_tiles * p.h, p.b), THREADS, smem_kv, s>>>(
      p, aligned ? 1 : 0);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n = (long long)p.b * p.skv * p.kvh * p.d;
  const long long blocks = lmin((n + THREADS - 1) / THREADS, 65535LL * 8);
  flash_bwd_reduce_kernel<bf16><<<(unsigned)blocks, THREADS, 0, s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int rows_g = p.sq * (p.h / p.kvh);
  flash_bwd_dq_mma_kernel<DMAX><<<dim3((rows_g + BM - 1) / BM, p.kvh, p.b), THREADS, smem_q, s>>>(
      p, aligned ? 1 : 0);
  return (int)cudaGetLastError();
}

}  // namespace tc

// float32 -> the CUDA-core kernels, bfloat16 -> the tensor-core kernels
template <typename T>
int launch(const Params& p, cudaStream_t s) {
  if (p.b <= 0 || p.h <= 0 || p.sq <= 0) return (int)cudaSuccess;
  if (p.d <= 0 || p.d > 256 || p.kvh <= 0 || p.h % p.kvh != 0 || p.skv <= 0 ||
      p.h > 65535 || p.b > 65535 || (long long)p.sq * (p.h / p.kvh) > 0x3fffffffLL ||
      (long long)((p.skv + tc::BN - 1) / tc::BN) * p.h > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if constexpr (std::is_same<T, float>::value) {
    if (p.d <= 64) return launch_dmax<64>(p, s);
    if (p.d <= 128) return launch_dmax<128>(p, s);
    return launch_dmax<256>(p, s);
  } else {
    if (p.d <= 64) return tc::launch_mma<64>(p, s);
    if (p.d <= 128) return tc::launch_mma<128>(p, s);
    return tc::launch_mma<256>(p, s);
  }
}

}  // namespace

extern "C" {

#define FLASH_BWD_ARGS                                                          \
  const void *q, const void *k, const void *v, const void *o, const void *dout, \
      const float *lse, float *delta, float *dk_part, float *dv_part, void *dq,  \
      void *dk, void *dv, int b, int sq, int skv, int h, int kvh, int d,         \
      int causal, int window, int q_offset, float scale, void *stream
#define FLASH_BWD_PARAMS                                                        \
  Params { q, k, v, o, dout, lse, delta, dk_part, dv_part, dq, dk, dv, b, sq,   \
           skv, h, kvh, d, causal, window, q_offset, scale }

int flash_attention_bwd_f32(FLASH_BWD_ARGS) {
  return launch<float>(FLASH_BWD_PARAMS, static_cast<cudaStream_t>(stream));
}

int flash_attention_bwd_bf16(FLASH_BWD_ARGS) {
  return launch<__nv_bfloat16>(FLASH_BWD_PARAMS, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
