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
// the balance point: ~0.16 ms at the bf16 tensor-core peak.  This first
// version is simple and right, not fast: fp32 FMAs on the CUDA cores from
// fp32 tiles in shared memory (bf16 inputs are widened on load), so its
// bound is the 67 TFLOP/s fp32 rate and its shared-memory traffic.  It is
// deterministic: no floating-point atomics anywhere.
//
//   1. `flash_bwd_delta_kernel`: a warp per (batch, position, head) row, delta in fp32.
//   2. `flash_bwd_dkdv_kernel`: a block per (32 kv rows, q head, batch) walks the q
//      tiles that can see its kv rows (causal bound and window) and
//      accumulates that head's share of dk and dv in registers, written to an
//      fp32 scratch (B, Skv, H, D): a block per q head, not per kv head, so
//      MQA still has H times the blocks.
//   3. `flash_bwd_reduce_kernel`: dk and dv of each kv head are the sum of its group's
//      shares, in head order (a fixed order: the result does not depend on
//      scheduling), rounded once to the input type.
//   4. `flash_bwd_dq_kernel`: a block per (32 q rows, q head, batch) walks the visible
//      kv tiles and accumulates dq in registers.
//
// Passes 2 and 4 both recompute s and p from the saved lse.  Tiles are 32 x
// 32 with 256 threads: a thread computes 4 rows x 1 column of the score tile
// and a 4-row x d/32-column slice of the d-wide products.  Shared memory rows
// are padded to d + 1 floats, so the 32 rows a warp reads at one column fall
// in 32 different banks: 4 x 32 x 257 x 4 B + the p and ds tiles = 140 KB at
// d 256.  The wrapper hands dense (B, S, H, D) tensors.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

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

template <typename T, int DMAX>
int launch_dmax(const Params& p, cudaStream_t s) {
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

template <typename T>
int launch(const Params& p, cudaStream_t s) {
  if (p.b <= 0 || p.h <= 0 || p.sq <= 0) return (int)cudaSuccess;
  if (p.d <= 0 || p.d > 256 || p.kvh <= 0 || p.h % p.kvh != 0 || p.skv <= 0 ||
      p.h > 65535 || p.b > 65535)
    return (int)cudaErrorInvalidValue;
  if (p.d <= 64) return launch_dmax<T, 64>(p, s);
  if (p.d <= 128) return launch_dmax<T, 128>(p, s);
  return launch_dmax<T, 256>(p, s);
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
