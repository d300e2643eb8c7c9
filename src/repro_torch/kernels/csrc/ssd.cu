// Mamba-2 SSD (state-space duality), chunked, for Hopper (sm_90a).
//
// Replaces the TPU kernel `ssd_pallas` (src/repro/kernels/ssd.py:75, kernel
// body `_kernel`).  There the chunks are the sequential minor grid axis and
// the fp32 state (P, N) sits in VMEM scratch across it.  Here one thread block
// owns one (batch, head) and walks its chunks in a loop, so the state never
// leaves shared memory between chunks.  Per chunk of Q = 64 steps, with
// L = cumsum(dt A) inside the chunk (A = -exp(a_log)):
//
//   M[t, s] = (C_t . B_s) exp(L_t - L_s) dt_s   for s <= t, else 0
//   Y       = M X + exp(L_t) (C h^T)
//   h'      = exp(L_last) h + (X dt exp(L_last - L))^T B
//
// then y = Y + d_skip x in fp32, rounded to x's type once, as the TPU path does
// after its kernel.  Head h reads B/C group h / (H / G).
//
// What bounds it on this card: operations.  At the serving shape (4 x 4096
// steps, 48 heads of P = 64, N = 128, one group, bf16 x/B/C) the chunked form
// needs tens of GFLOP against ~225 MB of traffic.  This version does them as
// fp32 FMAs on the CUDA cores (as the TPU kernel computes in fp32); tensor
// cores (C B^T and M X are plain matrix products), TMA and one C B^T per group
// instead of per head are for a later version.  What it does today:
//   * x, B and C of a chunk are read from device memory once, converted to
//     fp32 into shared memory, and every product reads them from there;
//   * register tiling: each of the 256 threads computes a 4 x 4 tile of M and
//     of Y and a 4 x (2 x 4) tile of h' from float4 shared-memory reads
//     (rows of B, C and h are padded by 4 floats, so the eight threads of a
//     quarter warp hit distinct banks);
//   * the loops stop at the chunk's valid rows, so a short last chunk and a
//     decode step (T = 1) do only their own work, and the shared memory is
//     sized to min(Q, T) rows: a decode launch needs ~35 KB and runs all its
//     blocks at once.
//
// Grid: one block per (head, batch): 192 blocks at the serving shape on 132
// SMs.  At T >= 64 a block holds ~135 KB of shared memory (one per SM), so
// that is two waves, the second 60/132 full.
//
// The causal mask selects: exp(L_t - L_s) is evaluated only for s <= t, where
// its argument is <= 0.  Above the diagonal it would be exp of a positive
// number, possibly inf, and inf * 0 is NaN.  Rows past the end of T are zeros
// (dt = 0 there, so they neither decay nor feed the state).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int Q = 64;         // time steps per chunk
constexpr int THREADS = 256;  // a 16 x 16 grid: (ty, tx)
constexpr int MAXP = 64;      // head_dim: 4 columns per thread, tx + 16 j
constexpr int MAXN = 128;     // state: 2 float4 per thread in the update

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

struct Params {
  const void* x;       // (B, T, H, P), strides x_sb, x_st, x_sh, unit along P
  const float* dt;     // (B, T, H) contiguous
  const float* a_log;  // (H,)
  const void* bm;      // (B, T, G, N), strides b_sb, b_st, b_sg, unit along N
  const void* cm;      // (B, T, G, N), strides c_sb, c_st, c_sg, unit along N
  const float* d_skip; // (H,) or null
  const float* h0;     // (B, H, P, N) contiguous, or null (zeros)
  void* y;             // (B, T, H, P) contiguous, x's type
  float* h_last;       // (B, H, P, N) contiguous
  long long x_sb, x_st, x_sh, b_sb, b_st, b_sg, c_sb, c_st, c_sg;
  int t, h, g, p, n, qa;  // qa = rows of the chunk buffers, min(Q, T)
};

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_chunk_kernel(const Params prm) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int P = prm.p, N = prm.n, qa = prm.qa, ldn = N + 4;
  float* sB = smem;            // qa x ldn
  float* sC = sB + qa * ldn;   // qa x ldn
  float* sH = sC + qa * ldn;   // P x ldn, the state
  float* sX = sH + P * ldn;    // qa x P
  float* sM = sX + qa * P;     // qa x qa
  float* sDt = sM + qa * qa;   // Q each from here on
  float* sL = sDt + Q;         // L_t
  float* sEL = sL + Q;         // exp(L_t)
  float* sW = sEL + Q;         // dt_s exp(L_last - L_s)
  __shared__ float sELast;     // exp(L_last)

  const int hh = blockIdx.x, bb = blockIdx.y;
  const int grp = hh / (prm.h / prm.g);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float a = -expf(prm.a_log[hh]);
  const T* x = static_cast<const T*>(prm.x) + bb * prm.x_sb + hh * prm.x_sh;
  const T* bm = static_cast<const T*>(prm.bm) + bb * prm.b_sb + grp * prm.b_sg;
  const T* cm = static_cast<const T*>(prm.cm) + bb * prm.c_sb + grp * prm.c_sg;
  const float* dt = prm.dt + (long long)bb * prm.t * prm.h + hh;          // stride h
  T* y = static_cast<T*>(prm.y) + ((long long)bb * prm.t * prm.h + hh) * P;
  const long long y_st = (long long)prm.h * P;
  const long long hoff = ((long long)bb * prm.h + hh) * P * N;
  const bool skip = prm.d_skip != nullptr;
  const float dskip = skip ? prm.d_skip[hh] : 0.f;

  for (int e = tid; e < P * N; e += THREADS)
    sH[(e / N) * ldn + e % N] = prm.h0 != nullptr ? prm.h0[hoff + e] : 0.f;

  for (int c0 = 0; c0 < prm.t; c0 += Q) {
    const int valid = min(Q, prm.t - c0);
    // ---- the chunk's dt, x, B, C into shared memory (fp32; zero past T)
    if (tid < Q) sDt[tid] = tid < valid ? dt[(long long)(c0 + tid) * prm.h] : 0.f;
    for (int e = tid; e < qa * P; e += THREADS) {
      const int s = e / P;
      sX[e] = s < valid ? to_f<T>(x[(c0 + s) * prm.x_st + e % P]) : 0.f;
    }
    for (int e = tid; e < qa * N; e += THREADS) {
      const int s = e / N, k = e % N;
      const bool ok = s < valid;
      sB[s * ldn + k] = ok ? to_f<T>(bm[(c0 + s) * prm.b_st + k]) : 0.f;
      sC[s * ldn + k] = ok ? to_f<T>(cm[(c0 + s) * prm.c_st + k]) : 0.f;
    }
    __syncthreads();

    // ---- L = cumsum(dt A): warp 0, two steps per lane, a shuffle scan
    if (tid < 32) {
      const float a0 = sDt[2 * tid] * a, a1 = sDt[2 * tid + 1] * a;
      float incl = a0 + a1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += v;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
      const float l0 = excl + a0, l1 = l0 + a1;
      const int last = valid - 1;
      const float llast = __shfl_sync(0xffffffffu, (last & 1) ? l1 : l0, last >> 1);
      sL[2 * tid] = l0;
      sL[2 * tid + 1] = l1;
      sEL[2 * tid] = expf(l0);
      sEL[2 * tid + 1] = expf(l1);
      sW[2 * tid] = sDt[2 * tid] * expf(llast - l0);
      sW[2 * tid + 1] = sDt[2 * tid + 1] * expf(llast - l1);
      if (tid == 0) sELast = expf(llast);
    }
    __syncthreads();

    // ---- M: rows t = ty + 16 i, columns s = tx + 16 j
    if (ty < valid) {
      float acc[4][4] = {};
      const float* crow[4];
      const float* brow[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        crow[i] = sC + min(ty + 16 * i, qa - 1) * ldn;
        brow[i] = sB + min(tx + 16 * i, qa - 1) * ldn;
      }
      for (int k = 0; k < N; k += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          cv[i] = *reinterpret_cast<const float4*>(crow[i] + k);
          bv[i] = *reinterpret_cast<const float4*>(brow[i] + k);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = dot4(cv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        if (t >= valid) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = tx + 16 * j;
          if (s >= valid) continue;
          // select, never multiply by the mask
          sM[t * qa + s] = s <= t ? acc[i][j] * expf(sL[t] - sL[s]) * sDt[s] : 0.f;
        }
      }
    }
    __syncthreads();

    // ---- Y: rows t = ty + 16 i, columns p = tx + 16 j
    if (ty < valid) {
      float am[4][4] = {}, ah[4][4] = {};
      int pr[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) pr[j] = min(tx + 16 * j, P - 1);
      const float* mrow[4];
      const float* crow[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        mrow[i] = sM + min(ty + 16 * i, valid - 1) * qa;
        crow[i] = sC + min(ty + 16 * i, qa - 1) * ldn;
      }
      for (int s = 0; s < valid; ++s) {
        float mv[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) mv[i] = mrow[i][s];
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = sX[s * P + pr[j]];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) am[i][j] = fmaf(mv[i], xv[j], am[i][j]);
      }
      for (int k = 0; k < N; k += 4) {
        float4 cv[4], hv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          cv[i] = *reinterpret_cast<const float4*>(crow[i] + k);
          hv[i] = *reinterpret_cast<const float4*>(sH + pr[i] * ldn + k);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) ah[i][j] = dot4(cv[i], hv[j], ah[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        if (t >= valid) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int pp = tx + 16 * j;
          if (pp >= P) continue;
          float v = am[i][j] + sEL[t] * ah[i][j];
          if (skip) v += dskip * sX[t * P + pp];
          y[(c0 + t) * y_st + pp] = from_f<T>(v);
        }
      }
    }
    __syncthreads();   // the state is read above and rewritten below

    // ---- h' = exp(L_last) h + (X w)^T B: rows p = ty + 16 i, columns
    //      n = 4 tx + 64 j .. + 3
    {
      const float el = sELast;
      float4 acc[4][2];
      int pr[4], nc[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = min(ty + 16 * i, P - 1);
#pragma unroll
      for (int j = 0; j < 2; ++j) nc[j] = min(4 * tx + 64 * j, N - 4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float4 hv = *reinterpret_cast<const float4*>(sH + pr[i] * ldn + nc[j]);
          acc[i][j] = make_float4(el * hv.x, el * hv.y, el * hv.z, el * hv.w);
        }
      for (int s = 0; s < valid; ++s) {
        const float ws = sW[s];
        float xv[4];
        float4 bv[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = sX[s * P + pr[i]] * ws;
#pragma unroll
        for (int j = 0; j < 2; ++j) bv[j] = *reinterpret_cast<const float4*>(sB + s * ldn + nc[j]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            acc[i][j].x = fmaf(xv[i], bv[j].x, acc[i][j].x);
            acc[i][j].y = fmaf(xv[i], bv[j].y, acc[i][j].y);
            acc[i][j].z = fmaf(xv[i], bv[j].z, acc[i][j].z);
            acc[i][j].w = fmaf(xv[i], bv[j].w, acc[i][j].w);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if (ty + 16 * i < P && 4 * tx + 64 * j < N)
            *reinterpret_cast<float4*>(sH + (ty + 16 * i) * ldn + 4 * tx + 64 * j) = acc[i][j];
    }
    __syncthreads();   // before the next chunk overwrites dt, x, B, C
  }

  for (int e = tid; e < P * N; e += THREADS)
    prm.h_last[hoff + e] = sH[(e / N) * ldn + e % N];
}

template <typename T>
int launch(const void* x, const float* dt, const float* a_log, const void* bm,
           const void* cm, const float* d_skip, const float* h0, void* y,
           float* h_last, long long x_sb, long long x_st, long long x_sh,
           long long b_sb, long long b_st, long long b_sg, long long c_sb,
           long long c_st, long long c_sg, int b, int t, int h, int g, int p,
           int n, void* stream) {
  if (b <= 0 || t <= 0 || h <= 0) return (int)cudaSuccess;
  if (g <= 0 || h % g != 0 || p <= 0 || p > MAXP || n <= 0 || n > MAXN || n % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const int qa = t < Q ? t : Q;
  Params prm{x, dt, a_log, bm, cm, d_skip, h0, y, h_last, x_sb, x_st, x_sh,
             b_sb, b_st, b_sg, c_sb, c_st, c_sg, t, h, g, p, n, qa};
  const int ldn = n + 4;
  const size_t smem =
      sizeof(float) * ((size_t)2 * qa * ldn + (size_t)p * ldn + (size_t)qa * p +
                       (size_t)qa * qa + 4 * Q);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(h, b);
  ssd_chunk_kernel<T><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(prm);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define SSD_ARGS                                                               \
  const void *x, const float *dt, const float *a_log, const void *bm,          \
      const void *cm, const float *d_skip, const float *h0, void *y,            \
      float *h_last, long long x_sb, long long x_st, long long x_sh,            \
      long long b_sb, long long b_st, long long b_sg, long long c_sb,           \
      long long c_st, long long c_sg, int b, int t, int h, int g, int p, int n, \
      void *stream
#define SSD_PASS                                                               \
  x, dt, a_log, bm, cm, d_skip, h0, y, h_last, x_sb, x_st, x_sh, b_sb, b_st,    \
      b_sg, c_sb, c_st, c_sg, b, t, h, g, p, n, stream

int ssd_chunked_f32(SSD_ARGS) { return launch<float>(SSD_PASS); }

int ssd_chunked_bf16(SSD_ARGS) { return launch<__nv_bfloat16>(SSD_PASS); }

}  // extern "C"
