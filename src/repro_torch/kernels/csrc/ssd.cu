// Mamba-2 SSD (state-space duality), chunked, for Hopper (sm_90a).
//
// Replaces the TPU kernel `ssd_pallas` (src/repro/kernels/ssd.py:75, kernel
// body `_kernel`).  There the chunks are the sequential minor grid axis and
// the fp32 state (P, N) sits in VMEM scratch across it.  Here a thread block
// walks its chunks in a loop, so the state never leaves the block between
// chunks.  Per chunk of Q = 64 steps, with L = cumsum(dt A) inside the chunk
// (A = -exp(a_log)):
//
//   M[t, s] = (C_t . B_s) exp(L_t - L_s) dt_s   for s <= t, else 0
//   Y       = M X + exp(L_t) (C h^T)
//   h'      = exp(L_last) h + X^T (B dt exp(L_last - L))
//
// then y = Y + d_skip x in fp32, rounded to x's type once, as the TPU path does
// after its kernel.  Head h reads B/C group h / (H / G).  The causal mask
// selects: exp(L_t - L_s) is evaluated only for s <= t, where its argument is
// <= 0 (above the diagonal it may be inf, and inf * 0 is NaN).  Rows past the
// end of T are zeros with dt = 0, so they neither decay nor feed the state.
//
// What bounds it on this card: bytes, once the products run on the tensor
// cores.  At the serving shape (4 x 4096 steps, 48 heads of P = 64, N = 128,
// one group, bf16 x/B/C) the least work at Q = 64 is 32.5 GFLOP (C B^T once
// per group), 0.033 ms at the bf16 rate, against 225 MB of traffic, 0.067 ms.
//
// Two kernels; the wrapper picks one by type and length:
//
// * bfloat16 x/B/C with T >= 2 (a prefill) -> `ssd_chunk_mma_kernel`, on the
//   tensor cores (mma.sync m16n8k16 bf16 -> fp32, ldmatrix-fed).
//   - Grid: one block of 4 warps per (batch, head, slice of 32 head_dim
//     columns): 384 blocks at the serving shape.  A block holds 72.5 KB of
//     shared memory (at N = 128) and at most 170 registers a thread, so 3 fit
//     an SM: 396 at once, one wave.  To fit, C has one stage (the next chunk's
//     C is loaded once this chunk's C B^T and C h^T are done), and B, x, dt two.
//   - C B^T is recomputed by every block (per head and slice) on the tensor
//     cores instead of once per (batch, group, chunk): sharing it would take a
//     second pass and a round trip of the (Q x Q) tiles through device memory,
//     while recomputing costs 2 x 384 x 64 x 64 x 64 x 128 = 25.8 GFLOP at the
//     serving shape, ~0.03 ms at the bf16 peak.  Only the tiles on or below
//     the diagonal are computed.
//   - Warp w owns rows t in [16 w, 16 w + 16) of C B^T, M and Y, and a 16 x 64
//     tile of the state: rows p in [16 (w % 2), +16), columns n in
//     [64 (w / 2), +64), carried in fp32 registers from chunk to chunk and
//     written to h_last in fp32 at the end.
//   - Per chunk, two barriers: (1) the chunk is in; C B^T from bf16 C and B as
//     given (exact products, fp32 sums) and Z = C h^T from a bf16 copy of the
//     state taken once per chunk; warp 0 scans L meanwhile.  (2) M is formed
//     in fp32 from C B^T as a select and used as the A operand straight from
//     those registers, Y = M X, y = Y + exp(L_t) Z + d_skip x; then the state
//     update (X w)^T B, w = dt exp(L_last - L), with X w formed in fp32 in the
//     A-fragment registers (the plain version also scales x, not B).
//   - Rounding points.  The Mamba-2 authors' GPU kernels cast M, the state
//     copy and the scaled operand of the state update to the input type (bf16)
//     before their products.  Here the state copy is one bf16 term as theirs,
//     but M and X w are carried as two bf16 terms each, hi = bf16(v) and lo =
//     bf16(v - hi), two products instead of one (the inputs C, B and x are
//     bf16 already and stay one term): with the scaled operand rounded once,
//     h_last misses its 1e-4 (1 + |h|) check by ~40x (the plain version with
//     that rounding emulated, on a CPU), and rounding M once is what moves a
//     served model's logits most (the same emulation through a smoke model).
//   - Loads: the next chunk's x, B, dt (16-byte and 4-byte cp.async) go into
//     the second of two stages while the current chunk computes, its C after
//     the first barrier; rows padded by 8 bf16 so ldmatrix is free of bank
//     conflicts.  The model hands strided views of its conv output (rows of
//     3,328 bf16, x / B / C at byte offsets 0 / 6,144 / 6,400, all 16-byte
//     aligned).  Rows whose start is not 16-byte aligned are loaded by a
//     slower path inside the same kernel, element by element.
//
// * float32, and a bf16 decode step (T = 1) -> `ssd_chunk_kernel<T>`, on the
//   CUDA cores: one block per (batch, head), fp32 FMAs register-tiled from
//   float4 shared-memory reads (each of 256 threads a 4 x 4 tile of M and Y
//   and a 4 x 8 tile of h'), x, B, C converted to fp32 in shared memory, rows
//   padded by 4 floats; its loops stop at the chunk's valid rows and its
//   buffers are sized to min(Q, T) rows, so a decode launch needs ~35 KB.  The
//   float32 checks (1e-4 against the plain version, 5e-5 for the served model)
//   need fp32 products.  A decode step is host-bound: its 13.9 us against a
//   3.8 us bound is left to a later PR.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "sm90_mma.cuh"

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

// what both kernels take: whole groups, head_dim <= MAXP, a state <= MAXN
// that is a multiple of 4
inline bool shape_ok(int h, int g, int p, int n) {
  return g > 0 && h % g == 0 && p > 0 && p <= MAXP && n > 0 && n <= MAXN && n % 4 == 0;
}

template <typename T>
int launch(const void* x, const float* dt, const float* a_log, const void* bm,
           const void* cm, const float* d_skip, const float* h0, void* y,
           float* h_last, long long x_sb, long long x_st, long long x_sh,
           long long b_sb, long long b_st, long long b_sg, long long c_sb,
           long long c_st, long long c_sg, int b, int t, int h, int g, int p,
           int n, void* stream) {
  if (b <= 0 || t <= 0 || h <= 0) return (int)cudaSuccess;
  if (!shape_ok(h, g, p, n)) return (int)cudaErrorInvalidValue;
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

// ---------------------------------------------------------------- bf16 prefill, tensor cores
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int PS = 32;         // head_dim columns per block
constexpr int LDX = PS + 8;    // x rows in shared memory (bf16)
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ inline int pad16(int n) { return (n + 15) & ~15; }

// one stage of B (Q x ldn bf16), x (Q x LDX bf16) and dt (Q fp32)
__host__ __device__ inline size_t stage_bytes(int ldn) {
  return sizeof(bf16) * ((size_t)Q * ldn + (size_t)Q * LDX) + sizeof(float) * Q;
}

// C (Q x ldn bf16), two stages, the state copy (PS x ldn bf16), L, exp(L), w, exp(L_last)
__host__ __device__ inline size_t smem_bytes(int n) {
  const int ldn = pad16(n) + 8;
  return sizeof(bf16) * (size_t)Q * ldn + 2 * stage_bytes(ldn) +
         sizeof(bf16) * (size_t)PS * ldn + sizeof(float) * (3 * Q + 4);
}

// rows [c0, c0 + Q) of a (T, cols) slice into shared memory (stride ld):
// zeros past T; columns past `cols` are left as they are (zeros from the first pass)
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* src, long long st,
                                          int c0, int rows, int cols, bool aligned) {
  if (aligned) {
    const int cpr = cols / 8;  // 16-byte chunks per row
    for (int i = threadIdx.x; i < Q * cpr; i += THREADS) {
      const int r = i / cpr, c = i - r * cpr;
      const bool ok = r < rows;
      sm90::cp_async16(sm90::smem_addr(dst + r * ld + 8 * c),
                       ok ? src + (c0 + r) * st + 8 * c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < Q * cols; i += THREADS) {
      const int r = i / cols, c = i - r * cols;
      dst[r * ld + c] = r < rows ? src[(c0 + r) * st + c] : __float2bfloat16(0.f);
    }
  }
}

// the state tile of this warp (16 x 64 fp32 in registers) rounded to bf16
__device__ __forceinline__ void store_state(bf16* sH, int ldn, const float (&hacc)[8][4], int hp0,
                                            int hn0, int n16, int lane) {
  const int row = hp0 + (lane >> 2), col = hn0 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (hn0 + 8 * j < n16) {
      *reinterpret_cast<uint32_t*>(sH + row * ldn + col + 8 * j) =
          sm90::pack_bf16(hacc[j][0], hacc[j][1]);
      *reinterpret_cast<uint32_t*>(sH + (row + 8) * ldn + col + 8 * j) =
          sm90::pack_bf16(hacc[j][2], hacc[j][3]);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 3) ssd_chunk_mma_kernel(const Params prm, int aligned) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = prm.n, P = prm.p, n16 = pad16(N), ldn = n16 + 8, nkn = n16 / 16;
  const size_t sbytes = stage_bytes(ldn);
  bf16* sC = reinterpret_cast<bf16*>(smem);                       // one stage
  unsigned char* stages = smem + sizeof(bf16) * Q * ldn;          // two stages of B, x, dt
  bf16* sH = reinterpret_cast<bf16*>(stages + 2 * sbytes);        // state copy
  float* sL = reinterpret_cast<float*>(sH + PS * ldn);            // L_t
  float* sEL = sL + Q;                                            // exp(L_t)
  float* sW = sEL + Q;                                            // dt_s exp(L_last - L_s)
  float* sELast = sW + Q;                                         // exp(L_last)

  const int p0 = blockIdx.x * PS, hh = blockIdx.y, bb = blockIdx.z;
  const int psv = min(PS, P - p0);  // this block's valid columns
  const int grp = hh / (prm.h / prm.g);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g4 = lane >> 2, c2 = 2 * (lane & 3), mi = lane >> 3;
  const float a = -expf(prm.a_log[hh]);
  const bf16* x = static_cast<const bf16*>(prm.x) + bb * prm.x_sb + hh * prm.x_sh + p0;
  const bf16* bm = static_cast<const bf16*>(prm.bm) + bb * prm.b_sb + grp * prm.b_sg;
  const bf16* cm = static_cast<const bf16*>(prm.cm) + bb * prm.c_sb + grp * prm.c_sg;
  const float* dt = prm.dt + (long long)bb * prm.t * prm.h + hh;  // stride h
  bf16* y = static_cast<bf16*>(prm.y) + ((long long)bb * prm.t * prm.h + hh) * P + p0;
  const long long y_st = (long long)prm.h * P;
  const long long hoff = ((long long)bb * prm.h + hh) * P * N;
  const bool skip = prm.d_skip != nullptr;
  const float dskip = skip ? prm.d_skip[hh] : 0.f;

  // B, x and dt of the chunk at c0 into stage st
  auto load_bx = [&](int c0, int st) {
    unsigned char* base = stages + st * sbytes;
    bf16* sB = reinterpret_cast<bf16*>(base);
    bf16* sX = sB + Q * ldn;
    float* sDt = reinterpret_cast<float*>(sX + Q * LDX);
    const int rows = min(Q, prm.t - c0);
    load_rows(sB, ldn, bm, prm.b_st, c0, rows, N, aligned);
    load_rows(sX, LDX, x, prm.x_st, c0, rows, psv, aligned);
    for (int i = threadIdx.x; i < Q; i += THREADS)
      sm90::cp_async4(sm90::smem_addr(sDt + i), i < rows ? dt + (long long)(c0 + i) * prm.h : dt,
                      i < rows);
  };

  {  // zeros everywhere once: padding columns are never written again
    const int n16b = (int)(smem_bytes(N) / 16);
    for (int i = threadIdx.x; i < n16b; i += THREADS)
      reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  load_rows(sC, ldn, cm, prm.c_st, 0, min(Q, prm.t), N, aligned);
  load_bx(0, 0);
  sm90::cp_async_commit();

  // the state tile of this warp: rows p in [hp0, hp0 + 16), columns n in [hn0, hn0 + 64)
  const int hp0 = 16 * (warp & 1), hn0 = 64 * (warp >> 1);
  const bool has_state = hn0 < n16;
  float hacc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int pr = hp0 + g4 + 8 * (e >> 1), n = hn0 + 8 * j + c2 + (e & 1);
      hacc[j][e] = prm.h0 != nullptr && pr < psv && n < N ? prm.h0[hoff + (p0 + pr) * N + n] : 0.f;
    }
  if (has_state) store_state(sH, ldn, hacc, hp0, hn0, n16, lane);

  const int t0 = 16 * warp + g4;  // this thread's rows of M and Y: t0 and t0 + 8
  for (int c0 = 0; c0 < prm.t; c0 += Q) {
    const int st = (c0 / Q) & 1;
    const int valid = min(Q, prm.t - c0);
    const bool more = c0 + Q < prm.t;
    sm90::cp_async_wait_all();
    __syncthreads();  // chunk c0 is in; every warp is done with the previous chunk
    if (more) load_bx(c0 + Q, st ^ 1);
    sm90::cp_async_commit();
    const bf16* cB = reinterpret_cast<const bf16*>(stages + st * sbytes);
    const bf16* cX = cB + Q * ldn;
    const float* cDt = reinterpret_cast<const float*>(cX + Q * LDX);

    // ---- L = cumsum(dt A): warp 0, two steps per lane, a shuffle scan
    if (warp == 0) {
      const float a0 = cDt[2 * lane] * a, a1 = cDt[2 * lane + 1] * a;
      float incl = a0 + a1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
      const float l0 = excl + a0, l1 = l0 + a1;
      const int last = valid - 1;
      const float llast = __shfl_sync(0xffffffffu, (last & 1) ? l1 : l0, last >> 1);
      sL[2 * lane] = l0;
      sL[2 * lane + 1] = l1;
      sEL[2 * lane] = expf(l0);
      sEL[2 * lane + 1] = expf(l1);
      sW[2 * lane] = cDt[2 * lane] * expf(llast - l0);
      sW[2 * lane + 1] = cDt[2 * lane + 1] * expf(llast - l1);
      if (lane == 0) *sELast = expf(llast);
    }

    // ---- C B^T (columns s <= 16 warp + 15) and Z = C h^T for this warp's rows
    const bool active = 16 * warp < valid;
    float cb[8][4], zacc[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) cb[j][0] = cb[j][1] = cb[j][2] = cb[j][3] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) zacc[j][0] = zacc[j][1] = zacc[j][2] = zacc[j][3] = 0.f;
    if (active) {
#pragma unroll
      for (int kk = 0; kk < MAXN / 16; ++kk) {
        if (kk < nkn) {
          // every fragment of the step first, then its products
          uint32_t af[4], bf[4][4], hf[PS / 16][4];
          sm90::ldsm_x4(af, sm90::smem_addr(sC + (16 * warp + (lane & 15)) * ldn + 16 * kk +
                                            (lane >> 4) * 8));
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            if (jj <= warp)
              sm90::ldsm_x4(bf[jj], sm90::smem_addr(cB + (16 * jj + (mi >> 1) * 8 + (lane & 7)) *
                                                    ldn + 16 * kk + (mi & 1) * 8));
#pragma unroll
          for (int pp = 0; pp < PS / 16; ++pp)
            sm90::ldsm_x4(hf[pp], sm90::smem_addr(sH + (16 * pp + (mi >> 1) * 8 + (lane & 7)) *
                                                      ldn + 16 * kk + (mi & 1) * 8));
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            if (jj <= warp) {
              sm90::mma_bf16(cb[2 * jj], af, bf[jj][0], bf[jj][1]);
              sm90::mma_bf16(cb[2 * jj + 1], af, bf[jj][2], bf[jj][3]);
            }
          }
#pragma unroll
          for (int pp = 0; pp < PS / 16; ++pp) {
            sm90::mma_bf16(zacc[2 * pp], af, hf[pp][0], hf[pp][1]);
            sm90::mma_bf16(zacc[2 * pp + 1], af, hf[pp][2], hf[pp][3]);
          }
        }
      }
    }
    __syncthreads();  // L, exp(L), w are in; C and the state copy are no longer read
    if (more) load_rows(sC, ldn, cm, prm.c_st, c0 + Q, min(Q, prm.t - c0 - Q), N, aligned);
    sm90::cp_async_commit();

    // ---- Y = M X for rows t0, t0 + 8 (columns p in 4 tiles of 8), then y
    if (active) {
      float yacc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) yacc[j][0] = yacc[j][1] = yacc[j][2] = yacc[j][3] = 0.f;
      const float lt[2] = {sL[t0], sL[t0 + 8]};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk <= warp) {
          // x fragments first, then M for s in [16 kk, 16 kk + 16) as hi + lo
          // A fragments, then the products
          uint32_t mh[4], ml[4];
          uint32_t xf[PS / 16][4];
#pragma unroll
          for (int pp = 0; pp < PS / 16; ++pp)
            sm90::ldsm_x4_t(xf[pp], sm90::smem_addr(cX + (16 * kk + (mi & 1) * 8 + (lane & 7)) *
                                                    LDX + 16 * pp + (mi >> 1) * 8));
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int j = 2 * kk + half, s = 8 * j + c2;
            const float ls[2] = {sL[s], sL[s + 1]}, ds[2] = {cDt[s], cDt[s + 1]};
            float m[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int t = t0 + 8 * (e >> 1), se = s + (e & 1);
              m[e] = se <= t ? cb[j][e] * exp2f((lt[e >> 1] - ls[e & 1]) * LOG2E) * ds[e & 1]
                             : 0.f;
            }
            sm90::split_bf16(m[0], m[1], mh[2 * half], ml[2 * half]);
            sm90::split_bf16(m[2], m[3], mh[2 * half + 1], ml[2 * half + 1]);
          }
#pragma unroll
          for (int pp = 0; pp < PS / 16; ++pp) {
            sm90::mma_bf16(yacc[2 * pp], mh, xf[pp][0], xf[pp][1]);
            sm90::mma_bf16(yacc[2 * pp], ml, xf[pp][0], xf[pp][1]);
            sm90::mma_bf16(yacc[2 * pp + 1], mh, xf[pp][2], xf[pp][3]);
            sm90::mma_bf16(yacc[2 * pp + 1], ml, xf[pp][2], xf[pp][3]);
          }
        }
      }
      // y = Y + exp(L_t) Z + d_skip x, rounded once
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int t = t0 + 8 * i, pc = 8 * j + c2;
          if (t >= valid || pc >= psv) continue;
          const float el = sEL[t];
          float v0 = yacc[j][2 * i] + el * zacc[j][2 * i];
          float v1 = yacc[j][2 * i + 1] + el * zacc[j][2 * i + 1];
          if (skip) {
            const float2 xv =
                sm90::unpack_bf16(*reinterpret_cast<const uint32_t*>(cX + t * LDX + pc));
            v0 += dskip * xv.x;
            v1 += dskip * xv.y;
          }
          bf16* yr = y + (c0 + t) * y_st + pc;
          if (pc + 1 < psv && (P & 1) == 0) {
            *reinterpret_cast<uint32_t*>(yr) = sm90::pack_bf16(v0, v1);
          } else {
            yr[0] = __float2bfloat16(v0);
            if (pc + 1 < psv) yr[1] = __float2bfloat16(v1);
          }
        }
    }

    // ---- h' = exp(L_last) h + (X w)^T B, X w as hi + lo in the A fragments
    if (has_state) {
      const float el = *sELast;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) hacc[j][e] *= el;
      const int ksteps = (valid + 15) / 16;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk < ksteps) {
          uint32_t xa[4], ah[4], al[4], bf[4][4];
          sm90::ldsm_x4_t(xa, sm90::smem_addr(cX + (16 * kk + (mi >> 1) * 8 + (lane & 7)) * LDX +
                                              hp0 + (mi & 1) * 8));
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            if (hn0 + 16 * jj < n16)
              sm90::ldsm_x4_t(bf[jj], sm90::smem_addr(cB + (16 * kk + (mi & 1) * 8 + (lane & 7)) *
                                                      ldn + hn0 + 16 * jj + (mi >> 1) * 8));
          const int s0 = 16 * kk + c2;
          const float w[4] = {sW[s0], sW[s0 + 1], sW[s0 + 8], sW[s0 + 9]};
#pragma unroll
          for (int r = 0; r < 4; ++r) {  // r < 2: steps s0, s0 + 1; r >= 2: s0 + 8, s0 + 9
            const float2 xv = sm90::unpack_bf16(xa[r]);
            sm90::split_bf16(xv.x * w[2 * (r >> 1)], xv.y * w[2 * (r >> 1) + 1], ah[r], al[r]);
          }
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            if (hn0 + 16 * jj < n16) {
              sm90::mma_bf16(hacc[2 * jj], ah, bf[jj][0], bf[jj][1]);
              sm90::mma_bf16(hacc[2 * jj], al, bf[jj][0], bf[jj][1]);
              sm90::mma_bf16(hacc[2 * jj + 1], ah, bf[jj][2], bf[jj][3]);
              sm90::mma_bf16(hacc[2 * jj + 1], al, bf[jj][2], bf[jj][3]);
            }
          }
        }
      }
      store_state(sH, ldn, hacc, hp0, hn0, n16, lane);  // read after the next chunk's barrier
    }
  }

  if (has_state) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int pr = hp0 + g4 + 8 * i, n = hn0 + 8 * j + c2;
        if (pr < psv && n < N)  // N is a multiple of 4: n + 1 < N too
          *reinterpret_cast<float2*>(prm.h_last + hoff + (p0 + pr) * N + n) =
              make_float2(hacc[j][2 * i], hacc[j][2 * i + 1]);
      }
  }
}

inline bool stride_ok(long long stride, int extent) { return extent <= 1 || stride % 8 == 0; }

int launch_mma(const Params& prm, int b, void* stream) {
  const size_t smem = smem_bytes(prm.n);
  cudaError_t e = cudaFuncSetAttribute(ssd_chunk_mma_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(ssd_chunk_mma_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  // 16-byte cp.async needs every row start 16-byte aligned
  const bool aligned =
      prm.p % 8 == 0 && prm.n % 8 == 0 &&
      ((reinterpret_cast<uintptr_t>(prm.x) | reinterpret_cast<uintptr_t>(prm.bm) |
        reinterpret_cast<uintptr_t>(prm.cm)) & 15) == 0 &&
      stride_ok(prm.x_sb, b) && stride_ok(prm.x_st, prm.t) && stride_ok(prm.x_sh, prm.h) &&
      stride_ok(prm.b_sb, b) && stride_ok(prm.b_st, prm.t) && stride_ok(prm.b_sg, prm.g) &&
      stride_ok(prm.c_sb, b) && stride_ok(prm.c_st, prm.t) && stride_ok(prm.c_sg, prm.g);
  dim3 grid((prm.p + PS - 1) / PS, prm.h, b);
  ssd_chunk_mma_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      prm, aligned ? 1 : 0);
  return (int)cudaGetLastError();
}

}  // namespace tc

// bf16 x/B/C through the tensor cores (the wrapper sends T >= 2 here)
int launch_bf16_mma(const void* x, const float* dt, const float* a_log, const void* bm,
                    const void* cm, const float* d_skip, const float* h0, void* y,
                    float* h_last, long long x_sb, long long x_st, long long x_sh,
                    long long b_sb, long long b_st, long long b_sg, long long c_sb,
                    long long c_st, long long c_sg, int b, int t, int h, int g, int p,
                    int n, void* stream) {
  if (b <= 0 || t <= 0 || h <= 0) return (int)cudaSuccess;
  if (!shape_ok(h, g, p, n)) return (int)cudaErrorInvalidValue;
  Params prm{x, dt, a_log, bm, cm, d_skip, h0, y, h_last, x_sb, x_st, x_sh,
             b_sb, b_st, b_sg, c_sb, c_st, c_sg, t, h, g, p, n, Q};
  return tc::launch_mma(prm, b, stream);
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

// a decode step (T = 1): the CUDA-core kernel
int ssd_chunked_bf16(SSD_ARGS) { return launch<__nv_bfloat16>(SSD_PASS); }

int ssd_chunked_bf16_mma(SSD_ARGS) { return launch_bf16_mma(SSD_PASS); }

}  // extern "C"
