// The backward of the Mamba-2 chunked SSD (K4), for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference differentiates through
// `ref.ssd_chunked_reference` (src/repro/kernels/ref.py:205, a lax.scan over
// chunks) with XLA's autodiff; it computes the gradient of the function the
// TPU kernel `ssd_pallas` (src/repro/kernels/ssd.py:75) computes.  The plain
// version, `ssd_chunked_bwd_torch` in ../ssd.py, writes the same math as a
// loop over chunks and is the card's oracle.
//
// Per (batch, head) and chunk of Q = 64 steps, with l_t = dt_t a, a =
// -exp(a_log), L = cumsum(l) inside the chunk, the chunk's incoming state H
// (P x N), the gradient dH' of its outgoing state, E[t, s] = exp(L_t - L_s)
// for s <= t (else 0), F_s = exp(L_last - L_s), W_s = dt_s F_s, CB = C B^T,
// DX[t, s] = dy_t . x_s, M = CB E dt_s, S = E dt_s DX, G = CB E DX dt_s,
// V_s = dH' B_s and Z_t = H C_t:
//
//   dx_s  = sum_t M[t, s] dy_t + W_s V_s + D dy_s
//   dB_s  = sum_t S[t, s] C_t + W_s dH'^T x_s            (per head, then summed)
//   dC_t  = sum_s S[t, s] B_s + exp(L_t) H^T dy_t         (per head, then summed)
//   dl_u  = sum_{s < u <= t} G[t, s] + sum_{t >= u} exp(L_t) dy_t . Z_t
//           + sum_{s < u} W_s x_s . V_s + exp(L_last) <dH', H>
//   ddt_s = sum_t CB E DX [t, s] + F_s x_s . V_s + dl_s a
//   da    = sum dl_s dt_s,  da_log = da a,  dD = sum_t dy_t . x_t
//   dH    = exp(L_last) dH' + sum_t exp(L_t) dy_t C_t^T   (the chunk before's dH')
//
// dl_u sums exactly the terms l_u moves (the pairs that straddle u, the
// outputs at or after u, the state-update weights before u), so no term is
// added and then taken away again: in float32 that keeps da_log's error near
// the reference's own (a difference of row and column sums of G lost ~10x).
// Every exp is of an argument <= 0: E is evaluated only for s <= t.
//
// Every sum runs in a fixed order (no atomics: two calls on the same inputs
// give the same bits).  Two sets of passes:
//
// bf16 x / B / C / dy, any T (namespace `tc`, mma.sync m16n8k16 through
// sm90_mma.cuh, bf16 products with fp32 sums; a chunk shorter than Q, down to
// one step, pads its rows with dt = 0 and zero x / dy / B / C, so T = 1 is
// one chunk of one valid row, as the last chunk of T = 4097 is):
//
// * `ssd_bwd_states_mma_kernel` - per (32 x 64 state tile, direction, head)
//   one block walks the chunks: direction 0 forward from h0, writing each
//   chunk's incoming state; direction 1 backward from dh_last, writing each
//   chunk's dH' and ending with dh0.  Both are the forward tensor-core
//   kernel's update (X w, or dy exp(L), as hi + lo A fragments; B or C one
//   term; the state in fp32 registers).  Its loads come two chunks ahead
//   through a three-stage cp.async ring, off the chunk-to-chunk chain.
//   Scratch: two (B, H, chunks, 2, P, N) hi + lo bf16 arrays, the bytes of
//   fp32 (100 MB each at 1 x 4096 x 48 x 64 x 128).  384 blocks, 4 an SM.
// * `ssd_bwd_chunk_mma_kernel` - per (chunk, head): dx, ddt and the
//   per-chunk da / dD partials; 3,072 blocks of 8 warps, 105 KB of shared
//   memory, 2 an SM.
// * `ssd_bwd_dbdc_mma_kernel` - per (chunk, group, 32 state columns): dB and
//   dC summed over the group's heads in registers, in head order, and
//   rounded once; 256 blocks of 8 warps, 2 an SM.  No per-head partials.
// * `ssd_bwd_sum_heads_kernel` - da_log and dD over (batch, chunk) in order.
//
// float32: `ssd_bwd_states_kernel` (fp32 FMAs, 16
// state rows a block, the next chunk's rows prefetched into registers),
// `ssd_bwd_chunk_kernel` (x, dy, B, C, H, dH', M, S, G in fp32 shared
// memory, 213 KB, one block an SM; per-head dB / dC rows (B, T, H, N) fp32),
// `ssd_bwd_sum_bc_kernel` (dB / dC summed over the heads of each group in
// head order, rounded once) and `ssd_bwd_sum_heads_kernel`.  The 1e-4
// float32 gate needs fp32 products.
//
// What bounds it on this card: operations, in principle.  At the training
// shape the least work is ~29 GFLOP, 0.03 ms at the bf16 rate, against ~81
// MB of inputs and outputs, 0.024 ms.  In practice the scratch and the
// latency bind.  The CUDA-core design moved ~0.8 GB of scratch, the
// per-head dB / dC partials half of it, and ran its products at the fp32
// rate.  The tensor-core passes move ~0.6 GB: the states are written once
// and read twice (by the chunk pass and the dB / dC pass), and the partials
// are gone.  The rest is latency: each
// pass is a chain of loads, products and barriers, so each keeps 16 warps an
// SM (registers <= 128).  The chunk pass hides the H and dH' loads behind
// the products that need neither, the state pass keeps its loads two chunks
// ahead, and the dB / dC pass keeps the next head's tiles in flight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "sm90_mma.cuh"

namespace {

constexpr int Q = 64;         // time steps per chunk (the forward's)
constexpr int MAXP = 64;      // head_dim
constexpr int MAXN = 128;     // state
constexpr int THREADS = 256;  // a 16 x 16 grid: (ty, tx)
constexpr int ROWS = 16;      // state rows per block of the state pass
// shared-memory leading dimensions: odd, so a column walk is conflict-free
constexpr int LDP = MAXP + 1;
constexpr int LDN = MAXN + 1;
constexpr int LDQ = Q + 1;

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
  const void* x;        // (B, T, H, P), strides x_sb, x_st, x_sh, unit along P
  const float* dt;      // (B, T, H) contiguous
  const float* a_log;   // (H,)
  const void* bm;       // (B, T, G, N), strides b_sb, b_st, b_sg, unit along N
  const void* cm;       // (B, T, G, N), strides c_sb, c_st, c_sg, unit along N
  const float* d_skip;  // (H,) or null
  const float* h0;      // (B, H, P, N) or null (zeros)
  const void* dy;       // (B, T, H, P) contiguous, x's type
  const float* dh_last; // (B, H, P, N) or null (zeros)
  void* states;         // each chunk's incoming state: fp32 (B, H, NC, P, N), or in the
                        // tensor-core passes hi + lo bf16 (B, H, NC, 2, P, N), the same bytes
  void* dstates;        // the gradient of each chunk's outgoing state, the same layouts
  float* dh0;           // (B, H, P, N) or null
  void* dx;             // (B, T, H, P), x's type
  float* ddt;           // (B, T, H)
  float* db_part;       // (B, T, H, N): dB of each head
  float* dc_part;       // (B, T, H, N): dC of each head
  float* head_part;     // (2, B, H, NC): da and dD of each chunk
  long long x_sb, x_st, x_sh, b_sb, b_st, b_sg, c_sb, c_st, c_sg;
  int b, t, h, g, p, n, nc;
};

// L = cumsum(dt a) over the chunk's Q steps by warp 0, two steps per lane, as
// the forward kernels scan it; rows past `valid` have dt = 0.  Writes L,
// exp(L), exp(L_last - L) and returns exp(L_last) through *elast.
__device__ __forceinline__ void scan_chunk(const float* sDt, float a, int valid, float* sL,
                                           float* sEL, float* sF, float* elast) {
  const int lane = threadIdx.x;
  const float a0 = sDt[2 * lane] * a, a1 = sDt[2 * lane + 1] * a;
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
  if (sL != nullptr) {
    sL[2 * lane] = l0;
    sL[2 * lane + 1] = l1;
  }
  sEL[2 * lane] = expf(l0);
  sEL[2 * lane + 1] = expf(l1);
  sF[2 * lane] = expf(llast - l0);
  sF[2 * lane + 1] = expf(llast - l1);
  if (lane == 0) *elast = expf(llast);
}

// ---------------------------------------------------------------- pass 1: the states
// Block (2 x slice + dir, head, batch): dir 0 walks the chunks forward from h0
// and writes each chunk's incoming state; dir 1 walks them backward from
// dh_last, writes each chunk's dH' and ends with dh0.  The two walks are
// independent, so they run side by side.  Each is a dependent chain of
// chunks: the next chunk's rows are loaded into registers while this one's
// scan and update run.
// Three blocks an SM (at most 85 registers a thread): 384 blocks at the
// training shape are then one wave; uncapped, ptxas took 255 registers and
// one block an SM, and the pass ran in three waves (1.49 ms against 0.96 ms
// capped, on an H100 at the training shape).
template <typename T>
__global__ void __launch_bounds__(THREADS, 3) ssd_bwd_states_kernel(const Params prm) {
  constexpr int NV = Q * ROWS / THREADS, NK = Q * MAXN / THREADS;
  __shared__ float sV[Q * ROWS];   // x (dir 0) or dy (dir 1) of this block's rows
  __shared__ __align__(16) float sK[Q * MAXN];   // B (dir 0) or C (dir 1)
  __shared__ float sDt[Q], sEL[Q], sF[Q], sW[Q];
  __shared__ float sELast;

  const int dir = blockIdx.x & 1, p0 = (blockIdx.x >> 1) * ROWS;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int P = prm.p, N = prm.n, H = prm.h;
  const int grp = hh / (H / prm.g);
  const int tid = threadIdx.x, row = tid / 16, tx = tid % 16;
  const int pr = p0 + row;                  // this thread's state row
  const bool row_ok = pr < P;
  const float a = -expf(prm.a_log[hh]);
  // dir 0: x rows (strided) and B; dir 1: dy rows (contiguous) and C
  const T* v = dir == 0
      ? static_cast<const T*>(prm.x) + bb * prm.x_sb + hh * prm.x_sh
      : static_cast<const T*>(prm.dy) + ((long long)bb * prm.t * H + hh) * P;
  const long long v_st = dir == 0 ? prm.x_st : (long long)H * P;
  const T* k = dir == 0 ? static_cast<const T*>(prm.bm) + bb * prm.b_sb + grp * prm.b_sg
                        : static_cast<const T*>(prm.cm) + bb * prm.c_sb + grp * prm.c_sg;
  const long long k_st = dir == 0 ? prm.b_st : prm.c_st;
  const float* dt = prm.dt + (long long)bb * prm.t * H + hh;   // stride H
  const float* init = dir == 0 ? prm.h0 : prm.dh_last;
  float* out = static_cast<float*>(dir == 0 ? prm.states : prm.dstates);
  const long long hoff = ((long long)bb * H + hh) * P * N;
  const long long soff = ((long long)bb * H + hh) * prm.nc * P * N;

  // this thread's state entries: row pr, columns 4 tx + 64 j + e (float4
  // reads of a row of B or C, conflict-free)
  float carry[MAXN / 64][4];
#pragma unroll
  for (int j = 0; j < MAXN / 64; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = 4 * tx + 64 * j + e;
      carry[j][e] = (init != nullptr && row_ok && n < N) ? init[hoff + (long long)pr * N + n]
                                                         : 0.f;
    }
  // chunk c's rows into registers (zeros past T, past P and past N)
  float rv[NV], rk[NK], rdt = 0.f;
  auto fetch = [&](int c) {
    const int c0 = c * Q, valid = min(Q, prm.t - c0);
    if (tid < Q) rdt = tid < valid ? dt[(long long)(c0 + tid) * H] : 0.f;
#pragma unroll
    for (int it = 0; it < NV; ++it) {
      const int e = tid + it * THREADS, s = e / ROWS, r = e % ROWS;
      rv[it] = (s < valid && p0 + r < P) ? to_f<T>(v[(c0 + s) * v_st + p0 + r]) : 0.f;
    }
#pragma unroll
    for (int it = 0; it < NK; ++it) {
      const int e = tid + it * THREADS, s = e / MAXN, kk = e % MAXN;
      rk[it] = (s < valid && kk < N) ? to_f<T>(k[(c0 + s) * k_st + kk]) : 0.f;
    }
  };
  fetch(dir == 0 ? 0 : prm.nc - 1);
  for (int step = 0; step < prm.nc; ++step) {
    const int c = dir == 0 ? step : prm.nc - 1 - step;
    const int valid = min(Q, prm.t - c * Q);
    if (row_ok) {
#pragma unroll
      for (int j = 0; j < MAXN / 64; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = 4 * tx + 64 * j + e;
          if (n < N) out[soff + ((long long)c * P + pr) * N + n] = carry[j][e];
        }
    }
    if (tid < Q) sDt[tid] = rdt;
#pragma unroll
    for (int it = 0; it < NV; ++it) sV[tid + it * THREADS] = rv[it];
#pragma unroll
    for (int it = 0; it < NK; ++it) sK[tid + it * THREADS] = rk[it];
    __syncthreads();
    if (step + 1 < prm.nc) fetch(dir == 0 ? c + 1 : c - 1);   // in flight during the update
    if (tid < 32) {
      scan_chunk(sDt, a, valid, nullptr, sEL, sF, &sELast);
      // each lane reads back the two steps it wrote
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = 2 * tid + i;
        sW[q] = dir == 0 ? sDt[q] * sF[q] : sEL[q];
      }
    }
    __syncthreads();
    // dir 0, the forward CUDA-core kernel's order: exp(L_last) h first, then
    // one fmaf per step of (x_s w_s) B_s, w_s = dt_s exp(L_last - L_s);
    // dir 1: dH = exp(L_last) dH' + sum_t (dy_t exp(L_t)) C_t^T
    const float el = sELast;
#pragma unroll
    for (int j = 0; j < MAXN / 64; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) carry[j][e] *= el;
#pragma unroll 4
    for (int s = 0; s < valid; ++s) {
      const float vw = sV[s * ROWS + row] * sW[s];
#pragma unroll
      for (int j = 0; j < MAXN / 64; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(sK + s * MAXN + 4 * tx + 64 * j);
        carry[j][0] = fmaf(vw, kv.x, carry[j][0]);
        carry[j][1] = fmaf(vw, kv.y, carry[j][1]);
        carry[j][2] = fmaf(vw, kv.z, carry[j][2]);
        carry[j][3] = fmaf(vw, kv.w, carry[j][3]);
      }
    }
    __syncthreads();   // before the next chunk overwrites the buffers
  }
  if (dir == 1 && prm.dh0 != nullptr && row_ok) {
#pragma unroll
    for (int j = 0; j < MAXN / 64; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 4 * tx + 64 * j + e;
        if (n < N) prm.dh0[hoff + (long long)pr * N + n] = carry[j][e];
      }
  }
}

// ---------------------------------------------------------------- pass 2: the chunks
// shared memory of one block, in floats
constexpr int SM_X = 0;                     // x       Q x LDP
constexpr int SM_DY = SM_X + Q * LDP;       // dy      Q x LDP
constexpr int SM_B = SM_DY + Q * LDP;       // B       Q x LDN
constexpr int SM_C = SM_B + Q * LDN;        // C       Q x LDN
constexpr int SM_H = SM_C + Q * LDN;        // H       MAXP x LDN
constexpr int SM_DH = SM_H + MAXP * LDN;    // dH'     MAXP x LDN
constexpr int SM_M = SM_DH + MAXP * LDN;    // M       Q x LDQ
constexpr int SM_S = SM_M + Q * LDQ;        // S       Q x LDQ
constexpr int SM_G = SM_S + Q * LDQ;        // CB E DX Q x LDQ, then G's row prefixes
constexpr int SM_VEC = SM_G + Q * LDQ;      // 8 vectors of Q
constexpr int SM_RED = SM_VEC + 8 * Q;      // THREADS
constexpr int SM_FLOATS = SM_RED + THREADS + 4;
constexpr size_t CHUNK_SMEM = sizeof(float) * SM_FLOATS;

// a block-wide sum of one value per thread, in a fixed order
__device__ __forceinline__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int half = THREADS / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) red[threadIdx.x] += red[threadIdx.x + half];
    __syncthreads();
  }
  const float out = red[0];
  __syncthreads();
  return out;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) ssd_bwd_chunk_kernel(const Params prm) {
  extern __shared__ float smem[];
  float* sX = smem + SM_X;
  float* sDY = smem + SM_DY;
  float* sB = smem + SM_B;
  float* sC = smem + SM_C;
  float* sH = smem + SM_H;
  float* sDH = smem + SM_DH;
  float* sM = smem + SM_M;
  float* sS = smem + SM_S;
  float* sG = smem + SM_G;
  float* sDt = smem + SM_VEC;     // dt_s
  float* sL = sDt + Q;            // L_t
  float* sEL = sL + Q;            // exp(L_t)
  float* sF = sEL + Q;            // exp(L_last - L_s)
  float* sXV = sF + Q;            // x_s . V_s
  float* sYZ = sXV + Q;           // exp(L_t) dy_t . Z_t
  float* sDiag = sYZ + Q;         // dy_t . x_t
  float* sDL = sDiag + Q;         // dl_s dt_s
  float* sRed = smem + SM_RED;
  float* sELast = sRed + THREADS;

  const int c = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int P = prm.p, N = prm.n, H = prm.h;
  const int c0 = c * Q, valid = min(Q, prm.t - c0);
  const int grp = hh / (H / prm.g);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float a = -expf(prm.a_log[hh]);
  const T* x = static_cast<const T*>(prm.x) + bb * prm.x_sb + hh * prm.x_sh;
  const long long yoff = ((long long)bb * prm.t * H + hh) * P;   // dy, dx: (B, T, H, P)
  const long long y_st = (long long)H * P;
  const T* dy = static_cast<const T*>(prm.dy) + yoff;
  const T* bm = static_cast<const T*>(prm.bm) + bb * prm.b_sb + grp * prm.b_sg;
  const T* cm = static_cast<const T*>(prm.cm) + bb * prm.c_sb + grp * prm.c_sg;
  const float* dt = prm.dt + (long long)bb * prm.t * H + hh;     // stride H
  const long long soff = (((long long)bb * H + hh) * prm.nc + c) * P * N;
  const bool skip = prm.d_skip != nullptr;
  const float dskip = skip ? prm.d_skip[hh] : 0.f;

  // ---- the chunk into shared memory, fp32, zeros past T and past P / N
  if (tid < Q) sDt[tid] = tid < valid ? dt[(long long)(c0 + tid) * H] : 0.f;
#pragma unroll 8
  for (int it = 0; it < Q * MAXP / THREADS; ++it) {
    const int e = tid + it * THREADS, s = e / MAXP, k = e % MAXP;
    const bool ok = s < valid && k < P;
    sX[s * LDP + k] = ok ? to_f<T>(x[(c0 + s) * prm.x_st + k]) : 0.f;
    sDY[s * LDP + k] = ok ? to_f<T>(dy[(c0 + s) * y_st + k]) : 0.f;
  }
#pragma unroll 8
  for (int it = 0; it < Q * MAXN / THREADS; ++it) {
    const int e = tid + it * THREADS, s = e / MAXN, k = e % MAXN;
    const bool ok = s < valid && k < N;
    sB[s * LDN + k] = ok ? to_f<T>(bm[(c0 + s) * prm.b_st + k]) : 0.f;
    sC[s * LDN + k] = ok ? to_f<T>(cm[(c0 + s) * prm.c_st + k]) : 0.f;
  }
  float hh_part = 0.f;   // this thread's share of <dH', H>
#pragma unroll 8
  for (int it = 0; it < MAXP * MAXN / THREADS; ++it) {
    const int e = tid + it * THREADS, pp = e / MAXN, k = e % MAXN;
    const bool ok = pp < P && k < N;
    const float hv = ok ? static_cast<const float*>(prm.states)[soff + (long long)pp * N + k] : 0.f;
    const float dv = ok ? static_cast<const float*>(prm.dstates)[soff + (long long)pp * N + k] : 0.f;
    sH[pp * LDN + k] = hv;
    sDH[pp * LDN + k] = dv;
    hh_part = fmaf(dv, hv, hh_part);
  }
  __syncthreads();
  if (tid < 32) scan_chunk(sDt, a, valid, sL, sEL, sF, sELast);
  const float hdot = block_sum(hh_part, sRed);   // its barriers order the scan too

  // ---- CB = C B^T and DX = dy x^T: rows t = ty + 16 i, columns s = tx + 16 j;
  //      M, S and CB E DX for s <= t < valid (E evaluated only there), else 0
  {
    float cb[4][4] = {}, dx[4][4] = {};
    for (int k = 0; k < MAXN; ++k) {
      float cv[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        cv[i] = sC[(ty + 16 * i) * LDN + k];
        bv[i] = sB[(tx + 16 * i) * LDN + k];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) cb[i][j] = fmaf(cv[i], bv[j], cb[i][j]);
    }
    for (int k = 0; k < MAXP; ++k) {
      float yv[4], xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        yv[i] = sDY[(ty + 16 * i) * LDP + k];
        xv[i] = sX[(tx + 16 * i) * LDP + k];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dx[i][j] = fmaf(yv[i], xv[j], dx[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = tx + 16 * j;
        float m = 0.f, sv = 0.f, gd = 0.f;
        if (s <= t && t < valid) {   // select, never multiply by the mask
          const float e = expf(sL[t] - sL[s]);
          const float ce = cb[i][j] * e;
          m = ce * sDt[s];
          sv = e * sDt[s] * dx[i][j];
          gd = ce * dx[i][j];
        }
        sM[t * LDQ + s] = m;
        sS[t * LDQ + s] = sv;
        sG[t * LDQ + s] = gd;
        if (s == t) sDiag[t] = t < valid ? dx[i][j] : 0.f;
      }
    }
  }
  __syncthreads();

  // ---- (Q x P): V = B dH'^T, Z = C H^T and M^T dy; then dx, x.V and dy.Z by row
  {
    float v[4][4] = {}, z[4][4] = {}, md[4][4] = {};
    for (int k = 0; k < MAXN; ++k) {
      float bv[4], cv[4], dv[4], hv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        bv[i] = sB[(ty + 16 * i) * LDN + k];
        cv[i] = sC[(ty + 16 * i) * LDN + k];
        dv[i] = sDH[(tx + 16 * i) * LDN + k];
        hv[i] = sH[(tx + 16 * i) * LDN + k];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[i][j] = fmaf(bv[i], dv[j], v[i][j]);
          z[i][j] = fmaf(cv[i], hv[j], z[i][j]);
        }
    }
    for (int t = 0; t < valid; ++t) {
      float mv[4], yv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        mv[i] = sM[t * LDQ + ty + 16 * i];
        yv[i] = sDY[t * LDP + tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) md[i][j] = fmaf(mv[i], yv[j], md[i][j]);
    }
    T* dxo = static_cast<T*>(prm.dx) + yoff;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = ty + 16 * i;
      const float w = sDt[s] * sF[s];
      float xvs = 0.f, yzs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pp = tx + 16 * j;
        xvs = fmaf(sX[s * LDP + pp], v[i][j], xvs);
        yzs = fmaf(sDY[s * LDP + pp], z[i][j], yzs);
        if (s < valid && pp < P) {
          float d = md[i][j] + w * v[i][j];
          if (skip) d += dskip * sDY[s * LDP + pp];
          dxo[(c0 + s) * y_st + pp] = from_f<T>(d);
        }
      }
      // the 16 threads of a row are one half of a warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        xvs += __shfl_xor_sync(0xffffffffu, xvs, off);
        yzs += __shfl_xor_sync(0xffffffffu, yzs, off);
      }
      if (tx == 0) {
        sXV[s] = s < valid ? xvs : 0.f;
        sYZ[s] = s < valid ? sEL[s] * yzs : 0.f;
      }
    }
  }

  // ---- (Q x N), rows r = ty + 16 i, columns n = tx + 16 j: per-head dB, then dC
  {
    const long long poff = ((long long)bb * prm.t * H + hh) * N;   // (B, T, H, N)
    const long long p_st = (long long)H * N;
    float acc[4][8] = {}, acc2[4][8] = {};
    for (int t = 0; t < valid; ++t) {   // sum_t S[t, r] C_t
      float sv[4], cv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = sS[t * LDQ + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) cv[j] = sC[t * LDN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(sv[i], cv[j], acc[i][j]);
    }
    for (int k = 0; k < MAXP; ++k) {    // sum_p x_r[p] dH'[p]
      float xv[4], dv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = sX[(ty + 16 * i) * LDP + k];
#pragma unroll
      for (int j = 0; j < 8; ++j) dv[j] = sDH[k * LDN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc2[i][j] = fmaf(xv[i], dv[j], acc2[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const float w = sDt[r] * sF[r];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = tx + 16 * j;
        if (r < valid && n < N) prm.db_part[poff + (c0 + r) * p_st + n] = acc[i][j] + w * acc2[i][j];
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = acc2[i][j] = 0.f;
    for (int s = 0; s < valid; ++s) {   // sum_s S[r, s] B_s
      float sv[4], bv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = sS[(ty + 16 * i) * LDQ + s];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = sB[s * LDN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(sv[i], bv[j], acc[i][j]);
    }
    for (int k = 0; k < MAXP; ++k) {    // sum_p dy_r[p] H[p]
      float yv[4], hv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) yv[i] = sDY[(ty + 16 * i) * LDP + k];
#pragma unroll
      for (int j = 0; j < 8; ++j) hv[j] = sH[k * LDN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc2[i][j] = fmaf(yv[i], hv[j], acc2[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const float el = sEL[r];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = tx + 16 * j;
        if (r < valid && n < N) prm.dc_part[poff + (c0 + r) * p_st + n] = acc[i][j] + el * acc2[i][j];
      }
    }
  }
  __syncthreads();   // sXV, sYZ are in

  // ---- dl and ddt: thread u < Q owns step u
  float col = 0.f;   // sum_t CB E DX [t, u]
  if (tid < Q)
    for (int t = tid; t < valid; ++t) col += sG[t * LDQ + tid];
  __syncthreads();
  if (tid < Q) {     // row tid of G = (CB E DX) dt_s, as exclusive prefixes over s
    float run = 0.f;
    for (int s = 0; s < Q; ++s) {
      const float gv = sG[tid * LDQ + s] * sDt[s];
      sG[tid * LDQ + s] = run;
      run += gv;
    }
  }
  __syncthreads();
  if (tid < Q) {
    const int u = tid;
    float dl = 0.f;
    for (int t = u; t < valid; ++t) dl += sG[t * LDQ + u];       // the pairs s < u <= t
    for (int t = u; t < valid; ++t) dl += sYZ[t];                // y_t for t >= u
    for (int s = 0; s < u && s < valid; ++s) dl += sDt[s] * sF[s] * sXV[s];   // W_s, s < u
    dl += *sELast * hdot;                                        // exp(L_last) H
    if (u < valid) prm.ddt[(long long)(bb * prm.t + c0 + u) * H + hh] = col + sF[u] * sXV[u] + dl * a;
    sDL[u] = u < valid ? dl * sDt[u] : 0.f;
  }
  __syncthreads();
  if (tid == 0) {
    float da = 0.f, dd = 0.f;
    for (int u = 0; u < valid; ++u) {
      da += sDL[u];
      dd += sDiag[u];
    }
    const long long part = ((long long)bb * H + hh) * prm.nc + c;
    prm.head_part[part] = da;
    prm.head_part[(long long)prm.b * H * prm.nc + part] = dd;
  }
}

// ---------------------------------------------------------------- pass 3: the sums
// dB / dC of each group: its heads' rows summed in head order, rounded once
template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_bwd_sum_bc_kernel(const Params prm, T* db, T* dc) {
  const int R = prm.h / prm.g, N = prm.n;
  const long long total = (long long)prm.b * prm.t * prm.g * N;
  for (long long e = blockIdx.x * (long long)THREADS + threadIdx.x; e < total;
       e += (long long)gridDim.x * THREADS) {
    const int n = (int)(e % N);
    const long long bt_g = e / N;                 // (b t) g
    const int gi = (int)(bt_g % prm.g);
    const long long bt = bt_g / prm.g;
    const long long base = (bt * prm.h + (long long)gi * R) * N + n;
    float sb = 0.f, sc = 0.f;
    for (int r = 0; r < R; ++r) {
      sb += prm.db_part[base + (long long)r * N];
      sc += prm.dc_part[base + (long long)r * N];
    }
    db[e] = from_f<T>(sb);
    dc[e] = from_f<T>(sc);
  }
}

// da_log and dD of each head: the (batch, chunk) partials in order
__global__ void ssd_bwd_sum_heads_kernel(const Params prm, float* da_log, float* dd_skip) {
  const int hh = blockIdx.x * blockDim.x + threadIdx.x;
  if (hh >= prm.h) return;
  float da = 0.f, dd = 0.f;
  for (int bb = 0; bb < prm.b; ++bb)
    for (int c = 0; c < prm.nc; ++c) {
      const long long part = ((long long)bb * prm.h + hh) * prm.nc + c;
      da += prm.head_part[part];
      dd += prm.head_part[(long long)prm.b * prm.h * prm.nc + part];
    }
  da_log[hh] = da * -expf(prm.a_log[hh]);
  if (dd_skip != nullptr) dd_skip[hh] = dd;
}

// ---------------------------------------------------------------- bf16, tensor cores
// The same three passes for bf16 x / B / C / dy (every T), every product
// on the tensor cores (mma.sync m16n8k16, bf16 in, fp32 sums).  A bf16
// input is one exact term; an fp32 operand (the weights X w and dy exp(L) of
// the state walks, M, S, the states H and their gradients dH') is hi + lo
// bf16 (`split_bf16`, ~2^-16 relative), as the forward's tensor-core kernel
// takes M and X w.  The states and state gradients are kept as hi + lo bf16
// pairs, the bytes of the fp32 scratch.
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int WARPS = 4;
constexpr int TC_THREADS = 32 * WARPS;
constexpr int SROWS = 16;        // state rows (head_dim p) per warp of the state pass
constexpr int BROWS = 32;        // state rows and columns per block of the state pass
constexpr int BCOLS = 64;
constexpr int STAGES = 3;        // the state pass's cp.async ring: two chunks in flight
constexpr int LDV = BROWS + 8;   // x / dy rows of a stage (bf16; 80 B: ldmatrix conflict-free)
constexpr int LDK = BCOLS + 8;   // B / C rows of a stage (bf16)
constexpr int LDX = MAXP + 8;    // x, dy rows of the chunk pass (bf16)
constexpr int LDS = MAXN + 8;    // B, C and state rows (bf16)
constexpr int LDG = Q + 1;       // G and its row prefixes (fp32)

__host__ __device__ inline int pad16(int n) { return (n + 15) & ~15; }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// `span` rows of a (rows, cols) slice starting at row r0 into shared memory
// (stride ld): rows past `rows` are zeros, columns past `cols` are left as
// they are (zeros from the first fill).  16-byte cp.async when every row
// start is 16-byte aligned, else element by element (the model's strided
// views of its conv output may start anywhere).
// A power-of-two count of pieces a row (every row of the training shape)
// divides the block: each thread keeps one column and steps whole rows, with
// no division in the loop.
template <int NT = TC_THREADS>
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* src, long long st,
                                          int r0, int span, int rows, int cols, bool aligned) {
  if (aligned) {
    const int cpr = cols / 8;  // 16-byte pieces a row
    if ((cpr & (cpr - 1)) == 0 && cpr <= NT) {
      const int sh = __ffs(cpr) - 1, c = threadIdx.x & (cpr - 1), step = NT >> sh;
      for (int r = threadIdx.x >> sh; r < span; r += step) {
        const bool ok = r < rows;
        sm90::cp_async16(sm90::smem_addr(dst + r * ld + 8 * c),
                         ok ? src + (r0 + r) * st + 8 * c : src, ok);
      }
      return;
    }
    for (int i = threadIdx.x; i < span * cpr; i += NT) {
      const int r = i / cpr, c = i - r * cpr;
      const bool ok = r < rows;
      sm90::cp_async16(sm90::smem_addr(dst + r * ld + 8 * c),
                       ok ? src + (r0 + r) * st + 8 * c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < span * cols; i += NT) {
      const int r = i / cols, c = i - r * cols;
      dst[r * ld + c] = r < rows ? src[(r0 + r) * st + c] : __float2bfloat16(0.f);
    }
  }
}

// dt of a chunk's rows (stride H) by 4-byte cp.async, zeros past `rows`
template <int NT = TC_THREADS>
__device__ __forceinline__ void load_dt(float* dst, const float* dt, long long st, int c0,
                                        int rows) {
  for (int i = threadIdx.x; i < Q; i += NT)
    sm90::cp_async4(sm90::smem_addr(dst + i), i < rows ? dt + (long long)(c0 + i) * st : dt,
                    i < rows);
}

template <int NT = TC_THREADS>
__device__ __forceinline__ void zero_smem(unsigned char* smem, int bytes) {
  for (int i = threadIdx.x; i < bytes / 16; i += NT)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
}

// ------------------------------------------ pass 1: the states, on the tensor cores
// Block (2 x tile + dir, head, batch), a tile of 32 state rows x 64 state
// columns (4 warps of 16 x 32; B or C are read for 64 columns, x or dy for 32:
// 12 KB a chunk, where 16 rows x 128 columns read 19): dir 0 walks the chunks
// forward from h0 and writes each chunk's incoming state, dir 1 walks them
// backward from dh_last, writes each chunk's dH' and ends with dh0.  Both are
// the forward's update h' = exp(L_last) h + A^T K with A = X w (w_s = dt_s
// exp(L_last - L_s)), K = B for dir 0 and A = dy exp(L), K = C for dir 1: A
// as hi + lo, the state in fp32 registers.
// The chain from chunk to chunk holds no load: x or dy, B or C and dt come
// two chunks ahead through a ring of three cp.async stages, and every warp
// scans L itself (shuffles), so one barrier a chunk orders the ring.  Each
// chunk's state goes out through a staging tile of the warp's own, as 16-byte
// stores of 64-byte row pieces (a store of the fragments themselves writes 4
// bytes a lane on 8 rows, and those stores bound the pass).
constexpr int STAGE_BYTES = 2 * Q * LDV + 2 * Q * LDK + 4 * Q;
constexpr int LDW = 32 + 8;                              // a warp's staging rows (bf16)
constexpr int STATE_SMEM = STAGES * STAGE_BYTES + WARPS * 2 * 2 * SROWS * LDW;

__global__ void __launch_bounds__(TC_THREADS, 4) ssd_bwd_states_mma_kernel(const Params prm,
                                                                         int aligned) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = prm.p, N = prm.n, H = prm.h, n16 = pad16(N);
  const int ntiles = (N + BCOLS - 1) / BCOLS, tile = blockIdx.x >> 1;
  const int dir = blockIdx.x & 1, p0 = (tile / ntiles) * BROWS, nb = (tile % ntiles) * BCOLS;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int pcols = min(BROWS, P - p0), ncols = min(BCOLS, N - nb);  // this block's tile
  const int grp = hh / (H / prm.g);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pw = 16 * (warp & 1), psv = min(SROWS, P - p0 - pw);  // this warp's rows
  const int g4 = lane >> 2, c2 = 2 * (lane & 3), mi = lane >> 3;
  const float a = -expf(prm.a_log[hh]);
  const bf16* v = dir == 0
      ? static_cast<const bf16*>(prm.x) + bb * prm.x_sb + hh * prm.x_sh + p0
      : static_cast<const bf16*>(prm.dy) + ((long long)bb * prm.t * H + hh) * P + p0;
  const long long v_st = dir == 0 ? prm.x_st : (long long)H * P;
  const bf16* k = nb + (dir == 0
      ? static_cast<const bf16*>(prm.bm) + bb * prm.b_sb + grp * prm.b_sg
      : static_cast<const bf16*>(prm.cm) + bb * prm.c_sb + grp * prm.c_sg);
  const long long k_st = dir == 0 ? prm.b_st : prm.c_st;
  const float* dt = prm.dt + (long long)bb * prm.t * H + hh;  // stride H
  const float* init = dir == 0 ? prm.h0 : prm.dh_last;
  const long long hoff = ((long long)bb * H + hh) * P * N;
  bf16* out = static_cast<bf16*>(dir == 0 ? prm.states : prm.dstates) +
              ((long long)bb * H + hh) * prm.nc * 2 * P * N;

  zero_smem(smem, STATE_SMEM);
  __syncthreads();
  // the chunk of walk step `step` into stage step % STAGES (one commit group
  // a step, empty past the last chunk)
  auto load = [&](int step) {
    if (step < prm.nc) {
      const int c0 = (dir == 0 ? step : prm.nc - 1 - step) * Q, rows = min(Q, prm.t - c0);
      bf16* sV = reinterpret_cast<bf16*>(smem + (step % STAGES) * STAGE_BYTES);
      bf16* sK = sV + Q * LDV;
      load_rows(sV, LDV, v, v_st, c0, Q, rows, pcols, aligned);
      load_rows(sK, LDK, k, k_st, c0, Q, rows, ncols, aligned);
      load_dt(reinterpret_cast<float*>(sK + Q * LDK), dt, H, c0, rows);
    }
    sm90::cp_async_commit();
  };
  for (int s = 0; s < STAGES - 1; ++s) load(s);

  // this warp's state tile: rows p0 + pw + g4 (+ 8), columns n0 + 8 j + c2
  // (+1), j < 4; nw its columns in the block's tile
  const int nw = 32 * (warp >> 1), n0 = nb + nw, pr0 = p0 + pw;
  bf16* sStage = reinterpret_cast<bf16*>(smem + STAGES * STAGE_BYTES) + warp * 2 * SROWS * LDW;
  const bool has = psv > 0 && n0 < n16;
  float hacc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int pr = g4 + 8 * (e >> 1), n = n0 + 8 * j + c2 + (e & 1);
      hacc[j][e] = init != nullptr && pr < psv && n < N ? init[hoff + (pr0 + pr) * N + n] : 0.f;
    }

  for (int step = 0; step < prm.nc; ++step) {
    const int c = dir == 0 ? step : prm.nc - 1 - step;
    const int valid = min(Q, prm.t - c * Q);
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // this chunk is in; every warp is done with the stage loaded next
    load(step + STAGES - 1);
    const bf16* sV = reinterpret_cast<const bf16*>(smem + (step % STAGES) * STAGE_BYTES);
    const bf16* sK = sV + Q * LDV;
    const float* sDt = reinterpret_cast<const float*>(sK + Q * LDK);

    if (has) {  // the state this chunk starts from (dir 1: its dH'), as hi + lo
      bf16* o = out + (long long)c * 2 * P * N + (long long)pr0 * N + n0;
      if (N % 8 == 0) {  // through the staging tile (the barrier above ends its last reads)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            uint32_t hi, lo;
            sm90::split_bf16(hacc[j][2 * i], hacc[j][2 * i + 1], hi, lo);
            const int at = (g4 + 8 * i) * LDW + 8 * j + c2;
            *reinterpret_cast<uint32_t*>(sStage + at) = hi;
            *reinterpret_cast<uint32_t*>(sStage + SROWS * LDW + at) = lo;
          }
        __syncwarp();
#pragma unroll
        for (int k = 0; k < 4; ++k) {  // piece k: part, row, 16 bytes q of 64
          const int idx = 32 * k + lane, part = idx >> 6, row = (idx >> 2) & 15, q = idx & 3;
          if (row < psv && n0 + 8 * q < N)
            *reinterpret_cast<uint4*>(o + (long long)part * P * N + row * N + 8 * q) =
                *reinterpret_cast<const uint4*>(sStage + (part * SROWS + row) * LDW + 8 * q);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int pr = g4 + 8 * i, n = 8 * j + c2;
            if (pr < psv && n0 + n < N) {  // N is a multiple of 4: n + 1 < N too
              uint32_t hi, lo;
              sm90::split_bf16(hacc[j][2 * i], hacc[j][2 * i + 1], hi, lo);
              *reinterpret_cast<uint32_t*>(o + pr * N + n) = hi;
              *reinterpret_cast<uint32_t*>(o + P * N + pr * N + n) = lo;
            }
          }
      }
    }
    // L = cumsum(dt a) by every warp, two steps a lane; the weights of the
    // lane's two steps (dir 0: dt exp(L_last - L), dir 1: exp(L))
    const float a0 = sDt[2 * lane] * a, a1 = sDt[2 * lane + 1] * a;
    float incl = a0 + a1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
    const float l0 = excl + a0, l1 = l0 + a1;
    const int last = valid - 1;
    const float llast = __shfl_sync(0xffffffffu, (last & 1) ? l1 : l0, last >> 1);
    const float wv0 = dir == 0 ? sDt[2 * lane] * expf(llast - l0) : expf(l0);
    const float wv1 = dir == 0 ? sDt[2 * lane + 1] * expf(llast - l1) : expf(l1);
    const float el = expf(llast);

    if (has) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) hacc[j][e] *= el;
      const int ksteps = (valid + 15) / 16;
#pragma unroll
      for (int kk = 0; kk < Q / 16; ++kk) {
        if (kk < ksteps) {
          uint32_t va[4], ah[4], al[4], kf[2][4];
          sm90::ldsm_x4_t(va, sm90::smem_addr(sV + (16 * kk + (mi >> 1) * 8 + (lane & 7)) * LDV +
                                              pw + (mi & 1) * 8));
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
            if (n0 + 16 * jj < n16)
              sm90::ldsm_x4_t(kf[jj], sm90::smem_addr(sK + (16 * kk + (mi & 1) * 8 + (lane & 7)) *
                                                      LDK + nw + 16 * jj + (mi >> 1) * 8));
          // the weights of steps s0, s0 + 1, s0 + 8, s0 + 9 (s0 = 16 kk + c2)
          const int src = 8 * kk + (lane & 3);
          const float w[4] = {__shfl_sync(0xffffffffu, wv0, src),
                              __shfl_sync(0xffffffffu, wv1, src),
                              __shfl_sync(0xffffffffu, wv0, src + 4),
                              __shfl_sync(0xffffffffu, wv1, src + 4)};
#pragma unroll
          for (int r = 0; r < 4; ++r) {  // r < 2: steps s0, s0 + 1; r >= 2: s0 + 8, s0 + 9
            const float2 xv = sm90::unpack_bf16(va[r]);
            sm90::split_bf16(xv.x * w[2 * (r >> 1)], xv.y * w[2 * (r >> 1) + 1], ah[r], al[r]);
          }
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
            if (n0 + 16 * jj < n16) {
              sm90::mma_bf16(hacc[2 * jj], ah, kf[jj][0], kf[jj][1]);
              sm90::mma_bf16(hacc[2 * jj + 1], ah, kf[jj][2], kf[jj][3]);
            }
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
            if (n0 + 16 * jj < n16) {
              sm90::mma_bf16(hacc[2 * jj], al, kf[jj][0], kf[jj][1]);
              sm90::mma_bf16(hacc[2 * jj + 1], al, kf[jj][2], kf[jj][3]);
            }
        }
      }
    }
  }
  cp_async_wait<0>();  // the empty groups past the last chunk
  if (dir == 1 && prm.dh0 != nullptr && has) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int pr = g4 + 8 * i, n = n0 + 8 * j + c2;
        if (pr < psv && n < N)
          *reinterpret_cast<float2*>(prm.dh0 + hoff + (pr0 + pr) * N + n) =
              make_float2(hacc[j][2 * i], hacc[j][2 * i + 1]);
      }
  }
}

// ------------------------------------------ pass 2: the chunks, on the tensor cores
// Block (chunk, head, batch), 8 warps: warp w owns rows 16 (w & 3) .. + 15 and
// one half of the head_dim columns (w >> 2).  Rows are t in the products
// whose rows are outputs t (C B^T, dy x^T, Z = C H^T) and s in those whose
// rows are s (B C^T, M^T dy, V = B dH'^T, dx).  Each orientation computes
// its own block of C B^T (cheap on the tensor cores), so M never goes
// through shared memory for a transpose: M^T goes from the accumulators
// straight into A fragments (both halves of a row block compute it; the
// products with head_dim columns are split between them, C B^T and dy x^T
// by 16-column blocks).  The causal mask skips the tiles above the diagonal.
// H and dH' share one hi + lo tile, H first: M^T dy runs while H arrives,
// C B^T and dy x^T while dH' does.  G stays fp32 (shared memory) for the dl
// / ddt tail, in the CUDA-core kernel's order of sums.  dB and dC are pass
// 3's.  105 KB of shared memory and <= 128 registers: two blocks (16 warps)
// an SM.
constexpr int CK_WARPS = 8;
constexpr int CK_THREADS = 32 * CK_WARPS;
constexpr int CK_X = 0;                          // x      Q x LDX bf16
constexpr int CK_DY = CK_X + 2 * Q * LDX;        // dy     Q x LDX
constexpr int CK_B = CK_DY + 2 * Q * LDX;        // B      Q x LDS
constexpr int CK_C = CK_B + 2 * Q * LDS;         // C      Q x LDS
constexpr int CK_ST = CK_C + 2 * Q * LDS;        // H, then dH': hi MAXP x LDS, lo MAXP x LDS;
                                                 // then G's row prefixes (fp32)
constexpr int CK_G = CK_ST + 4 * MAXP * LDS;     // CB E DX  Q x LDG fp32
constexpr int CK_VEC = CK_G + 4 * Q * LDG;       // 10 vectors of Q, 16 more floats
constexpr int CHUNK_MMA_SMEM = CK_VEC + 4 * (10 * Q + 16);
constexpr int HD_UNITS = MAXP * MAXN / 4 / CK_THREADS;  // 4-entry pieces of dH' a thread reads
static_assert(4 * Q * LDG <= 4 * MAXP * LDS, "G's prefixes fit the state tile");

__global__ void __launch_bounds__(CK_THREADS, 2) ssd_bwd_chunk_mma_kernel(const Params prm,
                                                                        int aligned) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sX = reinterpret_cast<bf16*>(smem + CK_X);
  bf16* sDY = reinterpret_cast<bf16*>(smem + CK_DY);
  bf16* sB = reinterpret_cast<bf16*>(smem + CK_B);
  bf16* sC = reinterpret_cast<bf16*>(smem + CK_C);
  bf16* sSh = reinterpret_cast<bf16*>(smem + CK_ST);   // the state tile's hi
  bf16* sSl = sSh + MAXP * LDS;                         // and lo
  float* sG = reinterpret_cast<float*>(smem + CK_G);
  float* sDt = reinterpret_cast<float*>(smem + CK_VEC);  // dt_s
  float* sL = sDt + Q;            // L_t
  float* sEL = sL + Q;            // exp(L_t)
  float* sF = sEL + Q;            // exp(L_last - L_s)
  float* sXV = sF + Q;            // x_s . V_s: the two column halves' shares, then their sum
  float* sYZ = sXV + 2 * Q;       // dy_t . Z_t: the halves' shares, then exp(L_t) times their sum
  float* sDiag = sYZ + 2 * Q;     // dy_t . x_t
  float* sDL = sDiag + Q;         // dl_s dt_s
  float* sRed = sDL + Q;          // warps' shares of <dH', H>; [8]: exp(L_last)

  const int c = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int P = prm.p, N = prm.n, H = prm.h, p16 = pad16(P), n16 = pad16(N);
  const int nkp = p16 / 16, nkn = n16 / 16;
  const int c0 = c * Q, valid = min(Q, prm.t - c0);
  const int grp = hh / (H / prm.g);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g4 = lane >> 2, c2 = 2 * (lane & 3), mi = lane >> 3;
  const int rw = warp & 3, half = warp >> 2;           // row block, column half
  const int r0 = 16 * rw, ra = r0 + g4, rb = ra + 8;   // this thread's two rows
  const int ph = 32 * half;                             // this warp's head_dim columns
  const float a = -expf(prm.a_log[hh]);
  const bf16* x = static_cast<const bf16*>(prm.x) + bb * prm.x_sb + hh * prm.x_sh;
  const long long yoff = ((long long)bb * prm.t * H + hh) * P;  // dy, dx: (B, T, H, P)
  const long long y_st = (long long)H * P;
  const bf16* dy = static_cast<const bf16*>(prm.dy) + yoff;
  const bf16* bm = static_cast<const bf16*>(prm.bm) + bb * prm.b_sb + grp * prm.b_sg;
  const bf16* cm = static_cast<const bf16*>(prm.cm) + bb * prm.c_sb + grp * prm.c_sg;
  const float* dt = prm.dt + (long long)bb * prm.t * H + hh;  // stride H
  const long long soff = (((long long)bb * H + hh) * prm.nc + c) * 2 * P * N;
  const bf16* hst = static_cast<const bf16*>(prm.states) + soff;    // hi, then lo at P N
  const bf16* dhst = static_cast<const bf16*>(prm.dstates) + soff;
  const bool skip = prm.d_skip != nullptr;
  const float dskip = skip ? prm.d_skip[hh] : 0.f;

  // ---- the chunk (group 0), then H (group 1); rows past T come as zeros, and
  //      columns past P or N are read (as zeros) only when P or N is not a
  //      multiple of 16
  if ((P | N) & 15) {
    zero_smem<CK_THREADS>(smem, CHUNK_MMA_SMEM);
    __syncthreads();
  }
  load_rows<CK_THREADS>(sX, LDX, x, prm.x_st, c0, Q, valid, P, aligned);
  load_rows<CK_THREADS>(sDY, LDX, dy, y_st, c0, Q, valid, P, aligned);
  load_rows<CK_THREADS>(sB, LDS, bm, prm.b_st, c0, Q, valid, N, aligned);
  load_rows<CK_THREADS>(sC, LDS, cm, prm.c_st, c0, Q, valid, N, aligned);
  load_dt<CK_THREADS>(sDt, dt, H, c0, valid);
  sm90::cp_async_commit();
  load_rows<CK_THREADS>(sSh, LDS, hst, N, 0, P, P, N, aligned);
  load_rows<CK_THREADS>(sSl, LDS, hst + P * N, N, 0, P, P, N, aligned);
  sm90::cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  if (warp == 0) scan_chunk(sDt, a, valid, sL, sEL, sF, sRed + 8);
  __syncthreads();

  // ---- rows s, while H arrives: BC = B C^T for t >= 16 rw; M^T = BC E dt_s
  //      as hi + lo A fragments (k = t); MD = M^T dy on this warp's columns
  float md[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) md[j][0] = md[j][1] = md[j][2] = md[j][3] = 0.f;
  {
    uint32_t mth[4][4], mtl[4][4];
    {
      float bc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) bc[j][0] = bc[j][1] = bc[j][2] = bc[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < MAXN / 16; ++kk) {
        if (kk < nkn) {
          uint32_t af[4];
          sm90::ldsm_x4(af, sm90::smem_addr(sB + (r0 + (lane & 15)) * LDS + 16 * kk + (lane >> 4) * 8));
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            if (jj >= rw) {
              uint32_t bf[4];
              sm90::ldsm_x4(bf, sm90::smem_addr(sC + (16 * jj + (mi >> 1) * 8 + (lane & 7)) * LDS +
                                                16 * kk + (mi & 1) * 8));
              sm90::mma_bf16(bc[2 * jj], af, bf[0], bf[1]);
              sm90::mma_bf16(bc[2 * jj + 1], af, bf[2], bf[3]);
            }
        }
      }
      const float ls[2] = {sL[ra], sL[rb]}, ds[2] = {sDt[ra], sDt[rb]};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = e < 2 ? ra : rb, t = 8 * j + c2 + (e & 1);
          float m = 0.f;
          if (j >= 2 * rw && s <= t && t < valid)
            m = bc[j][e] * expf(sL[t] - ls[e >> 1]) * ds[e >> 1];
          bc[j][e] = m;
        }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        sm90::split_bf16(bc[2 * kk][0], bc[2 * kk][1], mth[kk][0], mtl[kk][0]);
        sm90::split_bf16(bc[2 * kk][2], bc[2 * kk][3], mth[kk][1], mtl[kk][1]);
        sm90::split_bf16(bc[2 * kk + 1][0], bc[2 * kk + 1][1], mth[kk][2], mtl[kk][2]);
        sm90::split_bf16(bc[2 * kk + 1][2], bc[2 * kk + 1][3], mth[kk][3], mtl[kk][3]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk >= rw) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int pp = ph + 16 * q;
          if (pp < p16) {
            uint32_t yf[4];
            sm90::ldsm_x4_t(yf, sm90::smem_addr(sDY + (16 * kk + (mi & 1) * 8 + (lane & 7)) * LDX +
                                                pp + (mi >> 1) * 8));
            sm90::mma_bf16(md[2 * q], mth[kk], yf[0], yf[1]);
            sm90::mma_bf16(md[2 * q + 1], mth[kk], yf[2], yf[3]);
            sm90::mma_bf16(md[2 * q], mtl[kk], yf[0], yf[1]);
            sm90::mma_bf16(md[2 * q + 1], mtl[kk], yf[2], yf[3]);
          }
        }
      }
    }
  }
  // this thread's pieces of dH' for <dH', H> (global memory; pass 1 wrote them)
  uint2 dhi[HD_UNITS], dlo[HD_UNITS];
#pragma unroll
  for (int i = 0; i < HD_UNITS; ++i) {
    const int u = tid + i * CK_THREADS;
    if (u < P * N / 4) {
      dhi[i] = __ldg(reinterpret_cast<const uint2*>(dhst + 4 * u));
      dlo[i] = __ldg(reinterpret_cast<const uint2*>(dhst + P * N + 4 * u));
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // H is in

  // ---- rows t: Z = C H^T on this warp's columns, its share of dy_t . Z_t;
  //      this thread's share of <dH', H>
  {
    float z[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) z[j][0] = z[j][1] = z[j][2] = z[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < MAXN / 16; ++kk) {
      if (kk < nkn) {
        uint32_t af[4];
        sm90::ldsm_x4(af, sm90::smem_addr(sC + (r0 + (lane & 15)) * LDS + 16 * kk + (lane >> 4) * 8));
#pragma unroll
        for (int part = 0; part < 2; ++part) {
          const bf16* st = part == 0 ? sSh : sSl;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int pp = ph + 16 * q;
            if (pp < p16) {
              uint32_t hf[4];
              sm90::ldsm_x4(hf, sm90::smem_addr(st + (pp + (mi >> 1) * 8 + (lane & 7)) * LDS +
                                                16 * kk + (mi & 1) * 8));
              sm90::mma_bf16(z[2 * q], af, hf[0], hf[1]);
              sm90::mma_bf16(z[2 * q + 1], af, hf[2], hf[3]);
            }
          }
        }
      }
    }
    float yz[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (ph + 8 * j >= p16) continue;
        const float2 yv = sm90::unpack_bf16(
            *reinterpret_cast<const uint32_t*>(sDY + (i ? rb : ra) * LDX + ph + 8 * j + c2));
        yz[i] = fmaf(yv.x, z[j][2 * i], yz[i]);
        yz[i] = fmaf(yv.y, z[j][2 * i + 1], yz[i]);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      yz[i] += __shfl_xor_sync(0xffffffffu, yz[i], 1);
      yz[i] += __shfl_xor_sync(0xffffffffu, yz[i], 2);
    }
    if ((lane & 3) == 0) {
      sYZ[half * Q + ra] = yz[0];
      sYZ[half * Q + rb] = yz[1];
    }
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < HD_UNITS; ++i) {
      const int u = tid + i * CK_THREADS;
      if (u < P * N / 4) {
        const int e = 4 * u, pr = e / N, n = e - pr * N;
        const uint2 hh2 = *reinterpret_cast<const uint2*>(sSh + pr * LDS + n);
        const uint2 hl2 = *reinterpret_cast<const uint2*>(sSl + pr * LDS + n);
        const uint32_t hv[4] = {hh2.x, hh2.y, hl2.x, hl2.y};
        const uint32_t dv[4] = {dhi[i].x, dhi[i].y, dlo[i].x, dlo[i].y};
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float2 h1 = sm90::unpack_bf16(hv[q]), h2 = sm90::unpack_bf16(hv[q + 2]);
          const float2 d1 = sm90::unpack_bf16(dv[q]), d2 = sm90::unpack_bf16(dv[q + 2]);
          part = fmaf(d1.x + d2.x, h1.x + h2.x, part);
          part = fmaf(d1.y + d2.y, h1.y + h2.y, part);
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0) sRed[warp] = part;
  }
  __syncthreads();  // every warp is done with H
  load_rows<CK_THREADS>(sSh, LDS, dhst, N, 0, P, P, N, aligned);
  load_rows<CK_THREADS>(sSl, LDS, dhst + P * N, N, 0, P, P, N, aligned);
  sm90::cp_async_commit();

  // ---- rows t, while dH' arrives: CB = C B^T and DX = dy x^T on this warp's
  //      column blocks jb <= rw (jb = half, half + 2); G = CB E DX (fp32,
  //      shared memory), dy_t . x_t
  {
    float cb[2][2][4], dxa[2][2][4];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) cb[0][q][e] = cb[1][q][e] = dxa[0][q][e] = dxa[1][q][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < MAXN / 16; ++kk) {
      if (kk < nkn) {
        uint32_t af[4];
        sm90::ldsm_x4(af, sm90::smem_addr(sC + (r0 + (lane & 15)) * LDS + 16 * kk + (lane >> 4) * 8));
#pragma unroll
        for (int sl = 0; sl < 2; ++sl) {
          const int jb = half + 2 * sl;
          if (jb <= rw) {
            uint32_t bf[4];
            sm90::ldsm_x4(bf, sm90::smem_addr(sB + (16 * jb + (mi >> 1) * 8 + (lane & 7)) * LDS +
                                              16 * kk + (mi & 1) * 8));
            sm90::mma_bf16(cb[sl][0], af, bf[0], bf[1]);
            sm90::mma_bf16(cb[sl][1], af, bf[2], bf[3]);
          }
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < MAXP / 16; ++kk) {
      if (kk < nkp) {
        uint32_t af[4];
        sm90::ldsm_x4(af, sm90::smem_addr(sDY + (r0 + (lane & 15)) * LDX + 16 * kk + (lane >> 4) * 8));
#pragma unroll
        for (int sl = 0; sl < 2; ++sl) {
          const int jb = half + 2 * sl;
          if (jb <= rw) {
            uint32_t bf[4];
            sm90::ldsm_x4(bf, sm90::smem_addr(sX + (16 * jb + (mi >> 1) * 8 + (lane & 7)) * LDX +
                                              16 * kk + (mi & 1) * 8));
            sm90::mma_bf16(dxa[sl][0], af, bf[0], bf[1]);
            sm90::mma_bf16(dxa[sl][1], af, bf[2], bf[3]);
          }
        }
      }
    }
    const float lt[2] = {sL[ra], sL[rb]};
#pragma unroll
    for (int sl = 0; sl < 2; ++sl)
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jb = half + 2 * sl;
          const int t = e < 2 ? ra : rb, s = 16 * jb + 8 * q + c2 + (e & 1);
          float gv = 0.f;
          if (jb <= rw && s <= t && t < valid)  // select, never multiply by the mask
            gv = cb[sl][q][e] * expf(lt[e >> 1] - sL[s]) * dxa[sl][q][e];
          sG[t * LDG + s] = gv;
          if (s == t) sDiag[t] = t < valid ? dxa[sl][q][e] : 0.f;
        }
  }
  cp_async_wait<0>();
  __syncthreads();  // dH' is in

  // ---- rows s: V = B dH'^T on this warp's columns; dx = MD + W_s V + D dy,
  //      its share of x_s . V_s
  {
    float v[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j][0] = v[j][1] = v[j][2] = v[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < MAXN / 16; ++kk) {
      if (kk < nkn) {
        uint32_t af[4];
        sm90::ldsm_x4(af, sm90::smem_addr(sB + (r0 + (lane & 15)) * LDS + 16 * kk + (lane >> 4) * 8));
#pragma unroll
        for (int part = 0; part < 2; ++part) {
          const bf16* st = part == 0 ? sSh : sSl;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int pp = ph + 16 * q;
            if (pp < p16) {
              uint32_t hf[4];
              sm90::ldsm_x4(hf, sm90::smem_addr(st + (pp + (mi >> 1) * 8 + (lane & 7)) * LDS +
                                                16 * kk + (mi & 1) * 8));
              sm90::mma_bf16(v[2 * q], af, hf[0], hf[1]);
              sm90::mma_bf16(v[2 * q + 1], af, hf[2], hf[3]);
            }
          }
        }
      }
    }
    const float w[2] = {sDt[ra] * sF[ra], sDt[rb] * sF[rb]};  // W_s of this thread's rows
    bf16* dxo = static_cast<bf16*>(prm.dx) + yoff;
    float xv[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int s = i ? rb : ra, pc = ph + 8 * j + c2;
        if (ph + 8 * j >= p16) continue;
        const float2 xs =
            sm90::unpack_bf16(*reinterpret_cast<const uint32_t*>(sX + s * LDX + pc));
        xv[i] = fmaf(xs.x, v[j][2 * i], xv[i]);
        xv[i] = fmaf(xs.y, v[j][2 * i + 1], xv[i]);
        if (s < valid && pc < P) {
          float d0 = md[j][2 * i] + w[i] * v[j][2 * i];
          float d1 = md[j][2 * i + 1] + w[i] * v[j][2 * i + 1];
          if (skip) {
            const float2 ys =
                sm90::unpack_bf16(*reinterpret_cast<const uint32_t*>(sDY + s * LDX + pc));
            d0 += dskip * ys.x;
            d1 += dskip * ys.y;
          }
          bf16* dr = dxo + (c0 + s) * y_st + pc;
          if (pc + 1 < P && (P & 1) == 0) {
            *reinterpret_cast<uint32_t*>(dr) = sm90::pack_bf16(d0, d1);
          } else {
            dr[0] = __float2bfloat16(d0);
            if (pc + 1 < P) dr[1] = __float2bfloat16(d1);
          }
        }
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      xv[i] += __shfl_xor_sync(0xffffffffu, xv[i], 1);
      xv[i] += __shfl_xor_sync(0xffffffffu, xv[i], 2);
    }
    if ((lane & 3) == 0) {
      sXV[half * Q + ra] = xv[0];
      sXV[half * Q + rb] = xv[1];
    }
  }
  __syncthreads();  // the shares of <dH', H>, x . V and dy . Z are in; the state tile is free
  float hdot = 0.f;
#pragma unroll
  for (int i = 0; i < CK_WARPS; ++i) hdot += sRed[i];

  // ---- dl and ddt, thread u < Q owning step u, as the CUDA-core kernel sums
  //      them; the row prefixes of G dt_s are taken by threads Q..2Q-1 meanwhile
  float* sPre = reinterpret_cast<float*>(smem + CK_ST);
  float col = 0.f;  // sum_t CB E DX [t, u]
  if (tid < Q) {
    // the two halves' shares, in order
    sXV[tid] = tid < valid ? sXV[tid] + sXV[Q + tid] : 0.f;
    sYZ[tid] = tid < valid ? sEL[tid] * (sYZ[tid] + sYZ[Q + tid]) : 0.f;
#pragma unroll 8
    for (int t = tid; t < valid; ++t) col += sG[t * LDG + tid];
  } else if (tid < 2 * Q) {
    const int t = tid - Q;
    float run = 0.f;
#pragma unroll 8
    for (int s = 0; s < Q; ++s) {
      const float gv = sG[t * LDG + s] * sDt[s];
      sPre[t * LDG + s] = run;
      run += gv;
    }
  }
  __syncthreads();
  if (tid < Q) {
    const int u = tid;
    float dl = 0.f;
#pragma unroll 8
    for (int t = u; t < valid; ++t) dl += sPre[t * LDG + u];     // the pairs s < u <= t
#pragma unroll 8
    for (int t = u; t < valid; ++t) dl += sYZ[t];                // y_t for t >= u
#pragma unroll 8
    for (int s = 0; s < u && s < valid; ++s) dl += sDt[s] * sF[s] * sXV[s];   // W_s, s < u
    dl += sRed[8] * hdot;                                        // exp(L_last) H
    if (u < valid) prm.ddt[(long long)(bb * prm.t + c0 + u) * H + hh] = col + sF[u] * sXV[u] + dl * a;
    sDL[u] = u < valid ? dl * sDt[u] : 0.f;
  }
  __syncthreads();
  if (tid == 0) {
    float da = 0.f, dd = 0.f;
#pragma unroll 8
    for (int u = 0; u < valid; ++u) {
      da += sDL[u];
      dd += sDiag[u];
    }
    const long long part = ((long long)bb * H + hh) * prm.nc + c;
    prm.head_part[part] = da;
    prm.head_part[(long long)prm.b * H * prm.nc + part] = dd;
  }
}

// ------------------------------------------ pass 3: dB and dC, on the tensor cores
// Block (chunk, group x 32 state columns, batch), 8 warps: warp w owns rows
// 16 (w & 3) .. + 15 (t of dC, s of dB) and columns 16 (w >> 2) .. + 15 of
// the block's 32.  It walks the group's heads in order, each head's x, dy, dt
// and the 32 columns of its H and dH' (hi + lo) one head ahead through two
// cp.async stages, and sums in registers
//   dC_t += exp(L_t) dy_t H,   dB_s += W_s x_s dH',   S += E dt_s DX
// (S over the heads, its 16-column blocks shared out between the two warps
// of a row block: the chunk's S B and S^T C are one product each at the
// end), so dB and dC leave once, rounded to bf16: no per-head partials and no
// third pass over them.  The heads' sums run in head order: deterministic.
// Two blocks an SM (16 warps) at <= 128 registers: the loop over the heads is
// a chain of loads, barriers and short products, and the warps hide it.
constexpr int DB_WARPS = 8;
constexpr int DB_THREADS = 32 * DB_WARPS;
constexpr int NSL = 32;                           // state columns per block
constexpr int LDH = NSL + 8;                      // their rows (bf16)
constexpr int DS_X = 0;                           // a stage: x   Q x LDX bf16
constexpr int DS_DY = DS_X + 2 * Q * LDX;         //          dy  Q x LDX
constexpr int DS_H = DS_DY + 2 * Q * LDX;         //          H   hi, lo MAXP x LDH
constexpr int DS_DH = DS_H + 4 * MAXP * LDH;      //          dH' hi, lo MAXP x LDH
constexpr int DS_DT = DS_DH + 4 * MAXP * LDH;     //          dt  Q fp32
constexpr int DSTAGE = DS_DT + 4 * Q;
constexpr int DB_B = 2 * DSTAGE;                  // B, C columns  Q x LDH bf16
constexpr int DB_C = DB_B + 2 * Q * LDH;
constexpr int DB_VEC = DB_C + 2 * Q * LDH;        // a warp's L, exp(L), exp(L_last - L)
constexpr int DBDC_SMEM = DB_VEC + 4 * DB_WARPS * 3 * Q;
static_assert(4 * Q * LDG <= DSTAGE, "the summed S fits a stage");

__global__ void __launch_bounds__(DB_THREADS, 2) ssd_bwd_dbdc_mma_kernel(const Params prm,
                                                                       int aligned, bf16* db,
                                                                       bf16* dc) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sBs = reinterpret_cast<bf16*>(smem + DB_B);
  bf16* sCs = reinterpret_cast<bf16*>(smem + DB_C);

  const int P = prm.p, N = prm.n, H = prm.h, G = prm.g, p16 = pad16(P);
  const int nkp = p16 / 16, nsl = (N + NSL - 1) / NSL;
  const int c = blockIdx.x, grp = blockIdx.y / nsl, n0 = (blockIdx.y % nsl) * NSL;
  const int bb = blockIdx.z;
  const int nsv = min(NSL, N - n0);
  const int R = H / G;
  const int c0 = c * Q, valid = min(Q, prm.t - c0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g4 = lane >> 2, c2 = 2 * (lane & 3), mi = lane >> 3;
  const int rw = warp & 3, half = warp >> 2;           // row block, column half
  const int r0 = 16 * rw, ra = r0 + g4, rb = ra + 8;   // this thread's two rows
  const int ch = 16 * half;                             // this warp's columns in the block
  const bool cols = ch < nsv;
  // L, exp(L), exp(L_last - L) of the head in hand, this warp's own copy
  float* wL = reinterpret_cast<float*>(smem + DB_VEC) + warp * 3 * Q;
  float* wEL = wL + Q;
  float* wF = wEL + Q;

  zero_smem<DB_THREADS>(smem, DBDC_SMEM);
  __syncthreads();
  load_rows<DB_THREADS>(sBs, LDH, static_cast<const bf16*>(prm.bm) + bb * prm.b_sb +
                        grp * prm.b_sg + n0, prm.b_st, c0, Q, valid, nsv, aligned);
  load_rows<DB_THREADS>(sCs, LDH, static_cast<const bf16*>(prm.cm) + bb * prm.c_sb +
                        grp * prm.c_sg + n0, prm.c_st, c0, Q, valid, nsv, aligned);
  // head grp R + r of the group into stage r & 1 (one commit group a head)
  auto load_head = [&](int r) {
    if (r < R) {
      const int hh = grp * R + r;
      unsigned char* st = smem + (r & 1) * DSTAGE;
      const long long soff = (((long long)bb * H + hh) * prm.nc + c) * 2 * P * N + n0;
      const bf16* hs = static_cast<const bf16*>(prm.states) + soff;
      const bf16* ds = static_cast<const bf16*>(prm.dstates) + soff;
      load_rows<DB_THREADS>(reinterpret_cast<bf16*>(st + DS_X), LDX,
                            static_cast<const bf16*>(prm.x) + bb * prm.x_sb + hh * prm.x_sh,
                            prm.x_st, c0, Q, valid, P, aligned);
      load_rows<DB_THREADS>(reinterpret_cast<bf16*>(st + DS_DY), LDX,
                            static_cast<const bf16*>(prm.dy) + ((long long)bb * prm.t * H + hh) * P,
                            (long long)H * P, c0, Q, valid, P, aligned);
      bf16* sH = reinterpret_cast<bf16*>(st + DS_H);
      bf16* sD = reinterpret_cast<bf16*>(st + DS_DH);
      load_rows<DB_THREADS>(sH, LDH, hs, N, 0, P, P, nsv, aligned);
      load_rows<DB_THREADS>(sH + MAXP * LDH, LDH, hs + P * N, N, 0, P, P, nsv, aligned);
      load_rows<DB_THREADS>(sD, LDH, ds, N, 0, P, P, nsv, aligned);
      load_rows<DB_THREADS>(sD + MAXP * LDH, LDH, ds + P * N, N, 0, P, P, nsv, aligned);
      load_dt<DB_THREADS>(reinterpret_cast<float*>(st + DS_DT),
                          prm.dt + (long long)bb * prm.t * H + hh, H, c0, valid);
    }
    sm90::cp_async_commit();
  };
  load_head(0);

  // S (rows t, this warp's 16-column blocks jb = half, half + 2: slot jb >> 1),
  // dC (rows t) and dB (rows s) on this warp's 16 columns
  float sacc[2][2][4], dcs[2][4], dbs[2][4];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) sacc[0][q][e] = sacc[1][q][e] = dcs[q][e] = dbs[q][e] = 0.f;

  for (int r = 0; r < R; ++r) {
    cp_async_wait<0>();
    __syncthreads();  // head r is in; every warp is done with head r - 1
    load_head(r + 1);
    const unsigned char* st = smem + (r & 1) * DSTAGE;
    const bf16* sX = reinterpret_cast<const bf16*>(st + DS_X);
    const bf16* sDY = reinterpret_cast<const bf16*>(st + DS_DY);
    const bf16* sH = reinterpret_cast<const bf16*>(st + DS_H);
    const bf16* sD = reinterpret_cast<const bf16*>(st + DS_DH);
    const float* sDt = reinterpret_cast<const float*>(st + DS_DT);
    {  // L = cumsum(dt a) by every warp into its own vectors (no barrier)
      const float a = -expf(prm.a_log[grp * R + r]);
      const float a0 = sDt[2 * lane] * a, a1 = sDt[2 * lane + 1] * a;
      float incl = a0 + a1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
      const float l0 = excl + a0, l1 = l0 + a1;
      const int last = valid - 1;
      const float llast = __shfl_sync(0xffffffffu, (last & 1) ? l1 : l0, last >> 1);
      wL[2 * lane] = l0;
      wL[2 * lane + 1] = l1;
      wEL[2 * lane] = expf(l0);
      wEL[2 * lane + 1] = expf(l1);
      wF[2 * lane] = expf(llast - l0);
      wF[2 * lane + 1] = expf(llast - l1);
      __syncwarp();
    }

    // rows t: DX = dy x^T on this warp's column blocks jb <= rw, S += E dt_s DX;
    // dC += exp(L_t) dy H
    {
      float dxa[2][2][4], tmp[2][4];
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) dxa[0][q][e] = dxa[1][q][e] = tmp[q][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < MAXP / 16; ++kk) {
        if (kk < nkp) {
          uint32_t af[4];
          sm90::ldsm_x4(af, sm90::smem_addr(sDY + (r0 + (lane & 15)) * LDX + 16 * kk + (lane >> 4) * 8));
#pragma unroll
          for (int sl = 0; sl < 2; ++sl) {
            const int jb = half + 2 * sl;
            if (jb <= rw) {
              uint32_t bf[4];
              sm90::ldsm_x4(bf, sm90::smem_addr(sX + (16 * jb + (mi >> 1) * 8 + (lane & 7)) * LDX +
                                                16 * kk + (mi & 1) * 8));
              sm90::mma_bf16(dxa[sl][0], af, bf[0], bf[1]);
              sm90::mma_bf16(dxa[sl][1], af, bf[2], bf[3]);
            }
          }
          if (cols) {
#pragma unroll
            for (int part = 0; part < 2; ++part) {
              uint32_t hf[4];
              sm90::ldsm_x4_t(hf, sm90::smem_addr(sH + part * MAXP * LDH +
                                                  (16 * kk + (mi & 1) * 8 + (lane & 7)) * LDH +
                                                  ch + (mi >> 1) * 8));
              sm90::mma_bf16(tmp[0], af, hf[0], hf[1]);
              sm90::mma_bf16(tmp[1], af, hf[2], hf[3]);
            }
          }
        }
      }
      const float lt[2] = {wL[ra], wL[rb]}, el[2] = {wEL[ra], wEL[rb]};
#pragma unroll
      for (int sl = 0; sl < 2; ++sl) {
        const int jb = half + 2 * sl;
        if (jb <= rw) {
#pragma unroll
          for (int q = 0; q < 2; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int t = e < 2 ? ra : rb, s = 16 * jb + 8 * q + c2 + (e & 1);
              if (s <= t && t < valid)
                sacc[sl][q][e] += expf(lt[e >> 1] - wL[s]) * sDt[s] * dxa[sl][q][e];
            }
        }
      }
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) dcs[q][e] = fmaf(el[e >> 1], tmp[q][e], dcs[q][e]);
    }
    // rows s: dB += W_s x dH'
    if (cols) {
      float tmp[2][4];
#pragma unroll
      for (int q = 0; q < 2; ++q) tmp[q][0] = tmp[q][1] = tmp[q][2] = tmp[q][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < MAXP / 16; ++kk) {
        if (kk < nkp) {
          uint32_t af[4];
          sm90::ldsm_x4(af, sm90::smem_addr(sX + (r0 + (lane & 15)) * LDX + 16 * kk + (lane >> 4) * 8));
#pragma unroll
          for (int part = 0; part < 2; ++part) {
            uint32_t hf[4];
            sm90::ldsm_x4_t(hf, sm90::smem_addr(sD + part * MAXP * LDH +
                                                (16 * kk + (mi & 1) * 8 + (lane & 7)) * LDH +
                                                ch + (mi >> 1) * 8));
            sm90::mma_bf16(tmp[0], af, hf[0], hf[1]);
            sm90::mma_bf16(tmp[1], af, hf[2], hf[3]);
          }
        }
      }
      const float w[2] = {sDt[ra] * wF[ra], sDt[rb] * wF[rb]};
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) dbs[q][e] = fmaf(w[e >> 1], tmp[q][e], dbs[q][e]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the stages

  // the summed S (fp32, Q x LDG) into shared memory: each (t, s) from the warp
  // of its row block whose column blocks hold s (zeros above the diagonal)
  float* sS = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int sl = 0; sl < 2; ++sl)
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sS[(e < 2 ? ra : rb) * LDG + 16 * (half + 2 * sl) + 8 * q + c2 + (e & 1)] =
            sacc[sl][q][e];
  __syncthreads();
  if (cols) {
    // dC += S B (rows t, k = s) and dB += S^T C (rows s, k = t): the A
    // fragments from the summed S as hi + lo, read along and across its rows
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k0 = 16 * kk + c2;
      if (kk <= rw) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // q: rows ra / rb (q & 1), columns k0 / k0 + 8 (q >> 1)
          const float* row = sS + ((q & 1) ? rb : ra) * LDG + k0 + 8 * (q >> 1);
          sm90::split_bf16(row[0], row[1], ah[q], al[q]);
        }
        uint32_t bf[4];
        sm90::ldsm_x4_t(bf, sm90::smem_addr(sBs + (16 * kk + (mi & 1) * 8 + (lane & 7)) * LDH +
                                            ch + (mi >> 1) * 8));
        sm90::mma_bf16(dcs[0], ah, bf[0], bf[1]);
        sm90::mma_bf16(dcs[1], ah, bf[2], bf[3]);
        sm90::mma_bf16(dcs[0], al, bf[0], bf[1]);
        sm90::mma_bf16(dcs[1], al, bf[2], bf[3]);
      }
      if (kk >= rw) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // q: rows ra / rb (q & 1), steps k0 / k0 + 8 (q >> 1)
          const int s = (q & 1) ? rb : ra, t = k0 + 8 * (q >> 1);
          sm90::split_bf16(sS[t * LDG + s], sS[(t + 1) * LDG + s], ah[q], al[q]);
        }
        uint32_t cf[4];
        sm90::ldsm_x4_t(cf, sm90::smem_addr(sCs + (16 * kk + (mi & 1) * 8 + (lane & 7)) * LDH +
                                            ch + (mi >> 1) * 8));
        sm90::mma_bf16(dbs[0], ah, cf[0], cf[1]);
        sm90::mma_bf16(dbs[1], ah, cf[2], cf[3]);
        sm90::mma_bf16(dbs[0], al, cf[0], cf[1]);
        sm90::mma_bf16(dbs[1], al, cf[2], cf[3]);
      }
    }
    // dB and dC (B, T, G, N), rounded once
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int n = ch + 8 * q + c2;
      if (n < nsv) {  // N is a multiple of 4: n + 1 < nsv too
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = i ? rb : ra;
          if (row < valid) {
            const long long o = (((long long)bb * prm.t + c0 + row) * G + grp) * N + n0 + n;
            *reinterpret_cast<uint32_t*>(dc + o) = sm90::pack_bf16(dcs[q][2 * i], dcs[q][2 * i + 1]);
            *reinterpret_cast<uint32_t*>(db + o) = sm90::pack_bf16(dbs[q][2 * i], dbs[q][2 * i + 1]);
          }
        }
      }
    }
  }
}

}  // namespace tc

inline bool shape_ok(int b, int t, int h, int g, int p, int n) {
  return b > 0 && t > 0 && h > 0 && g > 0 && h % g == 0 && p > 0 && p <= MAXP && n > 0 &&
         n <= MAXN && b < 65536 && h < 65536;
}

inline bool stride_ok(long long stride, int extent) { return extent <= 1 || stride % 8 == 0; }

Params make_params(const void* x, const float* dt, const float* a_log, const void* bm,
                   const void* cm, const void* dy, long long x_sb, long long x_st,
                   long long x_sh, long long b_sb, long long b_st, long long b_sg,
                   long long c_sb, long long c_st, long long c_sg, int b, int t, int h, int g,
                   int p, int n) {
  Params prm{};
  prm.x = x; prm.dt = dt; prm.a_log = a_log; prm.bm = bm; prm.cm = cm; prm.dy = dy;
  prm.x_sb = x_sb; prm.x_st = x_st; prm.x_sh = x_sh;
  prm.b_sb = b_sb; prm.b_st = b_st; prm.b_sg = b_sg;
  prm.c_sb = c_sb; prm.c_st = c_st; prm.c_sg = c_sg;
  prm.b = b; prm.t = t; prm.h = h; prm.g = g; prm.p = p; prm.n = n;
  prm.nc = (t + Q - 1) / Q;
  return prm;
}

// whether the tensor-core passes may copy every row of x, dy, B, C and the
// states by 16-byte cp.async: each row start 16-byte aligned (dy and the
// states are the wrapper's contiguous tensors)
bool rows_aligned(const Params& prm) {
  return prm.p % 8 == 0 && prm.n % 8 == 0 &&
         ((reinterpret_cast<uintptr_t>(prm.x) | reinterpret_cast<uintptr_t>(prm.bm) |
           reinterpret_cast<uintptr_t>(prm.cm) | reinterpret_cast<uintptr_t>(prm.dy)) & 15) == 0 &&
         stride_ok(prm.x_sb, prm.b) && stride_ok(prm.x_st, prm.t) && stride_ok(prm.x_sh, prm.h) &&
         stride_ok(prm.b_sb, prm.b) && stride_ok(prm.b_st, prm.t) && stride_ok(prm.b_sg, prm.g) &&
         stride_ok(prm.c_sb, prm.b) && stride_ok(prm.c_st, prm.t) && stride_ok(prm.c_sg, prm.g);
}

// the dynamic shared memory and carveout of tensor-core pass `pass` (0:
// states, 1: chunks, 2: dB / dC), set once per device: each call costs host
// time on every backward
template <typename K>
cudaError_t allow_smem(int pass, K kernel, int bytes) {
  static bool done[3][64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && done[pass][dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && dev < 64) done[pass][dev] = true;
  return e;
}

template <typename T, bool MMA>
int launch_states(const void* x, const float* dt, const float* a_log, const void* bm,
                  const void* cm, const float* h0, const void* dy, const float* dh_last,
                  void* states, void* dstates, float* dh0, long long x_sb, long long x_st,
                  long long x_sh, long long b_sb, long long b_st, long long b_sg,
                  long long c_sb, long long c_st, long long c_sg, int b, int t, int h, int g,
                  int p, int n, void* stream) {
  if (!shape_ok(b, t, h, g, p, n)) return (int)cudaErrorInvalidValue;
  Params prm = make_params(x, dt, a_log, bm, cm, dy, x_sb, x_st, x_sh, b_sb, b_st, b_sg, c_sb,
                           c_st, c_sg, b, t, h, g, p, n);
  prm.h0 = h0; prm.dh_last = dh_last; prm.states = states; prm.dstates = dstates;
  prm.dh0 = dh0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (MMA) {
    if (n % 4) return (int)cudaErrorInvalidValue;
    cudaError_t e = allow_smem(0, tc::ssd_bwd_states_mma_kernel, tc::STATE_SMEM);
    if (e != cudaSuccess) return (int)e;
    dim3 grid(2 * ((p + tc::BROWS - 1) / tc::BROWS) * ((n + tc::BCOLS - 1) / tc::BCOLS), h, b);
    tc::ssd_bwd_states_mma_kernel<<<grid, tc::TC_THREADS, tc::STATE_SMEM, st>>>(
        prm, rows_aligned(prm) ? 1 : 0);
  } else {
    dim3 grid(2 * ((p + ROWS - 1) / ROWS), h, b);
    ssd_bwd_states_kernel<T><<<grid, THREADS, 0, st>>>(prm);
  }
  return (int)cudaGetLastError();
}

// the tensor-core route (MMA) launches the chunk pass and pass 3, which
// writes dB / dC whole into db_part / dc_part (then (B, T, G, N) in x's type)
template <typename T, bool MMA>
int launch_chunks(const void* x, const float* dt, const float* a_log, const void* bm,
                  const void* cm, const float* d_skip, const void* dy, const void* states,
                  const void* dstates, void* dx, float* ddt, void* db_part, void* dc_part,
                  float* head_part, long long x_sb, long long x_st, long long x_sh,
                  long long b_sb, long long b_st, long long b_sg, long long c_sb,
                  long long c_st, long long c_sg, int b, int t, int h, int g, int p, int n,
                  void* stream) {
  if (!shape_ok(b, t, h, g, p, n)) return (int)cudaErrorInvalidValue;
  Params prm = make_params(x, dt, a_log, bm, cm, dy, x_sb, x_st, x_sh, b_sb, b_st, b_sg, c_sb,
                           c_st, c_sg, b, t, h, g, p, n);
  prm.d_skip = d_skip; prm.states = const_cast<void*>(states);
  prm.dstates = const_cast<void*>(dstates);
  prm.dx = dx; prm.ddt = ddt; prm.head_part = head_part;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(prm.nc, h, b);
  if constexpr (MMA) {
    if (n % 4) return (int)cudaErrorInvalidValue;
    const int aligned = rows_aligned(prm) ? 1 : 0;
    cudaError_t e = allow_smem(1, tc::ssd_bwd_chunk_mma_kernel, tc::CHUNK_MMA_SMEM);
    if (e != cudaSuccess) return (int)e;
    tc::ssd_bwd_chunk_mma_kernel<<<grid, tc::CK_THREADS, tc::CHUNK_MMA_SMEM, st>>>(prm, aligned);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    e = allow_smem(2, tc::ssd_bwd_dbdc_mma_kernel, tc::DBDC_SMEM);
    if (e != cudaSuccess) return (int)e;
    dim3 grid3(prm.nc, g * ((n + tc::NSL - 1) / tc::NSL), b);
    tc::ssd_bwd_dbdc_mma_kernel<<<grid3, tc::DB_THREADS, tc::DBDC_SMEM, st>>>(
        prm, aligned, static_cast<tc::bf16*>(db_part), static_cast<tc::bf16*>(dc_part));
  } else {
    prm.db_part = static_cast<float*>(db_part);
    prm.dc_part = static_cast<float*>(dc_part);
    cudaError_t e = cudaFuncSetAttribute(ssd_bwd_chunk_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)CHUNK_SMEM);
    if (e != cudaSuccess) return (int)e;
    ssd_bwd_chunk_kernel<T><<<grid, THREADS, CHUNK_SMEM, st>>>(prm);
  }
  return (int)cudaGetLastError();
}

// dB / dC of each group from the per-head partials (BC), then da_log and dD
// of each head
template <typename T, bool BC>
int launch_reduce(const float* db_part, const float* dc_part, const float* head_part,
                  const float* a_log, void* db, void* dc, float* da_log, float* dd_skip, int b,
                  int t, int h, int g, int p, int n, void* stream) {
  if (!shape_ok(b, t, h, g, p, n)) return (int)cudaErrorInvalidValue;
  Params prm{};
  prm.b = b; prm.t = t; prm.h = h; prm.g = g; prm.p = p; prm.n = n;
  prm.nc = (t + Q - 1) / Q;
  prm.db_part = const_cast<float*>(db_part);
  prm.dc_part = const_cast<float*>(dc_part);
  prm.head_part = const_cast<float*>(head_part);
  prm.a_log = a_log;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (BC) {
    const long long total = (long long)b * t * g * n;
    const long long blocks = (total + THREADS - 1) / THREADS;
    ssd_bwd_sum_bc_kernel<T><<<(unsigned)(blocks < 4096 ? blocks : 4096), THREADS, 0, st>>>(
        prm, static_cast<T*>(db), static_cast<T*>(dc));
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  ssd_bwd_sum_heads_kernel<<<(h + 127) / 128, 128, 0, st>>>(prm, da_log, dd_skip);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define STATES_ARGS                                                                    \
  const void *x, const float *dt, const float *a_log, const void *bm, const void *cm,  \
      const float *h0, const void *dy, const float *dh_last, void *states,              \
      void *dstates, float *dh0, long long x_sb, long long x_st, long long x_sh,        \
      long long b_sb, long long b_st, long long b_sg, long long c_sb, long long c_st,   \
      long long c_sg, int b, int t, int h, int g, int p, int n, void *stream
#define STATES_PASS                                                                    \
  x, dt, a_log, bm, cm, h0, dy, dh_last, states, dstates, dh0, x_sb, x_st, x_sh, b_sb,  \
      b_st, b_sg, c_sb, c_st, c_sg, b, t, h, g, p, n, stream
#define CHUNKS_ARGS                                                                    \
  const void *x, const float *dt, const float *a_log, const void *bm, const void *cm,  \
      const float *d_skip, const void *dy, const void *states, const void *dstates,     \
      void *dx, float *ddt, void *db_part, void *dc_part, float *head_part,             \
      long long x_sb, long long x_st, long long x_sh, long long b_sb, long long b_st,   \
      long long b_sg, long long c_sb, long long c_st, long long c_sg, int b, int t,     \
      int h, int g, int p, int n, void *stream
#define CHUNKS_PASS                                                                    \
  x, dt, a_log, bm, cm, d_skip, dy, states, dstates, dx, ddt, db_part, dc_part,         \
      head_part, x_sb, x_st, x_sh, b_sb, b_st, b_sg, c_sb, c_st, c_sg, b, t, h, g, p,   \
      n, stream
#define REDUCE_ARGS                                                                    \
  const float *db_part, const float *dc_part, const float *head_part,                  \
      const float *a_log, void *db, void *dc, float *da_log, float *dd_skip, int b,     \
      int t, int h, int g, int p, int n, void *stream
#define REDUCE_PASS                                                                    \
  db_part, dc_part, head_part, a_log, db, dc, da_log, dd_skip, b, t, h, g, p, n, stream

using bf16_t = __nv_bfloat16;
int ssd_bwd_states_f32(STATES_ARGS) { return launch_states<float, false>(STATES_PASS); }
int ssd_bwd_chunks_f32(CHUNKS_ARGS) { return launch_chunks<float, false>(CHUNKS_PASS); }
int ssd_bwd_reduce_f32(REDUCE_ARGS) { return launch_reduce<float, true>(REDUCE_PASS); }
// bf16 x / B / C / dy: the tensor-core passes (their states and
// state gradients hi + lo bf16; the chunk pass's db_part / dc_part are dB /
// dC themselves), then the heads' sums alone (db_part, dc_part, db, dc unread)
int ssd_bwd_states_bf16_mma(STATES_ARGS) { return launch_states<bf16_t, true>(STATES_PASS); }
int ssd_bwd_chunks_bf16_mma(CHUNKS_ARGS) { return launch_chunks<bf16_t, true>(CHUNKS_PASS); }
int ssd_bwd_reduce_heads(REDUCE_ARGS) { return launch_reduce<float, false>(REDUCE_PASS); }

// the dynamic shared memory and the blocks an SM of tensor-core pass `pass`
// (0: states, 1: chunks, 2: dB / dC) on the current device
int ssd_bwd_mma_resources(int pass, int* smem_bytes, int* blocks_per_sm) {
  cudaError_t e = cudaSuccess;
  if (pass == 0) {
    *smem_bytes = tc::STATE_SMEM;
    e = allow_smem(0, tc::ssd_bwd_states_mma_kernel, tc::STATE_SMEM);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks_per_sm, tc::ssd_bwd_states_mma_kernel, tc::TC_THREADS, tc::STATE_SMEM);
  } else if (pass == 1) {
    *smem_bytes = tc::CHUNK_MMA_SMEM;
    e = allow_smem(1, tc::ssd_bwd_chunk_mma_kernel, tc::CHUNK_MMA_SMEM);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks_per_sm, tc::ssd_bwd_chunk_mma_kernel, tc::CK_THREADS, tc::CHUNK_MMA_SMEM);
  } else if (pass == 2) {
    *smem_bytes = tc::DBDC_SMEM;
    e = allow_smem(2, tc::ssd_bwd_dbdc_mma_kernel, tc::DBDC_SMEM);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks_per_sm, tc::ssd_bwd_dbdc_mma_kernel, tc::DB_THREADS, tc::DBDC_SMEM);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)e;
}

}  // extern "C"
