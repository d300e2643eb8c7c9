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
// Three passes, every sum in a fixed order (no atomics: two calls on the same
// inputs give the same bits):
//
// * `ssd_bwd_states_kernel` - per (16 state rows, head, batch) one block
//   walks the chunks forward from h0 and writes each chunk's incoming state
//   (in the forward CUDA-core kernel's order of additions and with its scan
//   of L), and one walks them backward from dh_last and writes each chunk's
//   dH'; the carry after chunk 0 is dh0.  State rows are independent, so a
//   head takes 2 ceil(P / 16) blocks (384 at the training shape); the next
//   chunk's rows are fetched into registers during each chunk's update.
//   Scratch: two (B, H, chunks, P, N) fp32 arrays (100 MB each at 1 x 4096 x
//   48 x 64 x 128).
// * `ssd_bwd_chunk_kernel` - one block per (chunk, head, batch), 3,072 at the
//   training shape: every chunk is independent once H and dH' are known.  It
//   holds x, dy, B, C, H, dH' and the three (Q x Q) matrices M, S, G in fp32
//   shared memory (213 KB, one block an SM), runs the products as register
//   tiles on the CUDA cores (fp32 FMAs), writes dx and ddt, per-head dB / dC
//   rows (fp32 (B, T, H, N)) and per-chunk partials of da and dD.
// * `ssd_bwd_sum_bc_kernel`, `ssd_bwd_sum_heads_kernel` - dB / dC summed over
//   the H / G heads of each group in head order and rounded to the inputs'
//   type once; da_log and dD summed over (batch, chunk) in order.
//
// What bounds it on this card: operations.  At the training shape the least
// work is ~29 GFLOP, 0.03 ms at the bf16 rate, against ~81 MB of inputs and
// outputs, 0.024 ms.  This first version computes in fp32 on the CUDA cores
// (0.43 ms of work at the fp32 rate) from shared memory, one block an SM, and
// moves ~0.8 GB of scratch; the tensor cores and a fused state pass are the
// levers for a later redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

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
  float* states;        // (B, H, NC, P, N): each chunk's incoming state
  float* dstates;       // (B, H, NC, P, N): the gradient of each chunk's outgoing state
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
  float* out = dir == 0 ? prm.states : prm.dstates;
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
    const float hv = ok ? prm.states[soff + (long long)pp * N + k] : 0.f;
    const float dv = ok ? prm.dstates[soff + (long long)pp * N + k] : 0.f;
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

inline bool shape_ok(int b, int t, int h, int g, int p, int n) {
  return b > 0 && t > 0 && h > 0 && g > 0 && h % g == 0 && p > 0 && p <= MAXP && n > 0 &&
         n <= MAXN && b < 65536 && h < 65536;
}

Params make_params(int b, int t, int h, int g, int p, int n) {
  Params prm{};
  prm.b = b;
  prm.t = t;
  prm.h = h;
  prm.g = g;
  prm.p = p;
  prm.n = n;
  prm.nc = (t + Q - 1) / Q;
  return prm;
}

template <typename T>
int launch_states(const void* x, const float* dt, const float* a_log, const void* bm,
                  const void* cm, const float* h0, const void* dy, const float* dh_last,
                  float* states, float* dstates, float* dh0, long long x_sb, long long x_st,
                  long long x_sh, long long b_sb, long long b_st, long long b_sg,
                  long long c_sb, long long c_st, long long c_sg, int b, int t, int h, int g,
                  int p, int n, void* stream) {
  if (!shape_ok(b, t, h, g, p, n)) return (int)cudaErrorInvalidValue;
  Params prm = make_params(b, t, h, g, p, n);
  prm.x = x; prm.dt = dt; prm.a_log = a_log; prm.bm = bm; prm.cm = cm; prm.h0 = h0;
  prm.dy = dy; prm.dh_last = dh_last; prm.states = states; prm.dstates = dstates;
  prm.dh0 = dh0;
  prm.x_sb = x_sb; prm.x_st = x_st; prm.x_sh = x_sh;
  prm.b_sb = b_sb; prm.b_st = b_st; prm.b_sg = b_sg;
  prm.c_sb = c_sb; prm.c_st = c_st; prm.c_sg = c_sg;
  dim3 grid(2 * ((p + ROWS - 1) / ROWS), h, b);
  ssd_bwd_states_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(prm);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_chunks(const void* x, const float* dt, const float* a_log, const void* bm,
                  const void* cm, const float* d_skip, const void* dy, const float* states,
                  const float* dstates, void* dx, float* ddt, float* db_part, float* dc_part,
                  float* head_part, long long x_sb, long long x_st, long long x_sh,
                  long long b_sb, long long b_st, long long b_sg, long long c_sb,
                  long long c_st, long long c_sg, int b, int t, int h, int g, int p, int n,
                  void* stream) {
  if (!shape_ok(b, t, h, g, p, n)) return (int)cudaErrorInvalidValue;
  Params prm = make_params(b, t, h, g, p, n);
  prm.x = x; prm.dt = dt; prm.a_log = a_log; prm.bm = bm; prm.cm = cm; prm.d_skip = d_skip;
  prm.dy = dy; prm.states = const_cast<float*>(states);
  prm.dstates = const_cast<float*>(dstates);
  prm.dx = dx; prm.ddt = ddt; prm.db_part = db_part; prm.dc_part = dc_part;
  prm.head_part = head_part;
  prm.x_sb = x_sb; prm.x_st = x_st; prm.x_sh = x_sh;
  prm.b_sb = b_sb; prm.b_st = b_st; prm.b_sg = b_sg;
  prm.c_sb = c_sb; prm.c_st = c_st; prm.c_sg = c_sg;
  cudaError_t e = cudaFuncSetAttribute(ssd_bwd_chunk_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)CHUNK_SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(prm.nc, h, b);
  ssd_bwd_chunk_kernel<T><<<grid, THREADS, CHUNK_SMEM, static_cast<cudaStream_t>(stream)>>>(prm);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_reduce(const float* db_part, const float* dc_part, const float* head_part,
                  const float* a_log, void* db, void* dc, float* da_log, float* dd_skip, int b,
                  int t, int h, int g, int p, int n, void* stream) {
  if (!shape_ok(b, t, h, g, p, n)) return (int)cudaErrorInvalidValue;
  Params prm = make_params(b, t, h, g, p, n);
  prm.db_part = const_cast<float*>(db_part);
  prm.dc_part = const_cast<float*>(dc_part);
  prm.head_part = const_cast<float*>(head_part);
  prm.a_log = a_log;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = (long long)b * t * g * n;
  const long long blocks = (total + THREADS - 1) / THREADS;
  ssd_bwd_sum_bc_kernel<T><<<(unsigned)(blocks < 4096 ? blocks : 4096), THREADS, 0, st>>>(
      prm, static_cast<T*>(db), static_cast<T*>(dc));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_sum_heads_kernel<<<(h + 127) / 128, 128, 0, st>>>(prm, da_log, dd_skip);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define STATES_ARGS                                                                    \
  const void *x, const float *dt, const float *a_log, const void *bm, const void *cm,  \
      const float *h0, const void *dy, const float *dh_last, float *states,             \
      float *dstates, float *dh0, long long x_sb, long long x_st, long long x_sh,       \
      long long b_sb, long long b_st, long long b_sg, long long c_sb, long long c_st,   \
      long long c_sg, int b, int t, int h, int g, int p, int n, void *stream
#define STATES_PASS                                                                    \
  x, dt, a_log, bm, cm, h0, dy, dh_last, states, dstates, dh0, x_sb, x_st, x_sh, b_sb,  \
      b_st, b_sg, c_sb, c_st, c_sg, b, t, h, g, p, n, stream
#define CHUNKS_ARGS                                                                    \
  const void *x, const float *dt, const float *a_log, const void *bm, const void *cm,  \
      const float *d_skip, const void *dy, const float *states, const float *dstates,   \
      void *dx, float *ddt, float *db_part, float *dc_part, float *head_part,           \
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

int ssd_bwd_states_f32(STATES_ARGS) { return launch_states<float>(STATES_PASS); }
int ssd_bwd_states_bf16(STATES_ARGS) { return launch_states<__nv_bfloat16>(STATES_PASS); }
int ssd_bwd_chunks_f32(CHUNKS_ARGS) { return launch_chunks<float>(CHUNKS_PASS); }
int ssd_bwd_chunks_bf16(CHUNKS_ARGS) { return launch_chunks<__nv_bfloat16>(CHUNKS_PASS); }
int ssd_bwd_reduce_f32(REDUCE_ARGS) { return launch_reduce<float>(REDUCE_PASS); }
int ssd_bwd_reduce_bf16(REDUCE_ARGS) { return launch_reduce<__nv_bfloat16>(REDUCE_PASS); }

}  // extern "C"
