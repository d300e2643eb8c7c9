// Flash attention for Hopper (sm_90a): blockwise online-softmax attention
// with grouped kv heads (GQA / MQA), a causal mask, a sliding window, an
// absolute q offset and an optional log-sum-exp output.
//
// Replaces the TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py:99, kernel body `_kernel`).  There the
// kv blocks are the sequential minor grid axis and the fp32 (acc, m, l) live in
// VMEM scratch across it.  Here one thread block owns a tile of q rows and
// walks its kv tiles in a loop, so nothing crosses blocks; kv tiles that
// cannot contribute under the causal mask or the window are never visited
// (at S = 4096, window 2048 a q tile visits about 33 of 64 kv tiles).
//
// What bounds it on this card: operations.  At the serving shape
// (4 x 4096 x 10 heads x 256, window 2048, bf16) the unmasked (q, k) pairs
// need about 258 GFLOP against about 185 MB of traffic, far above the card's
// ~295 FLOP per byte balance point: ~0.26 ms at the bf16 tensor-core peak.
//
// Two kernels, chosen by the input type in the launcher:
//
// * bfloat16 -> `flash_fwd_mma_kernel`, on the tensor cores.
//   - Products: warp-level mma.sync m16n8k16 bf16 -> fp32, fed by ldmatrix
//     (.trans for V).  Chosen over wgmma because the fp32 accumulator of
//     S = Q K^T is then, register for register, the A operand of P V (no trip
//     through shared memory, no operand descriptors or swizzle modes to match),
//     and every tile size stays a multiple of 16; mma.sync runs at a fraction
//     of wgmma's peak, which is still several times what the work needs to beat
//     cuDNN at the serving shape.  wgmma is the next step if this one is bound
//     by issue rate.
//   - Block: 8 warps, 128 rows, each warp 16 rows.  The rows are (position,
//     head) pairs of one kv group, position-major: at MQA with 10 q heads
//     (recurrentgemma-2b) one block holds 12.8 positions of all 10 heads, so
//     every head of the group that shares those positions reads each kv tile
//     from the same shared-memory copy, and a block's diagonal and window edge
//     cost at most two partly masked tiles for 13 positions.  Blocks start in
//     reverse order so the ones with the most kv tiles go first.
//   - Arithmetic: S = Q K^T in fp32 registers from q and k as given (products
//     of bf16 are exact in fp32); the fp32 scores are multiplied by `scale`
//     (times log2 e, for exp2) afterwards instead of scaling q first, so
//     against the plain version the difference is summation order plus one
//     fp32 rounding of the scale.  Masked scores are -1e30 and their p exactly
//     0 (a bit mask, not the score, decides); the running max and sum are fp32,
//     reduced over the four threads of a row with shuffles.  P is rounded to
//     bf16 once, in the A-fragment registers; O += P V accumulates in fp32
//     registers (at d 256 a warp's 16 x 256 slice is 128 registers a thread);
//     the output is rounded to bf16 once, the LSE stays fp32.  Only interior
//     kv tiles (inside the sequence, the causal bound and the window for every
//     row of the block) skip the per-element mask.  A row that sees no key gives
//     zeros and lse -1e30, as the TPU kernel does.
//   - Memory: q tile and two stages of (k, v) tiles in bf16 shared memory,
//     rows padded to the product width (a multiple of 16, zeros past d) plus
//     8 elements, so the 8 row addresses of an ldmatrix fall in 8 different
//     16-byte bank groups.  Tile t + 1 is loaded with 16-byte cp.async while
//     tile t computes.  At d 256: (128 + 2 x 2 x 64) x 264 x 2 B = 202,752 B,
//     one block per SM.  Rows whose global address is not 16-byte aligned
//     (a base pointer, a stride or d not a multiple of 8 elements) are loaded
//     by a slower path inside the same kernel: element by element, synchronously.
//   - Issue order: every fragment of a step is loaded before its products,
//     and the Q / K fragments of the next 16-deep step of S before the current
//     step's products (batching the loads took the serving shape from 2.36 to
//     1.6 ms on an H100; double-buffering the V fragments too needs more than 255
//     registers at d 256 and spills).  At d 256 the kernel uses 250 registers a
//     thread, so 8 warps (one block) per SM is also the register limit.
//   - Softmax exponentials are ex2.approx (one MUFU instruction).
//   - The output goes through shared memory (the warp's own q rows) and out in
//     16-byte stores.
//
// * float32 -> `flash_fwd_kernel<DMAX>`, on the CUDA cores: fp32 FMAs,
//   register-tiled (a thread computes a 4 x 4 block of scores and a 4-row slice
//   of p v from float4 shared-memory reads), q converted and multiplied by
//   `scale` before the products as the reference does.  Its 2e-5 check against
//   the plain version needs fp32 products; TF32 tensor cores would not meet it.
//   Shared memory: the q tile and one k and one v tile in fp32, rows padded to
//   a float4 multiple plus 4, plus the probability tile: (64 + 2 * 64) *
//   (d4 + 4) + 64 * 68 floats = 217,088 bytes at d = 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "sm90_mma.cuh"

namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // kv rows per tile
constexpr int THREADS = 256;  // a 16 x 16 grid: ty picks 4 q rows, tx columns
constexpr int RM = 4;         // q rows per thread
constexpr int SN = BK / 16;   // score columns per thread, tx + 16 j
constexpr int LDP = BK + 4;   // row stride of the probability tile
constexpr float NEG = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  long long q_sb, q_ss, q_sh;  // element strides (batch, seq, head); head_dim is 1
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int b, sq, skv, h, kvh, d;
  int causal, window, q_offset;  // window <= 0: no window
  float scale;
};

// rows [0, BQ or BK) x columns [0, d4) of a (seq, d) slice into shared memory,
// zeros past the sequence end and past d
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          long long row_stride, int row0, int rows,
                                          int n_rows, int d, int d4, float mul) {
  for (int i = threadIdx.x; i < rows * d4; i += THREADS) {
    const int r = i / d4, c = i - r * d4;
    const int s = row0 + r;
    dst[r * ld + c] = (s < n_rows && c < d) ? src[(long long)s * row_stride + c] * mul
                                            : 0.f;
  }
}

template <int DMAX>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(Params p) {
  constexpr int CV = DMAX / 64;  // float4 accumulator columns per q row and thread
  extern __shared__ __align__(16) float smem[];
  const int d = p.d;
  const int d4 = (d + 3) & ~3;
  const int ld = d4 + 4;         // float4-aligned rows, neighbours 4 banks apart
  float* qs = smem;              // BQ x ld, scaled q
  float* ks = qs + BQ * ld;      // BK x ld
  float* vs = ks + BK * ld;      // BK x ld
  float* ps = vs + BK * ld;      // BQ x LDP, probabilities of the tile

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;  // a row group's 16 threads share a warp
  const int q0 = blockIdx.x * BQ;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int kh = hh / (p.h / p.kvh);

  const float* qg = static_cast<const float*>(p.q) + bb * p.q_sb + hh * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + bb * p.k_sb + kh * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + bb * p.v_sb + kh * p.v_sh;
  load_tile(qs, ld, qg, p.q_ss, q0, BQ, p.sq, d, d4, p.scale);

  // kv tiles this q tile can see
  const int q_lo = p.q_offset + q0;
  const int q_hi = p.q_offset + min(q0 + BQ, p.sq) - 1;
  int kv_end = p.skv;
  if (p.causal) kv_end = min(kv_end, q_hi + 1);
  int kv_begin = 0;
  if (p.window > 0) kv_begin = max(0, q_lo - p.window + 1);
  const int t_begin = kv_begin / BK;
  const int t_end = kv_end > kv_begin ? (kv_end + BK - 1) / BK : t_begin;

  float m[RM], l[RM];
  float4 acc[RM][CV];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CV; ++j) acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's k, v and p are no longer read
    load_tile(ks, ld, kg, p.k_ss, k0, BK, p.skv, d, d4, 1.f);
    load_tile(vs, ld, vg, p.v_ss, k0, BK, p.skv, d, d4, 1.f);
    __syncthreads();

    // scores: rows ty * 4 + i, columns tx + 16 j
    float sc[RM][SN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < SN; ++j) sc[i][j] = 0.f;
    for (int c = 0; c < d4; c += 4) {
      float4 qv[RM], kv[SN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty * RM + i) * ld + c);
#pragma unroll
      for (int j = 0; j < SN; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * ld + c);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < SN; ++j) {
          float a = sc[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          sc[i][j] = fmaf(qv[i].w, kv[j].w, a);
        }
    }

    // mask, online softmax; a row's 16 threads reduce with shuffles
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty * RM + i;
      const int qpos = p.q_offset + q0 + r;
      float mx = NEG;
      unsigned ok_bits = 0;
#pragma unroll
      for (int j = 0; j < SN; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos < p.skv;
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.window > 0) ok = ok && kpos > qpos - p.window;
        if (ok) ok_bits |= 1u << j;
        sc[i][j] = ok ? sc[i][j] : NEG;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < SN; ++j) {
        const float pv = (ok_bits >> j) & 1u ? expf(sc[i][j] - m_new) : 0.f;
        ps[r * LDP + tx + 16 * j] = pv;
        rs += pv;
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < CV; ++j) {
        acc[i][j].x *= alpha;
        acc[i][j].y *= alpha;
        acc[i][j].z *= alpha;
        acc[i][j].w *= alpha;
      }
    }
    __syncwarp();  // rows ty * 4 + i are written and read by one warp only

    // acc += p v: rows ty * 4 + i, columns 4 tx + 64 j .. + 3
    for (int n = 0; n < BK; ++n) {
      float pv[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) pv[i] = ps[(ty * RM + i) * LDP + n];
      const float* vr = vs + n * ld;
#pragma unroll
      for (int j = 0; j < CV; ++j) {
        const int c = 4 * tx + 64 * j;
        if (c < d4) {
          const float4 v4 = *reinterpret_cast<const float4*>(vr + c);
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            acc[i][j].x = fmaf(pv[i], v4.x, acc[i][j].x);
            acc[i][j].y = fmaf(pv[i], v4.y, acc[i][j].y);
            acc[i][j].z = fmaf(pv[i], v4.z, acc[i][j].z);
            acc[i][j].w = fmaf(pv[i], v4.w, acc[i][j].w);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty * RM + i;
    if (q0 + r >= p.sq) continue;
    const float safe = fmaxf(l[i], 1e-30f);
    const long long orow = ((long long)bb * p.sq + q0 + r) * p.h + hh;
    float* og = static_cast<float*>(p.o) + orow * d;
#pragma unroll
    for (int j = 0; j < CV; ++j) {
      const int c = 4 * tx + 64 * j;
      const float vals[4] = {acc[i][j].x, acc[i][j].y, acc[i][j].z, acc[i][j].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < d) og[c + e] = vals[e] / safe;
    }
    if (p.lse != nullptr && tx == 0) p.lse[orow] = m[i] + logf(safe);
  }
}

template <int DMAX>
int launch_dmax(const Params& p, cudaStream_t stream) {
  const int ld = ((p.d + 3) & ~3) + 4;
  const size_t smem = sizeof(float) * ((size_t)(BQ + 2 * BK) * ld + BQ * LDP);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((p.sq + BQ - 1) / BQ, p.h, p.b);
  flash_fwd_kernel<DMAX><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- bf16, tensor cores
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int BM = 128;              // rows of a block: (position, head) pairs
constexpr int BN = 64;               // kv rows per tile
constexpr int WARPS = BM / 16;       // 16 rows per warp
constexpr int THREADS = 32 * WARPS;
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ inline int pad16(int d) { return (d + 15) & ~15; }

__host__ __device__ inline size_t smem_bytes(int d) {
  return sizeof(bf16) * (size_t)(pad16(d) + 8) * (BM + 2 * 2 * BN);
}

// q rows [m0, m0 + BM) of the group: row m is position m / g, head m % g
__device__ __forceinline__ void load_q(bf16* dst, int ld, const bf16* qg, const Params& p,
                                       int m0, int g, bool aligned) {
  if (aligned) {
    const int cpr = p.d / 8;  // 16-byte chunks per row
    for (int i = threadIdx.x; i < BM * cpr; i += THREADS) {
      const int r = i / cpr, c = i - r * cpr;
      const int s = (m0 + r) / g, j = (m0 + r) - s * g;
      const bool ok = s < p.sq;
      const bf16* src = ok ? qg + s * p.q_ss + j * p.q_sh + 8 * c : qg;
      sm90::cp_async16(sm90::smem_addr(dst + r * ld + 8 * c), src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < BM * p.d; i += THREADS) {
      const int r = i / p.d, c = i - r * p.d;
      const int s = (m0 + r) / g, j = (m0 + r) - s * g;
      dst[r * ld + c] = s < p.sq ? qg[s * p.q_ss + j * p.q_sh + c] : __float2bfloat16(0.f);
    }
  }
}

// kv rows [k0, k0 + BN) of one head: zeros past the sequence end
__device__ __forceinline__ void load_kv(bf16* dst, int ld, const bf16* src, long long ss,
                                        int k0, const Params& p, bool aligned) {
  if (aligned) {
    const int cpr = p.d / 8;
    for (int i = threadIdx.x; i < BN * cpr; i += THREADS) {
      const int r = i / cpr, c = i - r * cpr;
      const bool ok = k0 + r < p.skv;
      sm90::cp_async16(sm90::smem_addr(dst + r * ld + 8 * c),
                       ok ? src + (k0 + r) * ss + 8 * c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < BN * p.d; i += THREADS) {
      const int r = i / p.d, c = i - r * p.d;
      dst[r * ld + c] = k0 + r < p.skv ? src[(k0 + r) * ss + c] : __float2bfloat16(0.f);
    }
  }
}

// the Q and K fragments of one 16-deep step of S = Q K^T
__device__ __forceinline__ void load_qk(uint32_t (&a)[4], uint32_t (&b)[BN / 16][4],
                                        const bf16* q_row, const bf16* k_row, int ld, int kk) {
  sm90::ldsm_x4(a, sm90::smem_addr(q_row + kk * 16));
#pragma unroll
  for (int jj = 0; jj < BN / 16; ++jj)
    sm90::ldsm_x4(b[jj], sm90::smem_addr(k_row + jj * 16 * ld + kk * 16));
}

template <int DMAX>
__global__ void __launch_bounds__(THREADS, 1) flash_fwd_mma_kernel(const Params p, int aligned) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d = p.d, d16 = pad16(d), ld = d16 + 8, nk = d16 / 16;
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // BM x ld, later the output tile
  bf16* sK = sQ + BM * ld;                       // 2 stages of BN x ld
  bf16* sV = sK + 2 * BN * ld;                   // 2 stages of BN x ld

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = p.h / p.kvh;
  const int rows = p.sq * g;
  const int m0 = (gridDim.x - 1 - blockIdx.x) * BM;  // most kv tiles first
  const int kh = blockIdx.y, bb = blockIdx.z;
  const bf16* qg = static_cast<const bf16*>(p.q) + bb * p.q_sb + (long long)kh * g * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + bb * p.k_sb + kh * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + bb * p.v_sb + kh * p.v_sh;

  // kv tiles some row of this block can see
  const int q_lo = p.q_offset + m0 / g;
  const int q_hi = p.q_offset + (min(m0 + BM, rows) - 1) / g;
  int kv_end = p.skv;
  if (p.causal) kv_end = min(kv_end, q_hi + 1);
  int kv_begin = 0;
  if (p.window > 0) kv_begin = max(0, q_lo - p.window + 1);
  const int t_begin = kv_begin / BN;
  const int t_end = kv_end > kv_begin ? (kv_end + BN - 1) / BN : t_begin;

  if (d != d16) {  // the product reads columns [d, d16): zeros, once
    const int n16 = (int)(smem_bytes(d) / 16);
    for (int i = threadIdx.x; i < n16; i += THREADS)
      reinterpret_cast<uint4*>(smem_raw)[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
  }
  load_q(sQ, ld, qg, p, m0, g, aligned);
  if (t_begin < t_end) {
    load_kv(sK, ld, kg, p.k_ss, t_begin * BN, p, aligned);
    load_kv(sV, ld, vg, p.v_ss, t_begin * BN, p, aligned);
  }
  sm90::cp_async_commit();

  // this thread's rows: r0 = 16 warp + lane / 4 and r0 + 8
  const int r0 = warp * 16 + lane / 4;
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) qpos[i] = p.q_offset + (m0 + r0 + 8 * i) / g;
  const int c2 = 2 * (lane & 3);  // first of this thread's two columns in a tile
  const int mi = lane >> 3;       // which ldmatrix matrix this lane addresses
  const float sl2 = p.scale * LOG2E;

  float o[DMAX / 8][4];
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f};  // l: this thread's columns only

  for (int t = t_begin; t < t_end; ++t) {
    const int st = (t - t_begin) & 1;
    sm90::cp_async_wait_all();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1's stage
    if (t + 1 < t_end) {
      load_kv(sK + (st ^ 1) * BN * ld, ld, kg, p.k_ss, (t + 1) * BN, p, aligned);
      load_kv(sV + (st ^ 1) * BN * ld, ld, vg, p.v_ss, (t + 1) * BN, p, aligned);
    }
    sm90::cp_async_commit();
    const bf16* cK = sK + st * BN * ld;
    const bf16* cV = sV + st * BN * ld;
    const int k0 = t * BN;

    // S = Q K^T: 16 rows x 64 keys per warp, 8 tiles of 8 keys.  The asm of
    // ldmatrix and mma is volatile, so the source order is the issue order: the
    // fragments of step kk + 1 are loaded before the products of step kk
    float s[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const bf16* q_row = sQ + (warp * 16 + (lane & 15)) * ld + (lane >> 4) * 8;
    const bf16* k_row = cK + ((mi >> 1) * 8 + (lane & 7)) * ld + (mi & 1) * 8;
    uint32_t qa[2][4], kb[2][BN / 16][4];
    load_qk(qa[0], kb[0], q_row, k_row, ld, 0);
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk) {
      if (kk < nk) {
        if (kk + 1 < nk) load_qk(qa[(kk + 1) & 1], kb[(kk + 1) & 1], q_row, k_row, ld, kk + 1);
#pragma unroll
        for (int jj = 0; jj < BN / 16; ++jj) {
          sm90::mma_bf16(s[2 * jj], qa[kk & 1], kb[kk & 1][jj][0], kb[kk & 1][jj][1]);
          sm90::mma_bf16(s[2 * jj + 1], qa[kk & 1], kb[kk & 1][jj][2], kb[kk & 1][jj][3]);
        }
      }
    }

    // mask: element (j, e) is key k0 + 8 j + c2 + (e & 1) of row r0 + 8 (e >> 1)
    const bool interior = k0 + BN <= p.skv && (!p.causal || k0 + BN - 1 <= q_lo) &&
                          (p.window <= 0 || k0 > q_hi - p.window);
    uint32_t okb = 0xffffffffu;
    if (!interior) {
      okb = 0u;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + c2 + (e & 1), qp = qpos[e >> 1];
          bool ok = key < p.skv;
          if (p.causal) ok = ok && key <= qp;
          if (p.window > 0) ok = ok && key > qp - p.window;
          if (ok) okb |= 1u << (4 * j + e);
          else s[j][e] = NEG;
        }
    }

    // online softmax over the row's four threads
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2], mb[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = sm90::ex2((m_run[i] - mx[i]) * sl2);
      m_run[i] = mx[i];
      mb[i] = mx[i] * sl2;
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv =
            (okb >> (4 * j + e)) & 1u ? sm90::ex2(fmaf(s[j][e], sl2, -mb[e >> 1])) : 0.f;
        s[j][e] = pv;
        rs[e >> 1] += pv;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_run[i] = alpha[i] * l_run[i] + rs[i];
#pragma unroll
    for (int n = 0; n < DMAX / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V: P rounded to bf16 in the A fragments (the layout of S); four
    // V fragments loaded, then their eight products
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t pa[4] = {sm90::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
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
              sm90::ldsm_x4_t(b[u], sm90::smem_addr(cV + (kk * 16 + (mi & 1) * 8 + (lane & 7)) *
                                                        ld + (d4 * 4 + u) * 16 + (mi >> 1) * 8));
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (d4 * 4 + u < nk) {
              sm90::mma_bf16(o[2 * (d4 * 4 + u)], pa, b[u][0], b[u][1]);
              sm90::mma_bf16(o[2 * (d4 * 4 + u) + 1], pa, b[u][2], b[u][3]);
            }
        }
      }
    }
  }

  // epilogue: o / l rounded once to bf16 into this warp's own q rows, then out
  sm90::cp_async_wait_all();
  __syncthreads();  // with no visible tile the q copies may still be in flight
  float safe[2], lse[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    safe[i] = fmaxf(l, 1e-30f);
    lse[i] = l > 0.f ? m_run[i] * p.scale + logf(l) : NEG;
  }
  bf16* sO = sQ;
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n) {
    if (n < d16 / 8) {
      *reinterpret_cast<uint32_t*>(sO + r0 * ld + 8 * n + c2) =
          sm90::pack_bf16(o[n][0] / safe[0], o[n][1] / safe[0]);
      *reinterpret_cast<uint32_t*>(sO + (r0 + 8) * ld + 8 * n + c2) =
          sm90::pack_bf16(o[n][2] / safe[1], o[n][3] / safe[1]);
    }
  }
  __syncwarp();
  bf16* og = static_cast<bf16*>(p.o);
  const long long head0 = (long long)kh * g;
  if (d % 8 == 0) {  // 16-byte rows: the output is contiguous
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
  if (p.lse != nullptr && (lane & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + r0 + 8 * i, s = m / g;
      if (s < p.sq) p.lse[((long long)bb * p.sq + s) * p.h + head0 + m - s * g] = lse[i];
    }
  }
}

inline bool stride_ok(long long stride, int extent) { return extent <= 1 || stride % 8 == 0; }

template <int DMAX>
int launch_mma(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.d);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_mma_kernel<DMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // 16-byte cp.async needs every row start 16-byte aligned
  const bool aligned =
      p.d % 8 == 0 &&
      ((reinterpret_cast<uintptr_t>(p.q) | reinterpret_cast<uintptr_t>(p.k) |
        reinterpret_cast<uintptr_t>(p.v)) & 15) == 0 &&
      stride_ok(p.q_sb, p.b) && stride_ok(p.q_ss, p.sq) && stride_ok(p.q_sh, p.h) &&
      stride_ok(p.k_sb, p.b) && stride_ok(p.k_ss, p.skv) && stride_ok(p.k_sh, p.kvh) &&
      stride_ok(p.v_sb, p.b) && stride_ok(p.v_ss, p.skv) && stride_ok(p.v_sh, p.kvh);
  const int rows = p.sq * (p.h / p.kvh);
  dim3 grid((rows + BM - 1) / BM, p.kvh, p.b);
  flash_fwd_mma_kernel<DMAX><<<grid, THREADS, smem, stream>>>(p, aligned ? 1 : 0);
  return (int)cudaGetLastError();
}

}  // namespace tc

// float32 -> the CUDA-core kernel, bfloat16 -> the tensor-core kernel
int launch(bool bf16, const void* q, const void* k, const void* v, void* o, float* lse,
           long long q_sb, long long q_ss, long long q_sh, long long k_sb,
           long long k_ss, long long k_sh, long long v_sb, long long v_ss,
           long long v_sh, int b, int sq, int skv, int h, int kvh, int d,
           int causal, int window, int q_offset, float scale, void* stream) {
  if (b <= 0 || sq <= 0 || h <= 0) return (int)cudaSuccess;
  if (d <= 0 || d > 256 || kvh <= 0 || h % kvh != 0 || skv <= 0 ||
      (long long)sq * (h / kvh) > 0x3fffffffLL)
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, lse, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           b, sq, skv, h, kvh, d, causal, window, q_offset, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (d <= 64) return tc::launch_mma<64>(p, s);
    if (d <= 128) return tc::launch_mma<128>(p, s);
    return tc::launch_mma<256>(p, s);
  }
  if (d <= 64) return launch_dmax<64>(p, s);
  if (d <= 128) return launch_dmax<128>(p, s);
  return launch_dmax<256>(p, s);
}

}  // namespace

extern "C" {

#define FLASH_ARGS                                                             \
  const void *q, const void *k, const void *v, void *o, float *lse,            \
      long long q_sb, long long q_ss, long long q_sh, long long k_sb,          \
      long long k_ss, long long k_sh, long long v_sb, long long v_ss,          \
      long long v_sh, int b, int sq, int skv, int h, int kvh, int d,           \
      int causal, int window, int q_offset, float scale, void *stream
#define FLASH_PASS                                                             \
  q, k, v, o, lse, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, b,     \
      sq, skv, h, kvh, d, causal, window, q_offset, scale, stream

int flash_attention_fwd_f32(FLASH_ARGS) { return launch(false, FLASH_PASS); }

int flash_attention_fwd_bf16(FLASH_ARGS) { return launch(true, FLASH_PASS); }

}  // extern "C"
