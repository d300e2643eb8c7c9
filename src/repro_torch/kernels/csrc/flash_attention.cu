// Flash attention for Hopper (sm_90a): blockwise online-softmax attention
// with grouped kv heads (GQA / MQA), a causal mask, a sliding window, an
// absolute q offset and an optional log-sum-exp output.
//
// Replaces the TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py:99, kernel body `_kernel`).  There the
// kv blocks are the sequential minor grid axis and the fp32 (acc, m, l) live in
// VMEM scratch across it.  Here one thread block owns one (batch, head, q tile)
// and walks its kv tiles in a loop, so nothing crosses blocks; kv tiles that
// cannot contribute under the causal mask or the window are never visited,
// which is what makes the window pay (at S = 4096, window 2048 the later q
// tiles visit about half the kv tiles).
//
// What bounds it on this card: operations.  At the serving shape
// (4 x 4096 x 10 heads x 256, window 2048, bf16) the unmasked (q, k) pairs
// need about 258 GFLOP against about 185 MB of traffic, which is far above the
// card's ~295 FLOP per byte balance point; at the bf16 tensor-core peak the
// work takes ~0.26 ms.  This version does its products as fp32 FMAs on the
// CUDA cores (67 TFLOP/s peak), so it sits well above that bound; wgmma with
// TMA-fed tiles in bf16 is a later step.  What it does about the bound today:
//   * masked kv tiles are skipped, so the work follows the band, not S^2;
//   * the q tile is loaded and scaled once and stays in shared memory for all
//     its kv tiles, and the running (m, l, acc) never leave registers: the
//     64 x 256 fp32 accumulator is split over the 256 threads (4 rows x 64
//     columns each; 16 threads per 4-row group, inside one warp);
//   * register tiling: a thread computes a 4 x 4 block of scores and a 4-row
//     slice of p v from float4 shared-memory reads, 8 FMAs per shared load
//     (the first version, one row and 8 columns per thread, did 1 and was
//     bound by shared-memory loads).
//
// MQA: all heads of a group read the same kv rows.  Their blocks fetch them
// independently and the reuse is left to L2; sharing a kv tile between the
// heads of a group inside one block is what a faster design exploits.
//
// Arithmetic: q is converted to fp32 and multiplied by `scale` before the
// products (as the reference does); scores, the running max / sum and the
// accumulator are fp32; the output is rounded to the input type once, at the
// end.  Masked scores are -1e30 and their probabilities exactly 0, so a row
// with no visible key yields zeros and lse -1e30 (the TPU kernel's behaviour).
//
// Shared memory: the q tile and one k and one v tile in fp32, rows padded to
// a float4 multiple plus 4 (neighbouring rows 4 banks apart), plus the
// probability tile: (64 + 2 * 64) * (d4 + 4) + 64 * 68 floats = 217,088 bytes
// at d = 256, above the 48 KB default, so the launcher raises the limit first
// (one block per SM at d = 256).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// rows [0, BQ or BK) x columns [0, d4) of a (seq, d) slice into shared memory as
// fp32, zeros past the sequence end and past d
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long row_stride, int row0, int rows,
                                          int n_rows, int d, int d4, float mul) {
  for (int i = threadIdx.x; i < rows * d4; i += THREADS) {
    const int r = i / d4, c = i - r * d4;
    const int s = row0 + r;
    dst[r * ld + c] = (s < n_rows && c < d) ? to_f(src[(long long)s * row_stride + c]) * mul
                                            : 0.f;
  }
}

template <typename T, int DMAX>
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

  const T* qg = static_cast<const T*>(p.q) + bb * p.q_sb + hh * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + bb * p.k_sb + kh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + bb * p.v_sb + kh * p.v_sh;
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
    T* og = static_cast<T*>(p.o) + orow * d;
#pragma unroll
    for (int j = 0; j < CV; ++j) {
      const int c = 4 * tx + 64 * j;
      const float vals[4] = {acc[i][j].x, acc[i][j].y, acc[i][j].z, acc[i][j].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < d) og[c + e] = from_f<T>(vals[e] / safe);
    }
    if (p.lse != nullptr && tx == 0) p.lse[orow] = m[i] + logf(safe);
  }
}

template <typename T, int DMAX>
int launch_dmax(const Params& p, cudaStream_t stream) {
  const int ld = ((p.d + 3) & ~3) + 4;
  const size_t smem = sizeof(float) * ((size_t)(BQ + 2 * BK) * ld + BQ * LDP);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((p.sq + BQ - 1) / BQ, p.h, p.b);
  flash_fwd_kernel<T, DMAX><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           long long q_sb, long long q_ss, long long q_sh, long long k_sb,
           long long k_ss, long long k_sh, long long v_sb, long long v_ss,
           long long v_sh, int b, int sq, int skv, int h, int kvh, int d,
           int causal, int window, int q_offset, float scale, void* stream) {
  if (b <= 0 || sq <= 0 || h <= 0) return (int)cudaSuccess;
  if (d <= 0 || d > 256 || kvh <= 0 || h % kvh != 0 || skv <= 0)
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, lse, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           b, sq, skv, h, kvh, d, causal, window, q_offset, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64) return launch_dmax<T, 64>(p, s);
  if (d <= 128) return launch_dmax<T, 128>(p, s);
  return launch_dmax<T, 256>(p, s);
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

int flash_attention_fwd_f32(FLASH_ARGS) { return launch<float>(FLASH_PASS); }

int flash_attention_fwd_bf16(FLASH_ARGS) { return launch<__nv_bfloat16>(FLASH_PASS); }

}  // extern "C"
