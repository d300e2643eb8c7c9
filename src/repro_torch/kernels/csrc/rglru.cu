// RG-LRU scan for Hopper (sm_90a): h_t = a_t * h_{t-1} + x_t over (B, T, D)
// with an fp32 carry, writing every h_t.
//
// Replaces the TPU kernel `rglru_pallas` (src/repro/kernels/rglru.py:41, kernel
// body `_kernel`).  There the time axis is the sequential grid axis and the
// carry sits in VMEM scratch between time blocks; here every (batch, channel)
// pair is one lane that keeps h in a register and walks t in order, so the
// kernel computes what the TPU kernel and the plain version compute.  The gate
// math (a = exp(-c softplus(a_param) a_gate), x = sqrt(1 - a^2) i x) stays
// outside, in PyTorch, as it stays outside the TPU kernel.
//
// What bounds it on this card: bytes.  It reads a and x and writes y once,
// 12 bytes per element for 2 operations, so at the prefill shape
// (4 x 4096 x 2560 fp32, 503 MB) the least time is ~0.15 ms at 3.35 TB/s.
// The dependent chain (T steps of a multiply and an add, ~20 us at T = 4096)
// is well under that, so the design is about keeping enough loads in flight
// on enough SMs:
//
//   * a warp owns 32 consecutive channels of one batch row (one warp per
//     block: B * ceil(D / 32) blocks, 320 at the prefill shape, on all 132
//     SMs);
//   * the loads are decoupled from the recurrence: the warp keeps a ring of
//     STAGES tiles of (TILE_T steps x 32 channels) of a and x in shared
//     memory, filled by cp.async, so while the lanes run the recurrence out
//     of one tile the copies of the next STAGES - 1 are in flight (320 warps
//     x 3 tiles x 8 KB = 7.9 MB at the prefill shape, where the card needs
//     ~2.3 MB);
//   * each step's y is stored straight from registers, 128 bytes a warp,
//     coalesced.
//
// Rows that are 16-byte aligned (D % 4 == 0) are copied 16 bytes a lane; the
// others element by element, in the same kernel.  A partial last tile and the
// lanes past D are masked.  A single step (T = 1, every decode step) takes a
// second kernel, one thread per (batch, channel) with direct loads: nothing
// there to pipeline.
//
// The update is written as two separately rounded operations
// (__fmul_rn, __fadd_rn): nvcc would otherwise contract a * h + x into one
// FMA, and the plain PyTorch version rounds twice.  With that the kernel is
// bit-equal to it.
//
//
// The backward (`rglru_scan_bwd_kernel`) is the reverse scan of the adjoint,
// the math of the reference's `_scan_bwd` (src/repro/kernels/rglru_xla.py:56):
//
//   g_t = dy_t + a_{t+1} g_{t+1}  (g_{T-1} = dy_{T-1} + dh_last),
//   dx_t = g_t,  da_t = g_t h_{t-1},  dh0 = a_0 g_0,
//
// with h_{t-1} read from the saved states y (h0, or 0, before the first
// step): nothing is recomputed.  It reads a, y and dy and writes dx and da,
// 20 bytes per element: ~0.063 ms at the training shape (1 x 4096 x 2560) at
// 3.35 TB/s, so it is bound by bytes too.  Its layout is built for batch 1,
// where a warp per 32 channels gives 80 warps for 132 SMs:
//
//   * a warp owns G = 8 or 32 consecutive channels of one batch row (the
//     wrapper picks G from the grid against the SM count: G = 8 gives 320
//     one-warp blocks at the training shape, G = 32 keeps 128-byte rows where
//     the batch alone fills the card).  Each channel's recurrence runs
//     on Q = 32 / G lanes at once, the same operations on the same values, so
//     every lane holds the same g; lane k of a channel stores steps k, k + Q,
//     ..., so one store instruction writes Q steps of G channels;
//   * the a, dy and shifted-y tiles (32 steps x G channels) stream backwards
//     through a ring of cp.async stages deep enough to keep ~5 MB card-wide in
//     flight (G = 8: 6 stages, 18 KB; G = 32: 3, 36 KB);
//   * only the add and the multiply of the recurrence wait on the carry: a
//     full tile's a and dy are read into registers before its 32 steps run
//     unrolled, and h0 (or 0) is written into the shifted-y tile's first row,
//     so the loop has no branch; the partial last tile (T % 32 steps) runs
//     first, in a plain loop.  Offsets are 32-bit (the wrapper refuses
//     B T D >= 2^31).
//
// Every add and multiply is rounded on its own (__fadd_rn, __fmul_rn), in the
// order of the plain version, whatever G, so it is bit-equal to it.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "sm90_mma.cuh"  // the cp.async helpers

namespace {

constexpr int LANES = 32;                     // channels per warp
constexpr int TILE_T = 32;                    // time steps per tile
constexpr int STAGES = 4;                     // tiles in the ring
constexpr int TILE = TILE_T * LANES;          // floats of one array in one tile
constexpr int STEP_THREADS = 128;

// wait until at most N of this thread's cp.async groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy steps [t0, t0 + TILE_T) of channels [c0, c0 + 32) of one array into a
// (TILE_T x 32) tile; steps past t and channels past d are not copied.
template <bool VEC>
__device__ __forceinline__ void load_tile(float* tile, const float* __restrict__ src,
                                          long long row0, int t0, int t, int c0, int d,
                                          int lane) {
  if (VEC) {
    // 8 lanes cover one step's 128 bytes, a warp 4 steps per instruction
    const int col = 4 * (lane & 7);
#pragma unroll
    for (int k = 0; k < TILE_T / 4; ++k) {
      const int r = 4 * k + (lane >> 3);
      if (t0 + r < t && c0 + col < d)
        sm90::cp_async16(sm90::smem_addr(tile + r * LANES + col),
                         src + (row0 + t0 + r) * d + c0 + col, true);
    }
  } else {
#pragma unroll 8
    for (int r = 0; r < TILE_T; ++r) {
      if (t0 + r < t && c0 + lane < d)
        sm90::cp_async4(sm90::smem_addr(tile + r * LANES + lane),
                        src + (row0 + t0 + r) * d + c0 + lane, true);
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(LANES)
    rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ x,
                      const float* __restrict__ h0, float* __restrict__ y, int t, int d) {
  __shared__ __align__(16) float ring[STAGES][2][TILE];
  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * LANES;
  const int c = c0 + lane;
  const bool live = c < d;
  const long long row0 = (long long)blockIdx.y * t;
  const int n_tiles = (t + TILE_T - 1) / TILE_T;

  float h = (h0 != nullptr && live) ? h0[(long long)blockIdx.y * d + c] : 0.f;
  float* yp = y + row0 * d + c;

  // prologue: the first STAGES - 1 tiles in flight (empty groups past the end
  // keep the group count, and so the wait below, the same for every tile)
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) {
      load_tile<VEC>(ring[s][0], a, row0, s * TILE_T, t, c0, d, lane);
      load_tile<VEC>(ring[s][1], x, row0, s * TILE_T, t, c0, d, lane);
    }
    sm90::cp_async_commit();
  }
  for (int j = 0; j < n_tiles; ++j) {
    // refill the slot the previous tile used (every lane is past it: the
    // __syncwarp at the end of the last iteration)
    const int nj = j + STAGES - 1;
    if (nj < n_tiles) {
      load_tile<VEC>(ring[nj % STAGES][0], a, row0, nj * TILE_T, t, c0, d, lane);
      load_tile<VEC>(ring[nj % STAGES][1], x, row0, nj * TILE_T, t, c0, d, lane);
    }
    sm90::cp_async_commit();
    cp_async_wait<STAGES - 1>();  // this lane's copies of tile j have landed
    __syncwarp();                 // ... and every other lane's
    const float* ta = ring[j % STAGES][0];
    const float* tx = ring[j % STAGES][1];
    const int t0 = j * TILE_T;
    if (t0 + TILE_T <= t) {
#pragma unroll
      for (int r = 0; r < TILE_T; ++r) {
        h = __fadd_rn(__fmul_rn(ta[r * LANES + lane], h), tx[r * LANES + lane]);
        if (live) yp[(long long)(t0 + r) * d] = h;
      }
    } else {
      for (int r = 0; r < t - t0; ++r) {
        h = __fadd_rn(__fmul_rn(ta[r * LANES + lane], h), tx[r * LANES + lane]);
        if (live) yp[(long long)(t0 + r) * d] = h;
      }
    }
    __syncwarp();
  }
}

// one step per (batch, channel): the decode path (T = 1)
__global__ void __launch_bounds__(STEP_THREADS)
    rglru_scan_step_kernel(const float* __restrict__ a, const float* __restrict__ x,
                           const float* __restrict__ h0, float* __restrict__ y, int d) {
  const int c = blockIdx.x * STEP_THREADS + threadIdx.x;
  if (c >= d) return;
  const long long i = (long long)blockIdx.y * d + c;
  const float h = h0 != nullptr ? h0[i] : 0.f;
  y[i] = __fadd_rn(__fmul_rn(a[i], h), x[i]);
}

constexpr int BWD_TILE_T = 32;  // time steps per tile of the backward

// the backward's layout at G channels a warp: Q lanes per channel, the ring's
// depth and the floats of one array in one tile
template <int G>
struct BwdLayout {
  static_assert(G == 8 || G == 32, "8 or 32 channels a warp");
  static constexpr int Q = LANES / G;
  static constexpr int STAGES = G == 32 ? 3 : 6;
  static constexpr int TILE = BWD_TILE_T * G;
};

// Copy steps [s0, s0 + BWD_TILE_T) of channels [c0, c0 + G) of one array into
// a (BWD_TILE_T x G) tile; steps outside [0, t) and channels past d are not
// copied.
template <int G, bool VEC>
__device__ __forceinline__ void load_bwd_tile(float* tile, const float* __restrict__ src,
                                              int row0, int s0, int t, int c0, int d,
                                              int lane) {
  constexpr int PER_ROW = VEC ? G / 4 : G;       // copies per tile row
  constexpr int ROWS = LANES / PER_ROW;           // tile rows per warp instruction
  const int col = (VEC ? 4 : 1) * (lane % PER_ROW);
#pragma unroll
  for (int i = 0; i < BWD_TILE_T / ROWS; ++i) {
    const int r = i * ROWS + lane / PER_ROW, s = s0 + r;
    if (s >= 0 && s < t && c0 + col < d) {
      if (VEC)
        sm90::cp_async16(sm90::smem_addr(tile + r * G + col), src + (row0 + s) * d + c0 + col,
                         true);
      else
        sm90::cp_async4(sm90::smem_addr(tile + r * G + col), src + (row0 + s) * d + c0 + col,
                        true);
    }
  }
}

// tile q (steps [q BWD_TILE_T, q BWD_TILE_T + BWD_TILE_T)) of a, dy and the
// states one step earlier into ring slot `slot`
template <int G, bool VEC>
__device__ __forceinline__ void load_bwd_stage(float (*slot)[BwdLayout<G>::TILE],
                                               const float* a, const float* dy,
                                               const float* y, int row0, int q, int t, int c0,
                                               int d, int lane) {
  const int t0 = q * BWD_TILE_T;
  load_bwd_tile<G, VEC>(slot[0], a, row0, t0, t, c0, d, lane);
  load_bwd_tile<G, VEC>(slot[1], dy, row0, t0, t, c0, d, lane);
  load_bwd_tile<G, VEC>(slot[2], y, row0, t0 - 1, t, c0, d, lane);
}

template <int G, bool VEC>
__global__ void __launch_bounds__(LANES)
    rglru_scan_bwd_kernel(const float* __restrict__ a, const float* __restrict__ y,
                          const float* __restrict__ h0, const float* __restrict__ dy,
                          const float* __restrict__ dh_last, float* __restrict__ dx,
                          float* __restrict__ da, float* __restrict__ dh0, int t, int d) {
  using L = BwdLayout<G>;
  constexpr int Q = L::Q, STAGES = L::STAGES;
  __shared__ __align__(16) float ring[STAGES][3][L::TILE];
  const int lane = threadIdx.x;
  const int c = lane % G;      // this lane's channel in the group
  const int k = lane / G;      // it stores the steps that are k mod Q
  const int c0 = blockIdx.x * G;
  const bool live = c0 + c < d;
  const int row0 = blockIdx.y * t;
  const int hrow = blockIdx.y * d + c0 + c;
  const int n_tiles = (t + BWD_TILE_T - 1) / BWD_TILE_T;

  float carry = (dh_last != nullptr && live) ? dh_last[hrow] : 0.f;  // a_{t+1} g_{t+1}

  // tiles are taken last first: ring position j holds tile n_tiles - 1 - j
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles)
      load_bwd_stage<G, VEC>(ring[s], a, dy, y, row0, n_tiles - 1 - s, t, c0, d, lane);
    sm90::cp_async_commit();
  }
  for (int j = 0; j < n_tiles; ++j) {
    const int nj = j + STAGES - 1;
    if (nj < n_tiles)
      load_bwd_stage<G, VEC>(ring[nj % STAGES], a, dy, y, row0, n_tiles - 1 - nj, t, c0, d,
                             lane);
    sm90::cp_async_commit();
    cp_async_wait<STAGES - 1>();
    const float* ta = ring[j % STAGES][0];
    const float* tg = ring[j % STAGES][1];
    float* th = ring[j % STAGES][2];
    const int t0 = (n_tiles - 1 - j) * BWD_TILE_T;
    // the state before step 0 (no copy lands in that row)
    if (t0 == 0 && k == 0) th[c] = (h0 != nullptr && live) ? h0[hrow] : 0.f;
    __syncwarp();
    // this lane's element of step t0 + k (k * d apart from step t0's)
    float* dxp = dx + ((row0 + t0) * d + c0 + c) + k * d;
    float* dap = da + ((row0 + t0) * d + c0 + c) + k * d;
    const float* thp = th + lane;  // row k, channel c
    if (t0 + BWD_TILE_T <= t) {
      float ra[BWD_TILE_T], rg[BWD_TILE_T];
#pragma unroll
      for (int r = BWD_TILE_T - 1; r >= 0; --r) {
        ra[r] = ta[r * G + c];
        rg[r] = tg[r * G + c];
      }
#pragma unroll
      for (int r0 = BWD_TILE_T - Q; r0 >= 0; r0 -= Q) {
        float g[Q];
#pragma unroll
        for (int i = Q - 1; i >= 0; --i) {
          g[i] = __fadd_rn(rg[r0 + i], carry);
          carry = __fmul_rn(ra[r0 + i], g[i]);
        }
        float mine = g[0];
#pragma unroll
        for (int i = 1; i < Q; ++i)
          if (k == i) mine = g[i];
        if (live) {
          dxp[r0 * d] = mine;
          dap[r0 * d] = __fmul_rn(mine, thp[r0 * G]);
        }
      }
    } else {  // the partial tile: steps [t0, t)
      for (int r = t - t0 - 1; r >= 0; --r) {
        const float g = __fadd_rn(tg[r * G + c], carry);
        carry = __fmul_rn(ta[r * G + c], g);
        if (live && r % Q == k) {
          dxp[(r - k) * d] = g;
          dap[(r - k) * d] = __fmul_rn(g, thp[(r - k) * G]);
        }
      }
    }
    __syncwarp();
  }
  if (live && k == 0) dh0[hrow] = carry;
}

// n steps of the backward's dependent pair (an add, then a multiply by the
// next a, each rounded) on one thread: the measured floor of one channel's
// chain, read by chip_smoke.py
__global__ void bwd_chain_probe_kernel(int n, float a, float dy, float* out) {
  float carry = 0.f;
#pragma unroll 8
  for (int i = 0; i < n; ++i) carry = __fmul_rn(a, __fadd_rn(dy, carry));
  out[0] = carry;
}

template <int G>
int launch_bwd(const float* a, const float* y, const float* h0, const float* dy,
               const float* dh_last, float* dx, float* da, float* dh0, int b, int t, int d,
               cudaStream_t s) {
  dim3 grid((d + G - 1) / G, b);
  const bool vec = d % 4 == 0 && ((reinterpret_cast<uintptr_t>(a) |
                                   reinterpret_cast<uintptr_t>(dy) |
                                   reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  if (vec)
    rglru_scan_bwd_kernel<G, true><<<grid, LANES, 0, s>>>(a, y, h0, dy, dh_last, dx, da, dh0,
                                                          t, d);
  else
    rglru_scan_bwd_kernel<G, false><<<grid, LANES, 0, s>>>(a, y, h0, dy, dh_last, dx, da, dh0,
                                                           t, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int rglru_scan_f32(const float* a, const float* x, const float* h0, float* y,
                   int b, int t, int d, void* stream) {
  if (b <= 0 || t <= 0 || d <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t == 1) {
    dim3 grid((d + STEP_THREADS - 1) / STEP_THREADS, b);
    rglru_scan_step_kernel<<<grid, STEP_THREADS, 0, s>>>(a, x, h0, y, d);
    return (int)cudaGetLastError();
  }
  dim3 grid((d + LANES - 1) / LANES, b);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (vec)
    rglru_scan_kernel<true><<<grid, LANES, 0, s>>>(a, x, h0, y, t, d);
  else
    rglru_scan_kernel<false><<<grid, LANES, 0, s>>>(a, x, h0, y, t, d);
  return (int)cudaGetLastError();
}

// dy (B, T, D) and the optional dh_last (B, D) -> dx, da (B, T, D) and dh0 (B, D);
// `group`: the channels a warp takes (8 or 32)
int rglru_scan_bwd_f32(const float* a, const float* y, const float* h0, const float* dy,
                       const float* dh_last, float* dx, float* da, float* dh0, int b, int t,
                       int d, int group, void* stream) {
  if (b <= 0 || t <= 0 || d <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (group) {
    case 8: return launch_bwd<8>(a, y, h0, dy, dh_last, dx, da, dh0, b, t, d, s);
    case 32: return launch_bwd<32>(a, y, h0, dy, dh_last, dx, da, dh0, b, t, d, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int rglru_bwd_chain_probe(int n, float a, float dy, float* out, void* stream) {
  bwd_chain_probe_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(n, a, dy, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
