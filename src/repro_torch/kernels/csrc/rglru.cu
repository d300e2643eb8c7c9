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
// The backward (`rglru_scan_bwd_kernel`) is the reverse scan of the adjoint,
// the math of the reference's `_scan_bwd` (src/repro/kernels/rglru_xla.py:56):
//
//   g_t = dy_t + a_{t+1} g_{t+1}  (g_{T-1} = dy_{T-1} + dh_last),
//   dx_t = g_t,  da_t = g_t h_{t-1},  dh0 = a_0 g_0,
//
// with h_{t-1} read from the saved states y (h0, or 0, before the first
// step): nothing is recomputed.  It is laid out as the forward: a warp per 32
// channels of a batch row, g in a register, t walked backwards, the a, dy and
// shifted-y tiles streamed backwards through a ring of cp.async stages.  It
// reads a, y and dy and writes dx and da, 20 bytes per element: ~0.063 ms at
// the training shape (1 x 4096 x 2560) at 3.35 TB/s.  Every add and multiply
// is rounded on its own (__fadd_rn, __fmul_rn), as in the plain version, so
// it is bit-equal to it.

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

// Copy steps [s0, s0 + TILE_T) of channels [c0, c0 + 32) of one array into a
// (TILE_T x 32) tile, only the steps in [s_lo, s_hi) (the backward's shifted y
// tile starts one step before its a and dy tiles).
template <bool VEC>
__device__ __forceinline__ void load_tile_from(float* tile, const float* __restrict__ src,
                                               long long row0, int s0, int s_lo, int s_hi,
                                               int c0, int d, int lane) {
  if (VEC) {
    const int col = 4 * (lane & 7);
#pragma unroll
    for (int k = 0; k < TILE_T / 4; ++k) {
      const int r = 4 * k + (lane >> 3), s = s0 + r;
      if (s >= s_lo && s < s_hi && c0 + col < d)
        sm90::cp_async16(sm90::smem_addr(tile + r * LANES + col),
                         src + (row0 + s) * d + c0 + col, true);
    }
  } else {
#pragma unroll 8
    for (int r = 0; r < TILE_T; ++r) {
      const int s = s0 + r;
      if (s >= s_lo && s < s_hi && c0 + lane < d)
        sm90::cp_async4(sm90::smem_addr(tile + r * LANES + lane),
                        src + (row0 + s) * d + c0 + lane, true);
    }
  }
}

constexpr int BWD_STAGES = 3;  // 3 stages x (a, dy, y_prev) x 4 KB = 36 KB

// tile q (steps [q TILE_T, q TILE_T + TILE_T)) of a, dy and the states one
// step earlier into ring slot `slot`
template <bool VEC>
__device__ __forceinline__ void load_bwd_tile(float (*slot)[TILE], const float* a,
                                              const float* dy, const float* y, long long row0,
                                              int q, int t, int c0, int d, int lane) {
  const int t0 = q * TILE_T;
  load_tile_from<VEC>(slot[0], a, row0, t0, 0, t, c0, d, lane);
  load_tile_from<VEC>(slot[1], dy, row0, t0, 0, t, c0, d, lane);
  load_tile_from<VEC>(slot[2], y, row0, t0 - 1, 0, t, c0, d, lane);
}

template <bool VEC>
__global__ void __launch_bounds__(LANES)
    rglru_scan_bwd_kernel(const float* __restrict__ a, const float* __restrict__ y,
                          const float* __restrict__ h0, const float* __restrict__ dy,
                          const float* __restrict__ dh_last, float* __restrict__ dx,
                          float* __restrict__ da, float* __restrict__ dh0, int t, int d) {
  __shared__ __align__(16) float ring[BWD_STAGES][3][TILE];
  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * LANES;
  const int c = c0 + lane;
  const bool live = c < d;
  const long long row0 = (long long)blockIdx.y * t;
  const long long hrow = (long long)blockIdx.y * d + c;
  const int n_tiles = (t + TILE_T - 1) / TILE_T;

  float carry = (dh_last != nullptr && live) ? dh_last[hrow] : 0.f;  // a_{t+1} g_{t+1}
  const float h_init = (h0 != nullptr && live) ? h0[hrow] : 0.f;
  float* dxp = dx + row0 * d + c;
  float* dap = da + row0 * d + c;

  // tiles are taken last first: ring position j holds tile n_tiles - 1 - j
#pragma unroll
  for (int s = 0; s < BWD_STAGES - 1; ++s) {
    if (s < n_tiles)
      load_bwd_tile<VEC>(ring[s], a, dy, y, row0, n_tiles - 1 - s, t, c0, d, lane);
    sm90::cp_async_commit();
  }
  for (int j = 0; j < n_tiles; ++j) {
    const int nj = j + BWD_STAGES - 1;
    if (nj < n_tiles)
      load_bwd_tile<VEC>(ring[nj % BWD_STAGES], a, dy, y, row0, n_tiles - 1 - nj, t, c0, d,
                         lane);
    sm90::cp_async_commit();
    cp_async_wait<BWD_STAGES - 1>();
    __syncwarp();
    const float* ta = ring[j % BWD_STAGES][0];
    const float* tg = ring[j % BWD_STAGES][1];
    const float* th = ring[j % BWD_STAGES][2];
    const int t0 = (n_tiles - 1 - j) * TILE_T;
    const int rows = t - t0 < TILE_T ? t - t0 : TILE_T;
    for (int r = rows - 1; r >= 0; --r) {
      const float hp = t0 + r == 0 ? h_init : th[r * LANES + lane];
      const float g = __fadd_rn(tg[r * LANES + lane], carry);
      if (live) {
        dxp[(long long)(t0 + r) * d] = g;
        dap[(long long)(t0 + r) * d] = __fmul_rn(g, hp);
      }
      carry = __fmul_rn(ta[r * LANES + lane], g);
    }
    __syncwarp();
  }
  if (live) dh0[hrow] = carry;
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

// dy (B, T, D) and the optional dh_last (B, D) -> dx, da (B, T, D) and dh0 (B, D)
int rglru_scan_bwd_f32(const float* a, const float* y, const float* h0, const float* dy,
                       const float* dh_last, float* dx, float* da, float* dh0, int b, int t,
                       int d, void* stream) {
  if (b <= 0 || t <= 0 || d <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((d + LANES - 1) / LANES, b);
  const bool vec = d % 4 == 0 && ((reinterpret_cast<uintptr_t>(a) |
                                   reinterpret_cast<uintptr_t>(dy) |
                                   reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  if (vec)
    rglru_scan_bwd_kernel<true><<<grid, LANES, 0, s>>>(a, y, h0, dy, dh_last, dx, da, dh0, t, d);
  else
    rglru_scan_bwd_kernel<false><<<grid, LANES, 0, s>>>(a, y, h0, dy, dh_last, dx, da, dh0, t,
                                                        d);
  return (int)cudaGetLastError();
}

}  // extern "C"
