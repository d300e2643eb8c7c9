// RG-LRU scan for Hopper (sm_90a): h_t = a_t * h_{t-1} + x_t over (B, T, D)
// with an fp32 carry, writing every h_t.
//
// Replaces the TPU kernel `rglru_pallas` (src/repro/kernels/rglru.py:41, kernel
// body `_kernel`).  There the time axis is the sequential grid axis and the
// carry sits in VMEM scratch between time blocks.  Here each (batch, channel)
// pair is one thread that keeps h in a register and loops over t; the gate
// math (a = exp(-c softplus(a_param) a_gate), x = sqrt(1 - a^2) i x) stays
// outside, in PyTorch, as it stays outside the TPU kernel.
//
// What bounds it on this card: bytes.  It reads a and x and writes y once,
// 12 bytes per element for 2 operations, so at the prefill shape
// (4 x 4096 x 2560 fp32, 503 MB) the least time is ~0.15 ms at 3.35 TB/s.
// Loads and stores of neighbouring threads are neighbouring channels, so every
// access is coalesced, and the loads of later steps do not depend on h, so
// the unrolled loop keeps several in flight.  What holds it back today: only
// B * D threads (10,240 at the prefill shape, 80 blocks of 128 on 132 SMs)
// and a dependent chain of T steps each; a chunked parallel scan over t is a
// later step.
//
// The update is written as two separately rounded operations
// (__fmul_rn, __fadd_rn): nvcc would otherwise contract a * h + x into one
// FMA, and the plain PyTorch version rounds twice.  With that the kernel is
// bit-equal to it.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
    rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ x,
                      const float* __restrict__ h0, float* __restrict__ y, int t,
                      int d) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  const int bb = blockIdx.y;
  if (c >= d) return;
  float h = h0 != nullptr ? h0[(long long)bb * d + c] : 0.f;
  const long long base = (long long)bb * t * d + c;
#pragma unroll 8
  for (int s = 0; s < t; ++s) {
    const long long i = base + (long long)s * d;
    h = __fadd_rn(__fmul_rn(a[i], h), x[i]);
    y[i] = h;
  }
}

}  // namespace

extern "C" {

int rglru_scan_f32(const float* a, const float* x, const float* h0, float* y,
                   int b, int t, int d, void* stream) {
  if (b <= 0 || t <= 0 || d <= 0) return (int)cudaSuccess;
  dim3 grid((d + THREADS - 1) / THREADS, b);
  rglru_scan_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, x, h0, y, t, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
