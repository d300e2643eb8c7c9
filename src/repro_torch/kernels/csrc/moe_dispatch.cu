// The MoE's sparse dispatch on the card: the grouped expert products (rows
// and weight gradients) on wgmma, and the pair order and row gather beside
// them.  Bound to PyTorch by ctypes (kernels/moe_dispatch.py); bf16 operands,
// fp32 accumulation, bf16 out.  Every kernel launches on the given stream,
// allocates nothing and returns cudaGetLastError().
//
// The rows of expert e are off[e] .. off[e + 1] - 1 of the permuted tensors
// (off: E + 1 int32 on the device, read by the kernels: the host never sees
// them).  No kernel uses atomics and every sum runs in a fixed order, so two
// runs give the same bits.
//
// * `grouped_gemm_kernel`: C[rows of e] = A[rows of e] B[e], B (E, K, N)
//   read through its strides, N-contiguous (a weight: "MN-major" to wgmma)
//   or K-contiguous (a weight's transpose, the backward's dA = dC B[e]^T:
//   "K-major").  B may be two tensors of one shape joined along N or K
//   (split: the gate and up weights as one product, without a copy of them).
//   A block takes BM = 128 rows of one expert by BN columns: two warpgroups
//   of m64nBNk16 wgmma over a ring of STAGES 64-deep tiles that every thread
//   fills by cp.async, 128-byte swizzled as wgmma reads them; the output
//   tile goes out through shared memory, 16 bytes a thread.
//   The host sizes the grid's row axis from shapes alone (sum_e ceil(n_e /
//   BM) <= ceil(R / BM) + E); each block finds its expert by a walk over the
//   E + 1 offsets and a block past the last tile returns.  Bound:
//   operations, 2 R K N (at granite-moe-1b-a400m's training step, R = 65,536
//   rows, K and N 512-1024: 69-137 GFLOP a launch against 134-268 MB).
// * `grouped_gemm_wgrad_kernel`: W[e] = A[rows of e]^T G[rows of e]; a block
//   per (BM x BN tile of W[e], expert) walks the expert's rows in order, 64
//   at a time (no split over the rows, so no atomics); an expert with no
//   rows stores zeros.  Both operands are read row by row, so both are MN-major
//   to wgmma.  W may be two tensors joined along N.  Bound: operations, as
//   above.
// * `order_kernel`: after a stable sort of the ids, each row's token
//   (perm / k), each pair's row (the inverse permutation) and each expert's
//   first row (written by the row where the sorted ids cross into it, so
//   once each).  Bound: bytes (a few int32 a pair).
// * `permute_kernel`: Y[r] = X[tok[r]], 16 bytes a thread.  Bound: bytes.
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;       // rows of a block: two warpgroups of 64
constexpr int BK = 64;        // depth of a tile: one 128-byte row of bf16
constexpr int THREADS = 256;
constexpr int PANEL = 64 * 128;  // bytes of a 64-row, 128-byte-wide panel

// 128-byte swizzle: 16-byte chunk c of row r of a panel (rows of 128 bytes,
// the panel 1024-byte aligned) lands at chunk c ^ (r % 8)
__device__ __forceinline__ uint32_t swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// the wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cp.async writes through the generic proxy, wgmma reads through the async one
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator registers across an async wgmma
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the accumulators of a block's two warpgroups, rounded to bf16, into a BM x
// (BN + 8) tile in shared memory (the pad keeps a warp's stores on distinct
// banks), for stores of 16 bytes a thread.  Accumulator j of a thread: row
// (lane / 4) + 8 (j / 2 % 2) of its warp's 16, column 8 (j / 4) + 2 (lane %
// 4) + j % 2
template <int BN>
__device__ __forceinline__ void stage_acc(const float (&acc)[BN / 2], bf16* tile, int tid) {
  const int lane = tid & 31, c2 = (lane & 3) * 2;
  const int r = (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    *reinterpret_cast<uint32_t*>(tile + r * (BN + 8) + 8 * j + c2) =
        sm90::pack_bf16(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(tile + (r + 8) * (BN + 8) + 8 * j + c2) =
        sm90::pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// wgmma.mma_async m64nNk16, D += A B, fp32 accumulators; TA / TB: 1 for an
// MN-major operand, 0 for a K-major one
template <int TA, int TB>
__device__ __forceinline__ void wgmma_k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_k16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}


// -- the grouped row product ---------------------------------------------------

struct GemmParams {
  const bf16* a;
  const bf16* b0;
  const bf16* b1;  // B's second half (b0 where there is none)
  bf16* c;
  const int* off;
  long long s_am, s_be, s_bk, s_bn, s_cm;
  int n_experts, n, k;
  int split;    // B[., k, n] is b1's at k - split (split_k) or n - split past it
  int split_k;
};

__device__ __forceinline__ const bf16* b_at(const GemmParams& p, int e, int k, int n) {
  const bf16* b = p.b0;
  if (p.split_k ? k >= p.split : n >= p.split) {
    b = p.b1;
    if (p.split_k) k -= p.split; else n -= p.split;
  }
  return b + e * p.s_be + k * p.s_bk + n * p.s_bn;
}

// shared memory of a stage: the A tile (BM rows of 128 bytes, one panel)
// then the B tile: K-major, BN rows (n) of 128 bytes (k); MN-major, BN / 64
// panels of 64 rows (k) of 128 bytes (n)
template <int BN, bool B_KMAJOR, int STAGES>
__global__ void __launch_bounds__(THREADS, 1) grouped_gemm_kernel(const GemmParams p) {
  extern __shared__ uint8_t smem_raw[];
  constexpr int A_BYTES = BM * 128, STAGE = A_BYTES + BN * 128;
  constexpr int A_PER = BM * 8 / THREADS, B_PER = BN * 8 / THREADS;  // 16-byte chunks a thread
  const uint32_t base = (sm90::smem_addr(smem_raw) + 1023) & ~1023u;
  int e = -1, row0 = 0, row_end = 0;
  for (int x = 0, t0 = 0; x < p.n_experts; ++x) {
    const int lo = p.off[x], hi = p.off[x + 1], nt = (hi - lo + BM - 1) / BM;
    if ((int)blockIdx.y < t0 + nt) {
      e = x;
      row0 = lo + ((int)blockIdx.y - t0) * BM;
      row_end = hi;
      break;
    }
    t0 += nt;
  }
  if (e < 0) return;
  const int n0 = blockIdx.x * BN, tid = threadIdx.x, wg = tid >> 7;
  const bf16* a_src[A_PER];
  bool a_ok[A_PER];
  int a_k[A_PER];
  uint32_t a_dst[A_PER];
#pragma unroll
  for (int i = 0; i < A_PER; ++i) {
    const int idx = tid + i * THREADS, r = idx >> 3, c = idx & 7, row = row0 + r;
    a_ok[i] = row < row_end;
    a_k[i] = 8 * c;
    a_src[i] = p.a + (long long)(a_ok[i] ? row : row0) * p.s_am + 8 * c;
    a_dst[i] = swz(r, c);
  }
  // a B chunk's depth at the first tile, its address there (below the
  // split, or past it: b1's), and its place in the stage
  const bf16* b_src[B_PER][2];
  int b_k[B_PER];
  uint32_t b_dst[B_PER];
#pragma unroll
  for (int i = 0; i < B_PER; ++i) {
    const int idx = tid + i * THREADS;
    int n;
    if (B_KMAJOR) {
      const int nn = idx >> 3, c = idx & 7;
      b_k[i] = 8 * c;
      n = n0 + nn;
      b_dst[i] = swz(nn, c);
    } else {
      const int r = idx / (BN / 8), cn = idx % (BN / 8);
      b_k[i] = r;
      n = n0 + 8 * cn;
      b_dst[i] = (cn >> 3) * PANEL + swz(r, cn & 7);
    }
    if (n >= p.n) b_k[i] = p.k;  // never loaded
    const int nc = n < p.n ? n : 0;
    b_src[i][0] = b_at(p, e, b_k[i] < p.split || !p.split_k ? b_k[i] : 0, nc);
    b_src[i][1] = p.split_k ? b_at(p, e, b_k[i] + p.split, nc) - (long long)p.split * p.s_bk
                            : b_src[i][0];
  }
  auto load = [&](int stage, int kt) {
    const int k0 = kt * BK;
    const uint32_t sa = base + stage * STAGE, sb = sa + A_BYTES;
#pragma unroll
    for (int i = 0; i < A_PER; ++i)
      sm90::cp_async16(sa + a_dst[i], a_src[i] + k0, a_ok[i] && k0 + a_k[i] < p.k);
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int kk = k0 + b_k[i];
      const bool ok = kk < p.k;
      const bf16* src = p.split_k && kk >= p.split ? b_src[i][1] : b_src[i][0];
      sm90::cp_async16(sb + b_dst[i], ok ? src + (long long)k0 * p.s_bk : p.b0, ok);
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const int kt_n = (p.k + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < kt_n) load(s, s);
    sm90::cp_async_commit();
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    // tile kt has landed, and every warpgroup's products of tile kt - 2
    // are done, so its stage takes tile kt + STAGES - 2
    cp_async_wait<STAGES - 3>();
    fence_proxy_async();
    __syncthreads();
    if (kt + STAGES - 2 < kt_n) load((kt + STAGES - 2) % STAGES, kt + STAGES - 2);
    sm90::cp_async_commit();
    const uint32_t sa = base + (kt % STAGES) * STAGE, sb = sa + A_BYTES;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const uint64_t da = desc(sa + wg * PANEL + ks * 32, 16, 1024);
      const uint64_t db = B_KMAJOR ? desc(sb + ks * 32, 16, 1024)
                                   : desc(sb + ks * 16 * 128, PANEL, 1024);
      wgmma_k16<0, B_KMAJOR ? 0 : 1>(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(acc);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  cp_async_wait<0>();
  __syncthreads();  // every stage read: the ring becomes the output tile
  bf16* tile = reinterpret_cast<bf16*>(smem_raw + (base - sm90::smem_addr(smem_raw)));
  stage_acc<BN>(acc, tile, tid);
  __syncthreads();
  for (int i = tid; i < BM * (BN / 8); i += THREADS) {
    const int r = i / (BN / 8), c = i % (BN / 8), row = row0 + r, col = n0 + 8 * c;
    if (row < row_end && col < p.n)
      *reinterpret_cast<uint4*>(p.c + (long long)row * p.s_cm + col) =
          *reinterpret_cast<const uint4*>(tile + r * (BN + 8) + 8 * c);
  }
}

// -- the grouped weight gradient -----------------------------------------------

struct WgradParams {
  const bf16* a;
  const bf16* g;
  bf16* w0;
  bf16* w1;  // W's columns from split on (w0 where there is no split)
  const int* off;
  long long s_am, s_gm, s_we, ldw;
  int m, n, split;
};

// shared memory of a stage: 64 rows (the expert's) of A, BM / 64 panels of
// 128 bytes (m), then of G, BN / 64 panels (n)
template <int BN, int STAGES>
__global__ void __launch_bounds__(THREADS, 1) grouped_gemm_wgrad_kernel(const WgradParams p) {
  extern __shared__ uint8_t smem_raw[];
  constexpr int A_BYTES = BM * 128, STAGE = A_BYTES + BN * 128;
  constexpr int A_PER = BM * 8 / THREADS, B_PER = BN * 8 / THREADS;
  const uint32_t base = (sm90::smem_addr(smem_raw) + 1023) & ~1023u;
  const int e = blockIdx.y, tiles_n = (p.n + BN - 1) / BN;
  const int m0 = (blockIdx.x / tiles_n) * BM, n0 = (blockIdx.x % tiles_n) * BN;
  const int lo = p.off[e], hi = p.off[e + 1];
  const int tid = threadIdx.x, wg = tid >> 7;
  auto load = [&](int stage, int kt) {
    const int r0 = lo + kt * BK;
    const uint32_t sa = base + stage * STAGE, sb = sa + A_BYTES;
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int idx = tid + i * THREADS, r = idx / (BM / 8), cm = idx % (BM / 8);
      const int row = r0 + r, m = m0 + 8 * cm;
      const bool ok = row < hi && m < p.m;
      sm90::cp_async16(sa + (cm >> 3) * PANEL + swz(r, cm & 7),
                       ok ? p.a + (long long)row * p.s_am + m : p.a, ok);
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int idx = tid + i * THREADS, r = idx / (BN / 8), cn = idx % (BN / 8);
      const int row = r0 + r, n = n0 + 8 * cn;
      const bool ok = row < hi && n < p.n;
      sm90::cp_async16(sb + (cn >> 3) * PANEL + swz(r, cn & 7),
                       ok ? p.g + (long long)row * p.s_gm + n : p.g, ok);
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const int kt_n = (hi - lo + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < kt_n) load(s, s);
    sm90::cp_async_commit();
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<STAGES - 3>();
    fence_proxy_async();
    __syncthreads();
    if (kt + STAGES - 2 < kt_n) load((kt + STAGES - 2) % STAGES, kt + STAGES - 2);
    sm90::cp_async_commit();
    const uint32_t sa = base + (kt % STAGES) * STAGE, sb = sa + A_BYTES;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
      wgmma_k16<1, 1>(acc, desc(sa + wg * PANEL + ks * 16 * 128, PANEL, 1024),
                      desc(sb + ks * 16 * 128, PANEL, 1024));
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(acc);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  cp_async_wait<0>();
  __syncthreads();
  bf16* tile = reinterpret_cast<bf16*>(smem_raw + (base - sm90::smem_addr(smem_raw)));
  stage_acc<BN>(acc, tile, tid);
  __syncthreads();
  for (int i = tid; i < BM * (BN / 8); i += THREADS) {
    const int r = i / (BN / 8), c = i % (BN / 8), m = m0 + r, col = n0 + 8 * c;
    if (m >= p.m || col >= p.n) continue;
    bf16* w = (col < p.split ? p.w0 + col : p.w1 + (col - p.split)) + e * p.s_we + m * p.ldw;
    *reinterpret_cast<uint4*>(w) = *reinterpret_cast<const uint4*>(tile + r * (BN + 8) + 8 * c);
  }
}

// -- the order and the gather --------------------------------------------------

__global__ void order_kernel(const int16_t* ids, const long long* perm, int* tok, int* rop,
                             int* off, int r_n, int n_experts, int k) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= r_n) return;
  const long long q = perm[r];
  tok[r] = (int)(q / k);
  rop[q] = r;
  // expert e's rows start at the first row whose id is e or more; experts
  // past the last row's id, and E itself, start at R
  const int cur = ids[r], prev = r > 0 ? ids[r - 1] : -1;
  for (int e = prev + 1; e <= cur; ++e) off[e] = r;
  if (r == r_n - 1)
    for (int e = cur + 1; e <= n_experts; ++e) off[e] = r_n;
}

__global__ void permute_kernel(const uint4* x, const int* tok, uint4* y, long long total,
                               int chunks) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long r = i / chunks;
  y[i] = x[(long long)tok[r] * chunks + (i - r * chunks)];
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

template <typename Kern>
int smem_attr(Kern kern, int smem) {
  return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int BN, bool B_KMAJOR, int STAGES>
int launch_gemm(const GemmParams& p, int rows, cudaStream_t stream) {
  const int smem = STAGES * (BM + BN) * 128 + 1024;
  if (int err = smem_attr(grouped_gemm_kernel<BN, B_KMAJOR, STAGES>, smem)) return err;
  const dim3 grid((p.n + BN - 1) / BN, (rows + BM - 1) / BM + p.n_experts);
  grouped_gemm_kernel<BN, B_KMAJOR, STAGES><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int BN, int STAGES>
int launch_wgrad(const WgradParams& p, int n_experts, cudaStream_t stream) {
  const int smem = STAGES * (BM + BN) * 128 + 1024;
  if (int err = smem_attr(grouped_gemm_wgrad_kernel<BN, STAGES>, smem)) return err;
  const dim3 grid(((p.m + BM - 1) / BM) * ((p.n + BN - 1) / BN), n_experts);
  grouped_gemm_wgrad_kernel<BN, STAGES><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// C (rows, n) = A (rows, k) B[e] per expert, B = b0 (and b1 past split along
// n, or along k with split_k) of strides (s_be, s_bk, s_bn), one of s_bk and
// s_bn 1; tile: 0 (BN 128), 1 (BN 256), each with 4 stages
int moe_grouped_gemm_bf16(const void* a, long long s_am, const void* b0, const void* b1,
                          long long s_be, long long s_bk, long long s_bn, int split, int split_k,
                          void* c, long long s_cm, const int* off, int rows, int n_experts,
                          int n, int k, int tile, void* stream) {
  if (rows <= 0 || n <= 0) return (int)cudaSuccess;
  const bool kmajor = s_bk == 1;
  if (k <= 0 || n % 8 || k % 8 || split % 8 || n_experts <= 0 || (s_bk != 1 && s_bn != 1) ||
      s_am % 8 || s_be % 8 || (kmajor ? s_bn : s_bk) % 8 || s_cm % 8 || !aligned16(a) ||
      !aligned16(b0) || !aligned16(b1) || !aligned16(c) ||
      (rows + BM - 1) / BM + n_experts > 65535)
    return (int)cudaErrorInvalidValue;
  const GemmParams p{static_cast<const bf16*>(a), static_cast<const bf16*>(b0),
                     static_cast<const bf16*>(b1), static_cast<bf16*>(c), off,
                     s_am, s_be, s_bk, s_bn, s_cm, n_experts, n, k, split, split_k};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 0:
      return kmajor ? launch_gemm<128, true, 4>(p, rows, s)
                    : launch_gemm<128, false, 4>(p, rows, s);
    case 1:
      return kmajor ? launch_gemm<256, true, 4>(p, rows, s)
                    : launch_gemm<256, false, 4>(p, rows, s);
  }
  return (int)cudaErrorInvalidValue;
}

// W[e] (m, n) = A[rows of e]^T G[rows of e]: w0 holds the columns below
// split, w1 the rest (rows of ldw elements, experts s_we apart)
int moe_grouped_wgrad_bf16(const void* a, long long s_am, const void* g, long long s_gm,
                           void* w0, void* w1, long long s_we, long long ldw, int split,
                           const int* off, int n_experts, int m, int n, int tile, void* stream) {
  if (n_experts <= 0 || m <= 0 || n <= 0) return (int)cudaSuccess;
  if (m % 8 || n % 8 || s_am % 8 || s_gm % 8 || s_we % 8 || ldw % 8 || !aligned16(a) ||
      !aligned16(g) || !aligned16(w0) || !aligned16(w1))
    return (int)cudaErrorInvalidValue;
  const WgradParams p{static_cast<const bf16*>(a), static_cast<const bf16*>(g),
                      static_cast<bf16*>(w0), static_cast<bf16*>(w1), off, s_am, s_gm, s_we,
                      ldw, m, n, split};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 0: return launch_wgrad<128, 4>(p, n_experts, s);
    case 1: return launch_wgrad<256, 4>(p, n_experts, s);
  }
  return (int)cudaErrorInvalidValue;
}

// tok (r), rop (r) and off (n_experts + 1) of the stably sorted ids and
// their permutation (r = pairs, k a token)
int moe_order(const int16_t* ids, const long long* perm, int* tok, int* rop, int* off, int r,
              int n_experts, int k, void* stream) {
  if (r <= 0) return (int)cudaSuccess;
  order_kernel<<<(r + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      ids, perm, tok, rop, off, r, n_experts, k);
  return (int)cudaGetLastError();
}

// y[r] = x[tok[r]], rows of d bf16 (d % 8 == 0, both 16-byte aligned)
int moe_permute_bf16(const void* x, const int* tok, void* y, int r, int d, void* stream) {
  if (r <= 0 || d <= 0) return (int)cudaSuccess;
  if (d % 8 || !aligned16(x) || !aligned16(y)) return (int)cudaErrorInvalidValue;
  const long long total = (long long)r * (d / 8);
  permute_kernel<<<(unsigned)((total + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), tok, static_cast<uint4*>(y), total, d / 8);
  return (int)cudaGetLastError();
}

}  // extern "C"
