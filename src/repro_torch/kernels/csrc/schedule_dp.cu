// Schedule-DP sweep for Hopper (sm_90a): the level-synchronous longest-path
// recursion over the conjunctive DAG plus the machine-order links, one
// candidate schedule per row.
//
// Replaces the TPU kernel `sweep_pallas` (src/repro/kernels/schedule_dp.py,
// kernel body `kernel`, level loop `run`).  That kernel reduces over a dense
// (rows, n_b, n_b) predecessor mask because the TPU's vector unit has no cheap
// gather.  A GPU gathers freely, so this kernel uses the gather-side form of
// the same recursion (`level_loop_xla` in that file): a task's value is
// `node_add + max(0, values of its links)`, the links being the task's list
// in a compact CSR form of the graph shared by all rows (the real slots of
// the -1 padded index matrix, in slot order) plus one per-row machine link,
// and a task fires at the first level at which all its links have fired.
//
// What bounds it on this card: not bytes and not arithmetic.  A row moves
// about 32 bytes per task and does a handful of max/add per link, both far
// below a microsecond for the batches the search sends.  The time is the
// dependency chain: the levels of one row run one after another, and each
// level costs a few shared-memory round trips and two block barriers.  So
// every row has its own thread block (rows are independent; nothing crosses
// blocks) and the design keeps a level's work close to that floor:
//
//   * the row's state (values, node weights, machine links, cursors) and the
//     graph's link lists, as CSR, sit in shared memory, loaded once per block
//     (where the CSR does not fit beside the state, the same code reads it
//     from device memory);
//   * every task has a cursor into its link list: the first link not yet
//     seen done.  Done flags only go from 0 to 1, so a level moves the cursor
//     past links that are done (four at a time) and stops at the first that
//     is not: each link is checked about once in the task's lifetime, and a
//     waiting task costs three shared-memory round trips per level;
//   * a link's value is read once, when the cursor passes it (a done task's
//     value is final), and folded into the task's running max, which it
//     keeps in its own value slot until it fires; the machine link likewise,
//     when it is first seen done.  Firing is then one max with 0 and one
//     add: finish = max(0, links) + node weight, and start is that same max
//     (not finish - dur: that differs in the last bit and breaks on inf
//     durations).  Finishes and tails are never -0.0, so max over the same
//     operands in another order is the same number, NaN propagating;
//   * nothing is written to device memory inside the loop: a task's level
//     lives in its cursor slot once it is done, its start in its weight
//     slot, and the outputs are written once, coalesced, at the end.
//
// A level is two phases separated by barriers.  Phase 1: every unfinished
// task reads the PREVIOUS level's done flags of its links, decides whether it
// is ready and, if so, computes and stores its value (no task reads a value
// before the task is done).  Phase 2: the ready tasks mark themselves done.
// So `level` is exactly the Kahn pop level, rows with a cycle stall with
// n_done < n_valid, and padding tasks (index >= n_valid) never fire.
//
// Arithmetic is max and add only, with a NaN-propagating max and IEEE
// infinities (no fast-math), so in float64 the outputs are bit-identical to
// the plain PyTorch version and to the NumPy engine.
//
// One entry point per float type serves three call shapes (`mode`):
//   0  forward only: start, finish, level, n_done; q is not a result of this
//      shape and is never touched (it may be null)
//   1  forward, then on rows with n_done == n_valid the backward loop over
//      the successor links with node weight finish - start, giving q
//   2  backward only: `dur` is the node weight, `active` masks rows, only q
//      is written
// A block has up to 1,024 threads and a thread owns up to 8 tasks, so a row
// holds at most 8,192 tasks.  The real task count is an argument, or, where
// `n_valid_dev` is not null, read from device memory at the start of the
// kernel: a launch recorded in a CUDA graph then serves every instance of a
// shape bucket, whatever its task count.
//
// The same library holds `seq_cumsum_kernel`, a helper of the device-resident
// search (no TPU kernel corresponds to it): row prefix sums in float64 taken
// strictly left to right, as NumPy's `np.cumsum` takes them, so that the task
// durations the search derives from them are bit-identical to the NumPy
// engine's.  A parallel scan would add in another order.  The chain of adds
// bounds it (one dependent add per element of a row); one warp per row loads
// tiles coalesced into shared memory, one lane adds along the tile while the
// warp fetches the next, and the warp stores the tile's prefixes coalesced.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

enum { MODE_FORWARD = 0, MODE_FORWARD_TAILS = 1, MODE_BACKWARD = 2 };

constexpr int MAX_THREADS = 1024;
constexpr int MAX_TASKS = 8 * MAX_THREADS;
// shared memory one block may use; the kernel declares none statically, so
// this is all dynamic: the row's done counter, state and (where it fits) CSR
constexpr size_t MAX_SMEM = 232448;
constexpr size_t COUNTER_BYTES = 16;  // keeps the state after it 16-byte aligned

// A task's cursor slot: >= 0 while it waits (the position of its first link
// not seen done), FIRING from the level it fires (or for good: padding), and
// DONE_AT - level once it is done.
constexpr int FIRING = -1;
constexpr int DONE_AT = -2;

__device__ __forceinline__ bool is_done(int cursor) { return cursor <= DONE_AT; }

template <typename T> __device__ __forceinline__ T neg_inf();
template <> __device__ __forceinline__ float neg_inf<float>() {
  return __int_as_float(0xff800000);
}
template <> __device__ __forceinline__ double neg_inf<double>() {
  return __longlong_as_double(0xfff0000000000000LL);
}

// max that propagates NaN from either side, as torch.maximum and np.maximum do
template <typename T> __device__ __forceinline__ T pmax(T a, T b) {
  return (b != b) ? b : ((a < b) ? b : a);
}

// Row state in shared memory: val (value, or the running max of a waiting
// task), wt (node weight; a done task's start in the forward loop), lv (the
// machine link, -1 once seen done), cur (the cursor slot above).
template <typename T>
struct Row {
  T* val;
  T* wt;
  int* lv;
  int* cur;
};

// The masked level loop on one row.  On return, for a task i with
// is_done(cur[i]): val[i] is its value, DONE_AT - cur[i] its level and, in
// the forward loop, wt[i] its start (max(0, links)).  Other tasks' slots hold
// partial state and are not results.
template <typename T, bool FWD>
__device__ __forceinline__ void level_loop(const int* ip, const int* ix, int n_b,
                                           int n_valid, const Row<T>& r) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < n_b; i += nt) {
    r.val[i] = T(0);  // the running max starts at 0: max(0, links)
    r.cur[i] = i < n_valid ? ip[i] : FIRING;
  }
  __syncthreads();
  for (int lev = 0; lev <= n_valid; ++lev) {
    // phase 1: ready + value from the previous level's done flags
    unsigned fired = 0;  // bit k: task tid + k * nt fired in this level
    for (int i = tid, k = 0; i < n_b; i += nt, ++k) {
      int p = r.cur[i];
      if (p < 0) continue;
      const int m = r.lv[i];
      const int e = ip[i + 1];
      T acc = r.val[i];
      bool ready = true;
      if (m >= 0) {
        if (is_done(r.cur[m])) {
          acc = pmax(acc, r.val[m]);
          r.lv[i] = -1;
        } else {
          ready = false;
        }
      }
      // advance past done links, four at a time
      while (p < e) {
        int l[4];
        bool d[4];
        T v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) l[u] = p + u < e ? ix[p + u] : -1;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          d[u] = l[u] >= 0 && is_done(r.cur[l[u]]);
          v[u] = l[u] >= 0 ? r.val[l[u]] : T(0);
        }
        bool go = true;  // static indices only: l, d and v stay in registers
        int u = 0;
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          go = go && d[w];
          if (go) {
            acc = pmax(acc, v[w]);
            ++u;
          }
        }
        p += u;
        if (!go) break;
      }
      if (p < e) ready = false;
      if (ready) {
        const T f = acc + r.wt[i];
        r.val[i] = f;  // read by others only once the task is done (phase 2)
        if (FWD) r.wt[i] = acc;  // start
        r.cur[i] = FIRING;
        fired |= 1u << k;
      } else {
        r.val[i] = acc;
        r.cur[i] = p;
      }
    }
    // barrier: every read of the previous state is over before anyone publishes
    if (!__syncthreads_or(fired != 0)) break;
    // phase 2: publish
    for (int i = tid, k = 0; i < n_b; i += nt, ++k)
      if (fired >> k & 1u) r.cur[i] = DONE_AT - lev;
    __syncthreads();
  }
}

// the link lists a loop walks: copied into shared memory, or left in device memory
template <bool SMEM_CSR>
__device__ __forceinline__ void stage_csr(const int* __restrict__ g_ip,
                                          const int* __restrict__ g_ix, int nnz, int n_b,
                                          int* s_csr, const int*& ip, const int*& ix) {
  if (SMEM_CSR) {
    const int tid = threadIdx.x, nt = blockDim.x;
    int* s_ix = s_csr + n_b + 1;
    for (int j = tid; j <= n_b; j += nt) s_csr[j] = g_ip[j];
    for (int j = tid; j < nnz; j += nt) s_ix[j] = g_ix[j];
    ip = s_csr;
    ix = s_ix;
  } else {
    ip = g_ip;
    ix = g_ix;
  }
}

template <typename T, bool SMEM_CSR>
__global__ void __launch_bounds__(MAX_THREADS)
    sweep_kernel(const int* __restrict__ pred_ptr, const int* __restrict__ pred_idx,
                 int pred_nnz, const int* __restrict__ succ_ptr,
                 const int* __restrict__ succ_idx, int succ_nnz,
                 const T* __restrict__ dur, const int* __restrict__ mpred,
                 const int* __restrict__ msucc, const unsigned char* __restrict__ active,
                 int n_b, int n_valid_arg, const int* __restrict__ n_valid_dev, int mode,
                 T* start, T* finish, int* level, int* n_done, T* q) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_valid = n_valid_dev != nullptr ? *n_valid_dev : n_valid_arg;
  int& s_count = *reinterpret_cast<int*>(smem);
  Row<T> r;
  r.val = reinterpret_cast<T*>(smem + COUNTER_BYTES);
  r.wt = r.val + n_b;
  r.lv = reinterpret_cast<int*>(r.wt + n_b);
  r.cur = r.lv + n_b;
  int* s_csr = r.cur + n_b;  // (n_b + 1) + nnz ints when SMEM_CSR

  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t off = (size_t)blockIdx.x * n_b;
  const int* ip;
  const int* ix;

  if (mode != MODE_BACKWARD) {
    for (int i = tid; i < n_b; i += nt) {
      r.wt[i] = dur[off + i];
      r.lv[i] = mpred[off + i];
    }
    if (tid == 0) s_count = 0;
    stage_csr<SMEM_CSR>(pred_ptr, pred_idx, pred_nnz, n_b, s_csr, ip, ix);
    __syncthreads();
    level_loop<T, true>(ip, ix, n_b, n_valid, r);
    // outputs; tasks that never fired get zeros (and a zero backward weight)
    int cnt = 0;
    for (int i = tid; i < n_b; i += nt) {
      const int c = r.cur[i];
      const bool done = is_done(c);
      const T s = done ? r.wt[i] : T(0);
      const T f = done ? r.val[i] : T(0);
      start[off + i] = s;
      finish[off + i] = f;
      level[off + i] = done ? DONE_AT - c : 0;
      r.wt[i] = f - s;  // node weight of the backward loop
      cnt += (done && i < n_valid) ? 1 : 0;
    }
    if (cnt) atomicAdd(&s_count, cnt);
    __syncthreads();
    const int nd = s_count;
    if (tid == 0) n_done[blockIdx.x] = nd;
    if (mode == MODE_FORWARD) return;
    if (nd != n_valid) {  // cyclic row: its tails stay zero
      for (int i = tid; i < n_b; i += nt) q[off + i] = T(0);
      return;
    }
  } else {
    if (active != nullptr && active[blockIdx.x] == 0) {
      for (int i = tid; i < n_b; i += nt) q[off + i] = T(0);
      return;
    }
    for (int i = tid; i < n_b; i += nt) r.wt[i] = dur[off + i];
  }

  for (int i = tid; i < n_b; i += nt) r.lv[i] = msucc[off + i];
  stage_csr<SMEM_CSR>(succ_ptr, succ_idx, succ_nnz, n_b, s_csr, ip, ix);
  __syncthreads();
  level_loop<T, false>(ip, ix, n_b, n_valid, r);
  for (int i = tid; i < n_b; i += nt) q[off + i] = is_done(r.cur[i]) ? r.val[i] : T(0);
}

// shared memory of one row: the counter and the state, and the CSR of the
// larger list it walks
size_t state_bytes(int n_b, size_t elem) {
  return COUNTER_BYTES + (size_t)n_b * (2 * elem + 2 * sizeof(int));
}
size_t csr_bytes(int n_b, int nnz) { return ((size_t)n_b + 1 + nnz) * sizeof(int); }

constexpr int MAX_DEVICES = 64;

template <typename T, bool SMEM_CSR>
int launch_csr(const int* pred_ptr, const int* pred_idx, int pred_nnz,
               const int* succ_ptr, const int* succ_idx, int succ_nnz, const T* dur,
               const int* mpred, const int* msucc, const unsigned char* active, int b,
               int n_b, int n_valid, const int* n_valid_dev, int mode, T* start, T* finish,
               int* level, int* n_done, T* q, size_t smem, cudaStream_t stream) {
  int threads = ((n_b + 31) / 32) * 32;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  // the opt-in above 48 KB is set once per device and size, so a launch that
  // a CUDA graph records after a first, eager launch of its shape makes no
  // call but the launch itself
  static size_t allowed[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > allowed[dev]) {
    e = cudaFuncSetAttribute(sweep_kernel<T, SMEM_CSR>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed[dev] = smem;
  }
  sweep_kernel<T, SMEM_CSR><<<b, threads, smem, stream>>>(
      pred_ptr, pred_idx, pred_nnz, succ_ptr, succ_idx, succ_nnz, dur, mpred, msucc, active,
      n_b, n_valid, n_valid_dev, mode, start, finish, level, n_done, q);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_sweep(const int* pred_ptr, const int* pred_idx, int pred_nnz,
                 const int* succ_ptr, const int* succ_idx, int succ_nnz, const T* dur,
                 const int* mpred, const int* msucc, const unsigned char* active, int b,
                 int n_b, int n_valid, const int* n_valid_dev, int mode, T* start,
                 T* finish, int* level, int* n_done, T* q, cudaStream_t stream) {
  if (b <= 0) return (int)cudaSuccess;
  if (n_b <= 0 || n_b > MAX_TASKS) return (int)cudaErrorInvalidValue;
  // the loops' link lists: pred for the forward loop, succ for the backward
  if (mode == MODE_FORWARD) succ_nnz = 0;
  if (mode == MODE_BACKWARD) pred_nnz = 0;
  const int nnz = pred_nnz > succ_nnz ? pred_nnz : succ_nnz;
  const size_t state = state_bytes(n_b, sizeof(T));
  const size_t csr = csr_bytes(n_b, nnz);
  if (state + csr <= MAX_SMEM)
    return launch_csr<T, true>(pred_ptr, pred_idx, pred_nnz, succ_ptr, succ_idx, succ_nnz,
                               dur, mpred, msucc, active, b, n_b, n_valid, n_valid_dev, mode,
                               start, finish, level, n_done, q, state + csr, stream);
  if (state > MAX_SMEM) return (int)cudaErrorInvalidValue;
  return launch_csr<T, false>(pred_ptr, pred_idx, pred_nnz, succ_ptr, succ_idx, succ_nnz,
                              dur, mpred, msucc, active, b, n_b, n_valid, n_valid_dev, mode,
                              start, finish, level, n_done, q, state, stream);
}

constexpr int CUMSUM_TILE = 256;  // 8 values a lane

// out (rows, e + 1): out[r][0] = 0, out[r][k + 1] = out[r][k] + v[r][k], the
// adds strictly in order.  One warp per row.
__global__ void __launch_bounds__(32)
    seq_cumsum_kernel(const double* __restrict__ v, double* __restrict__ out, int e) {
  __shared__ double tile[CUMSUM_TILE];
  constexpr int PER_LANE = CUMSUM_TILE / 32;
  const int lane = threadIdx.x;
  const double* src = v + (size_t)blockIdx.x * e;
  double* dst = out + (size_t)blockIdx.x * ((size_t)e + 1);
  if (lane == 0) dst[0] = 0.0;
  double next[PER_LANE];
#pragma unroll
  for (int k = 0; k < PER_LANE; ++k) {
    const int i = k * 32 + lane;
    next[k] = i < e ? src[i] : 0.0;
  }
  double acc = 0.0;  // lane 0's running sum
  for (int base = 0; base < e; base += CUMSUM_TILE) {
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) tile[k * 32 + lane] = next[k];
    __syncwarp();
    // the next tile is in flight while lane 0 adds along this one
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
      const int i = base + CUMSUM_TILE + k * 32 + lane;
      next[k] = i < e ? src[i] : 0.0;
    }
    if (lane == 0) {
      const int m = e - base < CUMSUM_TILE ? e - base : CUMSUM_TILE;
      for (int j = 0; j < m; ++j) {
        acc = acc + tile[j];
        tile[j] = acc;
      }
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
      const int i = base + k * 32 + lane;
      if (i < e) dst[i + 1] = tile[k * 32 + lane];
    }
    __syncwarp();
  }
}

// The least a two-phase level can cost: one dependent shared-memory load, a
// barrier with a vote, one shared-memory store and a second barrier.  Timed by
// the smoke script to put a number on the chain that bounds the sweep.
__global__ void chain_probe_kernel(int levels, double* out) {
  extern __shared__ double s[];
  const int tid = threadIdx.x, nt = blockDim.x;
  s[tid] = (double)tid;
  __syncthreads();
  double x = 0.0;
  for (int l = 0; l < levels; ++l) {
    x = s[(tid + 1) % nt] + 1.0;
    if (!__syncthreads_or(x > 0.0)) break;
    s[tid] = x;
    __syncthreads();
  }
  if (tid == 0) out[blockIdx.x] = x;
}

// The least `seq_cumsum_kernel` can take a row: `n` float64 adds, each on the
// result of the one before.  One thread; `y` comes from the host, so the
// compiler can neither fold nor reorder the chain.  Timed by the smoke script.
__global__ void add_chain_probe_kernel(int n, double y, double* out) {
  double x = 0.0;
#pragma unroll 8
  for (int i = 0; i < n; ++i) x = x + y;
  out[0] = x;
}

}  // namespace

extern "C" {

// pred_ptr/succ_ptr: (n_b + 1) row offsets, pred_idx/succ_idx: the links
// (pred_nnz / succ_nnz of them), the graph's CSR; the rest as in the header.
// Returns a CUDA error code (cudaErrorInvalidValue for n_b above 8,192).
// n_valid_dev: null, or one int in device memory that the kernel takes as the
// real task count in place of n_valid.
int schedule_dp_sweep_f64(const int* pred_ptr, const int* pred_idx, int pred_nnz,
                          const int* succ_ptr, const int* succ_idx, int succ_nnz,
                          const double* dur, const int* mpred, const int* msucc,
                          const unsigned char* active, int b, int n_b, int n_valid,
                          const int* n_valid_dev, int mode, double* start, double* finish,
                          int* level, int* n_done, double* q, void* stream) {
  return launch_sweep<double>(pred_ptr, pred_idx, pred_nnz, succ_ptr, succ_idx, succ_nnz,
                              dur, mpred, msucc, active, b, n_b, n_valid, n_valid_dev, mode,
                              start, finish, level, n_done, q,
                              static_cast<cudaStream_t>(stream));
}

int schedule_dp_sweep_f32(const int* pred_ptr, const int* pred_idx, int pred_nnz,
                          const int* succ_ptr, const int* succ_idx, int succ_nnz,
                          const float* dur, const int* mpred, const int* msucc,
                          const unsigned char* active, int b, int n_b, int n_valid,
                          const int* n_valid_dev, int mode, float* start, float* finish,
                          int* level, int* n_done, float* q, void* stream) {
  return launch_sweep<float>(pred_ptr, pred_idx, pred_nnz, succ_ptr, succ_idx, succ_nnz,
                             dur, mpred, msucc, active, b, n_b, n_valid, n_valid_dev, mode,
                             start, finish, level, n_done, q, static_cast<cudaStream_t>(stream));
}

// v (rows, e) float64 -> out (rows, e + 1): each row's inclusive prefix sums
// after a leading 0, added strictly left to right.
int schedule_dp_seq_cumsum_f64(const double* v, double* out, int rows, int e, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  if (e < 0) return (int)cudaErrorInvalidValue;
  seq_cumsum_kernel<<<rows, 32, 0, static_cast<cudaStream_t>(stream)>>>(v, out, e);
  return (int)cudaGetLastError();
}

// 1 where a row of n_b tasks with nnz links (the larger list) keeps its
// CSR in shared memory, 0 where the kernel reads it from device memory
int schedule_dp_csr_in_smem(int n_b, int nnz, int elem_size) {
  return state_bytes(n_b, (size_t)elem_size) + csr_bytes(n_b, nnz) <= MAX_SMEM ? 1 : 0;
}

int schedule_dp_chain_probe(int levels, int blocks, int threads, double* out,
                            void* stream) {
  chain_probe_kernel<<<blocks, threads, threads * sizeof(double),
                       static_cast<cudaStream_t>(stream)>>>(levels, out);
  return (int)cudaGetLastError();
}

int schedule_dp_add_chain_probe(int n, double y, double* out, void* stream) {
  add_chain_probe_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(n, y, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
