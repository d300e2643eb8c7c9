// Schedule-DP sweep for Hopper (sm_90a): the level-synchronous longest-path
// recursion over the conjunctive DAG plus the machine-order links, one
// candidate schedule per row.
//
// Replaces the TPU kernel `sweep_pallas` (src/repro/kernels/schedule_dp.py,
// kernel body `kernel`, level loop `run`).  That kernel reduces over a dense
// (rows, n_b, n_b) predecessor mask because the TPU's vector unit has no cheap
// gather.  A GPU gathers freely, so this kernel uses the gather-side form of
// the same recursion (`level_loop_xla` in that file): a task's value is
// `node_add + max(0, values of its links)`, the links being the `deg` slots of
// a -1 padded index matrix shared by all rows plus one per-row machine link,
// and a task fires at the first level at which all its links have fired.
//
// What bounds it on this card: not bytes and not arithmetic.  A row moves
// about 32 bytes per task and does a handful of max/add per link, both far
// below a microsecond for the batches the search sends.  The time is the
// dependency chain: the levels of one row run one after another, and each
// level costs a shared-memory round trip and two block barriers.  The design
// therefore gives every row its own thread block (rows are independent, so
// nothing crosses blocks and up to one row per SM runs concurrently), keeps
// the row's whole state (values, done flags, node weights, machine links) in
// shared memory so a level touches no device memory except the link matrix
// (which every block shares and which stays in L1/L2), and ends a row's loop
// as soon as nothing in it is ready.
//
// A level is two phases separated by barriers.  Phase 1: every unfinished
// task reads the PREVIOUS level's done flags and values of its links and
// decides whether it is ready and what its value is.  Phase 2: the ready
// tasks publish.  So `level` is exactly the Kahn pop level, rows with a cycle
// stall with n_done < n_valid, and padding tasks (index >= n_valid) never fire.
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

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

enum { MODE_FORWARD = 0, MODE_FORWARD_TAILS = 1, MODE_BACKWARD = 2 };

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

// max(0, values of the links of task i), all links known to be done
template <typename T>
__device__ __forceinline__ T link_max(const int* __restrict__ link_row, int deg,
                                      int mlink, const T* val) {
  T base = neg_inf<T>();
  if (mlink >= 0) base = pmax(base, val[mlink]);
  for (int d = 0; d < deg; ++d) {
    const int l = link_row[d];
    if (l >= 0) base = pmax(base, val[l]);
  }
  return pmax(base, T(0));
}

// The masked level loop on one row.  On return val[i] is the value of every
// task that fired and 0 elsewhere, done[i] says which fired.  wt[i] and lv[i]
// are read only by the thread that owns index i.
template <typename T>
__device__ void level_loop(const int* __restrict__ link_mat, int deg, int n_b,
                           int n_valid, T* val, T* nv, const T* wt,
                           const int* lv, unsigned char* done,
                           unsigned char* rdy, int* level_out) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < n_b; i += nt) {
    val[i] = T(0);
    done[i] = 0;
  }
  __syncthreads();
  int lev = 0;
  while (true) {
    // phase 1: ready + new value from the previous level's state
    int any = 0;
    for (int i = tid; i < n_b; i += nt) {
      unsigned char r = 0;
      if (i < n_valid && !done[i]) {
        const int m = lv[i];
        bool ok = (m < 0) || done[m];
        const int* __restrict__ row = link_mat + (size_t)i * deg;
        for (int d = 0; ok && d < deg; ++d) {
          const int l = row[d];
          ok = (l < 0) || done[l];
        }
        if (ok) {
          nv[i] = link_max<T>(row, deg, m, val) + wt[i];
          r = 1;
        }
      }
      rdy[i] = r;
      any |= r;
    }
    // barrier: every read of the previous state is over before anyone writes
    if (!__syncthreads_or(any) || lev > n_valid) break;
    // phase 2: publish
    for (int i = tid; i < n_b; i += nt) {
      if (rdy[i]) {
        val[i] = nv[i];
        done[i] = 1;
        if (level_out) level_out[i] = lev;
      }
    }
    __syncthreads();
    ++lev;
  }
}

template <typename T>
__global__ void sweep_kernel(const int* __restrict__ pred_mat, int pred_deg,
                             const int* __restrict__ succ_mat, int succ_deg,
                             const T* __restrict__ dur,
                             const int* __restrict__ mpred,
                             const int* __restrict__ msucc,
                             const unsigned char* __restrict__ active,
                             int n_b, int n_valid, int mode,
                             T* start, T* finish, int* level, int* n_done,
                             T* q) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* val = reinterpret_cast<T*>(smem);
  T* nv = val + n_b;
  T* wt = nv + n_b;
  int* lv = reinterpret_cast<int*>(wt + n_b);
  unsigned char* done = reinterpret_cast<unsigned char*>(lv + n_b);
  unsigned char* rdy = done + n_b;
  __shared__ int s_count;

  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t off = (size_t)blockIdx.x * n_b;

  if (mode != MODE_BACKWARD) {
    for (int i = tid; i < n_b; i += nt) {
      wt[i] = dur[off + i];
      lv[i] = mpred[off + i];
      level[off + i] = 0;
    }
    if (tid == 0) s_count = 0;
    level_loop<T>(pred_mat, pred_deg, n_b, n_valid, val, nv, wt, lv, done, rdy,
                  level + off);
    // val now holds finish.  start is the same masked max once more (not
    // finish - dur: that differs in the last bit and breaks on inf durations)
    int cnt = 0;
    for (int i = tid; i < n_b; i += nt) {
      T s = T(0), f = T(0);
      if (done[i]) {
        s = link_max<T>(pred_mat + (size_t)i * pred_deg, pred_deg, lv[i], val);
        f = val[i];
        cnt += (i < n_valid) ? 1 : 0;
      }
      start[off + i] = s;
      finish[off + i] = f;
      wt[i] = f - s;  // node weight of the backward loop
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
    for (int i = tid; i < n_b; i += nt) wt[i] = dur[off + i];
  }

  for (int i = tid; i < n_b; i += nt) lv[i] = msucc[off + i];
  level_loop<T>(succ_mat, succ_deg, n_b, n_valid, val, nv, wt, lv, done, rdy,
                nullptr);
  for (int i = tid; i < n_b; i += nt) q[off + i] = val[i];
}

template <typename T>
int launch_sweep(const int* pred_mat, int pred_deg, const int* succ_mat,
                 int succ_deg, const T* dur, const int* mpred,
                 const int* msucc, const unsigned char* active, int b, int n_b,
                 int n_valid, int mode, T* start, T* finish, int* level,
                 int* n_done, T* q, cudaStream_t stream) {
  if (b <= 0) return (int)cudaSuccess;
  int threads = ((n_b + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem = (size_t)n_b * (3 * sizeof(T) + sizeof(int) + 2);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sweep_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sweep_kernel<T><<<b, threads, smem, stream>>>(
      pred_mat, pred_deg, succ_mat, succ_deg, dur, mpred, msucc, active, n_b,
      n_valid, mode, start, finish, level, n_done, q);
  return (int)cudaGetLastError();
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

}  // namespace

extern "C" {

int schedule_dp_sweep_f64(const int* pred_mat, int pred_deg,
                          const int* succ_mat, int succ_deg, const double* dur,
                          const int* mpred, const int* msucc,
                          const unsigned char* active, int b, int n_b,
                          int n_valid, int mode, double* start, double* finish,
                          int* level, int* n_done, double* q, void* stream) {
  return launch_sweep<double>(pred_mat, pred_deg, succ_mat, succ_deg, dur,
                              mpred, msucc, active, b, n_b, n_valid, mode,
                              start, finish, level, n_done, q,
                              static_cast<cudaStream_t>(stream));
}

int schedule_dp_sweep_f32(const int* pred_mat, int pred_deg,
                          const int* succ_mat, int succ_deg, const float* dur,
                          const int* mpred, const int* msucc,
                          const unsigned char* active, int b, int n_b,
                          int n_valid, int mode, float* start, float* finish,
                          int* level, int* n_done, float* q, void* stream) {
  return launch_sweep<float>(pred_mat, pred_deg, succ_mat, succ_deg, dur, mpred,
                             msucc, active, b, n_b, n_valid, mode, start,
                             finish, level, n_done, q,
                             static_cast<cudaStream_t>(stream));
}

int schedule_dp_chain_probe(int levels, int blocks, int threads, double* out,
                            void* stream) {
  chain_probe_kernel<<<blocks, threads, threads * sizeof(double),
                       static_cast<cudaStream_t>(stream)>>>(levels, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
