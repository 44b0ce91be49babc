// K2: one return event's whole delta-frontier hash closure, for Hopper.
//
// Replaces jepsen_tpu/parallel/sparse_kernels.py::frontier_closure_call
// (the Pallas TPU kernel whose body is engine._hash_event_closure). For
// one return event of the sparse engine it takes the frontier, N rows of
// (state, mask_lo, mask_hi) int32 lanes with a live flag, and the
// event's C slot tables, and computes what
// jepsen_tpu_torch.parallel.sparse._hash_event_closure computes, bit for
// bit, rows in the same order:
//
//   seed    insert the live rows into an empty open-addressed visited set
//           (T = next_pow2(2N) slots) and append the first sightings,
//           compacted, to an empty frontier;
//   repeat  step every delta row (the rows the last pass appended)
//           through every open slot j it has not linearized; insert the
//           candidates n*C + j; append the fresh ones in candidate order;
//           until a pass finds nothing fresh, or a probe run or the
//           frontier overflows.
//
// Output: the frontier lanes and meta = (count, ovf, iters, stepped).
//
// Design (one thread block owns the event's closure, as K1 owns a
// history's closure, so one of the H100's 132 SMs):
//   * The frontier, the table (rows, occupancy) and a claim word per
//     table slot live in dynamic shared memory for the whole closure;
//     the candidates are never materialised: candidate n*C + j is
//     rebuilt from delta row n and slot j (the model step runs here,
//     sparse_common.cuh) whenever it is needed, and only a probe offset
//     and a flag byte per candidate are kept.
//   * Probing is round-synchronous, as in the reference's while loop:
//     every pending candidate reads its slot; an equal occupant drops it,
//     a different one advances it, an empty slot takes an atomicMin of
//     its candidate index. After __syncthreads the lowest index writes
//     the slot; the losers re-check the same slot next round (the winner
//     may hold an equal row). Reads of a round all precede its writes,
//     so the table, the offsets and the winners are those of the
//     reference, whatever order the threads run in.
//   * The append is a block-wide prefix sum of the fresh flags in
//     candidate order, so rows land where the reference's cumsum puts
//     them.
//   * A device-side run flag (the scan's `ok`) makes the kernel write an
//     empty result at once once the history has failed or overflowed:
//     the scan discards that event's result, and the host never waits.
//
// Shared memory: 12N (frontier) + 17T (table rows, claim, occupancy) +
// 2NC (candidate offsets and flags) + 1056 bytes; with T = 2N that is
// N(46 + 2C) + 1056, so N = 1024 fits the H100's 227 KB opt-in for every
// C <= 64 and N = 2048 for C <= 33 (sparse_kernels.supported).
//
// What bounds it: the bytes it must move are small (the frontier in and
// out, the slot tables), and its operations are a few integer ops per
// probe of each candidate; the least time is far below what one block
// takes, since its probe rounds and closure passes run one after another
// on one SM, each behind a barrier. chip_smoke.py measures both against
// the bound on the card; PERF.md keeps the numbers.
//
// Build: nvcc -gencode=arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC frontier_closure.cu   (see kernels/__init__.py)

#include <cstdint>
#include <cuda_runtime.h>

#include "sparse_common.cuh"

namespace {

using namespace jt;

constexpr int kThreads = 1024;
constexpr int kMaxC = 64;

int table_size(int N) {
  int T = 2;
  while (T < 2 * N) T <<= 1;
  return T;
}

size_t smem_bytes(int N, int C) {
  const size_t T = (size_t)table_size(N);
  return 12 * (size_t)N + 17 * T + 2 * (size_t)N * C + 3 * 4 * kMaxC +
         40 * 4 + 2 * kMaxC;
}

struct Shared {
  int32_t *st, *ml, *mh;     // frontier rows [N]
  int32_t *tst, *tml, *tmh;  // table rows [T]
  int32_t* claim;            // [T], kClaimFree between rounds
  int32_t *f, *a0, *a1;      // slot tables [kMaxC]
  int32_t* scan;             // [32] warp sums, then 8 spare words
  uint8_t *off, *flags;      // per candidate [N*C]
  uint8_t* tocc;             // [T]
  uint8_t *wild, *occ;       // [kMaxC]
};

struct Event {
  int step_code, N, C, T, probe_limit;
  const int32_t *st_in, *ml_in, *mh_in;
  const uint8_t* live_in;
};

// Candidate li of a pass. The seed pass's candidates are the input rows;
// an expansion pass's are the delta rows [n_old, count) times the C
// slots, index n*C + j. Returns whether the candidate is live.
__device__ __forceinline__ bool candidate(const Event& ev, const Shared& s,
                                          bool seed, int n_old, int li,
                                          int32_t& st, uint32_t& ml,
                                          uint32_t& mh) {
  if (seed) {
    st = ev.st_in[li];
    ml = (uint32_t)ev.ml_in[li];
    mh = (uint32_t)ev.mh_in[li];
    return ev.live_in[li] != 0;
  }
  const int d = li / ev.C;
  const int j = li - d * ev.C;
  const int n = n_old + d;
  const uint32_t ml0 = (uint32_t)s.ml[n], mh0 = (uint32_t)s.mh[n];
  const uint32_t blo = j < 32 ? (1u << j) : 0u;
  const uint32_t bhi = j >= 32 ? (1u << (j - 32)) : 0u;
  ml = ml0 | blo;
  mh = mh0 | bhi;
  bool ok;
  st = step(ev.step_code, s.st[n], s.f[j], s.a0[j], s.a1[j], s.wild[j] != 0,
            &ok);
  return ok && s.occ[j] != 0 && ((ml0 & blo) | (mh0 & bhi)) == 0;
}

// One visited-set transaction over the M candidates of a pass, appending
// the fresh ones after `count`. Returns the number of fresh candidates;
// *probe_ovf says whether some candidate exhausted its probes. Uniform:
// every thread gets the same values.
__device__ int insert_pass(const Event& ev, const Shared& s, bool seed,
                           int n_old, int count, int M, bool* probe_ovf) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int base = seed ? 0 : n_old * ev.C;  // candidate index of li = 0
  int local = 0;
  for (int li = tid; li < M; li += nt) {
    int32_t st;
    uint32_t ml, mh;
    const bool live = candidate(ev, s, seed, n_old, li, st, ml, mh);
    s.flags[li] = live ? kPending : 0;
    s.off[li] = 0;
    local |= live;
  }
  int active = __syncthreads_or(local);
  while (active) {
    // read the slots, drop, advance or claim
    for (int li = tid; li < M; li += nt) {
      if (!(s.flags[li] & kPending) || s.off[li] >= ev.probe_limit) continue;
      int32_t st;
      uint32_t ml, mh;
      candidate(ev, s, seed, n_old, li, st, ml, mh);
      const int slot = (int)((table_hash(st, ml, mh) + s.off[li]) &
                             (uint32_t)(ev.T - 1));
      if (s.tocc[slot]) {
        if (s.tst[slot] == st && (uint32_t)s.tml[slot] == ml &&
            (uint32_t)s.tmh[slot] == mh) {
          s.flags[li] = 0;  // already visited
        } else {
          s.off[li] += 1;
        }
      } else {
        atomicMin(&s.claim[slot], base + li);
        s.flags[li] = kPending | kTry;
      }
    }
    __syncthreads();
    // the lowest claimant of each slot writes it and frees the claim
    local = 0;
    for (int li = tid; li < M; li += nt) {
      uint8_t fl = s.flags[li];
      if (fl & kTry) {
        int32_t st;
        uint32_t ml, mh;
        candidate(ev, s, seed, n_old, li, st, ml, mh);
        const int slot = (int)((table_hash(st, ml, mh) + s.off[li]) &
                               (uint32_t)(ev.T - 1));
        if (s.claim[slot] == base + li) {
          s.tst[slot] = st;
          s.tml[slot] = (int32_t)ml;
          s.tmh[slot] = (int32_t)mh;
          s.tocc[slot] = 1;
          s.claim[slot] = kClaimFree;
          s.flags[li] = kFresh;
          continue;
        }
        fl = kPending;
        s.flags[li] = fl;
      }
      if ((fl & kPending) && s.off[li] < ev.probe_limit) local = 1;
    }
    active = __syncthreads_or(local);
  }

  // append the fresh candidates after `count`, in candidate order
  const int per = (M + nt - 1) / nt;
  const int lo = min(M, tid * per), hi = min(M, lo + per);
  int mine = 0, pend = 0;
  for (int li = lo; li < hi; ++li) {
    mine += (s.flags[li] & kFresh) != 0;
    pend |= (s.flags[li] & kPending) != 0;
  }
  int n_fresh;
  int pos = count + block_exclusive_scan(mine, s.scan, &n_fresh);
  *probe_ovf = __syncthreads_or(pend) != 0;
  for (int li = lo; li < hi; ++li) {
    if (!(s.flags[li] & kFresh)) continue;
    if (pos < ev.N) {
      int32_t st;
      uint32_t ml, mh;
      candidate(ev, s, seed, n_old, li, st, ml, mh);
      s.st[pos] = st;
      s.ml[pos] = (int32_t)ml;
      s.mh[pos] = (int32_t)mh;
    }
    ++pos;
  }
  __syncthreads();
  return n_fresh;
}

__global__ void __launch_bounds__(kThreads, 1)
frontier_closure_kernel(Event ev, const int32_t* __restrict__ f,
                        const int32_t* __restrict__ a0,
                        const int32_t* __restrict__ a1,
                        const uint8_t* __restrict__ wild,
                        const uint8_t* __restrict__ occ,
                        const uint8_t* __restrict__ run, int32_t* st_out,
                        int32_t* ml_out, int32_t* mh_out, int32_t* meta) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int N = ev.N, T = ev.T, C = ev.C;

  if (*run == 0) {
    // the history already failed or overflowed: an empty result, which
    // the scan discards (uniform branch, no barrier)
    for (int i = tid; i < N; i += nt) st_out[i] = ml_out[i] = mh_out[i] = 0;
    if (tid < 4) meta[tid] = 0;
    return;
  }

  Shared s;
  int32_t* w = reinterpret_cast<int32_t*>(smem);
  s.st = w; w += N;
  s.ml = w; w += N;
  s.mh = w; w += N;
  s.tst = w; w += T;
  s.tml = w; w += T;
  s.tmh = w; w += T;
  s.claim = w; w += T;
  s.f = w; w += kMaxC;
  s.a0 = w; w += kMaxC;
  s.a1 = w; w += kMaxC;
  s.scan = w; w += 40;
  uint8_t* b = reinterpret_cast<uint8_t*>(w);
  s.off = b; b += (size_t)N * C;
  s.flags = b; b += (size_t)N * C;
  s.tocc = b; b += T;
  s.wild = b; b += kMaxC;
  s.occ = b;

  for (int i = tid; i < T; i += nt) {
    s.tocc[i] = 0;
    s.claim[i] = kClaimFree;
  }
  for (int i = tid; i < N; i += nt) s.st[i] = s.ml[i] = s.mh[i] = 0;
  for (int j = tid; j < C; j += nt) {
    s.f[j] = f[j];
    s.a0[j] = a0[j];
    s.a1[j] = a1[j];
    s.wild[j] = wild[j];
    s.occ[j] = occ[j];
  }
  __syncthreads();

  bool p_ovf;
  const int n0 = insert_pass(ev, s, true, 0, 0, N, &p_ovf);
  int count = min(n0, N);
  bool ovf = p_ovf || n0 > N;
  int n_old = 0, iters = 0, stepped = 0;
  bool changed = true;
  while (changed && !ovf) {
    const int n_fresh =
        insert_pass(ev, s, false, n_old, count, (count - n_old) * C, &p_ovf);
    stepped += count - n_old;
    ovf = ovf || p_ovf || count + n_fresh > N;
    n_old = count;
    count = min(count + n_fresh, N);
    ++iters;
    changed = n_fresh > 0;
  }

  for (int i = tid; i < N; i += nt) {
    st_out[i] = s.st[i];
    ml_out[i] = s.ml[i];
    mh_out[i] = s.mh[i];
  }
  if (tid == 0) {
    meta[0] = count;
    meta[1] = ovf ? 1 : 0;
    meta[2] = iters;
    meta[3] = stepped;
  }
}

}  // namespace

extern "C" {

// Once per device, before the first launch there: lets the kernel use the
// block's whole shared-memory opt-in. Returns that opt-in in bytes (the
// caller gates shapes by it), or minus the cudaError_t.
int jt_frontier_closure_init(void) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute((const void*)frontier_closure_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  }
  return err == cudaSuccess ? optin : -(int)err;
}

// The kernel's dynamic shared memory at (N, C), in bytes: the layout the
// caller's gate (sparse_kernels.k2_smem_bytes) must agree with.
long long jt_frontier_closure_smem(int N, int C) {
  return (long long)smem_bytes(N, C);
}

// One event's closure on `stream`. Slot tables f/a0/a1/wild/occ are [C],
// rows and live [N], run one byte, meta [4]. Returns the cudaError_t of
// the launch (cudaErrorInvalidValue for a shape the kernel does not
// take).
int jt_frontier_closure_launch(int step_code, const int32_t* f,
                               const int32_t* a0, const int32_t* a1,
                               const uint8_t* wild, const uint8_t* occ,
                               const int32_t* st_in, const int32_t* ml_in,
                               const int32_t* mh_in, const uint8_t* live_in,
                               const uint8_t* run, int32_t* st_out,
                               int32_t* ml_out, int32_t* mh_out,
                               int32_t* meta, int N, int C, int probe_limit,
                               void* stream) {
  if (N < 1 || C < 1 || C > kMaxC || probe_limit < 1 || probe_limit > 255 ||
      step_code < kRegister || step_code > kFifo) {
    return (int)cudaErrorInvalidValue;
  }
  Event ev{step_code, N, C, table_size(N), probe_limit,
           st_in,     ml_in, mh_in, live_in};
  frontier_closure_kernel<<<1, kThreads, smem_bytes(N, C),
                            reinterpret_cast<cudaStream_t>(stream)>>>(
      ev, f, a0, a1, wild, occ, run, st_out, ml_out, mh_out, meta);
  return (int)cudaGetLastError();
}

}  // extern "C"
