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
// Design (one thread block of 512 threads owns the event's closure, as
// K1 owns a history's closure, so one of the H100's 132 SMs):
//   * The frontier, the table (rows, occupancy) and a claim word per
//     table slot live in dynamic shared memory for the whole closure.
//     A pass's candidates are never materialised in full: candidate
//     n*C + j is built from delta row n and slot j (the model step runs
//     here, sparse_common.cuh).
//   * Each pass builds every candidate once, into the registers of the
//     thread that probes it (row, hash, probe offset, flags; a contiguous
//     run of at most 4 a thread, so thread order is candidate order):
//     a probe round touches only pending candidates and never rebuilds
//     one, and the seed's candidates (the input rows) are loaded before
//     the prologue, so their latency overlaps it. Rounds are phase A,
//     barrier, phase B with atomicMin claims, barrier; the append's
//     places are one block prefix (warp shuffles, one barrier, every
//     warp then scanning the warp totals itself) with the probe
//     overflow folded into it. So the table, the offsets and the winners
//     are the reference's whatever order the threads run in, and the
//     fresh rows land where the reference's cumsum puts them.
//   * A pass of at most 32 candidates runs in warp 0 alone: rounds
//     separated by __syncwarp, a claim won by the lowest lane trying the
//     slot (__match_any_sync), the append's places from a ballot: no
//     block barrier until the pass ends.
//   * A pass of more than 4 candidates a thread runs sparse_common.cuh's
//     insert_pass (the offset and flags of every candidate in shared
//     memory, the candidate rebuilt where needed), as before.
//   * A device-side run flag (the scan's `ok`) makes the kernel write an
//     empty result at once once the history has failed or overflowed:
//     the scan discards that event's result, and the host never waits.
//
// Shared memory: 12N (frontier) + 17T (table rows, claim, occupancy) +
// 2NC (candidate offsets and flags, for insert_pass) + 1056 bytes; with
// T = 2N that is N(46 + 2C) + 1056, so N = 1024 fits the H100's 227 KB
// opt-in for every C <= 64 and N = 2048 for C <= 33
// (sparse_kernels.supported).
//
// What bounds it: the bytes it must move are small (the frontier in and
// out, the slot tables), and its operations are a few integer ops per
// probe of each candidate; the least time is far below what one block
// takes, since its probe rounds and closure passes run one after another
// on one SM. chip_smoke.py measures both against the bound on the card;
// PERF.md keeps the numbers.
//
// Build: nvcc -gencode=arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC frontier_closure.cu   (see kernels/__init__.py)

#include <cstdint>
#include <cuda_runtime.h>

#include "sparse_common.cuh"

namespace {

using namespace jt;

// 512 threads: barriers cost less than with 1,024, and a pass of up to
// 2,048 candidates still fits the registers
constexpr int kThreads = 512;
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

// Candidate li of an expansion pass: delta row n_old + li / C through
// slot li % C. Returns whether the candidate is live.
struct ExpandCand {
  Event ev;
  Shared s;
  int n_old;
  __device__ __forceinline__ bool operator()(int li, int32_t& st,
                                             uint32_t& ml,
                                             uint32_t& mh) const {
    const int d = li / ev.C;
    const int j = li - d * ev.C;
    const int n = n_old + d;
    const uint32_t ml0 = (uint32_t)s.ml[n], mh0 = (uint32_t)s.mh[n];
    const uint32_t blo = j < 32 ? (1u << j) : 0u;
    const uint32_t bhi = j >= 32 ? (1u << (j - 32)) : 0u;
    ml = ml0 | blo;
    mh = mh0 | bhi;
    bool ok;
    st = step(ev.step_code, s.st[n], s.f[j], s.a0[j], s.a1[j],
              s.wild[j] != 0, &ok);
    return ok && s.occ[j] != 0 && ((ml0 & blo) | (mh0 & bhi)) == 0;
  }
};

// Candidate li of the seed pass: input row li.
struct SeedCand {
  Event ev;
  __device__ __forceinline__ bool operator()(int li, int32_t& st,
                                             uint32_t& ml,
                                             uint32_t& mh) const {
    st = ev.st_in[li];
    ml = (uint32_t)ev.ml_in[li];
    mh = (uint32_t)ev.mh_in[li];
    return ev.live_in[li] != 0;
  }
};

// Exclusive prefix sum of v over the block, in thread order, with one
// barrier: each warp scans itself with shuffles and leaves its total in
// ws[warp]; after the barrier every warp scans the warp totals itself.
// *total gets the sum. Two calls must be separated by a barrier (the
// second overwrites ws). Every thread must call it.
__device__ __forceinline__ int scan_one_barrier(int v, int* ws, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) ws[warp] = x;
  __syncthreads();
  int w = lane < n_warps ? ws[lane] : 0;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, w, o);
    if (lane >= o) w += y;
  }
  const int before = __shfl_sync(0xffffffffu, w, warp > 0 ? warp - 1 : 0);
  *total = __shfl_sync(0xffffffffu, w, n_warps - 1);
  return (warp > 0 ? before : 0) + x - v;
}

constexpr int kRegCands = 4;  // candidates a thread holds, at most

struct PassOut {
  int n_fresh;
  bool ovf;  // a candidate exhausted its probes
};

// The candidates [lo, hi) of this thread (at most kRegCands, in order),
// built into registers: row, hash, offset 0, kPending when live.
template <class Cand>
__device__ __forceinline__ void build(const Cand& cand, int lo, int hi,
                                      Probe (&c)[kRegCands]) {
#pragma unroll
  for (int k = 0; k < kRegCands; ++k) {
    c[k].fl = 0;
    c[k].off = 0;
    if (lo + k < hi) {
      int32_t st;
      uint32_t ml, mh;
      const bool live = cand(lo + k, st, ml, mh);
      set_row(c[k], st, ml, mh);
      c[k].fl = live ? kPending : 0;
    }
  }
}

// One visited-set transaction of the whole block over its threads'
// register candidates (thread t holds candidates [lo, hi), a contiguous
// run, so thread order is candidate order): rounds (at least one) of
// phase A, barrier, phase B (atomicMin claims on the slots' claim words,
// the lowest index wins, losers re-check next round), barrier; then the
// append of the fresh ones after `count` at the block's exclusive
// prefix of the fresh counts (one barrier), rows past N dropped, and a
// barrier before the next pass reads them. The frontier rows the candidates came from are
// not written: the append starts at `count`.
__device__ PassOut probe_append(const Shared& s, const TableView& t,
                                Probe (&c)[kRegCands], int lo, int hi,
                                int count, int N, int probe_limit) {
  // the first round needs no barrier before it: the rows and slots the
  // candidates were built from are only read, and the last pass (or the
  // prologue) ended with one
  int active = 1, local;
  while (active) {
#pragma unroll
    for (int k = 0; k < kRegCands; ++k) {
      if (lo + k < hi) probe_a<PlainLoads>(c[k], t, lo + k, probe_limit);
    }
    __syncthreads();
    local = 0;
#pragma unroll
    for (int k = 0; k < kRegCands; ++k) {
      if (lo + k < hi) {
        local |= probe_b<PlainLoads>(c[k], t, lo + k, probe_limit);
      }
    }
    active = __syncthreads_or(local);
  }
  // fresh counts in the low 16 bits, threads still pending above
  int n_mine = 0, pend = 0;
#pragma unroll
  for (int k = 0; k < kRegCands; ++k) {
    n_mine += (c[k].fl & kFresh) != 0;
    pend |= (c[k].fl & kPending) != 0;
  }
  int sum;
  int pos = count + (scan_one_barrier(n_mine | (pend << 16), s.scan, &sum) &
                     0xFFFF);
#pragma unroll
  for (int k = 0; k < kRegCands; ++k) {
    if (c[k].fl & kFresh) {
      if (pos < N) {
        s.st[pos] = c[k].st;
        s.ml[pos] = (int32_t)c[k].ml;
        s.mh[pos] = (int32_t)c[k].mh;
      }
      ++pos;
    }
  }
  __syncthreads();
  return {sum & 0xFFFF, (sum >> 16) != 0};
}

// A pass of at most 32 candidates in warp 0 alone: lane li builds
// candidate li; rounds separated by __syncwarp, a claim won by the lowest
// lane trying the slot (__match_any_sync: lanes are in candidate order,
// so that is the lowest index), no claim words; the append's places from
// a ballot. The outcome reaches the block through bc[0..1] and one
// barrier.
template <class Cand>
__device__ PassOut warp_pass(const Shared& s, const TableView& t,
                             const Cand& cand, int M, int count, int N,
                             int probe_limit, int* bc) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    Probe p{};
    if (lane < M) {
      int32_t st;
      uint32_t ml, mh;
      const bool live = cand(lane, st, ml, mh);
      set_row(p, st, ml, mh);
      p.fl = live ? kPending : 0;
    }
    while (true) {
      const bool act = (p.fl & kPending) && p.off < probe_limit;
      if (!__any_sync(0xffffffffu, act)) break;
      int slot = -1;
      bool occ = false, same = false;
      if (act) {
        slot = (int)((p.h + (uint32_t)p.off) & t.mask);
        occ = t.occ[slot] != 0;
        same = occ && t.st[slot] == p.st && (uint32_t)t.ml[slot] == p.ml &&
               (uint32_t)t.mh[slot] == p.mh;
      }
      __syncwarp();  // every read of the round before any write
      const unsigned rivals =
          __match_any_sync(0xffffffffu, act && !occ ? slot : -1 - lane);
      if (act) {
        if (same) {
          p.fl = 0;  // already visited
        } else if (occ) {
          p.off += 1;
        } else if (__ffs(rivals) - 1 == lane) {
          t.st[slot] = p.st;
          t.ml[slot] = (int32_t)p.ml;
          t.mh[slot] = (int32_t)p.mh;
          t.occ[slot] = 1;
          p.fl = kFresh;
        }
      }
      __syncwarp();  // the round's writes before the next round's reads
    }
    const unsigned fresh = __ballot_sync(0xffffffffu, p.fl & kFresh);
    const unsigned pend = __ballot_sync(0xffffffffu, p.fl & kPending);
    if (p.fl & kFresh) {
      const int pos = count + __popc(fresh & lanemask_lt());
      if (pos < N) {
        s.st[pos] = p.st;
        s.ml[pos] = (int32_t)p.ml;
        s.mh[pos] = (int32_t)p.mh;
      }
    }
    if (lane == 0) {
      bc[0] = __popc(fresh);
      bc[1] = pend != 0;
    }
  }
  __syncthreads();
  return {bc[0], bc[1] != 0};
}

// One visited-set transaction over the M candidates `cand` builds,
// appending the fresh ones to the frontier after `count`:
// sparse._hash_insert_append, bit for bit. At most 32 candidates: warp 0
// alone (warp_pass). At most 4 a thread: each built once into the
// registers of the thread that probes it (probe_append). More:
// sparse_common.cuh's insert_pass (offset and flags of every candidate
// in shared memory, the candidate rebuilt where needed). `pass` numbers
// the passes of the launch: it picks which two spare scan words carry
// warp 0's outcome to the block, so that one pass's words are never
// rewritten while another thread may still read them. Uniform: every
// thread gets the result.
template <class Cand>
__device__ PassOut k2_pass(const Event& ev, const Shared& s,
                           const Cand& cand, int M, int count, int pass) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const TableView t{s.tst, s.tml, s.tmh, s.claim, s.tocc,
                    (uint32_t)(ev.T - 1)};
  if (M <= 32) {
    return warp_pass(s, t, cand, M, count, ev.N, ev.probe_limit,
                     s.scan + 32 + 2 * (pass & 1));
  }
  if (M > nt * kRegCands) {
    bool probe_ovf;
    const int n_fresh =
        insert_pass(cand, t, s.off, s.flags, s.scan, M, ev.probe_limit,
                    s.st, s.ml, s.mh, count, ev.N, &probe_ovf);
    return {n_fresh, probe_ovf};
  }
  const int per = (M + nt - 1) / nt;
  const int lo = min(M, tid * per), hi = min(M, lo + per);
  Probe c[kRegCands];
  build(cand, lo, hi, c);
  return probe_append(s, t, c, lo, hi, count, ev.N, ev.probe_limit);
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

  // the seed's candidates (this thread's input rows) are loaded first,
  // so that their latency overlaps the prologue's; the frontier needs no
  // clearing: rows are read only below `count`
  const bool seed_regs = N > 32 && N <= nt * kRegCands;
  const int s_per = (N + nt - 1) / nt;
  const int s_lo = min(N, tid * s_per), s_hi = min(N, s_lo + s_per);
  Probe seed[kRegCands];
  if (seed_regs) build(SeedCand{ev}, s_lo, s_hi, seed);
  for (int i = tid; i < T; i += nt) {
    s.tocc[i] = 0;
    s.claim[i] = kClaimFree;
  }
  for (int j = tid; j < C; j += nt) {
    s.f[j] = f[j];
    s.a0[j] = a0[j];
    s.a1[j] = a1[j];
    s.wild[j] = wild[j];
    s.occ[j] = occ[j];
  }
  __syncthreads();

  int pass = 0;
  const TableView tv{s.tst, s.tml, s.tmh, s.claim, s.tocc, (uint32_t)(T - 1)};
  PassOut r = seed_regs
      ? probe_append(s, tv, seed, s_lo, s_hi, 0, N, ev.probe_limit)
      : k2_pass(ev, s, SeedCand{ev}, N, 0, pass);
  ++pass;
  int count = min(r.n_fresh, N);
  bool ovf = r.ovf || r.n_fresh > N;
  int n_old = 0, iters = 0, stepped = 0;
  bool changed = true;
  while (changed && !ovf) {
    r = k2_pass(ev, s, ExpandCand{ev, s, n_old}, (count - n_old) * C, count,
                pass++);
    stepped += count - n_old;
    ovf = ovf || r.ovf || count + r.n_fresh > N;
    n_old = count;
    count = min(count + r.n_fresh, N);
    ++iters;
    changed = r.n_fresh > 0;
  }

  for (int i = tid; i < N; i += nt) {
    const bool in = i < count;
    st_out[i] = in ? s.st[i] : 0;
    ml_out[i] = in ? s.ml[i] : 0;
    mh_out[i] = in ? s.mh[i] : 0;
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
