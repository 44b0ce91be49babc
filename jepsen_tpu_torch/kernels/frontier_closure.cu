// K2: one return event's whole delta-frontier hash closure, for Hopper.
//
// Replaces jepsen_tpu/parallel/sparse_kernels.py::frontier_closure_call
// (the Pallas TPU kernel whose body is engine._hash_event_closure). For
// one return event of the sparse engine it takes the frontier, N rows of
// L int32 lanes with a live flag, and the event's C slot tables, and
// computes what
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
// Search stats (the reference's frontier_closure_call(..., stats=True)):
// a second instantiation of the kernel (the template's Stats = true,
// picked when the caller passes a stats buffer) also writes stats[8] a
// key: swork, the sum over the closure's passes of the frontier count at
// the pass's start (what a sort closure would have stepped), then the
// histogram of the final probe offsets of every attempted (live)
// candidate of the seed and of every pass, bucketed at 1, 2, 4, 8, 16
// and 32 (search_stats.PROBE_HIST_EDGES). Each thread counts the
// candidates it resolves in seven registers; at the end each warp adds
// its sums into seven shared words with one atomicAdd a bucket, and
// thread 0 stores the eight words. A candidate's final offset is where
// its probe ended: at an equal row, at the slot it claimed (a loser of a
// claim re-checks the same slot, so its offset does not move) or, past
// probe_limit probes, at probe_limit. Stats = false is the stats-off
// kernel, its code unchanged.
//
// Rows. A row is the triple (state, mask_lo, mask_hi), L = 3, or the
// packed word of config_pack (sparse._PackedRep), L = 1 or 2: the state
// field (state - state_lo) in bits [0, s_bits), slot j's bit at s_bits +
// j, the word's low and high halves in lanes 0 and 1. The kernel is a
// template on L (one instantiation each); a packed row's model state is
// (w0 & smask) + state_lo, and its candidate through slot j keeps w0's
// mask bits, takes the stepped state's field and sets the bit at s_bits
// + j, in lane 0 below bit 32 and in lane 1 from there. Everything else
// (the table, its hash, the probes, the append) is sparse_common.cuh's,
// generic over L.
//
// Batched over keys (the per-key batch, engine.check_batch): one launch
// runs K keys' closures of one event row, a block or a thread-block
// cluster a key. Key `key` reads its event's slot tables in place at
// (key * R + r) * C of the batch's [K, R, C] tables, and its own rows,
// live flags, run flag and meta at key * N, key and key * 4; its table
// lives in its own shared memory. The single-key launch is the same
// entry with K = R = 1, so one body serves both.
//
// The batch's cluster (sparse_kernels.k2_cluster: 8 blocks a key where
// K > 1 and N * C > 4,096, else one). A row's launch lasts as long as
// its slowest key, and one block a key leaves most SMs idle (26 keys of
// the sparse batch on 26 of 132): a key's widest passes, past the
// registers' 2,048 candidates, rebuilt every candidate each round in
// insert_pass on one SM. So every block of a key's cluster keeps a copy
// of the key's frontier and table and runs the narrow passes whole (the
// same transaction on the same state leaves every copy the same, and
// needs no barrier across the cluster), and a pass of more than
// kSplitMin candidates that the cluster's registers hold is split over
// it (split_pass): reads stay local, claims meet on the leader's claim
// words through distributed shared memory, and the winners' rows and
// the appended rows are written into every copy.
//
// Design (one thread block of 512 threads owns the event's closure, as
// K1 owns a history's closure, so one of the H100's 132 SMs; a batch of
// at most 132 keys runs in one wave when one block a SM is resident):
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
// Shared memory: 4LN (frontier) + (4L + 5)T (table rows, claim,
// occupancy) + 2NC (candidate offsets and flags, for insert_pass) + 1056
// bytes; with T = 2N that is N(12L + 10 + 2C) + 1056. For the triple,
// N = 1024 fits the H100's 227 KB opt-in for every C <= 64 and N = 2048
// for C <= 33; for one lane, N = 2048 for every C <= 64 and N = 4096 for
// C <= 17 (sparse_kernels.supported).
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
constexpr int kMaxCluster = 8;
// A pass of more candidates than this is split over the key's cluster
// (when it has more than one block and the pass fits its registers);
// every block runs a smaller one whole, on its own copy.
constexpr int kSplitMin = 2048;

int table_size(int N) {
  int T = 2;
  while (T < 2 * N) T <<= 1;
  return T;
}

size_t smem_bytes(int N, int C, int L) {
  const size_t T = (size_t)table_size(N);
  return 4 * (size_t)L * N + (4 * (size_t)L + 5) * T + 2 * (size_t)N * C +
         3 * 4 * kMaxC + 40 * 4 + 2 * kMaxC;
}

// The largest cluster of each instantiation (index 2 * (L - 1) + Stats)
// the card runs at the block's whole opt-in, per device
// (jt_frontier_closure_init).
constexpr int kMaxDevices = 64;
int g_max_cluster[kMaxDevices][6];

template <int L>
struct Shared {
  int32_t* f[L];             // frontier rows [N], lane by lane
  int32_t* t[L];             // table rows [T], lane by lane
  int32_t* claim;            // [T], kClaimFree between rounds
  int32_t *fn, *a0, *a1;     // slot tables [kMaxC]
  int32_t* scan;             // [32] warp sums, then 8 spare words
  uint8_t *off, *flags;      // per candidate [N*C] (insert_pass)
  int32_t* act;              // [2] split rounds' "still probing", by
                             // parity: spare scan words 36-37
  int32_t* wtot;             // [kMaxCluster] a split pass's block totals,
                             // at the start of off (no insert_pass runs
                             // then)
  uint8_t* tocc;             // [T]
  uint8_t *wild, *occ;       // [kMaxC]
};

struct Event {
  int step_code, N, C, T, probe_limit;
  int s_bits;        // packed rows: the state field's bits
  int32_t state_lo;  // packed rows: the state of field 0
  uint32_t smask;    // packed rows: (1 << s_bits) - 1
  const int32_t* in[3];
  const uint8_t* live_in;
};

// A row's model state: the triple's lane 0, or the packed word's field
// plus state_lo (wrapping, as int32).
template <int L>
__device__ __forceinline__ int32_t row_state(const Event& ev,
                                             const uint32_t (&w)[L]) {
  if constexpr (L == 3) {
    return (int32_t)w[0];
  } else {
    return (int32_t)((w[0] & ev.smask) + (uint32_t)ev.state_lo);
  }
}

// Slot j's mask bit, lane by lane (the triple's state lane has none).
template <int L>
__device__ __forceinline__ void slot_bits(const Event& ev, int j,
                                          uint32_t (&b)[L]) {
  if constexpr (L == 3) {
    b[0] = 0u;
    b[1] = j < 32 ? (1u << j) : 0u;
    b[2] = j >= 32 ? (1u << (j - 32)) : 0u;
  } else {
    const int p = ev.s_bits + j;
    b[0] = p < 32 ? (1u << p) : 0u;
    if constexpr (L == 2) b[1] = p >= 32 ? (1u << (p - 32)) : 0u;
  }
}

// Candidate li of an expansion pass: delta row n_old + li / C through
// slot li % C. Returns whether the candidate is live.
template <int L>
struct ExpandCand {
  Event ev;
  Shared<L> s;
  int n_old;
  __device__ __forceinline__ bool operator()(int li, uint32_t (&w)[L]) const {
    const int d = li / ev.C;
    const int j = li - d * ev.C;
    const int n = n_old + d;
    uint32_t r[L], b[L];
    uint32_t already = 0;
    slot_bits<L>(ev, j, b);
#pragma unroll
    for (int k = 0; k < L; ++k) {
      r[k] = (uint32_t)s.f[k][n];
      already |= r[k] & b[k];
    }
    bool ok;
    const int32_t nx = step(ev.step_code, row_state<L>(ev, r), s.fn[j],
                            s.a0[j], s.a1[j], s.wild[j] != 0, &ok);
    if constexpr (L == 3) {
      w[0] = (uint32_t)nx;
    } else {
      w[0] = (r[0] & ~ev.smask) |
             (((uint32_t)nx - (uint32_t)ev.state_lo) & ev.smask) | b[0];
    }
#pragma unroll
    for (int k = 1; k < L; ++k) w[k] = r[k] | b[k];
    return ok && s.occ[j] != 0 && already == 0;
  }
};

// Candidate li of the seed pass: input row li.
template <int L>
struct SeedCand {
  Event ev;
  __device__ __forceinline__ bool operator()(int li, uint32_t (&w)[L]) const {
#pragma unroll
    for (int k = 0; k < L; ++k) w[k] = (uint32_t)ev.in[k][li];
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

// A thread's probe-length histogram (Stats = true): the candidates whose
// probe it saw end, by final offset, each counted `w` times (0 in a
// cluster's blocks other than the leader, for the passes every block
// runs whole); nothing at all when Stats = false.
template <bool Stats>
struct Hist {
  __device__ __forceinline__ void add(int) {}
  __device__ __forceinline__ void weigh(int) {}
};

template <>
struct Hist<true> {
  int n[7] = {0, 0, 0, 0, 0, 0, 0};
  int w = 1;
  __device__ __forceinline__ void add(int off) {
    const int b = (off >= 1) + (off >= 2) + (off >= 4) + (off >= 8) +
                  (off >= 16) + (off >= 32);
#pragma unroll
    for (int i = 0; i < 7; ++i) n[i] += b == i ? w : 0;
  }
  __device__ __forceinline__ void weigh(int v) { w = v; }
};

struct PassOut {
  int n_fresh;
  bool ovf;  // a candidate exhausted its probes
};

// The candidates [lo, hi) of this thread (at most kRegCands, in order),
// built into registers: row, hash, offset 0, kPending when live.
template <int L, class Cand>
__device__ __forceinline__ void build(const Cand& cand, int lo, int hi,
                                      Probe<L> (&c)[kRegCands]) {
#pragma unroll
  for (int k = 0; k < kRegCands; ++k) {
    c[k].fl = 0;
    c[k].off = 0;
    if (lo + k < hi) {
      uint32_t w[L];
      const bool live = cand(lo + k, w);
      set_row(c[k], w);
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
template <int L, bool Stats>
__device__ PassOut probe_append(const Shared<L>& s, const TableView<L>& t,
                                Probe<L> (&c)[kRegCands], int lo, int hi,
                                int count, int N, int probe_limit,
                                Hist<Stats>& hist) {
  // the live candidates (build left them pending), for the histogram
  unsigned attempted = 0;
  if constexpr (Stats) {
#pragma unroll
    for (int k = 0; k < kRegCands; ++k) {
      if (lo + k < hi && (c[k].fl & kPending)) attempted |= 1u << k;
    }
  }
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
  if constexpr (Stats) {
#pragma unroll
    for (int k = 0; k < kRegCands; ++k) {
      if (attempted & (1u << k)) hist.add(c[k].off);
    }
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
      if (pos < N) store_row<L>(s.f, pos, c[k].w);
      ++pos;
    }
  }
  __syncthreads();
  return {sum & 0xFFFF, (sum >> 16) != 0};
}

// The key's cluster: its size and this block's rank (1 and 0 for a
// launch without clusters).
struct Cl {
  int c, rank;
};

// barrier.cluster arrive and wait, split: a block arrives once it has
// set up its shared memory and waits before its first remote access, so
// no block touches another's before that one has started.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A pass of more than kSplitMin candidates on a cluster of c > 1 blocks,
// each holding a copy of the key's frontier and table: the candidates
// are spread over the cluster's c * 512 threads (global thread g = rank
// * 512 + tid holds a contiguous run of at most kRegCands, so thread
// order is candidate order across the cluster) and built from the local
// frontier copy. A round reads the local table copy (phase A), claims an
// empty slot with atomicMin on the leader's claim word, cluster barrier;
// in phase B the lowest claimant writes its row into every block's copy
// and frees the leader's word (a loser re-checks the slot next round),
// and each block ORs "still probing" into every block's act word,
// cluster barrier. The append's places come from a cluster-wide prefix
// (each block's total of fresh rows and pending candidates into every
// block's wtot, one cluster barrier), and each fresh row is written into
// every copy of the frontier, cluster barrier: every block then holds
// the same frontier and table, and the same outcome, as one block
// running the pass whole. `rnd` numbers the split rounds of the launch
// (the act words' parity; both 0 before the first). The caller has
// waited on the cluster barrier every block arrived at once set up.
template <int L, bool Stats, class Cand>
__device__ PassOut split_pass(const Shared<L>& s, const TableView<L>& t,
                              const Cand& cand, int M, int count, int N,
                              int probe_limit, const Cl& cl, int& rnd,
                              Hist<Stats>& hist) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, nt = blockDim.x;
  const int g = cl.rank * nt + tid;
  const int per = (M + cl.c * nt - 1) / (cl.c * nt);
  const int lo = min(M, g * per), hi = min(M, lo + per);
  Probe<L> c[kRegCands];
  build(cand, lo, hi, c);
  unsigned attempted = 0;
  if constexpr (Stats) {
#pragma unroll
    for (int k = 0; k < kRegCands; ++k) {
      if (lo + k < hi && (c[k].fl & kPending)) attempted |= 1u << k;
    }
  }
  int32_t* const claim0 = cluster.map_shared_rank(s.claim, 0);
  int active = 1;
  while (active) {
#pragma unroll
    for (int k = 0; k < kRegCands; ++k) {
      Probe<L>& p = c[k];
      if (lo + k >= hi || !(p.fl & kPending) || p.off >= probe_limit) {
        continue;
      }
      const int slot = (int)((p.h + (uint32_t)p.off) & t.mask);
      if (t.occ[slot]) {
        if (row_equal<PlainLoads>(t, slot, p.w)) {
          p.fl = 0;  // already visited
        } else {
          p.off += 1;
        }
      } else {
        atomicMin(&claim0[slot], lo + k);
        p.fl = kPending | kTry;
      }
    }
    cluster.sync();
    int local = 0;
#pragma unroll
    for (int k = 0; k < kRegCands; ++k) {
      Probe<L>& p = c[k];
      if (lo + k >= hi) continue;
      if (p.fl & kTry) {
        const int slot = (int)((p.h + (uint32_t)p.off) & t.mask);
        if (claim0[slot] == lo + k) {
          for (int b = 0; b < cl.c; ++b) {
#pragma unroll
            for (int q = 0; q < L; ++q) {
              cluster.map_shared_rank(s.t[q], b)[slot] = (int32_t)p.w[q];
            }
            cluster.map_shared_rank(s.tocc, b)[slot] = 1;
          }
          claim0[slot] = kClaimFree;
          p.fl = kFresh;
        } else {
          p.fl = kPending;
        }
      }
      local |= (p.fl & kPending) && p.off < probe_limit;
    }
    // the other parity's word was last read before the barrier above;
    // it is written next only after the barrier below
    const int q = rnd & 1;
    if (tid == 0) s.act[q ^ 1] = 0;
    if (__syncthreads_or(local) && tid < cl.c) {
      atomicOr(cluster.map_shared_rank(&s.act[q], tid), 1);
    }
    cluster.sync();
    active = *(volatile int32_t*)&s.act[q];
    ++rnd;
  }
  if constexpr (Stats) {
#pragma unroll
    for (int k = 0; k < kRegCands; ++k) {
      if (attempted & (1u << k)) hist.add(c[k].off);
    }
  }
  // the append: this block's fresh rows and pending threads, then the
  // cluster's prefix of the block totals
  int n_mine = 0, pend = 0;
#pragma unroll
  for (int k = 0; k < kRegCands; ++k) {
    n_mine += (c[k].fl & kFresh) != 0;
    pend |= (c[k].fl & kPending) != 0;
  }
  int sum;
  const int mine = scan_one_barrier(n_mine | (pend << 16), s.scan, &sum);
  if (tid < cl.c) *cluster.map_shared_rank(&s.wtot[cl.rank], tid) = sum;
  cluster.sync();
  int before = 0, all = 0;
  for (int b = 0; b < cl.c; ++b) {
    const int v = s.wtot[b];
    before += b < cl.rank ? (v & 0xFFFF) : 0;
    all += v;
  }
  int pos = count + before + (mine & 0xFFFF);
#pragma unroll
  for (int k = 0; k < kRegCands; ++k) {
    if (c[k].fl & kFresh) {
      if (pos < N) {
        for (int b = 0; b < cl.c; ++b) {
#pragma unroll
          for (int q = 0; q < L; ++q) {
            cluster.map_shared_rank(s.f[q], b)[pos] = (int32_t)c[k].w[q];
          }
        }
      }
      ++pos;
    }
  }
  // every copy of the frontier complete before any block reads it
  cluster.sync();
  return {all & 0xFFFF, (all >> 16) != 0};
}

// A pass of at most 32 candidates in warp 0 alone: lane li builds
// candidate li; rounds separated by __syncwarp, a claim won by the lowest
// lane trying the slot (__match_any_sync: lanes are in candidate order,
// so that is the lowest index), no claim words; the append's places from
// a ballot. The outcome reaches the block through bc[0..1] and one
// barrier.
template <int L, bool Stats, class Cand>
__device__ PassOut warp_pass(const Shared<L>& s, const TableView<L>& t,
                             const Cand& cand, int M, int count, int N,
                             int probe_limit, int* bc, Hist<Stats>& hist) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    Probe<L> p{};
    bool attempted = false;
    if (lane < M) {
      uint32_t w[L];
      const bool live = cand(lane, w);
      set_row(p, w);
      p.fl = live ? kPending : 0;
      attempted = live;
    }
    while (true) {
      const bool act = (p.fl & kPending) && p.off < probe_limit;
      if (!__any_sync(0xffffffffu, act)) break;
      int slot = -1;
      bool occ = false, same = false;
      if (act) {
        slot = (int)((p.h + (uint32_t)p.off) & t.mask);
        occ = t.occ[slot] != 0;
        same = occ && row_equal<PlainLoads>(t, slot, p.w);
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
          store_row<L>(t.lane, slot, p.w);
          t.occ[slot] = 1;
          p.fl = kFresh;
        }
      }
      __syncwarp();  // the round's writes before the next round's reads
    }
    if constexpr (Stats) {
      if (attempted) hist.add(p.off);
    }
    const unsigned fresh = __ballot_sync(0xffffffffu, p.fl & kFresh);
    const unsigned pend = __ballot_sync(0xffffffffu, p.fl & kPending);
    if (p.fl & kFresh) {
      const int pos = count + __popc(fresh & lanemask_lt());
      if (pos < N) store_row<L>(s.f, pos, p.w);
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
//
// On a cluster of c > 1 blocks a pass of more than kSplitMin candidates
// that the cluster's registers hold is split over it (split_pass); every
// other pass runs whole in each block, on its own copy of the frontier
// and table, which it leaves as every other block's (the same
// transaction on the same state), and counts in the stats of the leader
// (rank 0) alone: the others weigh them 0. `waited`: this thread has
// waited on the cluster barrier it arrived at once set up (before the
// first remote access of a split pass).
template <int L, bool Stats, bool Split, class Cand>
__device__ PassOut k2_pass(const Event& ev, const Shared<L>& s,
                           const Cand& cand, int M, int count, int pass,
                           const Cl& cl, int& rnd, bool& waited,
                           Hist<Stats>& hist) {
  const int tid = threadIdx.x, nt = blockDim.x;
  TableView<L> t;
#pragma unroll
  for (int k = 0; k < L; ++k) t.lane[k] = s.t[k];
  t.claim = s.claim;
  t.occ = s.tocc;
  t.mask = (uint32_t)(ev.T - 1);
  if (Split && M > kSplitMin && M <= cl.c * nt * kRegCands) {
    if (!waited) {
      cluster_wait();
      waited = true;
    }
    hist.weigh(1);
    return split_pass(s, t, cand, M, count, ev.N, ev.probe_limit, cl, rnd,
                      hist);
  }
  hist.weigh(!Split || cl.rank == 0 ? 1 : 0);
  if (M <= 32) {
    return warp_pass(s, t, cand, M, count, ev.N, ev.probe_limit,
                     s.scan + 32 + 2 * (pass & 1), hist);
  }
  if (M > nt * kRegCands) {
    bool probe_ovf;
    const int n_fresh = insert_pass(cand, t, s.off, s.flags, s.scan, M,
                                    ev.probe_limit, s.f, count, ev.N,
                                    &probe_ovf);
    if constexpr (Stats) {
      // every candidate's final offset and flags are still in s.off and
      // s.flags (this thread's own li, as in insert_pass); a candidate
      // that moved or ended pending or fresh was live, and one at offset
      // 0 with no flag is rebuilt to tell a duplicate from a dead one
      for (int li = tid; li < M; li += nt) {
        const int o = s.off[li];
        bool live = o > 0 || s.flags[li] != 0;
        if (!live) {
          uint32_t w[L];
          live = cand(li, w);
        }
        if (live) hist.add(o);
      }
    }
    return {n_fresh, probe_ovf};
  }
  const int per = (M + nt - 1) / nt;
  const int lo = min(M, tid * per), hi = min(M, lo + per);
  Probe<L> c[kRegCands];
  build(cand, lo, hi, c);
  return probe_append(s, t, c, lo, hi, count, ev.N, ev.probe_limit, hist);
}

struct OutLanes {
  int32_t* p[3];
};

// Key `key` of a launch over K keys (block `key`, or with Split the
// cluster of blocks [key * c, (key + 1) * c)): its event's slot tables
// (event row `row`) start at (key * R + row) * C, its rows and outputs at
// key * N, its run flag at key, its meta at key * 4 and (Stats) its stats
// at key * 8. With Split every block of the cluster keeps a copy of the
// key's frontier and table (k2_pass); the leader (rank 0) writes the
// outputs.
template <int L, bool Stats, bool Split>
__global__ void __launch_bounds__(kThreads, 1)
frontier_closure_kernel(Event ev, const int32_t* __restrict__ f,
                        const int32_t* __restrict__ a0,
                        const int32_t* __restrict__ a1,
                        const uint8_t* __restrict__ wild,
                        const uint8_t* __restrict__ occ, int row, int R,
                        const uint8_t* __restrict__ run, OutLanes out,
                        int32_t* meta, int32_t* stats) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int N = ev.N, T = ev.T, C = ev.C;
  Cl cl{1, 0};
  if constexpr (Split) {
    cl.c = (int)cooperative_groups::this_cluster().num_blocks();
    cl.rank = (int)cooperative_groups::this_cluster().block_rank();
  }
  const int key = (int)blockIdx.x / cl.c;
  if (key != 0 || row != 0) {  // one key's event (K = R = 1) is in place
    const size_t at = ((size_t)key * R + row) * C, rows = (size_t)key * N;
    f += at;
    a0 += at;
    a1 += at;
    wild += at;
    occ += at;
#pragma unroll
    for (int k = 0; k < L; ++k) {
      ev.in[k] += rows;
      out.p[k] += rows;
    }
    ev.live_in += rows;
    run += key;
    meta += 4 * (size_t)key;
    if constexpr (Stats) stats += 8 * (size_t)key;
  }

  if (*run == 0) {
    // the history already failed or overflowed: an empty result, which
    // the scan discards (uniform branch over the cluster, no barrier)
    if (cl.rank != 0) return;
    for (int i = tid; i < N; i += nt) {
#pragma unroll
      for (int k = 0; k < L; ++k) out.p[k][i] = 0;
    }
    if (tid < 4) meta[tid] = 0;
    if constexpr (Stats) {
      if (tid < 8) stats[tid] = 0;
    }
    return;
  }

  Shared<L> s;
  int32_t* w = reinterpret_cast<int32_t*>(smem);
#pragma unroll
  for (int k = 0; k < L; ++k) {
    s.f[k] = w;
    w += N;
  }
#pragma unroll
  for (int k = 0; k < L; ++k) {
    s.t[k] = w;
    w += T;
  }
  s.claim = w; w += T;
  s.fn = w; w += kMaxC;
  s.a0 = w; w += kMaxC;
  s.a1 = w; w += kMaxC;
  s.scan = w; w += 40;
  s.act = s.scan + 36;
  uint8_t* b = reinterpret_cast<uint8_t*>(w);
  s.wtot = reinterpret_cast<int32_t*>(b);
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
  Probe<L> seed[kRegCands];
  if (seed_regs) build(SeedCand<L>{ev}, s_lo, s_hi, seed);
  for (int i = tid; i < T; i += nt) {
    s.tocc[i] = 0;
    s.claim[i] = kClaimFree;
  }
  for (int j = tid; j < C; j += nt) {
    s.fn[j] = f[j];
    s.a0[j] = a0[j];
    s.a1[j] = a1[j];
    s.wild[j] = wild[j];
    s.occ[j] = occ[j];
  }
  if (tid < 2) s.act[tid] = 0;
  __syncthreads();
  bool waited = !Split;
  if constexpr (Split) cluster_arrive();

  int pass = 0, rnd = 0;
  Hist<Stats> hist;
  TableView<L> tv;
#pragma unroll
  for (int k = 0; k < L; ++k) tv.lane[k] = s.t[k];
  tv.claim = s.claim;
  tv.occ = s.tocc;
  tv.mask = (uint32_t)(T - 1);
  PassOut r = seed_regs
      ? (hist.weigh(!Split || cl.rank == 0 ? 1 : 0),
         probe_append(s, tv, seed, s_lo, s_hi, 0, N, ev.probe_limit, hist))
      : k2_pass<L, Stats, Split>(ev, s, SeedCand<L>{ev}, N, 0, pass, cl,
                                 rnd, waited, hist);
  ++pass;
  int count = min(r.n_fresh, N);
  bool ovf = r.ovf || r.n_fresh > N;
  int n_old = 0, iters = 0, stepped = 0, swork = 0;
  bool changed = true;
  while (changed && !ovf) {
    r = k2_pass<L, Stats, Split>(ev, s, ExpandCand<L>{ev, s, n_old},
                                 (count - n_old) * C, count, pass++, cl,
                                 rnd, waited, hist);
    stepped += count - n_old;
    if constexpr (Stats) swork += count;
    ovf = ovf || r.ovf || count + r.n_fresh > N;
    n_old = count;
    count = min(count + r.n_fresh, N);
    ++iters;
    changed = r.n_fresh > 0;
  }

  // every block of the cluster holds the same frontier and counts
  if (!waited) cluster_wait();
  if (cl.rank == 0) {
    for (int i = tid; i < N; i += nt) {
      const bool in = i < count;
#pragma unroll
      for (int k = 0; k < L; ++k) out.p[k][i] = in ? s.f[k][i] : 0;
    }
    if (tid == 0) {
      meta[0] = count;
      meta[1] = ovf ? 1 : 0;
      meta[2] = iters;
      meta[3] = stepped;
    }
  }
  if constexpr (Stats) {
    // the last pass ended with a barrier, after which no thread reads the
    // scan words again: they hold the cluster's seven sums, in the
    // leader's (each block adds its split passes' counts there)
    if (tid < 7) s.scan[tid] = 0;
    if constexpr (Split) {
      cooperative_groups::this_cluster().sync();
    } else {
      __syncthreads();
    }
    int* sums = s.scan;
    if constexpr (Split) {
      sums = cooperative_groups::this_cluster().map_shared_rank(s.scan, 0);
    }
#pragma unroll
    for (int b = 0; b < 7; ++b) {
      const int v = __reduce_add_sync(0xffffffffu, hist.n[b]);
      if ((tid & 31) == 0 && v != 0) atomicAdd(&sums[b], v);
    }
    if constexpr (Split) {
      cooperative_groups::this_cluster().sync();
    } else {
      __syncthreads();
    }
    if (cl.rank == 0 && tid == 0) {
      stats[0] = swork;
#pragma unroll
      for (int b = 0; b < 7; ++b) stats[1 + b] = s.scan[b];
    }
  }
}

template <int L, bool Stats, bool Split>
cudaError_t allow_optin(int optin) {
  return cudaFuncSetAttribute(
      (const void*)frontier_closure_kernel<L, Stats, Split>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
}

cudaLaunchConfig_t cluster_config(int c, int K, size_t smem,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c * K);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The largest cluster (8, 4, 2; else 1) of the Split kernel at (L,
// Stats) the card runs at the block's whole opt-in.
template <int L, bool Stats>
cudaError_t find_max_cluster(int optin, int* best) {
  cudaError_t err = allow_optin<L, Stats, false>(optin);
  if (err == cudaSuccess) err = allow_optin<L, Stats, true>(optin);
  if (err != cudaSuccess) return err;
  *best = 1;
  for (int c = kMaxCluster; c >= 2 && *best == 1; c /= 2) {
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = cluster_config(c, 1, optin, 0, &attr);
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(
            &n, frontier_closure_kernel<L, Stats, true>, &cfg) ==
            cudaSuccess &&
        n > 0) {
      *best = c;
    }
  }
  (void)cudaGetLastError();  // a refused probe leaves no sticky error
  return cudaSuccess;
}

template <int L, bool Stats, bool Split>
cudaError_t launch_one(int K, int c, size_t smem, cudaStream_t s,
                       const Event& ev, const int32_t* f, const int32_t* a0,
                       const int32_t* a1, const uint8_t* wild,
                       const uint8_t* occ, int r, int R, const uint8_t* run,
                       const OutLanes& out, int32_t* meta, int32_t* stats) {
  if constexpr (!Split) {
    frontier_closure_kernel<L, Stats, false><<<K, kThreads, smem, s>>>(
        ev, f, a0, a1, wild, occ, r, R, run, out, meta, stats);
    return cudaGetLastError();
  } else {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(c, K, smem, s, &attr);
    return cudaLaunchKernelEx(&cfg, frontier_closure_kernel<L, Stats, true>,
                              ev, f, a0, a1, wild, occ, r, R, run, out,
                              meta, stats);
  }
}

template <int L>
cudaError_t launch_lanes(int K, int c, size_t smem, cudaStream_t s,
                         const Event& ev, const int32_t* f,
                         const int32_t* a0, const int32_t* a1,
                         const uint8_t* wild, const uint8_t* occ, int r,
                         int R, const uint8_t* run, const OutLanes& out,
                         int32_t* meta, int32_t* stats) {
  if (stats != nullptr) {
    return c > 1 ? launch_one<L, true, true>(K, c, smem, s, ev, f, a0, a1,
                                             wild, occ, r, R, run, out,
                                             meta, stats)
                 : launch_one<L, true, false>(K, c, smem, s, ev, f, a0, a1,
                                              wild, occ, r, R, run, out,
                                              meta, stats);
  }
  return c > 1 ? launch_one<L, false, true>(K, c, smem, s, ev, f, a0, a1,
                                            wild, occ, r, R, run, out, meta,
                                            stats)
               : launch_one<L, false, false>(K, c, smem, s, ev, f, a0, a1,
                                             wild, occ, r, R, run, out, meta,
                                             stats);
}

}  // namespace

extern "C" {

// Once per device, before the first launch there: lets the kernel (each
// of its instantiations) use the block's whole shared-memory opt-in, and
// finds the largest cluster each runs at it (jt_frontier_closure_max_
// cluster). Returns that opt-in in bytes (the caller gates shapes by
// it), or minus the cudaError_t.
int jt_frontier_closure_init(void) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev >= kMaxDevices) err = cudaErrorInvalidDevice;
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  int* best = g_max_cluster[dev < kMaxDevices ? dev : 0];
  if (err == cudaSuccess) err = find_max_cluster<1, false>(optin, &best[0]);
  if (err == cudaSuccess) err = find_max_cluster<1, true>(optin, &best[1]);
  if (err == cudaSuccess) err = find_max_cluster<2, false>(optin, &best[2]);
  if (err == cudaSuccess) err = find_max_cluster<2, true>(optin, &best[3]);
  if (err == cudaSuccess) err = find_max_cluster<3, false>(optin, &best[4]);
  if (err == cudaSuccess) err = find_max_cluster<3, true>(optin, &best[5]);
  return err == cudaSuccess ? optin : -(int)err;
}

// The largest cluster jt_frontier_closure_init found on the current
// device for rows of `lanes` lanes, with stats outputs or without (0
// before it ran there).
int jt_frontier_closure_max_cluster(int lanes, int stats) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices ||
      lanes < 1 || lanes > 3) {
    return 0;
  }
  return g_max_cluster[dev][2 * (lanes - 1) + (stats != 0)];
}

// The kernel's dynamic shared memory at (N, C) with rows of `lanes`
// lanes, in bytes: the layout the caller's gate
// (sparse_kernels.k2_smem_bytes) must agree with.
long long jt_frontier_closure_smem(int N, int C, int lanes) {
  return (long long)smem_bytes(N, C, lanes);
}

// One event row's closures of K keys on `stream`, a cluster of `cluster`
// blocks a key (1: a block a key; at most what jt_frontier_closure_max_
// cluster says). Slot tables f/a0/a1/wild/occ are the batch's [K, R, C]
// (row r is read), rows (in0..in2) and live [K, N], run [K] bytes, the
// output rows (out0..out2) [K, N], meta [K, 4]; one key's event is K = R
// = 1, r = 0. `stats` null runs the stats-off kernel; else it receives
// [K, 8] (swork, then the probe-length histogram) from the Stats
// instantiation. Rows have `lanes` lanes (the pointers past them are
// unused, null): 3 for the triple, 1 or 2 for the packed word of s_bits
// state bits and state state_lo at field 0 (s_bits + C <= 32 * lanes).
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for a
// shape the kernel does not take).
int jt_frontier_closure_launch(int step_code, const int32_t* f,
                               const int32_t* a0, const int32_t* a1,
                               const uint8_t* wild, const uint8_t* occ, int r,
                               int R, const int32_t* in0, const int32_t* in1,
                               const int32_t* in2, const uint8_t* live_in,
                               const uint8_t* run, int32_t* out0,
                               int32_t* out1, int32_t* out2, int32_t* meta,
                               int32_t* stats, int K, int N, int C,
                               int probe_limit, int cluster,
                               int lanes, int s_bits, int state_lo,
                               void* stream) {
  const bool packed_ok = lanes == 3 || (lanes >= 1 && lanes <= 2 &&
                                        s_bits >= 1 && s_bits <= 32 &&
                                        s_bits + C <= 32 * lanes);
  if (K < 1 || R < 1 || r < 0 || r >= R || N < 1 || C < 1 || C > kMaxC ||
      probe_limit < 1 || probe_limit > 255 || step_code < kRegister ||
      step_code > kFifo || !packed_ok || cluster < 1 ||
      cluster > kMaxCluster || (long long)cluster * K >= 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const uint32_t smask =
      lanes == 3 ? 0u : (s_bits >= 32 ? 0xFFFFFFFFu : (1u << s_bits) - 1u);
  Event ev{step_code, N, C, table_size(N), probe_limit, s_bits, state_lo,
           smask, {in0, in1, in2}, live_in};
  const OutLanes out{{out0, out1, out2}};
  const size_t smem = smem_bytes(N, C, lanes);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (lanes) {
    case 1:
      err = launch_lanes<1>(K, cluster, smem, s, ev, f, a0, a1, wild, occ,
                            r, R, run, out, meta, stats);
      break;
    case 2:
      err = launch_lanes<2>(K, cluster, smem, s, ev, f, a0, a1, wild, occ,
                            r, R, run, out, meta, stats);
      break;
    default:
      err = launch_lanes<3>(K, cluster, smem, s, ev, f, a0, a1, wild, occ,
                            r, R, run, out, meta, stats);
  }
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
