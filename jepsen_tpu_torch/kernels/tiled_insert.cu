// K4: the probe/claim half of the sparse engine's visited-set
// transaction past K2's gate, batched over keys, for Hopper.
//
// Replaces jepsen_tpu/parallel/sparse_kernels.py::tiled_insert_call (the
// Pallas TPU kernel the sparse engine takes past the whole-event closure's
// memory gate, batched over a tier's keys under the reference's vmap). For
// each of K keys, M candidate rows with live flags go into the key's own
// open-addressed table of T slots. A row is L int32 lanes: the triple
// (state, mask_lo, mask_hi), L = 3, or the packed word of config_pack,
// L = 1 or 2; the kernels are templates on L, the hash the lane count's
// (sparse_common.cuh table_hash). It computes
// what jepsen_tpu_torch.parallel.sparse_kernels.tiled_insert_reference
// computes, bit for bit: key by key, the reference's visited-set
// transaction over the whole table (engine._hash_insert, the closure's
// default):
//
//   probe   every live candidate probes slots (table_hash + off) & (T-1),
//           off = 0, 1, ... < probe_limit, round-synchronously: an equal
//           occupant drops it, a different one advances it, an empty
//           slot is claimed, the lowest candidate index winning a race;
//           the losers re-check the slot next round;
//   out     the tables (updated in place), fresh [K, M] (claimed a
//           slot), off [K, M] (final probe offset, 0 for dead
//           candidates) and a flag a key, set when one of its candidates
//           exhausted its probes.
//
// The append of the fresh rows and the expansion around it stay PyTorch
// ops (sparse_kernels.tiled_event_closure), as the reference keeps them
// in XLA.
//
// Why one table and no tiles. The TPU kernel streams the table through
// VMEM in hash-range tiles, a candidate's probes wrapping inside its home
// tile. That lays rows out otherwise than one table and can exhaust a
// probe run where one table does not, so `capacity` would differ from the
// reference's default route, to which the port's results are held. The
// H100 keeps the whole table in device memory, read through L2, so K4 runs
// the one-table transaction.
//
// Where the time went (the sparse batch's recorded inputs, PERF.md): a
// launch of K12 T32768 spent 10 us listing the live candidates and 57 us
// in the grid's rounds, as many as the worst key's probe run (up to 33),
// each two barriers across the whole grid, though after the first few
// rounds only a few hundred candidates still probe. A thread-block
// cluster a key instead was 3-4x slower: a key with tens of thousands of
// live candidates has only its cluster's few SMs for them.
//
// Design: three launches on the stream, as K3's device layout:
//   1. prep (one block of 256 threads per 4,096 of the K*M candidates):
//      counts the live flags of its chunk (sparse_common.cuh's live
//      list) and, grid-stride, zeroes fresh and off, frees every claim
//      word and clears the keys' flags;
//   2. compact (same grid): writes the indices of the live candidates of
//      every key, in order (key-major), after those of the chunks before
//      it;
//   3. insert: a cooperative grid of every block the card keeps resident
//      (blocks per SM x SMs, read once per device by
//      jt_tiled_insert_init) over the list. Each block owns a contiguous
//      range of it, and each candidate probes its own key's table (key =
//      index / M, k * T slots in; its claim words k * T words into the
//      scratch). The claim words take the list index: a key's candidates
//      keep their order in the list and only they claim its slots, so
//      the lowest index wins each race as in one key's transaction, and
//      what key k gets is what one key's launch on its own candidates and
//      table gives.
//      a. While more than kLocal (1,024) candidates still probe, the
//         grid runs round-synchronous rounds (sparse_common.cuh's probe
//         phases, two grid barriers a round, a grid-wide count of those
//         still probing after the second).
//      b. Then the candidates still probing go to one list with their
//         offsets, the others write their outcome, and block 0 alone
//         runs the rest of the rounds with block barriers, a candidate a
//         thread. A round runs only where a candidate is due: slots are
//         never emptied and rows never change within a transaction, so a
//         candidate that reads occupied slots holding other rows ahead
//         of it would walk past them in the next rounds whatever else
//         happens; it reads a window of them at once (1 slot, doubling
//         while it walks, at most kWindowMax), moves its offset past them
//         and is due again in the round the reference reaches the first
//         slot it has not read. Every claim still happens in the round
//         the reference makes it, against the same rivals, so the
//         tables, fresh, off and the flags are the reference's; the
//         block's clock jumps to the earliest round a candidate is due.
//      Each candidate writes its fresh flag and offset, and one that
//      exhausted its probes sets its key's flag.
// One key is K = 1.
//
// What bounds it: bytes. The least it must move is every live flag,
// fresh and off once, the live candidates' rows and the table slots
// they probe and write; a few dozen integer operations a live candidate.
// chip_smoke.py measures both against the bound on the card; PERF.md
// keeps the numbers.
//
// Build: nvcc -gencode=arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC tiled_insert.cu   (see kernels/__init__.py)

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "sparse_common.cuh"

namespace {

using namespace jt;

constexpr int kGridThreads = 1024;  // each block of the insert's grid
constexpr int kScanWords = 40;
// candidates still probing that one block takes over from the grid
constexpr int kLocal = kGridThreads;
constexpr int kWindowMax = 8;  // slots a due candidate reads at once
constexpr int kNoWake = INT_MAX;

size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

struct Scratch {
  int32_t* counts;       // [list_chunks(K*M)] live flags per chunk
  int32_t* idx;          // [K*M] the live candidates' indices, in order
  int32_t* claim;        // [K*T] claim words
  int32_t* gflags;       // [4] candidates still probing (by round
                         // parity), the hand-off list's length, spare
  int32_t* hand;         // [kLocal] the hand-off list
  uint8_t *off, *flags;  // [K*M] per live candidate
  size_t bytes;
};

Scratch carve(void* base, int KM, size_t KT) {
  char* p = reinterpret_cast<char*>(base);
  Scratch s;
  size_t o = 0;
  s.counts = reinterpret_cast<int32_t*>(p + o);
  o = align16(o + 4 * (size_t)list_chunks(KM));
  s.idx = reinterpret_cast<int32_t*>(p + o);
  o = align16(o + 4 * (size_t)KM);
  s.claim = reinterpret_cast<int32_t*>(p + o);
  o = align16(o + 4 * KT);
  s.gflags = reinterpret_cast<int32_t*>(p + o);
  o = align16(o + 4 * 4);
  s.hand = reinterpret_cast<int32_t*>(p + o);
  o = align16(o + 4 * (size_t)kLocal);
  s.off = reinterpret_cast<uint8_t*>(p + o);
  o = align16(o + (size_t)KM);
  s.flags = reinterpret_cast<uint8_t*>(p + o);
  o = align16(o + (size_t)KM);
  s.bytes = o;
  return s;
}

struct Args {
  const int32_t* c[3];  // candidate lanes [K, M]; a row of L uses L
  const uint8_t* c_live;
  int M, K, KM, T;  // candidates a key, keys, K * M, slots a table
  size_t KT;        // K * T
  int32_t* t[3];    // table lanes [K, T]
  uint8_t* t_occ;
  uint8_t* fresh;
  int32_t* off_out;
  uint8_t* pend_out;
  Scratch sc;
  int probe_limit;
};

__global__ void __launch_bounds__(kListThreads)
k4_prep(Args a) {
  __shared__ int scan[kScanWords];
  list_count(a.c_live, a.KM, a.sc.counts, scan);
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t first = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (size_t i = first; i < (size_t)a.KM; i += stride) {
    a.fresh[i] = 0;
    a.off_out[i] = 0;
  }
  for (size_t i = first; i < a.KT; i += stride) a.sc.claim[i] = kClaimFree;
  for (size_t i = first; i < (size_t)a.K; i += stride) a.pend_out[i] = 0;
}

__global__ void __launch_bounds__(kListThreads)
k4_compact(Args a) {
  __shared__ int scan[kScanWords];
  list_compact(a.c_live, a.KM, a.sc.counts, a.sc.idx, scan);
}

// The table listed candidate li probes: its key's, idx[li] / M, whose
// slots and claim words lie key * T further than key 0's.
template <int L>
struct KeyTable {
  TableView<L> t;  // key 0's
  const int32_t* idx;
  int M;
  size_t T;
  __device__ __forceinline__ TableView<L> operator()(int li) const {
    return t.at((size_t)(idx[li] / M) * T);
  }
};

// The earliest of the block's values v (kNoWake: none); every thread
// calls it and gets it. `words` is 2 ints of shared memory, both
// kNoWake before the first call; `parity` alternates them, so that a
// call's word is reset only after every thread has read it.
__device__ __forceinline__ int block_min(int v, int* words, int& parity) {
  const int p = parity;
  parity ^= 1;
  if (threadIdx.x == 0) words[p ^ 1] = kNoWake;
  const int m = __reduce_min_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0 && m != kNoWake) atomicMin(&words[p], m);
  __syncthreads();
  return words[p];
}

// One handed-off candidate of the block's rounds: its probe state, the
// round it probes next and the slots it reads then.
template <int L>
struct Local {
  Probe<L> p;
  int wake, win;
};

// Phase A of a block round for candidate li due this round: read `win`
// slots from its offset (occupancy, then the rows of the occupied ones)
// and walk past those holding other rows. Slots are never emptied and
// rows never change in a transaction, so the reference's candidate
// walks past the same slots in the next rounds whatever else happens;
// this one jumps there at once and is due again in the round the
// reference reaches the first slot it has not read (its window doubling
// while it walks, at most kWindowMax). Then, as the reference: an equal
// row drops it, probe_limit exhausts it, an empty slot this round takes
// an atomicMin of li.
template <int L>
__device__ __forceinline__ void window_probe(Local<L>& c,
                                             const TableView<L>& t, int li,
                                             int round, int probe_limit) {
  Probe<L>& p = c.p;
  const int span = min(c.win, probe_limit - p.off);
  uint8_t occ[kWindowMax];
  bool eq[kWindowMax];
#pragma unroll
  for (int j = 0; j < kWindowMax; ++j) {
    occ[j] = j < span
        ? __ldcg(&t.occ[(p.h + (uint32_t)(p.off + j)) & t.mask]) : 0;
  }
#pragma unroll
  for (int j = 0; j < kWindowMax; ++j) {
    eq[j] = occ[j] &&
            row_equal<L2Loads>(
                t, (int)((p.h + (uint32_t)(p.off + j)) & t.mask), p.w);
  }
  int j = 0;
  while (j < span && occ[j] && !eq[j]) ++j;
  p.off += j;
  if (j == span) {
    // every slot read holds another row: exhausted, or walk on
    if (p.off < probe_limit) {
      c.wake = round + j;
      c.win = min(2 * c.win, kWindowMax);
    }
  } else if (eq[j]) {
    p.fl = 0;  // already visited
  } else if (j == 0) {
    atomicMin(&t.claim[(p.h + (uint32_t)p.off) & t.mask], li);
    p.fl = kPending | kTry;
  } else {
    c.wake = round + j;
  }
}

// Each listed candidate's outcome: its fresh flag and final offset; one
// that exhausted its probes flags its key.
__device__ __forceinline__ void outcome(const Args& a, int i, uint8_t fl,
                                        int off) {
  a.fresh[i] = (fl & kFresh) ? 1 : 0;
  a.off_out[i] = off;
  if (fl & kPending) a.pend_out[i / a.M] = 1;
}

// The transaction of every key's listed candidates: while more than
// kLocal still probe, round-synchronous rounds over the cooperative grid
// (sparse_common.cuh's phases, two grid barriers a round, the count of
// candidates still probing read after the second); then the ones left
// go to one list and block 0 runs their rounds alone, with block
// barriers, a round only where a candidate is due (block_min of the
// rounds they are due: rounds in which every one walks past occupied
// slots are skipped, window_probe). Claims take the list index, whose
// order is each key's candidates' order, so the lowest index wins a race
// as in one key's transaction, on either side of the hand-off.
template <int L>
__global__ void __launch_bounds__(kGridThreads)
k4_grid_insert(Args a) {
  namespace cg = cooperative_groups;
  cg::grid_group grid = cg::this_grid();
  __shared__ int scan[kScanWords];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n_live = list_total(a.sc.counts, a.KM, scan);
  const GridSpan s = grid_span(n_live);
  ListCand<L> cand;
  KeyTable<L> tables;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    cand.lane[k] = a.c[k];
    tables.t.lane[k] = a.t[k];
  }
  cand.idx = a.sc.idx;
  tables.t.claim = a.sc.claim;
  tables.t.occ = a.t_occ;
  tables.t.mask = (uint32_t)(a.T - 1);
  tables.idx = a.sc.idx;
  tables.M = a.M;
  tables.T = (size_t)a.T;
  const int pl = a.probe_limit;
  int* const probing_at = a.sc.gflags;  // [2], by round parity
  int* const n_hand = a.sc.gflags + 2;

  // 1. grid rounds while more than kLocal candidates probe
  Probe<L> p;
  p.off = 0;
  p.fl = 0;
  TableView<L> tv{};  // the table of this thread's register candidate
  if (s.in_regs) {
    if (s.my < s.hi) {
      uint32_t w[L];
      cand(s.my, w);
      set_row(p, w);
      p.fl = kPending;  // every listed candidate is live
      tv = tables(s.my);
    }
  } else {
    for (int li = s.lo + tid; li < s.hi; li += nt) {
      a.sc.flags[li] = kPending;
      a.sc.off[li] = 0;
    }
  }
  if (blockIdx.x == 0 && tid == 0) {
    probing_at[0] = probing_at[1] = 0;
    *n_hand = 0;
  }
  grid.sync();
  int round = 0;
  for (int probing = n_live; probing > kLocal; ++round) {
    if (s.in_regs) {
      probe_a<L2Loads>(p, tv, s.my, pl);
    } else {
      for (int li = s.lo + tid; li < s.hi; li += nt) {
        probe_read<L2Loads>(cand, tables(li), a.sc.off, a.sc.flags, li, pl);
      }
    }
    grid.sync();
    int mine = 0;
    if (s.in_regs) {
      mine = probe_b<L2Loads>(p, tv, s.my, pl);
    } else {
      for (int li = s.lo + tid; li < s.hi; li += nt) {
        mine += claim_settle<L2Loads>(cand, tables(li), a.sc.off,
                                      a.sc.flags, li, pl);
      }
    }
    // the other parity's count was last read before the barrier above;
    // it is added to again only after the barrier below
    if (blockIdx.x == 0 && tid == 0) probing_at[(round + 1) & 1] = 0;
    int total;
    block_exclusive_scan(mine, scan, &total);
    if (tid == 0 && total) atomicAdd(&probing_at[round & 1], total);
    grid.sync();
    probing = __ldcg(&probing_at[round & 1]);
  }

  // 2. the hand-off: the candidates still probing go to one list, with
  // their offsets; the others write their outcome
  if (s.in_regs) {
    if (s.my < s.hi) {
      if ((p.fl & kPending) && p.off < pl) {
        a.sc.hand[atomicAdd(n_hand, 1)] = s.my;
        a.sc.off[s.my] = (uint8_t)p.off;
      } else {
        outcome(a, a.sc.idx[s.my], p.fl, p.off);
      }
    }
  } else {
    for (int li = s.lo + tid; li < s.hi; li += nt) {
      const uint8_t fl = a.sc.flags[li];
      if ((fl & kPending) && a.sc.off[li] < pl) {
        a.sc.hand[atomicAdd(n_hand, 1)] = li;
      } else {
        outcome(a, a.sc.idx[li], fl, a.sc.off[li]);
      }
    }
  }
  grid.sync();
  if (blockIdx.x != 0) return;

  // 3. block 0: the rounds of the candidates handed off, thread t the
  // t-th of them
  const int n = __ldcg(n_hand);
  int* const mins = scan + 32;
  if (tid < 2) mins[tid] = kNoWake;
  Local<L> c;
  c.p.fl = 0;
  c.p.off = 0;
  c.wake = round;
  c.win = 1;
  int li = 0;
  TableView<L> ct{};
  if (tid < n) {
    li = __ldcg(&a.sc.hand[tid]);
    uint32_t w[L];
    cand(li, w);
    set_row(c.p, w);
    c.p.off = __ldcg(&a.sc.off[li]);
    c.p.fl = kPending;
    ct = tables(li);
  }
  __syncthreads();
  int parity = 0;
  int due = tid < n ? round : kNoWake;
  for (;;) {
    const int r = block_min(due, mins, parity);
    if (r == kNoWake) break;
    if ((c.p.fl & kPending) && c.p.off < pl && c.wake == r) {
      window_probe<L>(c, ct, li, r, pl);
    }
    __syncthreads();
    if (c.p.fl & kTry) {
      const int slot = (int)((c.p.h + (uint32_t)c.p.off) & ct.mask);
      if (__ldcg(&ct.claim[slot]) == li) {
        store_row<L>(ct.lane, slot, c.p.w);
        ct.occ[slot] = 1;
        ct.claim[slot] = kClaimFree;
        c.p.fl = kFresh;
      } else {
        c.p.fl = kPending;  // re-check the slot next round
        c.wake = r + 1;
      }
    }
    due = (c.p.fl & kPending) && c.p.off < pl ? c.wake : kNoWake;
  }
  if (tid < n) outcome(a, a.sc.idx[li], c.p.fl, c.p.off);
}

template <int L>
cudaError_t occupancy(int* per_sm) {
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, k4_grid_insert<L>, kGridThreads, 0);
  if (err == cudaSuccess && n < *per_sm) *per_sm = n;
  return err;
}

}  // namespace

extern "C" {

// Once per device, before the first launch there: reads how many blocks
// of the insert's grid the card keeps resident per SM (the least over
// its row layouts) and its SM count. Returns their product, the blocks
// of every launch's grid there, or minus the cudaError_t.
int jt_tiled_insert_init(void) {
  int dev = 0, per_sm = 1 << 30, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = occupancy<1>(&per_sm);
  if (err == cudaSuccess) err = occupancy<2>(&per_sm);
  if (err == cudaSuccess) err = occupancy<3>(&per_sm);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess && per_sm < 1) {
    err = cudaErrorCooperativeLaunchTooLarge;
  }
  return err == cudaSuccess ? per_sm * sms : -(int)err;
}

// The device scratch a launch over K keys of M candidates and tables of T
// slots needs, in bytes.
long long jt_tiled_insert_scratch(int K, int M, int T) {
  if (K < 1 || M < 1 || (long long)K * M >= INT_MAX) return -1;
  return (long long)carve(nullptr, K * M, (size_t)K * T).bytes;
}

// K keys' transactions on `stream`: the prep and compact launches, then a
// cooperative grid of grid_blocks blocks (all of which the card must keep
// resident; jt_tiled_insert_init's count). The candidates' lanes c0..c2,
// fresh and off_out are [K, M], the tables' lanes t0..t2 and t_occ
// [K, T] (T a power of two), pend_out [K]; rows have `lanes` lanes (1-3;
// the pointers past them are unused, null). The tables are updated in
// place, fresh, off_out and pend_out written whole. Returns the
// cudaError_t of the launches (cudaErrorInvalidValue for a shape it does
// not take: K * M must stay below INT_MAX, the list's int32 range; a
// cooperative launch the card refuses returns its error and runs
// nothing).
int jt_tiled_insert_launch(const int32_t* c0, const int32_t* c1,
                           const int32_t* c2, const uint8_t* c_live, int M,
                           int32_t* t0, int32_t* t1, int32_t* t2,
                           uint8_t* t_occ, int T, uint8_t* fresh,
                           int32_t* off_out, uint8_t* pend_out,
                           void* scratch, int K, int probe_limit,
                           int grid_blocks, int lanes, void* stream) {
  if (K < 1 || M < 1 || (long long)K * M >= INT_MAX || T < 2 ||
      (T & (T - 1)) != 0 || probe_limit < 1 || probe_limit > 255 ||
      grid_blocks < 1 || lanes < 1 || lanes > 3) {
    return (int)cudaErrorInvalidValue;
  }
  const int KM = K * M;
  const size_t KT = (size_t)K * T;
  Args a{{c0, c1, c2}, c_live, M,        K,        KM,
         T,            KT,     {t0, t1, t2}, t_occ, fresh,
         off_out,      pend_out, carve(scratch, KM, KT), probe_limit};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int grid = list_chunks(KM);
  k4_prep<<<grid, kListThreads, 0, s>>>(a);
  k4_compact<<<grid, kListThreads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  void* params[] = {&a};
  const void* kernel = lanes == 1   ? (const void*)k4_grid_insert<1>
                       : lanes == 2 ? (const void*)k4_grid_insert<2>
                                    : (const void*)k4_grid_insert<3>;
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid_blocks),
                                    dim3(kGridThreads), params, 0, s);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
