// Device helpers shared by the sparse engines' kernels (K2
// frontier_closure.cu, K3 hash_insert.cu, K4 tiled_insert.cu): the
// visited-set hash, a warp's lane mask, the five model-step families of
// jepsen_tpu_torch/parallel/steps.py, a block-wide exclusive prefix sum,
// the two phases of a visited-set probe round (probe_a, probe_b, on a
// candidate's state in registers or, through probe_read and
// claim_settle, in memory), the one-block transaction insert_pass (K2's
// and K3's shared layout), and the whole-table transaction over a
// cooperative grid (the live list, then grid_rounds: K3's device layout
// and K4). Integers are 32-bit two's
// complement; shifts follow steps.py's _shl/_sar (0 past the word for a left shift,
// sign fill for a right shift), and wrapping arithmetic goes through
// uint32_t so that it is defined.
//
// A row is L uint32 lanes, L a template parameter: 3 for the triple
// (state, mask_lo, mask_hi), 1 or 2 for the packed word of config_pack
// (sparse._PackedRep). The tables, probes and candidates below are
// generic over L; only K2's candidates look inside a row.

#pragma once

#include <cooperative_groups.h>
#include <cstdint>

namespace jt {

constexpr int kClaimFree = 0x7FFFFFFF;  // larger than any candidate index
constexpr uint8_t kPending = 1;          // still probing
constexpr uint8_t kTry = 2;              // claimed an empty slot this round
constexpr uint8_t kFresh = 4;            // won a slot: a first sighting

// engine._UnpackedRep.table_hash of the triple (L = 3) and
// engine._PackedRep.table_hash of the packed word (L = 1, 2): lane k times
// the k-th constant, XORed, then one finaliser
template <int L>
__device__ __forceinline__ uint32_t table_hash(const uint32_t (&w)[L]) {
  uint32_t h = w[0] * 0x85EBCA6Bu;
  if (L > 1) h ^= w[L > 1 ? 1 : 0] * 0xC2B2AE35u;
  if (L > 2) h ^= w[L > 2 ? 2 : 0] * 0x27D4EB2Fu;
  h ^= h >> 16;
  h *= 0x165667B1u;
  h ^= h >> 13;
  return h;
}

// the lanes of the warp below this one, as a mask
__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__device__ __forceinline__ int32_t shl(int32_t x, int32_t n) {
  return (n < 0 || n > 31) ? 0 : (int32_t)((uint32_t)x << n);
}

__device__ __forceinline__ int32_t sar(int32_t x, int32_t n) {
  return x >> ((n < 0 || n > 31) ? 31 : n);
}

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}

__device__ __forceinline__ int32_t floor_div(int32_t a, int32_t b) {
  const int32_t q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// model f-codes (jepsen_tpu_torch/models.py F_*)
constexpr int32_t F_READ = 0, F_WRITE = 1, F_CAS = 2, F_ACQUIRE = 3,
                  F_RELEASE = 4, F_ADD = 5, F_ENQ = 6, F_DEQ = 7;

// step families, in the order of sparse_kernels.STEP_CODES
enum StepCode { kRegister = 0, kMutex = 1, kGSet = 2, kUQueue = 3,
                kFifo = 4 };

// One model step: the next state, and whether the op is legal from s.
// As in steps.py an illegal op leaves the state unchanged.
__device__ __forceinline__ int32_t step(int code, int32_t s, int32_t f,
                                        int32_t a0, int32_t a1, bool wild,
                                        bool* ok_out) {
  bool ok;
  int32_t nx;
  switch (code) {
    case kRegister: {
      const bool rd = f == F_READ, wr = f == F_WRITE, cas = f == F_CAS;
      ok = wild || (rd && s == a0) || wr || (cas && s == a0);
      nx = (wild || rd) ? s : wr ? a0 : cas ? a1 : s;
      break;
    }
    case kMutex: {
      const bool acq = f == F_ACQUIRE, rel = f == F_RELEASE;
      ok = wild || (acq && s == 0) || (rel && s == 1);
      nx = wild ? s : acq ? 1 : 0;
      break;
    }
    case kGSet: {
      const bool add = f == F_ADD, rd = f == F_READ;
      const int32_t bit = shl(1, a0 < 0 ? 0 : a0);
      ok = wild || add || (rd && s == a0);
      nx = (wild || rd) ? s : add ? (s | bit) : s;
      break;
    }
    case kUQueue: {
      const bool enq = f == F_ENQ, deq = f == F_DEQ;
      const int32_t off = a0 < 0 ? 0 : a0;
      const int32_t one = shl(1, off);
      const int32_t cnt = sar(s, off) & a1;
      ok = wild || enq || (deq && cnt > 0);
      nx = wild ? s : enq ? wadd(s, one) : deq ? wsub(s, one) : s;
      break;
    }
    default: {  // kFifo
      const bool enq = f == F_ENQ, deq = f == F_DEQ;
      const int32_t v = a1 < 1 ? 1 : a1;
      const int32_t head = s & wsub(shl(1, v), 1);
      const int32_t bitlen = s < 0 ? 32 : 32 - __clz(s);
      const int32_t depth = floor_div(wsub(wadd(bitlen, v), 1), v);
      const int32_t enq_state =
          s | shl(a0 < 0 ? 0 : a0, (int32_t)((uint32_t)v * (uint32_t)depth));
      const bool deq_ok = head != 0 && (a0 < 0 || head == a0);
      ok = wild || enq || (deq && deq_ok);
      nx = wild ? s : enq ? enq_state : deq ? sar(s, v) : s;
      break;
    }
  }
  *ok_out = ok;
  return ok ? nx : s;
}

// Exclusive prefix sum of v over the block (blockDim.x a multiple of
// 32, at most 1024), in thread order; *total gets the sum. `warp_sums`
// is 32 ints of shared memory. Every thread must call it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums,
                                                    int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < n_warps ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  const int before = (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
  *total = warp_sums[n_warps - 1];
  __syncthreads();  // warp_sums may be reused right after
  return before;
}

constexpr int kFlagsPerThread = 16;  // live flags a thread reads at once

// The live flags i0 .. i0+15 (those below M) as bits.
__device__ __forceinline__ uint32_t live_bits(const uint8_t* live, int M,
                                              int i0) {
  uint32_t bits = 0;
  if (i0 + kFlagsPerThread <= M &&
      (reinterpret_cast<uintptr_t>(live + i0) & 15) == 0) {
    const uint4 v = *reinterpret_cast<const uint4*>(live + i0);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        bits |= (((w[q] >> (8 * b)) & 0xFFu) != 0 ? 1u : 0u) << (4 * q + b);
      }
    }
  } else {
    for (int k = 0; k < kFlagsPerThread && i0 + k < M; ++k) {
      bits |= (live[i0 + k] != 0 ? 1u : 0u) << k;
    }
  }
  return bits;
}

// An open-addressed visited set of T slots (T a power of two, mask =
// T - 1): rows of L lanes, occupancy and one claim word per slot
// (kClaimFree between rounds), in shared or device memory alike.
template <int L>
struct TableView {
  int32_t* lane[L];
  int32_t* claim;
  uint8_t* occ;
  uint32_t mask;
  // the same layout n slots further on (a key's own table)
  __device__ __forceinline__ TableView at(size_t n) const {
    TableView v = *this;
#pragma unroll
    for (int k = 0; k < L; ++k) v.lane[k] += n;
    v.claim += n;
    v.occ += n;
    return v;
  }
};

// Loads of table words. PlainLoads serve a table that one block owns
// (K2, K3's shared layout); L2Loads (ld.global.cg) serve the grid
// transaction (grid_rounds: K3's device layout, K4), whose table words
// other blocks write between grid-wide barriers, so no read may come
// from a stale line of this SM's L1.
struct PlainLoads {
  template <class T>
  __device__ __forceinline__ static T ld(const T* p) { return *p; }
};
struct L2Loads {
  template <class T>
  __device__ __forceinline__ static T ld(const T* p) { return __ldcg(p); }
};

// One candidate's probe state: its row and hash, its probe offset and
// its flags (kPending, kTry, kFresh).
template <int L>
struct Probe {
  uint32_t w[L];
  uint32_t h;
  int off;
  uint8_t fl;
};

template <int L>
__device__ __forceinline__ void set_row(Probe<L>& p, const uint32_t (&w)[L]) {
#pragma unroll
  for (int k = 0; k < L; ++k) p.w[k] = w[k];
  p.h = table_hash<L>(w);
}

// Whether table slot `slot` holds the row w.
template <class Ld, int L>
__device__ __forceinline__ bool row_equal(const TableView<L>& t, int slot,
                                          const uint32_t (&w)[L]) {
  bool eq = true;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    eq = eq && (uint32_t)Ld::ld(&t.lane[k][slot]) == w[k];
  }
  return eq;
}

// Row i of the L lanes `out` gets w.
template <int L>
__device__ __forceinline__ void store_row(int32_t* const (&out)[L], int i,
                                          const uint32_t (&w)[L]) {
#pragma unroll
  for (int k = 0; k < L; ++k) out[k][i] = (int32_t)w[k];
}

// Phase A of a probe round for candidate li: if it is still pending with
// probes left, read its slot; an equal occupant drops it, a different
// one advances it, an empty slot takes an atomicMin of li on the claim
// word.
template <class Ld, int L>
__device__ __forceinline__ void probe_a(Probe<L>& p, const TableView<L>& t,
                                        int li, int probe_limit) {
  if (!(p.fl & kPending) || p.off >= probe_limit) return;
  const int slot = (int)((p.h + (uint32_t)p.off) & t.mask);
  if (Ld::ld(&t.occ[slot])) {
    if (row_equal<Ld>(t, slot, p.w)) {
      p.fl = 0;  // already visited
    } else {
      p.off += 1;
    }
  } else {
    atomicMin(&t.claim[slot], li);
    p.fl = kPending | kTry;
  }
}

// Phase B, after every phase A of the round: the lowest claimant of a
// slot writes it and frees the claim (a loser then reads kClaimFree or
// the winner's index, never its own); a loser stays pending. Returns
// whether li is still pending with probes left.
template <class Ld, int L>
__device__ __forceinline__ bool probe_b(Probe<L>& p, const TableView<L>& t,
                                        int li, int probe_limit) {
  if (p.fl & kTry) {
    const int slot = (int)((p.h + (uint32_t)p.off) & t.mask);
    if (Ld::ld(&t.claim[slot]) == li) {
      store_row<L>(t.lane, slot, p.w);
      t.occ[slot] = 1;
      t.claim[slot] = kClaimFree;
      p.fl = kFresh;
      return false;
    }
    p.fl = kPending;
  }
  return (p.fl & kPending) && p.off < probe_limit;
}

// probe_a and probe_b for candidate li whose offset and flags live in
// off[li] and flags[li] (one byte each) and whose row `cand` rebuilds.
template <class Ld, int L, class Cand>
__device__ __forceinline__ void probe_read(const Cand& cand,
                                           const TableView<L>& t,
                                           uint8_t* off, uint8_t* flags,
                                           int li, int probe_limit) {
  if (!(flags[li] & kPending) || off[li] >= probe_limit) return;
  Probe<L> p;
  uint32_t w[L];
  cand(li, w);
  set_row(p, w);
  p.off = off[li];
  p.fl = flags[li];
  probe_a<Ld>(p, t, li, probe_limit);
  off[li] = (uint8_t)p.off;
  flags[li] = p.fl;
}

template <class Ld, int L, class Cand>
__device__ __forceinline__ bool claim_settle(const Cand& cand,
                                             const TableView<L>& t,
                                             uint8_t* off, uint8_t* flags,
                                             int li, int probe_limit) {
  Probe<L> p;
  p.fl = flags[li];
  p.off = off[li];
  if (p.fl & kTry) {
    uint32_t w[L];
    cand(li, w);
    set_row(p, w);
  }
  const bool more = probe_b<Ld>(p, t, li, probe_limit);
  flags[li] = p.fl;
  return more;
}

// One visited-set transaction of the M candidates of a pass, run by one
// whole block: sparse._hash_insert_append, bit for bit. `cand(li, w)`
// rebuilds candidate li's L lanes in w and returns whether it is live;
// off and flags hold one byte each per candidate; scan is 32 ints of
// shared memory. The fresh candidates are appended after `count` to the
// lanes `out`, in candidate order, those past N dropped. Returns the
// number of fresh candidates; *probe_ovf says whether one exhausted its
// probes. Uniform: every thread gets the same values.
//
// Probing is round-synchronous, as in the reference's while loop:
// phase A (probe_read) for every pending candidate, a barrier, phase B
// (claim_settle), a barrier; the losers re-check the same slot next
// round (the winner may hold an equal row). All reads of a round
// precede its writes, so the table, the offsets and the winners are the
// reference's whatever order the threads run in. The append is a block
// prefix sum of the fresh flags in candidate order, so the rows land
// where the reference's cumsum puts them. A candidate is read again (or
// rebuilt) wherever it is needed, so `out` may be the rows the
// candidates come from, as long as the appended rows lie past those.
template <int L, class Cand>
__device__ int insert_pass(const Cand& cand, const TableView<L>& t,
                           uint8_t* off, uint8_t* flags, int* scan, int M,
                           int probe_limit, int32_t* const (&out)[L],
                           int count, int N, bool* probe_ovf) {
  const int tid = threadIdx.x, nt = blockDim.x;
  int local = 0;
  for (int li = tid; li < M; li += nt) {
    uint32_t w[L];
    const bool live = cand(li, w);
    flags[li] = live ? kPending : 0;
    off[li] = 0;
    local |= live;
  }
  int active = __syncthreads_or(local);
  while (active) {
    for (int li = tid; li < M; li += nt) {
      probe_read<PlainLoads>(cand, t, off, flags, li, probe_limit);
    }
    __syncthreads();
    local = 0;
    for (int li = tid; li < M; li += nt) {
      local |= claim_settle<PlainLoads>(cand, t, off, flags, li,
                                        probe_limit);
    }
    active = __syncthreads_or(local);
  }

  // append the fresh candidates after `count`, in candidate order
  const int per = (M + nt - 1) / nt;
  const int lo = min(M, tid * per), hi = min(M, lo + per);
  int mine = 0, pend = 0;
  for (int li = lo; li < hi; ++li) {
    mine += (flags[li] & kFresh) != 0;
    pend |= (flags[li] & kPending) != 0;
  }
  int n_fresh;
  int pos = count + block_exclusive_scan(mine, scan, &n_fresh);
  *probe_ovf = __syncthreads_or(pend) != 0;
  for (int li = lo; li < hi; ++li) {
    if (!(flags[li] & kFresh)) continue;
    if (pos < N) {
      uint32_t w[L];
      cand(li, w);
      store_row<L>(out, pos, w);
    }
    ++pos;
  }
  __syncthreads();
  return n_fresh;
}

// ------------------------------------------- the grid transaction

// The live list: the indices of the live candidates among M flags, in
// order, built by two launches of kListThreads-thread blocks, one block
// per kListChunk flags: list_count, then list_compact.
constexpr int kListThreads = 256;
constexpr int kListChunk = kListThreads * kFlagsPerThread;

__host__ __device__ __forceinline__ int list_chunks(int M) {
  return (M + kListChunk - 1) / kListChunk;
}

// The first launch: block b counts the live flags of its chunk into
// counts[b]. `scan` is 40 ints of shared memory; every thread calls it.
__device__ __forceinline__ void list_count(const uint8_t* live, int M,
                                           int32_t* counts, int* scan) {
  const int i0 = blockIdx.x * kListChunk + threadIdx.x * kFlagsPerThread;
  int total;
  block_exclusive_scan(__popc(live_bits(live, M, i0)), scan, &total);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

// The second launch: block b writes the indices of its chunk's live
// candidates, in order, after those of the chunks before it.
__device__ __forceinline__ void list_compact(const uint8_t* live, int M,
                                             const int32_t* counts,
                                             int32_t* idx, int* scan) {
  int part = 0;
  for (int b = threadIdx.x; b < (int)blockIdx.x; b += blockDim.x) {
    part += counts[b];
  }
  int before;
  block_exclusive_scan(part, scan, &before);
  const int i0 = blockIdx.x * kListChunk + threadIdx.x * kFlagsPerThread;
  uint32_t bits = live_bits(live, M, i0);
  int total;
  int pos = before + block_exclusive_scan(__popc(bits), scan, &total);
  while (bits) {
    idx[pos++] = i0 + __ffs(bits) - 1;
    bits &= bits - 1;
  }
}

// The list's length: every chunk's count summed (every thread of the
// block gets it).
__device__ __forceinline__ int list_total(const int32_t* counts, int M,
                                          int* scan) {
  int part = 0;
  for (int b = threadIdx.x; b < list_chunks(M); b += blockDim.x) {
    part += counts[b];
  }
  int n;
  block_exclusive_scan(part, scan, &n);
  return n;
}

// Live candidate li: row idx[li] of the candidates' L lanes.
template <int L>
struct ListCand {
  const int32_t* lane[L];
  const int32_t* idx;
  __device__ __forceinline__ bool operator()(int li, uint32_t (&w)[L]) const {
    const int i = idx[li];
#pragma unroll
    for (int k = 0; k < L; ++k) w[k] = (uint32_t)lane[k][i];
    return true;
  }
};

// This block's share of the list of n live candidates: the contiguous
// range [lo, hi), in order. While that leaves each thread at most one
// candidate (in_regs, the same in every block), thread t holds
// candidate my = lo + t in registers.
struct GridSpan {
  int lo, hi, my;
  bool in_regs;
};

__device__ __forceinline__ GridSpan grid_span(int n) {
  const int per = (n + gridDim.x - 1) / gridDim.x;
  GridSpan s;
  s.lo = min(n, (int)blockIdx.x * per);
  s.hi = min(n, s.lo + per);
  s.my = s.lo + threadIdx.x;
  s.in_regs = per <= (int)blockDim.x;
  return s;
}

// The probe rounds of one visited-set transaction of the n_list listed
// candidates over a cooperative grid of co-resident blocks (the
// reference's whole-table transaction; K3's device layout and K4). The
// claim words take the list index, whose order is the candidates', so
// the lowest index wins a race as in the one-block insert_pass. A
// candidate of the span's registers keeps its row, hash, offset and
// flags in p; else they live in off[li] and flags[li], the row rebuilt
// each phase. A round is phase A (probe_a), grid.sync(), phase B
// (probe_b), grid.sync(): every read of a round precedes its writes
// grid-wide, so the table, the offsets and the winners are the
// reference's whatever order the blocks run in. Table words other blocks
// write are read through L2 (ld.global.cg), never from a stale L1 line.
// Whether any candidate still probes is a grid-wide flag, double-
// buffered by round parity so that clearing it needs no third barrier.
//
// `view(li)` is the table candidate li probes: the one table (K3), or
// its key's among K tables (K4). gflags is 3 ints of device memory: the
// probing flags and, for the caller's epilogue, a third that block 0
// clears here with them, before the first barrier. On return the
// candidates' outcome is in p (in_regs) or in off and flags.
template <int L, class Cand, class View>
__device__ void grid_rounds(const Cand& cand, const View& view,
                            const GridSpan& s, int n_list, Probe<L>& p,
                            uint8_t* off, uint8_t* flags, int* gflags,
                            int probe_limit) {
  namespace cg = cooperative_groups;
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, nt = blockDim.x;
  int* const active = gflags;  // [2], by round parity
  p.off = 0;
  p.fl = 0;
  TableView<L> tv{};  // the table of this thread's register candidate
  if (s.in_regs) {
    if (s.my < s.hi) {
      uint32_t w[L];
      cand(s.my, w);
      set_row(p, w);
      p.fl = kPending;  // every listed candidate is live
      tv = view(s.my);
    }
  } else {
    for (int li = s.lo + tid; li < s.hi; li += nt) {
      flags[li] = kPending;
      off[li] = 0;
    }
  }
  if (blockIdx.x == 0 && tid == 0) {
    active[0] = active[1] = 0;
    gflags[2] = 0;
  }
  grid.sync();
  for (int round = 0, go = n_list > 0; go; ++round) {
    if (s.in_regs) {
      probe_a<L2Loads>(p, tv, s.my, probe_limit);
    } else {
      for (int li = s.lo + tid; li < s.hi; li += nt) {
        probe_read<L2Loads>(cand, view(li), off, flags, li, probe_limit);
      }
    }
    grid.sync();
    int local = 0;
    if (s.in_regs) {
      local = probe_b<L2Loads>(p, tv, s.my, probe_limit);
    } else {
      for (int li = s.lo + tid; li < s.hi; li += nt) {
        local |= claim_settle<L2Loads>(cand, view(li), off, flags, li,
                                       probe_limit);
      }
    }
    // the other parity's flag was last read before the barrier above;
    // it is set again only after the barrier below
    if (blockIdx.x == 0 && tid == 0) active[(round + 1) & 1] = 0;
    if (__syncthreads_or(local) && tid == 0) {
      atomicOr(&active[round & 1], 1);
    }
    grid.sync();
    go = __ldcg(&active[round & 1]);
  }
}

}  // namespace jt
