// Device helpers shared by the sparse engines' kernels (K2
// frontier_closure.cu, K3 hash_insert.cu, K4 tiled_insert.cu): the
// visited-set hash, a warp's lane mask, the five model-step families of
// jepsen_tpu_torch/parallel/steps.py, a block-wide exclusive prefix sum,
// the two phases of a visited-set probe round (probe_a, probe_b, on a
// candidate's state in registers or, through probe_read and
// claim_settle, in memory: K2's and K3's one-block insert_pass, and K3's
// cooperative grid) and insert_pass itself. Integers are 32-bit two's
// complement; shifts follow steps.py's _shl/_sar (0 past the word for a left shift,
// sign fill for a right shift), and wrapping arithmetic goes through
// uint32_t so that it is defined.

#pragma once

#include <cstdint>

namespace jt {

constexpr int kClaimFree = 0x7FFFFFFF;  // larger than any candidate index
constexpr uint8_t kPending = 1;          // still probing
constexpr uint8_t kTry = 2;              // claimed an empty slot this round
constexpr uint8_t kFresh = 4;            // won a slot: a first sighting

// engine._UnpackedRep.table_hash, on uint32
__device__ __forceinline__ uint32_t table_hash(int32_t st, uint32_t ml,
                                               uint32_t mh) {
  uint32_t h = ((uint32_t)st * 0x85EBCA6Bu) ^ (ml * 0xC2B2AE35u) ^
               (mh * 0x27D4EB2Fu);
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

// An open-addressed visited set of T slots (T a power of two, mask =
// T - 1): rows, occupancy and one claim word per slot (kClaimFree between
// rounds), in shared or device memory alike.
struct TableView {
  int32_t *st, *ml, *mh;
  int32_t* claim;
  uint8_t* occ;
  uint32_t mask;
};

// Loads of table words. PlainLoads serve a table that one block owns
// (K2, K3's shared layout); L2Loads (ld.global.cg) serve K3's grid,
// whose table words other blocks write between grid-wide barriers, so
// no read may come from a stale line of this SM's L1.
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
struct Probe {
  int32_t st;
  uint32_t ml, mh, h;
  int off;
  uint8_t fl;
};

__device__ __forceinline__ void set_row(Probe& p, int32_t st, uint32_t ml,
                                        uint32_t mh) {
  p.st = st;
  p.ml = ml;
  p.mh = mh;
  p.h = table_hash(st, ml, mh);
}

// Phase A of a probe round for candidate li: if it is still pending with
// probes left, read its slot; an equal occupant drops it, a different
// one advances it, an empty slot takes an atomicMin of li on the claim
// word.
template <class Ld>
__device__ __forceinline__ void probe_a(Probe& p, const TableView& t,
                                        int li, int probe_limit) {
  if (!(p.fl & kPending) || p.off >= probe_limit) return;
  const int slot = (int)((p.h + (uint32_t)p.off) & t.mask);
  if (Ld::ld(&t.occ[slot])) {
    if (Ld::ld(&t.st[slot]) == p.st &&
        (uint32_t)Ld::ld(&t.ml[slot]) == p.ml &&
        (uint32_t)Ld::ld(&t.mh[slot]) == p.mh) {
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
template <class Ld>
__device__ __forceinline__ bool probe_b(Probe& p, const TableView& t,
                                        int li, int probe_limit) {
  if (p.fl & kTry) {
    const int slot = (int)((p.h + (uint32_t)p.off) & t.mask);
    if (Ld::ld(&t.claim[slot]) == li) {
      t.st[slot] = p.st;
      t.ml[slot] = (int32_t)p.ml;
      t.mh[slot] = (int32_t)p.mh;
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
template <class Ld, class Cand>
__device__ __forceinline__ void probe_read(const Cand& cand,
                                           const TableView& t, uint8_t* off,
                                           uint8_t* flags, int li,
                                           int probe_limit) {
  if (!(flags[li] & kPending) || off[li] >= probe_limit) return;
  Probe p;
  int32_t st;
  uint32_t ml, mh;
  cand(li, st, ml, mh);
  set_row(p, st, ml, mh);
  p.off = off[li];
  p.fl = flags[li];
  probe_a<Ld>(p, t, li, probe_limit);
  off[li] = (uint8_t)p.off;
  flags[li] = p.fl;
}

template <class Ld, class Cand>
__device__ __forceinline__ bool claim_settle(const Cand& cand,
                                             const TableView& t,
                                             uint8_t* off, uint8_t* flags,
                                             int li, int probe_limit) {
  Probe p;
  p.fl = flags[li];
  p.off = off[li];
  if (p.fl & kTry) {
    int32_t st;
    uint32_t ml, mh;
    cand(li, st, ml, mh);
    set_row(p, st, ml, mh);
  }
  const bool more = probe_b<Ld>(p, t, li, probe_limit);
  flags[li] = p.fl;
  return more;
}

// One visited-set transaction of the M candidates of a pass, run by one
// whole block: sparse._hash_insert_append, bit for bit. `cand(li, st,
// ml, mh)` rebuilds candidate li and returns whether it is live; off and
// flags hold one byte each per candidate; scan is 32 ints of shared
// memory. The fresh candidates are appended after `count` to out_*, in
// candidate order, those past N dropped. Returns the number of fresh
// candidates; *probe_ovf says whether one exhausted its probes. Uniform:
// every thread gets the same values.
//
// Probing is round-synchronous, as in the reference's while loop:
// phase A (probe_read) for every pending candidate, a barrier, phase B
// (claim_settle), a barrier; the losers re-check the same slot next
// round (the winner may hold an equal row). All reads of a round
// precede its writes, so the table, the offsets and the winners are the
// reference's whatever order the threads run in. The append is a block
// prefix sum of the fresh flags in candidate order, so the rows land
// where the reference's cumsum puts them. A candidate is read again (or
// rebuilt) wherever it is needed, so out_* may be the rows the
// candidates come from, as long as the appended rows lie past those.
template <class Cand>
__device__ int insert_pass(const Cand& cand, const TableView& t,
                           uint8_t* off, uint8_t* flags, int* scan, int M,
                           int probe_limit, int32_t* out_st,
                           int32_t* out_ml, int32_t* out_mh, int count,
                           int N, bool* probe_ovf) {
  const int tid = threadIdx.x, nt = blockDim.x;
  int local = 0;
  for (int li = tid; li < M; li += nt) {
    int32_t st;
    uint32_t ml, mh;
    const bool live = cand(li, st, ml, mh);
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
      int32_t st;
      uint32_t ml, mh;
      cand(li, st, ml, mh);
      out_st[pos] = st;
      out_ml[pos] = (int32_t)ml;
      out_mh[pos] = (int32_t)mh;
    }
    ++pos;
  }
  __syncthreads();
  return n_fresh;
}

}  // namespace jt
