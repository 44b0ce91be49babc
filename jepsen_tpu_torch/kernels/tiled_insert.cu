// K4: the probe/claim half of one visited-set transaction, with the
// table split into hash-range tiles, for Hopper.
//
// Replaces jepsen_tpu/parallel/sparse_kernels.py::tiled_insert_call (the
// Pallas TPU kernel the sparse engine takes past the whole-event closure's
// memory gate). It computes what
// jepsen_tpu_torch.parallel.sparse_kernels.tiled_insert_reference
// computes, bit for bit: for M candidate rows (state, mask_lo, mask_hi)
// with live flags and a table of T = n_tiles * TS slots,
//
//   * candidate i's hash h picks its home tile, h & (n_tiles - 1), and its
//     start inside the tile, (h >> log2(n_tiles)) & (TS - 1); its probes
//     wrap inside the tile, so each row has exactly one probe sequence;
//   * candidates stream in chunks of CH consecutive indices, in order;
//     within a chunk they probe round-synchronously (drop on an equal
//     occupant, advance past a different one, claim an empty slot by the
//     lowest index, losers re-check next round);
//   * out: the table (updated in place), fresh[M] (claimed a slot),
//     off[M] (final probe offset, 0 for dead candidates) and a flag set
//     when some candidate exhausted its `probe_limit` probes.
//
// The append of the fresh rows and the expansion around it stay PyTorch
// ops (sparse_kernels.tiled_event_closure), as the reference keeps them
// in XLA.
//
// Design: two launches, so that the M candidates are read once, by every
// SM, and each tile's block walks only its own live candidates.
//
//   bin     one block per R consecutive candidates (R = 256 * kb, a power
//           of two that divides CH whenever CH >= 256).
//           It reads each live flag once, writes fresh = 0 and off = 0
//           for every candidate, hashes the live ones and sorts their
//           indices by home tile into its own segment of the list,
//           stably: a candidate's place is the exclusive prefix, over
//           (tile, group of 32 candidates) in that order, of the groups'
//           counts, plus its rank among the lanes of its group with the
//           same tile (__match_any_sync). No atomics decide a place, so
//           inside a segment each tile's candidates stay in index order.
//           It writes per (tile, block) the segment's offset and count.
//   insert  one block per tile. A prefix over the blocks of its counts
//           makes the concatenation of its segments, in block order, the
//           tile's live candidates in index order. Chunk c covers blocks
//           [c * CH/R, (c+1) * CH/R), at most max(1, CH/R) of them. The
//           table stays in
//           device memory (read through L2 with ld.global.cg) and is
//           updated in place; no block touches another's tile.
//           Every warp first sums the tile's counts itself (a shuffle
//           prefix, no barrier), so all know how the tile runs:
//           * a tile with at most 32 live candidates runs in warp 0 alone:
//             lane p holds candidate p (row, hash, offset, flags in
//             registers); each chunk's lanes probe in rounds separated by
//             __syncwarp, and a claim goes to the lowest lane of those
//             trying one slot (__match_any_sync), the lowest index: no
//             claim words and no block barrier;
//           * a larger tile runs each non-empty chunk with the whole
//             block: every warp sums the chunk's counts itself (a chunk
//             with none of the tile's candidates costs no barrier), warp
//             0 places the chunk's segments, the candidates are gathered
//             into shared memory, then probe rounds as in the reference,
//             separated by __syncthreads, with atomicMin claims on a
//             claim word per tile slot in shared memory.
//
// Shared memory, whatever M is: the bin 4 * n_tiles * (R / 32) + 160
// bytes; the insert 4 * TS (claims) + 10 * CH (a chunk's candidates) +
// 8 * (span + 1) (the places of a chunk's segments, span = max(1,
// CH / R)). sparse_kernels.k4_smem_bytes computes the larger of the two,
// and sparse_kernels.tiled_plan makes no plan that it does not fit.
//
// What bounds it: the bytes the function must move — every live flag,
// fresh and off once, the live candidates' rows and the table slots
// they probe and write; a few integer operations a candidate. chip_smoke.py
// measures both against the bound on the card; PERF.md keeps the numbers.
//
// Build: nvcc -gencode=arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC tiled_insert.cu   (see kernels/__init__.py)

#include <cstdint>
#include <cuda_runtime.h>

#include "sparse_common.cuh"

namespace {

using namespace jt;

constexpr int kBinThreads = 256;
constexpr int kBinMaxK = 8;      // candidates a bin thread takes, at most
constexpr int kBinGroups = 8192;  // (tile, group) counters of a bin block
// 256 threads: the common tile needs warp 0 alone, and a smaller block
// launches sooner
constexpr int kInsThreads = 256;

struct Plan {
  int n_tt, kb, R;  // tiles, candidates a bin thread takes, R = 256 * kb
  int span;         // bin blocks a chunk spans, at most
};

int pow2_floor(int n) {
  int p = 1;
  while (p * 2 <= n) p *= 2;
  return p;
}

// The bin's shape for 2^tile_bits tiles and chunk CH (M does not enter).
// A bin block has (R / 32) * n_tt counters, at most kBinGroups while R
// can shrink to 256, and R divides CH whenever CH >= 256 (a launch over
// more than one chunk has CH >= 512), so a chunk spans at most
// max(1, CH / R) bin blocks.
Plan make_plan(int tile_bits, int CH) {
  Plan p;
  p.n_tt = 1 << tile_bits;
  int kb = kBinGroups / (8 * p.n_tt);
  kb = kb < 1 ? 1 : pow2_floor(kb < kBinMaxK ? kb : kBinMaxK);
  if (kb * kBinThreads > CH) kb = CH >= kBinThreads ? CH / kBinThreads : 1;
  p.kb = kb;
  p.R = kb * kBinThreads;
  p.span = CH > p.R ? CH / p.R : 1;
  return p;
}

int bin_blocks(const Plan& p, int M) { return (M + p.R - 1) / p.R; }

size_t bin_smem(const Plan& p) {
  return 4 * (size_t)p.n_tt * (p.R / 32) + 40 * 4;
}

size_t insert_smem(const Plan& p, int TS, int CH) {
  return 4 * (size_t)TS + 10 * (size_t)CH + 8 * ((size_t)p.span + 1);
}

// scratch: the list (B * R candidate indices), then per (tile, block)
// the segment's offset and count
size_t scratch_bytes(const Plan& p, int M) {
  const size_t B = (size_t)bin_blocks(p, M);
  return 4 * B * p.R + 8 * (size_t)p.n_tt * B;
}

// ------------------------------------------------------------------ bin

__global__ void __launch_bounds__(kBinThreads)
bin_kernel(const int32_t* __restrict__ c_st, const int32_t* __restrict__ c_ml,
           const int32_t* __restrict__ c_mh,
           const uint8_t* __restrict__ c_live, int M, uint8_t* fresh,
           int32_t* off_out, uint8_t* pend_out, int32_t* list,
           int32_t* seg_off, int32_t* seg_cnt, int tile_bits, int kb) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_tt = 1 << tile_bits;
  const int R = kb * kBinThreads;
  const int G = R / 32;  // groups of 32 candidates, in index order
  const int b = blockIdx.x, B = gridDim.x;
  const uint32_t tile_mask = (uint32_t)n_tt - 1u;
  int32_t* sub = reinterpret_cast<int32_t*>(smem);  // [n_tt][G]
  int32_t* scan = sub + (size_t)n_tt * G;           // 40 words

  const int n_sub = n_tt * G;
  for (int i = tid; i < n_sub; i += kBinThreads) sub[i] = 0;
  if (b == 0 && tid == 0) *pend_out = 0;
  __syncthreads();

  // every load first (flags, then the live candidates' rows), so that a
  // thread's kb candidates wait on memory once, not kb times
  int tiles[kBinMaxK], ranks[kBinMaxK];
  const int base = b * R;
#pragma unroll
  for (int k = 0; k < kBinMaxK; ++k) {
    const int i = base + k * kBinThreads + tid;
    tiles[k] = k < kb && i < M && c_live[i] != 0 ? 0 : -1;
  }
#pragma unroll
  for (int k = 0; k < kBinMaxK; ++k) {
    const int i = base + k * kBinThreads + tid;
    if (k < kb && i < M) {
      fresh[i] = 0;
      off_out[i] = 0;
    }
    if (tiles[k] == 0) {
      const uint32_t h =
          table_hash(c_st[i], (uint32_t)c_ml[i], (uint32_t)c_mh[i]);
      tiles[k] = (int)(h & tile_mask);
    }
  }
#pragma unroll
  for (int k = 0; k < kBinMaxK; ++k) {
    ranks[k] = 0;
    if (k >= kb) continue;
    // lanes of one tile find each other (most groups have no live lane
    // and skip it); a dead lane matches nobody
    const bool live = tiles[k] >= 0;
    if (!__any_sync(0xffffffffu, live)) continue;
    const unsigned peers =
        __match_any_sync(0xffffffffu, live ? tiles[k] : -1 - lane);
    if (live) {
      const int rank = __popc(peers & lanemask_lt());
      if (rank == 0) {
        sub[tiles[k] * G + k * (kBinThreads / 32) + warp] = __popc(peers);
      }
      ranks[k] = rank;
    }
  }
  __syncthreads();

  // exclusive prefix of sub in (tile, group) order, in place
  const int per = (n_sub + kBinThreads - 1) / kBinThreads;
  const int lo = min(n_sub, tid * per), hi = min(n_sub, lo + per);
  int mine = 0;
  for (int i = lo; i < hi; ++i) mine += sub[i];
  int total;
  int run = block_exclusive_scan(mine, scan, &total);
  for (int i = lo; i < hi; ++i) {
    const int v = sub[i];
    sub[i] = run;
    run += v;
  }
  __syncthreads();

  for (int t = tid; t < n_tt; t += kBinThreads) {
    const int o = sub[t * G];
    const int e = t + 1 < n_tt ? sub[(t + 1) * G] : total;
    seg_off[(size_t)t * B + b] = o;
    seg_cnt[(size_t)t * B + b] = e - o;
  }
#pragma unroll
  for (int k = 0; k < kBinMaxK; ++k) {
    if (tiles[k] < 0) continue;
    const int g = k * (kBinThreads / 32) + warp;
    list[(size_t)b * R + sub[tiles[k] * G + g] + ranks[k]] =
        base + k * kBinThreads + tid;
  }
}

// --------------------------------------------------------------- insert

struct WarpScan {
  // exclusive prefix of v over the warp's lanes; *total the warp's sum
  __device__ static int excl(int v, int* total) {
    const int lane = threadIdx.x & 31;
    int x = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    *total = __shfl_sync(0xffffffffu, x, 31);
    return x - v;
  }
};

struct Tile {
  const int32_t *c_st, *c_ml, *c_mh;
  int32_t *t_st, *t_ml, *t_mh;
  uint8_t* t_occ;
  size_t base;    // the tile's first slot
  int TS, tile_bits, probe_limit;
};

// One candidate's probe in the tile: its row, in-tile start, offset and
// flags (kPending, kFresh).
struct TProbe {
  int32_t st, ml, mh;
  int start, off;
  uint8_t fl;
};

// The tile's candidates, at most 32, in warp 0: lane p < n holds the
// tile's p-th live candidate (index idx). Chunks in order; inside one,
// rounds of: every pending lane with probes left reads its slot (an equal
// row drops it, a different one advances it, an empty slot makes it try
// a claim), __syncwarp, the lowest lane trying each slot writes it,
// __syncwarp. The others trying that slot stay pending at the same
// offset and re-check it next round, as the reference's losers do.
__device__ void insert_warp(const Tile& t, int idx, int n, int CH,
                            uint8_t* fresh, int32_t* off_out,
                            uint8_t* pend_out) {
  const int lane = threadIdx.x & 31;
  const bool mine = lane < n;
  TProbe p{};
  if (mine) {
    p.st = t.c_st[idx];
    p.ml = t.c_ml[idx];
    p.mh = t.c_mh[idx];
    const uint32_t h = table_hash(p.st, (uint32_t)p.ml, (uint32_t)p.mh);
    p.start = (int)((h >> t.tile_bits) & (uint32_t)(t.TS - 1));
    p.fl = kPending;
  }
  const int chunk = mine ? idx / CH : -1;
  unsigned todo = __ballot_sync(0xffffffffu, mine);
  while (todo) {
    const int cur = __shfl_sync(0xffffffffu, chunk, __ffs(todo) - 1);
    const bool in = mine && chunk == cur;
    todo &= ~__ballot_sync(0xffffffffu, in);
    while (true) {
      const bool act = in && (p.fl & kPending) && p.off < t.probe_limit;
      if (!__any_sync(0xffffffffu, act)) break;
      int slot = -1;
      bool occ = false, same = false;
      if (act) {
        slot = (p.start + p.off) & (t.TS - 1);
        const size_t s = t.base + slot;
        occ = __ldcg(&t.t_occ[s]) != 0;
        const int32_t st = __ldcg(&t.t_st[s]), ml = __ldcg(&t.t_ml[s]),
                      mh = __ldcg(&t.t_mh[s]);
        same = occ && st == p.st && ml == p.ml && mh == p.mh;
      }
      __syncwarp();  // every read of the round before any write
      const bool claim = act && !occ;
      const unsigned rivals =
          __match_any_sync(0xffffffffu, claim ? slot : -1 - lane);
      if (act) {
        if (same) {
          p.fl = 0;  // already visited
        } else if (occ) {
          p.off += 1;
        } else if (__ffs(rivals) - 1 == lane) {
          const size_t s = t.base + slot;
          t.t_st[s] = p.st;
          t.t_ml[s] = p.ml;
          t.t_mh[s] = p.mh;
          t.t_occ[s] = 1;
          p.fl = kFresh;
        }
      }
      __syncwarp();  // the round's writes before the next round's reads
    }
  }
  if (mine) {
    fresh[idx] = (p.fl & kFresh) ? 1 : 0;
    off_out[idx] = p.off;
  }
  if (__any_sync(0xffffffffu, mine && (p.fl & kPending)) && lane == 0) {
    *pend_out = 1;
  }
}

__global__ void __launch_bounds__(kInsThreads, 1)
insert_kernel(const int32_t* __restrict__ c_st,
              const int32_t* __restrict__ c_ml,
              const int32_t* __restrict__ c_mh, int M, int32_t* t_st,
              int32_t* t_ml, int32_t* t_mh, uint8_t* t_occ, uint8_t* fresh,
              int32_t* off_out, uint8_t* pend_out,
              const int32_t* __restrict__ list,
              const int32_t* __restrict__ seg_off,
              const int32_t* __restrict__ seg_cnt, int B, int R, int span,
              int TS, int tile_bits, int CH, int probe_limit) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int tile = blockIdx.x;
  const Tile t{c_st, c_ml, c_mh, t_st, t_ml, t_mh, t_occ,
               (size_t)tile * TS, TS, tile_bits, probe_limit};

  int32_t* w = reinterpret_cast<int32_t*>(smem);
  int32_t* claim = w; w += TS;
  // per bin block of the chunk: where its segment begins among the
  // chunk's candidates of this tile, and in that block's list
  int32_t* pre = w; w += span + 1;
  int32_t* soff = w; w += span + 1;
  int32_t* e_idx = w; w += CH;   // a chunk's candidates: index,
  int32_t* e_start = w; w += CH;  // in-tile start,
  uint8_t* e_off = reinterpret_cast<uint8_t*>(w);  // offset and flags
  uint8_t* e_fl = e_off + CH;

  const int32_t* cnt = seg_cnt + (size_t)tile * B;
  const int32_t* offs = seg_off + (size_t)tile * B;
  const int lane = tid & 31;

  // every warp counts the tile's candidates itself: lane l sums the
  // blocks [l * per, (l+1) * per), a shuffle prefix joins the lanes
  const int per = (B + 31) / 32;
  const int lo = min(B, lane * per), hi = min(B, lo + per);
  int mine = 0;
#pragma unroll 4
  for (int b = lo; b < hi; ++b) mine += cnt[b];
  int n_t;
  int at = WarpScan::excl(mine, &n_t);
  if (n_t == 0) return;  // uniform: no live candidate in this tile

  if (n_t <= 32) {
    // warp 0 alone: e_idx[p] = the tile's p-th candidate, in index order
    if (tid >= 32) return;
    for (int b = lo; b < hi; ++b) {
      const int k = cnt[b];
      for (int j = 0; j < k; ++j) {
        e_idx[at + j] = list[(size_t)b * R + offs[b] + j];
      }
      at += k;
    }
    __syncwarp();
    insert_warp(t, lane < n_t ? e_idx[lane] : 0, n_t, CH, fresh, off_out,
                pend_out);
    return;
  }

  // the whole block, chunk by chunk
  for (int i = tid; i < TS; i += nt) claim[i] = kClaimFree;
  __syncthreads();
  const int n_chunks = (M + CH - 1) / CH;
  const int spc = M > CH ? CH / R : B;  // blocks a chunk spans, <= span
  for (int c = 0; c < n_chunks; ++c) {
    const int b0 = c * spc, nb = min(B, b0 + spc) - b0;
    // every warp sums the chunk's counts itself
    int v = 0;
    for (int q = lane; q < nb; q += 32) v += cnt[b0 + q];
    const int ne = __reduce_add_sync(0xffffffffu, v);
    if (ne == 0) continue;  // uniform: the chunk has none of ours
    if (tid < 32) {
      int run = 0;
      for (int q0 = 0; q0 < nb; q0 += 32) {
        const int q = q0 + lane;
        const int k = q < nb ? cnt[b0 + q] : 0;
        int sum;
        const int x = WarpScan::excl(k, &sum);
        if (q < nb) {
          pre[q] = run + x;
          soff[q] = offs[b0 + q];
        }
        run += sum;
      }
      if (lane == 0) pre[nb] = ne;
    }
    __syncthreads();
    for (int q = 0; q < nb; ++q) {
      const int k = pre[q + 1] - pre[q];
      for (int j = tid; j < k; j += nt) {
        const int e = pre[q] + j;
        const int i = list[(size_t)(b0 + q) * R + soff[q] + j];
        const uint32_t h =
            table_hash(c_st[i], (uint32_t)c_ml[i], (uint32_t)c_mh[i]);
        e_idx[e] = i;
        e_start[e] = (int32_t)((h >> tile_bits) & (uint32_t)(TS - 1));
        e_off[e] = 0;
        e_fl[e] = kPending;
      }
    }
    __syncthreads();
    int active = 1;
    while (active) {
      for (int e = tid; e < ne; e += nt) {
        if (!(e_fl[e] & kPending) || e_off[e] >= probe_limit) continue;
        const int i = e_idx[e];
        const int slot = (e_start[e] + e_off[e]) & (TS - 1);
        const size_t s = t.base + slot;
        if (__ldcg(&t_occ[s])) {
          if (__ldcg(&t_st[s]) == c_st[i] && __ldcg(&t_ml[s]) == c_ml[i] &&
              __ldcg(&t_mh[s]) == c_mh[i]) {
            e_fl[e] = 0;  // already visited
          } else {
            e_off[e] += 1;
          }
        } else {
          atomicMin(&claim[slot], i);
          e_fl[e] = kPending | kTry;
        }
      }
      __syncthreads();
      int local = 0;
      for (int e = tid; e < ne; e += nt) {
        uint8_t fl = e_fl[e];
        if (fl & kTry) {
          const int slot = (e_start[e] + e_off[e]) & (TS - 1);
          const int i = e_idx[e];
          if (claim[slot] == i) {
            const size_t s = t.base + slot;
            t_st[s] = c_st[i];
            t_ml[s] = c_ml[i];
            t_mh[s] = c_mh[i];
            t_occ[s] = 1;
            claim[slot] = kClaimFree;
            e_fl[e] = kFresh;
            continue;
          }
          fl = kPending;
          e_fl[e] = fl;
        }
        if ((fl & kPending) && e_off[e] < probe_limit) local = 1;
      }
      active = __syncthreads_or(local);
    }
    for (int e = tid; e < ne; e += nt) {
      const int i = e_idx[e];
      fresh[i] = (e_fl[e] & kFresh) ? 1 : 0;
      off_out[i] = e_off[e];
      if (e_fl[e] & kPending) *pend_out = 1;
    }
    __syncthreads();  // before the chunk's arrays are reused
  }
}

}  // namespace

extern "C" {

// Once per device, before the first launch there: lets the kernels use
// the block's whole shared-memory opt-in. Returns that opt-in in bytes,
// or minus the cudaError_t.
int jt_tiled_insert_init(void) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute((const void*)insert_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute((const void*)bin_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  }
  return err == cudaSuccess ? optin : -(int)err;
}

// The larger dynamic shared memory of the two launches for a tile of TS
// slots, 2^tile_bits tiles and a chunk of CH, whatever M is
// (sparse_kernels.k4_smem_bytes must agree).
long long jt_tiled_insert_smem(int TS, int tile_bits, int CH) {
  const Plan p = make_plan(tile_bits, CH);
  const size_t a = insert_smem(p, TS, CH), b = bin_smem(p);
  return (long long)(a > b ? a : b);
}

// The device scratch one launch needs, in bytes.
long long jt_tiled_insert_scratch(int M, int tile_bits, int CH) {
  return (long long)scratch_bytes(make_plan(tile_bits, CH), M);
}

// One tiled insert on `stream`: the bin, then n_tiles = 1 << tile_bits
// insert blocks of TS slots (both powers of two). The table t_* is
// updated in place. fresh, off_out and pend_out are written whole (the
// bin zeroes them). `stages`: 1 the bin alone, 2 the insert alone (on a
// scratch an earlier bin of the same candidates filled), 3 both.
// Returns the cudaError_t of the launches (cudaErrorInvalidValue for a
// shape the kernels do not take).
int jt_tiled_insert_launch(const int32_t* c_st, const int32_t* c_ml,
                           const int32_t* c_mh, const uint8_t* c_live, int M,
                           int32_t* t_st, int32_t* t_ml, int32_t* t_mh,
                           uint8_t* t_occ, uint8_t* fresh, int32_t* off_out,
                           uint8_t* pend_out, void* scratch, int TS,
                           int tile_bits, int CH, int probe_limit, int stages,
                           void* stream) {
  if (M < 1 || TS < 1 || (TS & (TS - 1)) != 0 || tile_bits < 0 ||
      tile_bits > 24 || CH < 1 || (CH & (CH - 1)) != 0 || probe_limit < 1 ||
      probe_limit > 255 || stages < 1 || stages > 3 ||
      (M > CH && CH < 2 * kBinThreads)) {
    return (int)cudaErrorInvalidValue;
  }
  const Plan p = make_plan(tile_bits, CH);
  const int B = bin_blocks(p, M);
  int32_t* list = reinterpret_cast<int32_t*>(scratch);
  int32_t* seg_off = list + (size_t)B * p.R;
  int32_t* seg_cnt = seg_off + (size_t)p.n_tt * B;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (stages & 1) {
    bin_kernel<<<B, kBinThreads, bin_smem(p), s>>>(
        c_st, c_ml, c_mh, c_live, M, fresh, off_out, pend_out, list, seg_off,
        seg_cnt, tile_bits, p.kb);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (stages & 2) {
    insert_kernel<<<p.n_tt, kInsThreads, insert_smem(p, TS, CH), s>>>(
        c_st, c_ml, c_mh, M, t_st, t_ml, t_mh, t_occ, fresh, off_out,
        pend_out, list, seg_off, seg_cnt, B, p.R, p.span, TS, tile_bits,
        CH, probe_limit);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
