// K3: one visited-set transaction of the sharded engine, for Hopper.
//
// Replaces jepsen_tpu/parallel/sparse_kernels.py::hash_insert_call (the
// Pallas TPU kernel whose body is engine._hash_insert_append). Per
// closure iteration, each rank of jepsen_tpu_torch.parallel.sharded
// inserts the candidates it received from the owner exchange into its
// own open-addressed visited set and appends the fresh ones to its
// frontier. It computes what
// jepsen_tpu_torch.parallel.sparse._hash_insert_append computes, bit for
// bit — the table's contents and layout, the frontier rows in order, the
// counts and the overflow flag:
//
//   insert  every live candidate probes slots (table_hash + off) & (T-1),
//           off = 0, 1, ... < probe_limit: an equal occupant drops it, a
//           different one advances it, an empty slot is claimed, the
//           lowest candidate index winning a race;
//   append  the winners ("fresh") land after `count` in the frontier, in
//           candidate order; rows past N are dropped;
//   meta    (count2 = min(count + n_fresh, N), n_fresh, ovf = a probe
//           run exhausted or count + n_fresh > N).
//
// Inputs: candidates c_st/c_ml/c_mh int32 [M] and c_live bool [M]; the
// frontier f_* int32 [N]; count int32 [1] (on the device, so the host
// never waits); the table t_st/t_ml/t_mh int32 [T], t_occ bool [T].
// Outputs: o_* [N], ot_* [T], ot_occ [T], meta int32 [3]. Scratch: one
// device buffer (jt_hash_insert_scratch bytes).
//
// Design. The sharded engine cannot fuse a whole event's closure into one
// kernel, as K2 does: the owner all-to-all runs between the expansion and
// the insert. So K3 is one transaction, three launches on the stream:
//   1. count (one block per 4,096 candidates): counts the live flags of
//      its chunk, and copies the frontier — and, in the device layout,
//      the table — to the outputs, freeing every claim word;
//   2. compact (same grid): writes the indices of the live candidates, in
//      order, after the live ones of the chunks before it. The exchange
//      buffer is mostly dead rows (buckets have 2x slack, most candidates
//      are illegal), so the probe rounds walk only the live ones;
//   3. insert, over the live list, in one of two layouts:
//      * "shared" (17 T + 160 bytes fit the block's opt-in: T <= 8,192 on
//        the H100): one block of 1,024 threads, the table, its claim
//        words and occupancy in shared memory, running the round-
//        synchronous insert_pass of sparse_common.cuh (shared with K2)
//        and the append by a block prefix sum. With a few live
//        candidates a transaction (2.0 on average in the small checks)
//        one block is all the work needs;
//      * "device" (larger tables): a cooperative grid of every block the
//        card keeps resident (blocks per SM x SMs, read once per device
//        by jt_hash_insert_init), launched with
//        cudaLaunchCooperativeKernel, the table in the output buffers and
//        the claim words in the scratch. Each block owns a contiguous
//        range of the live list; while that leaves each thread at most
//        one candidate, its row, hash and probe state stay in registers
//        (else in the scratch, the row rebuilt each phase). A probe round
//        is phase A (probe_a), grid.sync(), phase B (probe_b),
//        grid.sync(): every read of a round precedes its writes
//        grid-wide, as in the one-block pass, so the table, offsets and
//        winners are the reference's. One block stays the faster
//        insert at the shared layout's sizes (PERF.md). Whether
//        any candidate is still probing is a grid-wide flag, double-
//        buffered by round parity so that clearing it needs no third
//        barrier. The append: each block counts its fresh winners
//        (a block prefix sum in candidate order), grid.sync(), then takes
//        the sum of the blocks before it and writes its rows after
//        count + that sum, dropping those at or past N; block 0 writes
//        meta. Table words other blocks write are read through L2
//        (ld.global.cg), never from a stale L1 line.
// Compacting keeps the candidates' order, so the claim winners (lowest
// index) and the append order are those of the full buffer.
//
// What bounds it: bytes. The least it must move is the live flags, the
// live candidates' rows, the table in and out and the fresh rows
// appended; its operations are a few dozen integer ops per live
// candidate. The grid spreads the probe rounds of ~10^5 live candidates
// over every SM; what remains is the count and compact launches, two grid
// barriers a round and the L2 latency of each probe, above the bound
// still. chip_smoke.py measures both on the card and PERF.md keeps the
// numbers.
//
// Build: nvcc -gencode=arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC hash_insert.cu   (see kernels/__init__.py)

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "sparse_common.cuh"

namespace {

using namespace jt;

constexpr int kPrepThreads = 256;
constexpr int kFlagsPerThread = 16;
constexpr int kChunk = kPrepThreads * kFlagsPerThread;  // flags per block
constexpr int kThreads = 1024;      // the one-block (shared) insert
constexpr int kGridThreads = 1024;  // each block of the grid insert
constexpr int kMaxGrid = 1024;      // blocks of the grid insert, at most
constexpr int kScanWords = 40;
constexpr int kShared = 0, kDevice = 1;  // table layouts
constexpr int kMaxDevices = 64;
// blocks of the grid insert the card keeps resident per SM, and its SMs:
// read by jt_hash_insert_init, per device
int g_per_sm[kMaxDevices], g_sms[kMaxDevices];

size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

__host__ __device__ int n_chunks(int M) { return (M + kChunk - 1) / kChunk; }

size_t smem_bytes(int T, int layout) {
  return (layout == kShared ? 17 * (size_t)T : 0) + 4 * kScanWords;
}

struct Scratch {
  int32_t* counts;  // [n_chunks] live flags per chunk
  int32_t* idx;     // [M] the live candidates' indices, in order
  int32_t* claim;   // [T] claim words (device layout only)
  int32_t* block_fresh;  // [kMaxGrid] fresh winners per grid block (device)
  int32_t* gflags;  // [4] still probing (by round parity), probe overflow
  uint8_t *off, *flags;  // [M] per live candidate
  size_t bytes;
};

Scratch carve(void* base, int M, int T, int layout) {
  char* p = reinterpret_cast<char*>(base);
  Scratch s;
  size_t o = 0;
  s.counts = reinterpret_cast<int32_t*>(p + o);
  o = align16(o + 4 * (size_t)n_chunks(M));
  s.idx = reinterpret_cast<int32_t*>(p + o);
  o = align16(o + 4 * (size_t)M);
  s.claim = s.block_fresh = s.gflags = nullptr;
  if (layout == kDevice) {
    s.claim = reinterpret_cast<int32_t*>(p + o);
    o = align16(o + 4 * (size_t)T);
    s.block_fresh = reinterpret_cast<int32_t*>(p + o);
    o = align16(o + 4 * (size_t)kMaxGrid);
    s.gflags = reinterpret_cast<int32_t*>(p + o);
    o = align16(o + 4 * 4);
  }
  s.off = reinterpret_cast<uint8_t*>(p + o);
  o = align16(o + (size_t)M);
  s.flags = reinterpret_cast<uint8_t*>(p + o);
  o = align16(o + (size_t)M);
  s.bytes = o;
  return s;
}

struct Args {
  const int32_t *c_st, *c_ml, *c_mh;
  const uint8_t* c_live;
  int M;
  const int32_t *f_st, *f_ml, *f_mh;
  int N;
  const int32_t* count;
  const int32_t *t_st, *t_ml, *t_mh;
  const uint8_t* t_occ;
  int T;
  int32_t *o_st, *o_ml, *o_mh;
  int32_t *ot_st, *ot_ml, *ot_mh;
  uint8_t* ot_occ;
  int32_t* meta;
  Scratch sc;
  int probe_limit, layout;
};

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

__global__ void __launch_bounds__(kPrepThreads)
k3_count(Args a) {
  __shared__ int scan[kScanWords];
  const int i0 = blockIdx.x * kChunk + threadIdx.x * kFlagsPerThread;
  int total;
  block_exclusive_scan(__popc(live_bits(a.c_live, a.M, i0)), scan, &total);
  if (threadIdx.x == 0) a.sc.counts[blockIdx.x] = total;
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  for (int i = first; i < a.N; i += stride) {
    a.o_st[i] = a.f_st[i];
    a.o_ml[i] = a.f_ml[i];
    a.o_mh[i] = a.f_mh[i];
  }
  if (a.layout == kDevice) {
    for (int i = first; i < a.T; i += stride) {
      a.ot_st[i] = a.t_st[i];
      a.ot_ml[i] = a.t_ml[i];
      a.ot_mh[i] = a.t_mh[i];
      a.ot_occ[i] = a.t_occ[i];
      a.sc.claim[i] = kClaimFree;
    }
  }
}

__global__ void __launch_bounds__(kPrepThreads)
k3_compact(Args a) {
  __shared__ int scan[kScanWords];
  int part = 0;
  for (int b = threadIdx.x; b < (int)blockIdx.x; b += blockDim.x) {
    part += a.sc.counts[b];
  }
  int before;
  block_exclusive_scan(part, scan, &before);
  const int i0 = blockIdx.x * kChunk + threadIdx.x * kFlagsPerThread;
  uint32_t bits = live_bits(a.c_live, a.M, i0);
  int total;
  int pos = before + block_exclusive_scan(__popc(bits), scan, &total);
  while (bits) {
    a.sc.idx[pos++] = i0 + __ffs(bits) - 1;
    bits &= bits - 1;
  }
}

// Live candidate li: row idx[li] of the exchange buffer.
struct LiveCand {
  const int32_t *st, *ml, *mh, *idx;
  __device__ __forceinline__ bool operator()(int li, int32_t& s,
                                             uint32_t& l,
                                             uint32_t& h) const {
    const int i = idx[li];
    s = st[i];
    l = (uint32_t)ml[i];
    h = (uint32_t)mh[i];
    return true;
  }
};

// The live candidates: the sum of the chunk counts (every thread of the
// block gets it).
__device__ __forceinline__ int live_total(const Args& a, int* scan) {
  int part = 0;
  for (int b = threadIdx.x; b < n_chunks(a.M); b += blockDim.x) {
    part += a.sc.counts[b];
  }
  int L;
  block_exclusive_scan(part, scan, &L);
  return L;
}

__device__ __forceinline__ void write_meta(const Args& a, int count,
                                           int n_fresh, bool p_ovf) {
  const long long total = (long long)count + n_fresh;
  a.meta[0] = (int32_t)(total < a.N ? total : a.N);
  a.meta[1] = n_fresh;
  a.meta[2] = (p_ovf || total > a.N) ? 1 : 0;
}

// The shared layout: one block, the table in shared memory.
__global__ void __launch_bounds__(kThreads, 1)
k3_insert(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, nt = blockDim.x, T = a.T;
  int* scan = reinterpret_cast<int*>(smem);
  const int L = live_total(a, scan);

  TableView t;
  t.mask = (uint32_t)(T - 1);
  int32_t* w = reinterpret_cast<int32_t*>(smem) + kScanWords;
  t.st = w; w += T;
  t.ml = w; w += T;
  t.mh = w; w += T;
  t.claim = w; w += T;
  t.occ = reinterpret_cast<uint8_t*>(w);
  for (int i = tid; i < T; i += nt) {
    t.st[i] = a.t_st[i];
    t.ml[i] = a.t_ml[i];
    t.mh[i] = a.t_mh[i];
    t.occ[i] = a.t_occ[i];
    t.claim[i] = kClaimFree;
  }
  __syncthreads();

  const int count = *a.count;
  bool p_ovf;
  const int n_fresh = insert_pass(
      LiveCand{a.c_st, a.c_ml, a.c_mh, a.sc.idx}, t, a.sc.off, a.sc.flags,
      scan, L, a.probe_limit, a.o_st, a.o_ml, a.o_mh, count, a.N, &p_ovf);

  for (int i = tid; i < T; i += nt) {
    a.ot_st[i] = t.st[i];
    a.ot_ml[i] = t.ml[i];
    a.ot_mh[i] = t.mh[i];
    a.ot_occ[i] = t.occ[i];
  }
  if (tid == 0) write_meta(a, count, n_fresh, p_ovf);
}

// The device layout: a cooperative grid of co-resident blocks, the table
// in the output buffers (k3_count copied it there and freed the claims).
// While the live list gives each thread at most one candidate (up to
// 270,336 live on the H100's 264 blocks) its row, hash, offset and flags
// stay in registers through every round and the append; past that they
// live in the scratch and each round rebuilds the row.
__global__ void __launch_bounds__(kGridThreads)
k3_grid_insert(Args a) {
  namespace cg = cooperative_groups;
  cg::grid_group grid = cg::this_grid();
  __shared__ int scan[kScanWords];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int b = blockIdx.x, G = gridDim.x;
  int* const active = a.sc.gflags;    // [2], by round parity
  int* const pend = a.sc.gflags + 2;  // a probe run exhausted
  const int L = live_total(a, scan);
  // this block's contiguous range of the live list, in order
  const int per = (L + G - 1) / G;
  const int lo = min(L, b * per), hi = min(L, lo + per);
  const bool in_regs = per <= nt;  // the same in every block
  const LiveCand cand{a.c_st, a.c_ml, a.c_mh, a.sc.idx};
  TableView t{a.ot_st, a.ot_ml, a.ot_mh, a.sc.claim, a.ot_occ,
              (uint32_t)(a.T - 1)};
  uint8_t* const off = a.sc.off;
  uint8_t* const flags = a.sc.flags;
  const int pl = a.probe_limit;

  const int my = lo + tid;  // this thread's candidate, in_regs
  Probe p;
  p.off = 0;
  p.fl = 0;
  if (in_regs) {
    if (my < hi) {
      int32_t st;
      uint32_t ml, mh;
      cand(my, st, ml, mh);
      set_row(p, st, ml, mh);
      p.fl = kPending;  // every compacted candidate is live
    }
  } else {
    for (int li = lo + tid; li < hi; li += nt) {
      flags[li] = kPending;
      off[li] = 0;
    }
  }
  if (b == 0 && tid == 0) {
    active[0] = active[1] = 0;
    *pend = 0;
  }
  grid.sync();
  for (int round = 0, go = L > 0; go; ++round) {
    if (in_regs) {
      probe_a<L2Loads>(p, t, my, pl);
    } else {
      for (int li = lo + tid; li < hi; li += nt) {
        probe_read<L2Loads>(cand, t, off, flags, li, pl);
      }
    }
    grid.sync();
    int local = 0;
    if (in_regs) {
      local = probe_b<L2Loads>(p, t, my, pl);
    } else {
      for (int li = lo + tid; li < hi; li += nt) {
        local |= claim_settle<L2Loads>(cand, t, off, flags, li, pl);
      }
    }
    // the other parity's flag was last read before the barrier above;
    // it is set again only after the barrier below
    if (b == 0 && tid == 0) active[(round + 1) & 1] = 0;
    if (__syncthreads_or(local) && tid == 0) {
      atomicOr(&active[round & 1], 1);
    }
    grid.sync();
    go = __ldcg(&active[round & 1]);
  }

  // append: this block's fresh winners in candidate order, after the
  // blocks before it (in_regs: thread order is candidate order)
  const int pp = (hi - lo + nt - 1) / nt;
  const int tlo = min(hi, lo + tid * pp), thi = min(hi, tlo + pp);
  int mine = 0, pending = 0;
  if (in_regs) {
    mine = (p.fl & kFresh) != 0;
    pending = (p.fl & kPending) != 0;
  } else {
    for (int li = tlo; li < thi; ++li) {
      mine += (flags[li] & kFresh) != 0;
      pending |= (flags[li] & kPending) != 0;
    }
  }
  int block_total;
  const int within = block_exclusive_scan(mine, scan, &block_total);
  if (__syncthreads_or(pending) && tid == 0) atomicOr(pend, 1);
  if (tid == 0) a.sc.block_fresh[b] = block_total;
  grid.sync();
  int before_part = 0, all_part = 0;
  for (int q = tid; q < G; q += nt) {
    const int v = __ldcg(&a.sc.block_fresh[q]);
    all_part += v;
    if (q < b) before_part += v;
  }
  int before, n_fresh;
  block_exclusive_scan(before_part, scan, &before);
  block_exclusive_scan(all_part, scan, &n_fresh);
  const int count = *a.count;
  int pos = count + before + within;
  if (in_regs) {
    if (mine && pos < a.N) {
      a.o_st[pos] = p.st;
      a.o_ml[pos] = (int32_t)p.ml;
      a.o_mh[pos] = (int32_t)p.mh;
    }
  } else {
    for (int li = tlo; li < thi; ++li) {
      if (!(flags[li] & kFresh)) continue;
      if (pos < a.N) {
        int32_t st;
        uint32_t ml, mh;
        cand(li, st, ml, mh);
        a.o_st[pos] = st;
        a.o_ml[pos] = (int32_t)ml;
        a.o_mh[pos] = (int32_t)mh;
      }
      ++pos;
    }
  }
  if (b == 0 && tid == 0) write_meta(a, count, n_fresh, __ldcg(pend) != 0);
}

}  // namespace

extern "C" {

// Once per device, before the first launch there: lets the one-block
// insert use the block's whole shared-memory opt-in, and reads how many
// blocks of the grid insert the card keeps resident per SM and its SM
// count (jt_hash_insert_grid_shape). Returns the opt-in in bytes (the
// caller picks the layout by it), or minus the cudaError_t.
int jt_hash_insert_init(void) {
  int dev = 0, optin = 0, per_sm = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev >= kMaxDevices) err = cudaErrorInvalidDevice;
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute((const void*)k3_insert,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, k3_grid_insert, kGridThreads, 0);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return -(int)err;
  g_per_sm[dev] = per_sm;
  g_sms[dev] = sms;
  return optin;
}

// What jt_hash_insert_init read on the current device: blocks of the
// grid insert resident per SM, and SMs. Returns 0, or the cudaError_t
// (cudaErrorInitializationError before jt_hash_insert_init ran there).
int jt_hash_insert_grid_shape(int* per_sm, int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || g_sms[dev] == 0) {
    return (int)cudaErrorInitializationError;
  }
  *per_sm = g_per_sm[dev];
  *sms = g_sms[dev];
  return 0;
}

// The insert kernel's dynamic shared memory for a table of T slots in
// `layout` (0 shared, 1 device): what sparse_kernels.k3_smem_bytes must
// agree with in the shared layout.
long long jt_hash_insert_smem(int T, int layout) {
  return (long long)smem_bytes(T, layout);
}

// The scratch buffer one launch needs, in bytes.
long long jt_hash_insert_scratch(int M, int T, int layout) {
  return (long long)carve(nullptr, M, T, layout).bytes;
}

// One transaction on `stream` (three kernels; the device layout's third
// a cooperative grid of grid_blocks blocks, all of which the card must
// keep resident). Returns the cudaError_t of the launches
// (cudaErrorInvalidValue for arguments it does not take; a cooperative
// launch the card refuses returns its error and runs nothing).
int jt_hash_insert_launch(const int32_t* c_st, const int32_t* c_ml,
                          const int32_t* c_mh, const uint8_t* c_live, int M,
                          const int32_t* f_st, const int32_t* f_ml,
                          const int32_t* f_mh, int N, const int32_t* count,
                          const int32_t* t_st, const int32_t* t_ml,
                          const int32_t* t_mh, const uint8_t* t_occ, int T,
                          int32_t* o_st, int32_t* o_ml, int32_t* o_mh,
                          int32_t* ot_st, int32_t* ot_ml, int32_t* ot_mh,
                          uint8_t* ot_occ, int32_t* meta, void* scratch,
                          int probe_limit, int layout, int grid_blocks,
                          void* stream) {
  if (M < 1 || N < 1 || T < 2 || (T & (T - 1)) != 0 || probe_limit < 1 ||
      probe_limit > 255 || (layout != kShared && layout != kDevice) ||
      (layout == kDevice && (grid_blocks < 1 || grid_blocks > kMaxGrid))) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{c_st,  c_ml,  c_mh,  c_live, M,     f_st,  f_ml,   f_mh,
         N,     count, t_st,  t_ml,   t_mh,  t_occ, T,      o_st,
         o_ml,  o_mh,  ot_st, ot_ml,  ot_mh, ot_occ, meta,
         carve(scratch, M, T, layout), probe_limit, layout};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int grid = n_chunks(M);
  k3_count<<<grid, kPrepThreads, 0, s>>>(a);
  k3_compact<<<grid, kPrepThreads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (layout == kShared) {
    k3_insert<<<1, kThreads, smem_bytes(T, layout), s>>>(a);
    return (int)cudaGetLastError();
  }
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)k3_grid_insert,
                                    dim3(grid_blocks), dim3(kGridThreads),
                                    params, 0, s);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
