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
// Inputs: candidates, L int32 lanes [M] (L = 3: the triple (state,
// mask_lo, mask_hi); L = 1 or 2: the packed word of config_pack), and
// c_live bool [M]; the frontier, L lanes [N]; count int32 [1] (on the
// device, so the host never waits); the table, L lanes [T] and t_occ
// bool [T]. Outputs: the frontier's and the table's lanes, ot_occ [T],
// meta int32 [3]. Scratch: one device buffer (jt_hash_insert_scratch
// bytes). The kernels are templates on L, the hash the lane count's
// (sparse_common.cuh table_hash).
//
// Design. The sharded engine cannot fuse a whole event's closure into one
// kernel, as K2 does: the owner all-to-all runs between the expansion and
// the insert. So K3 is one transaction, three launches on the stream:
//   1. count (one block per 4,096 candidates; sparse_common.cuh's live
//      list): counts the live flags of its chunk, and copies the
//      frontier — and, in the device layout, the table — to the
//      outputs, freeing every claim word;
//   2. compact (same grid): writes the indices of the live candidates, in
//      order, after the live ones of the chunks before it. The exchange
//      buffer is mostly dead rows (buckets have 2x slack, most candidates
//      are illegal), so the probe rounds walk only the live ones;
//   3. insert, over the live list, in one of two layouts:
//      * "shared" ((4L + 5) T + 160 bytes fit the block's opt-in: T <=
//        8,192 on the H100 for the triple, 16,384 for one lane): one
//        block of 1,024 threads, the table, its claim
//        words and occupancy in shared memory, running the round-
//        synchronous insert_pass of sparse_common.cuh (shared with K2)
//        and the append by a block prefix sum. With a few live
//        candidates a transaction (2.0 on average in the small checks)
//        one block is all the work needs;
//      * "device" (larger tables): a cooperative grid of every block the
//        card keeps resident (blocks per SM x SMs, read once per device
//        by jt_hash_insert_init), launched with
//        cudaLaunchCooperativeKernel, the table in the output buffers and
//        the claim words in the scratch. Its probe rounds are
//        sparse_common.cuh's grid_rounds, the whole-table transaction K4
//        runs too: each block owns a contiguous range of the live list;
//        while that leaves each thread at most one candidate, its row,
//        hash and probe state stay in registers (else in the scratch,
//        the row rebuilt each phase); a probe round is phase A,
//        grid.sync(), phase B, grid.sync(), so the table, offsets and
//        winners are the reference's. One block stays the faster
//        insert at the shared layout's sizes (PERF.md). The append:
//        each block counts its fresh winners (a block prefix sum in
//        candidate order), grid.sync(), then takes
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

constexpr int kThreads = 1024;      // the one-block (shared) insert
constexpr int kGridThreads = 1024;  // each block of the grid insert
constexpr int kMaxGrid = 1024;      // blocks of the grid insert, at most
constexpr int kScanWords = 40;
constexpr int kShared = 0, kDevice = 1;  // table layouts
constexpr int kMaxDevices = 64;
// blocks of the grid insert the card keeps resident per SM (the least
// over its row layouts), and its SMs: read by jt_hash_insert_init, per
// device
int g_per_sm[kMaxDevices], g_sms[kMaxDevices];

size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

size_t smem_bytes(int T, int layout, int L) {
  return (layout == kShared ? (4 * (size_t)L + 5) * T : 0) + 4 * kScanWords;
}

struct Scratch {
  int32_t* counts;  // [list_chunks(M)] live flags per chunk
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
  o = align16(o + 4 * (size_t)list_chunks(M));
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

// Three lane pointers; a row of L lanes uses the first L.
struct Lanes {
  int32_t* p[3];
};

struct Args {
  Lanes c;  // candidates [M] (read only)
  const uint8_t* c_live;
  int M;
  Lanes f;  // frontier [N] (read only)
  int N;
  const int32_t* count;
  Lanes t;  // table [T] (read only)
  const uint8_t* t_occ;
  int T;
  Lanes o, ot;  // output frontier [N] and table [T]
  uint8_t* ot_occ;
  int32_t* meta;
  Scratch sc;
  int probe_limit, layout;
};

template <int L>
__device__ __forceinline__ ListCand<L> list_cand(const Args& a) {
  ListCand<L> c;
#pragma unroll
  for (int k = 0; k < L; ++k) c.lane[k] = a.c.p[k];
  c.idx = a.sc.idx;
  return c;
}

template <int L>
__global__ void __launch_bounds__(kListThreads)
k3_count(Args a) {
  __shared__ int scan[kScanWords];
  list_count(a.c_live, a.M, a.sc.counts, scan);
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  for (int i = first; i < a.N; i += stride) {
#pragma unroll
    for (int k = 0; k < L; ++k) a.o.p[k][i] = a.f.p[k][i];
  }
  if (a.layout == kDevice) {
    for (int i = first; i < a.T; i += stride) {
#pragma unroll
      for (int k = 0; k < L; ++k) a.ot.p[k][i] = a.t.p[k][i];
      a.ot_occ[i] = a.t_occ[i];
      a.sc.claim[i] = kClaimFree;
    }
  }
}

__global__ void __launch_bounds__(kListThreads)
k3_compact(Args a) {
  __shared__ int scan[kScanWords];
  list_compact(a.c_live, a.M, a.sc.counts, a.sc.idx, scan);
}

__device__ __forceinline__ void write_meta(const Args& a, int count,
                                           int n_fresh, bool p_ovf) {
  const long long total = (long long)count + n_fresh;
  a.meta[0] = (int32_t)(total < a.N ? total : a.N);
  a.meta[1] = n_fresh;
  a.meta[2] = (p_ovf || total > a.N) ? 1 : 0;
}

// The shared layout: one block, the table in shared memory.
template <int L>
__global__ void __launch_bounds__(kThreads, 1)
k3_insert(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, nt = blockDim.x, T = a.T;
  int* scan = reinterpret_cast<int*>(smem);
  const int n_live = list_total(a.sc.counts, a.M, scan);

  TableView<L> t;
  t.mask = (uint32_t)(T - 1);
  int32_t* w = reinterpret_cast<int32_t*>(smem) + kScanWords;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    t.lane[k] = w;
    w += T;
  }
  t.claim = w; w += T;
  t.occ = reinterpret_cast<uint8_t*>(w);
  for (int i = tid; i < T; i += nt) {
#pragma unroll
    for (int k = 0; k < L; ++k) t.lane[k][i] = a.t.p[k][i];
    t.occ[i] = a.t_occ[i];
    t.claim[i] = kClaimFree;
  }
  __syncthreads();

  const int count = *a.count;
  int32_t* out[L];
#pragma unroll
  for (int k = 0; k < L; ++k) out[k] = a.o.p[k];
  bool p_ovf;
  const int n_fresh =
      insert_pass(list_cand<L>(a), t, a.sc.off, a.sc.flags, scan, n_live,
                  a.probe_limit, out, count, a.N, &p_ovf);

  for (int i = tid; i < T; i += nt) {
#pragma unroll
    for (int k = 0; k < L; ++k) a.ot.p[k][i] = t.lane[k][i];
    a.ot_occ[i] = t.occ[i];
  }
  if (tid == 0) write_meta(a, count, n_fresh, p_ovf);
}

// The one table every candidate of K3's grid probes.
template <int L>
struct OneTable {
  TableView<L> t;
  __device__ __forceinline__ TableView<L> operator()(int) const { return t; }
};

// The device layout: a cooperative grid of co-resident blocks, the table
// in the output buffers (k3_count copied it there and freed the claims).
// While the live list gives each thread at most one candidate (up to
// 270,336 live on the H100's 264 blocks) its row, hash, offset and flags
// stay in registers through every round and the append; past that they
// live in the scratch and each round rebuilds the row.
template <int L>
__global__ void __launch_bounds__(kGridThreads)
k3_grid_insert(Args a) {
  __shared__ int scan[kScanWords];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int b = blockIdx.x, G = gridDim.x;
  int* const pend = a.sc.gflags + 2;  // a probe run exhausted
  const int n_live = list_total(a.sc.counts, a.M, scan);
  const GridSpan s = grid_span(n_live);
  const int lo = s.lo, hi = s.hi;
  const bool in_regs = s.in_regs;
  const ListCand<L> cand = list_cand<L>(a);
  uint8_t* const flags = a.sc.flags;
  OneTable<L> table;
#pragma unroll
  for (int k = 0; k < L; ++k) table.t.lane[k] = a.ot.p[k];
  table.t.claim = a.sc.claim;
  table.t.occ = a.ot_occ;
  table.t.mask = (uint32_t)(a.T - 1);
  Probe<L> p;
  grid_rounds(cand, table, s, n_live, p, a.sc.off, flags, a.sc.gflags,
              a.probe_limit);
  namespace cg = cooperative_groups;
  cg::grid_group grid = cg::this_grid();

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
  int32_t* out[L];
#pragma unroll
  for (int k = 0; k < L; ++k) out[k] = a.o.p[k];
  if (in_regs) {
    if (mine && pos < a.N) store_row<L>(out, pos, p.w);
  } else {
    for (int li = tlo; li < thi; ++li) {
      if (!(flags[li] & kFresh)) continue;
      if (pos < a.N) {
        uint32_t w[L];
        cand(li, w);
        store_row<L>(out, pos, w);
      }
      ++pos;
    }
  }
  if (b == 0 && tid == 0) write_meta(a, count, n_fresh, __ldcg(pend) != 0);
}

template <int L>
cudaError_t setup(int optin, int* per_sm) {
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)k3_insert<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      optin);
  int n = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, k3_grid_insert<L>, kGridThreads, 0);
  }
  if (err == cudaSuccess && n < *per_sm) *per_sm = n;
  return err;
}

template <int L>
cudaError_t launch(const Args& a, int grid_blocks, cudaStream_t s) {
  const int grid = list_chunks(a.M);
  k3_count<L><<<grid, kListThreads, 0, s>>>(a);
  k3_compact<<<grid, kListThreads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (a.layout == kShared) {
    k3_insert<L><<<1, kThreads, smem_bytes(a.T, a.layout, L), s>>>(a);
    return cudaGetLastError();
  }
  Args arg = a;
  void* params[] = {&arg};
  err = cudaLaunchCooperativeKernel((const void*)k3_grid_insert<L>,
                                    dim3(grid_blocks), dim3(kGridThreads),
                                    params, 0, s);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

// Once per device, before the first launch there: lets the one-block
// insert (each of its row layouts) use the block's whole shared-memory
// opt-in, and reads how many blocks of the grid insert the card keeps
// resident per SM (the least over its row layouts) and its SM count
// (jt_hash_insert_grid_shape). Returns the opt-in in bytes (the caller
// picks the layout by it), or minus the cudaError_t.
int jt_hash_insert_init(void) {
  int dev = 0, optin = 0, per_sm = 1 << 30, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev >= kMaxDevices) err = cudaErrorInvalidDevice;
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) err = setup<1>(optin, &per_sm);
  if (err == cudaSuccess) err = setup<2>(optin, &per_sm);
  if (err == cudaSuccess) err = setup<3>(optin, &per_sm);
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

// The insert kernel's dynamic shared memory for a table of T slots of
// `lanes`-lane rows in `layout` (0 shared, 1 device): what
// sparse_kernels.k3_smem_bytes must agree with in the shared layout.
long long jt_hash_insert_smem(int T, int layout, int lanes) {
  return (long long)smem_bytes(T, layout, lanes);
}

// The scratch buffer one launch needs, in bytes.
long long jt_hash_insert_scratch(int M, int T, int layout) {
  return (long long)carve(nullptr, M, T, layout).bytes;
}

// One transaction on `stream` (three kernels; the device layout's third
// a cooperative grid of grid_blocks blocks, all of which the card must
// keep resident), on rows of `lanes` lanes (1-3; the lane pointers past
// them are unused, null). Returns the cudaError_t of the launches
// (cudaErrorInvalidValue for arguments it does not take; a cooperative
// launch the card refuses returns its error and runs nothing).
int jt_hash_insert_launch(const int32_t* c0, const int32_t* c1,
                          const int32_t* c2, const uint8_t* c_live, int M,
                          const int32_t* f0, const int32_t* f1,
                          const int32_t* f2, int N, const int32_t* count,
                          const int32_t* t0, const int32_t* t1,
                          const int32_t* t2, const uint8_t* t_occ, int T,
                          int32_t* o0, int32_t* o1, int32_t* o2,
                          int32_t* ot0, int32_t* ot1, int32_t* ot2,
                          uint8_t* ot_occ, int32_t* meta, void* scratch,
                          int probe_limit, int layout, int grid_blocks,
                          int lanes, void* stream) {
  if (M < 1 || N < 1 || T < 2 || (T & (T - 1)) != 0 || probe_limit < 1 ||
      probe_limit > 255 || (layout != kShared && layout != kDevice) ||
      (layout == kDevice && (grid_blocks < 1 || grid_blocks > kMaxGrid)) ||
      lanes < 1 || lanes > 3) {
    return (int)cudaErrorInvalidValue;
  }
  auto mut = [](const int32_t* p) { return const_cast<int32_t*>(p); };
  const Args a{{{mut(c0), mut(c1), mut(c2)}},
               c_live,
               M,
               {{mut(f0), mut(f1), mut(f2)}},
               N,
               count,
               {{mut(t0), mut(t1), mut(t2)}},
               t_occ,
               T,
               {{o0, o1, o2}},
               {{ot0, ot1, ot2}},
               ot_occ,
               meta,
               carve(scratch, M, T, layout),
               probe_limit,
               layout};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const cudaError_t err = lanes == 1   ? launch<1>(a, grid_blocks, s)
                          : lanes == 2 ? launch<2>(a, grid_blocks, s)
                                       : launch<3>(a, grid_blocks, s);
  return (int)err;
}

}  // extern "C"
