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
//      jt_tiled_insert_init) runs sparse_common.cuh's grid_rounds, the
//      whole-table transaction of K3's device layout, over the list.
//      Each block owns a contiguous range of it, and each candidate
//      probes its own key's table (key = index / M, k * T slots in; its
//      claim words k * T words into the scratch). The claim words take
//      the list index: a key's candidates keep their order in the list
//      and only they claim its slots, so the lowest index wins each race
//      as in one key's transaction, and what key k gets is what one
//      key's launch on its own candidates and table gives. Then each
//      candidate writes its fresh flag and offset, and one still probing
//      sets its key's flag.
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

size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

struct Scratch {
  int32_t* counts;       // [list_chunks(K*M)] live flags per chunk
  int32_t* idx;          // [K*M] the live candidates' indices, in order
  int32_t* claim;        // [K*T] claim words
  int32_t* gflags;       // [4] still probing (by round parity), spare
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

template <int L>
__global__ void __launch_bounds__(kGridThreads)
k4_grid_insert(Args a) {
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
  Probe<L> p;
  grid_rounds(cand, tables, s, n_live, p, a.sc.off, a.sc.flags, a.sc.gflags,
              a.probe_limit);
  // each candidate's outcome; one still probing flags its key
  if (s.in_regs) {
    if (s.my < s.hi) {
      const int i = a.sc.idx[s.my];
      a.fresh[i] = (p.fl & kFresh) ? 1 : 0;
      a.off_out[i] = p.off;
      if (p.fl & kPending) a.pend_out[i / a.M] = 1;
    }
  } else {
    for (int li = s.lo + tid; li < s.hi; li += nt) {
      const int i = a.sc.idx[li];
      const uint8_t fl = a.sc.flags[li];
      a.fresh[i] = (fl & kFresh) ? 1 : 0;
      a.off_out[i] = a.sc.off[li];
      if (fl & kPending) a.pend_out[i / a.M] = 1;
    }
  }
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
