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
//   3. insert (one block of 1,024 threads): the round-synchronous
//      insert_pass of sparse_common.cuh, shared with K2, over the live
//      list, then the append by a block prefix sum. The table, its claim
//      words and occupancy live in shared memory while 17 T + 160 bytes
//      fit the block's opt-in (T <= 8,192 on the H100: the "shared"
//      layout); else in the output buffers in device memory, with the
//      claim words in the scratch (the "device" layout). The probe
//      offsets and flags of the live candidates stay in device memory.
// Compacting keeps the candidates' order, so the claim winners (lowest
// index) and the append order are those of the full buffer.
//
// What bounds it: bytes. The least it must move is the live flags, the
// live candidates' rows, the table in and out and the frontier in and
// out; its operations are a few dozen integer ops per live candidate.
// One block runs every probe round behind barriers on one SM, so it sits
// far above that bound; chip_smoke.py measures both on the card and
// PERF.md keeps the numbers. Later work: more than one SM per
// transaction (a cooperative grid over the live list), TMA bulk copies.
//
// Build: nvcc -gencode=arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC hash_insert.cu   (see kernels/__init__.py)

#include <cstdint>
#include <cuda_runtime.h>

#include "sparse_common.cuh"

namespace {

using namespace jt;

constexpr int kPrepThreads = 256;
constexpr int kFlagsPerThread = 16;
constexpr int kChunk = kPrepThreads * kFlagsPerThread;  // flags per block
constexpr int kThreads = 1024;
constexpr int kScanWords = 40;
constexpr int kShared = 0, kDevice = 1;  // table layouts

size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

__host__ __device__ int n_chunks(int M) { return (M + kChunk - 1) / kChunk; }

size_t smem_bytes(int T, int layout) {
  return (layout == kShared ? 17 * (size_t)T : 0) + 4 * kScanWords;
}

struct Scratch {
  int32_t* counts;  // [n_chunks] live flags per chunk
  int32_t* idx;     // [M] the live candidates' indices, in order
  int32_t* claim;   // [T] claim words (device layout only)
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
  s.claim = nullptr;
  if (layout == kDevice) {
    s.claim = reinterpret_cast<int32_t*>(p + o);
    o = align16(o + 4 * (size_t)T);
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

__global__ void __launch_bounds__(kThreads, 1)
k3_insert(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, nt = blockDim.x, T = a.T;
  int* scan = reinterpret_cast<int*>(smem);
  int part = 0;
  for (int b = tid; b < n_chunks(a.M); b += nt) part += a.sc.counts[b];
  int L;
  block_exclusive_scan(part, scan, &L);

  TableView t;
  t.mask = (uint32_t)(T - 1);
  if (a.layout == kShared) {
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
  } else {
    t.st = a.ot_st;
    t.ml = a.ot_ml;
    t.mh = a.ot_mh;
    t.claim = a.sc.claim;
    t.occ = a.ot_occ;
  }

  const int count = *a.count;
  bool p_ovf;
  const int n_fresh = insert_pass(
      LiveCand{a.c_st, a.c_ml, a.c_mh, a.sc.idx}, t, a.sc.off, a.sc.flags,
      scan, L, a.probe_limit, a.o_st, a.o_ml, a.o_mh, count, a.N, &p_ovf);

  if (a.layout == kShared) {
    for (int i = tid; i < T; i += nt) {
      a.ot_st[i] = t.st[i];
      a.ot_ml[i] = t.ml[i];
      a.ot_mh[i] = t.mh[i];
      a.ot_occ[i] = t.occ[i];
    }
  }
  if (tid == 0) {
    const long long total = (long long)count + n_fresh;
    a.meta[0] = (int32_t)(total < a.N ? total : a.N);
    a.meta[1] = n_fresh;
    a.meta[2] = (p_ovf || total > a.N) ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// Once per device, before the first launch there: lets the insert kernel
// use the block's whole shared-memory opt-in. Returns that opt-in in
// bytes (the caller picks the layout by it), or minus the cudaError_t.
int jt_hash_insert_init(void) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute((const void*)k3_insert,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  }
  return err == cudaSuccess ? optin : -(int)err;
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

// One transaction on `stream` (three kernels). Returns the cudaError_t of
// the launches (cudaErrorInvalidValue for arguments it does not take).
int jt_hash_insert_launch(const int32_t* c_st, const int32_t* c_ml,
                          const int32_t* c_mh, const uint8_t* c_live, int M,
                          const int32_t* f_st, const int32_t* f_ml,
                          const int32_t* f_mh, int N, const int32_t* count,
                          const int32_t* t_st, const int32_t* t_ml,
                          const int32_t* t_mh, const uint8_t* t_occ, int T,
                          int32_t* o_st, int32_t* o_ml, int32_t* o_mh,
                          int32_t* ot_st, int32_t* ot_ml, int32_t* ot_mh,
                          uint8_t* ot_occ, int32_t* meta, void* scratch,
                          int probe_limit, int layout, void* stream) {
  if (M < 1 || N < 1 || T < 2 || (T & (T - 1)) != 0 || probe_limit < 1 ||
      probe_limit > 255 || (layout != kShared && layout != kDevice)) {
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
  k3_insert<<<1, kThreads, smem_bytes(T, layout), s>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
