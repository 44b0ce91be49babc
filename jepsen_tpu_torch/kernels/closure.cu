// Closure fixpoint of the bit-packed linearizability engine, for Hopper.
//
// Replaces jepsen_tpu/parallel/pallas_kernels.py::_closure_kernel (the
// Pallas TPU kernel behind bitdense's per-return-event closure). For one
// return event it takes
//
//   sel [C, S, S] int32   FULL (-1) where slot j may step state s -> t
//   B   [S, W]    int32   reachable set: bit b of word w = mask w*32 + b,
//                         W = max(1, 2^C / 32)
//
// and computes the least B' >= B closed under "for every (s, m) in B' and
// every slot j not in m with sel[j, s, t], (t, m | 1 << j) is in B'".
//
// Three layouts, chosen by the caller (closure_kernels.closure_plan, a
// pure function of S, C, the block's shared-memory opt-in and the largest
// cluster the card grants, both read once per device by jt_closure_init):
//
//   "cluster"  a thread-block cluster of k = 2..16 blocks (launched with
//              cudaLaunchKernelEx and a cluster dimension): block r owns
//              words [r*Wb, (r+1)*Wb) of every state t, Wb = W / k, in
//              its own shared memory. A slot j < 5 moves bits inside a
//              word; a slot j >= 5 moves whole words from w ^ 2^(j-5),
//              which lies in the block itself while 2^(j-5) < Wb, and
//              otherwise at the same offset in block r ^ (2^(j-5) / Wb),
//              read through distributed shared memory
//              (cluster.map_shared_rank). Both smoke shapes take it:
//              S=18 C=13 (18 KB of B, 8 blocks) and S=22 C=17 (360 KB,
//              16 blocks, past one block's 227 KB);
//   "shared"   the same kernel as a single block (k = 1), for shapes too
//              narrow to split (C <= 9: W <= 16 words);
//   "global"   one block updating B in device memory (the 50 MB L2 keeps
//              it resident), for shapes past the cluster's combined
//              shared memory.
//
// The split kernel (cluster and shared):
//   * sel is repacked into per-(j, t) bitmasks over the source states s,
//     one warp per mask word (a ballot over 32 sources), and then into a
//     list of the (j, t) pairs with a source, each with its items: the
//     target words (t, w) of this block that slot j can set (all Wb for
//     j < 5; the Wb/2 with bit j-5 set while the partner is local; all
//     Wb or none for a remote partner, by bit (j-5) - log2(Wb) of r).
//   * A sweep hands the items round the threads: item (j, t, w) ORs the
//     partner words of its sources (four loads in flight at a time) and,
//     for j < 5, shifts them; if that adds a bit to B[t][w], it sets it
//     with atomicOr. Items, not target words, are the unit because a
//     write step makes every state a source of one target: a thread
//     owning word (t, w) for all j would read S words a slot for that t
//     while the threads of the other states idled.
//   * Updates are in place (Gauss-Seidel), across blocks too. The closure
//     is monotone, so a read that sees an older or a newer word only
//     changes how many sweeps it takes, never the fixpoint: every bit
//     added is in the least fixpoint, and a sweep in which no block
//     added a bit read a B that did not change, so B is closed. Each
//     sweep ends with every block's "added a bit" stored into every
//     block's shared flags (double-buffered by the parity of the
//     cluster's exchanges, `cluster_sum`) and a cluster.sync(); all
//     blocks then read the same flags and leave together. That sync is
//     the last remote access: no block exits while another can still
//     read its shared memory. The first remote read comes after a
//     cluster.sync() that follows every block's load.
//   * An optional device-side run flag (the scan's `ok`) makes the kernel
//     a copy once the history has failed, so the host never waits for it.
//
// The batched scan (jt_closure_scan_launch; replaces the vmap of the
// per-key scan in jepsen_tpu/parallel/bitdense.py::_check_bitdense_batch,
// one launch for a chunk of event rows of K keys): sel [E, K, C, S, S]
// (event-major, as the host builds it), the carry B [K, S, W], ok [K],
// fail_r [K] (updated in place), the rows' returning slots slot [E, K]
// and run flags real [E, K], and optionally the stats trajectory
// traj [K, R, 2]. Each key is one block ("shared") or one cluster
// ("cluster"), chosen for the batch (closure_kernels.closure_plan_batch),
// or one block on device memory ("global"), and walks every row of the
// chunk with its share of B resident in shared memory, so B is read and
// written once a chunk and the host issues nothing per row. For each row
// r the key runs while ok and real[r]: the closure's sweeps as above, the
// filter on its returning slot j (keep the masks with bit j set, bit j
// cleared: an intra-word shift for j < 5, the word w | 2^(j-5) moved into
// w and w | 2^(j-5) cleared for j >= 5), and the failure test (no bit
// left: fail_r = r, ok = false; the key stops walking). The filtered set
// is the next row's B.
//   * The filter writes into the other half of a double buffer: for
//     2^(j-5) >= Wb the pair straddles two blocks of the cluster, and a
//     block must not clear a word its partner has yet to read. The
//     failure test is a cluster-wide count through the same exchange as
//     the sweeps' flags, whose cluster.sync() also ends every remote
//     read of the old buffer before any block writes into it again.
//   * A row's sweeps hand out kScanGroup items of one pair to a thread at
//     a time (the pair's lookup and source bits walked once for them).
//   * With stats each row writes its width (the popcount of the filtered
//     set, -1 where the key did not run) and -1 iterations (the count
//     never leaves the kernel), as the reference's Pallas path reports.
//   * In the "global" layout the filter runs in place in device memory,
//     a pair (w, w | 2^(j-5)) to one thread, between block barriers.
//
// What bounds it: the bytes it must move (sel and B read once, B' written
// once: 54 KB at S=18 C=13, 754 KB at S=22 C=17; the scan's chunk: its
// sel once and B twice, 22 MB at K=84 S=6 C=15 over 99 rows). What is
// left above that bound is the launch, the round trips to device memory
// for sel and B, the pair list, and about three sweeps with a cluster
// barrier each (the scan: a row's pair list, sweeps and filter, one after
// another, for the slowest key). chip_smoke.py measures both against the
// bound on the card; PERF.md keeps the numbers.
//
// Build: nvcc -gencode=arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC closure.cu   (see kernels/__init__.py)

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "sparse_common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxThreads = 1024;
constexpr int kMaxCluster = 16;
constexpr int kScanWords = 40;
constexpr int kMaxDevices = 64;
// items of one pair a thread takes at a time in the batched scan's sweeps
constexpr int kScanGroup = 2;
// the largest cluster of the split kernel the card runs, per device
// (jt_closure_init)
int g_max_cluster[kMaxDevices];

// positions p in a 32-bit word whose mask bit j (j < 5) is clear
__constant__ uint32_t kIntraClear[5] = {
    0x55555555u, 0x33333333u, 0x0F0F0F0Fu, 0x00FF00FFu, 0x0000FFFFu};

// The split kernel's shared memory, in order: `nbuf` buffers of B's block
// [S][Wb] (the batched scan's filter writes into a second), the source
// masks [C][S][SW], the pair list's item offsets [C*S + 1] and pair
// entries [C*S] (uint16), the sweep flags [2][kMaxCluster] and the scan
// words. closure_kernels.k1_block_bytes must agree.
struct SplitSmem {
  size_t src, pstart, pe, flags, scan, bytes;
};

__host__ __device__ SplitSmem split_smem(int S, int C, int Wb, int nbuf) {
  const int SW = (S + 31) / 32;
  SplitSmem m;
  size_t o = (size_t)nbuf * S * Wb * 4;
  m.src = o;
  o += (size_t)C * S * SW * 4;
  m.pstart = o;
  o += ((size_t)C * S + 1) * 4;
  m.pe = o;
  o = (o + (size_t)C * S * 2 + 15) & ~(size_t)15;
  m.flags = o;
  o += 2 * kMaxCluster * 4;
  m.scan = o;
  o += kScanWords * 4;
  m.bytes = o;
  return m;
}

// The sum over the cluster of v (the same in every thread of a block):
// every block's v into every block's flags of this exchange's parity and
// a cluster.sync(). The next write to those flags comes two exchanges
// later, after a cluster.sync() that no block reaches before reading
// them. One block alone: v.
template <bool kCluster>
__device__ __forceinline__ int cluster_sum(int v, int* flags, int& phase,
                                           int r, int k) {
  if constexpr (kCluster) {
    cg::cluster_group cluster = cg::this_cluster();
    int* f = flags + (phase & 1) * kMaxCluster;
    ++phase;
    if ((int)threadIdx.x < k) *cluster.map_shared_rank(f + r, threadIdx.x) = v;
    cluster.sync();
    int sum = 0;
    for (int q = 0; q < k; ++q) sum += f[q];
    return sum;
  } else {
    return v;
  }
}

// Repack one event's selects sel [C][S][S] (device or shared memory):
// mask word (j, t, k) holds bit s - 32k for every source s in [32k,
// 32k + 32) with sel[j, s, t]; one warp per word, four in flight per
// lane. The caller syncs the block before reading src.
__device__ __forceinline__ void repack_sel(const int32_t* sel, uint32_t* src,
                                           int S, int C) {
  const int tid = threadIdx.x;
  const int SW = (S + 31) >> 5;
  const int lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
  const int n_out = C * S * SW;
  for (int o0 = warp * 4; o0 < n_out; o0 += n_warps * 4) {
    bool v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int o = o0 + q;
      const int k = o % SW, t = (o / SW) % S, j = o / (SW * S);
      const int s = k * 32 + lane;
      v[q] = o < n_out && s < S && sel[((size_t)j * S + s) * S + t] != 0;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t m = __ballot_sync(0xffffffffu, v[q]);
      if (lane == 0 && o0 + q < n_out) src[o0 + q] = m;
    }
  }
}

// The pair list of block r: entry e = j*S + t, in order, with its items
// here. Returns the items; the block is synced on return.
__device__ __forceinline__ int build_pairs(const uint32_t* src, int* pstart,
                                           uint16_t* pe, int* scan, int S,
                                           int C, int log_wb, int r) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int SW = (S + 31) >> 5;
  const int CS = C * S;
  const int Wb = 1 << log_wb;
  int n_pairs, n_items;
  const int per = (CS + nt - 1) / nt;
  const int lo = min(CS, tid * per), hi = min(CS, lo + per);
  auto items = [&](int e) -> int {
    const int j = e / S, t = e % S;
    uint32_t any = 0;
    for (int k = 0; k < SW; ++k) any |= src[(j * S + t) * SW + k];
    if (!any) return 0;
    if (j < 5) return Wb;
    const int b = j - 5;
    if (b < log_wb) return Wb >> 1;
    return ((r >> (b - log_wb)) & 1) ? Wb : 0;
  };
  int mine = 0, n_mine = 0;
  for (int e = lo; e < hi; ++e) {
    const int n = items(e);
    mine += n;
    n_mine += n > 0;
  }
  int at = jt::block_exclusive_scan(mine, scan, &n_items);
  int pi = jt::block_exclusive_scan(n_mine, scan, &n_pairs);
  for (int e = lo; e < hi; ++e) {
    const int n = items(e);
    if (n == 0) continue;
    pstart[pi] = at;
    pe[pi] = (uint16_t)e;
    ++pi;
    at += n;
  }
  if (tid == 0) pstart[n_pairs] = n_items;
  __syncthreads();
  return n_items;
}

// Sweeps of the split kernel over this block's words B [S][Wb] until no
// block of the cluster adds a bit (the closure fixpoint, see the top). A
// thread takes V items of one pair at a time (every pair's items are a
// multiple of V: the caller checks Wb >= 2V): the pair's lookup and its
// sources' bits are walked once for V target words, whose loads are in
// flight together. V = 1 is the single-key kernel's sweep, four sources'
// loads in flight.
template <bool kCluster, int V>
__device__ __forceinline__ void sweep_split(uint32_t* B, const uint32_t* src,
                                            const int* pstart,
                                            const uint16_t* pe, int* flags,
                                            int n_items, int S, int log_wb,
                                            int r, int k, int& phase) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int Wb = 1 << log_wb;
  const int SW = (S + 31) >> 5;
  for (int sweep = 0;; ++sweep) {
    int changed = 0;
    int p = 0;
    for (int x = tid * V; x < n_items; x += nt * V) {
      while (pstart[p + 1] <= x) ++p;
      const int e = pe[p];
      const int j = e / S, t = e % S;
      const int y = x - pstart[p];
      const uint32_t* Bs = B;  // where the sources' words live
      if constexpr (V == 1) {
        int wl, swl;
        if (j < 5) {
          wl = swl = y;
        } else if (j - 5 < log_wb) {
          const int b = j - 5;
          wl = ((y >> b) << (b + 1)) | (1 << b) | (y & ((1 << b) - 1));
          swl = wl ^ (1 << b);
        } else {
          wl = swl = y;
          if constexpr (kCluster) {
            Bs = cg::this_cluster().map_shared_rank(
                B, r ^ (1 << (j - 5 - log_wb)));
          }
        }
        const uint32_t* m = src + (j * S + t) * SW;
        uint32_t g = 0;
        for (int kk = 0; kk < SW; ++kk) {
          // four sources' words a step, their loads in flight together
          // (a remote word costs a round trip through the cluster); a
          // source taken twice where fewer are left is read twice,
          // harmlessly
          const uint32_t* col = Bs + (kk * 32) * Wb + swl;
          uint32_t bits = m[kk];
          while (bits) {
            int s[4];
            s[0] = __ffs(bits) - 1;
            bits &= bits - 1;
#pragma unroll
            for (int q = 1; q < 4; ++q) {
              s[q] = bits ? __ffs(bits) - 1 : s[0];
              bits &= bits - 1;
            }
            g |= col[s[0] * Wb] | col[s[1] * Wb] | col[s[2] * Wb] |
                 col[s[3] * Wb];
          }
        }
        if (j < 5) g = (g & kIntraClear[j]) << (1 << j);
        uint32_t* dst = B + t * Wb + wl;
        if (g & ~*dst) {
          atomicOr(dst, g);
          changed = 1;
        }
      } else {
        if constexpr (kCluster) {
          if (j >= 5 && j - 5 >= log_wb) {
            Bs = cg::this_cluster().map_shared_rank(
                B, r ^ (1 << (j - 5 - log_wb)));
          }
        }
        const uint32_t* m = src + (j * S + t) * SW;
        int wl[V], swl[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int yy = y + v;
          if (j < 5 || j - 5 >= log_wb) {
            wl[v] = swl[v] = yy;
          } else {
            const int b = j - 5;
            wl[v] = ((yy >> b) << (b + 1)) | (1 << b) | (yy & ((1 << b) - 1));
            swl[v] = wl[v] ^ (1 << b);
          }
        }
        uint32_t g[V];
#pragma unroll
        for (int v = 0; v < V; ++v) g[v] = 0;
        for (int kk = 0; kk < SW; ++kk) {
          uint32_t bits = m[kk];
          while (bits) {
            const uint32_t* col = Bs + (kk * 32 + __ffs(bits) - 1) * Wb;
            bits &= bits - 1;
#pragma unroll
            for (int v = 0; v < V; ++v) g[v] |= col[swl[v]];
          }
        }
#pragma unroll
        for (int v = 0; v < V; ++v) {
          uint32_t gv = g[v];
          if (j < 5) gv = (gv & kIntraClear[j]) << (1 << j);
          uint32_t* dst = B + t * Wb + wl[v];
          if (gv & ~*dst) {
            atomicOr(dst, gv);
            changed = 1;
          }
        }
      }
    }
    changed = __syncthreads_or(changed);
    // the same sum in every block: all leave here together
    if (!cluster_sum<kCluster>(changed, flags, phase, r, k)) break;
  }
}

template <bool kCluster>
__global__ void __launch_bounds__(kMaxThreads)
closure_split(const int32_t* __restrict__ sel, const int32_t* b_in,
              int32_t* b_out, const unsigned char* __restrict__ run, int S,
              int C, int log_w, int log_wb) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  int r = 0, k = 1;  // this block's rank in its cluster, the cluster size
  if constexpr (kCluster) {
    r = (int)cg::this_cluster().block_rank();
    k = (int)cg::this_cluster().num_blocks();
  }
  const int Wb = 1 << log_wb;
  const int nb = S * Wb;  // the words this block owns
  const SplitSmem lay = split_smem(S, C, Wb, 1);
  uint32_t* B = reinterpret_cast<uint32_t*>(smem);
  uint32_t* src = reinterpret_cast<uint32_t*>(smem + lay.src);
  int* pstart = reinterpret_cast<int*>(smem + lay.pstart);
  uint16_t* pe = reinterpret_cast<uint16_t*>(smem + lay.pe);
  int* flags = reinterpret_cast<int*>(smem + lay.flags);
  int* scan = reinterpret_cast<int*>(smem + lay.scan);
  const uint32_t* bin = reinterpret_cast<const uint32_t*>(b_in);
  uint32_t* bout = reinterpret_cast<uint32_t*>(b_out);
  const size_t base = (size_t)r * Wb;  // this block's first word of a state

  if (run != nullptr && *run == 0) {
    // the history already failed: B' is B. Uniform over the cluster, and
    // no block touches another's shared memory, so no barrier.
    if (b_in != b_out) {
      for (int i = tid; i < nb; i += nt) {
        const size_t g = ((size_t)(i >> log_wb) << log_w) + base +
                         (i & (Wb - 1));
        bout[g] = bin[g];
      }
    }
    return;
  }

  for (int i = tid; i < nb; i += nt) {
    B[i] = bin[((size_t)(i >> log_wb) << log_w) + base + (i & (Wb - 1))];
  }
  repack_sel(sel, src, S, C);
  __syncthreads();
  const int n_items = build_pairs(src, pstart, pe, scan, S, C, log_wb, r);
  if constexpr (kCluster) cg::this_cluster().sync();  // all B loaded
  int phase = 0;
  sweep_split<kCluster, 1>(B, src, pstart, pe, flags, n_items, S, log_wb, r,
                           k, phase);

  for (int i = tid; i < nb; i += nt) {
    bout[((size_t)(i >> log_wb) << log_w) + base + (i & (Wb - 1))] = B[i];
  }
}

// The filter of the split scan on slot j: this block's words of the
// filtered set into nxt, read from cur (the partner word's block's cur
// for 2^(j-5) >= Wb). Returns this thread's share of the set's popcount
// (`count`) or of its non-zero words.
template <bool kCluster>
__device__ __forceinline__ int filter_split(const uint32_t* cur,
                                           uint32_t* nxt, int j, int S,
                                           int log_wb, int r, bool count) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int Wb = 1 << log_wb;
  const int nb = S * Wb;
  const uint32_t* part = cur;  // where the partner words live
  int off = 0;                 // a local partner: word wl | off
  bool zero = false;           // every word of this block has bit j set
  if (j >= 5) {
    const int b = j - 5;
    if (b < log_wb) {
      off = 1 << b;
    } else if ((r >> (b - log_wb)) & 1) {
      zero = true;
    } else if constexpr (kCluster) {
      part = cg::this_cluster().map_shared_rank(cur, r | (1 << (b - log_wb)));
    }
  }
  int acc = 0;
  for (int x = tid; x < nb; x += nt) {
    uint32_t v;
    if (j < 5) {
      v = (cur[x] >> (1 << j)) & kIntraClear[j];
    } else {
      v = (zero || (x & off)) ? 0u : part[x | off];
    }
    nxt[x] = v;
    acc += count ? __popc(v) : (v != 0);
  }
  return acc;
}

// The batched scan, one block or one cluster a key (see the top).
template <bool kCluster>
__global__ void __launch_bounds__(kMaxThreads)
closure_scan_split(const int32_t* __restrict__ sel, int32_t* b,
                   unsigned char* ok, int32_t* fail_r,
                   const int32_t* __restrict__ slot,
                   const unsigned char* __restrict__ real, int32_t* traj,
                   int E, int K, int r0, int R, int S, int C, int log_w,
                   int log_wb) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  int r = 0, k = 1;  // this block's rank in its cluster, the cluster size
  if constexpr (kCluster) {
    r = (int)cg::this_cluster().block_rank();
    k = (int)cg::this_cluster().num_blocks();
  }
  const int key = blockIdx.x / k;
  const int Wb = 1 << log_wb;
  const int nb = S * Wb;  // the words this block owns
  const int CSS = C * S * S;
  const SplitSmem lay = split_smem(S, C, Wb, 2);
  uint32_t* cur = reinterpret_cast<uint32_t*>(smem);
  uint32_t* nxt = cur + nb;
  uint32_t* src = reinterpret_cast<uint32_t*>(smem + lay.src);
  int* pstart = reinterpret_cast<int*>(smem + lay.pstart);
  uint16_t* pe = reinterpret_cast<uint16_t*>(smem + lay.pe);
  int* flags = reinterpret_cast<int*>(smem + lay.flags);
  int* scan = reinterpret_cast<int*>(smem + lay.scan);
  uint32_t* g = reinterpret_cast<uint32_t*>(b) + ((size_t)key * S << log_w);
  const size_t base = (size_t)r * Wb;  // this block's first word of a state
  const int32_t* sel_k = sel + (size_t)key * CSS;  // row i: + i * K * CSS
  const size_t row = (size_t)K * CSS;
  int32_t* tr = traj == nullptr ? nullptr : traj + ((size_t)key * R + r0) * 2;

  // every block of the key reads the same ok: uniform over the cluster
  bool alive = ok[key] != 0;
  int i = 0;
  if (alive) {
    int fr = fail_r[key];
    for (int x = tid; x < nb; x += nt) {
      cur[x] = g[((size_t)(x >> log_wb) << log_w) + base + (x & (Wb - 1))];
    }
    __syncthreads();
    if constexpr (kCluster) cg::this_cluster().sync();  // all B loaded
    int phase = 0;
    for (; i < E && alive; ++i) {
      if (!real[(size_t)i * K + key]) {
        if (tr != nullptr && r == 0 && tid == 0) tr[2 * i] = tr[2 * i + 1] = -1;
        continue;
      }
      repack_sel(sel_k + i * row, src, S, C);
      __syncthreads();
      const int n_items = build_pairs(src, pstart, pe, scan, S, C, log_wb, r);
      if (Wb >= 2 * kScanGroup) {
        sweep_split<kCluster, kScanGroup>(cur, src, pstart, pe, flags,
                                          n_items, S, log_wb, r, k, phase);
      } else {
        sweep_split<kCluster, 1>(cur, src, pstart, pe, flags, n_items, S,
                                 log_wb, r, k, phase);
      }
      const int acc = filter_split<kCluster>(
          cur, nxt, slot[(size_t)i * K + key], S, log_wb, r, tr != nullptr);
      int n_left;
      if (tr != nullptr) {
        jt::block_exclusive_scan(acc, scan, &n_left);
      } else {
        n_left = __syncthreads_or(acc);
      }
      // every block's filter has read the old buffers once this returns
      n_left = cluster_sum<kCluster>(n_left, flags, phase, r, k);
      if (tr != nullptr && r == 0 && tid == 0) {
        tr[2 * i] = n_left;
        tr[2 * i + 1] = -1;
      }
      uint32_t* t = cur;
      cur = nxt;
      nxt = t;
      if (n_left == 0) {  // the key fails at this row and stops walking
        alive = false;
        fr = r0 + i;
      }
    }
    for (int x = tid; x < nb; x += nt) {
      g[((size_t)(x >> log_wb) << log_w) + base + (x & (Wb - 1))] = cur[x];
    }
    if (r == 0 && tid == 0) {
      ok[key] = alive;
      fail_r[key] = fr;
    }
  }
  // the rows this key did not walk (after its failure, or all of them)
  if (tr != nullptr && r == 0) {
    for (int q = i + tid; q < E; q += nt) tr[2 * q] = tr[2 * q + 1] = -1;
  }
}

// The "global" layout's pieces: the source masks src [C][S(t)][SW] (bit
// s set iff sel[j][s][t] != 0) built by atomics in shared memory, and
// sweeps over B in device memory in which each thread owns target words
// (t, w) and ORs into them every contribution of every slot, until no
// thread adds a bit. Both leave the block synced.
__device__ __forceinline__ void global_masks(const int32_t* sel,
                                             uint32_t* src, int S, int C) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int SW = (S + 31) >> 5;
  for (int i = tid; i < C * S * SW; i += nt) src[i] = 0;
  __syncthreads();
  const int SS = S * S;
  for (int i = tid; i < C * SS; i += nt) {
    if (sel[i] != 0) {
      const int t = i % S;
      const int s = (i / S) % S;
      const int j = i / SS;
      atomicOr(&src[((size_t)j * S + t) * SW + (s >> 5)], 1u << (s & 31));
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void global_sweeps(uint32_t* B,
                                              const uint32_t* src, int S,
                                              int C, int log_w) {
  const int W = 1 << log_w;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int n = S * W;
  const int SW = (S + 31) >> 5;
  int changed;
  do {
    changed = 0;
    for (int i = tid; i < n; i += nt) {
      const int t = i >> log_w;
      const int w = i & (W - 1);
      uint32_t acc = B[i];
      const uint32_t orig = acc;
      for (int j = 0; j < C; ++j) {
        int sw = w;
        if (j >= 5) {
          const int jb = 1 << (j - 5);
          if ((w & jb) == 0) continue;  // target words have mask bit j set
          sw = w ^ jb;
        }
        const uint32_t* m = src + ((size_t)j * S + t) * SW;
        uint32_t g = 0;
        for (int k = 0; k < SW; ++k) {
          uint32_t bits = m[k];
          while (bits) {
            const int s = k * 32 + __ffs(bits) - 1;
            bits &= bits - 1;
            g |= (s == t && sw == w) ? acc : B[(size_t)s * W + sw];
          }
        }
        if (j < 5) {
          acc |= (g & kIntraClear[j]) << (1 << j);
        } else {
          acc |= g;
        }
      }
      if (acc != orig) {
        B[i] = acc;
        changed = 1;
      }
    }
  } while (__syncthreads_or(changed));
}

// The "global" layout: one block, B updated in place in device memory.
__global__ void __launch_bounds__(kMaxThreads)
closure_global(const int32_t* __restrict__ sel, const int32_t* b_in,
               int32_t* b_out, const unsigned char* __restrict__ run, int S,
               int C, int log_w) {
  extern __shared__ uint32_t gsmem[];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int n = S << log_w;
  uint32_t* B = reinterpret_cast<uint32_t*>(b_out);
  const uint32_t* bin = reinterpret_cast<const uint32_t*>(b_in);

  if (run != nullptr && *run == 0) {
    if (b_in != b_out) {
      for (int i = tid; i < n; i += nt) b_out[i] = b_in[i];
    }
    return;
  }
  if (b_in != b_out) {
    for (int i = tid; i < n; i += nt) B[i] = bin[i];
  }
  global_masks(sel, gsmem, S, C);
  global_sweeps(B, gsmem, S, C, log_w);
}

// The batched scan in the "global" layout: one block a key, its B updated
// in place in device memory (see the top).
__global__ void __launch_bounds__(kMaxThreads)
closure_scan_global(const int32_t* __restrict__ sel, int32_t* b,
                    unsigned char* ok, int32_t* fail_r,
                    const int32_t* __restrict__ slot,
                    const unsigned char* __restrict__ real, int32_t* traj,
                    int E, int K, int r0, int R, int S, int C, int log_w) {
  extern __shared__ uint32_t gsmem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int key = blockIdx.x;
  const int n = S << log_w;
  const int CSS = C * S * S;
  uint32_t* src = gsmem;
  int* scan = reinterpret_cast<int*>(gsmem + C * S * ((S + 31) >> 5));
  uint32_t* B = reinterpret_cast<uint32_t*>(b) + ((size_t)key * S << log_w);
  const int32_t* sel_k = sel + (size_t)key * CSS;
  int32_t* tr = traj == nullptr ? nullptr : traj + ((size_t)key * R + r0) * 2;
  bool alive = ok[key] != 0;
  int i = 0;
  if (alive) {
    int fr = fail_r[key];
    for (; i < E && alive; ++i) {
      if (!real[(size_t)i * K + key]) {
        if (tr != nullptr && tid == 0) tr[2 * i] = tr[2 * i + 1] = -1;
        continue;
      }
      global_masks(sel_k + (size_t)i * K * CSS, src, S, C);
      global_sweeps(B, src, S, C, log_w);
      // the filter in place, a word (j < 5) or a pair (j >= 5) a thread
      const int j = slot[(size_t)i * K + key];
      int acc = 0;
      if (j < 5) {
        for (int x = tid; x < n; x += nt) {
          const uint32_t v = (B[x] >> (1 << j)) & kIntraClear[j];
          B[x] = v;
          acc += tr != nullptr ? __popc(v) : (v != 0);
        }
      } else {
        const int bj = j - 5, jb = 1 << bj;
        for (int p = tid; p < n / 2; p += nt) {
          const int lo = ((p >> bj) << (bj + 1)) | (p & (jb - 1));
          const uint32_t v = B[lo | jb];
          B[lo] = v;
          B[lo | jb] = 0;
          acc += tr != nullptr ? __popc(v) : (v != 0);
        }
      }
      int n_left;
      if (tr != nullptr) {
        jt::block_exclusive_scan(acc, scan, &n_left);
      } else {
        n_left = __syncthreads_or(acc);
      }
      if (tr != nullptr && tid == 0) {
        tr[2 * i] = n_left;
        tr[2 * i + 1] = -1;
      }
      if (n_left == 0) {
        alive = false;
        fr = r0 + i;
      }
    }
    if (tid == 0) {
      ok[key] = alive;
      fail_r[key] = fr;
    }
  }
  if (tr != nullptr) {
    for (int q = i + tid; q < E; q += nt) tr[2 * q] = tr[2 * q + 1] = -1;
  }
}

size_t sel_bytes(int S, int C) {
  return (size_t)C * S * ((S + 31) / 32) * sizeof(uint32_t);
}

cudaLaunchConfig_t cluster_config(int k, int threads, size_t smem,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr, int keys = 1) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(k * keys);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = k;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

size_t scan_smem(int S, int C, int log_wb) {
  return split_smem(S, C, 1 << log_wb, 2).bytes;
}

// Checks shared by the launches: a layout the kernels take.
bool bad_layout(int S, int C, int layout, int k, int log_wb, int threads) {
  const int log_w = C >= 5 ? C - 5 : 0;
  return S < 1 || C < 1 || threads < 32 || threads > kMaxThreads ||
         threads % 32 != 0 || log_wb < 0 || log_wb > log_w || layout < 0 ||
         layout > 2 ||
         (layout == 2 &&
          (k < 2 || k > kMaxCluster || (k << log_wb) != (1 << log_w))) ||
         (layout == 1 && log_wb != log_w);
}

}  // namespace

extern "C" {

// Once per device, before the first launch there: lets every kernel use
// the block's whole shared-memory opt-in and the split kernels cluster
// past the portable 8 blocks, and finds the largest cluster (16, 8, 4 or
// 2 blocks of 1,024 threads) the card can run (jt_closure_max_cluster; 1
// when none). Returns the opt-in in bytes, or minus the cudaError_t.
int jt_closure_init(void) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev >= kMaxDevices) err = cudaErrorInvalidDevice;
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  const void* kernels[6] = {(const void*)closure_split<true>,
                            (const void*)closure_split<false>,
                            (const void*)closure_global,
                            (const void*)closure_scan_split<true>,
                            (const void*)closure_scan_split<false>,
                            (const void*)closure_scan_global};
  for (int i = 0; i < 6 && err == cudaSuccess; ++i) {
    err = cudaFuncSetAttribute(kernels[i],
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  }
  for (int i = 0; i < 4 && err == cudaSuccess; i += 3) {
    err = cudaFuncSetAttribute(kernels[i],
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  }
  if (err != cudaSuccess) return -(int)err;
  int best = 1;
  for (int k = kMaxCluster; k >= 2 && best == 1; k /= 2) {
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = cluster_config(k, kMaxThreads, 0, 0, &attr);
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, closure_split<true>, &cfg) ==
            cudaSuccess &&
        n > 0) {
      best = k;
    }
  }
  (void)cudaGetLastError();  // a refused probe leaves no sticky error
  g_max_cluster[dev] = best;
  return optin;
}

// The largest cluster jt_closure_init found on the current device (0
// before it ran there).
int jt_closure_max_cluster(void) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return 0;
  return g_max_cluster[dev];
}

// The split kernel's dynamic shared memory at (S, C) with 2^log_wb words
// of each state per block.
long long jt_closure_split_smem(int S, int C, int log_wb) {
  return (long long)split_smem(S, C, 1 << log_wb, 1).bytes;
}

// How many clusters of k blocks of `threads` threads, at (S, C, log_wb),
// the card can keep resident at once (0: it cannot run one), or minus
// the cudaError_t.
int jt_closure_active_clusters(int S, int C, int log_wb, int k,
                               int threads) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(
      k, threads, split_smem(S, C, 1 << log_wb, 1).bytes, 0, &attr);
  int n = 0;
  cudaError_t err =
      cudaOccupancyMaxActiveClusters(&n, closure_split<true>, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

// The closure fixpoint of one key in one launch on `stream`: sel [C, S,
// S], B and B' [S, W], run (null, or one flag). layout: 0 global (one
// block, B in device memory), 1 shared (one block, B in shared memory), 2
// cluster (k blocks, 2^log_wb words of each state each); `threads` per
// block. The caller has checked that the layout's shared memory fits.
// b_out may equal b_in (in place). Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for arguments it does not take).
int jt_closure_launch(const int32_t* sel, const int32_t* b_in,
                      int32_t* b_out, const unsigned char* run, int S, int C,
                      int layout, int k, int log_wb, int threads,
                      void* stream) {
  if (bad_layout(S, C, layout, k, log_wb, threads)) {
    return (int)cudaErrorInvalidValue;
  }
  const int log_w = C >= 5 ? C - 5 : 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (layout == 0) {
    closure_global<<<1, threads, sel_bytes(S, C), st>>>(sel, b_in, b_out,
                                                        run, S, C, log_w);
    return (int)cudaGetLastError();
  }
  const size_t smem = split_smem(S, C, 1 << log_wb, 1).bytes;
  if (layout == 1) {
    closure_split<false><<<1, threads, smem, st>>>(sel, b_in, b_out, run, S,
                                                   C, log_w, log_wb);
    return (int)cudaGetLastError();
  }
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(k, threads, smem, st, &attr);
  cudaError_t err = cudaLaunchKernelEx(&cfg, closure_split<true>, sel, b_in,
                                       b_out, run, S, C, log_w, log_wb);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// The batched scan's dynamic shared memory in a split layout at (S, C)
// with 2^log_wb words of each state per block.
long long jt_closure_scan_smem(int S, int C, int log_wb) {
  return (long long)scan_smem(S, C, log_wb);
}

// jt_closure_active_clusters for the batched scan's cluster kernel.
int jt_closure_scan_active_clusters(int S, int C, int log_wb, int k,
                                    int threads) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(
      k, threads, scan_smem(S, C, log_wb), 0, &attr);
  int n = 0;
  cudaError_t err =
      cudaOccupancyMaxActiveClusters(&n, closure_scan_split<true>, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

// The batched scan of K keys over the E event rows r0 .. r0 + E - 1 of a
// chunk, in one launch on `stream`: sel [E, K, C, S, S], the carry b [K,
// S, W] (int32 words), ok [K] (bytes) and fail_r [K], updated in place,
// slot [E, K] (each row's returning slot, in [0, C)), real [E, K] (bytes:
// the row is one of the key's events), traj (null, or [K, R, 2]: each
// row's width and iterations, R >= r0 + E). layout, k, log_wb and
// threads as jt_closure_launch's, for each key. Returns the cudaError_t
// of the launch (cudaErrorInvalidValue for arguments it does not take).
int jt_closure_scan_launch(const int32_t* sel, int32_t* b, unsigned char* ok,
                           int32_t* fail_r, const int32_t* slot,
                           const unsigned char* real, int32_t* traj, int E,
                           int K, int r0, int R, int S, int C, int layout,
                           int k, int log_wb, int threads, void* stream) {
  if (bad_layout(S, C, layout, k, log_wb, threads) || E < 1 || K < 1 ||
      r0 < 0 || (traj != nullptr && r0 + E > R) ||
      (long long)K * (layout == 2 ? k : 1) > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const int log_w = C >= 5 ? C - 5 : 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (layout == 0) {
    closure_scan_global<<<K, threads, sel_bytes(S, C) + kScanWords * 4,
                          st>>>(sel, b, ok, fail_r, slot, real, traj, E, K,
                                r0, R, S, C, log_w);
    return (int)cudaGetLastError();
  }
  const size_t smem = scan_smem(S, C, log_wb);
  if (layout == 1) {
    closure_scan_split<false><<<K, threads, smem, st>>>(
        sel, b, ok, fail_r, slot, real, traj, E, K, r0, R, S, C, log_w,
        log_wb);
    return (int)cudaGetLastError();
  }
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(k, threads, smem, st, &attr, K);
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, closure_scan_split<true>, sel, b, ok, fail_r, slot, real, traj,
      E, K, r0, R, S, C, log_w, log_wb);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
