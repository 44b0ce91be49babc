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
//     block's shared flags (double-buffered by sweep parity) and a
//     cluster.sync(); all blocks then read the same flags and leave
//     together. That sync is the last remote access: no block exits
//     while another can still read its shared memory. The first remote
//     read comes after a cluster.sync() that follows every block's load.
//   * An optional device-side run flag (the scan's `ok`) makes the kernel
//     a copy once the history has failed, so the host never waits for it.
//
// Batched over keys (jt_closure_launch with keys > 1; replaces the vmap
// of the per-key scan in jepsen_tpu/parallel/bitdense.py
// ::_check_bitdense_batch):
// one launch closes K keys' reachable sets at once, sel [K, C, S, S] and
// B [K, S, W]. The grid is K copies of the single key's: key
// blockIdx.x / k owns blocks [key * k, (key + 1) * k), one cluster of k
// blocks (a "shared" or "global" plan: one block), and offsets sel, B and
// B' by its key. Each key reads its own run flag run[key]; every block of
// a cluster reads the same flag and leaves before any cluster barrier, so
// a key that does not run is left as it is. Clusters need no
// co-residency: the card schedules them as SMs free up.
//
// What bounds it: the bytes it must move (sel and B read once, B' written
// once: 54 KB at S=18 C=13, 754 KB at S=22 C=17). What is left above that
// bound is the launch, the round trips to device memory for sel and B, the
// pair list, and about three sweeps with a cluster barrier each.
// chip_smoke.py measures both against the bound on the card; PERF.md
// keeps the numbers.
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
// the largest cluster of the split kernel the card runs, per device
// (jt_closure_init)
int g_max_cluster[kMaxDevices];

// positions p in a 32-bit word whose mask bit j (j < 5) is clear
__constant__ uint32_t kIntraClear[5] = {
    0x55555555u, 0x33333333u, 0x0F0F0F0Fu, 0x00FF00FFu, 0x0000FFFFu};

// The split kernel's shared memory, in order: B's block [S][Wb], the
// source masks [C][S][SW], the pair list's item offsets [C*S + 1] and
// pair entries [C*S] (uint16), the sweep flags [2][kMaxCluster] and the
// scan words. closure_kernels.k1_block_bytes must agree.
struct SplitSmem {
  size_t src, pstart, pe, flags, scan, bytes;
};

__host__ __device__ SplitSmem split_smem(int S, int C, int Wb) {
  const int SW = (S + 31) / 32;
  SplitSmem m;
  size_t o = (size_t)S * Wb * 4;
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
  {
    // the key of this block's cluster, in a batched launch (0 alone)
    const size_t key = blockIdx.x / k;
    sel += key * C * S * S;
    b_in += (key * S) << log_w;
    b_out += (key * S) << log_w;
    if (run != nullptr) run += key;
  }
  const int Wb = 1 << log_wb;
  const int SW = (S + 31) >> 5;
  const int CS = C * S;
  const int nb = S * Wb;  // the words this block owns
  const SplitSmem lay = split_smem(S, C, Wb);
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
  // repack sel: mask word (j, t, k) holds bit s - 32k for every source s
  // in [32k, 32k + 32) with sel[j, s, t]; one warp per word, four in
  // flight per lane
  {
    const int lane = tid & 31, warp = tid >> 5, n_warps = nt >> 5;
    const int n_out = CS * SW;
    for (int o0 = warp * 4; o0 < n_out; o0 += n_warps * 4) {
      bool v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int o = o0 + q;
        const int k = o % SW, t = (o / SW) % S, j = o / (SW * S);
        const int s = k * 32 + lane;
        v[q] = o < n_out && s < S &&
               sel[((size_t)j * S + s) * S + t] != 0;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t m = __ballot_sync(0xffffffffu, v[q]);
        if (lane == 0 && o0 + q < n_out) src[o0 + q] = m;
      }
    }
  }
  __syncthreads();
  // the pair list: entry e = j*S + t, in order, with its items here
  int n_pairs, n_items;
  {
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
  }
  __syncthreads();
  if constexpr (kCluster) cg::this_cluster().sync();  // all B loaded

  for (int sweep = 0;; ++sweep) {
    int changed = 0;
    int p = 0;
    for (int x = tid; x < n_items; x += nt) {
      while (pstart[p + 1] <= x) ++p;
      const int e = pe[p];
      const int j = e / S, t = e % S;
      const int y = x - pstart[p];
      int wl, swl;
      const uint32_t* Bs = B;  // where the sources' words live
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
      for (int k = 0; k < SW; ++k) {
        // four sources' words a step, their loads in flight together (a
        // remote word costs a round trip through the cluster); a source
        // taken twice where fewer are left is read twice, harmlessly
        const uint32_t* col = Bs + (k * 32) * Wb + swl;
        uint32_t bits = m[k];
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
    }
    changed = __syncthreads_or(changed);
    if constexpr (kCluster) {
      // every block's "changed" into every block's flags of this parity;
      // the next write to them comes after the next cluster.sync(),
      // which no block reaches before reading them
      cg::cluster_group cluster = cg::this_cluster();
      int* f = flags + (sweep & 1) * kMaxCluster;
      if (tid < k) *cluster.map_shared_rank(f + r, tid) = changed;
      cluster.sync();
      int any = 0;
      for (int q = 0; q < k; ++q) any |= f[q];
      if (!any) break;  // the same flags in every block: all leave here
    } else if (!changed) {
      break;
    }
  }

  for (int i = tid; i < nb; i += nt) {
    bout[((size_t)(i >> log_wb) << log_w) + base + (i & (Wb - 1))] = B[i];
  }
}

// The "global" layout: one block, B updated in place in device memory.
// Each thread owns target words (t, w) and ORs into them every
// contribution of every slot, sweeping until no thread adds a bit.
__global__ void __launch_bounds__(kMaxThreads)
closure_global(const int32_t* __restrict__ sel, const int32_t* b_in,
               int32_t* b_out, const unsigned char* __restrict__ run, int S,
               int C, int log_w) {
  extern __shared__ uint32_t gsmem[];
  const int W = 1 << log_w;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int n = S * W;
  const int SW = (S + 31) >> 5;
  uint32_t* src = gsmem;  // [C][S(t)][SW]: bit s set iff sel[j][s][t] != 0
  {
    // one block a key, in a batched launch (0 alone)
    const size_t key = blockIdx.x;
    sel += key * C * S * S;
    b_in += (key * S) << log_w;
    b_out += (key * S) << log_w;
    if (run != nullptr) run += key;
  }
  uint32_t* B = reinterpret_cast<uint32_t*>(b_out);
  const uint32_t* bin = reinterpret_cast<const uint32_t*>(b_in);

  if (run != nullptr && *run == 0) {
    if (b_in != b_out) {
      for (int i = tid; i < n; i += nt) b_out[i] = b_in[i];
    }
    return;
  }

  for (int i = tid; i < C * S * SW; i += nt) src[i] = 0;
  if (b_in != b_out) {
    for (int i = tid; i < n; i += nt) B[i] = bin[i];
  }
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

}  // namespace

extern "C" {

// Once per device, before the first launch there: lets every kernel use
// the block's whole shared-memory opt-in and the split kernel clusters
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
  const void* kernels[3] = {(const void*)closure_split<true>,
                            (const void*)closure_split<false>,
                            (const void*)closure_global};
  for (int i = 0; i < 3 && err == cudaSuccess; ++i) {
    err = cudaFuncSetAttribute(kernels[i],
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute((const void*)closure_split<true>,
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
  return (long long)split_smem(S, C, 1 << log_wb).bytes;
}

// How many clusters of k blocks of `threads` threads, at (S, C, log_wb),
// the card can keep resident at once (0: it cannot run one), or minus
// the cudaError_t.
int jt_closure_active_clusters(int S, int C, int log_wb, int k,
                               int threads) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(
      k, threads, split_smem(S, C, 1 << log_wb).bytes, 0, &attr);
  int n = 0;
  cudaError_t err =
      cudaOccupancyMaxActiveClusters(&n, closure_split<true>, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

// The closure fixpoints of `keys` keys (1 alone, or a batch) in one
// launch on `stream`: sel [keys, C, S, S], B and B' [keys, S, W], run
// (null, or one flag a key) [keys]. layout: 0 global (a block a key, B in
// device memory), 1 shared (a block a key, B in shared memory), 2 cluster
// (k blocks a key, 2^log_wb words of each state each); `threads` per
// block. The caller has checked that the layout's shared memory fits.
// b_out may equal b_in (in place). Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for arguments it does not take).
int jt_closure_launch(const int32_t* sel, const int32_t* b_in,
                      int32_t* b_out, const unsigned char* run, int keys,
                      int S, int C, int layout, int k, int log_wb,
                      int threads, void* stream) {
  const int log_w = C >= 5 ? C - 5 : 0;
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      log_wb < 0 || log_wb > log_w || layout < 0 || layout > 2 ||
      (layout == 2 && (k < 2 || k > kMaxCluster || (k << log_wb) !=
                                                       (1 << log_w))) ||
      (layout == 1 && log_wb != log_w) || keys < 1 ||
      (long long)keys * (layout == 2 ? k : 1) > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (layout == 0) {
    closure_global<<<keys, threads, sel_bytes(S, C), st>>>(
        sel, b_in, b_out, run, S, C, log_w);
    return (int)cudaGetLastError();
  }
  const size_t smem = split_smem(S, C, 1 << log_wb).bytes;
  if (layout == 1) {
    closure_split<false><<<keys, threads, smem, st>>>(
        sel, b_in, b_out, run, S, C, log_w, log_wb);
    return (int)cudaGetLastError();
  }
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(k, threads, smem, st, &attr, keys);
  cudaError_t err = cudaLaunchKernelEx(&cfg, closure_split<true>, sel, b_in,
                                       b_out, run, S, C, log_w, log_wb);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
