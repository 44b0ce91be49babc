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
//     lowest in-chunk index, losers re-check next round);
//   * out: the table, fresh[M] (claimed a slot), off[M] (final probe
//     offset, 0 for dead candidates) and a flag set when some candidate
//     exhausted its `probe_limit` probes.
//
// The append of the fresh rows and the expansion around it stay PyTorch
// ops (sparse_kernels.tiled_event_closure), as the reference keeps them
// in XLA.
//
// Design: one thread block per tile. The block loads its tile's rows,
// occupancy and a claim word per slot into dynamic shared memory, walks
// the chunks in order, gathers the live candidates whose home is its
// tile (any order: the claim arbitration orders them), probes them in
// rounds separated by __syncthreads, writes their fresh/off, and at the
// end writes the tile back. Blocks share nothing — every candidate
// belongs to one tile — so the grid spreads over as many SMs as there
// are tiles. Shared memory: 17 bytes per tile slot plus 10 per chunk
// entry (sparse_kernels.tiled_plan sizes both to the opt-in: a tile of
// 8,192 slots and a chunk of 8,192 take 216 KB).
//
// What bounds it: every block reads every candidate's live flag, and
// the live ones' rows, to find its own, so the bytes read grow with the
// number of tiles; the least time for the work is the candidates and the
// table read once and the table, fresh and off written once. The probe
// rounds of each chunk run one after another behind barriers, which
// keeps a block far above that bound. chip_smoke.py measures it;
// PERF.md keeps the numbers.
//
// Build: nvcc -gencode=arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC tiled_insert.cu   (see kernels/__init__.py)

#include <cstdint>
#include <cuda_runtime.h>

#include "sparse_common.cuh"

namespace {

using namespace jt;

constexpr int kThreads = 1024;

size_t smem_bytes(int TS, int CH) {
  return 17 * (size_t)TS + 10 * (size_t)CH + 16;
}

__global__ void __launch_bounds__(kThreads, 1)
tiled_insert_kernel(const int32_t* __restrict__ c_st,
                    const int32_t* __restrict__ c_ml,
                    const int32_t* __restrict__ c_mh,
                    const uint8_t* __restrict__ c_live, int M,
                    const int32_t* __restrict__ t_st,
                    const int32_t* __restrict__ t_ml,
                    const int32_t* __restrict__ t_mh,
                    const uint8_t* __restrict__ t_occ, int32_t* o_st,
                    int32_t* o_ml, int32_t* o_mh, uint8_t* o_occ,
                    uint8_t* fresh, int32_t* off_out, int32_t* pend_out,
                    int TS, int tile_bits, int CH, int probe_limit) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int tile = blockIdx.x;
  const size_t base = (size_t)tile * TS;
  const uint32_t tile_mask = (1u << tile_bits) - 1u;

  int32_t* w = reinterpret_cast<int32_t*>(smem);
  int32_t* tst = w; w += TS;
  int32_t* tml = w; w += TS;
  int32_t* tmh = w; w += TS;
  int32_t* claim = w; w += TS;
  int32_t* l_idx = w; w += CH;    // in-chunk index of a gathered candidate
  int32_t* l_start = w; w += CH;  // its in-tile probe start
  int32_t* n_mine = w; w += 4;
  uint8_t* b = reinterpret_cast<uint8_t*>(w);
  uint8_t* l_off = b; b += CH;
  uint8_t* l_flags = b; b += CH;
  uint8_t* tocc = b;

  for (int i = tid; i < TS; i += nt) {
    tst[i] = t_st[base + i];
    tml[i] = t_ml[base + i];
    tmh[i] = t_mh[base + i];
    tocc[i] = t_occ[base + i];
    claim[i] = kClaimFree;
  }

  for (int c0 = 0; c0 < M; c0 += CH) {
    if (tid == 0) *n_mine = 0;
    __syncthreads();
    const int ch = min(CH, M - c0);
    for (int k = tid; k < ch; k += nt) {
      const int i = c0 + k;
      if (!c_live[i]) continue;
      const uint32_t h =
          table_hash(c_st[i], (uint32_t)c_ml[i], (uint32_t)c_mh[i]);
      if ((h & tile_mask) != (uint32_t)tile) continue;
      const int p = atomicAdd(n_mine, 1);
      l_idx[p] = k;
      l_start[p] = (int32_t)((h >> tile_bits) & (uint32_t)(TS - 1));
      l_off[p] = 0;
      l_flags[p] = kPending;
    }
    __syncthreads();
    const int nm = *n_mine;
    int active = nm > 0;
    while (active) {
      for (int p = tid; p < nm; p += nt) {
        if (!(l_flags[p] & kPending) || l_off[p] >= probe_limit) continue;
        const int i = c0 + l_idx[p];
        const int slot = (l_start[p] + l_off[p]) & (TS - 1);
        if (tocc[slot]) {
          if (tst[slot] == c_st[i] && tml[slot] == c_ml[i] &&
              tmh[slot] == c_mh[i]) {
            l_flags[p] = 0;  // already visited
          } else {
            l_off[p] += 1;
          }
        } else {
          atomicMin(&claim[slot], l_idx[p]);
          l_flags[p] = kPending | kTry;
        }
      }
      __syncthreads();
      int local = 0;
      for (int p = tid; p < nm; p += nt) {
        uint8_t fl = l_flags[p];
        if (fl & kTry) {
          const int slot = (l_start[p] + l_off[p]) & (TS - 1);
          if (claim[slot] == l_idx[p]) {
            const int i = c0 + l_idx[p];
            tst[slot] = c_st[i];
            tml[slot] = c_ml[i];
            tmh[slot] = c_mh[i];
            tocc[slot] = 1;
            claim[slot] = kClaimFree;
            l_flags[p] = kFresh;
            continue;
          }
          fl = kPending;
          l_flags[p] = fl;
        }
        if ((fl & kPending) && l_off[p] < probe_limit) local = 1;
      }
      active = __syncthreads_or(local);
    }
    for (int p = tid; p < nm; p += nt) {
      const int i = c0 + l_idx[p];
      fresh[i] = (l_flags[p] & kFresh) ? 1 : 0;
      off_out[i] = l_off[p];
      if (l_flags[p] & kPending) *pend_out = 1;
    }
    __syncthreads();  // before the gather list is reused
  }

  for (int i = tid; i < TS; i += nt) {
    o_st[base + i] = tst[i];
    o_ml[base + i] = tml[i];
    o_mh[base + i] = tmh[i];
    o_occ[base + i] = tocc[i];
  }
}

}  // namespace

extern "C" {

// Once per device, before the first launch there: lets the kernel use the
// block's whole shared-memory opt-in. Returns that opt-in in bytes, or
// minus the cudaError_t.
int jt_tiled_insert_init(void) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute((const void*)tiled_insert_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  }
  return err == cudaSuccess ? optin : -(int)err;
}

// The kernel's dynamic shared memory for a tile of TS slots and a chunk
// of CH candidates (sparse_kernels.k4_smem_bytes must agree).
long long jt_tiled_insert_smem(int TS, int CH) {
  return (long long)smem_bytes(TS, CH);
}

// One tiled insert on `stream`: n_tiles = 1 << tile_bits blocks of TS
// slots (both powers of two). fresh, off_out and pend_out must be zero
// on entry: only live candidates are written. Returns the cudaError_t of
// the launch (cudaErrorInvalidValue for a shape the kernel does not
// take).
int jt_tiled_insert_launch(const int32_t* c_st, const int32_t* c_ml,
                           const int32_t* c_mh, const uint8_t* c_live, int M,
                           const int32_t* t_st, const int32_t* t_ml,
                           const int32_t* t_mh, const uint8_t* t_occ,
                           int32_t* o_st, int32_t* o_ml, int32_t* o_mh,
                           uint8_t* o_occ, uint8_t* fresh, int32_t* off_out,
                           int32_t* pend_out, int TS, int tile_bits, int CH,
                           int probe_limit, void* stream) {
  if (M < 1 || TS < 1 || (TS & (TS - 1)) != 0 || tile_bits < 0 ||
      tile_bits > 24 || CH < 1 || probe_limit < 1 || probe_limit > 255) {
    return (int)cudaErrorInvalidValue;
  }
  tiled_insert_kernel<<<(1 << tile_bits), kThreads, smem_bytes(TS, CH),
                        reinterpret_cast<cudaStream_t>(stream)>>>(
      c_st, c_ml, c_mh, c_live, M, t_st, t_ml, t_mh, t_occ, o_st, o_ml, o_mh,
      o_occ, fresh, off_out, pend_out, TS, tile_bits, CH, probe_limit);
  return (int)cudaGetLastError();
}

}  // extern "C"
