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
// Design (one thread block per history, so one of the H100's 132 SMs):
//   * sel is repacked in shared memory into per-(j, t) bitmasks over the
//     source states s, so a target word only visits the s that reach it
//     (the register family has one t per (j, s): S visits per slot, not
//     S^2).
//   * Each thread owns target words (t, w) and ORs into them every
//     contribution: slot j < 5 moves bits inside the word,
//     ((OR_s B[s][w]) & clear_j) << 2^j; slot j >= 5 moves whole words,
//     B[t][w] |= OR_s B[s][w ^ 2^(j-5)] for words with bit j-5 set (the
//     TPU kernel's roll-plus-select shuffle is just that index here).
//   * Updates are in place (Gauss-Seidel). The closure is monotone, so a
//     read that sees an older or a newer word only changes how many sweeps
//     it takes, never the fixpoint: every bit added is in the least
//     fixpoint, and a sweep in which no thread added a bit read a B that
//     did not change, so B is closed. __syncthreads_or ends the loop.
//   * B lives in dynamic shared memory when S*W*4 bytes plus the repacked
//     sel fit the block's opt-in limit (232,448 bytes on the H100: the
//     main path's 10k-op shape, S=18 C=13, is 18 KB). Otherwise it is
//     updated in place in device memory (S=22 C=17 is 360 KB), where the
//     50 MB L2 keeps it resident across sweeps. The caller chooses
//     (closure_kernels.kernel_layout), from the opt-in that
//     jt_closure_init reads and grants once per device.
//   * An optional device-side run flag (the scan's `ok`) makes the kernel
//     a copy once the history has failed, so the host never waits for it.
//
// What bounds it: the least time the card could take for this work is
// set by the bytes it must move at the main path's shape (sel and B read
// once, B' written once: 54 KB at S=18 C=13) and by its operations at
// S=22 C=17. The operations are few because a register step selects at
// most one target t per (j, s) and the kernel visits only the selected
// sources: one pass over sel, then per expansion one OR per selected
// (j, s, t) and target word. The kernel runs far above that bound: one
// block works on one SM of 132, and its ~3 sweeps run one after
// another. chip_smoke.py measures both against the bound on the card;
// PERF.md keeps the numbers. Using more SMs (many keys per grid, or
// one block per slice of W) is later work.
//
// Build: nvcc -gencode=arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC closure.cu   (see kernels/__init__.py)

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;

// positions p in a 32-bit word whose mask bit j (j < 5) is clear
__constant__ uint32_t kIntraClear[5] = {
    0x55555555u, 0x33333333u, 0x0F0F0F0Fu, 0x00FF00FFu, 0x0000FFFFu};

template <bool kSharedB>
__global__ void __launch_bounds__(kMaxThreads)
closure_kernel(const int32_t* __restrict__ sel, const int32_t* b_in,
               int32_t* b_out, const unsigned char* __restrict__ run,
               int S, int C, int log_w) {
  extern __shared__ uint32_t smem[];
  const int W = 1 << log_w;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int n = S * W;
  const int SW = (S + 31) >> 5;
  uint32_t* src = smem;  // [C][S(t)][SW]: bit s set iff sel[j][s][t] != 0
  uint32_t* B = kSharedB ? smem + C * S * SW
                         : reinterpret_cast<uint32_t*>(b_out);
  const uint32_t* bin = reinterpret_cast<const uint32_t*>(b_in);

  if (run != nullptr && *run == 0) {
    // the history already failed: B' is B (uniform branch, no barrier)
    if (b_in != b_out) {
      for (int i = tid; i < n; i += nt) b_out[i] = b_in[i];
    }
    return;
  }

  for (int i = tid; i < C * S * SW; i += nt) src[i] = 0;
  if (kSharedB || b_in != b_out) {
    for (int i = tid; i < n; i += nt) B[i] = bin[i];
  }
  __syncthreads();
  // repack sel, one thread per entry (neighbouring threads read
  // neighbouring t), into the source masks
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

  if (kSharedB) {
    uint32_t* out = reinterpret_cast<uint32_t*>(b_out);
    for (int i = tid; i < n; i += nt) out[i] = B[i];
  }
}

size_t sel_bytes(int S, int C) {
  return (size_t)C * S * ((S + 31) / 32) * sizeof(uint32_t);
}

}  // namespace

extern "C" {

// Once per device, before the first launch there: lets both layouts use
// the block's whole shared-memory opt-in. Returns that opt-in in bytes
// (the caller chooses the layout from it), or minus the cudaError_t.
int jt_closure_init(void) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute((const void*)closure_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute((const void*)closure_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  }
  return err == cudaSuccess ? optin : -(int)err;
}

// One closure fixpoint on `stream`, with B in shared memory when
// shared_b is non-zero (the caller has checked that it fits). b_out may
// equal b_in (in place); run may be null. Returns the cudaError_t of
// the launch.
int jt_closure_launch(const int32_t* sel, const int32_t* b_in,
                      int32_t* b_out, const unsigned char* run, int S, int C,
                      int shared_b, void* stream) {
  const int log_w = C >= 5 ? C - 5 : 0;
  const int n = S << log_w;
  int threads = ((n + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (threads < 32) threads = 32;
  const size_t smem =
      sel_bytes(S, C) + (shared_b ? (size_t)n * sizeof(uint32_t) : 0);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (shared_b) {
    closure_kernel<true><<<1, threads, smem, st>>>(sel, b_in, b_out, run, S,
                                                    C, log_w);
  } else {
    closure_kernel<false><<<1, threads, smem, st>>>(sel, b_in, b_out, run, S,
                                                     C, log_w);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
