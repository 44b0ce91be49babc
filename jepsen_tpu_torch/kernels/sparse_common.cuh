// Device helpers shared by the sparse engine's kernels (K2
// frontier_closure.cu, K4 tiled_insert.cu): the visited-set hash, the
// five model-step families of jepsen_tpu_torch/parallel/steps.py, and a
// block-wide exclusive prefix sum. Integers are 32-bit two's complement;
// shifts follow steps.py's _shl/_sar (0 past the word for a left shift,
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

}  // namespace jt
