// lpm_fused_lookup: longest-prefix match over per-length sorted planes,
// searched in a shared-memory copy of the live prefixes.
//
// Replaces the TPU kernel vpp_tpu/ops/lpm.py lpm_fused_lookup (body
// _lpm_search_kernel). Per packet, walk the populated prefix lengths
// longest first; for each, mask the destination, flip its sign bit
// (the _lpm_bias order trick: int32 order of the biased value is the
// uint32 order of the prefix), search that length's sorted, biased
// prefix row over its live entries [0, cnt) for the first entry >= the
// query, and stop at the first exact hit: its owning FIB slot is the
// answer. The TPU kernel walks every length (no data-dependent exit on
// a vector machine); stopping early gives the same result, since along
// longest-first the first hit IS the longest match.
//
// Bound on this card: the work is a few KB and a few thousand compares,
// nanoseconds at the data-sheet rates, so what costs is the chain of
// dependent reads of one packet. Walked in device memory by bisection,
// a packet makes ~20 dependent L2 round trips (12 probes at /24 alone).
//
// Design:
// * Prologue, one warp: lens and cnt are read once, the populated
//   lengths compacted (ballot) and their live regions, each rounded up
//   to 4 entries, given offsets by a warp prefix sum. Whether they fit
//   `budget` entries (the dynamic shared memory the wrapper gives the
//   block) is decided here, on the device, by every block: the host
//   never reads cnt, so the step keeps its zero host syncs.
// * Staging: the live regions are copied into shared memory in one pass
//   of 16-byte cp.async copies, all in flight at once.
// * Search: per packet and populated length an 8-ary search — seven
//   independent pivot reads narrow the range 8-fold per round, then one
//   round counts the last <= 8 entries — so a 4,096-entry row costs 5
//   dependent shared-memory reads instead of 13. Device memory is read
//   once more, for the slot at the hit.
// * A stack that does not fit (or whose rows are not 16-byte aligned)
//   is searched the same way in device memory through the read-only
//   path.
// * Blocks of 64 threads, one packet each, spread P = 256 over 4 SMs and
//   P = 4,096 over 64; beyond a few hundred blocks each thread loops
//   over packets, which bounds the re-staging.
#include <cuda_runtime.h>

#include <cstdint>

#include "kernels.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kMaxLens = 64;  // stacked lengths (IPv4 has 33)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <bool kShared>
__device__ __forceinline__ int32_t load(const int32_t* p) {
  if constexpr (kShared) {
    return *p;
  } else {
    return __ldg(p);
  }
}

// The index of the first entry of row[0, n) that is >= m (n if none),
// by 8-ary search; then the exact-hit test (-1 on a miss).
template <bool kShared>
__device__ __forceinline__ int32_t find(const int32_t* row, int32_t n,
                                        int32_t m) {
  int32_t lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (hi - lo > 8) {
    const int32_t span = hi - lo;
    int32_t below = 0;  // pivots < m: a prefix of the seven
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      below += load<kShared>(row + lo + span * j / 8) < m;
    }
    const int32_t new_lo = below ? lo + span * below / 8 + 1 : lo;
    hi = below < 7 ? lo + span * (below + 1) / 8 : hi;
    lo = new_lo;
  }
  int32_t at = lo;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    at += lo + j < hi && load<kShared>(row + lo + j) < m;
  }
  return at < n && load<kShared>(row + at) == m ? at : -1;
}

__global__ void __launch_bounds__(kThreads) lpm_kernel(
    const int32_t* __restrict__ dst, const int32_t* __restrict__ lens,
    const int32_t* __restrict__ cnt, const int32_t* __restrict__ pfx,
    const int32_t* __restrict__ slot, int32_t p, int32_t n_len,
    int32_t npad, int32_t budget, uint8_t* found, int32_t* out) {
  extern __shared__ __align__(16) int32_t s_pfx[];  // `budget` entries
  // the populated lengths, longest first: length, live count, offset in
  // s_pfx, stack row
  __shared__ int32_t s_len[kMaxLens], s_cnt[kMaxLens], s_off[kMaxLens],
      s_row[kMaxLens];
  __shared__ int32_t s_pop, s_fits;
  // the first packet's destination is read now: its latency hides
  // behind the prologue and the staging
  const int64_t i0 =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int32_t d0 = i0 < p ? __ldg(dst + i0) : 0;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    int32_t off = 0, pop = 0;
    for (int l0 = 0; l0 < n_len; l0 += 32) {
      const int l = l0 + lane;
      const int32_t c = l < n_len ? cnt[l] : 0;
      const int32_t len = l < n_len ? lens[l] : 0;
      int32_t sum = (c + 3) & ~3;  // inclusive prefix sum of the regions
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int32_t v = __shfl_up_sync(0xffffffffu, sum, d);
        sum += lane >= d ? v : 0;
      }
      const uint32_t live = __ballot_sync(0xffffffffu, c > 0);
      if (c > 0) {
        const int at = pop + __popc(live & ((1u << lane) - 1u));
        s_len[at] = len;
        s_cnt[at] = c;
        s_off[at] = off + sum - ((c + 3) & ~3);
        s_row[at] = l;
      }
      off += __shfl_sync(0xffffffffu, sum, 31);
      pop += __popc(live);
    }
    if (lane == 0) {
      s_pop = pop;
      s_fits = npad % 4 == 0 && off <= budget;
    }
  }
  __syncthreads();
  const int32_t n_pop = s_pop;
  const bool fits = s_fits;
  if (fits) {
    for (int k = 0; k < n_pop; ++k) {
      const int4* row = reinterpret_cast<const int4*>(
          pfx + static_cast<int64_t>(s_row[k]) * npad);
      const uint32_t to = smem_u32(s_pfx + s_off[k]);
      for (int c = threadIdx.x; c < (s_cnt[k] + 3) >> 2; c += kThreads) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         to + c * 16),
                     "l"(row + c)
                     : "memory");
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }
  for (int64_t i = i0; i < p;
       i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const uint32_t d = static_cast<uint32_t>(i == i0 ? d0 : __ldg(dst + i));
    uint8_t hit = 0;
    int32_t hit_slot = 0;
    for (int k = 0; k < n_pop; ++k) {
      const int32_t len = s_len[k];
      const uint32_t mask = len == 0 ? 0u : (0xFFFFFFFFu << (32 - len));
      const int32_t m = static_cast<int32_t>((d & mask) ^ 0x80000000u);
      const int64_t base = static_cast<int64_t>(s_row[k]) * npad;
      const int32_t at = fits ? find<true>(s_pfx + s_off[k], s_cnt[k], m)
                              : find<false>(pfx + base, s_cnt[k], m);
      if (at >= 0) {
        hit = 1;
        hit_slot = __ldg(slot + base + at);
        break;
      }
    }
    found[i] = hit;
    out[i] = hit_slot;
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || sms <= 0) {
      sms = 132;  // H100 SXM
    }
  }
  return sms;
}

}  // namespace

extern "C" int lpm_fused_lookup(const int32_t* dst, const int32_t* lens,
                                const int32_t* cnt, const int32_t* pfx,
                                const int32_t* slot, int32_t p,
                                int32_t n_len, int32_t npad, int32_t budget,
                                uint8_t* found, int32_t* out, void* stream) {
  if (n_len > kMaxLens) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = budget * static_cast<int>(sizeof(int32_t));
  static int configured = -1;  // the block also has ~1 KB static
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        lpm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = smem;
  }
  if (p > 0) {
    int blocks = (p + kThreads - 1) / kThreads;
    blocks = blocks > 4 * sm_count() ? 4 * sm_count() : blocks;
    lpm_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        dst, lens, cnt, pfx, slot, p, n_len, npad, budget, found, out);
  }
  return static_cast<int>(cudaGetLastError());
}
