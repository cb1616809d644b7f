// lpm_fused_lookup: longest-prefix match over per-length sorted planes.
//
// Replaces the TPU kernel vpp_tpu/ops/lpm.py lpm_fused_lookup (body
// _lpm_search_kernel). Per packet, walk the populated prefix lengths
// longest first; for each, mask the destination, flip its sign bit
// (the _lpm_bias order trick: int32 order of the biased value is the
// uint32 order of the prefix), bisect that length's sorted, biased
// prefix row over its live entries [0, cnt), and stop at the first
// exact hit: its owning FIB slot is the answer. The TPU kernel walks
// every length (no data-dependent exit on a vector machine); stopping
// early gives the same result, since along longest-first the first
// hit IS the longest match.
//
// Bound on this card: latency of dependent reads. The stacked planes
// are L x Npad x 2 x 4 B (~1 MB at L = 33, Npad = 4,096) and sit in the
// 50 MB L2; each packet does up to L bisections of log2(Npad) + 1
// dependent probes. Design: one thread per packet, the planes are read
// through the read-only path from L2, and the early exit cuts the walk
// to the lengths above the matching one.
#include <cuda_runtime.h>

#include "kernels.cuh"

namespace {

__global__ void lpm_kernel(const int32_t* __restrict__ dst,
                           const int32_t* __restrict__ lens,
                           const int32_t* __restrict__ cnt,
                           const int32_t* __restrict__ pfx,
                           const int32_t* __restrict__ slot, int32_t p,
                           int32_t n_len, int32_t npad, int32_t* found,
                           int32_t* out) {
  int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  const uint32_t d = static_cast<uint32_t>(dst[i]);
  int32_t hit_slot = 0;
  int32_t hit = 0;
  for (int32_t l = 0; l < n_len; ++l) {
    const int32_t len = lens[l];
    const uint32_t mask = len == 0 ? 0u : (0xFFFFFFFFu << (32 - len));
    const int32_t m = static_cast<int32_t>((d & mask) ^ 0x80000000u);
    const int32_t n = cnt[l];
    const int32_t* row = pfx + static_cast<int64_t>(l) * npad;
    int32_t lo = 0, hi = n;
    while (lo < hi) {  // bisect_left over the live entries
      const int32_t mid = (lo + hi) >> 1;
      if (__ldg(row + mid) < m) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    if (lo < n && __ldg(row + lo) == m) {
      hit = 1;
      hit_slot = __ldg(slot + static_cast<int64_t>(l) * npad + lo);
      break;
    }
  }
  found[i] = hit;
  out[i] = hit_slot;
}

}  // namespace

extern "C" int lpm_fused_lookup(const int32_t* dst, const int32_t* lens,
                                const int32_t* cnt, const int32_t* pfx,
                                const int32_t* slot, int32_t p,
                                int32_t n_len, int32_t npad, int32_t* found,
                                int32_t* out, void* stream) {
  if (p > 0) {
    const int threads = 256;
    const int blocks = (p + threads - 1) / threads;
    lpm_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        dst, lens, cnt, pfx, slot, p, n_len, npad, found, out);
  }
  return static_cast<int>(cudaGetLastError());
}
