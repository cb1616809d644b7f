// bv_first_set: bit-vector ACL first match, fused with its row gathers.
//
// Replaces the TPU kernel vpp_tpu/ops/acl_bv.py bv_first_set (body
// _bv_first_set_kernel) AND the five [P, W] row gathers the reference
// leaves to XLA in front of it (acl_bv.py bv_first_match_fused /
// acl_classify_local_pallas). Per packet: AND the five bitmap rows
// selected by its segment indices (src, dst, sport, dport) and its
// protocol, take each surviving word's lowest set bit, and return the
// smallest word * 32 + bit — the first matching rule — or
// VPP_BV_ENC_MISS when no bit survives.
//
// Bound on this card: bytes. Each packet reads 5 rows of W words
// (5 x 1280 B for the 10,240-rule global table, W = 320) chosen by
// data from ~105 MB of planes; there are ~9 integer operations per
// word, far below the compute roofline. Design: one warp per packet,
// lanes stride the W words so each row read is coalesced (32
// consecutive words = one 128-byte line per row per step); the AND and
// the per-word bit isolate run in registers and the combined word
// vector never reaches device memory; a warp-wide __reduce_min_sync
// folds the lanes' candidates. The local [T, I, W] planes are served
// by a per-packet table index (`table`, null for the global planes).
#include <cuda_runtime.h>

#include "kernels.cuh"

namespace {

__global__ void bv_first_set_kernel(
    const uint32_t* __restrict__ bm_src, const uint32_t* __restrict__ bm_dst,
    const uint32_t* __restrict__ bm_sport,
    const uint32_t* __restrict__ bm_dport,
    const uint32_t* __restrict__ bm_proto,
    const int32_t* __restrict__ row_src, const int32_t* __restrict__ row_dst,
    const int32_t* __restrict__ row_sport,
    const int32_t* __restrict__ row_dport,
    const int32_t* __restrict__ row_proto, const int32_t* __restrict__ table,
    int32_t p, int32_t n_int, int32_t n_proto, int32_t words, int32_t* enc) {
  const int32_t warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int32_t lane = threadIdx.x & 31;
  if (warp >= p) return;  // whole warp exits together
  const int64_t t = table ? table[warp] : 0;
  const int64_t w = words;
  const uint32_t* rs = bm_src + (t * n_int + row_src[warp]) * w;
  const uint32_t* rd = bm_dst + (t * n_int + row_dst[warp]) * w;
  const uint32_t* rp = bm_sport + (t * n_int + row_sport[warp]) * w;
  const uint32_t* rq = bm_dport + (t * n_int + row_dport[warp]) * w;
  const uint32_t* rr = bm_proto + (t * n_proto + row_proto[warp]) * w;
  uint32_t best = VPP_BV_ENC_MISS;
  for (int32_t j = lane; j < words; j += 32) {
    const uint32_t v = rs[j] & rd[j] & rp[j] & rq[j] & rr[j];
    if (v != 0u) {
      // words are scanned in increasing j per lane, so the lane's first
      // nonzero word already holds its smallest candidate
      best = static_cast<uint32_t>(j) * 32u +
             static_cast<uint32_t>(__ffs(static_cast<int>(v)) - 1);
      break;
    }
  }
  best = __reduce_min_sync(0xffffffffu, best);
  if (lane == 0) enc[warp] = static_cast<int32_t>(best);
}

}  // namespace

extern "C" int bv_first_set(const int32_t* bm_src, const int32_t* bm_dst,
                            const int32_t* bm_sport, const int32_t* bm_dport,
                            const int32_t* bm_proto, const int32_t* row_src,
                            const int32_t* row_dst, const int32_t* row_sport,
                            const int32_t* row_dport,
                            const int32_t* row_proto, const int32_t* table,
                            int32_t p, int32_t n_int, int32_t n_proto,
                            int32_t words, int32_t* enc, void* stream) {
  if (p > 0) {
    const int threads = 256;  // 8 packets per block
    const int64_t total = static_cast<int64_t>(p) * 32;
    const int blocks = static_cast<int>((total + threads - 1) / threads);
    bv_first_set_kernel<<<blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const uint32_t*>(bm_src),
        reinterpret_cast<const uint32_t*>(bm_dst),
        reinterpret_cast<const uint32_t*>(bm_sport),
        reinterpret_cast<const uint32_t*>(bm_dport),
        reinterpret_cast<const uint32_t*>(bm_proto), row_src, row_dst,
        row_sport, row_dport, row_proto, table, p, n_int, n_proto, words,
        enc);
  }
  return static_cast<int>(cudaGetLastError());
}
