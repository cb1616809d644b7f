// bv_first_set: bit-vector ACL first match of a packet vector in one
// kernel: segment searches, row AND, first set bit.
//
// Replaces the TPU kernel vpp_tpu/ops/acl_bv.py bv_first_set (body
// _bv_first_set_kernel) AND the work the reference leaves to XLA in
// front of it (acl_bv.py bv_first_match_fused and, for the
// per-interface tables, acl_classify_local_pallas): the four segment
// searches (searchsorted over each dimension's boundaries, clipped to
// the live count), the protocol clamp, the table lookup of a local
// classify and the five row gathers. Per packet: find its segment row in
// each of src, dst (unsigned) and sport, dport (signed) over the live
// boundaries [0, nbnd), AND the five bitmap rows those rows and its
// protocol select, and write the smallest word * 32 + bit that survives
// (the first matching rule) or VPP_BV_ENC_MISS.
//
// Bound on this card: latency and the launch, not bytes. A global
// classify (10,240 rules: 20,482 boundaries a dimension, W = 320 words a
// row) reads ~6.4 KB of rows a packet, and the distinct rows of a vector
// at most ~0.4 us of HBM time at P = 4,096, under the ~1.5 us launch
// floor; the boundaries (80 KB a dimension) and the rows a vector
// touches sit in L2. What costs is the chain of dependent reads: a
// bisection is 15 of them for 20,482 entries, then the row reads.
//
// Design:
// * A group of G lanes serves a packet: G = 32 (a warp) for wide rows,
//   G = 8 for rows of at most 32 words (the local tables, W = 4, where a
//   warp a packet would leave most lanes idle).
// * Segment search, G-ary: each round every lane reads one pivot of each
//   of the four dimensions (four independent reads), a ballot counts
//   the pivots <= the value, and the range shrinks G-fold. 20,482
//   entries take 3 rounds at G = 32, a local table's 258 take 3 at
//   G = 8. Unsigned and signed order share one compare: the port
//   dimensions flip the sign bit of both sides.
// * Row AND: the group's lanes read the five rows as 16-byte chunks,
//   all issued before any test (a lane holds 4 chunks, 16 words, of
//   each row: W = 320 is one round), keep each lane's first set bit in
//   registers, and fold the group's minimum with shuffles. The combined
//   words never reach device memory.
// * Local tables: the kernel reads rx_if, looks the table up in
//   if_local_table (a negative index wraps once and then clamps, as JAX
//   gathers), uses table max(tid, 0) and writes tid for the verdict.
// * 64-thread blocks: a global classify at P = 256 spreads over 128 SMs.
#include <cuda_runtime.h>

#include <cstdint>

#include "kernels.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlock = 64;
constexpr int kWideLanes = 32;   // lanes a packet when W > 32
constexpr int kNarrowLanes = 8;  // lanes a packet when W <= 32
constexpr int kChunks = 4;       // 16-byte chunks a lane holds a round

template <bool kVec4>
__device__ __forceinline__ uint4 and5(const uint32_t* const* rows,
                                      int32_t c) {
  if constexpr (kVec4) {
    uint4 x = __ldg(reinterpret_cast<const uint4*>(rows[0]) + c);
#pragma unroll
    for (int k = 1; k < 5; ++k) {
      const uint4 y = __ldg(reinterpret_cast<const uint4*>(rows[k]) + c);
      x.x &= y.x;
      x.y &= y.y;
      x.z &= y.z;
      x.w &= y.w;
    }
    return x;
  } else {
    uint32_t x = __ldg(rows[0] + c);
#pragma unroll
    for (int k = 1; k < 5; ++k) x &= __ldg(rows[k] + c);
    return make_uint4(x, 0u, 0u, 0u);
  }
}

// kG lanes a packet; kVec4: W % 4 == 0 with 16-byte aligned planes
template <int kG, bool kVec4>
__global__ void __launch_bounds__(kBlock) bv_first_set_kernel(
    const int32_t* __restrict__ src_ip, const int32_t* __restrict__ dst_ip,
    const int32_t* __restrict__ proto, const int32_t* __restrict__ sport,
    const int32_t* __restrict__ dport, const int32_t* __restrict__ bnd_src,
    const int32_t* __restrict__ bnd_dst,
    const int32_t* __restrict__ bnd_sport,
    const int32_t* __restrict__ bnd_dport,
    const int32_t* __restrict__ nbnd, const uint32_t* __restrict__ bm_src,
    const uint32_t* __restrict__ bm_dst,
    const uint32_t* __restrict__ bm_sport,
    const uint32_t* __restrict__ bm_dport,
    const uint32_t* __restrict__ bm_proto,
    const int32_t* __restrict__ rx_if, const int32_t* __restrict__ if_table,
    int32_t p, int32_t n_tables, int32_t n_int, int32_t n_proto,
    int32_t words, int32_t n_if, int32_t* __restrict__ enc,
    int32_t* __restrict__ tid_out) {
  constexpr uint32_t kGroupMask = kG == 32 ? kFull : (1u << (kG & 31)) - 1u;
  const int32_t gtid = blockIdx.x * kBlock + threadIdx.x;
  const int32_t lane = threadIdx.x & 31;
  const int32_t g = lane & (kG - 1);  // lane within the packet's group
  const int32_t base_lane = lane & ~(kG - 1);
  if ((gtid - lane) / kG >= p) return;  // the whole warp is past the end
  // a tail warp's lanes past the end repeat the last packet, unstored,
  // so that every lane takes part in the ballots and shuffles
  const int32_t pkt = min(gtid / kG, p - 1);
  const bool store = g == 0 && gtid / kG < p;

  int32_t tid = 0, t = 0;
  if (if_table) {
    int32_t r = rx_if[pkt];
    r = r < 0 ? r + n_if : r;
    r = min(max(r, 0), n_if - 1);
    tid = __ldg(if_table + r);
    t = min(max(tid, 0), n_tables - 1);
  }

  // segment search: the count of live boundaries <= the value
  const int64_t toff = static_cast<int64_t>(t) * n_int;
  const int32_t* bnd[4] = {bnd_src + toff, bnd_dst + toff, bnd_sport + toff,
                           bnd_dport + toff};
  const uint32_t flip[4] = {0u, 0u, 0x80000000u, 0x80000000u};
  const uint32_t val[4] = {static_cast<uint32_t>(src_ip[pkt]),
                           static_cast<uint32_t>(dst_ip[pkt]),
                           static_cast<uint32_t>(sport[pkt]) ^ flip[2],
                           static_cast<uint32_t>(dport[pkt]) ^ flip[3]};
  int32_t n[4], lo[4], hi[4];  // the count lies in [lo, hi]
  bool busy = false;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    n[k] = __ldg(nbnd + t * 4 + k);
    lo[k] = 0;
    hi[k] = max(min(n[k], n_int), 0);
    busy |= hi[k] > lo[k];
  }
  while (__any_sync(kFull, busy)) {
    int32_t step[4];
    bool le[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int32_t span = hi[k] - lo[k];
      step[k] = (span + kG - 1) / kG;
      const int32_t q = lo[k] + (g + 1) * step[k] - 1;
      le[k] = span > 0 && q < hi[k] &&
              (static_cast<uint32_t>(__ldg(bnd[k] + q)) ^ flip[k]) <= val[k];
    }
    busy = false;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // the pivots <= the value are a prefix of the group's lanes
      const int32_t below = __popc(
          (__ballot_sync(kFull, le[k]) >> base_lane) & kGroupMask);
      if (hi[k] > lo[k]) {
        const int32_t lo0 = lo[k];
        lo[k] = lo0 + below * step[k];
        hi[k] = min(hi[k], lo0 + (below + 1) * step[k] - 1);
      }
      busy |= hi[k] > lo[k];
    }
  }
  // the boundary at or below the value, clipped to [0, nbnd) as
  // _segment_of clips it (nbnd >= 1 by construction; a smaller count
  // wraps once, as a negative index does)
  const uint32_t* rows[5];
  const uint32_t* planes[4] = {bm_src, bm_dst, bm_sport, bm_dport};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int32_t r = min(max(lo[k] - 1, 0), n[k] - 1);
    r = max(r < 0 ? r + n_int : r, 0);
    rows[k] = planes[k] + (toff + r) * words;
  }
  const int32_t pr = min(max(proto[pkt], 0), n_proto - 1);
  rows[4] = bm_proto + (static_cast<int64_t>(t) * n_proto + pr) * words;

  // row AND and the first set bit: lane g holds chunks g, g + kG, ...
  constexpr int kWidth = kVec4 ? 4 : 1;  // words a chunk
  const int32_t chunks = words / kWidth;
  uint32_t best = VPP_BV_ENC_MISS;
  for (int32_t c0 = 0; c0 < chunks; c0 += kG * kChunks) {
    uint4 v[kChunks];
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const int32_t c = c0 + u * kG + g;
      v[u] = c < chunks ? and5<kVec4>(rows, c) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const uint32_t w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
      for (int k = 0; k < kWidth; ++k) {
        if (best == VPP_BV_ENC_MISS && w[k] != 0u) {
          // a lane's chunks rise with u, so its first hit is its least
          best = static_cast<uint32_t>((c0 + u * kG + g) * kWidth + k) * 32u +
                 static_cast<uint32_t>(__ffs(static_cast<int>(w[k])) - 1);
        }
      }
    }
    // later rounds only hold higher words: stop once every group has a hit
    const bool has = ((__ballot_sync(kFull, best != VPP_BV_ENC_MISS) >>
                       base_lane) & kGroupMask) != 0u;
    if (__all_sync(kFull, has)) break;
  }
#pragma unroll
  for (int o = kG / 2; o > 0; o >>= 1) {
    best = min(best, __shfl_xor_sync(kFull, best, o));
  }
  if (store) {
    enc[pkt] = static_cast<int32_t>(best);
    if (tid_out) tid_out[pkt] = tid;
  }
}

template <int kG>
void launch(bool vec4, int blocks, cudaStream_t st, const int32_t* src_ip,
            const int32_t* dst_ip, const int32_t* proto,
            const int32_t* sport, const int32_t* dport,
            const int32_t* bnd_src, const int32_t* bnd_dst,
            const int32_t* bnd_sport, const int32_t* bnd_dport,
            const int32_t* nbnd, const int32_t* bm_src,
            const int32_t* bm_dst, const int32_t* bm_sport,
            const int32_t* bm_dport, const int32_t* bm_proto,
            const int32_t* rx_if, const int32_t* if_table, int32_t p,
            int32_t n_tables, int32_t n_int, int32_t n_proto, int32_t words,
            int32_t n_if, int32_t* enc, int32_t* tid) {
  auto kernel = vec4 ? bv_first_set_kernel<kG, true>
                     : bv_first_set_kernel<kG, false>;
  kernel<<<blocks, kBlock, 0, st>>>(
      src_ip, dst_ip, proto, sport, dport, bnd_src, bnd_dst, bnd_sport,
      bnd_dport, nbnd, reinterpret_cast<const uint32_t*>(bm_src),
      reinterpret_cast<const uint32_t*>(bm_dst),
      reinterpret_cast<const uint32_t*>(bm_sport),
      reinterpret_cast<const uint32_t*>(bm_dport),
      reinterpret_cast<const uint32_t*>(bm_proto), rx_if, if_table, p,
      n_tables, n_int, n_proto, words, n_if, enc, tid);
}

}  // namespace

extern "C" int bv_first_set(
    const int32_t* src_ip, const int32_t* dst_ip, const int32_t* proto,
    const int32_t* sport, const int32_t* dport, const int32_t* bnd_src,
    const int32_t* bnd_dst, const int32_t* bnd_sport,
    const int32_t* bnd_dport, const int32_t* nbnd, const int32_t* bm_src,
    const int32_t* bm_dst, const int32_t* bm_sport, const int32_t* bm_dport,
    const int32_t* bm_proto, const int32_t* rx_if, const int32_t* if_table,
    int32_t p, int32_t n_tables, int32_t n_int, int32_t n_proto,
    int32_t words, int32_t n_if, int32_t vec4, int32_t* enc, int32_t* tid,
    void* stream) {
  if (p > 0) {
    const bool wide = words > 32;
    const int64_t threads =
        static_cast<int64_t>(p) * (wide ? kWideLanes : kNarrowLanes);
    const int blocks = static_cast<int>((threads + kBlock - 1) / kBlock);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (wide) {
      launch<kWideLanes>(vec4 != 0, blocks, st, src_ip, dst_ip, proto,
                         sport, dport, bnd_src, bnd_dst, bnd_sport,
                         bnd_dport, nbnd, bm_src, bm_dst, bm_sport, bm_dport,
                         bm_proto, rx_if, if_table, p, n_tables, n_int,
                         n_proto, words, n_if, enc, tid);
    } else {
      launch<kNarrowLanes>(vec4 != 0, blocks, st, src_ip, dst_ip, proto,
                           sport, dport, bnd_src, bnd_dst, bnd_sport,
                           bnd_dport, nbnd, bm_src, bm_dst, bm_sport,
                           bm_dport, bm_proto, rx_if, if_table, p, n_tables,
                           n_int, n_proto, words, n_if, enc, tid);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
