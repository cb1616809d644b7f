// sess_probe_ways: the reflective-session lookup of a packet vector in one
// kernel: reversed key, bucket hash, W-way probe and flat slot.
//
// Replaces the TPU kernel vpp_tpu/ops/session.py sess_probe_ways (body
// _sess_probe_kernel) AND the work the reference leaves to XLA around it
// in session_lookup_reverse_idx (vpp_tpu/ops/session.py:308): the
// reversed 5-tuple, the 32-bit bucket mix (_hash_mix, or canon_mix under
// `sess_hash: sym`), the bucket mask, and the flat slot b * W + way.
// Per packet: form the key its session was stored under (dst, src,
// dport << 16 | sport, proto), hash it, read the W ways of the home
// bucket from the six session columns, match the key, valid == 1 and
// now - time <= max_age, and write found (one byte, bool) and
// slot = b * W + the lowest matching way (b * W on a miss: the gather
// rung's any/argmax convention). With tenancy on, the caller passes each
// packet's key tenant kt (the tenant of the reply key's address pair,
// vpp_tpu/ops/session.py tenant_bucket) and the [T] slice planes: the
// bucket is then base[kt] + (mix & mask[kt]), in uint32, on the scalar
// and the 16-byte path alike; a null kt keeps mix & (n_buckets - 1).
//
// Bound on this card: latency and the launch, not bytes. A packet moves
// 20 B of header in, 96 B of bucket rows (six columns x W = 4 ways) and
// 5 B out: ~0.15 us of HBM time at P = 4,096, under the ~1.5 us launch
// floor. At sess_slots = 2^20 the six session columns are 24 MB against
// a 50 MB L2, which the NAT session table's eleven columns (44 MB at the
// same size) share with them, so a bucket is an L2 hit or one DRAM trip.
// What remains is one dependent chain per packet: its header, the hash
// (~20 integer operations), one round of row reads, the compare.
//
// Design:
// * The hash runs in uint32 arithmetic, whose multiplies wrap mod 2^32
//   exactly as the Python's split-constant _mul32 does.
// * At W = 4 each column's bucket row is one 16-byte read, and all six
//   are issued before any compare: no short-circuit chain, no per-way
//   break. Other W (or rows that are not 16-byte aligned) take a scalar
//   loop that still loads every column of a way before comparing it.
// * One thread per packet in 32-thread blocks: P = 4,096 spreads over 128
//   SMs, P = 256 over 8. Nothing is shared between packets, so there is
//   no shared memory.
#include <cuda_runtime.h>

#include <cstdint>

#include "kernels.cuh"

namespace {

constexpr int kBlock = 32;

__device__ __forceinline__ uint32_t pack_ports(int32_t hi, int32_t lo) {
  return (static_cast<uint32_t>(hi) << 16) | static_cast<uint32_t>(lo);
}

// ops/session.py _hash_mix
__device__ __forceinline__ uint32_t hash_mix(uint32_t a, uint32_t b,
                                             uint32_t ports,
                                             uint32_t proto) {
  uint32_t h = (a * 0x9E3779B1u) ^ (b * 0x85EBCA77u) ^
               (ports * 0xC2B2AE3Du) ^ (proto * 0x27D4EB2Fu);
  h ^= h >> 15;
  h *= 0x2545F491u;
  h ^= h >> 13;
  return h;
}

__device__ __forceinline__ int4 row4(const int32_t* col, uint32_t b) {
  return __ldg(reinterpret_cast<const int4*>(col) + b);
}

// now - time in int32 with wraparound, as JAX computes it: subtract as
// uint32 (signed overflow is undefined in C++) and reinterpret
__device__ __forceinline__ bool fresh(int32_t now, int32_t t,
                                      int32_t max_age) {
  return static_cast<int32_t>(static_cast<uint32_t>(now) -
                              static_cast<uint32_t>(t)) <= max_age;
}

__device__ __forceinline__ uint32_t way_match(int32_t v, int32_t s,
                                              int32_t d, int32_t pp,
                                              int32_t pr, int32_t t,
                                              uint32_t ks, uint32_t kd,
                                              uint32_t kp, uint32_t kr,
                                              int32_t now,
                                              int32_t max_age) {
  return (v == 1) & (static_cast<uint32_t>(s) == ks) &
         (static_cast<uint32_t>(d) == kd) &
         (static_cast<uint32_t>(pp) == kp) &
         (static_cast<uint32_t>(pr) == kr) & fresh(now, t, max_age);
}

// kVec4: W = 4 with 16-byte aligned columns (one row read per column)
template <bool kVec4>
__global__ void __launch_bounds__(kBlock) sess_probe_kernel(
    const int32_t* __restrict__ src_ip, const int32_t* __restrict__ dst_ip,
    const int32_t* __restrict__ proto, const int32_t* __restrict__ sport,
    const int32_t* __restrict__ dport, int32_t sym,
    const int32_t* __restrict__ kt, const int32_t* __restrict__ tnt_base,
    const int32_t* __restrict__ tnt_mask,
    const int32_t* __restrict__ valid, const int32_t* __restrict__ src,
    const int32_t* __restrict__ dst, const int32_t* __restrict__ ports,
    const int32_t* __restrict__ prot, const int32_t* __restrict__ time,
    int32_t p, int32_t n_buckets, int32_t ways,
    const int32_t* __restrict__ now_p, int32_t now_v,
    const int32_t* __restrict__ max_age_p, int32_t max_age_v,
    uint8_t* __restrict__ found, int32_t* __restrict__ slot) {
  const int32_t i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= p) return;
  const uint32_t s = static_cast<uint32_t>(src_ip[i]);
  const uint32_t d = static_cast<uint32_t>(dst_ip[i]);
  const int32_t sp = sport[i];
  const int32_t dp = dport[i];
  const uint32_t pr = static_cast<uint32_t>(proto[i]);
  // the clock and the age limit: device scalars (a captured step reads
  // each replay's values) or values
  const int32_t now = now_p ? __ldg(now_p) : now_v;
  const int32_t max_age = max_age_p ? __ldg(max_age_p) : max_age_v;
  // the reply's key: the forward 5-tuple its session was stored under
  const uint32_t ks = d, kd = s, kp = pack_ports(dp, sp);
  // sym: the direction-invariant canon_mix — endpoints in unsigned
  // order (ports signed on an address tie), so the swapped case is the
  // reversed key itself
  const bool fwd = !sym || s > d || (s == d && sp > dp);
  const uint32_t mix = fwd ? hash_mix(ks, kd, kp, pr)
                           : hash_mix(s, d, pack_ports(sp, dp), pr);
  uint32_t b;
  if (kt) {  // the key tenant's slice
    const int32_t t = kt[i];
    b = static_cast<uint32_t>(__ldg(tnt_base + t)) +
        (mix & static_cast<uint32_t>(__ldg(tnt_mask + t)));
  } else {
    b = mix & static_cast<uint32_t>(n_buckets - 1);
  }
  int32_t first = -1;  // the lowest matching way
  if constexpr (kVec4) {
    const int4 v = row4(valid, b), a = row4(src, b), c = row4(dst, b),
               q = row4(ports, b), r = row4(prot, b), t = row4(time, b);
    const uint32_t hit =  // bit w: way w matches
        way_match(v.x, a.x, c.x, q.x, r.x, t.x, ks, kd, kp, pr, now,
                  max_age) |
        way_match(v.y, a.y, c.y, q.y, r.y, t.y, ks, kd, kp, pr, now,
                  max_age) << 1 |
        way_match(v.z, a.z, c.z, q.z, r.z, t.z, ks, kd, kp, pr, now,
                  max_age) << 2 |
        way_match(v.w, a.w, c.w, q.w, r.w, t.w, ks, kd, kp, pr, now,
                  max_age) << 3;
    first = __ffs(static_cast<int>(hit)) - 1;
  } else {
    const int64_t base = static_cast<int64_t>(b) * ways;
    for (int32_t w = ways - 1; w >= 0; --w) {  // down, no break
      const int64_t k = base + w;
      if (way_match(__ldg(valid + k), __ldg(src + k), __ldg(dst + k),
                    __ldg(ports + k), __ldg(prot + k), __ldg(time + k), ks,
                    kd, kp, pr, now, max_age)) {
        first = w;
      }
    }
  }
  found[i] = first >= 0;
  slot[i] = static_cast<int32_t>(b) * ways + max(first, 0);
}

}  // namespace

extern "C" int sess_probe_ways(const int32_t* src_ip, const int32_t* dst_ip,
                               const int32_t* proto, const int32_t* sport,
                               const int32_t* dport, int32_t sym,
                               const int32_t* kt, const int32_t* tnt_base,
                               const int32_t* tnt_mask,
                               const int32_t* valid, const int32_t* src,
                               const int32_t* dst, const int32_t* ports,
                               const int32_t* prot, const int32_t* time,
                               int32_t p, int32_t n_buckets, int32_t ways,
                               int32_t vec4, const int32_t* now,
                               int32_t now_v, const int32_t* max_age,
                               int32_t max_age_v,
                               uint8_t* found, int32_t* slot, void* stream) {
  if (p > 0) {
    const int blocks = (p + kBlock - 1) / kBlock;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (vec4) {
      sess_probe_kernel<true><<<blocks, kBlock, 0, st>>>(
          src_ip, dst_ip, proto, sport, dport, sym, kt, tnt_base, tnt_mask,
          valid, src, dst, ports,
          prot, time, p, n_buckets, ways, now, now_v, max_age, max_age_v,
          found, slot);
    } else {
      sess_probe_kernel<false><<<blocks, kBlock, 0, st>>>(
          src_ip, dst_ip, proto, sport, dport, sym, kt, tnt_base, tnt_mask,
          valid, src, dst, ports,
          prot, time, p, n_buckets, ways, now, now_v, max_age, max_age_v,
          found, slot);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
