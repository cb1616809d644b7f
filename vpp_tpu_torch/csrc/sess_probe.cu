// sess_probe_ways: fused reflective-session bucket probe.
//
// Replaces the TPU kernel vpp_tpu/ops/session.py sess_probe_ways (body
// _sess_probe_kernel). Per packet: read the W ways of the home bucket
// from the six session columns, match the reversed 5-tuple (src, dst,
// packed ports, proto), valid == 1 and now - time <= max_age, and
// return the lowest matching way (found = 0 and first = 0 on a miss:
// the gather rung's any/argmax convention).
//
// Bound on this card: bytes, and below that latency. Each packet reads
// 6 columns x W x 4 B = 96 B at W = 4 from a random bucket of a table
// far larger than L2 (24 MB at 2^20 slots), so the work is P random
// 16-byte row reads per column; at P = 256 the kernel is one wave of
// dependent DRAM reads plus the launch, i.e. launch- and latency-bound.
// Design: one thread per packet (256-thread blocks), the W ways of a
// column are contiguous so each column read is one 16-byte segment;
// no shared memory (nothing is reused across packets). The TPU
// kernel's VMEM-resident columns have no counterpart: the columns stay
// in device memory and each packet gathers its own bucket.
#include <cuda_runtime.h>

#include "kernels.cuh"

namespace {

__global__ void sess_probe_kernel(const int32_t* __restrict__ b,
                                  const int32_t* __restrict__ key_src,
                                  const int32_t* __restrict__ key_dst,
                                  const int32_t* __restrict__ key_ports,
                                  const int32_t* __restrict__ key_proto,
                                  const int32_t* __restrict__ valid,
                                  const int32_t* __restrict__ src,
                                  const int32_t* __restrict__ dst,
                                  const int32_t* __restrict__ ports,
                                  const int32_t* __restrict__ proto,
                                  const int32_t* __restrict__ time,
                                  int32_t p, int32_t ways, int32_t now,
                                  const int32_t* __restrict__ max_age_p,
                                  int32_t* found,
                                  int32_t* first) {
  int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  const int32_t max_age = *max_age_p;
  const int64_t base = static_cast<int64_t>(b[i]) * ways;
  const uint32_t ks = static_cast<uint32_t>(key_src[i]);
  const uint32_t kd = static_cast<uint32_t>(key_dst[i]);
  const uint32_t kp = static_cast<uint32_t>(key_ports[i]);
  const uint32_t kr = static_cast<uint32_t>(key_proto[i]);
  int32_t hit = -1;
  for (int32_t w = 0; w < ways; ++w) {
    const int64_t c = base + w;
    // now - time in int32 with wraparound, as JAX computes it; signed
    // overflow is undefined in C++, so subtract as uint32 and
    // reinterpret
    const int32_t age = static_cast<int32_t>(
        static_cast<uint32_t>(now) - static_cast<uint32_t>(time[c]));
    if (valid[c] == 1 && static_cast<uint32_t>(src[c]) == ks &&
        static_cast<uint32_t>(dst[c]) == kd &&
        static_cast<uint32_t>(ports[c]) == kp &&
        static_cast<uint32_t>(proto[c]) == kr && age <= max_age) {
      hit = w;
      break;
    }
  }
  found[i] = hit >= 0 ? 1 : 0;
  first[i] = hit >= 0 ? hit : 0;
}

}  // namespace

extern "C" int sess_probe_ways(const int32_t* b, const int32_t* key_src,
                               const int32_t* key_dst,
                               const int32_t* key_ports,
                               const int32_t* key_proto,
                               const int32_t* valid, const int32_t* src,
                               const int32_t* dst, const int32_t* ports,
                               const int32_t* proto, const int32_t* time,
                               int32_t p, int32_t ways, int32_t now,
                               const int32_t* max_age, int32_t* found,
                               int32_t* first, void* stream) {
  if (p > 0) {
    const int threads = 256;
    const int blocks = (p + threads - 1) / threads;
    sess_probe_kernel<<<blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        b, key_src, key_dst, key_ports, key_proto, valid, src, dst, ports,
        proto, time, p, ways, now, max_age, found, first);
  }
  return static_cast<int>(cudaGetLastError());
}
