// mxu_first_match: bit-plane ACL first match on Hopper's int8 tensor
// cores, with the header bit explode and the first-match min fused in.
//
// Replaces the TPU kernel vpp_tpu/ops/acl_mxu.py mxu_first_match (body
// _classify_kernel) together with the eager explode before it
// (packet_bit_planes). Per packet p and rule column r:
//
//   bits[p, :] = src 0:32 | dst 32:64 | proto 64:72 | sport 72:88 |
//                dport 88:104 | 0 ... (plane j = bit j of the field)
//   mism[p, r] = sum_j bits[p, j] * coeff[r, j] + k[r]
//   enc[p]     = min { r : mism[p, r] == 0 }, else VPP_MXU_ENC_MISS
//
// The operand (ops/acl_mxu.py mxu_operand, built once per swap) is the
// rule-major int8 [R', 128] matrix of the coefficients (-1, 0, 1) with
// k (0..104) folded into the first zero-pad plane, 104; every packet
// carries a constant 1 bit on that plane, so the tensor-core sum IS the
// mismatch count and the epilogue is a compare with 0. All sums are
// small integers: int8 x int8 -> int32 is exact in any order. Each
// 128-byte row stores its eight 16-byte chunks permuted by
// c -> c ^ (r % 8): the 128-byte swizzle that wgmma reads, so any run of
// whole rows starting at a multiple of 8 is a ready shared-memory tile.
//
// Bound on this card: at P = 4,096 and R' = 10,240 the tensor work,
// 2 * P * 128 * R' = 10.7 G int8 operations = ~5.4 us at 1,979 TOP/s
// (dense int8, data sheet); at P = 256 the bytes, the 1.3 MB operand
// plus 24 B per packet = ~0.4 us at 3.35 TB/s. The compare epilogue
// (~2 integer operations per packet and rule) is the same order as the
// tensor work; here it overlaps the products only across the warpgroups
// and CTAs that share an SM, not inside a warpgroup (a warpgroup waits
// for its products, then compares), which PERF.md measures.
//
// Design:
// * A CTA owns 128 packets (two consumer warpgroups of 64) and a
//   contiguous run of 128-rule tiles; the grid is packet blocks x rule
//   splits, sized so that about two CTAs per SM are in flight.
// * The header columns (20 B per packet) are exploded straight into the
//   A tiles in shared memory, in the swizzled layout: no [P, 128]
//   matrix is ever written to device memory.
// * A producer thread keeps a ring of four 16 KB rule tiles in flight,
//   the first four issued before the explode so that they load under
//   it: one cp.async.bulk per tile (the operand is pre-swizzled, so a tile
//   is one contiguous block: no tensor map to encode on the host),
//   completing on a "full" mbarrier; the consumers release the stage on
//   an "empty" mbarrier once their products have read it.
// * Each consumer warpgroup multiplies its A tile by the stage with four
//   wgmma.mma_async m64n128k32 s32.s8.s8 (A and B from shared memory,
//   128-byte swizzle), then scans its 64 accumulator registers from the
//   highest column down with one select each: the last zero written is
//   the lowest matching column. Tiles arrive in column order, so the
//   first tile with a hit fixes the row's answer in this CTA.
// * Rows are combined over the four threads that share them with
//   shuffles, and CTAs over the rule splits with one atomicMin per row
//   into enc, which the wrapper fills with VPP_MXU_ENC_MISS: min is
//   order-free, so the result is deterministic.
// * Ragged edges are masked here: rows past P explode to zero and are
//   never written; the last rule tile copies only its live rows and the
//   epilogue ignores the columns past R'.
#include <cuda_runtime.h>

#include <cstdint>

#include "kernels.cuh"

namespace {

constexpr int kPlanes = 128;                 // int8 planes = bytes per row
constexpr int kKPlane = 104;                 // the plane that carries k
constexpr int kRows = 64;                    // packets per warpgroup
constexpr int kGroups = 2;                   // consumer warpgroups per CTA
constexpr int kN = 128;                      // rules per tile
constexpr int kStages = 4;                   // rule tiles in flight
constexpr int kATile = kRows * kPlanes;      // 8 KB
constexpr int kBTile = kN * kPlanes;         // 16 KB
constexpr int kConsumers = 128 * kGroups;
constexpr int kThreads = kConsumers + 32;    // + the producer warp
constexpr int kSmemBytes =
    1024 + kGroups * kATile + kStages * kBTile + 2 * kStages * 8;
constexpr int kNone = 1 << 20;               // "no zero in this tile"

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spin until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16) from global memory into shared memory by the
// copy engine; completion is counted on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile of 128-byte rows in
// the 128-byte swizzle: start address >> 4, leading byte offset unused
// (K fits one swizzle atom), stride byte offset 1,024 (8 rows), layout 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// d (+)= A[64, 32] x B[128, 32]^T, int8 -> int32; accumulate = 0 starts d.
__device__ __forceinline__ void wgmma_s8(int32_t (&d)[64], uint64_t da,
                                         uint64_t db, int32_t accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products.
__device__ __forceinline__ void fence_regs(int32_t (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Four bits -> four bytes 0/1, lowest bit in the lowest byte.
__device__ __forceinline__ uint32_t spread4(uint32_t b) {
  return (b * 0x00204081u) & 0x01010101u;
}

__global__ void __launch_bounds__(kThreads) mxu_first_match_kernel(
    const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
    const int32_t* __restrict__ proto, const int32_t* __restrict__ sport,
    const int32_t* __restrict__ dport, const int8_t* __restrict__ op,
    int32_t p, int32_t r, int32_t tiles_per_cta, int32_t* __restrict__ enc) {
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles must start on 1,024-byte boundaries
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint8_t* a_s = smem;                             // kGroups x [64, 128]
  uint8_t* b_s = smem + kGroups * kATile;          // kStages x [kN, 128]
  uint64_t* full = reinterpret_cast<uint64_t*>(b_s + kStages * kBTile);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows * kGroups;
  const int tile0 = blockIdx.y * tiles_per_cta;
  const int n_tiles = min(tiles_per_cta, (r + kN - 1) / kN - tile0);

  // tile t of this CTA into its ring stage (by the producer thread)
  auto issue = [&](int t) {
    const int s = t % kStages;
    const int col0 = (tile0 + t) * kN;
    const uint32_t bytes = min(kN, r - col0) * kPlanes;
    mbar_expect_tx(smem_u32(full + s), bytes);
    bulk_load(smem_u32(b_s + s * kBTile),
              op + static_cast<int64_t>(col0) * kPlanes, bytes,
              smem_u32(full + s));
  };
  const bool producer = tid == kConsumers;
  if (producer) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    // the first rule tiles load while the block explodes the headers
    for (int t = 0; t < min(kStages, n_tiles); ++t) issue(t);
  }

  // The explode: thread i writes the 16 planes of chunk i / 128 of
  // packet row i % 128 (neighbouring threads read neighbouring packets).
  // The 128 planes are four 32-bit words: src, dst, proto | sport << 8 |
  // dport << 24, and dport >> 8 with the constant plane 104 set.
  for (int i = tid; i < kRows * kGroups * 8; i += kThreads) {
    const int row = i % (kRows * kGroups);
    const int chunk = i / (kRows * kGroups);
    const int64_t pr = row0 + row;
    uint32_t word = 0;
    if (pr < p) {
      switch (chunk >> 1) {
        case 0:
          word = static_cast<uint32_t>(src[pr]);
          break;
        case 1:
          word = static_cast<uint32_t>(dst[pr]);
          break;
        case 2:
          word = (static_cast<uint32_t>(proto[pr]) & 0xFFu) |
                 ((static_cast<uint32_t>(sport[pr]) & 0xFFFFu) << 8) |
                 (static_cast<uint32_t>(dport[pr]) << 24);
          break;
        default:
          word = ((static_cast<uint32_t>(dport[pr]) >> 8) & 0xFFu) |
                 (1u << (kKPlane - 96));
      }
    }
    const uint32_t b16 = (word >> ((chunk & 1) * 16)) & 0xFFFFu;
    const uint4 v = make_uint4(spread4(b16 & 0xF), spread4((b16 >> 4) & 0xF),
                               spread4((b16 >> 8) & 0xF),
                               spread4((b16 >> 12) & 0xF));
    *reinterpret_cast<uint4*>(a_s + row * kPlanes +
                              ((chunk ^ (row & 7)) * 16)) = v;
  }
  // the A tiles are read by the tensor cores' (async) proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int warp = tid >> 5;
  if (warp == kGroups * 4) {
    // the producer refills each stage once its consumers release it
    if (producer) {
      for (int t = kStages; t < n_tiles; ++t) {
        mbar_wait(smem_u32(empty + t % kStages), ((t / kStages) - 1) & 1);
        issue(t);
      }
    }
    return;
  }

  const int group = warp >> 2;                  // consumer warpgroup
  const int fr = (tid & 31) >> 2;               // fragment row in the warp
  const int fq = tid & 3;                       // thread in the row's quad
  const uint64_t da = sw128_desc(smem_u32(a_s + group * kATile));
  int32_t best_lo = VPP_MXU_ENC_MISS;           // row fr of the warp's 16
  int32_t best_hi = VPP_MXU_ENC_MISS;           // row fr + 8
  int32_t acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    mbar_wait(smem_u32(full + s), (t / kStages) & 1);
    const uint64_t db = sw128_desc(smem_u32(b_s + s * kBTile));
    fence_regs(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < kPlanes / 32; ++ks) {
      // 32 bytes of K = 2 in the descriptor's 16-byte address units
      wgmma_s8(acc, da + 2 * ks, db + 2 * ks, ks);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs(acc);
    mbar_arrive(smem_u32(empty + s));  // the stage has been read

    // accumulator layout (m64nN, 32-bit): acc[4i + e] holds row fr
    // (e < 2) or fr + 8 (e >= 2) of the warp's 16, column 8i + 2fq + e % 2
    int bl_lo = kNone, bl_hi = kNone;
#pragma unroll
    for (int i = kN / 8 - 1; i >= 0; --i) {
      bl_lo = acc[4 * i + 1] == 0 ? 8 * i + 1 : bl_lo;
      bl_lo = acc[4 * i + 0] == 0 ? 8 * i : bl_lo;
      bl_hi = acc[4 * i + 3] == 0 ? 8 * i + 1 : bl_hi;
      bl_hi = acc[4 * i + 2] == 0 ? 8 * i : bl_hi;
    }
    const int col0 = (tile0 + t) * kN;
    const int live = min(kN, r - col0);
    if (best_lo == VPP_MXU_ENC_MISS && bl_lo + 2 * fq < live) {
      best_lo = col0 + bl_lo + 2 * fq;
    }
    if (best_hi == VPP_MXU_ENC_MISS && bl_hi + 2 * fq < live) {
      best_hi = col0 + bl_hi + 2 * fq;
    }
  }

  // the four threads of a quad hold the same two rows
  best_lo = min(best_lo, __shfl_xor_sync(0xffffffffu, best_lo, 1));
  best_lo = min(best_lo, __shfl_xor_sync(0xffffffffu, best_lo, 2));
  best_hi = min(best_hi, __shfl_xor_sync(0xffffffffu, best_hi, 1));
  best_hi = min(best_hi, __shfl_xor_sync(0xffffffffu, best_hi, 2));
  if (fq == 0) {
    const int64_t lo = row0 + group * kRows + (warp & 3) * 16 + fr;
    const int64_t hi = lo + 8;
    if (lo < p && best_lo != VPP_MXU_ENC_MISS) atomicMin(enc + lo, best_lo);
    if (hi < p && best_hi != VPP_MXU_ENC_MISS) atomicMin(enc + hi, best_hi);
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

extern "C" int mxu_first_match(const int32_t* src, const int32_t* dst,
                               const int32_t* proto, const int32_t* sport,
                               const int32_t* dport, const int8_t* op,
                               int32_t p, int32_t r, int32_t* enc,
                               void* stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        mxu_first_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  if (p > 0 && r > 0) {
    const int p_blocks = (p + kRows * kGroups - 1) / (kRows * kGroups);
    const int r_tiles = (r + kN - 1) / kN;
    // split the rule axis until about two CTAs per SM are in flight
    int splits = 2 * sm_count() / p_blocks;
    splits = splits < 1 ? 1 : (splits > r_tiles ? r_tiles : splits);
    const int per_cta = (r_tiles + splits - 1) / splits;
    splits = (r_tiles + per_cta - 1) / per_cta;
    const dim3 grid(p_blocks, splits);
    mxu_first_match_kernel<<<grid, kThreads, kSmemBytes,
                             static_cast<cudaStream_t>(stream)>>>(
        src, dst, proto, sport, dport, op, p, r, per_cta, enc);
  }
  return static_cast<int>(cudaGetLastError());
}
