// mxu_first_match: bit-plane ACL first match as a tensor-core product
// with a fused first-match epilogue.
//
// Replaces the TPU kernel vpp_tpu/ops/acl_mxu.py mxu_first_match (body
// _classify_kernel). Per packet p and rule column r:
//
//   mism[p, r] = sum_j bits[p, j] * coeff_t[r, j] + k[r]
//   enc[p]     = min { r : mism[p, r] == 0 }, else VPP_MXU_ENC_MISS
//
// Domain: bits in {0, 1}, coeff_t in {-1, 0, 1} (both bf16, 128 planes),
// k integral float32. Every product and partial sum is then a small
// integer (|sum| <= 128 + k), so the float32 accumulation of the tensor
// cores is exact in any order and `== 0.0f` is an exact test. The
// [P, R'] mismatch matrix never reaches device memory.
//
// Bound on this card: at P = 256 and R' = 10,240 the bytes, ~2.7 MB
// (the bf16 coefficients 2.6 MB, k, bits and enc) = ~0.8 us at
// 3.35 TB/s; at P = 4,096 the tensor work, 2 * P * 128 * R' = 10.7
// GFLOP = ~11 us at 989 TFLOP/s dense bf16 (reckoned from the shapes
// and the data sheet).
//
// Design (a first, right kernel): a block of 4 warps owns a tile of 64
// packets; it stages the [64, 128] bits tile in shared memory once and
// keeps each warp's A fragments (16 packets x 128 planes) in registers.
// It then walks its share of the rule axis in tiles of 64 rules — the
// loop stands in for the TPU grid's sequential rule axis — staging each
// [64, 128] coefficient tile (rule-major, K-contiguous: the natural
// "col" B operand) and k in shared memory. Products are mma.sync
// m16n8k16 bf16 x bf16 -> f32 (inline PTX; the accumulator layout is
// the documented one, so the epilogue reads it from registers). The
// epilogue keeps a running per-row min in registers, reduces it over the
// 4 threads that share a row, and lowers enc with atomicMin. The rule
// axis is also split across blocks (grid.y) so that a small P still
// fills the card; the wrapper fills enc with VPP_MXU_ENC_MISS first,
// and min is order-free, so the result is deterministic. Rows are
// padded by 8 bf16 in shared memory so fragment loads hit 32 distinct
// banks. Ragged P and R' are masked here (zero rows, k = 1 columns):
// no padded copy is made. wgmma, TMA and double buffering are later
// work.
#include <cuda_runtime.h>

#include <cstdint>

#include "kernels.cuh"

namespace {

constexpr int kPlanes = 128;
constexpr int kRowsPerBlock = 64;   // packets per block: 4 warps x 16
constexpr int kRulesPerTile = 64;   // rules per staged tile: 8 x n8
constexpr int kStride = kPlanes + 8;  // bf16 per shared row (272 bytes)
constexpr int kThreads = 128;
constexpr int kChunks = kPlanes / 8;  // 16-byte chunks per row

__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Stage `rows` rows of 128 bf16 from `src` (row-major, stride 128) into
// shared memory with stride kStride; rows at or past `limit` are zero.
__device__ __forceinline__ void stage_rows(uint16_t* dst,
                                           const uint16_t* __restrict__ src,
                                           int64_t first, int64_t limit,
                                           int rows) {
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int row = i / kChunks;
    const int chunk = i % kChunks;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (first + row < limit) {
      v = reinterpret_cast<const uint4*>(src + (first + row) * kPlanes)[chunk];
    }
    *reinterpret_cast<uint4*>(dst + row * kStride + chunk * 8) = v;
  }
}

__global__ void __launch_bounds__(kThreads) mxu_first_match_kernel(
    const uint16_t* __restrict__ bits, const uint16_t* __restrict__ coeff_t,
    const float* __restrict__ k, int32_t p, int32_t r,
    int32_t tiles_per_block, int32_t* __restrict__ enc) {
  __shared__ __align__(16) uint16_t a_s[kRowsPerBlock * kStride];
  __shared__ __align__(16) uint16_t b_s[kRulesPerTile * kStride];
  __shared__ float k_s[kRulesPerTile];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock;

  stage_rows(a_s, bits, row0, p, kRowsPerBlock);
  __syncthreads();

  // this warp's A fragments (rows warp*16 .. +15) for all 8 k-steps
  uint32_t a[8][4];
  const uint16_t* aw = a_s + warp * 16 * kStride;
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    const int c = ks * 16 + t * 2;
    a[ks][0] = lds32(aw + g * kStride + c);
    a[ks][1] = lds32(aw + (g + 8) * kStride + c);
    a[ks][2] = lds32(aw + g * kStride + c + 8);
    a[ks][3] = lds32(aw + (g + 8) * kStride + c + 8);
  }

  int32_t best_lo = VPP_MXU_ENC_MISS;  // row g of the warp's 16
  int32_t best_hi = VPP_MXU_ENC_MISS;  // row g + 8
  const int64_t tile0 = static_cast<int64_t>(blockIdx.y) * tiles_per_block;
  for (int64_t tile = tile0; tile < tile0 + tiles_per_block; ++tile) {
    const int64_t col0 = tile * kRulesPerTile;
    if (col0 >= r) break;  // the same for every thread of the block
    __syncthreads();       // the previous tile has been read
    stage_rows(b_s, coeff_t, col0, r, kRulesPerTile);
    if (threadIdx.x < kRulesPerTile) {
      const int64_t col = col0 + threadIdx.x;
      k_s[threadIdx.x] = col < r ? k[col] : 1.0f;  // padding never matches
    }
    __syncthreads();
#pragma unroll
    for (int nt = 0; nt < kRulesPerTile / 8; ++nt) {
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const uint16_t* bw = b_s + (nt * 8 + g) * kStride + t * 2;
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        mma_16816(acc, a[ks], lds32(bw + ks * 16), lds32(bw + ks * 16 + 8));
      }
      // accumulator: acc[0..1] row g, acc[2..3] row g + 8, columns
      // nt * 8 + t * 2 + {0, 1}
      const int c = nt * 8 + t * 2;
      const int32_t col = static_cast<int32_t>(col0) + c;
      if (acc[0] + k_s[c] == 0.0f) best_lo = min(best_lo, col);
      if (acc[1] + k_s[c + 1] == 0.0f) best_lo = min(best_lo, col + 1);
      if (acc[2] + k_s[c] == 0.0f) best_hi = min(best_hi, col);
      if (acc[3] + k_s[c + 1] == 0.0f) best_hi = min(best_hi, col + 1);
    }
  }

  // the 4 threads of a group hold the same two rows
  best_lo = min(best_lo, __shfl_xor_sync(0xffffffffu, best_lo, 1));
  best_lo = min(best_lo, __shfl_xor_sync(0xffffffffu, best_lo, 2));
  best_hi = min(best_hi, __shfl_xor_sync(0xffffffffu, best_hi, 1));
  best_hi = min(best_hi, __shfl_xor_sync(0xffffffffu, best_hi, 2));
  if (t == 0) {
    const int64_t lo = row0 + warp * 16 + g;
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

extern "C" int mxu_first_match(const void* bits, const void* coeff_t,
                               const float* k, int32_t p, int32_t r,
                               int32_t* enc, void* stream) {
  if (p > 0 && r > 0) {
    const int p_tiles = (p + kRowsPerBlock - 1) / kRowsPerBlock;
    const int r_tiles = (r + kRulesPerTile - 1) / kRulesPerTile;
    // split the rule axis until about two blocks per SM are in flight
    int splits = (2 * sm_count() + p_tiles - 1) / p_tiles;
    splits = splits < 1 ? 1 : (splits > r_tiles ? r_tiles : splits);
    const int per_block = (r_tiles + splits - 1) / splits;
    splits = (r_tiles + per_block - 1) / per_block;
    const dim3 grid(p_tiles, splits);
    mxu_first_match_kernel<<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint16_t*>(bits),
        static_cast<const uint16_t*>(coeff_t), k, p, r, per_block, enc);
  }
  return static_cast<int>(cudaGetLastError());
}
