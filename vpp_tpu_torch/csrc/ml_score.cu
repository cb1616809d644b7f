// ml_score: the per-packet ML stage of a packet vector in one kernel:
// features, centering, the int8 model and the policy.
//
// Replaces the stage the reference computes in plain jnp, which has no
// Pallas kernel: vpp_tpu/ops/mlscore.py ml_features, _centered,
// _mlp_partial / _forest_partial, ml_score and ml_policy (with the
// flow hash of vpp_tpu/ops/telemetry.py tel_flow_hash). Per packet:
// the 18 uint8 features of the post-NAT-reverse header, the session
// hit and its age, centered to x - 128; then either the MLP
// (a1 = xc . W1 + b1 in int32, relu, q1 = clip(a1 >> s1, 0, 255),
// score = (q1 - 128) . w2 + b2) or the oblivious forest (per level the
// selected feature + 128 against its threshold gives a bit of the leaf
// index; the trees' leaf votes are summed, + b2); then flagged = alive &
// score > thresh and the drop request of the action (drop: flagged;
// ratelimit: flagged and (flow hash & (2^rl_shift - 1)) != 0). With
// tenancy on, each packet's tenant id tid keys the per-tenant policy
// (vpp_tpu/ops/mlscore.py ml_policy): the tenant's threshold unless it
// is the inherit sentinel, nothing flagged under mode off, drops only
// under inherit or enforce.
//
// Bound on this card: the launch. A packet moves 38 B in and 6 B out
// (~0.05 us of HBM time at P = 4,096) and does 18 x 16 + 16 multiply-adds
// at H = 16 (~0.04 us of the int32 lanes at P = 4,096), both under the
// ~2 us a launch takes.
//
// Design:
// * One thread per packet, 64-thread blocks; nothing is shared between
//   packets but the model.
// * The model is staged in shared memory once per block as int32 words:
//   W1 [18, H], b1, w2 for the MLP (1,280 B at H = 16), the feature
//   indices, thresholds and leaf votes for the forest. Every thread of a
//   warp reads the same word (a broadcast).
// * Every model value and policy scalar (s1, b2, thresh, action,
//   rl_shift) is read through a device pointer, never passed by value:
//   a model swap writes them in place, and a captured step replays with
//   the new ones.
// * The kind is a template parameter. The sums run in uint32, so an
//   int32 overflow of a bias sum wraps as the reference's int32 does
//   (and as signed arithmetic in C++ need not); every shift of the flow
//   hash is on uint32, so it is logical.
#include <cuda_runtime.h>

#include <cstdint>

#include "kernels.cuh"

namespace {

constexpr int kBlock = 64;
constexpr int kFeatures = VPP_ML_FEATURES;

// vpp_tpu/ops/telemetry.py tel_flow_hash
__device__ __forceinline__ uint32_t flow_hash(uint32_t s, uint32_t d,
                                              int32_t sp, int32_t dp,
                                              int32_t pr) {
  const uint32_t ports = (static_cast<uint32_t>(sp) << 16) |
                         (static_cast<uint32_t>(dp) & 0xFFFFu);
  const uint32_t h = (s * 0x9E3779B1u) ^ (d * 0x85EBCA77u) ^
                     (ports * 0xC2B2AE3Du) ^
                     (static_cast<uint32_t>(pr) * 0x27D4EB2Fu);
  return h ^ (h >> 15);
}

__device__ __forceinline__ int32_t byte_of(int32_t v) { return v & 0xFF; }

template <int kKind>
__global__ void __launch_bounds__(kBlock) ml_score_kernel(
    const int32_t* __restrict__ src_ip, const int32_t* __restrict__ dst_ip,
    const int32_t* __restrict__ proto, const int32_t* __restrict__ sport,
    const int32_t* __restrict__ dport, const int32_t* __restrict__ pkt_len,
    const int32_t* __restrict__ flags,
    const uint8_t* __restrict__ established,
    const int32_t* __restrict__ sess_age, const uint8_t* __restrict__ alive,
    const int8_t* __restrict__ w1, const int32_t* __restrict__ b1,
    const int32_t* __restrict__ s1_p, const int8_t* __restrict__ w2,
    const int32_t* __restrict__ b2_p, const int32_t* __restrict__ f_feat,
    const int32_t* __restrict__ f_thresh,
    const int32_t* __restrict__ f_leaf, const int32_t* __restrict__ thresh_p,
    const int32_t* __restrict__ action_p,
    const int32_t* __restrict__ rl_shift_p, const int32_t* __restrict__ tid,
    const int32_t* __restrict__ tnt_mode,
    const int32_t* __restrict__ tnt_thresh, int32_t p, int32_t hidden,
    int32_t trees, int32_t depth, int32_t* __restrict__ scores,
    uint8_t* __restrict__ flagged, uint8_t* __restrict__ drop) {
  extern __shared__ int32_t smem[];
  // stage the model (every thread of the block, before any returns)
  if constexpr (kKind == VPP_ML_KIND_MLP) {
    const int nw = kFeatures * hidden;
    for (int k = threadIdx.x; k < nw; k += kBlock) smem[k] = w1[k];
    for (int k = threadIdx.x; k < hidden; k += kBlock) {
      smem[nw + k] = b1[k];
      smem[nw + hidden + k] = w2[k];
    }
  } else {
    const int nl = trees * depth;
    for (int k = threadIdx.x; k < nl; k += kBlock) {
      smem[k] = f_feat[k];
      smem[nl + k] = f_thresh[k];
    }
    const int nleaf = trees << depth;
    for (int k = threadIdx.x; k < nleaf; k += kBlock) {
      smem[2 * nl + k] = f_leaf[k];
    }
  }
  __syncthreads();
  const int32_t i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= p) return;

  // the centered features (ops/mlscore.py ml_features, _centered): each
  // the low byte of its value, minus 128
  const uint32_t s = static_cast<uint32_t>(src_ip[i]);
  const uint32_t d = static_cast<uint32_t>(dst_ip[i]);
  const int32_t sp = sport[i], dp = dport[i], pr = proto[i];
  int32_t xc[kFeatures];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    xc[k] = static_cast<int32_t>((s >> (24 - 8 * k)) & 0xFFu) - 128;
    xc[4 + k] = static_cast<int32_t>((d >> (24 - 8 * k)) & 0xFFu) - 128;
  }
  xc[8] = byte_of(sp >> 8) - 128;
  xc[9] = byte_of(sp) - 128;
  xc[10] = byte_of(dp >> 8) - 128;
  xc[11] = byte_of(dp) - 128;
  xc[12] = byte_of(pr) - 128;
  xc[13] = byte_of(min(pkt_len[i] >> 4, 255)) - 128;
  xc[14] = byte_of(flags[i]) - 128;
  xc[15] = (established[i] ? 255 : 0) - 128;
  xc[16] = min(max(sess_age[i], 0), 255) - 128;
  xc[17] = -128;

  uint32_t acc = 0;  // the partial score, int32 wraparound
  if constexpr (kKind == VPP_ML_KIND_MLP) {
    const int32_t* w1s = smem;
    const int32_t* b1s = smem + kFeatures * hidden;
    const int32_t* w2s = b1s + hidden;
    const uint32_t s1 = static_cast<uint32_t>(__ldg(s1_p));
    for (int j = 0; j < hidden; ++j) {
      uint32_t a = static_cast<uint32_t>(b1s[j]);
#pragma unroll
      for (int f = 0; f < kFeatures; ++f) {
        a += static_cast<uint32_t>(xc[f] * w1s[f * hidden + j]);
      }
      const int32_t r = max(static_cast<int32_t>(a), 0);
      // a shift of 32 or more (or a negative one) gives 0, as in XLA
      const int32_t q = min(s1 < 32u ? r >> s1 : 0, 255);
      acc += static_cast<uint32_t>((q - 128) * w2s[j]);
    }
  } else {
    const int nl = trees * depth;
    const int32_t* feat = smem;
    const int32_t* thr = smem + nl;
    const int32_t* leaf_votes = smem + 2 * nl;
    for (int t = 0; t < trees; ++t) {
      int32_t leaf = 0;
      for (int l = 0; l < depth; ++l) {
        const int32_t fi = feat[t * depth + l];
        // the selected feature, 0 when the index selects none; + 128
        // restores its uint8 value
        int32_t v = 0;
#pragma unroll
        for (int f = 0; f < kFeatures; ++f) v = fi == f ? xc[f] : v;
        leaf |= static_cast<int32_t>(v + 128 > thr[t * depth + l]) << l;
      }
      acc += static_cast<uint32_t>(leaf_votes[(t << depth) + leaf]);
    }
  }
  const int32_t score =
      static_cast<int32_t>(acc + static_cast<uint32_t>(__ldg(b2_p)));

  // the policy (ops/mlscore.py ml_policy), per tenant with tid
  int32_t thresh = __ldg(thresh_p);
  bool scored = true, drop_ok = true;
  if (tid) {
    const int32_t t = tid[i];
    const int32_t mode = __ldg(tnt_mode + t);
    const int32_t t_thr = __ldg(tnt_thresh + t);
    if (t_thr != VPP_ML_TNT_THRESH_INHERIT) thresh = t_thr;
    scored = mode != VPP_ML_TNT_OFF;
    drop_ok = mode == VPP_ML_TNT_INHERIT || mode == VPP_ML_TNT_ENFORCE;
  }
  const bool flag = alive[i] != 0 && score > thresh && scored;
  const int32_t action = __ldg(action_p);
  const uint32_t rl = static_cast<uint32_t>(__ldg(rl_shift_p));
  const uint32_t mask = rl >= 32u ? 0xFFFFFFFFu : (1u << rl) - 1u;
  const bool admit = (flow_hash(s, d, sp, dp, pr) & mask) == 0u;
  scores[i] = score;
  flagged[i] = flag;
  drop[i] = flag && drop_ok &&
            (action == VPP_ML_ACTION_DROP ||
             (action == VPP_ML_ACTION_RATELIMIT && !admit));
}

template <int kKind>
int launch(const int32_t* src_ip, const int32_t* dst_ip,
           const int32_t* proto, const int32_t* sport, const int32_t* dport,
           const int32_t* pkt_len, const int32_t* flags,
           const uint8_t* established, const int32_t* sess_age,
           const uint8_t* alive, const int8_t* w1, const int32_t* b1,
           const int32_t* s1, const int8_t* w2, const int32_t* b2,
           const int32_t* f_feat, const int32_t* f_thresh,
           const int32_t* f_leaf, const int32_t* thresh,
           const int32_t* action, const int32_t* rl_shift,
           const int32_t* tid, const int32_t* tnt_mode,
           const int32_t* tnt_thresh, int32_t p,
           int32_t hidden, int32_t trees, int32_t depth, int32_t smem,
           int32_t* scores, uint8_t* flagged, uint8_t* drop,
           cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ml_score_kernel<kKind>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (p + kBlock - 1) / kBlock;
  ml_score_kernel<kKind><<<blocks, kBlock, smem, st>>>(
      src_ip, dst_ip, proto, sport, dport, pkt_len, flags, established,
      sess_age, alive, w1, b1, s1, w2, b2, f_feat, f_thresh, f_leaf, thresh,
      action, rl_shift, tid, tnt_mode, tnt_thresh, p, hidden, trees, depth,
      scores, flagged, drop);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ml_score(const int32_t* src_ip, const int32_t* dst_ip,
                        const int32_t* proto, const int32_t* sport,
                        const int32_t* dport, const int32_t* pkt_len,
                        const int32_t* flags, const uint8_t* established,
                        const int32_t* sess_age, const uint8_t* alive,
                        const int8_t* w1, const int32_t* b1,
                        const int32_t* s1, const int8_t* w2,
                        const int32_t* b2, const int32_t* f_feat,
                        const int32_t* f_thresh, const int32_t* f_leaf,
                        const int32_t* thresh, const int32_t* action,
                        const int32_t* rl_shift, const int32_t* tid,
                        const int32_t* tnt_mode, const int32_t* tnt_thresh,
                        int32_t p, int32_t kind,
                        int32_t hidden, int32_t trees, int32_t depth,
                        int32_t smem, int32_t* scores, uint8_t* flagged,
                        uint8_t* drop, void* stream) {
  if (p <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == VPP_ML_KIND_FOREST) {
    return launch<VPP_ML_KIND_FOREST>(
        src_ip, dst_ip, proto, sport, dport, pkt_len, flags, established,
        sess_age, alive, w1, b1, s1, w2, b2, f_feat, f_thresh, f_leaf,
        thresh, action, rl_shift, tid, tnt_mode, tnt_thresh, p, hidden,
        trees, depth, smem, scores, flagged, drop, st);
  }
  return launch<VPP_ML_KIND_MLP>(
      src_ip, dst_ip, proto, sport, dport, pkt_len, flags, established,
      sess_age, alive, w1, b1, s1, w2, b2, f_feat, f_thresh, f_leaf, thresh,
      action, rl_shift, tid, tnt_mode, tnt_thresh, p, hidden, trees, depth,
      smem, scores, flagged, drop, st);
}
