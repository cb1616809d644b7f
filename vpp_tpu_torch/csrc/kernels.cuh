// Plain C interface of the vpp_tpu_torch CUDA kernels.
//
// Each entry launches its kernel on `stream` (a cudaStream_t passed as
// void*), does not synchronise, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper (ctypes) can raise on a
// refused launch. Every uint32 table field arrives as the int32 tensor
// holding the same bits (vpp_tpu_torch/pipeline/vector.py); the kernels
// reinterpret them as uint32_t where the reference computes unsigned.
#pragma once

#include <cstdint>

// Encoded "no rule matched" of bv_first_set (vpp_tpu/ops/acl_bv.py
// BV_ENC_MISS): every real rule index is < 32 * W <= 2^20.
#define VPP_BV_ENC_MISS 0x7FFFFFF

// Encoded "no rule matched" of mxu_first_match (vpp_tpu/ops/acl_mxu.py
// ENC_MISS): 27 bits, above every rule column.
#define VPP_MXU_ENC_MISS 0x7FFFFFF

// The ML stage (vpp_tpu/ops/mlscore.py): the feature-vector width
// (vpp_tpu/ml/model.py ML_FEATURES), the model kinds (ML_KIND_*) and the
// actions the policy drops on (ML_ACTION_*).
#define VPP_ML_FEATURES 18
#define VPP_ML_KIND_MLP 1
#define VPP_ML_KIND_FOREST 2
#define VPP_ML_ACTION_DROP 1
#define VPP_ML_ACTION_RATELIMIT 2
// the per-tenant ML modes (vpp_tpu/tenancy/sched.py ML_MODE_CODES) and
// the threshold that inherits the model's (ML_TNT_THRESH_INHERIT)
#define VPP_ML_TNT_INHERIT 0
#define VPP_ML_TNT_OFF 1
#define VPP_ML_TNT_ENFORCE 3
#define VPP_ML_TNT_THRESH_INHERIT (-2147483647 - 1)

extern "C" {

// now, max_age: device scalars, or null to take now_v / max_age_v;
// kt ([p] key tenants) with tnt_base / tnt_mask ([T]): the bucket is
// tnt_base[kt] + (mix & tnt_mask[kt]); kt null: mix & (n_buckets - 1)
int sess_probe_ways(const int32_t* src_ip, const int32_t* dst_ip,
                    const int32_t* proto, const int32_t* sport,
                    const int32_t* dport, int32_t sym, const int32_t* kt,
                    const int32_t* tnt_base, const int32_t* tnt_mask,
                    const int32_t* valid,
                    const int32_t* src, const int32_t* dst,
                    const int32_t* ports, const int32_t* prot,
                    const int32_t* time, int32_t p, int32_t n_buckets,
                    int32_t ways, int32_t vec4, const int32_t* now,
                    int32_t now_v, const int32_t* max_age,
                    int32_t max_age_v, uint8_t* found, int32_t* slot,
                    void* stream);

// One table (n_tables = 1, rx_if and if_table null) or per-interface
// tables ([T, ...] arrays; tid written per packet)
int bv_first_set(const int32_t* src_ip, const int32_t* dst_ip,
                 const int32_t* proto, const int32_t* sport,
                 const int32_t* dport, const int32_t* bnd_src,
                 const int32_t* bnd_dst, const int32_t* bnd_sport,
                 const int32_t* bnd_dport, const int32_t* nbnd,
                 const int32_t* bm_src, const int32_t* bm_dst,
                 const int32_t* bm_sport, const int32_t* bm_dport,
                 const int32_t* bm_proto, const int32_t* rx_if,
                 const int32_t* if_table, int32_t p, int32_t n_tables,
                 int32_t n_int, int32_t n_proto, int32_t words,
                 int32_t n_if, int32_t vec4, int32_t* enc, int32_t* tid,
                 void* stream);

int lpm_fused_lookup(const int32_t* dst, const int32_t* lens,
                     const int32_t* cnt, const int32_t* pfx,
                     const int32_t* slot, int32_t p, int32_t n_len,
                     int32_t npad, int32_t budget, uint8_t* found,
                     int32_t* out, void* stream);

int mxu_first_match(const int32_t* src, const int32_t* dst,
                    const int32_t* proto, const int32_t* sport,
                    const int32_t* dport, const int8_t* op, int32_t p,
                    int32_t r, int32_t* enc, void* stream);

// kind: VPP_ML_KIND_MLP or VPP_ML_KIND_FOREST; every model value and
// policy scalar by device pointer; tid ([p] tenant ids) with tnt_mode /
// tnt_thresh ([T]): the per-tenant policy (tid null: the global one);
// smem: the block's dynamic shared memory in bytes (the staged model)
int ml_score(const int32_t* src_ip, const int32_t* dst_ip,
             const int32_t* proto, const int32_t* sport,
             const int32_t* dport, const int32_t* pkt_len,
             const int32_t* flags, const uint8_t* established,
             const int32_t* sess_age, const uint8_t* alive,
             const int8_t* w1, const int32_t* b1, const int32_t* s1,
             const int8_t* w2, const int32_t* b2, const int32_t* f_feat,
             const int32_t* f_thresh, const int32_t* f_leaf,
             const int32_t* thresh, const int32_t* action,
             const int32_t* rl_shift, const int32_t* tid,
             const int32_t* tnt_mode, const int32_t* tnt_thresh, int32_t p,
             int32_t kind,
             int32_t hidden, int32_t trees, int32_t depth, int32_t smem,
             int32_t* scores, uint8_t* flagged, uint8_t* drop,
             void* stream);

}  // extern "C"
