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

extern "C" {

// now, max_age: device scalars, or null to take now_v / max_age_v
int sess_probe_ways(const int32_t* src_ip, const int32_t* dst_ip,
                    const int32_t* proto, const int32_t* sport,
                    const int32_t* dport, int32_t sym, const int32_t* valid,
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

}  // extern "C"
