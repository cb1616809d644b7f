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

int sess_probe_ways(const int32_t* b, const int32_t* key_src,
                    const int32_t* key_dst, const int32_t* key_ports,
                    const int32_t* key_proto, const int32_t* valid,
                    const int32_t* src, const int32_t* dst,
                    const int32_t* ports, const int32_t* proto,
                    const int32_t* time, int32_t p, int32_t ways,
                    int32_t now, const int32_t* max_age, int32_t* found,
                    int32_t* first, void* stream);

int bv_first_set(const int32_t* bm_src, const int32_t* bm_dst,
                 const int32_t* bm_sport, const int32_t* bm_dport,
                 const int32_t* bm_proto, const int32_t* row_src,
                 const int32_t* row_dst, const int32_t* row_sport,
                 const int32_t* row_dport, const int32_t* row_proto,
                 const int32_t* table, int32_t p, int32_t n_int,
                 int32_t n_proto, int32_t words, int32_t* enc,
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
