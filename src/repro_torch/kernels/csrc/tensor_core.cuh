// Building blocks of the tensor-core kernels (fused_block_tc.cu,
// flash_attention_tc.cu, ssd_scan_tc.cu) and of the RG-LRU scan's ring
// (rglru_scan.cu): 16- and 4-byte cp.async with zero fill, ldmatrix, and
// the warp-level bfloat16 product mma.sync.m16n8k16 with float32
// accumulators, as inline PTX for sm_80 and later (sm_90a here).
//
// Fragment layouts of m16n8k16 (lane = 4 * g + t, g = lane / 4,
// t = lane % 4), each register two bfloat16 values, the lower column first:
//
//   A [16 x 16], row-major: a0 (row g, cols 2t, 2t+1), a1 (row g + 8),
//                           a2 (row g, cols 2t + 8, 2t + 9), a3 (row g + 8)
//   B [16 x 8]:             b0 (rows 2t, 2t+1, col g),
//                           b1 (rows 2t + 8, 2t + 9, col g)
//   C [16 x 8], float32:    c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g + 8)
//
// ldmatrix.x4 loads four 8 x 8 matrices; lanes 8i .. 8i + 7 give the row
// addresses of matrix i, and every lane gets (row g, cols 2t, 2t+1) of each
// (with .trans: (rows 2t, 2t+1, col g)).  So for a tile stored row-major in
// shared memory at `base` with row stride `ld`:
//
//   A fragment of rows r0.., cols k0..:  base + (r0 + lane % 16) * ld
//                                              + k0 + (lane / 16) * 8
//   B fragments of two n8 tiles from a [k][n] tile (.trans), same address
//   with k for r and n for the column: (r0, r1) the first tile, (r2, r3) the
//   second.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; when !valid the 16
// bytes are zero-filled and nothing is read (src must still be a valid
// address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
    const int n = valid ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(n));
}
// 4 bytes, likewise (through L1: .cg takes 16-byte copies only)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
    const int n = valid ? 4 : 0;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N committed groups are still in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
        "{%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p)));
}

// c += a @ b on one m16n8k16 tile
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bfloat16 (to nearest even), lo in the lower half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
    __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&u);
    return __bfloat1622float2(v);
}

}  // namespace tc
