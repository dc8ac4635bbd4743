// The bf16 mma.sync building blocks the tensor-core kernels share
// (flash_attention.cu: flash_fwd_mma; ssd.cu: ssd_intra_chunk_mma), for
// sm_90a: 16-byte cp.async staging, ldmatrix fragment loads and the
// m16n8k16 product with fp32 sums.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled (nothing read) unless ``valid``
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a b for a 16 x 16 (row) by 16 x 8 (col) bf16 tile, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 and packed, the first in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ float bf16_lo(unsigned x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf16_hi(unsigned x) { return __uint_as_float(x & 0xffff0000u); }

// x rounded to bf16 (hi) and the rest x - hi rounded to bf16 (lo), two pairs
// packed as pack_bf16 packs them: hi + lo carries x to ~2^-17 relative
__device__ __forceinline__ void split_bf16(float x0, float x1, unsigned& hi, unsigned& lo) {
  hi = pack_bf16(x0, x1);
  lo = pack_bf16(x0 - bf16_lo(hi), x1 - bf16_hi(hi));   // x - hi is exact in fp32
}

// the same in three parts: hi + mid + lo carries x to ~2^-26 relative
__device__ __forceinline__ void split3_bf16(float x0, float x1, unsigned& hi, unsigned& mid,
                                            unsigned& lo) {
  hi = pack_bf16(x0, x1);
  split_bf16(x0 - bf16_lo(hi), x1 - bf16_hi(hi), mid, lo);
}

}  // namespace
