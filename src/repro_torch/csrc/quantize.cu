// Stochastic quantize-pack and unpack-dequantize for the comm plane on Hopper.
//
// Replaces the Pallas TPU kernels src/repro/kernels/quantize/kernel.py:
// quantize_pack_kernel (body _quantize_kernel) and unpack_dequantize_kernel
// (body _dequantize_kernel).  Input rows v[R, n] f32 are cut into
// nc = ceil(n / chunk) chunks; for chunk j of row r with key k = keys[r, j]:
//
//   scale = max_p |v[p]|                          (0 for an all-zero chunk)
//   inv   = scale > 0 ? L / scale : 0             L = 2^(bits-1) - 1
//   u     = float(key_combine(k, p)) * 2^-32      (round to nearest even)
//   q     = clamp(floor(|v[p]| * inv + u), 0, L)
//   lv    = v[p] < 0 ? L - q : L + q              (in [0, 2L])
//
// and the levels are packed 8/bits to the byte, level p % (8/bits) of a byte
// shifted by bits * (p % (8/bits)).  Dequantization is ((lv - L) * scale) *
// (1/L).  Bitwise equal to the numpy mirror and the plain torch version in
// repro_torch/kernels/quantize/ref.py.  Every float operation is an explicit
// round-to-nearest intrinsic (__fdiv_rn, __fmul_rn, __fadd_rn, __fsub_rn,
// __uint2float_rn), so the compiler cannot contract a multiply and an add
// into an FMA, which would move floor() at level boundaries and change the
// bytes; build without --use_fast_math.
//
// Bound on an H100: quantize reads 4 bytes a value (plus 8 bytes of key a
// chunk) and writes bits/8 bytes a value (plus a 4-byte scale a chunk); at
// 4 bits that is ~4.6 bytes a value against ~29 integer and float
// operations (the hash is 14 of them), so it is bound by bytes: at the
// main path's 912 M values a direction a round, ~1.2 ms at 3.35 TB/s.
// Dequantize reads bits/8 bytes and writes 4 bytes a value with ~6
// operations: bound by bytes too.
//
// Design: one block of 128 threads per chunk (the TPU kernel's one grid
// program per chunk).  The block's max-abs is a warp-shuffle max followed
// by a combine of the four warps' maxima in shared memory: no atomics, and
// max is exact in any order.  Then each thread builds whole bytes: it reads
// the 8/bits values of its byte, hashes each position in native uint32,
// rounds and packs, and makes one byte store.  The ragged tail of a row is
// masked in the load (positions >= n read 0.0, exactly the zero padding of
// the mirror, so the scale and the bytes are unchanged) instead of being
// materialised as padding; dequantize writes only positions < n.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t key_combine(uint32_t h, uint32_t v) {
  return fmix32(h ^ (v + 0x9E3779B9u + (h << 6) + (h >> 2)));
}

__global__ void __launch_bounds__(kThreads)
quantize_pack_kernel(const float* __restrict__ v, const int64_t* __restrict__ keys,
                     uint8_t* __restrict__ packed, float* __restrict__ scale_out,
                     int64_t n, int nc, int chunk, int bits) {
  __shared__ float warp_max[kThreads / 32];
  const int64_t cid = blockIdx.x;                  // chunk id = r * nc + j
  const int64_t r = cid / nc;
  const int64_t j = cid - r * nc;
  const float* row = v + r * n;
  const int64_t base = j * chunk;                  // first position in the row
  const int64_t valid = n - base < chunk ? n - base : chunk;

  float m = 0.0f;
  for (int p = threadIdx.x; p < valid; p += kThreads) m = fmaxf(m, fabsf(row[base + p]));
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xFFFFFFFFu, m, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  float scale = warp_max[0];
  for (int w = 1; w < kThreads / 32; ++w) scale = fmaxf(scale, warp_max[w]);

  const float L = static_cast<float>((1 << (bits - 1)) - 1);
  const float inv = scale > 0.0f ? __fdiv_rn(L, scale) : 0.0f;
  const uint32_t key = static_cast<uint32_t>(keys[cid]);
  const int per = 8 / bits;
  const int pb = chunk / per;
  uint8_t* out = packed + cid * pb;
  for (int b = threadIdx.x; b < pb; b += kThreads) {
    uint32_t byte = 0;
    for (int e = 0; e < per; ++e) {
      const int p = b * per + e;
      const float x = p < valid ? row[base + p] : 0.0f;
      const float h = __uint2float_rn(key_combine(key, static_cast<uint32_t>(p)));
      const float u = __fmul_rn(h, 0x1p-32f);
      const float q = fminf(fmaxf(floorf(__fadd_rn(__fmul_rn(fabsf(x), inv), u)), 0.0f), L);
      const float lv = x < 0.0f ? __fsub_rn(L, q) : __fadd_rn(L, q);
      byte |= static_cast<uint32_t>(lv) << (bits * e);
    }
    out[b] = static_cast<uint8_t>(byte);
  }
  if (threadIdx.x == 0) scale_out[cid] = scale;
}

__global__ void __launch_bounds__(kThreads)
unpack_dequantize_kernel(const uint8_t* __restrict__ packed, const float* __restrict__ scale,
                         float* __restrict__ v, int64_t n, int nc, int chunk, int bits) {
  const int64_t cid = blockIdx.x;
  const int64_t r = cid / nc;
  const int64_t j = cid - r * nc;
  const int64_t base = j * chunk;
  const int64_t valid = n - base < chunk ? n - base : chunk;
  const float L = static_cast<float>((1 << (bits - 1)) - 1);
  const float recip = __fdiv_rn(1.0f, L);
  const float s = scale[cid];
  const int per = 8 / bits;
  const uint32_t mask = (1u << bits) - 1u;
  const uint8_t* in = packed + cid * (chunk / per);
  float* row = v + r * n;
  for (int p = threadIdx.x; p < valid; p += kThreads) {
    const uint32_t lv = (static_cast<uint32_t>(in[p / per]) >> (bits * (p % per))) & mask;
    row[base + p] = __fmul_rn(__fmul_rn(__fsub_rn(__uint2float_rn(lv), L), s), recip);
  }
}

}  // namespace

// Both launch on ``stream`` of the current CUDA device (the caller makes the
// tensors' device current) with one block per chunk, R * nc blocks; they
// return the cudaError_t of the launch (0 when it was accepted).
extern "C" int quantize_pack_launch(const void* v, const void* keys, void* packed,
                                    void* scale, int64_t rows, int64_t n, int nc,
                                    int chunk, int bits, void* stream) {
  quantize_pack_kernel<<<static_cast<unsigned>(rows * nc), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<const int64_t*>(keys),
      static_cast<uint8_t*>(packed), static_cast<float*>(scale), n, nc, chunk, bits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int unpack_dequantize_launch(const void* packed, const void* scale, void* v,
                                        int64_t rows, int64_t n, int nc, int chunk,
                                        int bits, void* stream) {
  unpack_dequantize_kernel<<<static_cast<unsigned>(rows * nc), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), static_cast<const float*>(scale),
      static_cast<float*>(v), n, nc, chunk, bits);
  return static_cast<int>(cudaGetLastError());
}
