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
// operations (the hash is 14 of them, 10 on the warp route), so it is
// bound by bytes: at the main path's 912 M values a direction a round,
// ~1.2 ms at 3.35 TB/s.
// Dequantize reads bits/8 bytes and writes 4 bytes a value with ~6
// operations: bound by bytes too.
//
// Two routes, chosen by the wrapper (kernels/quantize/kernel.py:route)
// before the launch; both give the same bytes.
//
// Route "warp" (quantize_pack_warp_kernel, unpack_dequantize_warp_kernel):
// one warp per chunk, 8 warps (8 chunks) a block, no shared memory and no
// __syncthreads.  Lane l holds positions 4l + 128i + {0..3}, i < chunk/128,
// in registers: each value is read once, by a 16-byte float4 load, and a
// warp's load covers 512 contiguous bytes.  The scale is the lane's own
// max-abs followed by a 5-step __shfl_xor_sync max (exact in any order).
// The chunk-constant part of key_combine is hoisted:
// key_combine(h, p) = fmix32(h ^ (p + K)) with K = 0x9E3779B9 + (h << 6) +
// (h >> 2), all uint32 modulo 2^32, so a value costs fmix32 and two
// operations.  The four levels of a float4 pack into one little-endian
// word of 4 * bits bits (level e shifted by bits * e, which is the byte
// layout below) and leave in one store of 1, 2 or 4 bytes a lane, so a
// warp's packed output is contiguous.  Dequantize loads that word once,
// reads the scale once and writes float4s.  Takes chunk a multiple of 128
// up to 1024 (4 to 32 values a lane), n % 4 == 0 (so a float4 is wholly
// inside the row or wholly past n, where it reads 0.0, the mirror's zero
// padding) and 16-byte-aligned pointers; the C entries refuse the rest.
//
// Route "block" (quantize_pack_kernel, unpack_dequantize_kernel): any
// chunk, n and alignment.  One block of 128 threads per chunk (the TPU
// kernel's one grid program per chunk).  The block's max-abs is a
// warp-shuffle max followed by a combine of the four warps' maxima in shared
// memory: no atomics, and max is exact in any order.  Then each thread builds
// whole bytes: it reads the 8/bits values of its byte, hashes each position in
// native uint32, rounds and packs, and makes one byte store.  The ragged tail
// of a row is masked in the load (positions >= n read 0.0, exactly the zero
// padding of the mirror, so the scale and the bytes are unchanged) instead of
// being materialised as padding; dequantize writes only positions < n.

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


// ---- route "warp" ---------------------------------------------------------

constexpr int kWarpChunks = 8;                    // chunks (warps) a block
constexpr int kWarpThreads = 32 * kWarpChunks;

// A lane's packed word: the 4 levels of one float4 group at BITS bits each.
template <int BITS> struct Word;
template <> struct Word<2> { using T = uint8_t; };
template <> struct Word<4> { using T = uint16_t; };
template <> struct Word<8> { using T = uint32_t; };

// The chunk-constant part of key_combine(h, p): 0x9E3779B9 + (h << 6) + (h >> 2).
__device__ __forceinline__ uint32_t key_offset(uint32_t h) {
  return 0x9E3779B9u + (h << 6) + (h >> 2);
}

// Chunk cid = r * nc + j of a warp-route launch, its first position in
// row r, and how many of its positions lie before n.
struct WarpChunk {
  int64_t cid, r, base, valid;
};

template <int CHUNK>
__device__ __forceinline__ WarpChunk warp_chunk(int64_t n, int nc) {
  WarpChunk c;
  c.cid = static_cast<int64_t>(blockIdx.x) * kWarpChunks + (threadIdx.x >> 5);
  c.r = c.cid / nc;
  c.base = (c.cid - c.r * nc) * CHUNK;
  c.valid = n - c.base < CHUNK ? n - c.base : CHUNK;
  return c;
}

template <int BITS, int V>
__global__ void __launch_bounds__(kWarpThreads)
quantize_pack_warp_kernel(const float* __restrict__ v, const int64_t* __restrict__ keys,
                          uint8_t* __restrict__ packed, float* __restrict__ scale_out,
                          int64_t n, int nc, int64_t chunks) {
  constexpr int kChunk = 128 * V;
  using W = typename Word<BITS>::T;
  const WarpChunk c = warp_chunk<kChunk>(n, nc);
  if (c.cid >= chunks) return;                     // the last block's spare warps
  const int lane = threadIdx.x & 31;
  const float4* src = reinterpret_cast<const float4*>(v + c.r * n + c.base) + lane;

  float4 x[V];
#pragma unroll
  for (int i = 0; i < V; ++i)                      // all loads in flight first
    x[i] = 4 * lane + 128 * i < c.valid ? src[32 * i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float m = 0.0f;
#pragma unroll
  for (int i = 0; i < V; ++i)
    m = fmaxf(m, fmaxf(fmaxf(fabsf(x[i].x), fabsf(x[i].y)), fmaxf(fabsf(x[i].z), fabsf(x[i].w))));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xFFFFFFFFu, m, off));

  const float scale = m;
  constexpr float L = static_cast<float>((1 << (BITS - 1)) - 1);
  const float inv = scale > 0.0f ? __fdiv_rn(L, scale) : 0.0f;
  const uint32_t key = static_cast<uint32_t>(keys[c.cid]);
  const uint32_t koff = key_offset(key);
  W* out = reinterpret_cast<W*>(packed + c.cid * (kChunk * BITS / 8)) + lane;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float xs[4] = {x[i].x, x[i].y, x[i].z, x[i].w};
    const uint32_t p0 = static_cast<uint32_t>(4 * lane + 128 * i) + koff;
    uint32_t word = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float h = __uint2float_rn(fmix32(key ^ (p0 + e)));
      const float u = __fmul_rn(h, 0x1p-32f);
      const float q = fminf(fmaxf(floorf(__fadd_rn(__fmul_rn(fabsf(xs[e]), inv), u)), 0.0f), L);
      const float lv = xs[e] < 0.0f ? __fsub_rn(L, q) : __fadd_rn(L, q);
      word |= static_cast<uint32_t>(lv) << (BITS * e);
    }
    out[32 * i] = static_cast<W>(word);
  }
  if (lane == 0) scale_out[c.cid] = scale;
}

template <int BITS, int V>
__global__ void __launch_bounds__(kWarpThreads)
unpack_dequantize_warp_kernel(const uint8_t* __restrict__ packed,
                              const float* __restrict__ scale, float* __restrict__ v,
                              int64_t n, int nc, int64_t chunks) {
  constexpr int kChunk = 128 * V;
  using W = typename Word<BITS>::T;
  const WarpChunk c = warp_chunk<kChunk>(n, nc);
  if (c.cid >= chunks) return;
  const int lane = threadIdx.x & 31;
  const W* in = reinterpret_cast<const W*>(packed + c.cid * (kChunk * BITS / 8)) + lane;
  W words[V];
#pragma unroll
  for (int i = 0; i < V; ++i) words[i] = in[32 * i];
  const float s = scale[c.cid];
  constexpr float L = static_cast<float>((1 << (BITS - 1)) - 1);
  const float recip = __fdiv_rn(1.0f, L);
  constexpr uint32_t kMask = (1u << BITS) - 1u;
  float4* dst = reinterpret_cast<float4*>(v + c.r * n + c.base) + lane;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (4 * lane + 128 * i >= c.valid) continue;   // past n: nothing to write
    const uint32_t w = words[i];
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[e] = __fmul_rn(__fmul_rn(__fsub_rn(__uint2float_rn((w >> (BITS * e)) & kMask), L), s),
                       recip);
    dst[32 * i] = make_float4(o[0], o[1], o[2], o[3]);
  }
}

// Launch a warp-route kernel template at V = chunk / 128 (1..8) and BITS.
template <template <int, int> class Launch, typename... Args>
cudaError_t warp_dispatch(int chunk, int bits, Args... args) {
  const int V = chunk / 128;
#define QUANT_V(B, VV) \
  case VV: Launch<B, VV>::run(args...); break;
#define QUANT_BITS(B)                                                          \
  case B:                                                                      \
    switch (V) {                                                               \
      QUANT_V(B, 1) QUANT_V(B, 2) QUANT_V(B, 3) QUANT_V(B, 4)                  \
      QUANT_V(B, 5) QUANT_V(B, 6) QUANT_V(B, 7) QUANT_V(B, 8)                  \
      default: return cudaErrorInvalidValue;                                   \
    }                                                                          \
    break;
  switch (bits) {
    QUANT_BITS(2) QUANT_BITS(4) QUANT_BITS(8)
    default: return cudaErrorInvalidValue;
  }
#undef QUANT_BITS
#undef QUANT_V
  return cudaGetLastError();
}

template <int BITS, int V>
struct QuantizeWarp {
  static void run(unsigned grid, cudaStream_t stream, const float* v, const int64_t* keys,
                  uint8_t* packed, float* scale, int64_t n, int nc, int64_t chunks) {
    quantize_pack_warp_kernel<BITS, V><<<grid, kWarpThreads, 0, stream>>>(
        v, keys, packed, scale, n, nc, chunks);
  }
};

template <int BITS, int V>
struct DequantizeWarp {
  static void run(unsigned grid, cudaStream_t stream, const uint8_t* packed,
                  const float* scale, float* v, int64_t n, int nc, int64_t chunks) {
    unpack_dequantize_warp_kernel<BITS, V><<<grid, kWarpThreads, 0, stream>>>(
        packed, scale, v, n, nc, chunks);
  }
};

// The inputs the warp route takes (the wrapper's route() decides the same).
bool warp_takes(int64_t n, int chunk, const void* a, const void* b) {
  return chunk % 128 == 0 && chunk >= 128 && chunk <= 1024 && n % 4 == 0 &&
         reinterpret_cast<uintptr_t>(a) % 16 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

}  // namespace

// All four launch on ``stream`` of the current CUDA device (the caller makes
// the tensors' device current) and return the cudaError_t of the launch (0
// when it was accepted).  Route "block": one block per chunk, R * nc blocks.
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

// Route "warp": one warp per chunk, ceil(R * nc / 8) blocks of 256 threads.
// The same arguments as the block entries; chunk must be a multiple of 128
// up to 1024, n % 4 == 0 and the row pointers (v and packed) 16-byte
// aligned, or they return cudaErrorInvalidValue without launching.
extern "C" int quantize_pack_warp_launch(const void* v, const void* keys, void* packed,
                                         void* scale, int64_t rows, int64_t n, int nc,
                                         int chunk, int bits, void* stream) {
  if (!warp_takes(n, chunk, v, packed)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t chunks = rows * nc;
  const unsigned grid = static_cast<unsigned>((chunks + kWarpChunks - 1) / kWarpChunks);
  return static_cast<int>(warp_dispatch<QuantizeWarp>(
      chunk, bits, grid, static_cast<cudaStream_t>(stream), static_cast<const float*>(v),
      static_cast<const int64_t*>(keys), static_cast<uint8_t*>(packed),
      static_cast<float*>(scale), n, nc, chunks));
}

extern "C" int unpack_dequantize_warp_launch(const void* packed, const void* scale, void* v,
                                             int64_t rows, int64_t n, int nc, int chunk,
                                             int bits, void* stream) {
  if (!warp_takes(n, chunk, v, packed)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t chunks = rows * nc;
  const unsigned grid = static_cast<unsigned>((chunks + kWarpChunks - 1) / kWarpChunks);
  return static_cast<int>(warp_dispatch<DequantizeWarp>(
      chunk, bits, grid, static_cast<cudaStream_t>(stream),
      static_cast<const uint8_t*>(packed), static_cast<const float*>(scale),
      static_cast<float*>(v), n, nc, chunks));
}
