// On-device stateless RR index generation: the swap-or-not cipher on Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rr_perm/kernel.py:
// rr_indices_kernel (body _rr_kernel).  For every cohort slot c, local step k
// and batch column b it computes
//
//   e     = k / spe[c]                      (epoch)
//   p     = (k % spe[c]) * B + b            (position within the epoch)
//   key_e = key_combine(prekey[c], e)
//   rr:  out = SoN_{key_e}(p mod n)         (`rounds` swap-or-not rounds)
//   wr:  out = fmix32(key_combine(key_e, p)) mod n
//
// bitwise-equal to the numpy mirror and the plain torch version in
// repro_torch/kernels/rr_perm/ref.py.  All arithmetic is uint32 with native
// wraparound.
//
// Bound on an H100: the only device-memory traffic is the C*K*B int32 output
// (4 bytes an element) plus 12 bytes of scalars per slot, so the byte bound
// is 4*C*K*B / 3.35 TB/s.  The work is ~1.1e3 integer ALU operations an
// element in rr mode (24 rounds of two key_combine + one fmix32, two
// modulos, max, select), so the kernel is bound by integer operations
// (~270 operations per output byte) once it has enough elements to fill
// the card; at the main path's cohort shapes (a few hundred elements) it is
// bound by the launch itself.
//
// Design: one thread per output element, a 2-D grid (slot, tile of K*B).
// Each thread reads its slot's three scalars, runs the cipher in registers
// and makes one coalesced int32 store: no shared memory, no reduction, no
// synchronisation.  sizes and spe are clamped to >= 1 so a malformed slot
// never divides by zero (padding slots carry 1 for both).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

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

__global__ void rr_indices_kernel(const int64_t* __restrict__ prekey,
                                  const int32_t* __restrict__ sizes,
                                  const int32_t* __restrict__ spe,
                                  int32_t* __restrict__ out,
                                  int K, int B, int rounds, int wr) {
  const int c = blockIdx.x;
  const int t = blockIdx.y * blockDim.x + threadIdx.x;
  const int kb = K * B;
  if (t >= kb) return;
  const uint32_t n = static_cast<uint32_t>(max(sizes[c], 1));
  const int s = max(spe[c], 1);
  const int k = t / B;
  const int b = t - k * B;
  const int e = k / s;
  const uint32_t p = static_cast<uint32_t>((k - e * s) * B + b);
  const uint32_t key_e = key_combine(static_cast<uint32_t>(prekey[c]),
                                     static_cast<uint32_t>(e));
  uint32_t x;
  if (wr) {
    x = fmix32(key_combine(key_e, p)) % n;
  } else {
    x = p % n;
    for (int r = 0; r < rounds; ++r) {
      const uint32_t kr_key = key_combine(key_e, static_cast<uint32_t>(r));
      const uint32_t kr = fmix32(kr_key) % n;
      const uint32_t partner = (kr + n - x) % n;
      const uint32_t canon = x > partner ? x : partner;
      if (key_combine(kr_key, canon) & 1u) x = partner;
    }
  }
  out[static_cast<int64_t>(c) * kb + t] = static_cast<int32_t>(x);
}

// Does nothing: the yardstick for the card's launch floor, against which
// rr_indices_kernel's time at the main path's few hundred elements is read.
__global__ void empty_kernel() {}

}  // namespace

// Launches on ``stream`` of the current CUDA device (the caller makes the
// tensors' device current); returns the cudaError_t of the launch (0 when
// it was accepted).
extern "C" int rr_indices_launch(const void* prekey, const void* sizes,
                                 const void* spe, void* out, int C, int K,
                                 int B, int rounds, int wr, void* stream) {
  constexpr int kThreads = 256;
  const dim3 grid(C, (K * B + kThreads - 1) / kThreads);
  rr_indices_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(prekey), static_cast<const int32_t*>(sizes),
      static_cast<const int32_t*>(spe), static_cast<int32_t*>(out), K, B,
      rounds, wr);
  return static_cast<int>(cudaGetLastError());
}

// One launch of empty_kernel (a block of one thread) on ``stream``; returns
// the cudaError_t of the launch.
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
