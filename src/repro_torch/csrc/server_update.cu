// Fused FedShuffleMVR server update (App. F) over every parameter tensor in
// one launch, on Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/server_update/kernel.py:
// fused_server_update (body _update_kernel).  For each value of each tensor,
// in fp32:
//
//   ghat = (-d) * inv_eta_l
//   m'   = a * ghat + (1 - a) * m          (1 - a formed in fp32)
//   x'   = x + eta_g * d
//
// x (and d, which the caller casts to x's dtype) are f32 or bf16, m is f32;
// x' is stored in x's dtype, m' in f32.  Bitwise equal to the plain torch
// version repro_torch/kernels/server_update/ref.py:server_update_torch: every
// float operation is a round-to-nearest intrinsic (__fmul_rn, __fadd_rn,
// __fsub_rn), so nothing contracts into an FMA; build without
// --use_fast_math.  eta_g and a come by value; inv_eta_l is read from a
// device scalar, so the caller computes 1 / (local_lr * lr_mult * k_bar)
// on the device without a host synchronisation.
//
// Bound on an H100: bytes.  Per f32 value it reads x, d, m (12 bytes) and
// writes x', m' (8 bytes) and does 6 float operations.  At the CharLM-100M
// leaf set (111 tensors, 114,051,840 values) that is 2.281 GB, 0.681 ms at
// 3.35 TB/s; the 0.68 GFLOP are ~0.02 ms at the fp32 rate.
//
// Design: one launch for all tensors (the JAX wrapper launches once per
// leaf, which would be 111 launches here).  The launch carries a table of
// (x, d, m, x', m' pointers, n, first block) for up to kMaxTensors tensors
// as a __grid_constant__ kernel parameter (16 KB; CUDA 12.1 allows 32 KB of
// parameters).  Each tensor is cut into tiles of kTile values, one block a
// tile; a block finds its tensor by a binary search over the tensors' first
// blocks (the prefix sum of their tile counts) and its offset from there.
// A thread moves 4 consecutive values a step, as one 16-byte load or store
// of each f32 array (8 bytes for bf16) where the tensor's pointers are
// aligned, so a warp covers 512 contiguous bytes; the ragged tail of each
// tensor, and a tensor whose pointers are not aligned, go value by value.
// Outputs are new buffers, never the inputs: the caller may hold both.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#if !defined(CUDART_VERSION) || CUDART_VERSION < 12010
#error "server_update.cu passes a 16 KB kernel parameter: it needs CUDA 12.1 or later"
#endif

namespace {

constexpr int kMaxTensors = 256;
constexpr int kThreads = 256;
constexpr int kVec = 4;                       // values a thread moves a step
constexpr int kSteps = 4;                     // steps a thread takes a tile
constexpr int kTile = kThreads * kVec * kSteps;  // 4096 values a block

struct Leaf {
  const void* x;
  const void* d;
  const float* m;
  void* x_out;
  float* m_out;
  long long n;
  long long block0;                           // first block of this tensor
  int bf16;                                   // x, d, x' are bf16 (else f32)
  int vec;                                    // pointers aligned for kVec loads
};

struct Table {
  Leaf leaf[kMaxTensors];
  int count;
  float eta_g;
  float a;
  const float* inv_eta_l;
};

__device__ __forceinline__ void update(float x, float d, float m, float eta_g, float a,
                                       float one_minus_a, float inv, float& x_new,
                                       float& m_new) {
  const float ghat = __fmul_rn(-d, inv);
  m_new = __fadd_rn(__fmul_rn(a, ghat), __fmul_rn(one_minus_a, m));
  x_new = __fadd_rn(x, __fmul_rn(eta_g, d));
}

__device__ __forceinline__ float load_x(const void* p, long long i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_x(void* p, long long i, float v, int bf16) {
  if (bf16) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(p)[i] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
    server_update_kernel(const __grid_constant__ Table t) {
  const long long b = blockIdx.x;
  // the last tensor whose first block is <= b (tensors of 0 values own no
  // block and share their first block with the next tensor)
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.leaf[mid].block0 <= b) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const Leaf& L = t.leaf[lo];
  const float eta_g = t.eta_g, a = t.a, inv = *t.inv_eta_l;
  const float one_minus_a = __fsub_rn(1.0f, a);
  const long long n = L.n;
  const long long tile0 = (b - L.block0) * kTile;
  for (int s = 0; s < kSteps; ++s) {
    const long long i = tile0 + (long long)s * kThreads * kVec + (long long)threadIdx.x * kVec;
    if (i >= n) break;
    float xv[kVec], dv[kVec], mv[kVec], xn[kVec], mn[kVec];
    if (L.vec && i + kVec <= n) {
      const float4 m4 = reinterpret_cast<const float4*>(L.m + i)[0];
      mv[0] = m4.x; mv[1] = m4.y; mv[2] = m4.z; mv[3] = m4.w;
      if (L.bf16) {
        const uint2 x2 = reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(L.x) + i)[0];
        const uint2 d2 = reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(L.d) + i)[0];
        const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(&x2);
        const __nv_bfloat16* db = reinterpret_cast<const __nv_bfloat16*>(&d2);
        for (int j = 0; j < kVec; ++j) {
          xv[j] = __bfloat162float(xb[j]);
          dv[j] = __bfloat162float(db[j]);
        }
      } else {
        const float4 x4 = reinterpret_cast<const float4*>(static_cast<const float*>(L.x) + i)[0];
        const float4 d4 = reinterpret_cast<const float4*>(static_cast<const float*>(L.d) + i)[0];
        xv[0] = x4.x; xv[1] = x4.y; xv[2] = x4.z; xv[3] = x4.w;
        dv[0] = d4.x; dv[1] = d4.y; dv[2] = d4.z; dv[3] = d4.w;
      }
      for (int j = 0; j < kVec; ++j) {
        update(xv[j], dv[j], mv[j], eta_g, a, one_minus_a, inv, xn[j], mn[j]);
      }
      reinterpret_cast<float4*>(L.m_out + i)[0] = make_float4(mn[0], mn[1], mn[2], mn[3]);
      if (L.bf16) {
        uint2 o;
        __nv_bfloat16* ob = reinterpret_cast<__nv_bfloat16*>(&o);
        for (int j = 0; j < kVec; ++j) ob[j] = __float2bfloat16_rn(xn[j]);
        reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(L.x_out) + i)[0] = o;
      } else {
        reinterpret_cast<float4*>(static_cast<float*>(L.x_out) + i)[0] =
            make_float4(xn[0], xn[1], xn[2], xn[3]);
      }
    } else {
      for (int j = 0; j < kVec && i + j < n; ++j) {
        float xo, mo;
        update(load_x(L.x, i + j, L.bf16), load_x(L.d, i + j, L.bf16), L.m[i + j], eta_g, a,
               one_minus_a, inv, xo, mo);
        L.m_out[i + j] = mo;
        store_x(L.x_out, i + j, xo, L.bf16);
      }
    }
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

}  // namespace

extern "C" {

int server_update_max_tensors() { return kMaxTensors; }

// rows: count x 7 int64 (x, d, m, x_out, m_out pointers, n, bf16 flag).
// Returns a cudaError_t (0 = launched, or nothing to do).
int server_update_launch(const long long* rows, int count, float eta_g, float a,
                         const float* inv_eta_l, void* stream) {
  if (count < 1 || count > kMaxTensors || inv_eta_l == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Table t = {};
  long long blocks = 0;
  for (int k = 0; k < count; ++k) {
    const long long* r = rows + 7 * k;
    Leaf& L = t.leaf[k];
    L.x = reinterpret_cast<const void*>(r[0]);
    L.d = reinterpret_cast<const void*>(r[1]);
    L.m = reinterpret_cast<const float*>(r[2]);
    L.x_out = reinterpret_cast<void*>(r[3]);
    L.m_out = reinterpret_cast<float*>(r[4]);
    L.n = r[5];
    L.bf16 = r[6] != 0;
    if (L.n < 0) return static_cast<int>(cudaErrorInvalidValue);
    const uintptr_t xa = L.bf16 ? 8 : 16;     // bytes of kVec values of x
    L.vec = aligned(L.x, xa) && aligned(L.d, xa) && aligned(L.x_out, xa) &&
            aligned(L.m, 16) && aligned(L.m_out, 16);
    L.block0 = blocks;
    blocks += (L.n + kTile - 1) / kTile;
  }
  t.count = count;
  t.eta_g = eta_g;
  t.a = a;
  t.inv_eta_l = inv_eta_l;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  server_update_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
