// Causal, sliding-window GQA flash attention (forward only), on Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py:
// flash_attention (body _flash_kernel).  For q [B, H, Tq, hd] and k, v
// [B, KV, Tk, hd] (f32 or bf16, all one dtype; kv head = h / (H / KV)):
//
//   s_ij = (q_i . k_j) * scale,  scale = 1 / sqrt(hd)       (fp32 sums)
//   s_ij = -1e30 where j > i, or i - j >= window (window > 0), or j >= Tk
//   o_i  = sum_j softmax_j(s_i) v_j / max(l_i, 1e-30)       (online, fp32)
//
// stored in q's dtype.  Positions are the indices 0..Tq-1 and 0..Tk-1, as in
// the TPU kernel; attention is always causal (the TPU kernel's causal=False
// is on no path of the system).  The plain torch version is
// repro_torch/kernels/flash_attention/ref.py:flash_attention_torch.
//
// Bound on an H100: operations.  At Hymba-1.5B's prefill (B 4, T 2048, H 25,
// KV 5, hd 64, window 1024) a layer has 1,573,376 unmasked (query, key)
// pairs a (batch, head), 4 * hd FLOP each (QK^T and PV): 40.3 GFLOP, 0.041
// ms at the bf16 tensor-core rate of 989 TFLOP/s; the bytes (q, k, v read
// once, o written once) are 62.9 MB, 0.019 ms at 3.35 TB/s.
//
// Design (a first kernel that is right; wgmma and TMA come later): one
// 256-thread block per (query tile of 64 rows, query head, batch).  The
// block stages its Q tile, then each K and V tile of 64 keys, in shared
// memory as fp32, and runs a loop over the key tiles from the window's first
// to the causal last one, so wholly masked tiles are never visited (as the
// TPU kernel's pl.when skips them).  A thread owns a 4 x 4 micro-tile of the
// 64 x 64 scores (rows ty + 16 i, keys tx + 16 j) and 4 rows x hd/16 columns
// of the output accumulator, in registers, with the running max and sum of
// its 4 rows; the 16 threads that share a row reduce over it with warp
// shuffles.  The products are fp32 FMAs on the CUDA cores (67 TFLOP/s at
// most), so the kernel cannot come within 16x of the tensor-core bound.
// The kernel reads q, k and v in the model's [B, T, H, hd] layout through
// the element strides it is given (the head dim must be contiguous), so the
// caller makes no transposed copy.  Rows padded by one float keep the
// shared-memory reads free of bank conflicts.
//
// Masked scores are -1e30, not -inf, as on the TPU: a row whose first
// visited tile is wholly outside its window adds exp(0) = 1 terms, which the
// correction exp(-1e30 - m) rescales to exactly 0 once a real key arrives;
// with Tq <= Tk the row's own key guarantees one does.
// Head dims 1..128 and any Tq, Tk (the ragged last tiles are masked here).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;            // query rows a block
constexpr int kBK = 64;            // keys a tile
constexpr int kThreads = 256;      // 16 x 16 threads, a 4 x 4 score micro-tile each
constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_sh, q_st;      // element strides of q [B, H, Tq, hd]
  long long k_sb, k_sh, k_st;      // of k [B, KV, Tk, hd]
  long long v_sb, v_sh, v_st;      // of v [B, KV, Tk, hd]
  long long o_sb, o_sh, o_st;      // of o [B, H, Tq, hd]
  int group, Tq, Tk, hd, window;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

size_t smem_bytes(int hd) {
  const int ld = hd + 1;
  return sizeof(float) * (size_t(kBQ) * ld + size_t(kBK) * ld + size_t(kBK) * hd +
                          size_t(kBQ) * (kBK + 1));
}

// NC: column chunks of 16 a thread keeps of the output, hd <= 16 * NC
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads) flash_fwd(const Args a) {
  extern __shared__ float smem[];
  const int hd = a.hd, ld = hd + 1;
  float* qs = smem;                    // [kBQ][ld]
  float* ks = qs + kBQ * ld;           // [kBK][ld]
  float* vs = ks + kBK * ld;           // [kBK][hd]
  float* ps = vs + kBK * hd;           // [kBQ][kBK + 1]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.group;
  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  for (int i = tid; i < kBQ * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    qs[r * ld + d] = (q0 + r < a.Tq) ? to_f(qp[(q0 + r) * a.q_st + d]) : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // the key tiles any row of this block can see
  const int last = min(a.Tk - 1, q0 + kBQ - 1);
  const int first = a.window ? max(0, q0 - a.window + 1) : 0;
  for (int k0 = (first / kBK) * kBK; k0 <= last; k0 += kBK) {
    __syncthreads();                   // the previous tile's ks, vs, ps are consumed
    for (int i = tid; i < kBK * hd; i += kThreads) {
      const int r = i / hd, d = i - r * hd;
      const bool in = k0 + r < a.Tk;
      ks[r * ld + d] = in ? to_f(kp[(k0 + r) * a.k_st + d]) : 0.f;
      vs[r * hd + d] = in ? to_f(vp[(k0 + r) * a.v_st + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        const bool ok = key < a.Tk && key <= row && (!a.window || row - key < a.window);
        s[i][j] = ok ? s[i][j] * a.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)       // the row's 16 threads share a half-warp
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        ps[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
      m[i] = m_new;
    }
    __syncthreads();

    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * (kBK + 1) + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        vv[c] = col < hd ? vs[kk * hd + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  T* op = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.Tq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < hd) store(op + row * a.o_st + col, acc[i][c] / denom);
    }
  }
}

template <typename T, int NC>
cudaError_t launch(const Args& a, int B, int H, cudaStream_t stream) {
  const size_t bytes = smem_bytes(a.hd);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd<T, NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tq + kBQ - 1) / kBQ, H, B);
  flash_fwd<T, NC><<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, int B, int H, cudaStream_t stream) {
  if (a.hd <= 16) return launch<T, 1>(a, B, H, stream);
  if (a.hd <= 32) return launch<T, 2>(a, B, H, stream);
  if (a.hd <= 64) return launch<T, 4>(a, B, H, stream);
  return launch<T, 8>(a, B, H, stream);
}

}  // namespace

extern "C" {

// strides: 12 element strides, (batch, head, time) of q, k, v and o in turn;
// scale is 1 / sqrt(hd) rounded to fp32 by the caller.  Returns a cudaError_t
// (0 on success); the head dim must be 1..128 and H a multiple of KV
// (checked by the caller).
int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                           const long long* strides, int B, int H, int KV, int Tq, int Tk,
                           int hd, int window, float scale, int bf16,
                           void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.q_sb = strides[0]; a.q_sh = strides[1]; a.q_st = strides[2];
  a.k_sb = strides[3]; a.k_sh = strides[4]; a.k_st = strides[5];
  a.v_sb = strides[6]; a.v_sh = strides[7]; a.v_st = strides[8];
  a.o_sb = strides[9]; a.o_sh = strides[10]; a.o_st = strides[11];
  a.group = H / KV;
  a.Tq = Tq;
  a.Tk = Tk;
  a.hd = hd;
  a.window = window;
  a.scale = scale;
  if (Tq == 0 || B == 0 || H == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(bf16 ? dispatch<__nv_bfloat16>(a, B, H, s) : dispatch<float>(a, B, H, s));
}

}  // extern "C"
