// Mamba2 SSD intra-chunk kernel (forward only), on Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd/kernel.py:
// ssd_intra_chunk (body _ssd_kernel).  For each (batch b, chunk c, head h),
// with xdt [Bz, nc, Q, H, P] (f32 or bf16), a [Bz, nc, Q, H] f32 log decays
// and B, C [Bz, nc, Q, N] (f32 or bf16), all in fp32:
//
//   cum_i = a_0 + ... + a_i
//   y_ip  = sum_{j <= i} exp(cum_i - cum_j) * (C_i . B_j) * xdt_jp     [Q, P]
//   S_pn  = sum_j exp(cum_{Q-1} - cum_j) * B_jn * xdt_jp              [P, N]
//
// y [Bz, nc, Q, H, P] and S [Bz, nc, H, P, N] are fp32.  The plain torch
// version is repro_torch/kernels/ssd/ref.py:ssd_intra_chunk_torch.
//
// Mask before the exp: the TPU kernel (kernel.py:38-39) forms exp(cum_i -
// cum_j) over the whole Q x Q square and multiplies by the triangle after,
// so under strong decay the upper triangle overflows and inf * 0 gives NaN.
// This kernel computes the exponential only for j <= i, where cum_i - cum_j
// <= 0 for decays a <= 0.
//
// Bound on an H100: bytes.  At Hymba-1.5B's prefill (Bz 4, nc 16, Q 128,
// H 25, P 64, N 16) a layer reads xdt (bf16, 26.2 MB), a, B and C, and writes
// y (fp32, 52.4 MB) and S (6.6 MB): 86.5 MB, 0.026 ms at 3.35 TB/s; its
// ~2.2 GFLOP take 0.033 ms even at the fp32 rate.
//
// Design (a first kernel that is right): one 256-thread block per (head,
// chunk, batch), 1,600 blocks at Hymba's prefill.  The block stages the
// chunk's xdt column of its head [Q, P], B and C [Q, N] (rows padded by one
// float, so the column walks below have no bank conflicts) and a in shared
// memory as fp32; warp 0 forms cum with a warp scan (each lane sums Q/32
// consecutive steps, then a shuffle scan over the lanes' totals), and the
// decays to the chunk's end exp(cum_{Q-1} - cum_j) once.  S is one output a
// thread, P * N of them.  y goes in row blocks of 32: the block first fills
// the masked matrix L_ij = exp(cum_i - cum_j) (C_i . B_j) for j <= i of
// those rows in shared memory (C . B^T is recomputed per head, N FMAs an
// entry), then each thread sums one (i, p) of y over j <= i.  Shared
// memory at Hymba's tile: 67.7 KB.  A tile beyond the card's shared memory a
// block (mamba2-1.3b's Q 256, N 128 needs 364 KB) is refused before the
// launch; tiling it is a later kernel's work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRB = 32;            // rows of y a pass

struct Args {
  const void* xdt;
  const float* a;
  const void* B;
  const void* C;
  float* y;
  float* S;
  int nc, Q, H, P, N;
  int x_bf16, bc_bf16;             // xdt is bf16; B and C are bf16 (else f32)
};

__device__ __forceinline__ float load(const void* p, long long i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

size_t smem_floats(int Q, int P, int N) {
  return size_t(Q) * P + 2 * size_t(Q) * (N + 1) + 2 * size_t(Q) + size_t(kRB) * (Q + 1);
}

__global__ void __launch_bounds__(kThreads) ssd_intra_chunk(const Args a) {
  extern __shared__ float sm[];
  const int Q = a.Q, P = a.P, N = a.N, H = a.H, ldn = N + 1, ldl = Q + 1;
  float* xs = sm;                      // [Q][P]
  float* bs = xs + Q * P;              // [Q][ldn]
  float* cs = bs + Q * ldn;            // [Q][ldn]
  float* cum = cs + Q * ldn;           // [Q]
  float* dec = cum + Q;                // [Q]: exp(cum_{Q-1} - cum_j)
  float* L = dec + Q;                  // [kRB][ldl]
  const int tid = threadIdx.x, h = blockIdx.x;
  const long long chunk = (long long)blockIdx.z * a.nc + blockIdx.y;

  for (int i = tid; i < Q * P; i += kThreads) {
    const int j = i / P, p = i - j * P;
    xs[i] = load(a.xdt, ((chunk * Q + j) * H + h) * P + p, a.x_bf16);
  }
  for (int i = tid; i < Q * N; i += kThreads) {
    const int j = i / N, n = i - j * N;
    bs[j * ldn + n] = load(a.B, chunk * Q * N + i, a.bc_bf16);
    cs[j * ldn + n] = load(a.C, chunk * Q * N + i, a.bc_bf16);
  }
  if (tid < 32) {                      // warp 0: cum by a warp scan
    const int per = (Q + 31) / 32, j0 = tid * per, j1 = min(Q, j0 + per);
    float run = 0.f;
    for (int j = j0; j < j1; ++j) {
      run += a.a[(chunk * Q + j) * H + h];
      cum[j] = run;                    // the lane's own prefix
    }
    float incl = run;                  // inclusive scan of the lanes' totals
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl += t;
    }
    const float offset = incl - run;   // the sum of the lanes before this one
    for (int j = j0; j < j1; ++j) cum[j] += offset;
  }
  __syncthreads();
  const float total = cum[Q - 1];
  for (int j = tid; j < Q; j += kThreads) dec[j] = expf(total - cum[j]);
  __syncthreads();

  // the chunk's state, one (p, n) a thread
  float* Sp = a.S + (chunk * H + h) * (long long)P * N;
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i - p * N;
    float acc = 0.f;
    for (int j = 0; j < Q; ++j) acc = fmaf(dec[j] * xs[j * P + p], bs[j * ldn + n], acc);
    Sp[i] = acc;
  }

  for (int i0 = 0; i0 < Q; i0 += kRB) {
    const int rows = min(kRB, Q - i0), cols = i0 + rows;
    __syncthreads();                   // the previous rows' L is consumed
    for (int e = tid; e < rows * cols; e += kThreads) {
      const int r = e / cols, j = e - r * cols, i = i0 + r;
      float v = 0.f;
      if (j <= i) {
        float dot = 0.f;
        for (int n = 0; n < N; ++n) dot = fmaf(cs[i * ldn + n], bs[j * ldn + n], dot);
        v = expf(cum[i] - cum[j]) * dot;
      }
      L[r * ldl + j] = v;
    }
    __syncthreads();
    for (int e = tid; e < rows * P; e += kThreads) {
      const int r = e / P, p = e - r * P, i = i0 + r;
      float acc = 0.f;
      for (int j = 0; j <= i; ++j) acc = fmaf(L[r * ldl + j], xs[j * P + p], acc);
      a.y[((chunk * Q + i) * H + h) * P + p] = acc;
    }
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success), or -1 when the tile needs more
// shared memory than a block of this card may have.
int ssd_intra_chunk_launch(const void* xdt, const float* a, const void* B, const void* C,
                           float* y, float* S, int Bz, int nc, int Q, int H, int P, int N,
                           int x_bf16, int bc_bf16, void* stream) {
  if (Bz == 0 || nc == 0 || H == 0 || Q == 0) return 0;
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return int(err);
  const size_t bytes = sizeof(float) * smem_floats(Q, P, N);
  if (bytes > size_t(max_smem)) return -1;
  err = cudaFuncSetAttribute(ssd_intra_chunk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(bytes));
  if (err != cudaSuccess) return int(err);
  Args args{xdt, a, B, C, y, S, nc, Q, H, P, N, x_bf16, bc_bf16};
  ssd_intra_chunk<<<dim3(H, nc, Bz), kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(args);
  return int(cudaGetLastError());
}

// Shared-memory bytes a block needs for a (Q, P, N) tile.
long long ssd_smem_bytes(int Q, int P, int N) {
  return (long long)(sizeof(float) * smem_floats(Q, P, N));
}

}  // extern "C"
