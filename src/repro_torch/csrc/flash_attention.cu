// GQA flash attention (forward only), causal or not, with an optional sliding
// window, on Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py:
// flash_attention (body _flash_kernel), both of its modes.  For q
// [B, H, Tq, hd] and k, v [B, KV, Tk, hd] (f32 or bf16, all one dtype;
// kv head = h / (H / KV)):
//
//   s_ij = (q_i . k_j) * scale,  scale = 1 / sqrt(hd)       (fp32 sums)
//   s_ij = -1e30 where j > i (causal only), or i - j >= window (window > 0),
//          or j >= Tk
//   o_i  = sum_j softmax_j(s_i) v_j / max(l_i, 1e-30)       (online, fp32)
//
// stored in q's dtype.  Positions are the indices 0..Tq-1 and 0..Tk-1, as in
// the TPU kernel.  The causal mode serves the decoders' self-attention; the
// non-causal one (causal = 0, the TPU kernel's causal=False) the audio
// encoder's self-attention and the decoder's cross-attention over the
// encoder memory, where Tq and Tk differ (256 and 1,024 at SeamlessM4T-
// medium's serving shape).  The plain torch version is
// repro_torch/kernels/flash_attention/ref.py:flash_attention_torch.
//
// Bound on an H100: operations.  At Hymba-1.5B's prefill (B 4, T 2048, H 25,
// KV 5, hd 64, window 1024) a layer has 1,573,376 unmasked (query, key)
// pairs a (batch, head), 4 * hd FLOP each (QK^T and PV): 40.3 GFLOP, 0.041
// ms at the bf16 tensor-core rate of 989 TFLOP/s; the bytes (q, k, v read
// once, o written once) are 62.9 MB, 0.019 ms at 3.35 TB/s.  Non-causal at
// SeamlessM4T-medium's encoder (B 4, T 1024, H = KV = 16, hd 64): 17.18
// GFLOP, 0.0174 ms, bound by operations; its cross-attention (Tq 256, Tk
// 1024): 4.29 GFLOP (0.0043 ms) but 21.0 MB (0.0063 ms), bound by bytes.
//
// Two kernels share the grid, one block per (query tile of 64 rows, query
// head, batch), and the loop over the key tiles from the window's first to
// the causal last one (the last of Tk when not causal), so wholly masked
// tiles are never visited (as the TPU kernel's pl.when skips them).  Both
// read q, k and v in the model's [B, T, H, hd] layout through the element
// strides they are given (the head dim must be contiguous), so the caller
// makes no transposed copy.  The
// wrapper (kernels/flash_attention/kernel.py:route) picks one before the
// launch:
//
// flash_fwd_mma: bf16 with hd 16, 32, 64 or 128, q, k, v pointers and batch,
// head and time strides 16-byte aligned (every prefill of the port).  FA2-style
// on the mma.sync tensor cores: 4 warps a block, 16 query rows a warp.  Q is
// copied once into shared memory and loaded into A fragments (ldmatrix.x4) that
// stay in registers.  K and V tiles of 64 keys are double-buffered in shared
// memory by 16-byte cp.async copies, the next tile's copy in flight during this
// tile's products; keys past Tk are zero-filled (src-size 0).  Shared rows are
// padded by 16 bytes, so the eight rows an ldmatrix phase reads fall in eight
// distinct bank groups.  S = Q K^T by mma.sync m16n8k16 (bf16 in, fp32 sums),
// K's B fragments by ldmatrix; the -1e30 mask is applied per element only on
// tiles that touch the diagonal (causal only), the window's edge or the ragged
// end.  The online softmax runs in registers: a thread holds 16 scores of each
// of 2 rows, the row max is reduced over the 4 threads of a quad (shuffles 1,
// 2), l is summed from the fp32 p per thread and over the quad at the end.  O
// += P V in two products: p = p_hi + p_lo, both rounded to bf16 in registers
// and reused as A fragments (the m16n8 accumulator layout is the m16n8k16 A
// layout once pairs are packed); V's B fragments come by ldmatrix.trans; O sums
// in fp32 registers.  Why two: the TPU kernel keeps p in fp32 through P V, and
// one bf16 p (relative error up to 2^-8 a term, against an l summed in fp32)
// moves an output by up to 2^-9 |v_j| where one key dominates a row, as in the
// first rows of every causal prefill: past one bf16 step of a small
// output.  p_hi + p_lo carries p to ~2^-17, for twice the P V products (1.5x in
// all).  Epilogue: O / max(l, 1e-30) rounded to bf16, staged through the warp's
// own rows of Q's shared tile, stored 16 bytes a thread.  Shared memory: 5
// tiles of 64 x (hd + 8) bf16, 46,080 bytes at hd 64, 87,040 at hd 128 (opted
// in past 48 KB).  What bounds it: the products, 96 m16n8k16 a warp a key tile
// at hd 64 (64.2 GFLOP issued at Hymba's shape for 40.3 useful: the split P V,
// and the masked halves of the diagonal and window-edge tiles), at most ~2/3 of
// the 989 TFLOP/s through mma.sync (the full rate needs wgmma), with the
// softmax's exp2 and shuffles between the two products; predicted 0.20-0.45 ms
// a launch at Hymba's shape.
//
// flash_fwd: everything else, fp32 above all (the fp32 checks hold the
// kernel at 2e-5, which bf16 tensor cores cannot meet).  A first kernel
// that is right: 256 threads; the block stages its Q tile, then each K and
// V tile of 64 keys, in shared memory as fp32.  A thread owns a 4 x 4
// micro-tile of the 64 x 64 scores (rows ty + 16 i, keys tx + 16 j) and 4
// rows x hd/16 columns of the output accumulator, in registers, with the
// running max and sum of its 4 rows; the 16 threads that share a row reduce
// over it with warp shuffles.  The products are fp32 FMAs on the CUDA cores
// (67 TFLOP/s at most), so it cannot come within 16x of the tensor-core
// bound.  Rows padded by one float keep the shared-memory reads free of
// bank conflicts.
//
// Masked scores are -1e30, not -inf, as on the TPU: a row whose first
// visited tile is wholly outside its window adds exp(0) = 1 terms, which the
// correction exp(-1e30 - m) rescales to exactly 0 once a real key arrives
// (which is also why flash_fwd_mma zero-fills the rows past Tk: a 0 weight
// times a NaN of stale shared memory would not vanish).  One does arrive for
// every row i < Tk - 1 + window (any row without a window), in both modes:
// key Tk - 1 is in row i's window, and so is a causal row's own key
// min(i, Tk - 1); the loop visits every tile up to Tk - 1 in the non-causal
// mode and up to the row's own tile in the causal one.  Rows i >= Tk - 1 +
// window see no key at all (the TPU kernel returns 0 there, its oracle the
// mean of v); the wrapper refuses such inputs (ref.py:
// check_every_row_sees_a_key), so both modes hold for any Tq and Tk.
// Head dims 1..128 and any Tq, Tk (the ragged last tiles are masked here).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

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
  int causal;                      // 0: every key (Tq and Tk may differ)
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
  const int last = a.causal ? min(a.Tk - 1, q0 + kBQ - 1) : a.Tk - 1;
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
        const bool ok = key < a.Tk && (!a.causal || key <= row) &&
                        (!a.window || row - key < a.window);
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


// ---- flash_fwd_mma: bf16 on the mma.sync tensor cores ----

constexpr int kMmaThreads = 128;   // 4 warps, 16 query rows each

template <int HD>
struct MmaTile {
  static constexpr int kLd = HD + 8;        // row pitch in bf16: 16 bytes of padding
  static constexpr int kElems = kBQ * kLd;  // one 64-row tile (kBQ == kBK)
  static constexpr size_t kSmem = sizeof(__nv_bfloat16) * 5 * kElems;   // Q, 2 K, 2 V
};

// rows [r0, r0 + 64) of a [T, HD] bf16 matrix with row stride ``st`` into a
// padded shared tile by cp.async; rows >= T are zero-filled
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long st, int r0, int T) {
  constexpr int kChunks = HD / 8;                         // 16 bytes a chunk
  constexpr int kIters = kBQ * kChunks / kMmaThreads;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = threadIdx.x + it * kMmaThreads;
    const int r = i / kChunks, c = i - r * kChunks;
    const bool in = r0 + r < T;
    const __nv_bfloat16* g = in ? src + (r0 + r) * st + c * 8 : src;
    cp_async16(smem_addr(dst + r * MmaTile<HD>::kLd + c * 8), g, in);
  }
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads) flash_fwd_mma(const Args a) {
  using T = __nv_bfloat16;
  constexpr int kLd = MmaTile<HD>::kLd, kTile = MmaTile<HD>::kElems;
  constexpr int KC = HD / 16;              // k-steps of Q K^T
  constexpr int ND = HD / 8;               // n-tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [64][kLd]
  T* ks = qs + kTile;                      // [2][64][kLd]
  T* vs = ks + 2 * kTile;                  // [2][64][kLd]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;  // the quad's row, the thread in the quad
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.group;
  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  // the key tiles any row of this block can see
  const int last = a.causal ? min(a.Tk - 1, q0 + kBQ - 1) : a.Tk - 1;
  const int first = a.window ? max(0, q0 - a.window + 1) : 0;
  const int kb = (first / kBK) * kBK;
  const int n_tiles = last >= kb ? (last - kb) / kBK + 1 : 0;

  load_tile<HD>(qs, qp, a.q_st, q0, a.Tq);
  if (n_tiles > 0) {
    load_tile<HD>(ks, kp, a.k_st, kb, a.Tk);
    load_tile<HD>(vs, vp, a.v_st, kb, a.Tk);
  }
  cp_async_commit();

  unsigned qa[KC][4];                      // this warp's 16 Q rows as A fragments
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // rows q0 + 16 warp + g (r = 0) and + 8 (r = 1); scores in log2 units
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float sl2 = a.scale * 1.4426950408889634f;
  const int row0 = q0 + warp * 16 + g;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = kb + t * kBK;
    const T* kt = ks + (t & 1) * kTile;
    const T* vt = vs + (t & 1) * kTile;
    if (t + 1 < n_tiles) {                 // the next tile's copy flies during this one
      load_tile<HD>(ks + ((t + 1) & 1) * kTile, kp, a.k_st, k0 + kBK, a.Tk);
      load_tile<HD>(vs + ((t + 1) & 1) * kTile, vp, a.v_st, k0 + kBK, a.Tk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                       // this tile (and Q) landed for every thread
    if (t == 0) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        ldsm_x4(smem_addr(qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                          kc * 16 + (lane >> 4) * 8),
                qa[kc]);
    }

    // S = Q K^T: n-tile j holds keys k0 + 8 j .. + 7
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        unsigned kf[4];
        ldsm_x4(smem_addr(kt + (j * 8 + (lane & 7) + (lane >> 4) * 8) * kLd + kc * 16 +
                          ((lane >> 3) & 1) * 8),
                kf);
        mma_bf16(s[j], qa[kc], kf[0], kf[1]);
        mma_bf16(s[j + 1], qa[kc], kf[2], kf[3]);
      }
    }

    // element e of s[j]: row row0 + 8 (e >> 1), key k0 + 8 j + 2 tig + (e & 1)
    const bool edge = (a.causal && k0 + kBK - 1 > q0) || k0 + kBK > a.Tk ||
                      (a.window && q0 + kBQ - 1 - k0 >= a.window);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * sl2;
        if (edge) {
          const int row = row0 + 8 * (e >> 1), key = k0 + 8 * j + 2 * tig + (e & 1);
          if (key >= a.Tk || (a.causal && key > row) || (a.window && row - key >= a.window))
            x = kNegInf;
        }
        s[j][e] = x;
      }

    // online softmax: the row max over the quad, p = 2^(x - m) in fp32
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float corr = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][2 * r] *= corr;
        o[n][2 * r + 1] *= corr;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m[e >> 1]);
        l[e >> 1] += s[j][e];
      }

    // O += P_hi V + P_lo V: keys 16 kc .. + 15 are n-tiles 2 kc, 2 kc + 1 of S
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      unsigned pa[4], pl[4];               // p_hi and p_lo as A fragments
#pragma unroll
      for (int i = 0; i < 4; ++i) {        // a0..a3: rows g, g + 8 of keys +0..7, +8..15
        const float x0 = s[2 * kc + (i >> 1)][2 * (i & 1)];
        const float x1 = s[2 * kc + (i >> 1)][2 * (i & 1) + 1];
        split_bf16(x0, x1, pa[i], pl[i]);
      }
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        unsigned vf[4];
        ldsm_x4_trans(smem_addr(vt + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                                n * 8 + (lane >> 4) * 8),
                      vf);
        mma_bf16(o[n], pa, vf[0], vf[1]);
        mma_bf16(o[n], pl, vf[0], vf[1]);
        mma_bf16(o[n + 1], pa, vf[2], vf[3]);
        mma_bf16(o[n + 1], pl, vf[2], vf[3]);
      }
    }
    __syncthreads();                       // every warp is done with this stage
  }
  cp_async_wait<0>();                      // with no tile, the Q copy is still pending
  __syncthreads();

  // epilogue: O / max(l, 1e-30) in bf16 through the warp's own 16 rows of qs
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  T* ow = qs + warp * 16 * kLd;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(ow + g * kLd + n * 8 + 2 * tig) =
        __floats2bfloat162_rn(o[n][0] / l[0], o[n][1] / l[0]);
    *reinterpret_cast<__nv_bfloat162*>(ow + (g + 8) * kLd + n * 8 + 2 * tig) =
        __floats2bfloat162_rn(o[n][2] / l[1], o[n][3] / l[1]);
  }
  __syncwarp();
  T* op = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;
  constexpr int kChunks = HD / 8;
#pragma unroll
  for (int it = 0; it < 16 * kChunks / 32; ++it) {
    const int i = lane + 32 * it;
    const int r = i / kChunks, c = i - r * kChunks;
    const int row = q0 + warp * 16 + r;
    if (row < a.Tq)
      *reinterpret_cast<uint4*>(op + row * a.o_st + c * 8) =
          *reinterpret_cast<const uint4*>(ow + r * kLd + c * 8);
  }
}

template <int HD>
cudaError_t launch_mma(const Args& a, int B, int H, cudaStream_t stream) {
  const size_t bytes = MmaTile<HD>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_mma<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tq + kBQ - 1) / kBQ, H, B);
  flash_fwd_mma<HD><<<grid, kMmaThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

Args make_args(const void* q, const void* k, const void* v, void* o, const long long* strides,
               int H, int KV, int Tq, int Tk, int hd, int window, int causal, float scale) {
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
  a.causal = causal;
  a.scale = scale;
  return a;
}

}  // namespace

extern "C" {

// strides: 12 element strides, (batch, head, time) of q, k, v and o in turn;
// causal: 1 for the causal mode, 0 for every key; scale is 1 / sqrt(hd)
// rounded to fp32 by the caller.  Returns a cudaError_t (0 on success); the
// head dim must be 1..128, H a multiple of KV, and every query row must see
// a key (checked by the caller).  flash_fwd.
int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                           const long long* strides, int B, int H, int KV, int Tq, int Tk,
                           int hd, int window, int causal, float scale, int bf16,
                           void* stream) {
  const Args a = make_args(q, k, v, o, strides, H, KV, Tq, Tk, hd, window, causal, scale);
  if (Tq == 0 || B == 0 || H == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(bf16 ? dispatch<__nv_bfloat16>(a, B, H, s) : dispatch<float>(a, B, H, s));
}

// flash_fwd_mma, bf16 only: the same arguments; hd must be 16, 32, 64 or
// 128, and the four pointers and 12 strides 16-byte aligned (8 elements),
// or it returns cudaErrorInvalidValue without launching.
int flash_attention_mma_launch(const void* q, const void* k, const void* v, void* o,
                               const long long* strides, int B, int H, int KV, int Tq, int Tk,
                               int hd, int window, int causal, float scale, void* stream) {
  const void* ptrs[4] = {q, k, v, o};
  for (int i = 0; i < 4; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return int(cudaErrorInvalidValue);
  for (int i = 0; i < 12; ++i)
    if (strides[i] % 8) return int(cudaErrorInvalidValue);
  const Args a = make_args(q, k, v, o, strides, H, KV, Tq, Tk, hd, window, causal, scale);
  if (Tq == 0 || B == 0 || H == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return int(launch_mma<16>(a, B, H, s));
    case 32: return int(launch_mma<32>(a, B, H, s));
    case 64: return int(launch_mma<64>(a, B, H, s));
    case 128: return int(launch_mma<128>(a, B, H, s));
    default: return int(cudaErrorInvalidValue);
  }
}

}  // extern "C"
