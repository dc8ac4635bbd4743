// GQA flash attention (forward only), causal or not, with an optional sliding
// window, on Hopper: three kernels, flash_fwd_wgmma, flash_fwd_mma and
// flash_fwd.
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
// Three kernels share the grid, one block per (query tile of 64 rows, query
// head, batch), and the loop over the key tiles from the window's first to
// the causal last one (the last of Tk when not causal), so wholly masked
// tiles are never visited (as the TPU kernel's pl.when skips them).  All
// read q, k and v in the model's [B, T, H, hd] layout through the element
// strides they are given (the head dim must be contiguous), so the caller
// makes no transposed copy.  The wrapper (kernels/flash_attention/kernel.py:
// route) picks one before the launch:
//
// flash_fwd_wgmma: the non-causal mode without a window, bf16 at hd 64, the
// pointers and strides 16-byte aligned (SeamlessM4T-medium's encoder and
// cross-attention).  Bound by operations at the encoder shape (17.18 GFLOP
// useful) and by bytes at the cross shape (21.0 MB); the design is
// FA3's shape for Hopper, cut to what this card and compiler gave:
//   - Copies by TMA: 4-D tensor maps over the [B, T, heads, 64] views
//     (built at each launch with cuTensorMapEncodeTiled, taken through
//     cudaGetDriverEntryPointByVersion, so no -lcuda), the 128-byte swizzle
//     (a bf16 row at hd 64 is 128 bytes, what wgmma reads without bank
//     conflicts), rows past T zero-filled by the hardware.  Q once, K and V
//     tiles of 128 keys into a ring with a "full" mbarrier (TMA bytes) and
//     an "empty" one (the 4 consumer warps) a stage.  One producer warp
//     issues every copy; the consumers spend no registers or instructions
//     on loads.
//   - S = Q K^T by wgmma m64n128k16 with both operands in shared memory,
//     K-major; O += P V by wgmma m64n64k16 with P from registers (the
//     m64n128 accumulator's pairs are the A fragment) and V from shared
//     memory, MN-major (the transpose bit), so V needs no transposed copy.
//   - P in two bf16 parts, P_hi V + P_lo V, as in flash_fwd_mma: one
//     rounding of p fails the one-step bound where two keys carry a row and
//     their values cancel (tests/test_torch_flash.py:
//     test_wgmma_keeps_p_in_two_bf16_parts), so 1.5x the useful products.
//   - The online softmax in registers in log2 units, ex2.approx; the mask
//     only on the ragged last tile (a uniform branch); O's rescale skipped
//     when no row of a warp moved its max.
//   - A block is one consumer warpgroup of 64 query rows and the producer
//     warp (160 threads), 3 blocks a SM (2 stages) or, when the grid fits
//     in two a SM, 2 (3 stages).  Each warpgroup runs Q K^T, softmax and
//     P V in turn; the SM's other blocks fill the tensor cores meanwhile.
//   What bounds it, from its own clock64 phase counters on the card: the
//   softmax, about 520 instructions and 66 ex2 (8 cycles
//   of the 16-wide SFU each) a warp a tile, half of a warpgroup's time;
//   the SFU and the issue slots are both near full when three warpgroups
//   share a sub-partition.  Two consumer warpgroups a block with a producer
//   warpgroup and setmaxnreg, the FA3 intra-warpgroup overlap (on 64-key
//   sub-tiles, to fit the registers) and row sums on the tensor cores were
//   each slower: ptxas held every such kernel to 168 registers a thread
//   (the launch bound rounded up to whole warpgroups) and spilled or
//   serialised the wgmma pipeline.
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
#include <cuda.h>            // CUtensorMap and its enums (no libcuda: see tensor_map_encoder)
#include <cudaTypedefs.h>    // PFN_cuTensorMapEncodeTiled
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"
#include "sm90.cuh"

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

// ---- flash_fwd_wgmma: the non-causal mode at hd 64 on Hopper's wgmma ----

constexpr int kWgHD = 64;                               // one 128-byte swizzle row of bf16
constexpr int kWgRows = 64;                             // query rows a block (its warpgroup)
constexpr int kWgBN = 128;                              // keys a tile
constexpr int kWgThreads = 160;                         // the consumer warpgroup, the producer warp
constexpr uint32_t kWgQBytes = kWgRows * kWgHD * 2;     // 8 KB
constexpr uint32_t kWgKVBytes = kWgBN * kWgHD * 2;      // 16 KB

// BLOCKS a SM: 3 with a ring of 2 stages, or 2 with 3; the launch bounds
// let each thread hold 128 or 168 registers, and shared memory (73,768 or
// 106,552 bytes a block) fits that many blocks
template <int BLOCKS>
struct WgCfg {
  static constexpr int kStages = BLOCKS == 3 ? 2 : 3;
  static constexpr size_t kSmem =     // Q, the ring, its barriers (the base is 1024-aligned)
      kWgQBytes + 2 * kStages * kWgKVBytes + 8 * (2 * kStages + 1);
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S = Q K^T for one key tile: 4 k-steps of 16 along hd, both operands
// K-major in shared memory (a k-step advances each descriptor by 32 bytes
// inside the swizzled row)
__device__ __forceinline__ void wg_qk(float (&s)[64], uint64_t dq, uint64_t dk) {
#pragma unroll
  for (int kk = 0; kk < kWgHD / 16; ++kk) wgmma_m64n128k16_ss(s, dq + 2 * kk, dk + 2 * kk, kk);
}

// O += P_hi V + P_lo V: the tile's keys 16 kc .. + 15 are k-step kc (V's
// rows, 2,048 bytes a step).  V is MN-major: 8-key groups 1,024 bytes
// apart; hd 64 is one swizzle atom wide, so the atom stride is never used.
__device__ __forceinline__ void wg_pv(float (&o)[32], const uint32_t (&ph)[32],
                                      const uint32_t (&pl)[32], uint32_t v) {
#pragma unroll
  for (int kc = 0; kc < kWgBN / 16; ++kc) {
    const uint64_t d = wgmma_desc_sw128(v + 2048 * kc, 1024, 1024);
    wgmma_m64n64k16_rs_tb(o, ph + 4 * kc, d, 1);
    wgmma_m64n64k16_rs_tb(o, pl + 4 * kc, d, 1);
  }
}

// One key tile's online softmax in wgmma's m64n128 accumulator layout:
// s[4 j + e] is row g + 8 (e >> 1) of the warp's 16, key 8 j + 2 (lane % 4)
// + (e & 1) of the tile.  Keys at or past ``valid`` are masked (the ragged
// last tile only, behind a uniform branch); m (log2 units) and the
// thread's part of l are updated, corr gets the factor of each row's old
// sums, and s becomes p = 2^(s sl2 - m) in fp32.
__device__ __forceinline__ void wg_softmax(float (&s)[64], float (&m)[2], float (&l)[2],
                                           float (&corr)[2], int valid, float sl2) {
  const int tq = threadIdx.x & 3;
  if (valid < kWgBN) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (8 * j + 2 * tq + (e & 1) >= valid) s[4 * j + e] = kNegInf;
  }
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mn = fmaxf(m[r], mx[r] * sl2);
    corr[r] = ex2(m[r] - mn);
    m[r] = mn;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    s[i] = ex2(fmaf(s[i], sl2, -m[(i >> 1) & 1]));
    l[(i >> 1) & 1] += s[i];
  }
}

// P = P_hi + P_lo packed in bf16 pairs as wgmma's register A takes them
// (the m64n128 accumulator's pairs are the A fragment's): ph[4 kc + i] holds
// s[8 kc + 2 i] and s[8 kc + 2 i + 1]; then O *= corr (rows by e >> 1, as
// in S), skipped when no row of the warp moved its max.  The split comes
// first: the rescale's branch then keeps the compiler from spreading the
// split between the P V instructions, which stretched their issue.
__device__ __forceinline__ void wg_split_rescale(float (&o)[32], const float (&corr)[2],
                                                 const float (&s)[64], uint32_t (&ph)[32],
                                                 uint32_t (&pl)[32]) {
#pragma unroll
  for (int n = 0; n < 32; ++n) split_bf16(s[2 * n], s[2 * n + 1], ph[n], pl[n]);
  if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= corr[(i >> 1) & 1];
  }
}

// One block per (64 query rows, head, batch).  Warp 4 is the producer: its
// first thread loads Q once, then streams K and V tiles of 128 keys into a
// ring of kStages by TMA (full[s]: the stage landed; empty[s]: the 4
// consumer warps are done with it).  Warps 0-3, one warpgroup, consume:
// per tile Q K^T, the softmax and P V, each waited for in turn; the other
// blocks on the SM fill the tensor cores meanwhile.
template <int BLOCKS>
__global__ void __launch_bounds__(kWgThreads, BLOCKS)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_o, int Tq, int Tk, int group,
                    float sl2) {
  constexpr int kS = WgCfg<BLOCKS>::kStages;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t sq = smem_addr(wg_smem);                // Q, later O
  const uint32_t sk = sq + kWgQBytes;                    // kS K tiles
  const uint32_t sv = sk + kS * kWgKVBytes;              // kS V tiles
  const uint32_t full = sv + kS * kWgKVBytes;            // kS barriers
  const uint32_t empty = full + 8 * kS;                  // kS barriers
  const uint32_t qbar = empty + 8 * kS;
  const int q0 = blockIdx.x * kWgRows, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (Tk + kWgBN - 1) / kWgBN;
  if (sq & 1023) __trap();                               // the swizzle wants 1024-byte tiles
  if (threadIdx.x == 0) {
    for (int st = 0; st < kS; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, 4);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {                              // the producer warp
    if (threadIdx.x == 128) {
      const int kvh = h / group;
      mbar_arrive_expect_tx(qbar, kWgQBytes);
      tma_load_4d(sq, &tm_q, qbar, 0, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kS;
        mbar_wait(empty + 8 * st, ((t / kS) & 1) ^ 1);
        mbar_arrive_expect_tx(full + 8 * st, 2 * kWgKVBytes);
        tma_load_4d(sk + st * kWgKVBytes, &tm_k, full + 8 * st, 0, t * kWgBN, kvh, b);
        tma_load_4d(sv + st * kWgKVBytes, &tm_v, full + 8 * st, 0, t * kWgBN, kvh, b);
      }
    }
    return;
  }

  const int lane = threadIdx.x & 31;
  const uint64_t dq = wgmma_desc_sw128(sq, 16, 1024);
  float s[64], o[32], corr[2];
  uint32_t ph[32], pl[32];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  mbar_wait(qbar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kS;
    mbar_wait(full + 8 * st, (t / kS) & 1);
    fence_regs(s);
    wgmma_fence();
    wg_qk(s, dq, wgmma_desc_sw128(sk + st * kWgKVBytes, 16, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    wg_softmax(s, m, l, corr, Tk - t * kWgBN, sl2);
    wg_split_rescale(o, corr, s, ph, pl);
    fence_regs(o);
    fence_regs(ph);
    fence_regs(pl);
    wgmma_fence();
    wg_pv(o, ph, pl, sv + st * kWgKVBytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(ph);
    fence_regs(pl);
    if (lane == 0) mbar_arrive(empty + 8 * st);
  }

  // epilogue: O / max(l, 1e-30) in bf16 into Q's tile (the last Q K^T is
  // complete), in the swizzle the output's TMA map reads; rows past Tq are
  // not stored
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  const int g = lane >> 2, tq = lane & 3, row0 = (threadIdx.x >> 5) * 16 + g;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)          // row0 + 8 r has row0's swizzle phase g
      *reinterpret_cast<unsigned*>(wg_smem + (row0 + 8 * r) * 128 + ((j ^ g) << 4) + 4 * tq) =
          pack_bf16(o[4 * j + 2 * r] * l[r], o[4 * j + 2 * r + 1] * l[r]);
  fence_proxy_async();
  named_bar_sync(1, 128);
  if (threadIdx.x == 0) {
    tma_store_4d(&tm_o, sq, 0, q0, h, b);
    tma_store_wait();
  }
}

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// a bf16 [B, heads, T, 64] view with element strides st3 = (batch, head,
// time) and a contiguous head dim as a 4-D TMA map over (64, T, heads, B),
// innermost first, in boxes of 64 x ``rows`` with the 128-byte swizzle;
// rows past T read as zeros.  A dim of extent 1 gets a stride of one row
// (its stride is never used, and TMA wants a nonzero multiple of 16 bytes).
bool make_tensor_map(CUtensorMap* map, const void* ptr, const long long* st3, int B, int heads,
                     int T, int rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const long long extent[3] = {T, heads, B}, elems[3] = {st3[2], st3[1], st3[0]};
  cuuint64_t dims[4] = {kWgHD, cuuint64_t(T), cuuint64_t(heads), cuuint64_t(B)};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) strides[i] = 2 * cuuint64_t(extent[i] == 1 ? kWgHD : elems[i]);
  cuuint32_t box[4] = {kWgHD, cuuint32_t(rows), 1, 1}, unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int BLOCKS>
cudaError_t launch_wgmma(const CUtensorMap (&maps)[4], int B, int H, int Tq, int Tk, int group,
                         float sl2, cudaStream_t stream) {
  constexpr size_t bytes = WgCfg<BLOCKS>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma<BLOCKS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + kWgRows - 1) / kWgRows, H, B);
  flash_fwd_wgmma<BLOCKS><<<grid, kWgThreads, bytes, stream>>>(maps[0], maps[1], maps[2],
                                                               maps[3], Tq, Tk, group, sl2);
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

// flash_fwd_wgmma, the non-causal mode in bf16 at hd 64: the same
// arguments; window 0, causal 0, hd 64, the four pointers and 12 strides
// 16-byte aligned (8 elements), or it returns cudaErrorInvalidValue without
// launching (also when a TMA map cannot be encoded).
int flash_attention_wgmma_launch(const void* q, const void* k, const void* v, void* o,
                                 const long long* strides, int B, int H, int KV, int Tq, int Tk,
                                 int hd, int window, int causal, float scale, void* stream) {
  const void* ptrs[4] = {q, k, v, o};
  for (int i = 0; i < 4; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return int(cudaErrorInvalidValue);
  for (int i = 0; i < 12; ++i)
    if (strides[i] % 8) return int(cudaErrorInvalidValue);
  if (hd != kWgHD || window != 0 || causal != 0 || KV <= 0 || H % KV)
    return int(cudaErrorInvalidValue);
  if (Tq == 0 || B == 0 || H == 0) return 0;
  CUtensorMap maps[4];
  if (!make_tensor_map(&maps[0], q, strides, B, H, Tq, kWgRows) ||
      !make_tensor_map(&maps[1], k, strides + 3, B, KV, Tk, kWgBN) ||
      !make_tensor_map(&maps[2], v, strides + 6, B, KV, Tk, kWgBN) ||
      !make_tensor_map(&maps[3], o, strides + 9, B, H, Tq, kWgRows))
    return int(cudaErrorInvalidValue);
  // a grid that fits in two blocks a SM (SeamlessM4T's cross-attention, 256
  // blocks) runs two a SM with three stages, a larger one (its encoder, 1,024
  // blocks) three a SM with two: each was the faster at its shape
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return int(err);
  const long long blocks = 1LL * ((Tq + kWgRows - 1) / kWgRows) * H * B;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float sl2 = scale * 1.4426950408889634f;
  if (blocks <= 2LL * sms) return int(launch_wgmma<2>(maps, B, H, Tq, Tk, H / KV, sl2, s));
  return int(launch_wgmma<3>(maps, B, H, Tq, Tk, H / KV, sl2, s));
}

}  // extern "C"
