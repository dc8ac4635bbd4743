// Mamba2 SSD intra-chunk kernels (forward only), on Hopper.
//
// Replace the Pallas TPU kernel src/repro/kernels/ssd/kernel.py:
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
// These kernels select the exponential only where j <= i, where cum_i -
// cum_j <= 0 for decays a <= 0.
//
// Bound on an H100: bytes.  At Hymba-1.5B's prefill (Bz 4, nc 16, Q 128,
// H 25, P 64, N 16) a launch reads xdt (bf16, 26.2 MB), a, B and C, and
// writes y (fp32, 52.4 MB) and S (6.6 MB): 86.5 MB, 0.0258 ms at 3.35 TB/s;
// its ~2.2 GFLOP take 0.002 ms at the bf16 tensor-core rate.
//
// Two kernels; the wrapper (kernels/ssd/kernel.py:route) picks one before
// the launch.
//
// ssd_intra_chunk_mma: bf16 xdt, B and C with 16-byte-aligned rows, P 64,
// N 16 or 128, Q 64, 128, 192 or 256: the state dims and chunks of the
// configs (Hymba's Q 128 / N 16, mamba2-1.3b's Q 256 / N 128).  The y part
// is flash attention with the softmax replaced by the decay mask: scores =
// C B^T, L = select(j <= i, exp(cum_i - cum_j) scores, 0), y = L xdt.  One
// 128-thread block per (64-row tile of i, head, chunk, batch), 3,200 at
// Hymba's prefill; warp w owns rows 16 w .. 16 w + 15 of the tile, and
// their C rows stay in registers as A fragments.  The tiles of 64 steps j
// up to the diagonal (B [64, N], and xdt [64, P] of this head) stream
// through a double-buffered shared ring by 16-byte cp.async, rows padded by
// 16 bytes so each ldmatrix phase hits eight distinct bank groups; shared
// memory does not grow with Q * N (29,184 bytes at Hymba's tile, 73,728 at
// mamba2-1.3b's).  Warp 0 forms cum [Q] by a warp scan (a is strided by H)
// in fp64 and keeps it as two fp32 parts, hi + lo; the exponents are
// (hi_i - hi_j) + (lo_i - lo_j), within ~1e-6 of the fp64 difference the
// plain version rounds once to fp32.  Per 16 steps
// of a j tile, in registers: C B^T by mma.sync m16n8k16 (bf16 in, fp32
// sums; C and B are exact in bf16, so this needs no split), the decay and
// the mask (the mask only on the diagonal tile, where warp w also skips the
// steps past its rows), L split into bf16 parts reused as A fragments (the
// m16n8 accumulator layout is the A layout once pairs are packed), two at
// N 16 and three at N 128, and y += L_hi X + L_lo X (+ L_mid X) with X's B
// fragments by ldmatrix.trans; taking 16 steps at a time keeps 8 scores a
// thread live, not 32, so Hymba's N 16 fits 5 blocks a SM.  The block of
// the last row tile streams every j tile and also forms S = X^T (dec B),
// dec_j = exp(cum_{Q-1} - cum_j): X^T's A fragments come by ldmatrix.trans
// (exact), B's by ldmatrix.trans are scaled by dec in fp32 and split into
// hi + lo; warp w holds S's rows p = 16 w .. 16 w + 15.  y and S are stored
// from the accumulators in fp32, 8 bytes a thread, each quad writing 32
// consecutive bytes of a row.
//
// Why the splits and the fp64 scan: the contract is atol 3e-5 / rtol 3e-4
// against fp32, and tests/test_torch_ssd.py holds a CPU emulation of this
// kernel's arithmetic (_emulate_mma) to it.  One bf16 rounding of L (2^-9
// relative a term) moves y by ~1e-2 at Hymba's tile, and one of dec B moves
// S by ~3e-3; hi + lo (2^-17) holds S, and y at N 16, but not y at N 128,
// where |C.B| reaches ~20: at 32 heads of mamba2-1.3b's tile a few of 16.8
// M outputs leave the bound, so there L takes three parts (2^-26), for a
// third L X product.  cum in fp32, |cum| ~200 at Q 256, is off by ~8e-6
// rounded once and by ~1e-4 summed step by step in fp32; either moves cum_i
// - cum_j, and y past the bound of the step computed in fp64 throughout.
// The tests test_one_bf16_rounding_of_l_leaves_the_bound,
// test_two_bf16_parts_of_l_leave_the_bound_at_mamba2_scale and
// test_fp32_step_order_cum_leaves_the_bound show each on the CPU;
// test_mma_emulation_and_plain_match_fp64 holds the emulation and the plain
// version to the fp64 step.
//
// ssd_intra_chunk: everything else, f32 above all.  A first kernel that is
// right: one 256-thread block per (head, chunk, batch), 1,600 blocks at
// Hymba's prefill.  The block stages the chunk's xdt column of its head
// [Q, P], B and C [Q, N] (rows padded by one float, so the column walks
// below have no bank conflicts) and a in shared memory as fp32; warp 0
// forms cum with a warp scan (each lane sums Q/32 consecutive steps, then a
// shuffle scan over the lanes' totals), and the decays to the chunk's end
// exp(cum_{Q-1} - cum_j) once.  S is one output a thread, P * N of them.  y
// goes in row blocks of 32: the block first fills the masked matrix L_ij =
// exp(cum_i - cum_j) (C_i . B_j) for j <= i of those rows in shared memory
// (C . B^T is recomputed per head, N FMAs an entry), then each thread sums
// one (i, p) of y over j <= i.  Every multiply-add reads its operands from
// shared memory, so the SM's shared-load issue rate bounds it (reckoned
// from the loops: ~0.35 ms at Hymba's tile).  Shared memory at Hymba's tile: 67.7 KB.  A tile
// beyond the card's shared memory a block (mamba2-1.3b's Q 256, N 128 in
// f32 needs 364 KB) is refused before the launch.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

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

// ---- ssd_intra_chunk_mma: bf16 on the mma.sync tensor cores ----

constexpr int kMmaThreads = 128;   // 4 warps, 16 rows of y each
constexpr int kT = 64;             // rows of y a block; steps j a tile
constexpr int kP = 64;             // the head dim P the route takes
constexpr int kMaxQ = 256;

template <int N>
struct MmaTile {
  static constexpr int kLdB = N + 8;        // B and C row pitch in bf16: 16 bytes of padding
  static constexpr int kLdX = kP + 8;
  static constexpr int kB = kT * kLdB;      // elements of one B or C tile
  static constexpr int kX = kT * kLdX;
  // C, 2 B, 2 X tiles, then cum's hi and lo parts and dec [Q] in fp32
  static size_t smem(int Q) {
    return sizeof(__nv_bfloat16) * (3 * kB + 2 * kX) + 3 * sizeof(float) * size_t(Q);
  }
};

// rows [r0, r0 + 64) of a bf16 matrix of W columns with row stride ``st``
// into a shared tile of row pitch ``ld`` by cp.async
template <int W>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, int ld, const __nv_bfloat16* src,
                                          long long st, int r0) {
  constexpr int kChunks = W / 8;                          // 16 bytes a chunk
  constexpr int kIters = kT * kChunks / kMmaThreads;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = threadIdx.x + it * kMmaThreads;
    const int r = i / kChunks, c = i - r * kChunks;
    cp_async16(smem_addr(dst + r * ld + c * 8), src + (r0 + r) * st + c * 8, true);
  }
}

// At N 16 (Hymba) the kernel fits 5 blocks a SM in registers without
// spilling; N 128 needs its registers for S's accumulators.
template <int N>
__global__ void __launch_bounds__(kMmaThreads, N == 16 ? 5 : 1)
    ssd_intra_chunk_mma(const Args a) {
  using T = __nv_bfloat16;
  constexpr int kLdB = MmaTile<N>::kLdB, kLdX = MmaTile<N>::kLdX;
  constexpr int KC = N / 16;               // k-steps of C B^T
  constexpr int NS = N / 8;                // n-tiles of S
  constexpr int NY = kP / 8;               // n-tiles of y
  constexpr int kLParts = N <= 16 ? 2 : 3;  // bf16 parts of L (the source note says why)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cs = reinterpret_cast<T*>(smem_raw);  // [64][kLdB]: this tile's C rows
  T* bs = cs + MmaTile<N>::kB;             // [2][64][kLdB]
  T* xs = bs + 2 * MmaTile<N>::kB;         // [2][64][kLdX]
  const int Q = a.Q, H = a.H, nt = Q / kT;
  float* cum = reinterpret_cast<float*>(xs + 2 * MmaTile<N>::kX);   // [Q]: cum's hi part
  float* cuml = cum + Q;                   // [Q]: its lo part, fp32(cum - hi)
  float* dec = cuml + Q;                   // [Q]: exp(cum_{Q-1} - cum_j)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;  // the quad's row, the thread in the quad
  const int t = blockIdx.x % nt, h = blockIdx.x / nt;
  const long long chunk = (long long)blockIdx.z * a.nc + blockIdx.y;
  const int i0 = t * kT;
  const bool owner = t == nt - 1;          // the last row tile streams every j tile: it forms S
  const T* xp = static_cast<const T*>(a.xdt) + (chunk * Q * H + h) * kP;
  const T* bp = static_cast<const T*>(a.B) + chunk * Q * N;
  const T* cp = static_cast<const T*>(a.C) + chunk * Q * N;
  const long long xst = (long long)H * kP;  // xdt's step stride

  load_rows<N>(cs, kLdB, cp, N, i0);
  load_rows<N>(bs, kLdB, bp, N, 0);
  load_rows<kP>(xs, kLdX, xp, xst, 0);
  cp_async_commit();
  if (warp == 0) {                         // cum by a warp scan in fp64, kept as hi + lo
    const float* ah = a.a + chunk * Q * H + h;
    const int per = Q / 32, j0 = lane * per;
    double run = 0.0;                      // the lane's Q/32 consecutive steps
    for (int j = j0; j < j0 + per; ++j) run += ah[j * H];
    double incl = run;                     // inclusive scan of the lanes' totals
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    double acc = incl - run;               // the sum of the lanes before this one
    for (int j = j0; j < j0 + per; ++j) {
      acc += ah[j * H];
      const float hi = float(acc);
      cum[j] = hi;
      cuml[j] = float(acc - double(hi));
    }
  }
  __syncthreads();
  if (owner) {
    const float total = cum[Q - 1], total_lo = cuml[Q - 1];
    for (int j = tid; j < Q; j += kMmaThreads)
      dec[j] = expf((total - cum[j]) + (total_lo - cuml[j]));
  }
  const int row0 = i0 + warp * 16 + g;     // this thread's rows row0 (r = 0) and row0 + 8
  const float ci[2] = {cum[row0], cum[row0 + 8]}, cil[2] = {cuml[row0], cuml[row0 + 8]};

  unsigned ca[KC][4];                      // the warp's 16 C rows as A fragments
  float y[NY][4], sacc[NS][4];
#pragma unroll
  for (int n = 0; n < NY; ++n) y[n][0] = y[n][1] = y[n][2] = y[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < NS; ++n) sacc[n][0] = sacc[n][1] = sacc[n][2] = sacc[n][3] = 0.f;

  for (int jt = 0; jt <= t; ++jt) {
    const int j0 = jt * kT;
    const T* bt = bs + (jt & 1) * MmaTile<N>::kB;
    const T* xt = xs + (jt & 1) * MmaTile<N>::kX;
    if (jt < t) {                          // the next tile's copy flies during this one
      load_rows<N>(bs + ((jt + 1) & 1) * MmaTile<N>::kB, kLdB, bp, N, j0 + kT);
      load_rows<kP>(xs + ((jt + 1) & 1) * MmaTile<N>::kX, kLdX, xp, xst, j0 + kT);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                       // this tile (and C, dec) landed for every thread
    if (jt == 0) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        ldsm_x4(smem_addr(cs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdB +
                          kc * 16 + (lane >> 4) * 8),
                ca[kc]);
    }
    // steps j0 + 16 kc .. + 15 in turn; on the diagonal tile, warp w's rows
    // see steps j0 .. j0 + 16 w + 15 only
    const bool diag = jt == t;
#pragma unroll
    for (int kc = 0; kc < kT / 16; ++kc) {
      if (diag && kc > warp) continue;
      // scores = C B^T: n-tile h holds steps j0 + 16 kc + 8 h .. + 7
      float sc[2][4] = {};
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        unsigned bf[4];
        ldsm_x4(smem_addr(bt + (kc * 16 + (lane & 7) + (lane >> 4) * 8) * kLdB + k * 16 +
                          ((lane >> 3) & 1) * 8),
                bf);
        mma_bf16(sc[0], ca[k], bf[0], bf[1]);
        mma_bf16(sc[1], ca[k], bf[2], bf[3]);
      }
      // L = select(j <= i, exp(cum_i - cum_j) scores, 0); element e of sc[h]:
      // row row0 + 8 (e >> 1), step j0 + 16 kc + 8 h + 2 tig + (e & 1)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = j0 + 16 * kc + 8 * h + 2 * tig;
        const float cj[2] = {cum[j], cum[j + 1]}, cjl[2] = {cuml[j], cuml[j + 1]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = !diag || j + (e & 1) <= row0 + 8 * (e >> 1);
          const float d = (ci[e >> 1] - cj[e & 1]) + (cil[e >> 1] - cjl[e & 1]);
          sc[h][e] = in ? expf(d) * sc[h][e] : 0.f;
        }
      }
      // y += the L parts times X; a0..a3: rows g, g + 8 of steps +0..7, +8..15
      unsigned lf[kLParts][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float l0 = sc[i >> 1][2 * (i & 1)], l1 = sc[i >> 1][2 * (i & 1) + 1];
        if constexpr (kLParts == 3)
          split3_bf16(l0, l1, lf[0][i], lf[1][i], lf[2][i]);
        else
          split_bf16(l0, l1, lf[0][i], lf[1][i]);
      }
#pragma unroll
      for (int n = 0; n < NY; n += 2) {
        unsigned xf[4];
        ldsm_x4_trans(smem_addr(xt + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdX +
                                n * 8 + (lane >> 4) * 8),
                      xf);
#pragma unroll
        for (int part = 0; part < kLParts; ++part) {
          mma_bf16(y[n], lf[part], xf[0], xf[1]);
          mma_bf16(y[n + 1], lf[part], xf[2], xf[3]);
        }
      }
    }

    // S += X^T (dec B)_hi + X^T (dec B)_lo: warp w holds rows p = 16 w .. + 15
    if (owner) {
#pragma unroll
      for (int kc = 0; kc < kT / 16; ++kc) {
        unsigned xa[4];                    // X^T [p, j] as A fragments, from X [j, p]
        ldsm_x4_trans(smem_addr(xt + (kc * 16 + (lane & 7) + (lane >> 4) * 8) * kLdX +
                                warp * 16 + ((lane >> 3) & 1) * 8),
                      xa);
        const int j = j0 + kc * 16 + 2 * tig;
        const float d[4] = {dec[j], dec[j + 1], dec[j + 8], dec[j + 9]};
#pragma unroll
        for (int n = 0; n < NS; n += 2) {
          unsigned bf[4], hi[4], lo[4];    // b0, b1 of n-tiles n, n + 1: steps j, j + 1 / j + 8, j + 9
          ldsm_x4_trans(smem_addr(bt + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdB +
                                  n * 8 + (lane >> 4) * 8),
                        bf);
#pragma unroll
          for (int r = 0; r < 4; ++r)
            split_bf16(bf16_lo(bf[r]) * d[2 * (r & 1)], bf16_hi(bf[r]) * d[2 * (r & 1) + 1],
                       hi[r], lo[r]);
          mma_bf16(sacc[n], xa, hi[0], hi[1]);
          mma_bf16(sacc[n], xa, lo[0], lo[1]);
          mma_bf16(sacc[n + 1], xa, hi[2], hi[3]);
          mma_bf16(sacc[n + 1], xa, lo[2], lo[3]);
        }
      }
    }
    __syncthreads();                       // every warp is done with this stage
  }

  // epilogue: element e of an accumulator is row g + 8 (e >> 1), column 2 tig + (e & 1)
  float* yp = a.y + ((chunk * Q + row0) * H + h) * kP + 2 * tig;
#pragma unroll
  for (int n = 0; n < NY; ++n) {
    *reinterpret_cast<float2*>(yp + n * 8) = make_float2(y[n][0], y[n][1]);
    *reinterpret_cast<float2*>(yp + 8 * xst + n * 8) = make_float2(y[n][2], y[n][3]);
  }
  if (owner) {
    float* sp = a.S + ((chunk * H + h) * kP + warp * 16 + g) * N + 2 * tig;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      *reinterpret_cast<float2*>(sp + n * 8) = make_float2(sacc[n][0], sacc[n][1]);
      *reinterpret_cast<float2*>(sp + 8 * N + n * 8) = make_float2(sacc[n][2], sacc[n][3]);
    }
  }
}

template <int N>
cudaError_t launch_mma(const Args& a, int Bz, cudaStream_t stream) {
  const size_t bytes = MmaTile<N>::smem(a.Q);
  cudaError_t err = cudaFuncSetAttribute(ssd_intra_chunk_mma<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Q / kT) * a.H, a.nc, Bz);
  ssd_intra_chunk_mma<N><<<grid, kMmaThreads, bytes, stream>>>(a);
  return cudaGetLastError();
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

// ssd_intra_chunk_mma, bf16 xdt, B and C only: the same arguments; P must be
// 64, N 16 or 128, Q a multiple of 64 up to 256, the xdt, B and C
// pointers 16-byte aligned and y and S 8-byte aligned, or it returns
// cudaErrorInvalidValue without launching.
int ssd_intra_chunk_mma_launch(const void* xdt, const float* a, const void* B, const void* C,
                               float* y, float* S, int Bz, int nc, int Q, int H, int P, int N,
                               void* stream) {
  const void* in[3] = {xdt, B, C};
  const void* out[2] = {y, S};
  for (int i = 0; i < 3; ++i)
    if (reinterpret_cast<uintptr_t>(in[i]) % 16) return int(cudaErrorInvalidValue);
  for (int i = 0; i < 2; ++i)
    if (reinterpret_cast<uintptr_t>(out[i]) % 8) return int(cudaErrorInvalidValue);
  if (P != kP || Q % kT || Q > kMaxQ) return int(cudaErrorInvalidValue);
  if (Bz == 0 || nc == 0 || H == 0 || Q == 0) return 0;
  const Args args{xdt, a, B, C, y, S, nc, Q, H, P, N, 1, 1};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 16: return int(launch_mma<16>(args, Bz, s));
    case 128: return int(launch_mma<128>(args, Bz, s));
    default: return int(cudaErrorInvalidValue);
  }
}

}  // extern "C"
