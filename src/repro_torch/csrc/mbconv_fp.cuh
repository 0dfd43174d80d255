// The register-tiled fp32 stages of a fused MBConv (and of a DSConv's
// DW + PW), shared by csrc/mbconv.cu (one site) and csrc/supersite.cu
// (a chain of sites):
//   1. gemm_rows<BN>: C = A . B with A row-major in device or shared
//      memory (a window's pixels, C channels each) and B a row-major
//      weight matrix in device memory.  PW1: window pixels x C times
//      C x chunk.
//   2. dw3x3: DW 3x3 + bias + Hardswish at the stride anchors of a
//      zero-padded window [rows][W + 2][bm] of one channel chunk, into a
//      channel-major result [bm][ldp].
//   3. gemm_kmajor<BN>: C = A . B with A already channel-major in shared
//      memory (the DW result).  PW2: output pixels x chunk times chunk x F.
//
// A GEMM runs in macro tiles of BM x BN outputs over a CTA of NT = 256
// threads, each thread owning a 4 x 4 accumulator tile (TX = BN / 4
// threads along N, TY = NT / TX along M, BM = 4 * TY).  K advances in
// tiles of KT = 16 through a ring of STAGES = 3 shared buffers filled by
// cp.async (16 bytes a copy where rows are float4-aligned, 4 bytes
// otherwise), so two K tiles are in flight from L2 while one computes:
// the short K loops of these GEMMs (C = 16-256, a chunk of 16-128) would
// otherwise wait on L2 at every tile.  Each k costs one float4 load of A
// and one of B per 16 FFMAs.  All fp32 FFMA on CUDA cores: TF32 tensor
// cores would break fp32 parity.
//
// Rows and columns beyond the problem are zero-filled (A and B), so a
// ragged tile computes zeros there, and the epilogue is called only for
// rows < P; it gets a float4 of columns [n, n + 4) and checks n + j < N
// itself.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace mbfp {

constexpr int NT = 256;    // threads of a CTA
constexpr int STAGES = 3;  // K tiles in flight (cp.async ring)
constexpr int KT = 16;     // K-tile depth

// Rows of a macro tile of width bn (16, 32, 64 or 128).
__host__ __device__ constexpr int tile_bm(int bn) { return 4 * (NT / (bn / 4)); }
// PW2's tile width for P output pixels and F channels: the one of 16,
// 32, 64 and 128 whose macro tiles cover P x F with the fewest padded
// outputs, the wider on a tie (a small band's few pixels fill a wide,
// short tile better).
__host__ __device__ inline int pw2_bn(int P, int F) {
  int best = 16, cost = -1;
  for (int bn = 16; bn <= 128; bn *= 2) {
    if (bn > 16 && bn / 2 >= F) break;
    const int bm = tile_bm(bn);
    const int c = (P + bm - 1) / bm * bm * ((F + bn - 1) / bn * bn);
    if (cost < 0 || c <= cost) {
      best = bn;
      cost = c;
    }
  }
  return best;
}
// Shared floats of gemm_rows' staging: STAGES x (A [BM][KT + 4], B
// [KT][BN]).
__host__ __device__ constexpr int rows_stage_floats(int bn) {
  return STAGES * (tile_bm(bn) * (KT + 4) + KT * bn);
}
// Shared floats of gemm_kmajor's staging: STAGES x B [KT][BN].
__host__ __device__ constexpr int kmajor_stage_floats(int bn) {
  return STAGES * KT * bn;
}
__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// Issue the cp.async copies of B[k0 : k0 + KT][n0 : n0 + BN] into Bs
// ([KT][BN]), zero outside K x N; float4 copies when vec (ldb and N
// multiples of 4, B 16-byte aligned).  The copy loops stay rolled: the
// compiler would otherwise keep every unrolled copy's address live across
// the K loop and spill.
template <int BN, int KT>
__device__ __forceinline__ void load_b(float* Bs, const float* B, int ldb,
                                       int k0, int K, int n0, int N,
                                       bool vec) {
  if (vec) {
#pragma unroll 1
    for (int e = threadIdx.x; e < KT * BN / 4; e += NT) {
      const int k = e / (BN / 4), c = (e % (BN / 4)) * 4;
      const bool ok = k0 + k < K && n0 + c < N;
      cp_async16(Bs + k * BN + c, ok ? B + (size_t)(k0 + k) * ldb + n0 + c : B,
                 ok);
    }
  } else {
#pragma unroll 1
    for (int e = threadIdx.x; e < KT * BN; e += NT) {
      const int k = e / BN, c = e % BN;
      const bool ok = k0 + k < K && n0 + c < N;
      cp_async4(Bs + k * BN + c, ok ? B + (size_t)(k0 + k) * ldb + n0 + c : B,
                ok);
    }
  }
}

// Copy A[p0 : p0 + BM][k0 : k0 + KT] into As ([BM][KT + 4], row-major),
// zero outside P x K.  Row p of A is at A + p * lda, in device memory
// (cp.async; zero fills read nothing) or, when A_SHARED, in shared memory
// (plain copies).  vec: A and lda allow float4 runs and K % 4 == 0, so a
// run of 4 k is all in or all out.
template <int BN, bool A_SHARED>
__device__ __forceinline__ void load_a(float* As, const float* A, int lda,
                                       int p0, int P, int k0, int K,
                                       bool vec) {
  constexpr int BM = tile_bm(BN), LDA = KT + 4, C4 = KT / 4;
#pragma unroll 1
  for (int e = threadIdx.x; e < BM * C4; e += NT) {
    const int r = e / C4, c = (e % C4) * 4, k = k0 + c;
    float* dst = As + r * LDA + c;
    const bool row = p0 + r < P;
    const float* src = A + (size_t)(row ? p0 + r : 0) * lda + k;
    if (vec) {
      const bool ok = row && k < K;
      if (A_SHARED)
        *reinterpret_cast<float4*>(dst) =
            ok ? *reinterpret_cast<const float4*>(src)
               : make_float4(0.f, 0.f, 0.f, 0.f);
      else
        cp_async16(dst, ok ? src : A, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = row && k + j < K;
        if (A_SHARED)
          dst[j] = ok ? src[j] : 0.0f;
        else
          cp_async4(dst + j, ok ? src + j : A, ok);
      }
    }
  }
}

// One K tile of a thread's 4 x 4 accumulator from a row-major A tile
// (a = its first row, rows lda apart) and B rows [k][col]: per 4 k, four
// float4 loads of A and four of B for 64 FFMAs.
template <int BN>
__device__ __forceinline__ void mma_rows(float (&acc)[4][4], const float* a,
                                         int lda, const float* b) {
#pragma unroll
  for (int k = 0; k < KT; k += 4) {
    float ar[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(a + i * lda + k);
      ar[i][0] = v.x;
      ar[i][1] = v.y;
      ar[i][2] = v.z;
      ar[i][3] = v.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 bv = *reinterpret_cast<const float4*>(b + (k + kk) * BN);
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(ar[i][kk], br[j], acc[i][j]);
    }
  }
}

// One K tile from a k-major A (a = A[k][row], rows lda apart): one
// float4 of A and one of B per k, 16 FFMAs.
template <int BN>
__device__ __forceinline__ void mma_kmajor(float (&acc)[4][4], const float* a,
                                           int lda, const float* b) {
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(a + k * lda);
    const float4 bv = *reinterpret_cast<const float4*>(b + k * BN);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
  }
}

// The epilogue of a macro tile: epi(p, n, float4) for the thread's rows
// p < P and its first column n < N.
template <class Epi>
__device__ __forceinline__ void tile_epilogue(const float (&acc)[4][4], int p,
                                              int P, int n, int N,
                                              Epi epi) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (p + i < P && n < N)
      epi(p + i, n,
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
}

// C[P x N] = A[P x K] . B[K x N]; row p of A at A + p * lda (device
// memory, or shared memory when A_SHARED), B row-major with leading
// dimension ldb in device memory.  epi(p, n, float4) gets columns
// [n, n + 4) of row p.  K tiles of A and B stream through a ring of
// STAGES buffers.  stage: rows_stage_floats(BN) shared floats.  Ends
// with __syncthreads.
template <int BN, bool A_SHARED, class Epi>
__device__ __forceinline__ void gemm_rows(const float* A, int lda, int P,
                                          int K, const float* B, int ldb,
                                          int N, float* stage, Epi epi) {
  constexpr int TX = BN / 4, BM = tile_bm(BN), LDA = KT + 4;
  float* As = stage;                       // [STAGES][BM][LDA]
  float* Bs = stage + STAGES * BM * LDA;   // [STAGES][KT][BN]
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const bool vec = aligned16(B) && ldb % 4 == 0 && N % 4 == 0;
  const bool avec = aligned16(A) && lda % 4 == 0 && K % 4 == 0;
  const int nk = (K + KT - 1) / KT;
  for (int n0 = 0; n0 < N; n0 += BN) {
    for (int p0 = 0; p0 < P; p0 += BM) {
      // K tiles 0 .. STAGES - 2 in flight before the loop; each
      // iteration issues the tile STAGES - 1 ahead (an empty group past
      // the end keeps the wait count uniform)
#pragma unroll
      for (int kt = 0; kt < STAGES - 1; ++kt) {
        if (kt < nk) {
          load_a<BN, A_SHARED>(As + kt * BM * LDA, A, lda, p0, P, kt * KT,
                               K, avec);
          load_b<BN, KT>(Bs + kt * KT * BN, B, ldb, kt * KT, K, n0, N,
                          vec);
        }
        cp_async_commit();
      }
      float acc[4][4] = {};
      for (int kt = 0; kt < nk; ++kt) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();  // tile kt landed everywhere; slot kt - 1 is free
        const int ki = kt + STAGES - 1;
        if (ki < nk) {
          const int si = ki % STAGES;
          load_a<BN, A_SHARED>(As + si * BM * LDA, A, lda, p0, P, ki * KT,
                               K, avec);
          load_b<BN, KT>(Bs + si * KT * BN, B, ldb, ki * KT, K, n0, N,
                          vec);
        }
        cp_async_commit();
        const int s = kt % STAGES;
        mma_rows<BN>(acc, As + (s * BM + ty * 4) * LDA, LDA,
                          Bs + s * KT * BN + tx * 4);
      }
      tile_epilogue(acc, p0 + ty * 4, P, n0 + tx * 4, N, epi);
      __syncthreads();
    }
  }
}

// C[P x N] = A[P x K] . B[K x N] with A channel-major in shared memory,
// A(p, k) = A[k * lda + p], lda = round4(P); rows k < round_up(K, KT)
// of A must hold finite values (their B rows are zero).  B and epi as in
// gemm_rows; B's K tiles stream through a ring of STAGES buffers.
// stage: kmajor_stage_floats(BN) shared floats.  Ends with
// __syncthreads.
template <int BN, class Epi>
__device__ __forceinline__ void gemm_kmajor(const float* A, int lda, int P,
                                            int K, const float* B, int ldb,
                                            int N, float* stage, Epi epi) {
  constexpr int TX = BN / 4, BM = tile_bm(BN);
  float* Bs = stage;  // [STAGES][KT][BN]
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const bool vec = aligned16(B) && ldb % 4 == 0 && N % 4 == 0;
  const int nk = (K + KT - 1) / KT;
  for (int n0 = 0; n0 < N; n0 += BN) {
    for (int p0 = 0; p0 < P; p0 += BM) {
      // rows past lda - 4 read the last group: in bounds, never stored
      const int pa = min(p0 + ty * 4, lda - 4);
#pragma unroll
      for (int kt = 0; kt < STAGES - 1; ++kt) {
        if (kt < nk)
          load_b<BN, KT>(Bs + kt * KT * BN, B, ldb, kt * KT, K, n0, N, vec);
        cp_async_commit();
      }
      float acc[4][4] = {};
      for (int kt = 0; kt < nk; ++kt) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();
        const int ki = kt + STAGES - 1;
        if (ki < nk)
          load_b<BN, KT>(Bs + (ki % STAGES) * KT * BN, B, ldb, ki * KT, K, n0,
                         N, vec);
        cp_async_commit();
        mma_kmajor<BN>(acc, A + (size_t)kt * KT * lda + pa, lda,
                       Bs + (kt % STAGES) * KT * BN + tx * 4);
      }
      tile_epilogue(acc, p0 + ty * 4, P, n0 + tx * 4, N, epi);
      __syncthreads();
    }
  }
}

// Zero the parts of a padded window [T][Wp][bm] that no pixel writes:
// the rows outside [lo, hi) (outside the map) and the pad columns 0 and
// Wp - 1 of the rows inside.
__device__ __forceinline__ void zero_border(float* win, int T, int Wp, int bm,
                                            int lo, int hi) {
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  const int q4 = bm / 4;
  for (int e = threadIdx.x; e < T * Wp * q4; e += NT) {
    const int c = e % q4, t = e / q4;
    const int tr = t / Wp, col = t % Wp;
    if (tr < lo || tr >= hi || col == 0 || col == Wp - 1)
      reinterpret_cast<float4*>(win + (size_t)t * bm)[c] = z;
  }
}

// PW1 epilogue value: Hardswish(acc + bias) for live channels, ZERO for
// the chunk's dead columns (n >= mw), so the window holds no garbage.
__device__ __forceinline__ float4 bias_hswish(float4 v, const float* bias,
                                              int n, int mw) {
  v.x = n + 0 < mw ? hswish(v.x + __ldg(bias + n + 0)) : 0.0f;
  v.y = n + 1 < mw ? hswish(v.y + __ldg(bias + n + 1)) : 0.0f;
  v.z = n + 2 < mw ? hswish(v.z + __ldg(bias + n + 2)) : 0.0f;
  v.w = n + 3 < mw ? hswish(v.w + __ldg(bias + n + 3)) : 0.0f;
  return v;
}

// DW 3x3 + bias + Hardswish over a padded window win [T][Wp][bm] (window
// row 0 is the top tap of output row 0) at the stride anchors s - 1,
// for P = rows * Wo output pixels -> ds [bm][ldp], ldp = round4(P).
// Weights dww[(dy * 3 + dx) * ldw + n], bias dwb[n], n < mw; dead
// channels and the pad pixels p >= P get zero.  Each thread keeps one
// channel's 9 taps in registers and writes 4 pixels as one float4.
__device__ __forceinline__ void dw3x3(const float* win, int Wp, int bm, int mw,
                                      int P, int Wo, int s,
                                      const float* dww, int ldw,
                                      const float* dwb, float* ds) {
  const int ldp = round4(P);
  const int n = threadIdx.x % bm;  // NT is a multiple of bm
  const bool live = n < mw;
  float wt[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) wt[t] = live ? __ldg(dww + t * ldw + n) : 0.0f;
  const float bias = live ? __ldg(dwb + n) : 0.0f;
  for (int g = threadIdx.x / bm; g < ldp / 4; g += NT / bm) {
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = 4 * g + j;
      float v = 0.0f;
      if (live && p < P) {
        const int r = p / Wo, wo = p % Wo;
        const float* mp = win + ((r * s) * Wp + wo * s + s - 1) * bm + n;
        float a = 0.0f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
            a = fmaf(mp[(dy * Wp + dx) * bm], wt[dy * 3 + dx], a);
        v = hswish(a + bias);
      }
      o[j] = v;
    }
    *reinterpret_cast<float4*>(ds + (size_t)n * ldp + 4 * g) =
        make_float4(o[0], o[1], o[2], o[3]);
  }
}

// Add a float4 of columns [n, n + 4) into row p of acc [P][F] (ld F).
__device__ __forceinline__ void add_row4(float* acc, int F, int p, int n,
                                         float4 v) {
  float* a = acc + (size_t)p * F + n;
  if (F % 4 == 0) {
    float4 o = *reinterpret_cast<float4*>(a);
    o.x += v.x;
    o.y += v.y;
    o.z += v.z;
    o.w += v.w;
    *reinterpret_cast<float4*>(a) = o;
  } else {
    const float r[4] = {v.x, v.y, v.z, v.w};
    for (int j = 0; j < 4 && n + j < F; ++j) a[j] += r[j];
  }
}

// Dispatch a GEMM on its tile width (16, 32, 64 or 128).
#define MBFP_DISPATCH_BN(bn, BN, ...) \
  switch (bn) {                       \
    case 16: {                        \
      constexpr int BN = 16;          \
      __VA_ARGS__;                    \
    } break;                          \
    case 32: {                        \
      constexpr int BN = 32;          \
      __VA_ARGS__;                    \
    } break;                          \
    case 64: {                        \
      constexpr int BN = 64;          \
      __VA_ARGS__;                    \
    } break;                          \
    default: {                        \
      constexpr int BN = 128;         \
      __VA_ARGS__;                    \
    } break;                          \
  }

// PW1's epilogue: bias + Hardswish of window pixel q (row lo + q / W)
// into the padded window [T][W + 2][bm].
struct MidEpi {
  float* win;
  const float* b1;
  int lo, W, bm, mw;
  __device__ __forceinline__ void operator()(int q, int n, float4 v) const {
    const int tr = lo + q / W, col = q % W + 1;
    *reinterpret_cast<float4*>(win + ((size_t)tr * (W + 2) + col) * bm + n) =
        bias_hswish(v, b1, n, mw);
  }
};

// PW2's epilogue: add the partial sums into acc [P][F].
struct AccEpi {
  float* acc;
  int F;
  __device__ __forceinline__ void operator()(int p, int n, float4 v) const {
    add_row4(acc, F, p, n, v);
  }
};

// One channel chunk [m0, m0 + mw) of an MBConv over a band, after the
// window's border is zero: PW1 into `win`, DW into `xs`, PW2 partial
// sums added into acc [P][F].  Window pixel q's C input channels are at
// x + q * C (shared memory when A_SHARED), q < NQ: the window rows
// [lo, hi) inside the map, NQ = (hi - lo) * W.  w1/b1/dww/dwb/w2 are
// offset to the chunk's first channel; M is the full mid width (the
// leading dimension of w1 and of dww); bn2 is PW2's tile width.  xs:
// the larger of rows_stage_floats(bm) and bm * round4(P) shared floats
// (PW1 staging, then the DW result); win: the window, then PW2's staging
// (kmajor_stage_floats(bn2)).
template <bool A_SHARED>
__device__ __forceinline__ void mbconv_chunk(
    const float* x, int NQ, int lo, int W, int C, int M, int mw, int bm,
    const float* w1, const float* b1, const float* dww, const float* dwb,
    const float* w2, int F, int bn2, int P, int Wo, int s, float* xs,
    float* win, float* acc) {
  const MidEpi mid{win, b1, lo, W, bm, mw};
  MBFP_DISPATCH_BN(bm, BN,
                   gemm_rows<BN, A_SHARED>(x, C, NQ, C, w1, M, mw, xs, mid));
  dw3x3(win, W + 2, bm, mw, P, Wo, s, dww, M, dwb, xs);
  __syncthreads();
  const AccEpi add{acc, F};
  MBFP_DISPATCH_BN(bn2, BN,
                   gemm_kmajor<BN>(xs, round4(P), P, mw, w2, F, F, win, add));
}

}  // namespace mbfp
