// relu_attn_noncausal: ReLU linear attention, non-causal, fp32.
//
// Replaces the TPU kernel repro/kernels/relu_attn/kernel.py::
// relu_attn_noncausal, whose grid (row, phase, token tile) carries the
// d x d state in VMEM scratch from the K/V phase to the Q phase.
//
// For each (branch*batch, head) row:
//     kv   = ReLU(K)^T V             (d x d)
//     ksum = sum_n ReLU(K)           (d)
//     out  = ReLU(Q) kv / max(ReLU(Q) . ksum, eps)
//
// Bound on the H100: memory.  Per token the row reads 3d and writes d
// floats (16 d bytes) and does ~4 d^2 flops: ~4 flops/byte at d = 16,
// below the card's ~20 fp32 flops/byte ridge.  At EfficientViT's MSA
// shapes (N = 196 or 49 tokens, d = 16, 8 or 16 heads) a call moves 0.1-1.6
// MB, so one CTA's latency sets its time, not the bytes.
//
// Design.  A CTA of 512 threads takes one (g, head) row and runs both
// phases:
//   staging  the row's Q, K and V token rows arrive by 16-byte cp.async
//            copies, all at once (a tile of up to `tile` tokens; all N at
//            the served shapes), at a row pitch that puts the float4 reads
//            of eight consecutive tokens in distinct banks.
//   phase 0  the threads split the d x d state into 4 x 4 register
//            tiles and the tokens into `sets` (token n to set n mod sets).
//            A thread accumulates its tile and four ksum entries over its
//            set's tokens: 16 independent FMA chains fed by two float4
//            reads a token.  The sets a warp holds are summed by xor
//            shuffles, then the warps' sums by a fixed pairwise tree
//            through shared memory.
//   phase 1  a thread per (token, 4 output columns): ReLU(Q) and the
//            state as float4s (broadcast reads), the 4 numerators and the
//            denominator, num / max(den, eps) with IEEE divisions, one
//            float4 store.
// The head dim 16 is a template argument (every divisor a constant);
// other head dims take a generic instantiation.
// Batch invariance: the arithmetic of a row depends on (N, d, tile)
// only, never on G, the grid or the SM count, and every output is written
// once, without atomics, so a row gives the same bits in any call (the
// FIX8 forward's batch-invariance gate needs that).  The token tiling
// does not change the bits either: a set's sums run through the tiles in
// registers, or through shared memory, in token order.
//
// Layouts.  Q, K and V arrive as strided views of the stacked QKV tensor
// (strides sg, sn, sh shared).  The output addresses row g as (branch g /
// ob, image g % ob) through separate strides, so the MSA writes its
// (B, H, W, branches * heads * d) map, the layout its projection reads,
// with no copy.
#include "common.cuh"

constexpr int RA_THREADS = 512;

// d rounded up to a multiple of 4: the staged row, the state's row.
__host__ __device__ inline int ra_dp(int d) { return (d + 3) & ~3; }
// Floats between staged token rows: dp, plus 4 where dp / 4 is even.
__host__ __device__ inline int ra_pitch(int d) {
  const int dp = ra_dp(d);
  return dp / 4 % 2 ? dp : dp + 4;
}
// 4 x 4 tiles of the d x d state.
__host__ __device__ inline int ra_tiles(int d) {
  const int t = ra_dp(d) / 4;
  return t * t;
}
// Sets of a warp summed by shuffles: 32 / tiles where the tiles divide 32.
__host__ __device__ inline int ra_spw(int d) {
  return 32 % ra_tiles(d) ? 1 : 32 / ra_tiles(d);
}
// Token sets: the threads over the state's tiles, at most 32 partial
// sums left after the shuffles (one set where the tiles outnumber the
// threads: a thread then takes several tiles in turn).
__host__ __device__ inline int ra_sets(int d) {
  const int s = RA_THREADS / ra_tiles(d), cap = 32 * ra_spw(d);
  return s < 1 ? 1 : s < cap ? s : cap;
}
// Partial states left for the tree.
__host__ __device__ inline int ra_slots(int d) {
  const int s = ra_sets(d);
  return s > 1 ? s / ra_spw(d) : 1;
}
// Shared bytes of one CTA (Python mirror: kernels/relu_attn/kernel.py::
// relu_attn_smem_bytes): the Q, K and V tiles [tile][pitch], then the
// partial states [slots][dp * dp + dp] (kv, then ksum).
__host__ __device__ inline long long ra_smem_bytes(int d, int tile) {
  const int dp = ra_dp(d);
  return 4LL * (3LL * tile * ra_pitch(d) +
                (long long)ra_slots(d) * (dp * dp + dp));
}

struct RaArgs {
  const float *q, *k, *v;
  float* out;
  int G, N, heads, d;
  long long sg, sn, sh;      // q / k / v strides: row g, token, head
  int ob;                    // images per branch: g = branch * ob + image
  long long os, oi, on, oh;  // out strides: branch, image, token, head
  int tile;
  float eps;
};

// Tokens [n0, n0 + cnt) of the CTA's row into dst [tile][pitch], zeros
// past d.  The caller commits and waits.
template <int D_>
__device__ __forceinline__ void ra_stage(float* dst, const float* src,
                                         int d_rt, long long sn, int n0,
                                         int cnt, bool vec) {
  const int d = D_ ? D_ : d_rt, P = ra_pitch(d);
  if (vec) {
    const int nc = d / 4;
#pragma unroll 1
    for (int e = threadIdx.x; e < cnt * nc; e += RA_THREADS) {
      const int i = e / nc, c = 4 * (e - i * nc);
      cp_async16(dst + i * P + c, src + (n0 + i) * sn + c, true);
    }
  } else {
    const int nc = ra_dp(d);
#pragma unroll 1
    for (int e = threadIdx.x; e < cnt * nc; e += RA_THREADS) {
      const int i = e / nc, c = e - i * nc;
      cp_async4(dst + i * P + c, c < d ? src + (n0 + i) * sn + c : src,
                c < d);
    }
  }
}

// acc += ReLU(K)^T V over this tile's tokens of set s (of S), rows i0..
// and columns j0.. of the state; ksum += ReLU(K) rows i0..
__device__ __forceinline__ void ra_accumulate(float (&acc)[4][4],
                                              float (&ksum)[4],
                                              const float* kr,
                                              const float* vr, int P,
                                              int first, int cnt, int S) {
#pragma unroll 2
  for (int i = first; i < cnt; i += S) {
    const float4 kk = *reinterpret_cast<const float4*>(kr + i * P);
    const float4 vv = *reinterpret_cast<const float4*>(vr + i * P);
    const float k4[4] = {fmaxf(kk.x, 0.0f), fmaxf(kk.y, 0.0f),
                         fmaxf(kk.z, 0.0f), fmaxf(kk.w, 0.0f)};
    const float v4[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      ksum[ii] += k4[ii];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        acc[ii][jj] = fmaf(k4[ii], v4[jj], acc[ii][jj]);
    }
  }
}

template <int D_>
__global__ void __launch_bounds__(RA_THREADS) relu_attn_kernel(RaArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int d = D_ ? D_ : a.d;
  const int dp = ra_dp(d), P = ra_pitch(d), t4 = dp / 4, TT = t4 * t4;
  const int S = ra_sets(d), spw = ra_spw(d), slots = ra_slots(d);
  const int ST = dp * dp + dp, tile = a.tile;
  float* qs = smem;
  float* ks = qs + tile * P;
  float* vs = ks + tile * P;
  float* part = vs + tile * P;   // [slots][ST]
  const int tid = threadIdx.x;
  const int g = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const long long base = g * a.sg + h * a.sh;
  const int ntiles = (a.N + tile - 1) / tile;
  const bool vec = d % 4 == 0 && aligned16(a.q) && aligned16(a.k) &&
                   aligned16(a.v) && (a.sg | a.sn | a.sh) % 4 == 0;

  // Q's first tile travels with K and V's: phase 0 leaves it untouched
  ra_stage<D_>(qs, a.q + base, d, a.sn, 0, min(tile, a.N), vec);

  // Phase 0: thread u takes items (set s, tile) u, u + RA_THREADS, ..,
  // item = s * TT + tile, so a warp's lanes u and u ^ (TT k) share a tile
  if (S > 1) {
    // one item a thread, its sums in registers through every tile
    const int s = tid / TT, tl = tid % TT;
    const int i0 = 4 * (tl / t4), j0 = 4 * (tl % t4);
    const bool act = s < S;
    float acc[4][4] = {}, ksum[4] = {};
#pragma unroll 1
    for (int t = 0; t < ntiles; ++t) {
      const int n0 = t * tile, cnt = min(tile, a.N - n0);
      if (t > 0) __syncthreads();   // the previous K / V tile is consumed
      ra_stage<D_>(ks, a.k + base, d, a.sn, n0, cnt, vec);
      ra_stage<D_>(vs, a.v + base, d, a.sn, n0, cnt, vec);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (act)
        ra_accumulate(acc, ksum, ks + i0, vs + j0, P,
                      ((s - n0) % S + S) % S, cnt, S);
    }
    // the sets of a warp: lanes TT apart hold the same tile; a butterfly
    // gives every lane the same bits
#pragma unroll 1
    for (int o = TT; o < 32 && spw > 1; o *= 2) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ksum[i] += __shfl_xor_sync(0xffffffffu, ksum[i], o);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], o);
      }
    }
    if (act && s % spw == 0) {
      float* dst = part + s / spw * ST;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (j0 == 0) dst[dp * dp + i0 + i] = ksum[i];
        *reinterpret_cast<float4*>(dst + (i0 + i) * dp + j0) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
    }
  } else {
    // one set: a thread takes several tiles in turn, their sums carried
    // from token tile to token tile in shared memory
#pragma unroll 1
    for (int t = 0; t < ntiles; ++t) {
      const int n0 = t * tile, cnt = min(tile, a.N - n0);
      if (t > 0) __syncthreads();
      ra_stage<D_>(ks, a.k + base, d, a.sn, n0, cnt, vec);
      ra_stage<D_>(vs, a.v + base, d, a.sn, n0, cnt, vec);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll 1
      for (int tl = tid; tl < TT; tl += RA_THREADS) {
        const int i0 = 4 * (tl / t4), j0 = 4 * (tl % t4);
        float acc[4][4], ksum[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ksum[i] = t && j0 == 0 ? part[dp * dp + i0 + i] : 0.0f;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = t ? part[(i0 + i) * dp + j0 + j] : 0.0f;
        }
        ra_accumulate(acc, ksum, ks + i0, vs + j0, P, 0, cnt, 1);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (j0 == 0) part[dp * dp + i0 + i] = ksum[i];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            part[(i0 + i) * dp + j0 + j] = acc[i][j];
        }
      }
    }
  }
  __syncthreads();
  // the partial states, summed pairwise into slot 0 (slot k takes slot
  // k + w at w = 1, 2, 4, ..): a fixed order
  if (slots > 1) {
#pragma unroll 1
    for (int x = tid; x < ST; x += RA_THREADS) {
      float* p0 = part + x;
      float v[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) v[k] = k < slots ? p0[k * ST] : 0.0f;
#pragma unroll
      for (int w = 1; w < 32; w *= 2)
#pragma unroll
        for (int k = 0; k + w < 32; k += 2 * w)
          if (k + w < slots) v[k] += v[k + w];
      p0[0] = v[0];
    }
    __syncthreads();
  }

  // Phase 1: a thread per (token, 4 output columns)
  const bool ovec = d % 4 == 0 && aligned16(a.out) &&
                    (a.os | a.oi | a.on | a.oh) % 4 == 0;
  float* ob = a.out + (g / a.ob) * a.os + (g % a.ob) * a.oi + h * a.oh;
#pragma unroll 1
  for (int t = 0; t < ntiles; ++t) {
    const int n0 = t * tile, cnt = min(tile, a.N - n0);
    if (t > 0) {
      __syncthreads();   // the previous Q tile is consumed
      ra_stage<D_>(qs, a.q + base, d, a.sn, n0, cnt, vec);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
#pragma unroll 1
    for (int e = tid; e < cnt * t4; e += RA_THREADS) {
      const int i = e / t4, e0 = 4 * (e - i * t4);
      const float* qr = qs + i * P;
      float num[4] = {}, den = 0.0f;
#pragma unroll 1
      for (int c = 0; c < dp; c += 4) {
        const float4 q4 = *reinterpret_cast<const float4*>(qr + c);
        const float4 k4 =
            *reinterpret_cast<const float4*>(part + dp * dp + c);
        const float qv[4] = {fmaxf(q4.x, 0.0f), fmaxf(q4.y, 0.0f),
                             fmaxf(q4.z, 0.0f), fmaxf(q4.w, 0.0f)};
        const float kv4[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float4 w =
              *reinterpret_cast<const float4*>(part + (c + m) * dp + e0);
          num[0] = fmaf(qv[m], w.x, num[0]);
          num[1] = fmaf(qv[m], w.y, num[1]);
          num[2] = fmaf(qv[m], w.z, num[2]);
          num[3] = fmaf(qv[m], w.w, num[3]);
          den = fmaf(qv[m], kv4[m], den);
        }
      }
      const float dd = fmaxf(den, a.eps);
      float* o = ob + (n0 + i) * a.on + e0;
      if (ovec) {
        *reinterpret_cast<float4*>(o) =
            make_float4(__fdiv_rn(num[0], dd), __fdiv_rn(num[1], dd),
                        __fdiv_rn(num[2], dd), __fdiv_rn(num[3], dd));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (e0 + j < d) o[j] = __fdiv_rn(num[j], dd);
      }
    }
  }
}

template <int D_>
static cudaError_t ra_launch(const RaArgs& a, cudaStream_t s) {
  const size_t smem = (size_t)ra_smem_bytes(a.d, a.tile);
  static size_t granted = 48 * 1024;
  cudaError_t err = allow_smem(relu_attn_kernel<D_>, smem, &granted);
  if (err != cudaSuccess) return err;
  relu_attn_kernel<D_><<<a.G * a.heads, RA_THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

// tile: tokens staged at once; out row g = branch * ob + image.  A
// refused launch returns its error; nothing falls back.
REPRO_EXPORT int relu_attn_noncausal_f32(
    const float* q, const float* k, const float* v, float* out, int G, int N,
    int heads, int D, long long sg, long long sn, long long sh, int ob,
    long long os, long long oi, long long on, long long oh, int tile,
    float eps, void* stream) {
  if (tile < 1 || D < 1 || ob < 1 || G % ob)
    return (int)cudaErrorInvalidValue;
  const RaArgs a{q,  k,  v,  out, G,  N,  heads, D,   sg,
                 sn, sh, ob, os,  oi, on, oh,    tile, eps};
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(D == 16 ? ra_launch<16>(a, s) : ra_launch<0>(a, s));
}

REPRO_EXPORT long long relu_attn_smem_c(int d, int tile) {
  return ra_smem_bytes(d, tile);
}
