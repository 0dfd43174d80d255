// ssd_chunked: the Mamba-2 chunked SSD (state-space duality) scan, fp32.
//
// Replaces the TPU kernel repro/kernels/ssd/kernel.py::ssd_chunked_pallas,
// whose grid (row, chunk) runs the chunks of a row in order and carries the
// N x P state in VMEM scratch.  Per chunk of C tokens, with cum the
// in-chunk cumsum of dA:
//     L[l, s] = exp(min(cum_l - cum_s, 0) tril) tril            (C x C)
//     y       = ((Cm Bm^T) L) (x dt) + exp(cum) (Cm state)
//     state   = Bm^T (exp(cum_last - cum) dt x) + exp(cum_last) state
//
// Bound on the H100: operations.  Per chunk the products are 2 C^2 (N + P)
// + 4 C N P flops against 4 C (2 N + 2 P + 2) bytes: at Mamba2-1.3B's
// shape (P 64, N 128, C 256) ~100 flops/byte, above the ~20 fp32
// flops/byte ridge of the CUDA cores (fp32 throughout: the decays need it).
//
// Design, as csrc/relu_attn_causal.cu (the same skeleton plus the decay):
//   - one CTA per (row, slice of PE head-dim columns): y[:, p] and
//     state[:, p] need only column p of x, and each CTA recomputes the
//     chunk's C Bm^T and L.  At batch 1 Mamba2-1.3B has 64 rows against 132
//     SMs; the split fills the card.  The wrapper picks PE.
//   - the CTA runs its row's chunks in order; inside a chunk, 64-token
//     query tiles, each with its state term and the score tiles of the key
//     tiles at or before it; the last query tile folds the key tiles into
//     the state after decaying it by exp(cum_last).
//   - the cumsum runs in one warp: each lane sums a contiguous segment in
//     order, then the lanes' totals are scanned with shuffles.
//   - a ragged S: tokens past S load as dt = dA = x = B = C = 0, so they
//     add nothing to any output or to the state, and are not written.
//     (The TPU kernel takes the whole sequence as one chunk when S is not
//     a multiple of the chunk, which no CTA could hold at 32k tokens.)
// The sums, the cumsum and the exps run in another order than the plain
// version's, so the two agree to fp32 rounding, not bit for bit.
#include "common.cuh"

constexpr int ST = 64;            // token tile: query rows and key rows
constexpr int ST_THREADS = 256;   // 16 x 16

template <int NJ>
__global__ void __launch_bounds__(ST_THREADS)
    ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ dA, const float* __restrict__ Bm,
               const float* __restrict__ Cm, float* __restrict__ y, int S,
               int P, int N, int chunk) {
  constexpr int PE = 16 * NJ;
  extern __shared__ float smem[];
  const int NP = N + 1;
  float* st = smem;               // [N][PE] state slice
  float* cum = st + N * PE;       // [chunk] in-chunk cumsum of dA
  float* dts = cum + chunk;       // [chunk] dt
  float* dec = dts + chunk;       // [chunk] exp(cum_last - cum)
  float* cs = dec + chunk;        // [ST][NP] Cm tile
  float* bs = cs + ST * NP;       // [ST][NP] Bm tile
  float* xs = bs + ST * NP;       // [ST][PE] x * dt tile, this CTA's columns
  float* ss = xs + ST * PE;       // [ST][ST + 1] scores (C Bm^T) L
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int p0 = blockIdx.y * PE, pe = min(PE, P - p0);
  const size_t row = blockIdx.x;
  const float* xr = x + row * S * P;
  const float* dtr = dt + row * S;
  const float* dar = dA + row * S;
  const float* br = Bm + row * S * N;
  const float* cr = Cm + row * S * N;
  float* yr = y + row * S * P;

  for (int i = tid; i < N * PE; i += ST_THREADS) st[i] = 0.0f;
  for (int c0 = 0; c0 < S; c0 += chunk) {
    const int cn = min(chunk, S - c0), nt = (cn + ST - 1) / ST;
    __syncthreads();   // the previous chunk is done with cum, dts, dec
    for (int i = tid; i < chunk; i += ST_THREADS)
      dts[i] = i < cn ? dtr[c0 + i] : 0.0f;
    if (tid < 32) {
      const int per = (chunk + 31) / 32, lo = min(tid * per, chunk),
                hi = min(lo + per, chunk);
      float run = 0.0f;
      for (int i = lo; i < hi; ++i) {
        run += i < cn ? dar[c0 + i] : 0.0f;
        cum[i] = run;
      }
      float incl = run;
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += t;
      }
      const float off = incl - run;
      for (int i = lo; i < hi; ++i) cum[i] += off;
    }
    __syncthreads();
    const float cl = cum[chunk - 1];
    for (int i = tid; i < chunk; i += ST_THREADS) dec[i] = expf(cl - cum[i]);
    for (int qi = 0; qi < nt; ++qi) {
      const int l0 = qi * ST, qn = min(ST, cn - l0);
      __syncthreads();   // the state is final; the previous tiles are read
      for (int i = tid; i < ST * N; i += ST_THREADS) {
        const int r = i / N, n = i % N;
        cs[r * NP + n] = r < qn ? cr[(size_t)(c0 + l0 + r) * N + n] : 0.0f;
      }
      __syncthreads();
      // the state term: exp(cum_l) (Cm_l . state)
      float acc[4][NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
      for (int n = 0; n < N; ++n) {
        float sv[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) sv[j] = st[n * PE + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = cs[(ty + 16 * i) * NP + n];
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] += a * sv[j];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = ty + 16 * i;
        const float e = l < qn ? expf(cum[l0 + l]) : 0.0f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] *= e;
      }
      const bool last = qi == nt - 1;
      for (int ki = 0; ki <= qi; ++ki) {
        const int s0 = ki * ST, kn = min(ST, cn - s0);
        __syncthreads();   // the state term and the previous key tile read
        for (int i = tid; i < ST * N; i += ST_THREADS) {
          const int r = i / N, n = i % N;
          bs[r * NP + n] = r < kn ? br[(size_t)(c0 + s0 + r) * N + n] : 0.0f;
        }
        for (int i = tid; i < ST * PE; i += ST_THREADS) {
          const int r = i / PE, c = i % PE;
          xs[i] = (r < kn && c < pe)
                      ? xr[(size_t)(c0 + s0 + r) * P + p0 + c] * dts[s0 + r]
                      : 0.0f;
        }
        if (last && ki == 0) {   // decay the state before this chunk's fold
          const float e = expf(cl);
          for (int i = tid; i < N * PE; i += ST_THREADS) st[i] *= e;
        }
        __syncthreads();
        {
          float s[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
          for (int n = 0; n < N; ++n) {
            float a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = cs[(ty + 16 * i) * NP + n];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = bs[(tx + 16 * j) * NP + n];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) s[i][j] += a[i] * b[j];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int l = l0 + ty + 16 * i, m = s0 + tx + 16 * j;
              const float L = (m <= l && l < cn)
                                  ? expf(fminf(cum[l] - cum[m], 0.0f))
                                  : 0.0f;
              ss[(ty + 16 * i) * (ST + 1) + tx + 16 * j] = s[i][j] * L;
            }
        }
        __syncthreads();
        for (int m = 0; m < kn; ++m) {
          float xv[NJ];
#pragma unroll
          for (int j = 0; j < NJ; ++j) xv[j] = xs[m * PE + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float sv = ss[(ty + 16 * i) * (ST + 1) + m];
#pragma unroll
            for (int j = 0; j < NJ; ++j) acc[i][j] += sv * xv[j];
          }
        }
        if (last) {   // fold this key tile into the state
          for (int i = tid; i < N * PE; i += ST_THREADS) {
            const int n = i / PE, c = i % PE;
            float a = 0.0f;
            for (int m = 0; m < kn; ++m)
              a += bs[m * NP + n] * dec[s0 + m] * xs[m * PE + c];
            st[i] += a;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = ty + 16 * i;
        if (l >= qn) continue;
        float* yrow = yr + (size_t)(c0 + l0 + l) * P + p0;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int c = tx + 16 * j;
          if (c < pe) yrow[c] = acc[i][j];
        }
      }
    }
  }
}

// Shared-memory bytes of one CTA; python mirror:
// kernels/ssd/kernel.py::ssd_smem_bytes.
static size_t ssd_smem_bytes(int N, int PE, int chunk) {
  return sizeof(float) * ((size_t)N * PE + 3 * (size_t)chunk +
                          2 * (size_t)ST * (N + 1) + (size_t)ST * PE +
                          (size_t)ST * (ST + 1));
}

template <int NJ>
static int ssd_launch(const float* x, const float* dt, const float* dA,
                      const float* Bm, const float* Cm, float* y, int BH,
                      int S, int P, int N, int chunk, cudaStream_t s) {
  const size_t smem = ssd_smem_bytes(N, 16 * NJ, chunk);
  static size_t granted = 48 * 1024;
  cudaError_t err = allow_smem(ssd_kernel<NJ>, smem, &granted);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(BH, (P + 16 * NJ - 1) / (16 * NJ));
  ssd_kernel<NJ><<<grid, ST_THREADS, smem, s>>>(x, dt, dA, Bm, Cm, y, S, P,
                                                N, chunk);
  return (int)cudaGetLastError();
}

// x (BH, S, P), dt and dA (BH, S), Bm and Cm (BH, S, N), all fp32
// contiguous; y (BH, S, P) fp32; `pe` head-dim columns per CTA (16, 32,
// 48 or 64).
REPRO_EXPORT int ssd_chunked_f32(const float* x, const float* dt,
                                 const float* dA, const float* Bm,
                                 const float* Cm, float* y, int BH, int S,
                                 int P, int N, int chunk, int pe,
                                 void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (pe) {
    case 16: return ssd_launch<1>(x, dt, dA, Bm, Cm, y, BH, S, P, N, chunk, s);
    case 32: return ssd_launch<2>(x, dt, dA, Bm, Cm, y, BH, S, P, N, chunk, s);
    case 48: return ssd_launch<3>(x, dt, dA, Bm, Cm, y, BH, S, P, N, chunk, s);
    case 64: return ssd_launch<4>(x, dt, dA, Bm, Cm, y, BH, S, P, N, chunk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
