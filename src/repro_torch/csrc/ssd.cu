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
// Design: the chunk-parallel scan of chunk_scan.cuh (as
// csrc/relu_attn_causal.cu, plus the decay), three launches.
//   states   (row, chunk, 64 state rows): dS_c = (Bm_c w)^T x_c with w =
//            exp(cum_last - cum) dt, and the chunk's total decay
//            exp(cum_last), into workspace slot c and decay[row, c].
//   prefix   S_0 = 0, S_{c+1} = exp(cum_last,c) S_c + dS_c, in place.
//   outputs  (row, chunk, 64-query tile): exp(cum_l) (Cm_l . S_c) (the
//            state streamed through shared memory 64 rows at a time),
//            then per key tile at or before the query tile the 64 x 64
//            scores Cm Bm^T times L, and scores . (x dt), all P columns
//            in one CTA, so each score tile is computed once.
//   The in-chunk cumsum runs in one warp, the same code in launches 1 and
//   3 (the same bits): each lane sums a contiguous segment in order, then
//   the lanes' totals are scanned with shuffles.
// A ragged S: tokens past S load as dt = dA = x = B = C = 0, so they add
// nothing to any output, and are not written.  (The TPU kernel takes the
// whole sequence as one chunk when S is not a multiple of the chunk,
// which no CTA could hold at 32k tokens.)
// The sums, the cumsum and the exps run in another order than the plain
// version's, so the two agree to fp32 rounding, not bit for bit; each call
// gives the same bits.
#include "chunk_scan.cuh"

using namespace cscan;

// cum[i] = sum_{t <= i} da[t] for i < chunk (da past cn read as 0), by
// warp 0; the caller synchronizes before reading it.
__device__ __forceinline__ void chunk_cumsum(float* cum, const float* da,
                                             int cn, int chunk) {
  const int lane = threadIdx.x;
  if (lane >= 32) return;
  const int per = (chunk + 31) / 32, lo = min(lane * per, chunk),
            hi = min(lo + per, chunk);
  float run = 0.0f;
  for (int i0 = lo; i0 < hi; i0 += 8) {   // eight loads in flight
    float t[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      t[u] = i0 + u < hi && i0 + u < cn ? da[i0 + u] : 0.0f;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (i0 + u >= hi) break;
      run += t[u];
      cum[i0 + u] = run;
    }
  }
  float incl = run;
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  const float off = incl - run;
  for (int i = lo; i < hi; ++i) cum[i] += off;
}

template <int G>
__global__ void __launch_bounds__(NT, 2)
    ssd_states(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ dA, const float* __restrict__ Bm,
               float* __restrict__ ws, float* __restrict__ decay, int S,
               int P, int N, int chunk, int nr, int nc) {
  extern __shared__ float4 smem4[];
  constexpr int VP = 64 * G;
  const int ch4 = pad4(chunk);
  float* cum = reinterpret_cast<float*>(smem4);   // [chunk] cumsum of dA
  float* w = cum + ch4;                           // [chunk] decay to end * dt
  float* as = w + ch4;                            // [TILE][TILE] Bm w
  float* bs = as + TILE * TILE;                   // [TILE][VP] x
  int t = blockIdx.x;
  const int rt = t % nr;
  t /= nr;
  const int c = t % (nc - 1), row = t / (nc - 1);
  const int c0 = c * chunk, r0 = rt * TILE;
  chunk_cumsum(cum, dA + (size_t)row * S + c0, chunk, chunk);
  __syncthreads();
  const float cl = cum[chunk - 1];
  for (int i = threadIdx.x; i < chunk; i += NT)
    w[i] = expf(cl - cum[i]) * dt[(size_t)row * S + c0 + i];
  if (rt == 0 && threadIdx.x == 0) decay[(size_t)row * nc + c] = expf(cl);
  float acc[4][G][4] = {}, za[4] = {};
  for (int m0 = 0; m0 < chunk; m0 += TILE) {
    const int mn = min(TILE, chunk - m0);
    __syncthreads();   // w is written; the previous tokens are read
    const size_t at = (size_t)row * S + c0 + m0;
    const bool ba = stage_start<false>(as, TILE, Bm + at * N, mn, N, r0,
                                       TILE, w + m0);
    stage_start<false>(bs, VP, x + at * P, mn, P, 0, VP, nullptr);
    cp_async_commit();
    cp_async_wait<0>();
    if (ba) stage_finish<false>(as, TILE, mn, TILE, w + m0);
    __syncthreads();
    outer_acc<G, false>(acc, za, as, bs, VP, mn);
  }
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float* W = ws + ((size_t)row * nc + c) * N * P;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int n = r0 + 4 * ty + u;
    if (n >= N) continue;
#pragma unroll
    for (int g = 0; g < G; ++g) store4(W + (size_t)n * P, 4 * tx + 64 * g, P,
                                       acc[u][g]);
  }
}

template <int G>
__global__ void __launch_bounds__(NT, G == 1 ? 2 : 1)
    ssd_out(const float* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ dA, const float* __restrict__ Bm,
            const float* __restrict__ Cm, const float* __restrict__ ws,
            float* __restrict__ y, int S, int P, int N, int chunk, int nq,
            int nc) {
  extern __shared__ float4 smem4[];
  constexpr int VP = 64 * G;
  const int ch4 = pad4(chunk), ap = apitch(N), np = pad4(N);
  float* cum = reinterpret_cast<float*>(smem4);   // [chunk] cumsum of dA
  float* dts = cum + ch4;                         // [chunk] dt
  float* cs = dts + ch4;                          // [TILE][ap] Cm
  float* bs = cs + TILE * ap;                     // [TILE][ap] Bm
  float* xs = bs + TILE * ap;                     // [TILE][VP] x dt, state
  float* ss = xs + TILE * VP;                     // [TILE][SP] scores
  int t = blockIdx.x;
  const int qi = t % nq;
  t /= nq;
  const int c = t % nc, row = t / nc;
  const int c0 = c * chunk, cn = min(chunk, S - c0), q0 = qi * TILE;
  if (q0 >= cn) return;
  const int qn = min(TILE, cn - q0);
  const size_t at0 = (size_t)row * S + c0;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  // Cm and the first key tile's Bm in flight while dt and the cumsum
  // are staged
  stage_start<false>(cs, ap, Cm + (at0 + q0) * N, qn, N, 0, np, nullptr);
  stage_start<false>(bs, ap, Bm + at0 * N, min(TILE, cn), N, 0, np, nullptr);
  cp_async_commit();
  chunk_cumsum(cum, dA + at0, cn, chunk);
  for (int i = threadIdx.x; i < chunk; i += NT)
    dts[i] = i < cn ? dt[at0 + i] : 0.0f;
  cp_async_wait<0>();
  __syncthreads();
  float acc[4][G][4] = {}, den[4] = {};
  if (c > 0) {   // the state term: exp(cum_l) (Cm_l . S_c)
    const float* St = ws + ((size_t)row * nc + c) * N * P;
    for (int n0 = 0; n0 < np; n0 += TILE) {
      __syncthreads();   // the previous state rows are read
      stage_start<false>(xs, VP, St + (size_t)n0 * P, min(TILE, N - n0), P,
                         0, VP, nullptr);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      mul_acc<G, NO_DEN>(acc, den, cs + n0, ap, xs, VP, min(TILE, np - n0),
                         nullptr);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = q0 + 4 * ty + i;
      const float e = l < cn ? expf(cum[l]) : 0.0f;
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[i][g][u] *= e;
    }
  }
  // Per key tile: x's copies run under the scores, the next Bm's under
  // scores . (x dt).
  for (int ki = 0; ki <= qi; ++ki) {
    const int k0 = ki * TILE, kn = min(TILE, cn - k0);
    __syncthreads();   // scores . x (or the state term) is done with xs
    const bool xa = stage_start<false>(xs, VP, x + (at0 + k0) * P, kn, P, 0,
                                       VP, dts + k0);
    cp_async_commit();
    cp_async_wait<1>();   // this key tile's Bm
    __syncthreads();
    const bool diag = ki == qi;
    float s[4][4];
    score_tile(s, cs, bs, ap, np, diag_blocks(diag));
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int l = q0 + 4 * ty + i, m = k0 + tx + 16 * j;
        const float L =
            (m <= l && l < cn) ? expf(fminf(cum[l] - cum[m], 0.0f)) : 0.0f;
        ss[(4 * ty + i) * SP + tx + 16 * j] = s[i][j] * L;
      }
    cp_async_wait<0>();   // x
    if (xa) stage_finish<false>(xs, VP, kn, VP, dts + k0);
    __syncthreads();   // the scores and x dt are in; bs is read
    if (ki < qi) {
      const int k1 = k0 + TILE;
      stage_start<false>(bs, ap, Bm + (at0 + k1) * N, min(TILE, cn - k1), N,
                         0, np, nullptr);
    }
    cp_async_commit();
    mul_acc<G, NO_DEN>(acc, den, ss, SP, xs, VP, diag_keys(diag, kn),
                       nullptr);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= qn) continue;
    float* yrow = y + (at0 + q0 + r) * P;
#pragma unroll
    for (int g = 0; g < G; ++g) store4(yrow, 4 * tx + 64 * g, P, acc[i][g]);
  }
}

// Shared-memory bytes of one CTA of each launch; python mirror:
// kernels/ssd/kernel.py::ssd_smem_bytes.
static size_t ssd_states_smem(int G, int chunk) {
  return sizeof(float) * (2 * (size_t)pad4(chunk) + (size_t)TILE * TILE +
                          (size_t)TILE * 64 * G);
}
static size_t ssd_out_smem(int N, int G, int chunk) {
  return sizeof(float) * (2 * (size_t)pad4(chunk) +
                          2 * (size_t)TILE * apitch(N) +
                          (size_t)TILE * 64 * G + (size_t)TILE * SP);
}

template <int G>
static int ssd_launch(const float* x, const float* dt, const float* dA,
                      const float* Bm, const float* Cm, float* y, float* ws,
                      int BH, int S, int P, int N, int chunk,
                      cudaStream_t s) {
  static size_t granted_states = 48 * 1024, granted_out = 48 * 1024;
  const int nc = (S + chunk - 1) / chunk, nr = (N + TILE - 1) / TILE;
  const int nq = (chunk + TILE - 1) / TILE;
  float* decay = ws + (size_t)BH * nc * N * P;
  cudaError_t err;
  const bool run_states = nc > 1;
  if (run_states) {
    const size_t smem = ssd_states_smem(G, chunk);
    err = allow_smem(ssd_states<G>, smem, &granted_states);
    if (err != cudaSuccess) return (int)err;
    ssd_states<G><<<(unsigned)BH * (nc - 1) * nr, NT, smem, s>>>(
        x, dt, dA, Bm, ws, decay, S, P, N, chunk, nr, nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const bool run_prefix = nc > 1;
  if (run_prefix) {
    const int st = prefix_launch<true>(ws, decay, BH, nc, (long long)N * P,
                                       s);
    if (st) return st;
  }
  const bool run_out = true;
  if (run_out) {
    const size_t smem = ssd_out_smem(N, G, chunk);
    err = allow_smem(ssd_out<G>, smem, &granted_out);
    if (err != cudaSuccess) return (int)err;
    ssd_out<G><<<(unsigned)BH * nc * nq, NT, smem, s>>>(
        x, dt, dA, Bm, Cm, ws, y, S, P, N, chunk, nq, nc);
  }
  return (int)cudaGetLastError();
}

// ssd_states_smem (out == 0) or ssd_out_smem (out != 0), for the python
// mirror's test.
REPRO_EXPORT long long ssd_smem_c(int N, int P, int chunk, int out) {
  const int G = (P + 63) / 64;
  return (long long)(out ? ssd_out_smem(N, G, chunk)
                         : ssd_states_smem(G, chunk));
}

// x (BH, S, P), dt and dA (BH, S), Bm and Cm (BH, S, N), all fp32
// contiguous, N and P <= 256; y (BH, S, P) fp32; ws the workspace,
// BH * nc * (N * P + 1) floats with nc = ceil(S / chunk): the states, then
// the chunks' decays (unused, and may be null, for a single chunk).
REPRO_EXPORT int ssd_chunked_f32(const float* x, const float* dt,
                                 const float* dA, const float* Bm,
                                 const float* Cm, float* y, float* ws, int BH,
                                 int S, int P, int N, int chunk,
                                 void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch ((P + 63) / 64) {
    case 1: return ssd_launch<1>(x, dt, dA, Bm, Cm, y, ws, BH, S, P, N, chunk, s);
    case 2: return ssd_launch<2>(x, dt, dA, Bm, Cm, y, ws, BH, S, P, N, chunk, s);
    case 3: return ssd_launch<3>(x, dt, dA, Bm, Cm, y, ws, BH, S, P, N, chunk, s);
    case 4: return ssd_launch<4>(x, dt, dA, Bm, Cm, y, ws, BH, S, P, N, chunk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
