// relu_attn_causal: chunked causal ReLU linear attention, fp32 or bf16 in,
// fp32 out.
//
// Replaces the TPU kernel repro/kernels/relu_attn/kernel.py::
// relu_attn_causal, whose grid (row, chunk) runs the chunks of a row in
// order and carries the d x d prefix state and the d normalizer in VMEM
// scratch.  Per chunk of C tokens (N zero-padded to whole chunks):
//     S    = tril(ReLU(Q) ReLU(K)^T)                    (C x C)
//     num  = S V + ReLU(Q) state,  den = rowsum(S) + ReLU(Q) . zsum
//     out  = num / max(den, eps)
//     state += ReLU(K)^T V,        zsum += sum_n ReLU(K)
//
// Bound on the H100: operations.  Per chunk the products are 4 C^2 d +
// 4 C d^2 flops against 16 C d bytes: at C = 256 and d = 64 ~80
// flops/byte, above the card's ~20 fp32 flops/byte ridge (the fp32 CUDA
// cores: the products need full fp32, so no TF32 tensor cores).
//
// Design: the chunk-parallel scan of chunk_scan.cuh, three launches.
//   states   (row, chunk, 64 state rows): dS_c = ReLU(K_c)^T V_c and
//            dz_c = sum ReLU(K_c), the chunk's tokens staged 64 at a time;
//            workspace slot c holds dS_c (d x d) then dz_c (d).
//   prefix   S_c = sum_{c' < c} dS_c', z_c likewise, in place.
//   outputs  (row, chunk, 64-query tile): ReLU(Q) S_c (the state streamed
//            through shared memory 64 rows at a time) and ReLU(Q) . z_c,
//            then per key tile at or before the query tile the 64 x 64
//            scores (masked on the diagonal tile) and scores . [V | 1],
//            all d output columns of the tile in one CTA (64 G columns a
//            thread row, G = ceil(d / 64)), so each score tile is
//            computed once.  The grid's fastest index is the query tile:
//            a chunk's tiles read S_c together, from L2.
// Ragged N: tokens past N load as zeros and are not written, which is
// the TPU kernel's zero padding (padded tokens follow every real one).
// Sums run in another order than the plain version's, so the two agree
// to fp32 rounding, not bit for bit; each call gives the same bits.
#include "chunk_scan.cuh"

using namespace cscan;

// Floats of one workspace slot: the d x d state, then the normalizer.
__host__ __device__ inline size_t slot_floats(int D) {
  return (size_t)D * D + D;
}

template <typename T, int G>
__global__ void __launch_bounds__(NT, G <= 2 ? 2 : 1)
    causal_states(const T* __restrict__ k, const T* __restrict__ v,
                  float* __restrict__ ws, int N, int D, int chunk, int nr,
                  int nc) {
  extern __shared__ float4 smem4[];
  float* as = reinterpret_cast<float*>(smem4);   // [TILE][TILE] ReLU(K)
  float* bs = as + TILE * TILE;                  // [TILE][64 G] V
  constexpr int VP = 64 * G;
  int t = blockIdx.x;
  const int rt = t % nr;
  t /= nr;
  const int c = t % (nc - 1), row = t / (nc - 1);
  const int c0 = c * chunk, r0 = rt * TILE;
  const size_t base = (size_t)row * N * D;
  float acc[4][G][4] = {}, za[4] = {};
  for (int m0 = 0; m0 < chunk; m0 += TILE) {
    const int mn = min(TILE, chunk - m0);
    __syncthreads();   // the previous tokens are read
    const size_t at = base + (size_t)(c0 + m0) * D;
    const bool ka = stage_start<true>(as, TILE, k + at, mn, D, r0, TILE,
                                      nullptr);
    stage_start<false>(bs, VP, v + at, mn, D, 0, VP, nullptr);
    cp_async_commit();
    cp_async_wait<0>();
    if (ka) stage_finish<true>(as, TILE, mn, TILE, nullptr);
    __syncthreads();
    outer_acc<G, true>(acc, za, as, bs, VP, mn);
  }
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float* W = ws + ((size_t)row * nc + c) * slot_floats(D);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int d = r0 + 4 * ty + u;
    if (d >= D) continue;
#pragma unroll
    for (int g = 0; g < G; ++g) store4(W + (size_t)d * D, 4 * tx + 64 * g, D,
                                       acc[u][g]);
    if (tx == 0) W[(size_t)D * D + d] = za[u];
  }
}

template <typename T, int G>
__global__ void __launch_bounds__(NT, G == 1 ? 2 : 1)
    causal_out(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ ws,
               float* __restrict__ out, int N, int D, int chunk, int nq,
               int nc, float eps) {
  extern __shared__ float4 smem4[];
  constexpr int VP = 64 * G;
  const int ap = apitch(D), dp = pad4(D);
  float* qs = reinterpret_cast<float*>(smem4);   // [TILE][ap] ReLU(Q)
  float* ks = qs + TILE * ap;                    // [TILE][ap] ReLU(K)
  float* vs = ks + TILE * ap;                    // [TILE][VP] V or state
  float* ss = vs + TILE * VP;                    // [TILE][SP] scores
  float* zs = ss + TILE * SP;                    // [dp] normalizer
  int t = blockIdx.x;
  const int qi = t % nq;
  t /= nq;
  const int c = t % nc, row = t / nc;
  const int c0 = c * chunk, cn = min(chunk, N - c0), q0 = qi * TILE;
  if (q0 >= cn) return;
  const int qn = min(TILE, cn - q0);
  const size_t base = (size_t)row * N * D;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  // Q, then the first key tile's K, in flight at once
  const bool qa = stage_start<true>(qs, ap, q + base + (size_t)(c0 + q0) * D,
                                    qn, D, 0, dp, nullptr);
  cp_async_commit();
  bool ka = stage_start<true>(ks, ap, k + base + (size_t)c0 * D,
                              min(TILE, cn), D, 0, dp, nullptr);
  cp_async_commit();
  cp_async_wait<1>();   // Q
  if (qa) stage_finish<true>(qs, ap, qn, dp, nullptr);
  float acc[4][G][4] = {}, den[4] = {};
  if (c > 0) {   // the state term: ReLU(Q) S_c and ReLU(Q) . z_c
    const float* S = ws + ((size_t)row * nc + c) * slot_floats(D);
    for (int i = threadIdx.x; i < dp; i += NT)
      zs[i] = i < D ? S[(size_t)D * D + i] : 0.0f;
    for (int d0 = 0; d0 < dp; d0 += TILE) {
      __syncthreads();   // the previous state rows are read
      stage_start<false>(vs, VP, S + (size_t)d0 * D, min(TILE, D - d0), D,
                         0, VP, nullptr);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      mul_acc<G, DEN_VEC>(acc, den, qs + d0, ap, vs, VP, min(TILE, dp - d0),
                          zs + d0);
    }
  }
  // Per key tile: V's copies run under the scores, the next K's under
  // scores . V.
  for (int ki = 0; ki <= qi; ++ki) {
    const int k0 = ki * TILE, kn = min(TILE, cn - k0);
    __syncthreads();   // scores . V (or the state term) is done with vs
    stage_start<false>(vs, VP, v + base + (size_t)(c0 + k0) * D, kn, D, 0,
                       VP, nullptr);
    cp_async_commit();
    cp_async_wait<1>();   // this key tile's K
    if (ka) stage_finish<true>(ks, ap, kn, dp, nullptr);
    __syncthreads();
    const bool diag = ki == qi;
    float s[4][4];
    score_tile(s, qs, ks, ap, dp, diag_blocks(diag));
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 4 * ty + i, m = tx + 16 * j;
        ss[r * SP + m] = (diag && m > r) ? 0.0f : s[i][j];
      }
    cp_async_wait<0>();   // V
    __syncthreads();   // the scores and V are in; ks is read
    if (ki < qi) {
      const int k1 = k0 + TILE;
      ka = stage_start<true>(ks, ap, k + base + (size_t)(c0 + k1) * D,
                             min(TILE, cn - k1), D, 0, dp, nullptr);
    }
    cp_async_commit();
    mul_acc<G, DEN_ONES>(acc, den, ss, SP, vs, VP, diag_keys(diag, kn),
                         nullptr);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= qn) continue;
    const float dd = fmaxf(den[i], eps);
    float* orow = out + base + (size_t)(c0 + q0 + r) * D;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float o[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) o[u] = acc[i][g][u] / dd;
      store4(orow, 4 * tx + 64 * g, D, o);
    }
  }
}

// Shared-memory bytes of one CTA of each launch; python mirror:
// kernels/relu_attn/kernel.py::relu_attn_causal_smem_bytes.
static size_t causal_states_smem(int G) {
  return sizeof(float) * ((size_t)TILE * TILE + (size_t)TILE * 64 * G);
}
static size_t causal_out_smem(int D, int G) {
  return sizeof(float) * (2 * (size_t)TILE * apitch(D) +
                          (size_t)TILE * 64 * G + (size_t)TILE * SP +
                          pad4(D));
}

template <typename T, int G>
static int causal_launch(const T* q, const T* k, const T* v, float* out,
                         float* ws, int BH, int N, int D, int chunk,
                         float eps, cudaStream_t s) {
  static size_t granted_states = 48 * 1024, granted_out = 48 * 1024;
  const int nc = (N + chunk - 1) / chunk, nr = (D + TILE - 1) / TILE;
  const int nq = (chunk + TILE - 1) / TILE;
  cudaError_t err;
  const bool run_states = nc > 1;
  if (run_states) {
    const size_t smem = causal_states_smem(G);
    err = allow_smem(causal_states<T, G>, smem, &granted_states);
    if (err != cudaSuccess) return (int)err;
    causal_states<T, G><<<(unsigned)BH * (nc - 1) * nr, NT, smem, s>>>(
        k, v, ws, N, D, chunk, nr, nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const bool run_prefix = nc > 1;
  if (run_prefix) {
    const int st = prefix_launch<false>(ws, nullptr, BH, nc,
                                        (long long)slot_floats(D), s);
    if (st) return st;
  }
  const bool run_out = true;
  if (run_out) {
    const size_t smem = causal_out_smem(D, G);
    err = allow_smem(causal_out<T, G>, smem, &granted_out);
    if (err != cudaSuccess) return (int)err;
    causal_out<T, G><<<(unsigned)BH * nc * nq, NT, smem, s>>>(
        q, k, v, ws, out, N, D, chunk, nq, nc, eps);
  }
  return (int)cudaGetLastError();
}

template <typename T>
static int causal_dispatch(const T* q, const T* k, const T* v, float* out,
                           float* ws, int BH, int N, int D, int chunk,
                           float eps, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch ((D + 63) / 64) {
    case 1: return causal_launch<T, 1>(q, k, v, out, ws, BH, N, D, chunk, eps, s);
    case 2: return causal_launch<T, 2>(q, k, v, out, ws, BH, N, D, chunk, eps, s);
    case 3: return causal_launch<T, 3>(q, k, v, out, ws, BH, N, D, chunk, eps, s);
    case 4: return causal_launch<T, 4>(q, k, v, out, ws, BH, N, D, chunk, eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// causal_states_smem (out == 0) or causal_out_smem (out != 0) at head
// dim D, for the python mirror's test.
REPRO_EXPORT long long relu_attn_causal_smem_c(int D, int out) {
  const int G = (D + 63) / 64;
  return (long long)(out ? causal_out_smem(D, G) : causal_states_smem(G));
}

// q, k, v: (BH, N, D) contiguous, D <= 256; out (BH, N, D) fp32; ws the
// workspace, BH * ceil(N / chunk) * (D * D + D) floats (unused, and may
// be null, for a single chunk).
REPRO_EXPORT int relu_attn_causal_f32(const float* q, const float* k,
                                      const float* v, float* out, float* ws,
                                      int BH, int N, int D, int chunk,
                                      float eps, void* stream) {
  return causal_dispatch(q, k, v, out, ws, BH, N, D, chunk, eps, stream);
}

REPRO_EXPORT int relu_attn_causal_bf16(const __nv_bfloat16* q,
                                       const __nv_bfloat16* k,
                                       const __nv_bfloat16* v, float* out,
                                       float* ws, int BH, int N, int D,
                                       int chunk, float eps, void* stream) {
  return causal_dispatch(q, k, v, out, ws, BH, N, D, chunk, eps, stream);
}
