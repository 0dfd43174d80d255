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
// Bound on the H100: operations.  Per chunk the TPU kernel's products are
// 4 C^2 d + 4 C d^2 flops against 16 C d bytes: at C = 256 and d = 64
// ~80 flops/byte, above the card's ~20 fp32 flops/byte ridge (the fp32
// CUDA cores: the products need full fp32, so no TF32 tensor cores).
//
// Design.  A Hopper CTA has 227 KB of shared memory; the chunk's 256 x 256
// score tile alone is 256 KB, and at d = 240 (Gemma3-12B's global layer)
// the d x d state is 230 KB.  So:
//   - one CTA per (row, slice of DE value columns): each output column
//     needs only its own state column, plus the normalizer ReLU(Q) . zsum,
//     which every CTA computes in full.  The split also fills the card
//     at batch 1 (16-32 rows against 132 SMs); the wrapper picks DE.
//   - the CTA runs its row's chunks in order (no state crosses CTAs), and
//     inside a chunk walks 64-token query tiles; for each it adds the
//     state term, then the 64 x 64 score tiles of the key tiles at or
//     before it (the mask applies on the diagonal tile only).  The last
//     query tile of a chunk also folds each key tile into the state, after
//     every query tile has read the state at the chunk's start.
//   - ragged N: tokens past N load as zeros and are not written, which is
//     the TPU kernel's zero padding (padded tokens follow every real one).
// Each thread owns 4 query rows x NJ columns (rows ty + 16 i, columns
// tx + 16 j); tiles are padded to an odd pitch so the 16 rows a warp reads
// at one depth fall in distinct banks.  Sums run in another order than
// the plain version's, so the two agree to fp32 rounding, not bit for bit.
#include <cuda_bf16.h>

#include "common.cuh"

constexpr int CT = 64;            // token tile: query rows and key rows
constexpr int CT_THREADS = 256;   // 16 x 16

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int NJ>
__global__ void __launch_bounds__(CT_THREADS)
    relu_attn_causal_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, float* __restrict__ out,
                            int N, int D, int chunk, float eps) {
  constexpr int DE = 16 * NJ;
  extern __shared__ float smem[];
  const int DP = D + 1;
  float* st = smem;               // [D][DE] state slice, ReLU(K)^T V
  float* zs = st + D * DE;        // [D] normalizer, sum of ReLU(K)
  float* qs = zs + D;             // [CT][DP] ReLU(Q) tile
  float* ks = qs + CT * DP;       // [CT][DP] ReLU(K) tile
  float* vs = ks + CT * DP;       // [CT][DE] V tile, this CTA's columns
  float* ss = vs + CT * DE;       // [CT][CT + 1] masked scores
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int e0 = blockIdx.y * DE, de = min(DE, D - e0);
  const size_t base = (size_t)blockIdx.x * N * D;

  for (int i = tid; i < D * DE + D; i += CT_THREADS) st[i] = 0.0f;
  for (int c0 = 0; c0 < N; c0 += chunk) {
    const int cn = min(chunk, N - c0), nt = (cn + CT - 1) / CT;
    for (int qi = 0; qi < nt; ++qi) {
      const int q0 = c0 + qi * CT, qn = min(CT, cn - qi * CT);
      __syncthreads();   // the state is final; the previous tiles are read
      for (int i = tid; i < CT * D; i += CT_THREADS) {
        const int r = i / D, d = i % D;
        qs[r * DP + d] =
            r < qn ? fmaxf(to_f32(q[base + (size_t)(q0 + r) * D + d]), 0.0f)
                   : 0.0f;
      }
      __syncthreads();
      // the state term: ReLU(Q) against the state at the chunk's start
      float acc[4][NJ], den[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        den[i] = 0.0f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
      }
      for (int d = 0; d < D; ++d) {
        const float z = zs[d];
        float sv[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) sv[j] = st[d * DE + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = qs[(ty + 16 * i) * DP + d];
          den[i] += a * z;
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] += a * sv[j];
        }
      }
      const bool last = qi == nt - 1;
      for (int ki = 0; ki <= qi; ++ki) {
        const int k0 = c0 + ki * CT, kn = min(CT, cn - ki * CT);
        __syncthreads();   // the state term and the previous key tile read
        for (int i = tid; i < CT * D; i += CT_THREADS) {
          const int r = i / D, d = i % D;
          ks[r * DP + d] =
              r < kn
                  ? fmaxf(to_f32(k[base + (size_t)(k0 + r) * D + d]), 0.0f)
                  : 0.0f;
        }
        for (int i = tid; i < CT * DE; i += CT_THREADS) {
          const int r = i / DE, c = i % DE;
          vs[i] = (r < kn && c < de)
                      ? to_f32(v[base + (size_t)(k0 + r) * D + e0 + c])
                      : 0.0f;
        }
        __syncthreads();
        {
          float s[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
          for (int d = 0; d < D; ++d) {
            float a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * DP + d];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = ks[(tx + 16 * j) * DP + d];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) s[i][j] += a[i] * b[j];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int r = ty + 16 * i, c = tx + 16 * j;
              ss[r * (CT + 1) + c] = (ki == qi && c > r) ? 0.0f : s[i][j];
            }
        }
        __syncthreads();
        for (int c = 0; c < kn; ++c) {
          float vv[NJ];
#pragma unroll
          for (int j = 0; j < NJ; ++j) vv[j] = vs[c * DE + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float sv = ss[(ty + 16 * i) * (CT + 1) + c];
            den[i] += sv;
#pragma unroll
            for (int j = 0; j < NJ; ++j) acc[i][j] += sv * vv[j];
          }
        }
        if (last) {   // fold this key tile into the state
          for (int i = tid; i < D * DE; i += CT_THREADS) {
            const int d = i / DE, c = i % DE;
            float a = 0.0f;
            for (int n = 0; n < kn; ++n) a += ks[n * DP + d] * vs[n * DE + c];
            st[i] += a;
          }
          for (int d = tid; d < D; d += CT_THREADS) {
            float a = 0.0f;
            for (int n = 0; n < kn; ++n) a += ks[n * DP + d];
            zs[d] += a;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        if (r >= qn) continue;
        const float dd = fmaxf(den[i], eps);
        float* orow = out + base + (size_t)(q0 + r) * D + e0;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int c = tx + 16 * j;
          if (c < de) orow[c] = acc[i][j] / dd;
        }
      }
    }
  }
}

// Shared-memory bytes of one CTA; python mirror:
// kernels/relu_attn/kernel.py::relu_attn_causal_smem_bytes.
static size_t causal_smem_bytes(int D, int DE) {
  return sizeof(float) * ((size_t)D * DE + D + 2 * (size_t)CT * (D + 1) +
                          (size_t)CT * DE + (size_t)CT * (CT + 1));
}

template <typename T, int NJ>
static int causal_launch(const T* q, const T* k, const T* v, float* out,
                         int BH, int N, int D, int chunk, float eps,
                         cudaStream_t s) {
  const size_t smem = causal_smem_bytes(D, 16 * NJ);
  static size_t granted = 48 * 1024;
  cudaError_t err = allow_smem(relu_attn_causal_kernel<T, NJ>, smem, &granted);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(BH, (D + 16 * NJ - 1) / (16 * NJ));
  relu_attn_causal_kernel<T, NJ><<<grid, CT_THREADS, smem, s>>>(
      q, k, v, out, N, D, chunk, eps);
  return (int)cudaGetLastError();
}

template <typename T>
static int causal_dispatch(const T* q, const T* k, const T* v, float* out,
                           int BH, int N, int D, int chunk, int de, float eps,
                           void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (de) {
    case 16: return causal_launch<T, 1>(q, k, v, out, BH, N, D, chunk, eps, s);
    case 32: return causal_launch<T, 2>(q, k, v, out, BH, N, D, chunk, eps, s);
    case 48: return causal_launch<T, 3>(q, k, v, out, BH, N, D, chunk, eps, s);
    case 64: return causal_launch<T, 4>(q, k, v, out, BH, N, D, chunk, eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// q, k, v: (BH, N, D) contiguous; out (BH, N, D) fp32; `de` value columns
// per CTA (16, 32, 48 or 64).
REPRO_EXPORT int relu_attn_causal_f32(const float* q, const float* k,
                                      const float* v, float* out, int BH,
                                      int N, int D, int chunk, int de,
                                      float eps, void* stream) {
  return causal_dispatch(q, k, v, out, BH, N, D, chunk, de, eps, stream);
}

REPRO_EXPORT int relu_attn_causal_bf16(const __nv_bfloat16* q,
                                       const __nv_bfloat16* k,
                                       const __nv_bfloat16* v, float* out,
                                       int BH, int N, int D, int chunk,
                                       int de, float eps, void* stream) {
  return causal_dispatch(q, k, v, out, BH, N, D, chunk, de, eps, stream);
}
