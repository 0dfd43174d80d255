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
// floats (16 d bytes) and does ~4 d^2 flops (ReLU(K)^T V and ReLU(Q) kv):
// ~4 flops/byte at d = 16, below the card's ~20 fp32 flops/byte ridge.
//
// Design: one CTA per row runs both phases, with a __syncthreads()
// between them in place of the TPU grid's sequential phase axis.  Phase 0
// streams tiles of block_n tokens of ReLU(K) and V through shared memory;
// each thread owns entries of the d x d + d state, kept in shared memory.
// Phase 1 reads Q once against that state.  Q/K/V are read from device
// memory once and the output written once.  The ragged token tail is
// masked, not padded.  Q, K and V arrive as strided views of the stacked
// QKV tensor (the q/k/v split of the JAX wrapper), so the wrapper copies
// nothing; the output is written contiguous (G, N, heads, d).
#include "common.cuh"

__global__ void relu_attn_kernel(const float* __restrict__ q,
                                 const float* __restrict__ k,
                                 const float* __restrict__ v,
                                 float* __restrict__ out, int N, int heads,
                                 int D, long long sg, long long sn,
                                 long long sh, int block_n, float eps) {
  extern __shared__ float smem[];
  const int S = D * D + D;
  float* state = smem;                // [D][D] kv, then [D] ksum
  float* ksum = state + D * D;
  float* kt = state + S;              // [block_n][D] ReLU(K) tile
  float* vt = kt + block_n * D;       // [block_n][D] V tile

  const int g = blockIdx.x / heads, h = blockIdx.x % heads;
  const size_t base = (size_t)g * sg + (size_t)h * sh;

  for (int i = threadIdx.x; i < S; i += blockDim.x) state[i] = 0.0f;

  // Phase 0: the state accumulates over token tiles.
  for (int n0 = 0; n0 < N; n0 += block_n) {
    const int nt = min(block_n, N - n0);
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < nt * D; i += blockDim.x) {
      const size_t off = base + (size_t)(n0 + i / D) * sn + i % D;
      kt[i] = fmaxf(k[off], 0.0f);
      vt[i] = v[off];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < S; i += blockDim.x) {
      float a = 0.0f;
      if (i < D * D) {
        const int d = i / D, e = i % D;
        for (int n = 0; n < nt; ++n) a += kt[n * D + d] * vt[n * D + e];
      } else {
        const int d = i - D * D;
        for (int n = 0; n < nt; ++n) a += kt[n * D + d];
      }
      state[i] += a;
    }
  }
  __syncthreads();

  // Phase 1: every token's output from ReLU(Q) and the state.
  float* ob = out + ((size_t)g * N * heads + h) * D;
  for (int i = threadIdx.x; i < N * D; i += blockDim.x) {
    const int n = i / D, e = i % D;
    const float* qr = q + base + (size_t)n * sn;
    float num = 0.0f, den = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float pq = fmaxf(qr[d], 0.0f);
      num += pq * state[d * D + e];
      den += pq * ksum[d];
    }
    ob[(size_t)n * heads * D + e] = num / fmaxf(den, eps);
  }
}

// Shared-memory bytes of one CTA; python mirror: kernels/relu_attn/kernel.py.
static size_t relu_attn_smem_bytes(int D, int block_n) {
  return sizeof(float) * ((size_t)D * D + D + 2 * (size_t)block_n * D);
}

REPRO_EXPORT int relu_attn_noncausal_f32(const float* q, const float* k,
                                         const float* v, float* out, int G,
                                         int N, int heads, int D,
                                         long long sg, long long sn,
                                         long long sh, int block_n,
                                         float eps, void* stream) {
  const size_t smem = relu_attn_smem_bytes(D, block_n);
  static size_t granted = 48 * 1024;
  cudaError_t err = allow_smem(relu_attn_kernel, smem, &granted);
  if (err != cudaSuccess) return (int)err;
  relu_attn_kernel<<<G * heads, 256, smem, (cudaStream_t)stream>>>(
      q, k, v, out, N, heads, D, sg, sn, sh, block_n, eps);
  return (int)cudaGetLastError();
}
