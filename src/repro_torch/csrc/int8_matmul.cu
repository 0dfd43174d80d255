// int8_matmul: W8A8 GEMM, int32 sums, epilogue (acc * xs[row]) * ws[col];
// int8_matmul_emit: the same GEMM + bias, then an act-quant of each group
// of `rows` consecutive rows (one image's H*W pixels of a 1x1 conv).
//
// Replace the TPU kernels repro/kernels/int8_matmul/kernel.py::int8_matmul
// and ::int8_matmul_emit, whose grids carry an int32 accumulator in VMEM
// scratch across K steps that run in order.  Here each CTA owns a 64 x 64
// output tile and loops over K itself, so no state crosses CTAs.  The
// emitting TPU kernel holds a whole row group with the full N extent in
// one grid step, so its absmax is local; here a group's rows spread over
// CTAs (196 rows per image at S3 of B1@224, 49 at S4, against 64-row
// tiles), so the group's absmax is a cross-CTA reduction: each row's max
// over the tile's columns goes into its own group's word with atomicMax
// (exact, independent of CTA order), and a second pass quantizes.
//
// Bound on the H100 at the MSA projections of B1@224 (K = 128..512):
// bytes at batch 1, where the int8 operands and the fp32 output are a few
// hundred KB against ~10^8 int8 operations; at 1,979 int8 TOPS the
// operations would take a few tenths of a microsecond.  This kernel does
// not reach the tensor cores: __dp4a on CUDA cores, 16 dp4a per thread per
// 4-deep k step, operands staged through shared memory in 32-deep k
// chunks.  The epilogue keeps the TPU kernel's order (acc * xs) * ws (+ b),
// with rounded intrinsics, so it equals its plain PyTorch version bit for
// bit.  The emitting variant writes the fp32 output (the kept map, or
// scratch) and reads it back once in its quantize pass.
#include "int8.cuh"

__global__ void __launch_bounds__(GEMM_THREADS)
    int8_matmul_kernel(const int8_t* __restrict__ x,
                       const int8_t* __restrict__ w,
                       const float* __restrict__ xs,
                       const float* __restrict__ ws, float* __restrict__ out,
                       int M, int N, int K) {
  gemm_tile_i8(
      M, N, 0, K, [&](int r, int k) { return x[(size_t)r * K + k]; },
      [&](int k, int n) { return w[(size_t)k * N + n]; },
      [&](int r, int n, int acc) {
        const float o = __fmul_rn(__fmul_rn(__int2float_rn(acc), xs[r]),
                                  ws[n]);
        out[(size_t)r * N + n] = o;
        return 0.0f;
      });
}

REPRO_EXPORT int int8_matmul_i8(const int8_t* x, const int8_t* w,
                                const float* xs, const float* ws, float* out,
                                int M, int N, int K, void* stream) {
  int8_matmul_kernel<<<gemm_grid(M, N, 1), GEMM_THREADS, 0,
                       (cudaStream_t)stream>>>(x, w, xs, ws, out, M, N, K);
  return (int)cudaGetLastError();
}

// Pass 1 of int8_matmul_emit: o = ((acc * xs[g]) * ws[n]) + b[n] for the
// row's group g = r / rows; o is written, and each row's absmax over the
// tile's columns is folded into amax[g].
__global__ void __launch_bounds__(GEMM_THREADS)
    int8_matmul_emit_kernel(const int8_t* __restrict__ x,
                            const int8_t* __restrict__ w,
                            const float* __restrict__ xs,
                            const float* __restrict__ ws,
                            const float* __restrict__ bias,
                            float* __restrict__ out,
                            unsigned int* __restrict__ amax, int M, int N,
                            int K, int rows) {
  int acc[4][4];
  gemm_acc_i8(
      M, N, 0, K, [&](int r, int k) { return x[(size_t)r * K + k]; },
      [&](int k, int n) { return w[(size_t)k * N + n]; }, acc);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int m0 = blockIdx.x * GM, n0 = blockIdx.y * GN;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + 16 * i;
    float rmax = 0.0f;
    if (r < M) {
      const float xsg = xs[r / rows];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx + 16 * j;
        if (n < N) {
          const float o = __fadd_rn(
              __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]), xsg), ws[n]),
              bias[n]);
          out[(size_t)r * N + n] = o;
          rmax = fmaxf(rmax, fabsf(o));
        }
      }
    }
    // the 16 threads of one row are 16 consecutive lanes of a warp
    for (int o = 8; o > 0; o >>= 1)
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, o));
    if (tx == 0 && r < M) atomicMax(amax + r / rows, __float_as_uint(rmax));
  }
}

// x (M, K) int8, w (K, N) int8, xs (M / rows,) per-group activation
// scales, ws (N,), bias (N,); out (M, N) fp32 (the kept map or scratch),
// amax (M / rows) words zeroed here, q (M, N) int8, scales (M / rows,).
REPRO_EXPORT int int8_matmul_emit_i8(const int8_t* x, const int8_t* w,
                                     const float* xs, const float* ws,
                                     const float* bias, float* out,
                                     unsigned int* amax, int8_t* q,
                                     float* scales, int M, int N, int K,
                                     int rows, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int G = M / rows;
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(unsigned int) * G, s);
  if (err != cudaSuccess) return (int)err;
  int8_matmul_emit_kernel<<<gemm_grid(M, N, 1), GEMM_THREADS, 0, s>>>(
      x, w, xs, ws, bias, out, amax, M, N, K, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)i8_emit_pass(out, amax, q, scales, G, (long long)rows * N, s);
}
