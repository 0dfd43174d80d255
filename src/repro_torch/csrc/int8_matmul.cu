// int8_matmul: W8A8 GEMM, int32 sums, epilogue (acc * xs[row]) * ws[col].
//
// Replaces the TPU kernel repro/kernels/int8_matmul/kernel.py::int8_matmul,
// whose grid carries an int32 accumulator in VMEM scratch across K steps
// that run in order.  Here each CTA owns a 64 x 64 output tile and loops
// over K itself, so no state crosses CTAs.
//
// Bound on the H100 at the MSA projections of B1@224 (K = 128..512):
// bytes at batch 1, where the int8 operands and the fp32 output are a few
// hundred KB against ~10^8 int8 operations; at 1,979 int8 TOPS the
// operations would take a few tenths of a microsecond.  This kernel does
// not reach the tensor cores: __dp4a on CUDA cores, 16 dp4a per thread per
// 4-deep k step, operands staged through shared memory in 32-deep k
// chunks.  The epilogue keeps the TPU kernel's order (acc * xs) * ws, with
// rounded intrinsics, so it equals its plain PyTorch version bit for bit.
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
