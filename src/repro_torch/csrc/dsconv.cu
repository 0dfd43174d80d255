// dsconv_fused: depthwise 3x3 + bias -> Hardswish -> 1x1 GEMM + bias, NHWC
// fp32.
//
// Replaces the TPU kernel repro/kernels/dsconv/kernel.py::dsconv_fused
// (the Pallas grid (batch, c_out tiles) with the DW result in VMEM
// scratch, reused across c_out tiles through pl.when(j == 0)).
//
// Bound on the H100: memory.  At stem.ds0 (112x112x16 -> 16) the
// function does 2 * (9 + 16) = 50 flops per 4-byte output channel it
// writes and reads the same amount, ~6 flops/byte, far below the card's
// ~20 fp32 flops/byte ridge (67 TFLOP/s over 3.35 TB/s).
//
// Design: one CTA per (image, band of output rows).  The band's input
// rows plus a one-row halo are read from device memory once into shared
// memory (zero outside the image: the SAME padding), the DW result stays
// in shared memory, and the CTA loops over c_out tiles itself, staging
// each tile of the 1x1 weights in shared memory.  CTAs run in no order,
// so nothing carries over between them (the TPU kernel's pl.when(j == 0)
// scratch reuse has no counterpart).  Stride s samples the stride-1 DW
// map at offset s - 1, the anchor of the reference's SAME conv.  fp32 FMA
// on CUDA cores: TF32 tensor cores would break fp32 parity.
#include "common.cuh"

__global__ void dsconv_kernel(const float* __restrict__ x,
                              const float* __restrict__ dw_w,
                              const float* __restrict__ dw_b,
                              const float* __restrict__ pw_w,
                              const float* __restrict__ pw_b,
                              float* __restrict__ out, int H, int W, int C,
                              int F, int stride, int act, int rows,
                              int block_f) {
  extern __shared__ float smem[];
  const int Ho = H / stride, Wo = W / stride;
  const int T = (rows - 1) * stride + 3;  // input rows incl. the halo
  const int Wp = W + 2;                   // input cols incl. the pad ring
  float* xs = smem;                       // [T][Wp][C]
  float* ds = xs + T * Wp * C;            // [rows * Wo][C]
  float* ws = ds + rows * Wo * C;         // [C][block_f]

  const int b = blockIdx.y;
  const int i0 = blockIdx.x * rows;
  const int nrows = min(rows, Ho - i0);
  const int Tn = (nrows - 1) * stride + 3;
  const int r_in0 = i0 * stride + stride - 2;  // input row of tile row 0
  const float* xb = x + (size_t)b * H * W * C;

  for (int idx = threadIdx.x; idx < Tn * Wp * C; idx += blockDim.x) {
    const int c = idx % C, t = idx / C;
    const int ir = r_in0 + t / Wp, ic = t % Wp - 1;
    float v = 0.0f;
    if (ir >= 0 && ir < H && ic >= 0 && ic < W)
      v = xb[((size_t)ir * W + ic) * C + c];
    xs[idx] = v;
  }
  __syncthreads();

  const int P = nrows * Wo;
  for (int idx = threadIdx.x; idx < P * C; idx += blockDim.x) {
    const int c = idx % C, p = idx / C;
    const int r = p / Wo, wo = p % Wo;
    const float* xp = xs + ((r * stride) * Wp + wo * stride + stride - 1) * C;
    float acc = 0.0f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        acc += xp[(dy * Wp + dx) * C + c] * dw_w[(dy * 3 + dx) * C + c];
    acc += dw_b[c];
    ds[idx] = act ? hswish(acc) : acc;
  }
  __syncthreads();

  float* ob = out + ((size_t)b * Ho + i0) * Wo * F;
  for (int f0 = 0; f0 < F; f0 += block_f) {
    const int fw = min(block_f, F - f0);
    for (int idx = threadIdx.x; idx < C * fw; idx += blockDim.x) {
      const int c = idx / fw, f = idx % fw;
      ws[c * block_f + f] = pw_w[(size_t)c * F + f0 + f];
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < P * fw; idx += blockDim.x) {
      const int p = idx / fw, f = idx % fw;
      const float* dp = ds + p * C;
      float acc = 0.0f;
      for (int c = 0; c < C; ++c) acc += dp[c] * ws[c * block_f + f];
      ob[(size_t)p * F + f0 + f] = acc + pw_b[f0 + f];
    }
    __syncthreads();
  }
}

// Shared-memory bytes of one CTA; python mirror: kernels/dsconv/kernel.py.
static size_t dsconv_smem_bytes(int W, int C, int stride, int rows,
                                int block_f) {
  const int Wo = W / stride, T = (rows - 1) * stride + 3;
  return sizeof(float) * ((size_t)T * (W + 2) * C + (size_t)rows * Wo * C +
                          (size_t)C * block_f);
}

REPRO_EXPORT int dsconv_fused_f32(const float* x, const float* dw_w,
                                  const float* dw_b, const float* pw_w,
                                  const float* pw_b, float* out, int B, int H,
                                  int W, int C, int F, int stride, int act,
                                  int rows, int block_f, void* stream) {
  const int Ho = H / stride;
  const size_t smem = dsconv_smem_bytes(W, C, stride, rows, block_f);
  static size_t granted = 48 * 1024;
  cudaError_t err = allow_smem(dsconv_kernel, smem, &granted);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Ho + rows - 1) / rows, B);
  dsconv_kernel<<<grid, 256, smem, (cudaStream_t)stream>>>(
      x, dw_w, dw_b, pw_w, pw_b, out, H, W, C, F, stride, act, rows,
      block_f);
  return (int)cudaGetLastError();
}
