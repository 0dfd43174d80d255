// mbconv_fused: PW1 + bias -> Hardswish -> DW3x3 + bias -> stride ->
// Hardswish -> PW2 + bias, NHWC fp32.
//
// Replaces the TPU kernel repro/kernels/mbconv/kernel.py::mbconv_fused,
// which holds one image's whole zero-padded mid map in VMEM scratch:
// (H+2)(W+2)*M*4 bytes, 3.3 MB at S1.mb0 of B1@224.  A Hopper CTA has at
// most 227 KB of shared memory.
//
// Bound on the H100: operations.  The two 1x1 GEMMs do 2*(C + F)*M flops
// per pixel against (C + F)*4 bytes of activations, e.g. ~35 flops/byte at
// S1.mb0 and several hundred at S3/S4, above the card's ~20 fp32
// flops/byte ridge (67 TFLOP/s over 3.35 TB/s).
//
// Design: one CTA per (image, band of output rows).  The band's input
// rows plus the DW halo are read from device memory once into shared
// memory.  PW1 is recomputed over the halo rows of each band, and the mid
// channels are processed in chunks of block_m so the band fits in shared
// memory whatever M is.  DW is per channel, so chunks are independent up
// to PW2, whose partial sums accumulate across chunks in shared memory;
// only the final projection is written to device memory.  The mid map's
// padding ring and every halo row outside the image are written as ZERO
// after the activation (hardswish(b1) != 0, so computing them would be
// wrong).  Stride s samples the stride-1 DW map at offset s - 1 (the
// reference's SAME anchor).  fp32 FMA on CUDA cores: TF32 tensor cores
// would break fp32 parity.  Every band recomputes PW1 on its halo rows,
// a cost of (rows*s + 3 - s) / (rows*s) on the dominant GEMM.
#include "common.cuh"

__global__ void mbconv_kernel(const float* __restrict__ x,
                              const float* __restrict__ w1,
                              const float* __restrict__ b1,
                              const float* __restrict__ dw_w,
                              const float* __restrict__ dw_b,
                              const float* __restrict__ w2,
                              const float* __restrict__ b2,
                              float* __restrict__ out, int H, int W, int C,
                              int M, int F, int stride, int rows,
                              int block_m) {
  extern __shared__ float smem[];
  const int Ho = H / stride, Wo = W / stride;
  const int T = (rows - 1) * stride + 3;  // input rows incl. the halo
  const int Wp = W + 2;                   // mid cols incl. the pad ring
  float* xs = smem;                       // [T][W][C]
  float* ms = xs + T * W * C;             // [T][Wp][block_m]
  float* ds = ms + T * Wp * block_m;      // [rows * Wo][block_m]
  float* acc = ds + rows * Wo * block_m;  // [rows * Wo][F]

  const int b = blockIdx.y;
  const int i0 = blockIdx.x * rows;
  const int nrows = min(rows, Ho - i0);
  const int Tn = (nrows - 1) * stride + 3;
  const int r_in0 = i0 * stride + stride - 2;  // input row of tile row 0
  const int P = nrows * Wo;
  const float* xb = x + (size_t)b * H * W * C;

  for (int idx = threadIdx.x; idx < Tn * W * C; idx += blockDim.x) {
    const int ir = r_in0 + idx / (W * C);
    xs[idx] = (ir >= 0 && ir < H) ? xb[(size_t)ir * W * C + idx % (W * C)]
                                  : 0.0f;
  }
  for (int idx = threadIdx.x; idx < P * F; idx += blockDim.x) acc[idx] = 0.0f;
  __syncthreads();

  for (int m0 = 0; m0 < M; m0 += block_m) {
    const int mw = min(block_m, M - m0);
    // PW1 + bias + Hardswish on the band's rows and halo; zero ring.
    for (int idx = threadIdx.x; idx < Tn * Wp * mw; idx += blockDim.x) {
      const int m = idx % mw, t = idx / mw;
      const int tr = t / Wp, col = t % Wp;
      const int ir = r_in0 + tr;
      float v = 0.0f;
      if (ir >= 0 && ir < H && col >= 1 && col <= W) {
        const float* xp = xs + (tr * W + col - 1) * C;
        const float* wp = w1 + m0 + m;
        float a = 0.0f;
        for (int c = 0; c < C; ++c) a += xp[c] * __ldg(wp + (size_t)c * M);
        v = hswish(a + b1[m0 + m]);
      }
      ms[(tr * Wp + col) * block_m + m] = v;
    }
    __syncthreads();
    // DW 3x3 + bias at the strided anchors, Hardswish.
    for (int idx = threadIdx.x; idx < P * mw; idx += blockDim.x) {
      const int m = idx % mw, p = idx / mw;
      const int r = p / Wo, wo = p % Wo;
      const float* mp =
          ms + ((r * stride) * Wp + wo * stride + stride - 1) * block_m + m;
      float a = 0.0f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          a += mp[(dy * Wp + dx) * block_m] * dw_w[(dy * 3 + dx) * M + m0 + m];
      ds[p * block_m + m] = hswish(a + dw_b[m0 + m]);
    }
    __syncthreads();
    // PW2 partial sums over this chunk of mid channels.
    for (int idx = threadIdx.x; idx < P * F; idx += blockDim.x) {
      const int f = idx % F, p = idx / F;
      const float* dp = ds + p * block_m;
      const float* wp = w2 + (size_t)m0 * F + f;
      float a = 0.0f;
      for (int m = 0; m < mw; ++m) a += dp[m] * __ldg(wp + (size_t)m * F);
      acc[idx] += a;
    }
    __syncthreads();
  }

  float* ob = out + ((size_t)b * Ho + i0) * Wo * F;
  for (int idx = threadIdx.x; idx < P * F; idx += blockDim.x)
    ob[idx] = acc[idx] + b2[idx % F];
}

// Shared-memory bytes of one CTA; python mirror: kernels/mbconv/kernel.py.
static size_t mbconv_smem_bytes(int W, int C, int F, int stride, int rows,
                                int block_m) {
  const int Wo = W / stride, T = (rows - 1) * stride + 3;
  return sizeof(float) *
         ((size_t)T * W * C + (size_t)T * (W + 2) * block_m +
          (size_t)rows * Wo * block_m + (size_t)rows * Wo * F);
}

REPRO_EXPORT int mbconv_fused_f32(const float* x, const float* w1,
                                  const float* b1, const float* dw_w,
                                  const float* dw_b, const float* w2,
                                  const float* b2, float* out, int B, int H,
                                  int W, int C, int M, int F, int stride,
                                  int rows, int block_m, void* stream) {
  const int Ho = H / stride;
  const size_t smem = mbconv_smem_bytes(W, C, F, stride, rows, block_m);
  static size_t granted = 48 * 1024;
  cudaError_t err = allow_smem(mbconv_kernel, smem, &granted);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Ho + rows - 1) / rows, B);
  mbconv_kernel<<<grid, 256, smem, (cudaStream_t)stream>>>(
      x, w1, b1, dw_w, dw_b, w2, b2, out, H, W, C, M, F, stride, rows,
      block_m);
  return (int)cudaGetLastError();
}
