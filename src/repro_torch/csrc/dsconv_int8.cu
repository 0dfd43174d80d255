// dsconv_fused_int8: int32 DW3x3 on int8 input -> dequant -> stride ->
// Hardswish -> requant over the whole image -> int8 PW GEMM -> dequant.
//
// Replaces the TPU kernel repro/kernels/dsconv/kernel.py::dsconv_fused_int8,
// which holds one image per grid step, requantizes the DW map with one
// absmax over the image, and keeps the int8 map in VMEM scratch reused
// across c_out steps that run in order.
//
// A CTA here sees a band of the image, so the image's absmax is a
// cross-CTA reduction, done in two launches:
//   1. dsconv_i8_dw_absmax: the DW stage for every output element, its
//      magnitude folded into the image's absmax word (commit_absmax);
//      nothing else is written.
//   2. dsconv_i8_pw: a GEMM tile per (64 pixels, 64 c_out, image) whose
//      A operand recomputes the DW stage from the int8 input and
//      quantizes it with the now final scale, so the DW map never
//      reaches device memory (9 int MACs per element, recomputed once).
//
// Bound on the H100 at stem.ds0 of B1@224 (112 x 112 x 16 -> 16): bytes.
// The int8 input is 200 KB and the fp32 output 800 KB per image against
// ~6 M int8 operations per image.  The design reads the input twice
// (once per pass, mostly from L2) and writes only the output.
#include "int8.cuh"

// The DW3x3 stage at output pixel (i, j), channel c: taps centred on
// input (i*s + s - 1, j*s + s - 1), the reference's SAME anchor, with the
// int8 zero ring outside the image; dequant, then Hardswish when act.
__device__ __forceinline__ float dsconv_dw(
    const int8_t* __restrict__ xb, const int8_t* __restrict__ dw, float xsb,
    const float* __restrict__ dws, const float* __restrict__ dwb, int H,
    int W, int C, int stride, int act, int i, int j, int c) {
  const int ci = i * stride + stride - 1, cj = j * stride + stride - 1;
  int acc = 0;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int ir = ci + dy - 1;
    if (ir < 0 || ir >= H) continue;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int jc = cj + dx - 1;
      if (jc < 0 || jc >= W) continue;
      acc += static_cast<int>(xb[((size_t)ir * W + jc) * C + c]) *
             static_cast<int>(dw[(dy * 3 + dx) * C + c]);
    }
  }
  const float y = dequant(acc, xsb, dws[c], dwb[c]);
  return act ? hswish_rn(y) : y;
}

__global__ void __launch_bounds__(ELEM_THREADS)
    dsconv_i8_dw_absmax(const int8_t* __restrict__ x,
                        const float* __restrict__ xs,
                        const int8_t* __restrict__ dw,
                        const float* __restrict__ dws,
                        const float* __restrict__ dwb,
                        unsigned int* __restrict__ amax, int H, int W, int C,
                        int stride, int act) {
  const int b = blockIdx.y, Ho = H / stride, Wo = W / stride;
  const int idx = blockIdx.x * ELEM_THREADS + threadIdx.x;
  float v = 0.0f;
  if (idx < Ho * Wo * C) {
    const int c = idx % C, p = idx / C;
    v = fabsf(dsconv_dw(x + (size_t)b * H * W * C, dw, xs[b], dws, dwb, H, W,
                        C, stride, act, p / Wo, p % Wo, c));
  }
  commit_absmax(v, amax + b);
}

__global__ void __launch_bounds__(GEMM_THREADS)
    dsconv_i8_pw(const int8_t* __restrict__ x, const float* __restrict__ xs,
                 const int8_t* __restrict__ dw, const float* __restrict__ dws,
                 const float* __restrict__ dwb, const int8_t* __restrict__ pw,
                 const float* __restrict__ pws, const float* __restrict__ pwb,
                 const unsigned int* __restrict__ amax,
                 float* __restrict__ out, int H, int W, int C, int F,
                 int stride, int act) {
  const int b = blockIdx.z, Ho = H / stride, Wo = W / stride;
  const int8_t* xb = x + (size_t)b * H * W * C;
  const float xsb = xs[b], s_dw = scale_of(amax[b]);
  float* ob = out + (size_t)b * Ho * Wo * F;
  gemm_tile_i8(
      Ho * Wo, F, 0, C,
      [&](int r, int k) {
        return quant_i8(dsconv_dw(xb, dw, xsb, dws, dwb, H, W, C, stride, act,
                                  r / Wo, r % Wo, k),
                        s_dw);
      },
      [&](int k, int n) { return pw[(size_t)k * F + n]; },
      [&](int r, int n, int acc) {
        ob[(size_t)r * F + n] = dequant(acc, s_dw, pws[n], pwb[n]);
        return 0.0f;
      });
}

REPRO_EXPORT int dsconv_fused_int8_i8(
    const int8_t* x, const float* xs, const int8_t* dw, const float* dws,
    const float* dwb, const int8_t* pw, const float* pws, const float* pwb,
    unsigned int* amax, float* out, int B, int H, int W, int C, int F,
    int stride, int act, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int Ho = H / stride, Wo = W / stride;
  dsconv_i8_dw_absmax<<<elem_grid((long long)Ho * Wo * C, B), ELEM_THREADS,
                        0, s>>>(x, xs, dw, dws, dwb, amax, H, W, C, stride,
                                act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dsconv_i8_pw<<<gemm_grid(Ho * Wo, F, B), GEMM_THREADS, 0, s>>>(
      x, xs, dw, dws, dwb, pw, pws, pwb, amax, out, H, W, C, F, stride, act);
  return (int)cudaGetLastError();
}
