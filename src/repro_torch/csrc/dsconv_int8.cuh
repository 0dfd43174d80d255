// The two passes of the FIX8 DSConv: int32 DW3x3 on int8 input ->
// dequant -> stride -> Hardswish -> requant over the whole image -> int8
// PW GEMM -> dequant.  The image's absmax is a cross-CTA reduction:
//   1. dsconv_i8_dw_absmax: the DW stage for every output element, its
//      magnitude folded into the image's absmax word (commit_absmax);
//      nothing else is written.
//   2. dsconv_i8_pw<EMIT>: a GEMM tile per (64 pixels, 64 c_out, image)
//      whose A operand recomputes the DW stage from the int8 input and
//      quantizes it with the now final scale, so the DW map never reaches
//      device memory (9 int MACs per element, recomputed once).  The
//      epilogue dequantizes, adds the fp residual `res` when given (res +
//      out, one rounding) and, EMIT, folds the output into its absmax.
// Used by csrc/dsconv_int8.cu (one site) and csrc/supersite_int8.cu.
#pragma once

#include "int8.cuh"

// The DW3x3 stage at output pixel (i, j), channel c: taps centred on
// input (i*s + s - 1, j*s + s - 1), the reference's SAME anchor, with the
// int8 zero ring outside the image; dequant, then Hardswish when act.
__device__ __forceinline__ float dsconv_dw(
    const ActIn& x, size_t xb, float xsb, const int8_t* __restrict__ dw,
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
      acc += static_cast<int>(x.at(xb + ((size_t)ir * W + jc) * C + c, xsb)) *
             static_cast<int>(dw[(dy * 3 + dx) * C + c]);
    }
  }
  const float y = dequant(acc, xsb, dws[c], dwb[c]);
  return act ? hswish_rn(y) : y;
}

__global__ void __launch_bounds__(ELEM_THREADS)
    dsconv_i8_dw_absmax(ActIn x, const int8_t* __restrict__ dw,
                        const float* __restrict__ dws,
                        const float* __restrict__ dwb,
                        unsigned int* __restrict__ amax, int H, int W, int C,
                        int stride, int act) {
  const int b = blockIdx.y, Ho = H / stride, Wo = W / stride;
  const int idx = blockIdx.x * ELEM_THREADS + threadIdx.x;
  float v = 0.0f;
  if (idx < Ho * Wo * C) {
    const int c = idx % C, p = idx / C;
    v = fabsf(dsconv_dw(x, (size_t)b * H * W * C, x.scale(b), dw, dws, dwb,
                        H, W, C, stride, act, p / Wo, p % Wo, c));
  }
  commit_absmax(v, amax + b);
}

template <bool EMIT>
__global__ void __launch_bounds__(GEMM_THREADS)
    dsconv_i8_pw(ActIn x, const int8_t* __restrict__ dw,
                 const float* __restrict__ dws, const float* __restrict__ dwb,
                 const int8_t* __restrict__ pw, const float* __restrict__ pws,
                 const float* __restrict__ pwb,
                 const unsigned int* __restrict__ amax,
                 const float* __restrict__ res, float* __restrict__ out,
                 unsigned int* __restrict__ amax_out, int H, int W, int C,
                 int F, int stride, int act) {
  const int b = blockIdx.z, Ho = H / stride, Wo = W / stride;
  const size_t xb = (size_t)b * H * W * C;
  const float xsb = x.scale(b), s_dw = scale_of(amax[b]);
  const float* rb = res != nullptr ? res + (size_t)b * Ho * Wo * F : nullptr;
  float* ob = out + (size_t)b * Ho * Wo * F;
  const float vmax = gemm_tile_i8(
      Ho * Wo, F, 0, C,
      [&](int r, int k) {
        return quant_i8(dsconv_dw(x, xb, xsb, dw, dws, dwb, H, W, C, stride,
                                  act, r / Wo, r % Wo, k),
                        s_dw);
      },
      [&](int k, int n) { return pw[(size_t)k * F + n]; },
      [&](int r, int n, int acc) {
        float o = dequant(acc, s_dw, pws[n], pwb[n]);
        if (rb != nullptr) o = __fadd_rn(rb[(size_t)r * F + n], o);
        ob[(size_t)r * F + n] = o;
        return o;
      });
  if (EMIT) commit_absmax(vmax, amax_out + b);
}

// The two passes of one DSConv over B images (amax: 2 * B words, the DW
// absmax and the output absmax of each image).
static inline cudaError_t dsconv_i8_passes(
    ActIn x, const int8_t* dw, const float* dws, const float* dwb,
    const int8_t* pw, const float* pws, const float* pwb, const float* res,
    float* out, unsigned int* amax, bool emit, int B, int H, int W, int C,
    int F, int stride, int act, cudaStream_t s) {
  const int Ho = H / stride, Wo = W / stride;
  dsconv_i8_dw_absmax<<<elem_grid((long long)Ho * Wo * C, B), ELEM_THREADS,
                        0, s>>>(x, dw, dws, dwb, amax, H, W, C, stride, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (emit)
    dsconv_i8_pw<true><<<gemm_grid(Ho * Wo, F, B), GEMM_THREADS, 0, s>>>(
        x, dw, dws, dwb, pw, pws, pwb, amax, res, out, amax + B, H, W, C, F,
        stride, act);
  else
    dsconv_i8_pw<false><<<gemm_grid(Ho * Wo, F, B), GEMM_THREADS, 0, s>>>(
        x, dw, dws, dwb, pw, pws, pwb, amax, res, out, amax + B, H, W, C, F,
        stride, act);
  return cudaGetLastError();
}
