// The passes of the FIX8 MBConv: int8 PW1 -> dequant -> Hardswish ->
// requant (whole image) -> int32 DW3x3 -> dequant -> stride -> Hardswish
// -> requant (whole image) -> int8 PW2 -> dequant.  Each requant point is
// a cross-CTA absmax (commit_absmax into a per-image word zeroed before
// the first pass), so a pass ends at each:
//   1. mbconv_i8_pw1: GEMM tiles (64 pixels x 64 mid channels, image);
//      the epilogue dequantizes, applies Hardswish, writes the fp32 mid
//      map to a device scratch and folds it into the mid absmax.
//   2. mbconv_i8_dw: one thread per (output pixel, mid channel) reads the
//      9 taps of the mid scratch, quantizes each with the final mid scale
//      (the int8 zero ring outside the image contributes nothing), sums
//      in int32, dequantizes, applies Hardswish, writes the fp32 DW map
//      to a second scratch and folds it into the DW absmax.
//   3. mbconv_i8_pw2<EMIT>: GEMM tiles whose A operand quantizes the DW
//      scratch with its final scale; the epilogue dequantizes, adds the
//      fp residual `res` when given (res + out, one rounding), writes the
//      fp32 output and, EMIT, folds it into the output absmax.
//   4. i8_emit (int8.cuh): quantizes an fp32 map with its final scale and
//      writes the per-image scales.
// Used by csrc/mbconv_int8.cu (one site) and csrc/supersite_int8.cu (a
// chain, whose member boundaries quantize on load through ActIn).
#pragma once

#include "int8.cuh"

__global__ void __launch_bounds__(GEMM_THREADS)
    mbconv_i8_pw1(ActIn x, const int8_t* __restrict__ w1,
                  const float* __restrict__ s1, const float* __restrict__ b1,
                  float* __restrict__ mid, unsigned int* __restrict__ amax_mid,
                  int HW, int C, int M) {
  const int b = blockIdx.z;
  const size_t xb = (size_t)b * HW * C;
  float* mb = mid + (size_t)b * HW * M;
  const float xsb = x.scale(b);
  const float vmax = gemm_tile_i8(
      HW, M, 0, C,
      [&](int r, int k) { return x.at(xb + (size_t)r * C + k, xsb); },
      [&](int k, int n) { return w1[(size_t)k * M + n]; },
      [&](int r, int n, int acc) {
        const float v = hswish_rn(dequant(acc, xsb, s1[n], b1[n]));
        mb[(size_t)r * M + n] = v;
        return v;
      });
  commit_absmax(vmax, amax_mid + b);
}

__global__ void __launch_bounds__(ELEM_THREADS)
    mbconv_i8_dw(const float* __restrict__ mid,
                 const unsigned int* __restrict__ amax_mid,
                 const int8_t* __restrict__ dw, const float* __restrict__ dws,
                 const float* __restrict__ dwb, float* __restrict__ dwo,
                 unsigned int* __restrict__ amax_dw, int H, int W, int M,
                 int stride) {
  const int b = blockIdx.y, Ho = H / stride, Wo = W / stride;
  const int idx = blockIdx.x * ELEM_THREADS + threadIdx.x;
  const float s_mid = scale_of(amax_mid[b]);
  float v = 0.0f;
  if (idx < Ho * Wo * M) {
    const int m = idx % M, p = idx / M;
    const int ci = (p / Wo) * stride + stride - 1;
    const int cj = (p % Wo) * stride + stride - 1;
    const float* mb = mid + (size_t)b * H * W * M;
    int acc = 0;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int ir = ci + dy - 1;
      if (ir < 0 || ir >= H) continue;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int jc = cj + dx - 1;
        if (jc < 0 || jc >= W) continue;
        acc += static_cast<int>(
                   quant_i8(mb[((size_t)ir * W + jc) * M + m], s_mid)) *
               static_cast<int>(dw[(dy * 3 + dx) * M + m]);
      }
    }
    const float y = hswish_rn(dequant(acc, s_mid, dws[m], dwb[m]));
    dwo[((size_t)b * Ho * Wo + p) * M + m] = y;
    v = fabsf(y);
  }
  commit_absmax(v, amax_dw + b);
}

template <bool EMIT>
__global__ void __launch_bounds__(GEMM_THREADS)
    mbconv_i8_pw2(const float* __restrict__ dwo,
                  const unsigned int* __restrict__ amax_dw,
                  const int8_t* __restrict__ w2, const float* __restrict__ s2,
                  const float* __restrict__ b2, const float* __restrict__ res,
                  float* __restrict__ out, unsigned int* __restrict__ amax_out,
                  int HWo, int M, int F) {
  const int b = blockIdx.z;
  const float* db = dwo + (size_t)b * HWo * M;
  const float* rb = res != nullptr ? res + (size_t)b * HWo * F : nullptr;
  float* ob = out + (size_t)b * HWo * F;
  const float s_dw = scale_of(amax_dw[b]);
  const float vmax = gemm_tile_i8(
      HWo, F, 0, M,
      [&](int r, int k) { return quant_i8(db[(size_t)r * M + k], s_dw); },
      [&](int k, int n) { return w2[(size_t)k * F + n]; },
      [&](int r, int n, int acc) {
        float o = dequant(acc, s_dw, s2[n], b2[n]);
        if (rb != nullptr) o = __fadd_rn(rb[(size_t)r * F + n], o);
        ob[(size_t)r * F + n] = o;
        return o;
      });
  if (EMIT) commit_absmax(vmax, amax_out + b);
}

// The three passes of one MBConv over B images (amax: 3 * B words, mid,
// DW and output absmax of each image).  `res` (nullable) is the fp
// residual added in the PW2 epilogue; `emit` makes PW2 fold its output
// into the output absmax.
static inline cudaError_t mbconv_i8_passes(
    ActIn x, const int8_t* w1, const float* s1, const float* b1,
    const int8_t* dw, const float* dws, const float* dwb, const int8_t* w2,
    const float* s2, const float* b2, const float* res, float* mid,
    float* dwo, float* out, unsigned int* amax, bool emit, int B, int H,
    int W, int C, int M, int F, int stride, cudaStream_t s) {
  const int Ho = H / stride, Wo = W / stride;
  mbconv_i8_pw1<<<gemm_grid(H * W, M, B), GEMM_THREADS, 0, s>>>(
      x, w1, s1, b1, mid, amax, H * W, C, M);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mbconv_i8_dw<<<elem_grid((long long)Ho * Wo * M, B), ELEM_THREADS, 0, s>>>(
      mid, amax, dw, dws, dwb, dwo, amax + B, H, W, M, stride);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (emit)
    mbconv_i8_pw2<true><<<gemm_grid(Ho * Wo, F, B), GEMM_THREADS, 0, s>>>(
        dwo, amax + B, w2, s2, b2, res, out, amax + 2 * B, Ho * Wo, M, F);
  else
    mbconv_i8_pw2<false><<<gemm_grid(Ho * Wo, F, B), GEMM_THREADS, 0, s>>>(
        dwo, amax + B, w2, s2, b2, res, out, amax + 2 * B, Ho * Wo, M, F);
  return cudaGetLastError();
}
