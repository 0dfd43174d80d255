// mbconv_fused_int8 and mbconv_fused_int8_emit: int8 PW1 -> dequant ->
// Hardswish -> requant (whole image) -> int32 DW3x3 -> dequant -> stride ->
// Hardswish -> requant (whole image) -> int8 PW2 -> dequant, and for the
// emitting variant a per-image act-quant of the output (+ the fp output).
//
// Replaces the TPU kernels repro/kernels/mbconv/kernel.py::mbconv_fused_int8
// and ::mbconv_fused_int8_emit.  Each holds one image per grid step in
// VMEM (the int8 padded mid map is (H+2)(W+2)M bytes, 0.8 MB at S1.mb0 of
// B1@224) and requantizes the mid map, the DW output and (emit) the block
// output with one absmax over the image.  A Hopper CTA has 227 KB of
// shared memory and sees a band of the image, so each requant point is a
// cross-CTA absmax (commit_absmax into a per-image word the wrapper
// zeroes), and the kernel is split into passes at those points
// (mbconv_int8.cuh, shared with the super-site chain kernel).  The
// emitting variant adds a pass that quantizes the output.
// So a site costs 3 CUDA launches (4 emitting), plus the wrapper's zeroing
// of the absmax words, and the fp32 mid and DW maps cross device memory
// once each way.  Keeping them on chip would need the recompute the TPU
// kernel avoids by holding the whole image; that trade is a later PR's.
//
// Bound on the H100 at B1@224: bytes at S1/S2 (int8 input and fp32
// output against a few hundred int8 operations per pixel), operations
// only near the int8 tensor-core ridge, which the S3/S4 GEMMs (K = 128..
// 1024) do not reach at these batch sizes.  The GEMMs run __dp4a on CUDA
// cores (int8.cuh).
#include "mbconv_int8.cuh"

// amax holds 3 * B words, zeroed by the wrapper: mid, DW and output
// absmax of each image.  q and scales are null for the plain variant.
static int mbconv_int8(const int8_t* x, const float* xs, const int8_t* w1,
                       const float* s1, const float* b1, const int8_t* dw,
                       const float* dws, const float* dwb, const int8_t* w2,
                       const float* s2, const float* b2, float* mid,
                       float* dwo, float* out, unsigned int* amax, int8_t* q,
                       float* scales, int B, int H, int W, int C, int M,
                       int F, int stride, cudaStream_t s) {
  const bool emit = q != nullptr;
  cudaError_t err = mbconv_i8_passes(
      ActIn{x, xs, nullptr, nullptr}, w1, s1, b1, dw, dws, dwb, w2, s2, b2,
      nullptr, mid, dwo, out, amax, emit, B, H, W, C, M, F, stride, s);
  if (err != cudaSuccess || !emit) return (int)err;
  return (int)i8_emit_pass(out, amax + 2 * B, q, scales, B,
                           (long long)(H / stride) * (W / stride) * F, s);
}

REPRO_EXPORT int mbconv_fused_int8_i8(
    const int8_t* x, const float* xs, const int8_t* w1, const float* s1,
    const float* b1, const int8_t* dw, const float* dws, const float* dwb,
    const int8_t* w2, const float* s2, const float* b2, float* mid,
    float* dwo, float* out, unsigned int* amax, int B, int H, int W, int C,
    int M, int F, int stride, void* stream) {
  return mbconv_int8(x, xs, w1, s1, b1, dw, dws, dwb, w2, s2, b2, mid, dwo,
                     out, amax, nullptr, nullptr, B, H, W, C, M, F, stride,
                     (cudaStream_t)stream);
}

REPRO_EXPORT int mbconv_fused_int8_emit_i8(
    const int8_t* x, const float* xs, const int8_t* w1, const float* s1,
    const float* b1, const int8_t* dw, const float* dws, const float* dwb,
    const int8_t* w2, const float* s2, const float* b2, float* mid,
    float* dwo, float* out, unsigned int* amax, int8_t* q, float* scales,
    int B, int H, int W, int C, int M, int F, int stride, void* stream) {
  return mbconv_int8(x, xs, w1, s1, b1, dw, dws, dwb, w2, s2, b2, mid, dwo,
                     out, amax, q, scales, B, H, W, C, M, F, stride,
                     (cudaStream_t)stream);
}
