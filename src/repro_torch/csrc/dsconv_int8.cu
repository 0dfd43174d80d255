// dsconv_fused_int8: int32 DW3x3 on int8 input -> dequant -> stride ->
// Hardswish -> requant over the whole image -> int8 PW GEMM -> dequant;
// dsconv_fused_int8_emit: the same, then a per-image act-quant of the
// full-c_out output (+ the fp32 output under keep-fp).
//
// Replace the TPU kernels repro/kernels/dsconv/kernel.py::dsconv_fused_int8
// and ::dsconv_fused_int8_emit, which hold one image per grid step,
// requantize the DW map (and, emitting, the output) with one absmax over
// the image, and keep the int8 map in VMEM scratch.
//
// A CTA here sees a band of the image, so the image's absmax is a
// cross-CTA reduction, done in two launches (dsconv_int8.cuh, shared with
// the super-site chain kernel): the DW stage's absmax, then a GEMM pass
// that recomputes the DW stage and quantizes it with the final scale, so
// the DW map never reaches device memory.  The emitting variant's GEMM
// pass also folds the output into a second absmax word per image (EMIT in
// dsconv_int8.cuh), and a third launch quantizes the fp32 output (i8_emit,
// int8.cuh), so its fp32 map is dsconv_fused_int8's output bit for bit.
//
// Bound on the H100 at stem.ds0 of B1@224 (112 x 112 x 16 -> 16): bytes.
// The int8 input is 200 KB and the fp32 output 800 KB per image against
// ~6 M int8 operations per image.  The design reads the input twice
// (once per pass, mostly from L2) and writes only the output.
#include "dsconv_int8.cuh"

REPRO_EXPORT int dsconv_fused_int8_i8(
    const int8_t* x, const float* xs, const int8_t* dw, const float* dws,
    const float* dwb, const int8_t* pw, const float* pws, const float* pwb,
    unsigned int* amax, float* out, int B, int H, int W, int C, int F,
    int stride, int act, void* stream) {
  return (int)dsconv_i8_passes(ActIn{x, xs, nullptr, nullptr}, dw, dws, dwb,
                               pw, pws, pwb, nullptr, out, amax, false, B, H,
                               W, C, F, stride, act, (cudaStream_t)stream);
}

// amax: 2 * B words, zeroed here; out (B, Ho, Wo, F) fp32 (the kept map or
// scratch); q (B, Ho, Wo, F) int8; scales (B,).
REPRO_EXPORT int dsconv_fused_int8_emit_i8(
    const int8_t* x, const float* xs, const int8_t* dw, const float* dws,
    const float* dwb, const int8_t* pw, const float* pws, const float* pwb,
    unsigned int* amax, float* out, int8_t* q, float* scales, int B, int H,
    int W, int C, int F, int stride, int act, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(unsigned int) * 2 * B, s);
  if (err != cudaSuccess) return (int)err;
  err = dsconv_i8_passes(ActIn{x, xs, nullptr, nullptr}, dw, dws, dwb, pw,
                         pws, pwb, nullptr, out, amax, true, B, H, W, C, F,
                         stride, act, s);
  if (err != cudaSuccess) return (int)err;
  return (int)i8_emit_pass(out, amax + B, q, scales, B,
                           (long long)(H / stride) * (W / stride) * F, s);
}
