// dsconv_fused_int8: int32 DW3x3 on int8 input -> dequant -> stride ->
// Hardswish -> requant over the whole image -> int8 PW GEMM -> dequant.
//
// Replaces the TPU kernel repro/kernels/dsconv/kernel.py::dsconv_fused_int8,
// which holds one image per grid step, requantizes the DW map with one
// absmax over the image, and keeps the int8 map in VMEM scratch reused
// across c_out steps that run in order.
//
// A CTA here sees a band of the image, so the image's absmax is a
// cross-CTA reduction, done in two launches (dsconv_int8.cuh, shared with
// the super-site chain kernel): the DW stage's absmax, then a GEMM pass
// that recomputes the DW stage and quantizes it with the final scale, so
// the DW map never reaches device memory.
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
