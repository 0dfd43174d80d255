// group_agg_int8: one FIX8 MSA aggregation branch.  int32 depthwise SxS
// over the int8 QKV map -> dequant -> requant (whole image) -> grouped 1x1
// (groups of d channels) with int32 sums -> dequant.
//
// Replaces the TPU kernel repro/kernels/group_conv/kernel.py::group_agg_int8,
// which holds one image per grid step and runs the grouped 1x1 as ONE
// dense (C, C) block-diagonal matmul on the MXU (768 x 768 at S4 of
// B1@224, 94 % zeros).  Here the grouped 1x1 is a GEMM whose reduction is
// cut to the output tile's own groups: a 64-channel output tile sums over
// its 64 input channels only, with the weights of other groups read as
// zero inside that block, which gives the same int32 sums from the
// (d, C) grouped weights without the dense matrix.
//
// The DW output is requantized with one absmax over the image, a cross-CTA
// reduction, so the kernel runs in two launches:
//   1. group_agg_dw_absmax: the DW stage for every element, folded into
//      the image's absmax word (commit_absmax); nothing is written.
//   2. group_agg_pw: grouped GEMM tiles (64 pixels x 64 channels, image)
//      whose A operand recomputes the DW stage from the int8 input and
//      quantizes it with the final scale: the int8 S3 map is 75 KB per
//      image, its fp32 DW map 301 KB, so recomputing 25 int MACs per
//      element beats a round trip of the fp32 map.
//
// Bound on the H100 at B1@224 ((B,14,14,384) and (B,7,7,768), S = 5,
// d = 16): bytes.  Per image the int8 input is 75 / 38 KB and the fp32
// output 301 / 151 KB, against 25 + 16 MACs per element.
#include "int8.cuh"

__device__ __forceinline__ float agg_dw(
    const int8_t* __restrict__ xb, const int8_t* __restrict__ dw, float xsb,
    const float* __restrict__ dws, const float* __restrict__ dwb, int H,
    int W, int C, int S, int i, int j, int c) {
  const int p = S / 2;
  int acc = 0;
  for (int dy = 0; dy < S; ++dy) {
    const int ir = i + dy - p;
    if (ir < 0 || ir >= H) continue;
    for (int dx = 0; dx < S; ++dx) {
      const int jc = j + dx - p;
      if (jc < 0 || jc >= W) continue;
      acc += static_cast<int>(xb[((size_t)ir * W + jc) * C + c]) *
             static_cast<int>(dw[(dy * S + dx) * C + c]);
    }
  }
  return dequant(acc, xsb, dws[c], dwb[c]);
}

__global__ void __launch_bounds__(ELEM_THREADS)
    group_agg_dw_absmax(const int8_t* __restrict__ x,
                        const float* __restrict__ xs,
                        const int8_t* __restrict__ dw,
                        const float* __restrict__ dws,
                        const float* __restrict__ dwb,
                        unsigned int* __restrict__ amax, int H, int W, int C,
                        int S) {
  const int b = blockIdx.y;
  const int idx = blockIdx.x * ELEM_THREADS + threadIdx.x;
  float v = 0.0f;
  if (idx < H * W * C) {
    const int c = idx % C, p = idx / C;
    v = fabsf(agg_dw(x + (size_t)b * H * W * C, dw, xs[b], dws, dwb, H, W, C,
                     S, p / W, p % W, c));
  }
  commit_absmax(v, amax + b);
}

__global__ void __launch_bounds__(GEMM_THREADS)
    group_agg_pw(const int8_t* __restrict__ x, const float* __restrict__ xs,
                 const int8_t* __restrict__ dw, const float* __restrict__ dws,
                 const float* __restrict__ dwb, const int8_t* __restrict__ pw,
                 const float* __restrict__ pws, const float* __restrict__ pwb,
                 const unsigned int* __restrict__ amax,
                 float* __restrict__ out, int H, int W, int C, int S, int d) {
  const int b = blockIdx.z;
  const int8_t* xb = x + (size_t)b * H * W * C;
  float* ob = out + (size_t)b * H * W * C;
  const float xsb = xs[b], s_y = scale_of(amax[b]);
  const int c0 = blockIdx.y * GN;          // the tile's groups: GN % d == 0
  gemm_tile_i8(
      H * W, C, c0, min(c0 + GN, C),
      [&](int r, int k) {
        return quant_i8(
            agg_dw(xb, dw, xsb, dws, dwb, H, W, C, S, r / W, r % W, k), s_y);
      },
      [&](int k, int n) {
        return k / d == n / d ? pw[(size_t)(k % d) * C + n]
                              : static_cast<int8_t>(0);
      },
      [&](int r, int n, int acc) {
        ob[(size_t)r * C + n] = dequant(acc, s_y, pws[n], pwb[n]);
        return 0.0f;
      });
}

REPRO_EXPORT int group_agg_int8_i8(const int8_t* x, const float* xs,
                                   const int8_t* dw, const float* dws,
                                   const float* dwb, const int8_t* pw,
                                   const float* pws, const float* pwb,
                                   unsigned int* amax, float* out, int B,
                                   int H, int W, int C, int S, int d,
                                   void* stream) {
  if (d <= 0 || GN % d != 0 || C % d != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  group_agg_dw_absmax<<<elem_grid((long long)H * W * C, B), ELEM_THREADS, 0,
                        s>>>(x, xs, dw, dws, dwb, amax, H, W, C, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  group_agg_pw<<<gemm_grid(H * W, C, B), GEMM_THREADS, 0, s>>>(
      x, xs, dw, dws, dwb, pw, pws, pwb, amax, out, H, W, C, S, d);
  return (int)cudaGetLastError();
}
