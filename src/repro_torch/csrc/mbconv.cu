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
// flops/byte ridge (67 TFLOP/s over 3.35 TB/s).  The small maps (S3 14x14,
// S4 7x7) give few pixels per image, so the card fills only if the work
// of one image is spread over many SMs.
//
// Design: the grid is (slice of the mid channels, band of output rows,
// image), and the slices of one (band, image) form one thread-block
// cluster.  DW is per channel, so the mid channels split with no halo:
// each CTA runs PW1 -> DW -> PW2 for its slice of M over its band's
// window, in chunks of block_m channels, with the register-tiled stages
// of mbconv_fp.cuh, and keeps the PW2 partial sums [band pixels][F] in
// shared memory.  After cluster.sync() each CTA sums its share of the
// band's outputs over the cluster's ranks in rank order (reading the
// other CTAs' partials through distributed shared memory), adds b2 and
// writes it; a second cluster.sync() keeps every CTA's shared memory
// alive until the others have read it.  The order is fixed, so the
// result is deterministic.  At S3/S4 the band is the whole map: PW1 runs
// once per pixel.  Large maps keep row bands, whose windows recompute
// PW1 on (rows*s + 3 - s) / (rows*s) of the rows; the input streams
// through K tiles from L2 and is never held whole.  The mid window's pad
// ring and every halo row outside the image are ZERO after the
// activation (hardswish(b1) != 0).  Stride s samples the stride-1 DW map
// at offset s - 1 (the reference's SAME anchor).  fp32 FFMA on CUDA
// cores: TF32 tensor cores would break fp32 parity.
#include <cooperative_groups.h>

#include "mbconv_fp.cuh"

namespace cg = cooperative_groups;
using namespace mbfp;

// Shared-memory layout of one CTA, in floats: the PW2 partial sums
// [rows * Wo][F], then region X (PW1 staging | DW result [bm][ldp]),
// then region Y (the mid window [T][W + 2][bm] | PW2 staging at the tile
// width pw2_bn of a whole band, which every band uses), each a
// multiple of 4 floats (float4 alignment).  Python
// mirror: kernels/mbconv/kernel.py::mbconv_smem_bytes.
struct MbLayout {
  int acc, x, y;
};
static inline MbLayout mb_layout(int W, int F, int stride, int rows, int bm) {
  const int P = rows * (W / stride), T = (rows - 1) * stride + 3;
  MbLayout l;
  l.acc = round4(P * F);
  l.x = max(rows_stage_floats(bm), bm * round4(P));
  l.y = max(T * (W + 2) * bm, kmajor_stage_floats(pw2_bn(P, F)));
  return l;
}

__global__ void __launch_bounds__(NT, 2)
    mbconv_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                  const float* __restrict__ b1, const float* __restrict__ dw_w,
                  const float* __restrict__ dw_b, const float* __restrict__ w2,
                  const float* __restrict__ b2, float* __restrict__ out, int H,
                  int W, int C, int M, int F, int stride, int rows, int bm,
                  int bn2, int slice, int acc_n, int x_n) {
  extern __shared__ __align__(16) float smem[];
  const int s = stride, Ho = H / s, Wo = W / s, Wp = W + 2;
  const int split = gridDim.x, rank = blockIdx.x;  // one cluster spans x
  const int i0 = blockIdx.y * rows, b = blockIdx.z;
  const int nrows = min(rows, Ho - i0);
  const int P = nrows * Wo, T = (nrows - 1) * s + 3;
  const int r_in0 = i0 * s + s - 2;  // input row of window row 0
  const int lo = max(0, -r_in0), hi = min(T, H - r_in0);  // rows in the map
  float* acc = smem;
  float* xs = smem + acc_n;
  float* win = xs + x_n;
  const float* xb = x + (size_t)b * H * W * C;

  for (int e = threadIdx.x; e < P * F; e += NT) acc[e] = 0.0f;
  const int m_lo = rank * slice, m_hi = min(M, m_lo + slice);
  for (int m0 = m_lo; m0 < m_hi; m0 += bm) {
    zero_border(win, T, Wp, bm, lo, hi);
    mbconv_chunk<false>(xb + (size_t)(r_in0 + lo) * W * C, (hi - lo) * W, lo,
                        W, C, M, min(bm, m_hi - m0), bm, w1 + m0, b1 + m0,
                        dw_w + m0, dw_b + m0, w2 + (size_t)m0 * F, F, bn2, P,
                        Wo, s, xs, win, acc);
  }
  float* ob = out + ((size_t)b * Ho + i0) * Wo * F;
  if (split == 1) {
    __syncthreads();
    for (int e = threadIdx.x; e < P * F; e += NT)
      ob[e] = acc[e] + __ldg(b2 + e % F);
    return;
  }
  // sum the cluster's partials, rank by rank, over this CTA's share
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  const int total = P * F;
  const int per = round4((total + split - 1) / split);
  const int e_lo = rank * per, e_hi = min(total, e_lo + per);
  if (F % 4 == 0) {
    for (int e = e_lo + 4 * threadIdx.x; e < e_hi; e += 4 * NT) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      // four remote loads in flight, summed in rank order
      for (int q0 = 0; q0 < split; q0 += 4) {
        float4 r[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (q0 + u < split)
            r[u] = *reinterpret_cast<const float4*>(
                cl.map_shared_rank(acc, q0 + u) + e);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (q0 + u < split) {
            v.x += r[u].x;
            v.y += r[u].y;
            v.z += r[u].z;
            v.w += r[u].w;
          }
      }
      const int f = e % F;
      v.x += __ldg(b2 + f);
      v.y += __ldg(b2 + f + 1);
      v.z += __ldg(b2 + f + 2);
      v.w += __ldg(b2 + f + 3);
      *reinterpret_cast<float4*>(ob + e) = v;
    }
  } else {
    for (int e = e_lo + threadIdx.x; e < e_hi; e += NT) {
      float v = 0.0f;
      for (int q = 0; q < split; ++q) v += cl.map_shared_rank(acc, q)[e];
      ob[e] = v + __ldg(b2 + e % F);
    }
  }
  cl.sync();
}

// Shared-memory bytes of one CTA; Python mirror: kernels/mbconv/kernel.py.
REPRO_EXPORT long long mbconv_smem_bytes_c(int W, int F, int stride,
                                           int rows, int bm) {
  const MbLayout l = mb_layout(W, F, stride, rows, bm);
  return (long long)sizeof(float) * ((long long)l.acc + l.x + l.y);
}

// Mid channels per slice: ceil(M / split), rounded up to a multiple of 4.
static inline int mb_slice(int M, int split) {
  return round4((M + split - 1) / split);
}

static cudaError_t mb_config(int B, int H, int W, int F, int stride,
                             int rows, int bm, int split, void* stream,
                             cudaLaunchConfig_t* cfg,
                             cudaLaunchAttribute* attr) {
  static size_t granted = 48 * 1024;
  static bool nonportable = false;
  const MbLayout l = mb_layout(W, F, stride, rows, bm);
  const size_t smem = sizeof(float) * ((size_t)l.acc + l.x + l.y);
  cudaError_t err = allow_smem(mbconv_kernel, smem, &granted);
  if (err != cudaSuccess) return err;
  if (split > 8 && !nonportable) {
    err = cudaFuncSetAttribute(
        mbconv_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    nonportable = true;
  }
  const int Ho = H / stride;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(split, (Ho + rows - 1) / rows, B);
  cfg->blockDim = dim3(NT);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = split;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = split > 1 ? 1 : 0;
  return cudaSuccess;
}

static bool mb_blocks_ok(int bm, int split) {
  return (bm == 16 || bm == 32 || bm == 64 || bm == 128) && split >= 1 &&
         split <= 16;
}

REPRO_EXPORT int mbconv_fused_f32(const float* x, const float* w1,
                                  const float* b1, const float* dw_w,
                                  const float* dw_b, const float* w2,
                                  const float* b2, float* out, int B, int H,
                                  int W, int C, int M, int F, int stride,
                                  int rows, int bm, int split, void* stream) {
  if (!mb_blocks_ok(bm, split)) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err =
      mb_config(B, H, W, F, stride, rows, bm, split, stream, &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  const MbLayout l = mb_layout(W, F, stride, rows, bm);
  err = cudaLaunchKernelEx(&cfg, mbconv_kernel, x, w1, b1, dw_w, dw_b, w2, b2,
                           out, H, W, C, M, F, stride, rows, bm,
                           pw2_bn(rows * (W / stride), F), mb_slice(M, split),
                           l.acc, l.x);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of `split` CTAs the card can hold at once for this
// geometry (cudaOccupancyMaxActiveClusters); 0 means such a launch can
// never be scheduled.  For the block sweep.
REPRO_EXPORT int mbconv_max_active_clusters(int B, int H, int W, int F,
                                            int stride, int rows, int bm,
                                            int split, int* n) {
  if (!mb_blocks_ok(bm, split)) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err =
      mb_config(B, H, W, F, stride, rows, bm, split, nullptr, &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  cfg.numAttrs = 1;  // a cluster of one when split == 1
  return (int)cudaOccupancyMaxActiveClusters(n, mbconv_kernel, &cfg);
}
