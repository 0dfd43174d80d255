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
// Bound on the H100 at stem.ds0 of B1@224 (112 x 112 x 16 -> 16): bytes.
// The int8 input is 200 KB and the fp32 output 800 KB per image against
// ~6 M int8 operations per image.  In practice latency: a few microseconds
// of work per image around one whole-image requant.
//
// dsconv_fused_int8 takes the cluster kernel (dsconv_i8_cluster) wherever
// one image's band of rows fits a thread-block cluster (kernels/dsconv/
// kernel.py::dsconv_int8_path; stem.ds0 of B1 at 192-384 px): one launch,
// grid (rank, image), the ranks of an image one cluster, each owning a
// band of its output rows.  A rank stages its input rows and their 1-row
// halo by cp.async (a zero pixel at both ends of a row, zero rows outside
// the image), computes the DW stage once per element (dsconv_dw's
// arithmetic: int32 3x3 taps at the reference's anchor i*s + s - 1,
// dequant, hswish_rn) into an fp32 band in shared memory, and takes the
// image's absmax as the max of the ranks' CTA maxima, each pushed to every
// rank through distributed shared memory (exact, the same in every rank).
// It quantizes its band once (quant_i8, __fdiv_rn) into a K-contiguous
// int8 panel and runs the 1x1 on int8 tensor cores (mma.sync m16n8k32
// over 32 channels, m16n8k16 over a last 16), then dequantizes and stores
// float4s.  No global atomic, no zero fill, no second launch.
//
// dsconv_fused_int8_emit takes the same kernel with an emitting epilogue
// (EMIT) wherever the path rule gives the cluster: each rank keeps its
// band's dequantized outputs in shared memory (the fp32 DW band's region,
// dead once the codes are written), pushes its output absmax to every rank
// as the DW's was, and after that cluster barrier quantizes its band with
// the image's scale (scale_of, quant_i8: i8_emit's arithmetic, so the same
// bits) into 16-byte stores, writing the fp32 map beside them under
// keep-fp.  Rank 0 writes the scale.  One launch, no memset.
//
// The two passes (dsconv_int8.cuh, shared with the super-site chain
// kernel), for maps whose bands fit no cluster and channel counts the
// cluster kernel does not take: the DW stage's absmax into a zeroed word
// per image, then a __dp4a GEMM pass that recomputes the DW stage and
// quantizes it with the final scale.  Emitting, the GEMM pass also folds
// the output into a second absmax word per image (EMIT in
// dsconv_int8.cuh), and a third launch quantizes the fp32 output (i8_emit,
// int8.cuh).  On either path the emitting variant's fp32 map is
// dsconv_fused_int8's output bit for bit.
#include "dsconv_int8.cuh"
#include "int8_mma.cuh"

namespace cg = cooperative_groups;
using i8mma::round_up;

// Threads of a cluster kernel CTA.  Its time goes to dependent chains (the
// DW taps, and the IEEE divisions of Hardswish and of the requant), so a
// CTA is 16 warps and two fit an SM: at stem.ds0 of B1@224 the 8 images'
// clusters of 16 ranks then fit the card at once (14 clusters, against 7
// at one CTA of 1024 threads an SM; chip_smoke.py's [dsconv_int8 sweep]).
constexpr int DS_NT = 512;

// Row pitch in bytes of a K-contiguous int8 panel of C channels, read by
// 4-byte fragment loads: C, or C + 16 where C / 16 is even, so the eight
// rows of a fragment load fall in distinct banks.
__host__ __device__ inline int ds_qp(int c) { return c / 16 % 2 ? c : c + 16; }

// Shared-memory layout of one rank of the cluster kernel, in bytes (Python
// mirror: kernels/dsconv/kernel.py::dsconv_int8_cluster_smem).  rows =
// ceil(Ho / ranks) output rows a rank, P = rows * Wo pixels.  xin: the
// rank's input rows with the halo, (rows - 1) * stride + 3 of them, each
// [W + 2][C] with a zero pixel at both ends; later the requantized DW
// codes [P rounded up to 16][qp]; dwf: the fp32 DW band [P][C], emitting
// later the band's fp32 outputs [P][F] (so [P][max(C, F)]); pwr: the 1x1
// weights as they arrive [C][F]; pwt: transposed [F][qp]; taps: the DW
// taps [9][C]; par: dws, dwb [C], pws, pwb [F]; red: 64 words for the
// block and cluster maxima, and 64 more emitting (the output's).
struct DsLayout {
  int rows, P, qp, dwf, pwr, pwt, taps, par, red, total;
};
__host__ __device__ inline DsLayout ds_layout(int H, int W, int C, int F,
                                              int stride, int ranks,
                                              bool emit) {
  DsLayout l;
  const int Ho = H / stride, Wo = W / stride;
  l.rows = (Ho + ranks - 1) / ranks;
  l.P = l.rows * Wo;
  l.qp = ds_qp(C);
  const int xin = ((l.rows - 1) * stride + 3) * (W + 2) * C;
  const int yq = round_up(l.P, 16) * l.qp;
  l.dwf = round_up(xin > yq ? xin : yq, 16);
  l.pwr = l.dwf + 4 * l.P * (emit && F > C ? F : C);
  l.pwt = l.pwr + round_up(C * F, 16);
  l.taps = l.pwt + F * l.qp;
  l.par = l.taps + round_up(9 * C, 16);
  l.red = l.par + 4 * (2 * C + 2 * F);
  l.total = l.red + 4 * (emit ? 128 : 64);
  return l;
}

// out: the fp32 map (emitting: only under keep-fp, else null); q, scales:
// the emitting kernel's codes (B, Ho, Wo, F) and per-image scales.
struct DsArgs {
  const int8_t* x;
  const float* xs;
  const int8_t *dw, *pw;
  const float *dws, *dwb, *pws, *pwb;
  float* out;
  int8_t* q;
  float* scales;
  int H, W, C, F, stride, act;
};

// C a multiple of 16, F of 8.
template <bool EMIT>
__global__ void __launch_bounds__(DS_NT, 2) dsconv_i8_cluster(DsArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int ranks = static_cast<int>(cl.num_blocks());
  const int rank = static_cast<int>(cl.block_rank()), b = blockIdx.y;
  const int H = a.H, W = a.W, C = a.C, F = a.F, s = a.stride;
  const int Ho = H / s, Wo = W / s, WP = W + 2, cq = C / 4;
  const DsLayout l = ds_layout(H, W, C, F, s, ranks, EMIT);
  const int qp = l.qp, o0 = rank * l.rows;
  const int P = max(0, min(l.rows, Ho - o0)) * Wo;   // this rank's pixels
  const int nin = (l.rows - 1) * s + 3, ir0 = o0 * s + s - 2;
  int8_t* xin = reinterpret_cast<int8_t*>(smem);
  int8_t* yq = xin;
  float* dwf = reinterpret_cast<float*>(smem + l.dwf);
  int8_t* pwr = reinterpret_cast<int8_t*>(smem + l.pwr);
  int8_t* pwt = reinterpret_cast<int8_t*>(smem + l.pwt);
  int8_t* taps = reinterpret_cast<int8_t*>(smem + l.taps);
  float* par = reinterpret_cast<float*>(smem + l.par);
  float* red = reinterpret_cast<float*>(smem + l.red);
  const int tid = threadIdx.x;
  const float xsb = a.xs[b];
  i8mma::cluster_arrive();

  // every load in flight at once: the input rows (zeros outside the
  // image), the taps and the 1x1 weights (16 bytes a copy), the scales and
  // biases
  const int8_t* xb = a.x + (size_t)b * H * W * C;
  if (aligned16(a.x) && aligned16(a.dw) && aligned16(a.pw)) {
    const int c16 = C / 16;
#pragma unroll 1
    for (int e = tid; e < nin * WP * c16; e += DS_NT) {
      const int c = 16 * (e % c16), px = e / c16;
      const int ir = ir0 + px / WP, j = px % WP - 1;
      const bool ok = ir >= 0 && ir < H && j >= 0 && j < W;
      i8mma::cp_async_zfill<16>(
          xin + px * C + c, ok ? xb + ((size_t)ir * W + j) * C + c : xb, ok);
    }
#pragma unroll 1
    for (int e = tid; e < (9 * C + C * F) / 16; e += DS_NT) {
      const int o = 16 * e;
      if (o < 9 * C)
        i8mma::cp_async_zfill<16>(taps + o, a.dw + o, true);
      else
        i8mma::cp_async_zfill<16>(pwr + o - 9 * C, a.pw + o - 9 * C, true);
    }
  } else {
#pragma unroll 1
    for (int e = tid; e < nin * WP * C; e += DS_NT) {
      const int c = e % C, px = e / C;
      const int ir = ir0 + px / WP, j = px % WP - 1;
      xin[e] = ir >= 0 && ir < H && j >= 0 && j < W
                   ? xb[((size_t)ir * W + j) * C + c]
                   : int8_t(0);
    }
#pragma unroll 1
    for (int e = tid; e < 9 * C + C * F; e += DS_NT) {
      if (e < 9 * C)
        taps[e] = a.dw[e];
      else
        pwr[e - 9 * C] = a.pw[e - 9 * C];
    }
  }
  i8mma::stage_f32(par, a.dws, C, C);
  i8mma::stage_f32(par + C, a.dwb, C, C);
  i8mma::stage_f32(par + 2 * C, a.pws, F, F);
  i8mma::stage_f32(par + 2 * C + F, a.pwb, F, F);
  i8mma::cp_async_commit();
  i8mma::cp_async_wait_all();
  __syncthreads();

  // pwt[n][k] = pw[k][n]: four k a thread
#pragma unroll 1
  for (int e = tid; e < F * cq; e += DS_NT) {
    const int n = e % F, k = 4 * (e / F);
    *reinterpret_cast<uint32_t*>(pwt + n * qp + k) =
        i8mma::pack4(pwr[k * F + n], pwr[(k + 1) * F + n],
                     pwr[(k + 2) * F + n], pwr[(k + 3) * F + n]);
  }

  // DW 3x3 -> dequant -> Hardswish: a thread takes four channels (one
  // word) of a pixel, the same four for every pixel it takes; with a
  // tap's weight of channel q masked alone into byte q of a word, __dp4a
  // gives that channel's product
  float vmax = 0.0f;
  const int nu = DS_NT - DS_NT % cq;
  if (tid < nu) {
    const int c4 = tid % cq;
    uint32_t w9[9];
#pragma unroll
    for (int t = 0; t < 9; ++t)
      w9[t] = *reinterpret_cast<const uint32_t*>(taps + t * C + 4 * c4);
    float ds[4], db[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      ds[q] = par[4 * c4 + q];
      db[q] = par[C + 4 * c4 + q];
    }
#pragma unroll 1
    for (int p = tid / cq; p < P; p += nu / cq) {
      // output (i, j) of the band: taps on staged rows i*s + dy and
      // columns j*s + s - 1 + dx (the anchor i*s + s - 1 of the image)
      const int i = p / Wo, j = p % Wo;
      const int8_t* xp = xin + ((i * s) * WP + j * s + s - 1) * C + 4 * c4;
      int acc[4] = {0, 0, 0, 0};
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int xw =
              *reinterpret_cast<const int*>(xp + (dy * WP + dx) * C);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[q] = __dp4a(
                xw, static_cast<int>(w9[dy * 3 + dx] & (0xFFu << 8 * q)),
                acc[q]);
        }
      float y[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        y[q] = dequant(acc[q], xsb, ds[q], db[q]);
        if (a.act) y[q] = hswish_rn(y[q]);
        vmax = fmaxf(vmax, fabsf(y[q]));
      }
      *reinterpret_cast<float4*>(dwf + p * C + 4 * c4) =
          make_float4(y[0], y[1], y[2], y[3]);
    }
  }
  // the image's scale: every rank's DW is done once this returns, so the
  // codes may overwrite the input rows
  const float s_dw = scale_of(
      __float_as_uint(i8mma::cluster_max_push(cl, vmax, red, ranks)));

  // requantize the band once (zero rows up to P16)
  const int P16 = round_up(P, 16);
#pragma unroll 1
  for (int e = tid; e < P16 * cq; e += DS_NT) {
    const int c = 4 * (e % cq), p = e / cq;
    uint32_t v = 0;
    if (p < P) {
      const float4 f = *reinterpret_cast<const float4*>(dwf + p * C + c);
      v = i8mma::pack4(quant_i8(f.x, s_dw), quant_i8(f.y, s_dw),
                       quant_i8(f.z, s_dw), quant_i8(f.w, s_dw));
    }
    *reinterpret_cast<uint32_t*>(yq + p * qp + c) = v;
  }
  __syncthreads();

  // the 1x1: a warp takes 16 pixels x up to 32 output channels (four
  // column tiles of 8), K = C in steps of 32 (m16n8k32) and a last 16
  // (m16n8k16); then dequant, and each lane pair swaps a half so a lane
  // stores four consecutive channels of one pixel: to the fp32 map, or
  // emitting to the band's fp32 outputs in shared memory (where the fp32
  // DW band was: its last reads were the requant's, before the barrier)
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int ng = (F + 31) / 32, units = P16 / 16 * ng;
  const bool odd = t & 1;
  float* ob = EMIT ? dwf : a.out + ((size_t)b * Ho + o0) * Wo * F;
  const float* pws = par + 2 * C;
  const float* pwb = pws + F;
#pragma unroll 1
  for (int u = warp; u < units; u += DS_NT / 32) {
    const int mt = u / ng, n0 = 32 * (u % ng), nj = min(4, (F - n0) / 8);
    int acc[4][4];
    i8mma::zero_acc(acc);
    const int8_t* ar = yq + (mt * 16 + g) * qp + 4 * t;
    const int8_t* br = pwt + (n0 + g) * qp + 4 * t;
    int k = 0;
#pragma unroll 1
    for (; k + 32 <= C; k += 32) {
      const uint32_t a0 = *reinterpret_cast<const uint32_t*>(ar + k);
      const uint32_t a1 = *reinterpret_cast<const uint32_t*>(ar + 8 * qp + k);
      const uint32_t a2 = *reinterpret_cast<const uint32_t*>(ar + k + 16);
      const uint32_t a3 =
          *reinterpret_cast<const uint32_t*>(ar + 8 * qp + k + 16);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < nj) {
          const int8_t* bj = br + 8 * j * qp + k;
          i8mma::mma16832(acc[j], a0, a1, a2, a3,
                          *reinterpret_cast<const uint32_t*>(bj),
                          *reinterpret_cast<const uint32_t*>(bj + 16));
        }
    }
    if (k < C) {
      const uint32_t a0 = *reinterpret_cast<const uint32_t*>(ar + k);
      const uint32_t a1 = *reinterpret_cast<const uint32_t*>(ar + 8 * qp + k);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < nj)
          i8mma::mma16816(acc[j], a0, a1,
                          *reinterpret_cast<const uint32_t*>(
                              br + 8 * j * qp + k));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j >= nj) break;
      const int c = n0 + 8 * j + 2 * t;
      const float v0 = dequant(acc[j][0], s_dw, pws[c], pwb[c]);
      const float v1 = dequant(acc[j][1], s_dw, pws[c + 1], pwb[c + 1]);
      const float v2 = dequant(acc[j][2], s_dw, pws[c], pwb[c]);
      const float v3 = dequant(acc[j][3], s_dw, pws[c + 1], pwb[c + 1]);
      // even lanes keep row g and take their neighbour's two columns of
      // it; odd lanes keep row g + 8
      const float x0 = __shfl_xor_sync(0xffffffffu, odd ? v0 : v2, 1);
      const float x1 = __shfl_xor_sync(0xffffffffu, odd ? v1 : v3, 1);
      const int r = mt * 16 + g + (odd ? 8 : 0);
      if (r < P) {
        const float4 v = odd ? make_float4(x0, x1, v2, v3)
                             : make_float4(v0, v1, x0, x1);
        *reinterpret_cast<float4*>(ob + (size_t)r * F + c - (odd ? 2 : 0)) =
            v;
      }
    }
  }
  if constexpr (EMIT) {
    // the band's output absmax (read back from shared memory, so the MMA
    // loop holds no more registers than the plain form's), the image's
    // scale, then the band's codes, 16 bytes a thread where the band's
    // offset allows (F a multiple of 16), else 8, and under keep-fp its
    // fp32 map
    const int n = P * F;
    __syncthreads();
    float omax = 0.0f;
#pragma unroll 1
    for (int e = 4 * tid; e < n; e += 4 * DS_NT) {
      const float4 v = *reinterpret_cast<const float4*>(ob + e);
      omax = fmaxf(omax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                               fmaxf(fabsf(v.z), fabsf(v.w))));
    }
    const float s_out = scale_of(__float_as_uint(
        i8mma::cluster_max_push(cl, omax, red + 64, ranks, false)));
    const size_t o = ((size_t)b * Ho + o0) * Wo * F;
    int8_t* qb = a.q + o;
    const int step = ((reinterpret_cast<uintptr_t>(qb) | n) & 15) ? 8 : 16;
#pragma unroll 1
    for (int e = tid * step; e < n; e += DS_NT * step) {
      uint32_t w[4];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        if (4 * h >= step) break;
        const float4 f = *reinterpret_cast<const float4*>(ob + e + 4 * h);
        w[h] = i8mma::pack4(quant_i8(f.x, s_out), quant_i8(f.y, s_out),
                            quant_i8(f.z, s_out), quant_i8(f.w, s_out));
        if (a.out != nullptr)
          *reinterpret_cast<float4*>(a.out + o + e + 4 * h) = f;
      }
      if (step == 16)
        *reinterpret_cast<uint4*>(qb + e) = make_uint4(w[0], w[1], w[2], w[3]);
      else
        *reinterpret_cast<uint2*>(qb + e) = make_uint2(w[0], w[1]);
    }
    if (rank == 0 && tid == 0) a.scales[b] = s_out;
  }
}

// One launch of the cluster kernel (n: null), or the clusters of `ranks`
// CTAs the card holds at once (into *n, nothing launched).
template <bool EMIT>
static cudaError_t ds_cluster(const DsArgs& a, int B, int ranks,
                              cudaStream_t s, int* n) {
  static size_t granted = 48 * 1024;
  static bool nonportable = false;
  if (a.C % 16 || a.F % 8 || ranks < 1 || ranks > 16)
    return cudaErrorInvalidValue;
  const DsLayout l = ds_layout(a.H, a.W, a.C, a.F, a.stride, ranks, EMIT);
  cudaError_t err = allow_smem(dsconv_i8_cluster<EMIT>, l.total, &granted);
  if (err != cudaSuccess) return err;
  if (ranks > 8 && !nonportable) {
    err = cudaFuncSetAttribute(dsconv_i8_cluster<EMIT>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return err;
    nonportable = true;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3(ranks, B);
  cfg.blockDim = dim3(DS_NT);
  cfg.dynamicSmemBytes = l.total;
  cfg.stream = s;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = ranks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if (n != nullptr)
    return cudaOccupancyMaxActiveClusters(n, dsconv_i8_cluster<EMIT>, &cfg);
  err = cudaLaunchKernelEx(&cfg, dsconv_i8_cluster<EMIT>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// ranks >= 1: the cluster kernel with that many CTAs per image (amax
// unused); ranks == 0: the two passes, with amax holding B words zeroed by
// the wrapper.  A refused launch returns its error; nothing falls back.
REPRO_EXPORT int dsconv_fused_int8_i8(
    const int8_t* x, const float* xs, const int8_t* dw, const float* dws,
    const float* dwb, const int8_t* pw, const float* pws, const float* pwb,
    unsigned int* amax, float* out, int B, int H, int W, int C, int F,
    int stride, int act, int ranks, void* stream) {
  if (ranks > 0) {
    const DsArgs a{x,       xs,      dw, pw, dws, dwb, pws,    pwb,
                   out,     nullptr, nullptr, H, W, C, F, stride, act};
    return (int)ds_cluster<false>(a, B, ranks, (cudaStream_t)stream,
                                  nullptr);
  }
  return (int)dsconv_i8_passes(ActIn{x, xs, nullptr, nullptr}, dw, dws, dwb,
                               pw, pws, pwb, nullptr, out, amax, false, B, H,
                               W, C, F, stride, act, (cudaStream_t)stream);
}

// Shared bytes of one rank of the cluster kernel (emit: its emitting
// form); Python mirror: kernels/dsconv/kernel.py::dsconv_int8_cluster_smem.
REPRO_EXPORT long long dsconv_int8_cluster_smem_c(int H, int W, int C, int F,
                                                  int stride, int ranks,
                                                  int emit) {
  return ds_layout(H, W, C, F, stride, ranks, emit != 0).total;
}

// Clusters of `ranks` CTAs the card holds at once for this shape; for the
// sweep.
REPRO_EXPORT int dsconv_int8_max_active_clusters(int B, int H, int W, int C,
                                                 int F, int stride, int ranks,
                                                 int* n) {
  const DsArgs a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                 nullptr, nullptr, nullptr, nullptr, nullptr, H,
                 W,       C,       F,       stride,  1};
  return (int)ds_cluster<false>(a, B, ranks, nullptr, n);
}

// q (B, Ho, Wo, F) int8; scales (B,).  ranks >= 1: the emitting cluster
// kernel, one launch (amax unused; out the kept fp32 map, or null);
// ranks == 0: the passes, a memset of amax (2 * B words) and three
// launches (out the kept map or scratch).  A refused launch returns its
// error; nothing falls back.
REPRO_EXPORT int dsconv_fused_int8_emit_i8(
    const int8_t* x, const float* xs, const int8_t* dw, const float* dws,
    const float* dwb, const int8_t* pw, const float* pws, const float* pwb,
    unsigned int* amax, float* out, int8_t* q, float* scales, int B, int H,
    int W, int C, int F, int stride, int act, int ranks, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (ranks > 0) {
    const DsArgs a{x,   xs, dw,     pw, dws, dwb, pws, pwb,   out,
                   q,   scales, H,  W,  C,   F,   stride, act};
    return (int)ds_cluster<true>(a, B, ranks, s, nullptr);
  }
  if (amax == nullptr || out == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(unsigned int) * 2 * B, s);
  if (err != cudaSuccess) return (int)err;
  err = dsconv_i8_passes(ActIn{x, xs, nullptr, nullptr}, dw, dws, dwb, pw,
                         pws, pwb, nullptr, out, amax, true, B, H, W, C, F,
                         stride, act, s);
  if (err != cudaSuccess) return (int)err;
  return (int)i8_emit_pass(out, amax + B, q, scales, B,
                           (long long)(H / stride) * (W / stride) * F, s);
}
