// group_agg_int8: one FIX8 MSA aggregation branch.  int32 depthwise SxS
// over the int8 QKV map -> dequant -> requant (whole image) -> grouped 1x1
// (groups of d channels) with int32 sums -> dequant.
//
// Replaces the TPU kernel repro/kernels/group_conv/kernel.py::group_agg_int8,
// which holds one image per grid step and runs the grouped 1x1 as ONE
// dense (C, C) block-diagonal matmul on the MXU (768 x 768 at S4 of
// B1@224, 94 % zeros).
//
// Bound on the H100 at B1@224 ((B,14,14,384) and (B,7,7,768), S = 5,
// d = 16): bytes.  Per image the int8 input is 75 / 38 KB and the fp32
// output 301 / 151 KB, against 25 + 16 MACs per element.  In practice
// latency: a few microseconds of work per image around one whole-image
// requant.
//
// The cluster kernel (group_agg_cluster), one launch per call where an
// image's channel slices fit a cluster (kernels/group_conv/kernel.py::
// group_agg_path; every B1 shape at 192-384 px): grid (rank, image), the
// R ranks of an image one cluster, each owning whole groups of d channels.
// A rank stages its channel slice of the image with cp.async, computes
// the DW stage + dequant once per element into an fp32 slice in shared
// memory (__dp4a over zero-ringed channel planes, see below), and takes the image's absmax as the max of the ranks' CTA
// maxima, each pushed to every rank through distributed shared memory
// (max does not depend on order: the scale is exact and the same in every
// rank).  It requantizes its slice once (__fdiv_rn, as the plain version
// divides) and runs its groups' 1x1 on int8 tensor cores, mma.sync
// m16n8k16: K = 16 is one group (d = 16), so none of the dense
// block-diagonal's zeros is multiplied.  Groups never cross ranks, so no
// rank reads another's codes; no global atomic, no zero fill, no second
// launch.
//
// The two-launch kernel, for maps whose slices fit no cluster (S3 of B1
// from 640 px) and for a group size that is not a multiple of 16:
//   1. group_agg_dw_absmax: the DW stage for every element, folded into
//      the image's absmax word (commit_absmax, zeroed by the wrapper).
//   2. group_agg_pw: grouped __dp4a GEMM tiles (64 pixels x 64 channels,
//      image) whose A operand recomputes the DW stage from the int8 input
//      and quantizes it with the final scale; the weights of other groups
//      read as zero inside the tile's 64 input channels.
#include "int8_mma.cuh"

namespace cg = cooperative_groups;
using i8mma::NT;
using i8mma::round_up;

// The DW stage runs on __dp4a: each channel's slice is transposed into a
// plane [H + S - 1][Wq] (rows of pixels, a zero ring, the image's column j
// at plane column j + 4), so the S taps of one output row are S
// consecutive bytes; a thread takes one channel and four output columns,
// loads 16 bytes of a plane row once for all four, and cuts each
// output's taps out of them with funnel shifts: one __dp4a per 4 taps
// (the weights of the taps past S are zero).
__host__ __device__ constexpr int ga_nw(int S) { return (S + 3) / 4; }
// Plane row length (4 pad columns, the image, then room for the last
// column group's 16-byte window) and plane stride: an odd number of words,
// so the 32 lanes of a warp (32 channels) read 32 distinct banks.
__host__ __device__ inline int ga_wq(int W) { return 4 * ((W - 1) / 4) + 16; }
__host__ __device__ inline int ga_plane(int H, int W, int S) {
  const int n = (H + S - 1) * ga_wq(W);
  return n / 4 % 2 ? n : n + 4;
}

// Shared-memory layout of one rank of the cluster kernel, in bytes (Python
// mirror: kernels/group_conv/kernel.py::group_agg_cluster_smem).  cs =
// C / ranks channels a rank.  xt: the channels' planes [cs][plane], later
// the requantized DW codes yq [P16][qp] (qp: cs, or cs + 16 where cs / 16
// is even, so the eight rows of an A fragment load fall in distinct
// banks); dwf: the fp32 DW slice [P][cs], before it the input slice as
// it arrives [P][cs]; pwt: the 1x1 weights of the rank's groups,
// transposed [cs][d] (k contiguous); pwr: the same weights' raw rows
// [d][cs]; taps: the DW taps [S*S][cs] as they arrive; tw: the taps of
// each plane row as __dp4a words [S][nw][cs]; par: the slice's dws, dwb,
// pws, pwb [cs] each; red: 64 words for the block and cluster
// reductions.
struct GaLayout {
  int cs, qp, dwf, pwt, pwr, taps, tw, par, red, total;
};
__host__ __device__ inline GaLayout ga_layout(int H, int W, int C, int d,
                                              int S, int ranks) {
  GaLayout l;
  l.cs = C / ranks;
  l.qp = l.cs / 16 % 2 ? l.cs : l.cs + 16;
  const int yq = round_up(H * W, 16) * l.qp, xt = l.cs * ga_plane(H, W, S);
  l.dwf = round_up(yq > xt ? yq : xt, 16);
  l.pwt = l.dwf + 4 * H * W * l.cs;
  l.pwr = l.pwt + l.cs * d;
  l.taps = l.pwr + l.cs * d;
  l.tw = l.taps + round_up(S * S * l.cs, 16);
  l.par = l.tw + 4 * S * ga_nw(S) * l.cs;
  l.red = l.par + 4 * 4 * l.cs;
  l.total = l.red + 4 * 64;
  return l;
}

struct GaArgs {
  const int8_t* x;
  const float* xs;
  const int8_t *dw, *pw;
  const float *dws, *dwb, *pws, *pwb;
  float* out;
  int H, W, C, d;
};

template <int S>
__global__ void __launch_bounds__(NT, 2) group_agg_cluster(GaArgs a) {
  constexpr int p = S / 2, NW = ga_nw(S);
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int ranks = static_cast<int>(cl.num_blocks());
  const int rank = static_cast<int>(cl.block_rank()), b = blockIdx.y;
  const int H = a.H, W = a.W, C = a.C, d = a.d;
  const int P = H * W, ng = (W + 3) / 4, Wq = ga_wq(W);
  const int PS = ga_plane(H, W, S);
  const GaLayout l = ga_layout(H, W, C, d, S, ranks);
  const int cs = l.cs, qp = l.qp, c_lo = rank * cs, cq = cs / 4;
  int8_t* xt = reinterpret_cast<int8_t*>(smem);
  int8_t* yq = xt;
  float* dwf = reinterpret_cast<float*>(smem + l.dwf);
  int8_t* raw = reinterpret_cast<int8_t*>(dwf);
  int8_t* pwt = reinterpret_cast<int8_t*>(smem + l.pwt);
  int8_t* pwr = reinterpret_cast<int8_t*>(smem + l.pwr);
  int8_t* taps = reinterpret_cast<int8_t*>(smem + l.taps);
  uint32_t* tw = reinterpret_cast<uint32_t*>(smem + l.tw);
  float* par = reinterpret_cast<float*>(smem + l.par);
  float* red = reinterpret_cast<float*>(smem + l.red);
  const int tid = threadIdx.x;
  const float xsb = a.xs[b];
  i8mma::cluster_arrive();

  // every load in flight at once: the image's channel slice, the taps
  // and the 1x1 weights' rows (16 bytes a copy), the scales and biases
  const int8_t* xb = a.x + (size_t)b * P * C + c_lo;
  if ((reinterpret_cast<uintptr_t>(a.x) | reinterpret_cast<uintptr_t>(a.dw) |
       reinterpret_cast<uintptr_t>(a.pw) | C) % 16 == 0) {
    const int n16 = cs / 16;
#pragma unroll 1
    for (int e = tid; e < (P + S * S + d) * n16; e += NT) {
      const int row = e / n16, c = 16 * (e % n16);
      if (row < P)
        i8mma::cp_async_zfill<16>(raw + row * cs + c, xb + (size_t)row * C + c,
                                  true);
      else if (row < P + S * S)
        i8mma::cp_async_zfill<16>(taps + (row - P) * cs + c,
                                  a.dw + (size_t)(row - P) * C + c_lo + c,
                                  true);
      else
        i8mma::cp_async_zfill<16>(
            pwr + (row - P - S * S) * cs + c,
            a.pw + (size_t)(row - P - S * S) * C + c_lo + c, true);
    }
  } else {
#pragma unroll 1
    for (int e = tid; e < (P + S * S + d) * cs; e += NT) {
      const int row = e / cs, c = e % cs;
      if (row < P)
        raw[e] = xb[(size_t)row * C + c];
      else if (row < P + S * S)
        taps[e - P * cs] = a.dw[(size_t)(row - P) * C + c_lo + c];
      else
        pwr[e - (P + S * S) * cs] =
            a.pw[(size_t)(row - P - S * S) * C + c_lo + c];
    }
  }
  i8mma::stage_f32(par, a.dws + c_lo, cs, cs);
  i8mma::stage_f32(par + cs, a.dwb + c_lo, cs, cs);
  i8mma::stage_f32(par + 2 * cs, a.pws + c_lo, cs, cs);
  i8mma::stage_f32(par + 3 * cs, a.pwb + c_lo, cs, cs);
  i8mma::cp_async_commit();
  // the planes' zero ring (their interiors are overwritten below)
#pragma unroll 1
  for (int e = tid; e < cs * PS / 4; e += NT)
    reinterpret_cast<uint32_t*>(xt)[e] = 0u;
  i8mma::cp_async_wait_all();
  __syncthreads();

  // the slice into planes, four pixels x four channels a thread
#pragma unroll 1
  for (int e = tid; e < H * ng * cq; e += NT) {
    const int c4 = 4 * (e % cq), rest = e / cq;
    const int i = rest / ng, j0 = 4 * (rest % ng);
    uint32_t r[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      r[q] = j0 + q < W ? *reinterpret_cast<const uint32_t*>(
                              raw + (i * W + j0 + q) * cs + c4)
                        : 0u;
    const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
    const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
    const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);
    const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
    int8_t* dst = xt + c4 * PS + (i + p) * Wq + j0 + 4;
    *reinterpret_cast<uint32_t*>(dst) = __byte_perm(t0, t1, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + PS) = __byte_perm(t0, t1, 0x7632);
    *reinterpret_cast<uint32_t*>(dst + 2 * PS) = __byte_perm(t2, t3, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + 3 * PS) = __byte_perm(t2, t3, 0x7632);
  }
  // the taps as __dp4a words: tw[dy][v][c] holds taps 4v..4v+3 of row dy
#pragma unroll 1
  for (int e = tid; e < S * NW * cs; e += NT) {
    const int c = e % cs, dv = e / cs, dy = dv / NW, v = dv % NW;
    uint32_t word = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (4 * v + k < S)
        word |= static_cast<uint32_t>(static_cast<uint8_t>(
                    taps[(dy * S + 4 * v + k) * cs + c]))
                << 8 * k;
    tw[e] = word;
  }
  // pwt[n][k] = pw[k][c_lo + n]: four k a thread
#pragma unroll 1
  for (int e = tid; e < cs * (d / 4); e += NT) {
    const int n = e % cs, k = 4 * (e / cs);
    *reinterpret_cast<uint32_t*>(pwt + n * d + k) =
        i8mma::pack4(pwr[k * cs + n], pwr[(k + 1) * cs + n],
                     pwr[(k + 2) * cs + n], pwr[(k + 3) * cs + n]);
  }
  __syncthreads();

  // DW SxS -> dequant: a thread takes one channel (lanes: consecutive
  // channels) and four output columns of one row
  float vmax = 0.0f;
#pragma unroll 1
  for (int e = tid; e < cs * H * ng; e += NT) {
    const int c = e % cs, rest = e / cs;
    const int i = rest / ng, j0 = 4 * (rest % ng);
    const int8_t* pl = xt + c * PS + i * Wq + j0;
    int acc[4] = {0, 0, 0, 0};
#pragma unroll
    for (int dy = 0; dy < S; ++dy) {
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        w[k] = *reinterpret_cast<const uint32_t*>(pl + dy * Wq + 4 * k);
#pragma unroll
      for (int v = 0; v < NW; ++v) {
        const int wt = static_cast<int>(tw[(dy * NW + v) * cs + c]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // output j0 + q, taps 4v.. start at plane column j0 + q + 4 - p
          const int o = q + 4 - p + 4 * v, wi = o / 4, sh = o % 4;
          const uint32_t xv =
              sh ? __funnelshift_r(w[wi], w[wi + 1], 8 * sh) : w[wi];
          acc[q] = __dp4a(static_cast<int>(xv), wt, acc[q]);
        }
      }
    }
    const float s0 = par[c], b0 = par[cs + c];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (j0 + q < W) {
        const float y = dequant(acc[q], xsb, s0, b0);
        dwf[(i * W + j0 + q) * cs + c] = y;
        vmax = fmaxf(vmax, fabsf(y));
      }
  }
  // the image's scale: every rank's DW is done once this returns, so the
  // codes may overwrite the planes
  const float s_y = scale_of(
      __float_as_uint(i8mma::cluster_max_push(cl, vmax, red, ranks)));

  // requantize the slice once (zero rows up to P16)
  const int P16 = round_up(P, 16);
#pragma unroll 1
  for (int e = tid; e < P16 * cq; e += NT) {
    const int c = 4 * (e % cq), pix = e / cq;
    uint32_t v = 0;
    if (pix < P) {
      const float4 f = *reinterpret_cast<const float4*>(dwf + pix * cs + c);
      v = i8mma::pack4(quant_i8(f.x, s_y), quant_i8(f.y, s_y),
                       quant_i8(f.z, s_y), quant_i8(f.w, s_y));
    }
    *reinterpret_cast<uint32_t*>(yq + pix * qp + c) = v;
  }
  __syncthreads();

  // the grouped 1x1: a warp takes 16 pixels x one group, d / 8 column
  // tiles of 8 over K = d in steps of 16; then dequant and store
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int groups = cs / d, units = P16 / 16 * groups;
  float* ob = a.out + (size_t)b * P * C + c_lo;
#pragma unroll 1
  for (int u = warp; u < units; u += NT / 32) {
    const int mt = u / groups, gi = u % groups;
    const int8_t* ar = yq + (mt * 16 + g) * qp + gi * d + 4 * t;
#pragma unroll 1
    for (int n0 = 0; n0 < d; n0 += 32) {
      const int nj = min(4, (d - n0) / 8);
      int acc[4][4];
      i8mma::zero_acc(acc);
#pragma unroll 1
      for (int k = 0; k < d; k += 16) {
        const uint32_t a0 = *reinterpret_cast<const uint32_t*>(ar + k);
        const uint32_t a1 =
            *reinterpret_cast<const uint32_t*>(ar + 8 * qp + k);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < nj)
            i8mma::mma16816(
                acc[j], a0, a1,
                *reinterpret_cast<const uint32_t*>(
                    pwt + (gi * d + n0 + 8 * j + g) * d + k + 4 * t));
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mt * 16 + g + 8 * h;
          const int c = gi * d + n0 + 8 * j + 2 * t;
          if (j < nj && r < P)
            *reinterpret_cast<float2*>(ob + (size_t)r * C + c) = make_float2(
                dequant(acc[j][2 * h], s_y, par[2 * cs + c],
                        par[3 * cs + c]),
                dequant(acc[j][2 * h + 1], s_y, par[2 * cs + c + 1],
                        par[3 * cs + c + 1]));
        }
    }
  }
}

template <int S>
static cudaError_t ga_cluster_config(const GaArgs& a, int B, int ranks,
                                     cudaStream_t s, cudaLaunchConfig_t* cfg,
                                     cudaLaunchAttribute* attr) {
  static size_t granted = 48 * 1024;
  static bool nonportable = false;
  const GaLayout l = ga_layout(a.H, a.W, a.C, a.d, S, ranks);
  cudaError_t err = allow_smem(group_agg_cluster<S>, l.total, &granted);
  if (err != cudaSuccess) return err;
  if (ranks > 8 && !nonportable) {
    err = cudaFuncSetAttribute(group_agg_cluster<S>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return err;
    nonportable = true;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(ranks, B);
  cfg->blockDim = dim3(NT);
  cfg->dynamicSmemBytes = l.total;
  cfg->stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = ranks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// One launch of the cluster kernel at scale S (n: null), or the clusters
// of `ranks` CTAs the card holds at once (into *n, nothing launched).
template <int S>
static cudaError_t ga_cluster(const GaArgs& a, int B, int ranks,
                              cudaStream_t s, int* n) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = ga_cluster_config<S>(a, B, ranks, s, &cfg, &attr);
  if (err != cudaSuccess) return err;
  if (n != nullptr)
    return cudaOccupancyMaxActiveClusters(n, group_agg_cluster<S>, &cfg);
  err = cudaLaunchKernelEx(&cfg, group_agg_cluster<S>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

static cudaError_t ga_cluster_any(const GaArgs& a, int S, int B, int ranks,
                                  cudaStream_t s, int* n) {
  if (a.d % 16 || a.C % (ranks * a.d) || ranks < 1 || ranks > 16)
    return cudaErrorInvalidValue;
  switch (S) {
    case 1: return ga_cluster<1>(a, B, ranks, s, n);
    case 3: return ga_cluster<3>(a, B, ranks, s, n);
    case 5: return ga_cluster<5>(a, B, ranks, s, n);
    case 7: return ga_cluster<7>(a, B, ranks, s, n);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// the two-launch kernel
// ---------------------------------------------------------------------------

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

// One aggregation branch over B images.  ranks >= 1: the cluster kernel
// with that many CTAs per image (ranks must divide the C / d groups, d a
// multiple of 16, S one of 1, 3, 5, 7; amax unused); ranks == 0: the two
// launches, with amax holding B words zeroed by the wrapper.  A refused
// launch returns its error; nothing falls back.
REPRO_EXPORT int group_agg_int8_i8(const int8_t* x, const float* xs,
                                   const int8_t* dw, const float* dws,
                                   const float* dwb, const int8_t* pw,
                                   const float* pws, const float* pwb,
                                   unsigned int* amax, float* out, int B,
                                   int H, int W, int C, int S, int d,
                                   int ranks, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (ranks > 0) {
    const GaArgs a{x, xs, dw, pw, dws, dwb, pws, pwb, out, H, W, C, d};
    return (int)ga_cluster_any(a, S, B, ranks, s, nullptr);
  }
  if (d <= 0 || GN % d != 0 || C % d != 0) return (int)cudaErrorInvalidValue;
  group_agg_dw_absmax<<<elem_grid((long long)H * W * C, B), ELEM_THREADS, 0,
                        s>>>(x, xs, dw, dws, dwb, amax, H, W, C, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  group_agg_pw<<<gemm_grid(H * W, C, B), GEMM_THREADS, 0, s>>>(
      x, xs, dw, dws, dwb, pw, pws, pwb, amax, out, H, W, C, S, d);
  return (int)cudaGetLastError();
}

// Shared bytes of one rank of the cluster kernel; Python mirror:
// kernels/group_conv/kernel.py::group_agg_cluster_smem.
REPRO_EXPORT long long group_agg_cluster_smem_c(int H, int W, int C, int d,
                                                int S, int ranks) {
  return ga_layout(H, W, C, d, S, ranks).total;
}

// Clusters of `ranks` CTAs the card holds at once for this shape; for the
// sweep.
REPRO_EXPORT int group_agg_max_active_clusters(int B, int H, int W, int C,
                                               int d, int S, int ranks,
                                               int* n) {
  const GaArgs a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                 nullptr, nullptr, nullptr, H, W, C, d};
  return (int)ga_cluster_any(a, S, B, ranks, nullptr, n);
}

// ---------------------------------------------------------------------------
// a test entry point of the m16n8k16 fragment
// ---------------------------------------------------------------------------

// One CTA: A (R x K int8, row-major) times W (K x N int8, row-major), K a
// multiple of 16, staged K-contiguous as the cluster kernel stages its
// codes and weights, into out_mma through mma16816, and the same sums
// with __dp4a into out_dp4a, both (R, N) int32.  R <= 64, N <= 64 a
// multiple of 8, K <= 64.
__global__ void __launch_bounds__(NT)
    mma16816_selftest(const int8_t* __restrict__ A,
                      const int8_t* __restrict__ W, int* __restrict__ out_mma,
                      int* __restrict__ out_dp4a, int R, int K, int N) {
  __shared__ __align__(16) int8_t As[64 * 64], Bs[64 * 64];
  for (int e = threadIdx.x; e < 64 * K; e += NT)
    As[e] = e / K < R ? A[e] : int8_t(0);
  for (int e = threadIdx.x; e < N * K; e += NT)
    Bs[e] = W[(e % K) * N + e / K];  // Bs[n][k]
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // a warp takes 16 rows x 8 columns: warps 0-7 over (4 row, N/8 column)
  // tiles
  for (int u = warp; u < 4 * (N / 8); u += NT / 32) {
    const int mt = u % 4, nt = u / 4;
    int acc[1][4];
    i8mma::zero_acc(acc);
    for (int k = 0; k < K; k += 16)
      i8mma::mma16816(
          acc[0],
          *reinterpret_cast<const uint32_t*>(As + (mt * 16 + g) * K + k +
                                             4 * t),
          *reinterpret_cast<const uint32_t*>(As + (mt * 16 + g + 8) * K + k +
                                             4 * t),
          *reinterpret_cast<const uint32_t*>(Bs + (nt * 8 + g) * K + k +
                                             4 * t));
    for (int i = 0; i < 4; ++i) {
      const int r = mt * 16 + g + 8 * (i >> 1), n = nt * 8 + 2 * t + (i & 1);
      if (r < R) out_mma[r * N + n] = acc[0][i];
    }
  }
  for (int e = threadIdx.x; e < R * N; e += NT) {
    const int r = e / N, n = e % N;
    int v = 0;
    for (int k = 0; k < K; k += 4)
      v = __dp4a(*reinterpret_cast<const int*>(As + r * K + k),
                 *reinterpret_cast<const int*>(Bs + n * K + k), v);
    out_dp4a[e] = v;
  }
}

REPRO_EXPORT int int8_mma16816_selftest_i8(const int8_t* A, const int8_t* W,
                                           int* out_mma, int* out_dp4a,
                                           int R, int K, int N,
                                           void* stream) {
  if (R < 1 || R > 64 || N < 8 || N > 64 || N % 8 || K < 16 || K > 64 ||
      K % 16)
    return (int)cudaErrorInvalidValue;
  mma16816_selftest<<<1, NT, 0, (cudaStream_t)stream>>>(A, W, out_mma,
                                                        out_dp4a, R, K, N);
  return (int)cudaGetLastError();
}
