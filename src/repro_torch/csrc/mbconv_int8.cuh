// The FIX8 MBConv: int8 PW1 -> dequant -> Hardswish -> requant (whole
// image) -> int32 DW3x3 -> dequant -> stride -> Hardswish -> requant
// (whole image) -> int8 PW2 -> dequant.  Two forms, both on the int8
// tensor-core tile of int8_mma.cuh:
//
// The cluster kernel (mbi8_cluster), one launch per site where one image's
// maps fit a thread-block cluster.  The grid is (rank, image); the ranks
// of an image form one cluster and each owns a slice of the M mid
// channels for every pixel (DW is per channel: no halo).  A rank runs
// PW1 for its slice into an fp32 slice in shared memory, and the cluster
// takes the image's mid absmax from every rank's published CTA max
// through distributed shared memory (max does not depend on order, so the
// scale is exact and the same in every rank); it quantizes its slice once
// (with a zero ring), runs DW, takes the DW absmax the same way and
// quantizes the DW slice once.  PW2 gives each rank a slice of the F
// output columns over the full K = M: its A operand reads the DW codes of
// every rank through DSMEM.  The emitting form takes a third cluster max
// of the output and quantizes it in the same launch.  No scratch map, no
// absmax word in device memory, no zero fill.
//
// The passes (mbconv_i8_passes), for maps that do not fit a cluster and
// for the members of csrc/supersite_int8.cu.  Each requant point is a
// cross-CTA absmax (commit_absmax into a per-image word zeroed before the
// first pass), so a pass ends at each:
//   1. mbi8_gemm<Pw1Epi>: 64 pixels of an image per CTA, all M columns in
//      tiles of 64; its A panel is staged once (quantized once per
//      element when the input is an fp32 boundary map, ActIn).  The
//      epilogue writes the fp32 mid map and folds it into the mid absmax.
//   2. mbi8_dw: a band of output rows x 32 channels per CTA; the band's
//      window of the mid map is quantized once per element into shared
//      memory (zero ring), then DW, dequant, Hardswish; writes the fp32
//      DW map and folds it into the DW absmax.
//   3. mbi8_gemm<Pw2Epi>: as 1 over the DW map quantized with its final
//      scale; the epilogue dequantizes, adds the fp residual `res` when
//      given (res + out, one rounding), writes the fp32 output and, when
//      emitting, folds it into the output absmax.
#pragma once

#include <cooperative_groups.h>

#include "int8_mma.cuh"

namespace cg = cooperative_groups;
using i8mma::KB;
using i8mma::NT;
using i8mma::panel_pitch;
using i8mma::round_up;

// One MBConv site's tensors and shape.  x: the input (int8 codes, or an
// fp32 boundary map quantized on load); res (nullable): the fp residual
// added in the PW2 epilogue (a chain member's; the passes only); q /
// scales (nullable): the emitted int8 output (the cluster kernel only).
struct MbI8Site {
  ActIn x;
  const int8_t *w1, *dw, *w2;
  const float *s1, *b1, *dws, *dwb, *s2, *b2, *res;
  float* out;
  int8_t* q;
  float* scales;
  int H, W, C, M, F, stride;
};

// ---------------------------------------------------------------------------
// the cluster kernel
// ---------------------------------------------------------------------------

// Mid channels per rank: ceil(M / ranks) rounded up to 16 (so a 16-byte
// chunk of the DW codes lies in one rank), and output columns per rank:
// ceil(F / ranks) rounded up to 8 (an MMA tile).
__host__ __device__ inline int cl_mslice(int M, int ranks) {
  return round_up((M + ranks - 1) / ranks, 16);
}
__host__ __device__ inline int cl_fslice(int F, int ranks) {
  return round_up((F + ranks - 1) / ranks, 8);
}

// Shared-memory layout of one rank, in bytes (Python mirror:
// kernels/mbconv/kernel.py::mbconv_int8_cluster_smem).  xa: the input
// panel [P16][px], later the quantized mid slice with its zero ring
// [H+2][W+2][ms] and the DW codes [Po16][ms]; w1t: the PW1 weight slice,
// transposed [ms][px]; midf: the fp32 mid slice [P][ms], later the fp32 DW
// slice [Po][ms] and the fp32 output slice [Po][fs]; w2t: the PW2 weight
// slice, transposed [fs][pm]; dwk: the DW taps [9][ms]; acc: the PW2 int32
// sums [Po16][fs]; red: block-reduction words and the published maxes;
// par: the slices' dequant scales and biases (s1, b1, dws, dwb [ms] each,
// s2, b2 [fs] each).
struct ClLayout {
  int px, pm, w1t, midf, w2t, dwk, acc, red, par, total;
};
__host__ __device__ inline ClLayout cl_layout(int H, int W, int C, int M,
                                              int F, int stride, int ranks) {
  const int ms = cl_mslice(M, ranks), fs = cl_fslice(F, ranks);
  const int P = H * W, Po = (H / stride) * (W / stride);
  const int P16 = round_up(P, 16), Po16 = round_up(Po, 16);
  ClLayout l;
  l.px = panel_pitch(C);
  l.pm = panel_pitch(M);
  const int xa = P16 * l.px, qa = ((H + 2) * (W + 2) + Po16) * ms;
  l.w1t = round_up(xa > qa ? xa : qa, 16);
  l.midf = l.w1t + ms * l.px;
  const int mf = 4 * (P * ms > Po * fs ? P * ms : Po * fs);
  l.w2t = l.midf + round_up(mf, 16);
  l.dwk = l.w2t + fs * l.pm;
  l.acc = l.dwk + round_up(9 * ms, 16);
  l.red = l.acc + 4 * Po16 * fs;
  l.par = l.red + 4 * 40;
  l.total = l.par + 4 * (4 * ms + 2 * fs);
  return l;
}

// The image's max of v >= 0 over the cluster: the CTA's max is published
// in red[34 + slot], every rank reads every rank's word after
// cluster.sync().  Every thread of every rank must call this.
__device__ __forceinline__ float cluster_max(cg::cluster_group& cl, float v,
                                             float* red, int slot,
                                             int ranks) {
  v = i8mma::block_max(v, red);
  if (threadIdx.x == 0) red[34 + slot] = v;
  cl.sync();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float m = lane < ranks ? *cl.map_shared_rank(red + 34 + slot, lane) : 0.f;
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) red[33] = m;
  }
  __syncthreads();
  return red[33];
}

template <bool EMIT>
__global__ void __launch_bounds__(NT, 2) mbi8_cluster(MbI8Site a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int ranks = static_cast<int>(cl.num_blocks());
  const int rank = static_cast<int>(cl.block_rank()), b = blockIdx.y;
  const int H = a.H, W = a.W, C = a.C, M = a.M, F = a.F, s = a.stride;
  const int P = H * W, Wo = W / s, Po = (H / s) * Wo, Wp = W + 2;
  const int Po16 = round_up(Po, 16);
  const int ms = cl_mslice(M, ranks), fs = cl_fslice(F, ranks);
  const ClLayout l = cl_layout(H, W, C, M, F, s, ranks);
  int8_t* xa = reinterpret_cast<int8_t*>(smem);
  int8_t* midq = xa;
  int8_t* dwq = xa + (H + 2) * Wp * ms;
  int8_t* w1t = reinterpret_cast<int8_t*>(smem + l.w1t);
  float* midf = reinterpret_cast<float*>(smem + l.midf);
  int8_t* w2t = reinterpret_cast<int8_t*>(smem + l.w2t);
  int8_t* dwk = reinterpret_cast<int8_t*>(smem + l.dwk);
  int* acc2 = reinterpret_cast<int*>(smem + l.acc);
  float* red = reinterpret_cast<float*>(smem + l.red);
  float* par = reinterpret_cast<float*>(smem + l.par);
  const int m_lo = rank * ms, m_n = min(ms, M - m_lo);
  const int f_lo = rank * fs, f_n = max(0, min(fs, F - f_lo));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kc = round_up(C, KB), km = round_up(M, KB);

  // stage the image, both weight slices and the DW taps
  const float xs = a.x.scale(b);
  i8mma::stage_act(xa, l.px, a.x, (size_t)b * P * C, P, C, kc, xs);
  i8mma::cp_async_commit();
  i8mma::stage_wt(w1t, l.px, a.w1 + m_lo, M, C, m_n, ms, kc);
  i8mma::stage_wt(w2t, l.pm, a.w2 + f_lo, F, M, f_n, fs, km);
#pragma unroll 1
  for (int e = tid; e < 9 * ms; e += NT) {
    const int c = e % ms;
    dwk[e] = c < m_n ? a.dw[(e / ms) * M + m_lo + c] : int8_t(0);
  }
#pragma unroll 1
  for (int e = tid; e < Po16 * fs; e += NT) acc2[e] = 0;
  for (int e = tid; e < 4 * ms + 2 * fs; e += NT) {
    float v = 0.0f;
    if (e < 4 * ms) {
      const int k = e / ms, c = e % ms;
      if (c < m_n)
        v = (k == 0 ? a.s1 : k == 1 ? a.b1 : k == 2 ? a.dws : a.dwb)[m_lo + c];
    } else {
      const int c = (e - 4 * ms) % fs;
      if (c < f_n) v = (e - 4 * ms < fs ? a.s2 : a.b2)[f_lo + c];
    }
    par[e] = v;
  }
  i8mma::cp_async_wait_all();
  __syncthreads();

  // PW1: [P x C] . [C x ms] -> dequant -> Hardswish -> the fp32 mid slice
  float vmax = 0.0f;
  {
    const int ngs = (ms + 31) / 32, units = (P + 15) / 16 * ngs;
#pragma unroll 1
    for (int u = warp; u < units; u += NT / 32) {
      const int mt = u / ngs, ng = u % ngs, nj = min(4, (ms - 32 * ng) / 8);
      int acc[4][4];
      i8mma::zero_acc(acc);
      i8mma::warp_mma<4>(acc, xa + mt * 16 * l.px, l.px,
                         w1t + ng * 32 * l.px, l.px, 0, kc / KB, nj);
      // every value first (straight-line divisions; a pad channel's
      // zero scale and bias give 0), then the stores
      float v[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = min(ng * 32 + 8 * j + 2 * t + (i & 1), ms - 1);
          v[j][i] = hswish_rn(dequant(acc[j][i], xs, par[c], par[ms + c]));
        }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = mt * 16 + g + 8 * (i >> 1);
          const int c = ng * 32 + 8 * j + 2 * t + (i & 1);
          if (j < nj && r < P) {
            midf[r * ms + c] = v[j][i];
            vmax = fmaxf(vmax, fabsf(v[j][i]));
          }
        }
    }
  }
  const float s_mid =
      scale_of(__float_as_uint(cluster_max(cl, vmax, red, 0, ranks)));

  // quantize the mid slice once, into [H+2][W+2][ms] with a zero ring
  const int mq = ms / 4;
#pragma unroll 1
  for (int e = tid; e < (H + 2) * Wp * mq; e += NT) {
    const int c = 4 * (e % mq), pix = e / mq;
    const int pr = pix / Wp - 1, pc = pix % Wp - 1;
    uint32_t v = 0;
    if (pr >= 0 && pr < H && pc >= 0 && pc < W) {
      const float4 f =
          *reinterpret_cast<const float4*>(midf + (pr * W + pc) * ms + c);
      v = i8mma::pack4(quant_i8(f.x, s_mid), quant_i8(f.y, s_mid),
                       quant_i8(f.z, s_mid), quant_i8(f.w, s_mid));
    }
    *reinterpret_cast<uint32_t*>(midq + pix * ms + c) = v;
  }
  __syncthreads();

  // DW 3x3 at the stride anchors s - 1 -> dequant -> Hardswish, 4
  // channels a thread, into the fp32 DW slice (over the dead mid slice)
  float* dwf = midf;
  vmax = 0.0f;
#pragma unroll 1
  for (int e = tid; e < Po * mq; e += NT) {
    const int c = 4 * (e % mq), p = e / mq;
    const int r0 = (p / Wo) * s + s - 1, c0 = (p % Wo) * s + s - 1;
    int acc[4] = {0, 0, 0, 0};
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const uint32_t xv = *reinterpret_cast<const uint32_t*>(
          midq + ((r0 + tap / 3) * Wp + c0 + tap % 3) * ms + c);
      const uint32_t wv =
          *reinterpret_cast<const uint32_t*>(dwk + tap * ms + c);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        acc[k] += static_cast<int>(static_cast<int8_t>(xv >> 8 * k)) *
                  static_cast<int>(static_cast<int8_t>(wv >> 8 * k));
    }
    float y[4];  // a pad channel's zero scale and bias give 0
#pragma unroll
    for (int k = 0; k < 4; ++k)
      y[k] = hswish_rn(dequant(acc[k], s_mid, par[2 * ms + c + k],
                               par[3 * ms + c + k]));
    *reinterpret_cast<float4*>(dwf + p * ms + c) =
        make_float4(y[0], y[1], y[2], y[3]);
#pragma unroll
    for (int k = 0; k < 4; ++k) vmax = fmaxf(vmax, fabsf(y[k]));
  }
  const float s_dw =
      scale_of(__float_as_uint(cluster_max(cl, vmax, red, 1, ranks)));

  // quantize the DW slice once: the codes every rank's PW2 reads
#pragma unroll 1
  for (int e = tid; e < Po16 * mq; e += NT) {
    const int c = 4 * (e % mq), p = e / mq;
    uint32_t v = 0;
    if (p < Po) {
      const float4 f = *reinterpret_cast<const float4*>(dwf + p * ms + c);
      v = i8mma::pack4(quant_i8(f.x, s_dw), quant_i8(f.y, s_dw),
                       quant_i8(f.z, s_dw), quant_i8(f.w, s_dw));
    }
    *reinterpret_cast<uint32_t*>(dwq + p * ms + c) = v;
  }
  cl.sync();

  // PW2: [Po x M] (every rank's codes, through DSMEM) . [M x fs].  Warps
  // split K when there are fewer (row, column) tiles than warps; the
  // int32 sums meet in shared memory (exact in any order).
  {
    const int kbs = km / KB, ngs = (fs + 31) / 32;
    const int tiles = Po16 / 16 * ngs;
    int ks = 1;
    while (tiles * ks * 2 <= NT / 32 && ks * 2 <= kbs) ks *= 2;
#pragma unroll 1
    for (int u = warp; u < tiles * ks; u += NT / 32) {
      const int kq = u % ks, tile = u / ks;
      const int mt = tile / ngs, ng = tile % ngs;
      const int nj = min(4, (fs - 32 * ng) / 8);
      const int rg = (mt * 16 + g) * ms;
      const int8_t* bp = w2t + (ng * 32 + g) * l.pm + 16 * t;
      int acc[4][4];
      i8mma::zero_acc(acc);
      const int kb1 = (kq + 1) * kbs / ks;
      // four K blocks' remote loads in flight before their products
#pragma unroll 1
      for (int kb0 = kq * kbs / ks; kb0 < kb1; kb0 += 4) {
        uint4 lo[4], hi[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int k = KB * (kb0 + u) + 16 * t, q = k / ms;
          lo[u] = hi[u] = make_uint4(0, 0, 0, 0);
          if (kb0 + u < kb1 && q < ranks) {
            const int8_t* src = cl.map_shared_rank(dwq, q) + rg + k % ms;
            lo[u] = i8mma::ld16(src);
            hi[u] = i8mma::ld16(src + 8 * ms);
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (kb0 + u < kb1 && j < nj)
              i8mma::mma_k64(acc[j], lo[u], hi[u],
                             i8mma::ld16(bp + 8 * j * l.pm + KB * (kb0 + u)));
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = mt * 16 + g + 8 * (i >> 1);
          const int c = ng * 32 + 8 * j + 2 * t + (i & 1);
          if (j < nj && r < Po) atomicAdd(acc2 + r * fs + c, acc[j][i]);
        }
    }
  }
  __syncthreads();

  // dequant, the fp32 output and (emitting) its absmax
  float* outf = midf;
  vmax = 0.0f;
#pragma unroll 1
  for (int e = tid; e < Po * f_n; e += NT) {
    const int r = e / f_n, c = e % f_n;
    const float o = dequant(acc2[r * fs + c], s_dw, par[4 * ms + c],
                            par[4 * ms + fs + c]);
    a.out[((size_t)b * Po + r) * F + f_lo + c] = o;
    if (EMIT) outf[r * fs + c] = o;
    vmax = fmaxf(vmax, fabsf(o));
  }
  if (EMIT) {
    const float s_out =
        scale_of(__float_as_uint(cluster_max(cl, vmax, red, 2, ranks)));
#pragma unroll 1
    for (int e = tid; e < Po * f_n; e += NT) {
      const int r = e / f_n, c = e % f_n;
      a.q[((size_t)b * Po + r) * F + f_lo + c] =
          quant_i8(outf[r * fs + c], s_out);
    }
    if (rank == 0 && tid == 0) a.scales[b] = s_out;
  }
  cl.sync();  // every rank's DW codes stay alive until all have read them
}

template <bool EMIT>
static cudaError_t mbi8_cluster_config(const MbI8Site& a, int B, int ranks,
                                       cudaStream_t s,
                                       cudaLaunchConfig_t* cfg,
                                       cudaLaunchAttribute* attr) {
  static size_t granted = 48 * 1024;
  static bool nonportable = false;
  const ClLayout l = cl_layout(a.H, a.W, a.C, a.M, a.F, a.stride, ranks);
  cudaError_t err = allow_smem(mbi8_cluster<EMIT>, l.total, &granted);
  if (err != cudaSuccess) return err;
  if (ranks > 8 && !nonportable) {
    err = cudaFuncSetAttribute(mbi8_cluster<EMIT>,
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

// One launch for B images at `ranks` CTAs per image.  A refused launch
// returns its error; nothing falls back to the passes.
static inline cudaError_t mbconv_i8_cluster(const MbI8Site& a, int B,
                                            int ranks, cudaStream_t s) {
  if (ranks < 1 || cl_mslice(a.M, ranks) * (ranks - 1) >= a.M)
    return cudaErrorInvalidValue;  // a rank would own no mid channel
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err;
  if (a.q != nullptr) {
    err = mbi8_cluster_config<true>(a, B, ranks, s, &cfg, &attr);
    if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, mbi8_cluster<true>, a);
  } else {
    err = mbi8_cluster_config<false>(a, B, ranks, s, &cfg, &attr);
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&cfg, mbi8_cluster<false>, a);
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// How many clusters of `ranks` CTAs the card holds at once for this site
// (cudaOccupancyMaxActiveClusters); 0: such a launch can never run.
static inline cudaError_t mbconv_i8_cluster_occupancy(const MbI8Site& a,
                                                      int B, int ranks,
                                                      bool emit, int* n) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err =
      emit ? mbi8_cluster_config<true>(a, B, ranks, nullptr, &cfg, &attr)
           : mbi8_cluster_config<false>(a, B, ranks, nullptr, &cfg, &attr);
  if (err != cudaSuccess) return err;
  return emit ? cudaOccupancyMaxActiveClusters(n, mbi8_cluster<true>, &cfg)
              : cudaOccupancyMaxActiveClusters(n, mbi8_cluster<false>, &cfg);
}

// ---------------------------------------------------------------------------
// the passes
// ---------------------------------------------------------------------------

constexpr int GROWS = 64;  // pixels (GEMM rows) per CTA of a GEMM pass
constexpr int GEMM_SMEM = 96 * 1024;  // a GEMM pass's budget for its panels
// The most shared memory one CTA may have (227 KB): past it, with the
// whole K of one 64-column weight tile, a pass stages that tile in K
// chunks of GEMM_KCHUNK bytes (K above ~1.7 KB, e.g. B3's S4 at M = 2048).
constexpr int GEMM_SMEM_MAX = 227 * 1024;
constexpr int GEMM_KCHUNK = 512;
constexpr int DW_CC = 32;  // channels per CTA of the DW pass
constexpr int DW_SMEM = 24 * 1024;  // the DW pass's window budget

// Weight columns a GEMM pass stages at once: all N (rounded up to 64)
// where the A panel and they fit GEMM_SMEM, else one tile of 64.
__host__ __device__ inline int gemm_pass_cols(int K, int N) {
  const int n = round_up(N, 64);
  return (GROWS + n) * panel_pitch(K) <= GEMM_SMEM ? n : 64;
}
// The K chunk of a pass's weight tile: 0 (the whole K) where the A panel
// and a 64-column tile of the whole K fit GEMM_SMEM_MAX, else
// GEMM_KCHUNK.
__host__ __device__ inline int gemm_pass_kchunk(int K) {
  return (GROWS + 64) * panel_pitch(K) <= GEMM_SMEM_MAX ? 0 : GEMM_KCHUNK;
}
// Shared bytes of a GEMM pass: the A panel [64][pk] and the staged
// weight columns [cols][pk], or one 64-column tile of a K chunk.
__host__ __device__ inline int gemm_pass_smem(int K, int N) {
  const int kc = gemm_pass_kchunk(K);
  return kc ? GROWS * panel_pitch(K) + 64 * panel_pitch(kc)
            : (GROWS + gemm_pass_cols(K, N)) * panel_pitch(K);
}
// Output rows per CTA of the DW pass: the most (a power of two, at most
// Ho) whose window [(rows - 1) s + 3][W + 2][DW_CC] fits DW_SMEM.
__host__ __device__ inline int dw_pass_rows(int H, int W, int stride) {
  const int Ho = H / stride;
  int rows = 1;
  while (rows * 2 <= Ho &&
         ((rows * 2 - 1) * stride + 3) * (W + 2) * DW_CC <= DW_SMEM)
    rows *= 2;
  return rows;
}
// Shared bytes of the DW pass: the window, the taps [9][DW_CC] and the
// dequant scale and bias of the CTA's channels.
__host__ __device__ inline int dw_pass_smem(int H, int W, int stride) {
  return ((dw_pass_rows(H, W, stride) - 1) * stride + 3) * (W + 2) * DW_CC +
         9 * DW_CC + 2 * 4 * DW_CC;
}

static inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}
// A launch's grid: a pass whose rows (pixels) alone give the card fewer
// than `want` CTAs splits its other dimension further, down to `rows` 1
// (the DW pass's band) or one 64-column tile per CTA (a GEMM pass).  A
// small batch otherwise leaves most SMs idle (S1.mb1 at batch 1: 28 DW
// CTAs of 8 rows).
static inline int dw_launch_rows(int B, int H, int W, int M, int stride) {
  const int Ho = H / stride, chunks = (M + DW_CC - 1) / DW_CC;
  int rows = dw_pass_rows(H, W, stride);
  while (rows > 1 && (Ho + rows - 1) / rows * chunks * B < 2 * sm_count())
    rows /= 2;
  return rows;
}
static inline int gemm_pass_groups(int B, int R, int N) {
  const int tiles = (N + 63) / 64, ctas = (R + GROWS - 1) / GROWS * B;
  int g = 1;
  while (g < tiles && ctas * g < sm_count()) g *= 2;
  return g < tiles ? g : tiles;
}

// A GEMM pass's epilogue: value(b, r, n, acc, scale) is the fp32 output
// of sum acc at (image b, row r, column n), store(b, r, n, v) writes it.
struct Pw1Epi {
  const float *s1, *b1;
  float* mid;
  int M, HW;
  __device__ __forceinline__ float value(int b, int r, int n, int acc,
                                         float sa) const {
    return hswish_rn(dequant(acc, sa, s1[n], b1[n]));
  }
  __device__ __forceinline__ void store(int b, int r, int n, float v) const {
    mid[((size_t)b * HW + r) * M + n] = v;
  }
};

struct Pw2Epi {
  const float *s2, *b2, *res;
  float* out;
  int F, HWo;
  __device__ __forceinline__ float value(int b, int r, int n, int acc,
                                         float sa) const {
    const float o = dequant(acc, sa, s2[n], b2[n]);
    return res != nullptr ? __fadd_rn(res[((size_t)b * HWo + r) * F + n], o)
                          : o;
  }
  __device__ __forceinline__ void store(int b, int r, int n, float v) const {
    out[((size_t)b * HWo + r) * F + n] = v;
  }
};

// A GEMM pass's 64 x 64 output tile at (rows r0.., columns n0..) from
// the warps' sums: every value first (straight-line divisions, edges
// clamped into the map), then the stores of those inside it (rows <
// `rows`, columns < n_hi), their magnitudes folded into vmax.
template <typename Epi>
__device__ __forceinline__ void gemm_pass_out(const Epi& epi,
                                              const int (&acc)[4][4], int b,
                                              int r0, int rows, int n0,
                                              int n_hi, int N, float sa,
                                              float& vmax) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, wm = warp & 3, wn = warp >> 2;
  float v[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[j][i] = epi.value(
          b, r0 + min(wm * 16 + g + 8 * (i >> 1), rows - 1),
          min(n0 + wn * 32 + 8 * j + 2 * t + (i & 1), N - 1), acc[j][i], sa);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = wm * 16 + g + 8 * (i >> 1);
      const int n = n0 + wn * 32 + 8 * j + 2 * t + (i & 1);
      if (r < rows && n < n_hi) {
        epi.store(b, r0 + r, n, v[j][i]);
        vmax = fmaxf(vmax, fabsf(v[j][i]));
      }
    }
}

// A GEMM pass: rows [64 blockIdx.x, +64) of image blockIdx.z of an R x K
// map (ActIn, staged once per CTA: quantized once per element when fp32)
// times the (K, N) weights, column group blockIdx.y of gridDim.y in tiles
// of 64; the epilogue's values are stored and their magnitudes committed
// to amax[b] (when amax is given).  Where a 64-column tile of the whole K
// does not fit beside the A panel (gemm_pass_kchunk), each tile streams
// through shared memory in K chunks (exact int32 sums: the same bits).
// Two CTAs per SM: a register cap for three (80) or four (64) spilled
// (ptxas -v).
template <typename Epi>
__global__ void __launch_bounds__(NT, 2)
    mbi8_gemm(ActIn a, int R, int K, const int8_t* __restrict__ w, int N,
              Epi epi, unsigned int* __restrict__ amax) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int pk = panel_pitch(K), kpad = round_up(K, KB);
  const int kc = gemm_pass_kchunk(K);
  const int cols = kc ? 64 : gemm_pass_cols(K, N);
  int8_t* As = reinterpret_cast<int8_t*>(smem);
  int8_t* Bs = As + GROWS * pk;
  const int b = blockIdx.z, r0 = blockIdx.x * GROWS;
  const int rows = min(GROWS, R - r0);
  const int per = (N + 64 * gridDim.y - 1) / (64 * gridDim.y) * 64;
  const int n_lo = blockIdx.y * per, n_hi = min(N, n_lo + per);
  const float sa = a.scale(b);
  i8mma::stage_act(As, pk, a, ((size_t)b * R + r0) * K, rows, K, kpad, sa);
  i8mma::cp_async_commit();
  const int warp = threadIdx.x >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  float vmax = 0.0f;
  if (kc) {
    const int pc = panel_pitch(kc);
#pragma unroll 1
    for (int n0 = n_lo; n0 < n_hi; n0 += 64) {
      int acc[4][4];
      i8mma::zero_acc(acc);
#pragma unroll 1
      for (int k0 = 0; k0 < K; k0 += kc) {
        const int kn = min(kc, K - k0), knpad = round_up(kn, KB);
        i8mma::stage_wt(Bs, pc, w + (size_t)k0 * N + n0, N, kn,
                        min(64, n_hi - n0), 64, knpad);
        i8mma::cp_async_wait_all();
        __syncthreads();
        i8mma::warp_mma<4>(acc, As + wm * 16 * pk + k0, pk,
                           Bs + wn * 32 * pc, pc, 0, knpad / KB, 4);
        __syncthreads();
      }
      gemm_pass_out(epi, acc, b, r0, rows, n0, n_hi, N, sa, vmax);
    }
  } else {
#pragma unroll 1
    for (int c0 = n_lo; c0 < n_hi; c0 += cols) {
      i8mma::stage_wt(Bs, pk, w + c0, N, K, min(cols, n_hi - c0), cols,
                      kpad);
      i8mma::cp_async_wait_all();
      __syncthreads();
#pragma unroll 1
      for (int n0 = c0; n0 < min(n_hi, c0 + cols); n0 += 64) {
        int acc[4][4];
        i8mma::zero_acc(acc);
        i8mma::warp_mma<4>(acc, As + wm * 16 * pk, pk,
                           Bs + (n0 - c0 + wn * 32) * pk, pk, 0, kpad / KB,
                           4);
        gemm_pass_out(epi, acc, b, r0, rows, n0, n_hi, N, sa, vmax);
      }
      __syncthreads();
    }
  }
  if (amax != nullptr) commit_absmax(vmax, amax + b);
}

// The DW pass: output rows [rows blockIdx.x, +rows) x channels [32
// blockIdx.y, +32) of image blockIdx.z.  Four channels a thread, four
// float4 loads in flight while the window is staged.
__global__ void __launch_bounds__(NT)
    mbi8_dw(const float* __restrict__ mid,
            const unsigned int* __restrict__ amax_mid,
            const int8_t* __restrict__ dw, const float* __restrict__ dws,
            const float* __restrict__ dwb, float* __restrict__ dwo,
            unsigned int* __restrict__ amax_dw, int H, int W, int M,
            int stride, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = stride, Ho = H / s, Wo = W / s, Wp = W + 2;
  const int T0 = (rows - 1) * s + 3;
  int8_t* win = reinterpret_cast<int8_t*>(smem);  // [T][W + 2][DW_CC]
  int8_t* taps = win + T0 * Wp * DW_CC;           // [9][DW_CC]
  float* sc = reinterpret_cast<float*>(taps + 9 * DW_CC);  // scale, bias
  const int b = blockIdx.z, i0 = blockIdx.x * rows, c0 = blockIdx.y * DW_CC;
  const int cc = min(DW_CC, M - c0), nr = min(rows, Ho - i0);
  const int T = (nr - 1) * s + 3, ir0 = i0 * s + s - 2;  // window row 0
  const float s_mid = scale_of(amax_mid[b]);
  const float* mb = mid + (size_t)b * H * W * M + c0;
  for (int e = threadIdx.x; e < 9 * DW_CC; e += NT) {
    const int c = e % DW_CC;
    taps[e] = c < cc ? dw[(e / DW_CC) * M + c0 + c] : int8_t(0);
  }
  if (threadIdx.x < DW_CC) {
    const int c = threadIdx.x;
    sc[c] = c < cc ? dws[c0 + c] : 0.0f;
    sc[DW_CC + c] = c < cc ? dwb[c0 + c] : 0.0f;
  }
  // the window, quantized once per element (zero ring outside the image)
  const int q4 = DW_CC / 4, n4 = T * Wp * q4;
  if (M % 4 == 0) {
#pragma unroll 1
    for (int e0 = threadIdx.x; e0 < n4; e0 += 4 * NT) {
      float4 f[4];
      bool ok[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * NT, c = 4 * (e % q4), pix = e / q4;
        const int ir = ir0 + pix / Wp, jc = pix % Wp - 1;
        ok[u] = e < n4 && c < cc && ir >= 0 && ir < H && jc >= 0 && jc < W;
        f[u] = ok[u] ? *reinterpret_cast<const float4*>(
                           mb + ((size_t)ir * W + jc) * M + c)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * NT;
        if (e < n4)
          *reinterpret_cast<uint32_t*>(win + 4 * e) =
              ok[u] ? i8mma::pack4(quant_i8(f[u].x, s_mid),
                                   quant_i8(f[u].y, s_mid),
                                   quant_i8(f[u].z, s_mid),
                                   quant_i8(f[u].w, s_mid))
                    : 0u;
      }
    }
  } else {
#pragma unroll 1
    for (int e = threadIdx.x; e < T * Wp * DW_CC; e += NT) {
      const int c = e % DW_CC, pix = e / DW_CC;
      const int ir = ir0 + pix / Wp, jc = pix % Wp - 1;
      win[e] = c < cc && ir >= 0 && ir < H && jc >= 0 && jc < W
                   ? quant_i8(mb[((size_t)ir * W + jc) * M + c], s_mid)
                   : int8_t(0);
    }
  }
  __syncthreads();
  float vmax = 0.0f;
#pragma unroll 1
  for (int e = threadIdx.x; e < nr * Wo * q4; e += NT) {
    const int c = 4 * (e % q4), p = e / q4, i = p / Wo, j = p % Wo;
    if (c >= cc) continue;
    int acc[4] = {0, 0, 0, 0};
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const uint32_t xv = *reinterpret_cast<const uint32_t*>(
          win + ((i * s + tap / 3) * Wp + j * s + s - 1 + tap % 3) * DW_CC +
          c);
      const uint32_t wv =
          *reinterpret_cast<const uint32_t*>(taps + tap * DW_CC + c);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        acc[k] += static_cast<int>(static_cast<int8_t>(xv >> 8 * k)) *
                  static_cast<int>(static_cast<int8_t>(wv >> 8 * k));
    }
    float* o = dwo + (((size_t)b * Ho + i0 + i) * Wo + j) * M + c0 + c;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (c + k < cc) {
        const float y = hswish_rn(
            dequant(acc[k], s_mid, sc[c + k], sc[DW_CC + c + k]));
        o[k] = y;
        vmax = fmaxf(vmax, fabsf(y));
      }
  }
  commit_absmax(vmax, amax_dw + b);
}

template <typename Epi>
static cudaError_t launch_gemm_pass(ActIn a, int R, int K, const int8_t* w,
                                    int N, Epi epi, unsigned int* amax, int B,
                                    cudaStream_t s) {
  static size_t granted = 48 * 1024;
  const int smem = gemm_pass_smem(K, N);
  cudaError_t err = allow_smem(mbi8_gemm<Epi>, smem, &granted);
  if (err != cudaSuccess) return err;
  mbi8_gemm<Epi><<<dim3((R + GROWS - 1) / GROWS, gemm_pass_groups(B, R, N),
                       B),
                  NT, smem, s>>>(a, R, K, w, N, epi, amax);
  return cudaGetLastError();
}

// The three passes of one MBConv over B images (amax: 3 * B words, mid,
// DW and output absmax of each image, zeroed by the caller).  mid / dwo:
// fp32 scratch of the mid and DW maps.  `emit` makes PW2 fold its output
// into the output absmax (a.q is not written here).
static inline cudaError_t mbconv_i8_passes(const MbI8Site& a, float* mid,
                                           float* dwo, unsigned int* amax,
                                           bool emit, int B,
                                           cudaStream_t s) {
  const int H = a.H, W = a.W, M = a.M, F = a.F, st = a.stride;
  const int Ho = H / st, Wo = W / st;
  cudaError_t err = launch_gemm_pass(
      a.x, H * W, a.C, a.w1, M, Pw1Epi{a.s1, a.b1, mid, M, H * W}, amax, B,
      s);
  if (err != cudaSuccess) return err;
  const int rows = dw_launch_rows(B, H, W, M, st);
  mbi8_dw<<<dim3((Ho + rows - 1) / rows, (M + DW_CC - 1) / DW_CC, B), NT,
            dw_pass_smem(H, W, st), s>>>(mid, amax, a.dw, a.dws, a.dwb, dwo,
                                         amax + B, H, W, M, st, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_gemm_pass(ActIn{nullptr, nullptr, dwo, amax + B}, Ho * Wo, M,
                          a.w2, F, Pw2Epi{a.s2, a.b2, a.res, a.out, F,
                                          Ho * Wo},
                          emit ? amax + 2 * B : nullptr, B, s);
}
