// int8_matmul: W8A8 GEMM, int32 sums, epilogue (acc * xs[row]) * ws[col];
// int8_matmul_emit: the same GEMM + bias, then an act-quant of each group
// of `rows` consecutive rows (one image's H*W pixels of a 1x1 conv).
//
// Replace the TPU kernels repro/kernels/int8_matmul/kernel.py::int8_matmul
// and ::int8_matmul_emit, whose grids carry an int32 accumulator in VMEM
// scratch across K steps that run in order.
//
// Bound on the H100 at the MSA projections of B1@224 (K = 128..512):
// bytes, by the roofline: the int8 operands and the fp32 output are a few
// hundred KB to 3 MB against ~10^8 int8 operations, which would take a few
// tenths of a microsecond at 1,979 int8 TOPS.  In practice latency: one
// call is a few microseconds of staging, a handful of MMA steps and one
// store of the output tile per CTA, so the design cuts the round trips
// and barriers on a CTA's path.
//
// The tile (gemm_sums, both kernels): a CTA's int32 sums of a BM x BN
// output tile.  K walks in chunks of up to KC = 512 bytes (every served K
// is one chunk: 128..512): each chunk of both operands arrives as 16-byte
// cp.async copies, every load of a chunk in flight at once: the x rows,
// the (K, N) weights' rows (transposed in shared memory once they are in;
// stage_wt's loads where a ragged N forbids 16-byte copies) and, with the
// first, the tile's scales.  A K longer than one chunk runs a two-stage
// ring: the next chunk's copies fly while this one's products run.  It
// runs the int8 tensor-core tile of int8_mma.cuh (mma.sync m16n8k32) with
// no sync between MMA steps; warps split a chunk's K further when the
// tile has fewer 16 x 32 warp tiles than warps.  The int32 sums meet in a
// tile in shared memory (exact in any order).
//
// int8_matmul (int8_mma_gemm): BM in {16, 32, 64, 128} and BN in {32, 64,
// 128} (kernels/int8_matmul/kernel.py::int8_gemm_plan picks both from M,
// N and K with a cost model fitted to chip_smoke.py's [int8_matmul
// sweep]).  The epilogue rounds (acc * xs) * ws with __fmul_rn once, on
// the full sum, in the TPU kernel's order, so it equals its plain PyTorch
// version bit for bit, and stores the tile as float4 rows.  One launch,
// no scratch, no memset, no host synchronisation, any K.
//
// int8_matmul_emit (int8_emit_gemm): the emitting TPU kernel holds a whole
// row group with the full N extent in one grid step, so its absmax is
// local.  Here one image's int32 sums take 50-301 KB at the served
// shapes, more than a CTA holds at S3's QKV, so a group's tiles (BM and BN
// multiples of 16, kernels/int8_matmul/kernel.py::int8_emit_plan) are the
// ranks of one thread-block cluster, up to 16: each rank computes its
// tile, rounds o = ((acc * xs[g]) * ws) + b in the TPU kernel's order into
// shared memory (and stores it as the kept fp32 map when asked), takes
// its tile's absmax, and i8mma::cluster_max_push gives every rank the
// group's exact absmax (max does not depend on order).  Each rank then
// quantizes its own tile (scale_of, quant_i8 of int8.cuh) and stores the
// codes 16 bytes a thread.  One launch a call: no memset, no atomics, no
// fp32 scratch, no second pass; a cluster per image, so image i's bits do
// not depend on the batch.  Where no cluster holds a group (large images),
// the same kernel runs as a plain grid of the group's tiles: each CTA
// stores o and its tile's max into a (G, tiles) buffer with plain stores
// (nothing to zero, nothing atomic), and i8_emit_tiles reduces a group's
// maxima and quantizes it: two launches.
#include "int8_mma.cuh"

using i8mma::KB;
using i8mma::NT;
using i8mma::panel_pitch;
using i8mma::round_up;

namespace cg = cooperative_groups;

constexpr int KC = 512;  // K bytes of one chunk
constexpr int EMIT_MAX_RANKS = 16;

// Shared-memory layout of one CTA, in bytes (Python mirror:
// kernels/int8_matmul/kernel.py::int8_gemm_smem), for a chunk of kc =
// min(K, KC) bytes of K rounded up to KB, in `stages` = 1 (K is one chunk)
// or 2 (the ring): per stage the A panel [bm][pk] and the weights' raw
// rows [kc][bn] as they arrive; the transposed B panel [bn][pk]; the
// int32 sums [bm][bn + 8] (the pad puts the 8 rows of a fragment store in
// distinct banks); the tile's row and column scales [bm], [bn].
struct MmLayout {
  int kc, stages, pk, a, raw, b, c, cp, xs, ws, total;
};
__host__ __device__ inline MmLayout mm_layout(int K, int bm, int bn) {
  MmLayout l;
  l.kc = round_up(K, KB) < KC ? round_up(K, KB) : KC;
  l.stages = K > KC ? 2 : 1;
  l.pk = panel_pitch(l.kc);
  l.a = bm * l.pk;
  l.raw = l.stages * l.a;
  l.b = l.raw + l.stages * l.kc * bn;
  l.c = l.b + bn * l.pk;
  l.cp = bn + 8;
  l.xs = l.c + 4 * bm * l.cp;
  l.ws = l.xs + 4 * bm;
  l.total = l.ws + 4 * bn;
  return l;
}

// The int32 sums of a rows x cols output tile into the sums region of `l`
// (Cs[r][l.cp]): x points at the tile's first row (rows of K bytes), w at
// its first column of the (K, N) weights.  `scales()` runs in every
// thread after the first chunk's copies are issued, to put the tile's
// scale copies into the same cp.async group.  Returns after a barrier,
// with every sum and scale in shared memory.
template <typename Scales>
__device__ __forceinline__ void gemm_sums(unsigned char* smem,
                                          const MmLayout& l,
                                          const int8_t* __restrict__ x,
                                          const int8_t* __restrict__ w,
                                          int N, int K, int rows, int cols,
                                          int bn, Scales scales) {
  int8_t* Bs = reinterpret_cast<int8_t*>(smem + l.b);
  int* Cs = reinterpret_cast<int*>(smem + l.c);
  const int chunks = (K + l.kc - 1) / l.kc;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool w_async = i8mma::wt_async_ok(w, N, cols);
  // chunk q's x rows and (with w_async) the weights' raw rows, as
  // cp.async into stage q % stages
  auto issue = [=](int q) {
    const int k0 = q * l.kc, kn = min(l.kc, K - k0);
    const int st = q % l.stages;
    i8mma::stage_rows_i8(reinterpret_cast<int8_t*>(smem) + st * l.a, l.pk,
                         x + k0, K, rows, kn, round_up(kn, KB));
    if (w_async)
      i8mma::stage_w_raw(
          reinterpret_cast<int8_t*>(smem + l.raw) + st * l.kc * bn, bn,
          w + (size_t)k0 * N, N, kn, cols);
  };
  issue(0);
  scales();
  i8mma::cp_async_commit();
  // 16 x 32 warp tiles over the valid rows and columns; warps split a
  // chunk's K when there are fewer tiles than warps
  const int mts = (rows + 15) / 16, ngs = (cols + 31) / 32;
  const int tiles = mts * ngs;
  int ks = 1;
  while (tiles * ks * 2 <= NT / 32 && ks * 2 <= l.kc / KB) ks *= 2;
  // the sums are stored where one warp owns a tile's whole K, else added
  const bool add = ks > 1 || chunks > 1;
  if (add) {
#pragma unroll 1
    for (int e = tid; e < mts * 16 * l.cp; e += NT) Cs[e] = 0;
  }
#pragma unroll 1
  for (int q = 0; q < chunks; ++q) {
    const int k0 = q * l.kc, kn = min(l.kc, K - k0);
    const int kpad = round_up(kn, KB), nkb = kpad / KB, st = q % l.stages;
    if (q + 1 < chunks) {
      issue(q + 1);
      i8mma::cp_async_commit();
      i8mma::cp_async_wait_one();
    } else {
      i8mma::cp_async_wait_all();
    }
    if (!w_async)
      i8mma::stage_wt(Bs, l.pk, w + (size_t)k0 * N, N, kn, cols, bn, kpad);
    __syncthreads();
    if (w_async) {
      i8mma::transpose_wt(
          Bs, l.pk,
          reinterpret_cast<const int8_t*>(smem + l.raw) + st * l.kc * bn, bn,
          kn, cols, bn, kpad);
      __syncthreads();
    }
    const int8_t* As = reinterpret_cast<const int8_t*>(smem) + st * l.a;
#pragma unroll 1
    for (int u = warp; u < tiles * ks; u += NT / 32) {
      const int kq = u % ks, tile = u / ks;
      const int mt = tile / ngs, ng = tile % ngs;
      const int nj = min(4, (cols - 32 * ng + 7) / 8);
      int acc[4][4];
      i8mma::zero_acc(acc);
      i8mma::warp_mma<4>(acc, As + mt * 16 * l.pk, l.pk,
                         Bs + ng * 32 * l.pk, l.pk, kq * nkb / ks,
                         (kq + 1) * nkb / ks, nj);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int* c = Cs + (mt * 16 + g + 8 * h) * l.cp + ng * 32 + 8 * j + 2 * t;
          if (j < nj) {
            if (!add) {
              *reinterpret_cast<int2*>(c) =
                  make_int2(acc[j][2 * h], acc[j][2 * h + 1]);
            } else if (ks == 1) {
              int2 v = *reinterpret_cast<int2*>(c);
              v.x += acc[j][2 * h];
              v.y += acc[j][2 * h + 1];
              *reinterpret_cast<int2*>(c) = v;
            } else {
              atomicAdd(c, acc[j][2 * h]);
              atomicAdd(c + 1, acc[j][2 * h + 1]);
            }
          }
        }
    }
    // every warp is done with this stage and Bs before they are refilled
    __syncthreads();
  }
}

// Grid (row tiles, column tiles).
__global__ void __launch_bounds__(NT, 2)
    int8_mma_gemm(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ xs, const float* __restrict__ ws,
                  float* __restrict__ out, int M, int N, int K, int bm,
                  int bn) {
  extern __shared__ __align__(16) unsigned char smem[];
  const MmLayout l = mm_layout(K, bm, bn);
  const int* Cs = reinterpret_cast<const int*>(smem + l.c);
  float* xss = reinterpret_cast<float*>(smem + l.xs);
  float* wss = reinterpret_cast<float*>(smem + l.ws);
  const int m0 = blockIdx.x * bm, n0 = blockIdx.y * bn;
  const int rows = min(bm, M - m0), cols = min(bn, N - n0);
  const int tid = threadIdx.x;
  gemm_sums(smem, l, x + (size_t)m0 * K, w + n0, N, K, rows, cols, bn,
            [=] {
              i8mma::stage_f32(xss, xs + m0, rows, bm);
              i8mma::stage_f32(wss, ws + n0, cols, bn);
            });

  // the epilogue: (acc * xs) * ws, stored row by row
  const int c4 = (cols + 3) / 4;
  if (N % 4 == 0) {
#pragma unroll 1
    for (int e = tid; e < rows * c4; e += NT) {
      const int r = e / c4, c = 4 * (e % c4);
      const int4 s = *reinterpret_cast<const int4*>(Cs + r * l.cp + c);
      const float xr = xss[r];
      const float* wv = wss + c;
      *reinterpret_cast<float4*>(out + (size_t)(m0 + r) * N + n0 + c) =
          make_float4(__fmul_rn(__fmul_rn(__int2float_rn(s.x), xr), wv[0]),
                      __fmul_rn(__fmul_rn(__int2float_rn(s.y), xr), wv[1]),
                      __fmul_rn(__fmul_rn(__int2float_rn(s.z), xr), wv[2]),
                      __fmul_rn(__fmul_rn(__int2float_rn(s.w), xr), wv[3]));
    }
  } else {
#pragma unroll 1
    for (int e = tid; e < rows * cols; e += NT) {
      const int r = e / cols, c = e % cols;
      out[(size_t)(m0 + r) * N + n0 + c] = __fmul_rn(
          __fmul_rn(__int2float_rn(Cs[r * l.cp + c]), xss[r]), wss[c]);
    }
  }
}

// x (M, K) int8, w (K, N) int8, xs (M,), ws (N,) -> out (M, N) fp32 over a
// grid of bm x bn tiles.  A refused launch returns its error.
REPRO_EXPORT int int8_matmul_i8(const int8_t* x, const int8_t* w,
                                const float* xs, const float* ws, float* out,
                                int M, int N, int K, int bm, int bn,
                                void* stream) {
  if (bm % 16 || bn % 32 || bm < 16 || bn < 32 || bm > 128 || bn > 128)
    return (int)cudaErrorInvalidValue;
  static size_t granted = 48 * 1024;
  const MmLayout l = mm_layout(K, bm, bn);
  cudaError_t err = allow_smem(int8_mma_gemm, l.total, &granted);
  if (err != cudaSuccess) return (int)err;
  int8_mma_gemm<<<dim3((M + bm - 1) / bm, (N + bn - 1) / bn), NT, l.total,
                  (cudaStream_t)stream>>>(x, w, xs, ws, out, M, N, K, bm, bn);
  return (int)cudaGetLastError();
}

// Shared bytes of one CTA at (bm, bn); Python mirror:
// kernels/int8_matmul/kernel.py::int8_gemm_smem.
REPRO_EXPORT long long int8_matmul_smem_c(int K, int bm, int bn) {
  return mm_layout(K, bm, bn).total;
}

// ---------------------------------------------------------------------------
// int8_matmul_emit
// ---------------------------------------------------------------------------

// mm_layout's regions (the row scales' unused), then the bias [bn] and 64
// reduction words (Python mirror: kernels/int8_matmul/kernel.py::
// int8_emit_smem).  The sums region later holds o.
struct EmLayout {
  MmLayout mm;
  int bias, red, total;
};
__host__ __device__ inline EmLayout em_layout(int K, int bm, int bn) {
  EmLayout l;
  l.mm = mm_layout(K, bm, bn);
  l.bias = l.mm.total;
  l.red = l.bias + 4 * bn;
  l.total = l.red + 4 * 64;
  return l;
}

struct EmitArgs {
  const int8_t *x, *w;
  const float *xs, *ws, *bias;   // bias may be null (no add)
  float* out;      // the kept fp32 map (cluster: or null), or scratch
  int8_t* q;
  float* scales;
  float* tmax;     // plain grid: each tile's absmax, (G, tiles)
  int N, K, rows, xs_stride, bm, bn, tn;   // tn: column tiles a group
};

// Grid (tiles of a group, groups); CLUSTER: the group's tiles are one
// cluster.  Tile `blockIdx.x` is row tile / tn, column tile % tn.
template <bool CLUSTER>
__global__ void __launch_bounds__(NT, 2) int8_emit_gemm(const EmitArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (CLUSTER) i8mma::cluster_arrive();
  const EmLayout l = em_layout(a.K, a.bm, a.bn);
  const int tile = blockIdx.x, gi = blockIdx.y, tid = threadIdx.x;
  const int tm = tile / a.tn, r0 = tm * a.bm, n0 = (tile - tm * a.tn) * a.bn;
  const int rows = max(0, min(a.bm, a.rows - r0));
  const int cols = max(0, min(a.bn, a.N - n0));
  const size_t m0 = (size_t)gi * a.rows + r0;
  const int N = a.N, cp = l.mm.cp;
  const float* wss = reinterpret_cast<const float*>(smem + l.mm.ws);
  const float* bs = reinterpret_cast<const float*>(smem + l.bias);
  float* red = reinterpret_cast<float*>(smem + l.red);
  float* os = reinterpret_cast<float*>(smem + l.mm.c);   // o over its sum
  const bool has_bias = a.bias != nullptr;
  float* ws_dst = reinterpret_cast<float*>(smem + l.mm.ws);
  float* b_dst = reinterpret_cast<float*>(smem + l.bias);
  const float* ws_src = a.ws + n0;
  const float* b_src = a.bias + (has_bias ? n0 : 0);
  const int bn = a.bn;
  // the group's activation scale, loaded while the tile is staged
  const float xg = __ldg(a.xs + (size_t)gi * a.xs_stride);
  gemm_sums(smem, l.mm, a.x + m0 * a.K, a.w + n0, N, a.K, rows, cols, bn,
            [=] {
              i8mma::stage_f32(ws_dst, ws_src, cols, bn);
              if (has_bias) i8mma::stage_f32(b_dst, b_src, cols, bn);
            });

  // o = ((acc * xs) * ws) + b, a quad of columns an item, into shared
  // memory over its own sum, and to the kept map; the tile's absmax
  const int c4 = (cols + 3) / 4;
  const bool fp4 = N % 4 == 0;
  float vmax = 0.f;
#pragma unroll 1
  for (int e = tid; e < rows * c4; e += NT) {
    const int r = e / c4, c = 4 * (e - r * c4);
    float* o = os + r * cp + c;
    const int4 s = *reinterpret_cast<const int4*>(o);
    const int sv[4] = {s.x, s.y, s.z, s.w};
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = __fmul_rn(__fmul_rn(__int2float_rn(sv[i]), xg), wss[c + i]);
      if (has_bias) v[i] = __fadd_rn(v[i], bs[c + i]);
      if (c + i < cols) vmax = fmaxf(vmax, fabsf(v[i]));
    }
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    if (a.out != nullptr) {
      float* dst = a.out + (m0 + r) * N + n0 + c;
      if (fp4 && c + 4 <= cols) {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (c + i < cols) dst[i] = v[i];
      }
    }
  }

  if constexpr (CLUSTER) {
    cg::cluster_group cl = cg::this_cluster();
    const float s = scale_of(__float_as_uint(
        i8mma::cluster_max_push(cl, vmax, red, gridDim.x)));
    if (tile == 0 && tid == 0) a.scales[gi] = s;
    // the codes, 16 columns an item: one 16-byte store where N allows
    const int c16 = (cols + 15) / 16;
    const bool q16 = N % 16 == 0;
#pragma unroll 1
    for (int e = tid; e < rows * c16; e += NT) {
      const int r = e / c16, c = 16 * (e - r * c16);
      const float* o = os + r * cp + c;
      int8_t* dst = a.q + (m0 + r) * N + n0 + c;
      if (q16 && c + 16 <= cols) {
        uint32_t wv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 f = *reinterpret_cast<const float4*>(o + 4 * j);
          wv[j] = i8mma::pack4(quant_i8(f.x, s), quant_i8(f.y, s),
                               quant_i8(f.z, s), quant_i8(f.w, s));
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(wv[0], wv[1], wv[2],
                                                    wv[3]);
      } else {
#pragma unroll 1
        for (int i = 0; i < 16 && c + i < cols; ++i)
          dst[i] = quant_i8(o[i], s);
      }
    }
  } else {
    const float m = i8mma::block_max(vmax, red);
    if (tid == 0) a.tmax[(size_t)gi * gridDim.x + tile] = m;
  }
}

// The plain grid's second launch: group b's scale from its tiles' maxima
// tmax[b][0, tiles), then its n elements of `out` quantized.
__global__ void __launch_bounds__(ELEM_THREADS)
    i8_emit_tiles(const float* __restrict__ out,
                  const float* __restrict__ tmax, int tiles,
                  int8_t* __restrict__ q, float* __restrict__ scales,
                  long long n) {
  __shared__ float red[33];
  const int b = blockIdx.y;
  float v = 0.f;
#pragma unroll 1
  for (int i = threadIdx.x; i < tiles; i += ELEM_THREADS)
    v = fmaxf(v, tmax[(size_t)b * tiles + i]);
  const float s = scale_of(__float_as_uint(i8mma::block_max(v, red)));
  const long long idx = (long long)blockIdx.x * ELEM_THREADS + threadIdx.x;
  if (idx < n) q[b * n + idx] = quant_i8(out[b * n + idx], s);
  if (blockIdx.x == 0 && threadIdx.x == 0) scales[b] = s;
}

static cudaError_t emit_cluster_config(const EmitArgs& a, int G, int tiles,
                                       cudaStream_t s, cudaLaunchConfig_t* cfg,
                                       cudaLaunchAttribute* attr) {
  static size_t granted = 48 * 1024;
  static bool nonportable = false;
  const int smem = em_layout(a.K, a.bm, a.bn).total;
  cudaError_t err = allow_smem(int8_emit_gemm<true>, smem, &granted);
  if (err != cudaSuccess) return err;
  if (tiles > 8 && !nonportable) {
    err = cudaFuncSetAttribute(int8_emit_gemm<true>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return err;
    nonportable = true;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(tiles, G);
  cfg->blockDim = dim3(NT);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = tiles;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

static bool emit_tile_ok(int bm, int bn) {
  return bm >= 16 && bn >= 16 && bm % 16 == 0 && bn % 16 == 0;
}

// x (M, K) int8, w (K, N) int8, xs: one activation scale per group of
// `rows` rows, xs_stride floats apart (0: one scale for all), ws (N,),
// bias (N,) or null -> q (M, N) int8, scales (M / rows,).  Tiles bm x bn
// (multiples of 16).  cluster: one launch, the group's tiles one cluster
// (at most 16), out the kept fp32 map or null, tmax unused.  Else the
// plain grid and i8_emit_tiles, two launches: out the kept map or
// scratch (M, N), tmax (M / rows, tiles).  A refused launch returns its
// error; nothing falls back.
REPRO_EXPORT int int8_matmul_emit_i8(const int8_t* x, const int8_t* w,
                                     const float* xs, int xs_stride,
                                     const float* ws, const float* bias,
                                     float* out, float* tmax, int8_t* q,
                                     float* scales, int M, int N, int K,
                                     int rows, int bm, int bn, int cluster,
                                     void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (!emit_tile_ok(bm, bn) || rows < 1 || M % rows)
    return (int)cudaErrorInvalidValue;
  const int G = M / rows, tn = (N + bn - 1) / bn;
  const int tiles = (rows + bm - 1) / bm * tn;
  const EmitArgs a{x, w, xs, ws, bias, out, q, scales, tmax,
                   N, K, rows, xs_stride, bm, bn, tn};
  if (cluster) {
    if (tiles > EMIT_MAX_RANKS) return (int)cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t err = emit_cluster_config(a, G, tiles, s, &cfg, &attr);
    if (err != cudaSuccess) return (int)err;
    err = cudaLaunchKernelEx(&cfg, int8_emit_gemm<true>, a);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
  }
  if (out == nullptr || tmax == nullptr) return (int)cudaErrorInvalidValue;
  static size_t granted = 48 * 1024;
  const int smem = em_layout(K, bm, bn).total;
  cudaError_t err = allow_smem(int8_emit_gemm<false>, smem, &granted);
  if (err != cudaSuccess) return (int)err;
  int8_emit_gemm<false><<<dim3(tiles, G), NT, smem, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long n = (long long)rows * N;
  i8_emit_tiles<<<elem_grid(n, G), ELEM_THREADS, 0, s>>>(out, tmax, tiles, q,
                                                         scales, n);
  return (int)cudaGetLastError();
}

// Shared bytes of one CTA of int8_emit_gemm at (bm, bn); Python mirror:
// kernels/int8_matmul/kernel.py::int8_emit_smem.
REPRO_EXPORT long long int8_emit_smem_c(int K, int bm, int bn) {
  return em_layout(K, bm, bn).total;
}

// The clusters of the emitting kernel's group tiles at (bm, bn) the card
// holds at once, into *n (nothing launched).
REPRO_EXPORT int int8_emit_max_active_clusters(int M, int N, int K, int rows,
                                               int bm, int bn, int* n) {
  if (!emit_tile_ok(bm, bn) || rows < 1 || M % rows)
    return (int)cudaErrorInvalidValue;
  const int tn = (N + bn - 1) / bn, tiles = (rows + bm - 1) / bm * tn;
  if (tiles > EMIT_MAX_RANKS) return (int)cudaErrorInvalidValue;
  const EmitArgs a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                   nullptr, nullptr, nullptr, N, K, rows, 0, bm, bn, tn};
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = emit_cluster_config(a, M / rows, tiles, nullptr, &cfg,
                                        &attr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveClusters(n, int8_emit_gemm<true>, &cfg);
}
