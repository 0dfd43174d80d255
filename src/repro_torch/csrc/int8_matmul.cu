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
// int8_matmul (int8_mma_gemm): a BM x BN output tile per CTA, BM in {16,
// 32, 64, 128} and BN in {32, 64, 128}
// (kernels/int8_matmul/kernel.py::int8_gemm_plan picks both from M, N
// and K with a cost model fitted to chip_smoke.py's [int8_matmul sweep]).
// K walks in chunks of up to KC = 512 bytes (every served K is one chunk:
// 128..512): each chunk of both operands arrives as 16-byte cp.async
// copies, every load of a chunk in flight at once: the x rows, the (K, N)
// weights' rows (transposed in shared memory once they are in; stage_wt's
// loads where a ragged N forbids 16-byte copies) and, with the first, the
// tile's scales.  A K longer than one chunk runs a two-stage ring: the
// next chunk's copies fly while this one's products run.  It runs the
// int8 tensor-core tile of int8_mma.cuh (mma.sync m16n8k32) with no sync
// between MMA steps; warps split a chunk's K further when the tile has
// fewer 16 x 32 warp tiles than warps.  The int32 sums meet in a tile in
// shared memory (exact in any order).  The epilogue rounds (acc * xs) *
// ws with __fmul_rn once, on the full sum, in the TPU kernel's order, so
// it equals its plain PyTorch version bit for bit, and stores the tile as
// float4 rows.  One launch, no scratch, no memset, no host
// synchronisation, any K.
//
// int8_matmul_emit keeps the __dp4a tile of int8.cuh: each CTA owns a
// 64 x 64 output tile and loops over K itself.  The emitting TPU kernel
// holds a whole row group with the full N extent in one grid step, so its
// absmax is local; here a group's rows spread over CTAs (196 rows per
// image at S3 of B1@224, 49 at S4, against 64-row tiles), so the group's
// absmax is a cross-CTA reduction: each row's max over the tile's columns
// goes into its own group's word with atomicMax (exact, independent of CTA
// order), and a second pass quantizes.  The epilogue keeps the TPU
// kernel's order (acc * xs) * ws + b, with rounded intrinsics.  The
// emitting variant writes the fp32 output (the kept map, or scratch) and
// reads it back once in its quantize pass.
#include "int8_mma.cuh"

using i8mma::KB;
using i8mma::NT;
using i8mma::panel_pitch;
using i8mma::round_up;

constexpr int KC = 512;  // K bytes of one chunk

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

// Grid (row tiles, column tiles).
__global__ void __launch_bounds__(NT, 2)
    int8_mma_gemm(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ xs, const float* __restrict__ ws,
                  float* __restrict__ out, int M, int N, int K, int bm,
                  int bn) {
  extern __shared__ __align__(16) unsigned char smem[];
  const MmLayout l = mm_layout(K, bm, bn);
  int8_t* Bs = reinterpret_cast<int8_t*>(smem + l.b);
  int* Cs = reinterpret_cast<int*>(smem + l.c);
  float* xss = reinterpret_cast<float*>(smem + l.xs);
  float* wss = reinterpret_cast<float*>(smem + l.ws);
  const int m0 = blockIdx.x * bm, n0 = blockIdx.y * bn;
  const int rows = min(bm, M - m0), cols = min(bn, N - n0);
  const int chunks = (K + l.kc - 1) / l.kc;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool w_async = i8mma::wt_async_ok(w + n0, N, cols);
  // chunk q's x rows and (with w_async) the weights' raw rows, as
  // cp.async into stage q % stages
  auto issue = [=](int q) {
    const int k0 = q * l.kc, kn = min(l.kc, K - k0);
    const int st = q % l.stages;
    i8mma::stage_rows_i8(reinterpret_cast<int8_t*>(smem) + st * l.a, l.pk,
                         x + (size_t)m0 * K + k0, K, rows, kn,
                         round_up(kn, KB));
    if (w_async)
      i8mma::stage_w_raw(
          reinterpret_cast<int8_t*>(smem + l.raw) + st * l.kc * bn, bn,
          w + (size_t)k0 * N + n0, N, kn, cols);
  };
  issue(0);
  i8mma::stage_f32(xss, xs + m0, rows, bm);
  i8mma::stage_f32(wss, ws + n0, cols, bn);
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
      i8mma::stage_wt(Bs, l.pk, w + (size_t)k0 * N + n0, N, kn, cols, bn,
                      kpad);
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

// Pass 1 of int8_matmul_emit: o = ((acc * xs[g]) * ws[n]) + b[n] for the
// row's group g = r / rows; o is written, and each row's absmax over the
// tile's columns is folded into amax[g].
__global__ void __launch_bounds__(GEMM_THREADS)
    int8_matmul_emit_kernel(const int8_t* __restrict__ x,
                            const int8_t* __restrict__ w,
                            const float* __restrict__ xs,
                            const float* __restrict__ ws,
                            const float* __restrict__ bias,
                            float* __restrict__ out,
                            unsigned int* __restrict__ amax, int M, int N,
                            int K, int rows) {
  int acc[4][4];
  gemm_acc_i8(
      M, N, 0, K, [&](int r, int k) { return x[(size_t)r * K + k]; },
      [&](int k, int n) { return w[(size_t)k * N + n]; }, acc);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int m0 = blockIdx.x * GM, n0 = blockIdx.y * GN;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + 16 * i;
    float rmax = 0.0f;
    if (r < M) {
      const float xsg = xs[r / rows];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx + 16 * j;
        if (n < N) {
          const float o = __fadd_rn(
              __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]), xsg), ws[n]),
              bias[n]);
          out[(size_t)r * N + n] = o;
          rmax = fmaxf(rmax, fabsf(o));
        }
      }
    }
    // the 16 threads of one row are 16 consecutive lanes of a warp
    for (int o = 8; o > 0; o >>= 1)
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, o));
    if (tx == 0 && r < M) atomicMax(amax + r / rows, __float_as_uint(rmax));
  }
}

// x (M, K) int8, w (K, N) int8, xs (M / rows,) per-group activation
// scales, ws (N,), bias (N,); out (M, N) fp32 (the kept map or scratch),
// amax (M / rows) words zeroed here, q (M, N) int8, scales (M / rows,).
REPRO_EXPORT int int8_matmul_emit_i8(const int8_t* x, const int8_t* w,
                                     const float* xs, const float* ws,
                                     const float* bias, float* out,
                                     unsigned int* amax, int8_t* q,
                                     float* scales, int M, int N, int K,
                                     int rows, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int G = M / rows;
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(unsigned int) * G, s);
  if (err != cudaSuccess) return (int)err;
  int8_matmul_emit_kernel<<<gemm_grid(M, N, 1), GEMM_THREADS, 0, s>>>(
      x, w, xs, ws, bias, out, amax, M, N, K, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)i8_emit_pass(out, amax, q, scales, G, (long long)rows * N, s);
}
