// Shared FIX8 arithmetic and the int8 tile GEMM of the port's int8 kernels.
//
// Bit-exactness: every fp32 step is an explicitly rounded intrinsic
// (__fmul_rn, __fadd_rn, __fdiv_rn), so nvcc cannot contract a*b+c into
// an FMA.  The plain PyTorch versions run op by op and round after every
// multiply and add; the kernels round at the same places, in the same
// order, and give the same bits.  rintf rounds half to even, as
// torch.round does.  Do not build with --use_fast_math.
#pragma once

#include <cstdint>

#include "common.cuh"

// jax.nn.hard_swish run op by op: x * (relu6(x + 3) / 6).
__device__ __forceinline__ float hswish_rn(float x) {
  return __fmul_rn(
      x, __fdiv_rn(fminf(fmaxf(__fadd_rn(x, 3.0f), 0.0f), 6.0f), 6.0f));
}

// acc * (a * b) + bias: the dequant order of conv2d_int8 and of the TPU
// kernels' conv stages (activation scale times weight scale first).
__device__ __forceinline__ float dequant(int acc, float a, float b,
                                         float bias) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), __fmul_rn(a, b)), bias);
}

// The symmetric scale of a per-image absmax word: max(absmax, 1e-8) / 127.
__device__ __forceinline__ float scale_of(unsigned int absmax_bits) {
  return __fdiv_rn(fmaxf(__uint_as_float(absmax_bits), 1e-8f), 127.0f);
}

// clamp(round(x / scale), -128, 127).
__device__ __forceinline__ int8_t quant_i8(float x, float scale) {
  const float r = rintf(__fdiv_rn(x, scale));
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(r, -128.0f),
                                                    127.0f)));
}

// An int8 activation map entering a conv stage: the codes themselves
// (`q`, with per-image scales `xs`), or an fp32 map (`fp`) quantized as it
// is read, with the per-image scale of its finished absmax words (`amax`).
// The second form is how a requant point folds into the pass that reads
// it: the map is quantized on load, never stored as int8.
struct ActIn {
  const int8_t* q;
  const float* xs;
  const float* fp;
  const unsigned int* amax;
  __device__ __forceinline__ float scale(int b) const {
    return q != nullptr ? xs[b] : scale_of(amax[b]);
  }
  __device__ __forceinline__ int8_t at(size_t i, float s) const {
    return q != nullptr ? q[i] : quant_i8(fp[i], s);
  }
};

// Whole-image requantization across CTAs: the block's max of v >= 0 goes
// into *dst with one atomicMax on its bits (non-negative floats order as
// their bit patterns, so the max is exact and independent of CTA order).
// The wrapper zeroes *dst.  Every thread of the block must call this.
__device__ __forceinline__ void commit_absmax(float v, unsigned int* dst) {
  __shared__ float warp_max[32];
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < static_cast<int>(blockDim.x >> 5) ? warp_max[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) atomicMax(dst, __float_as_uint(v));
  }
}

// ---------------------------------------------------------------------------
// int8 tile GEMM: int8 x int8 -> int32 with __dp4a on CUDA cores
// ---------------------------------------------------------------------------

constexpr int GM = 64, GN = 64, GK = 32;
constexpr int GKP = GK + 4;   // row pitch: int32 loads of 16 rows hit 16 banks
constexpr int GEMM_THREADS = 256;
constexpr int ELEM_THREADS = 256;

// The int32 sums of one GM x GN output tile, rows [blockIdx.x * GM, +GM)
// of R and columns [blockIdx.y * GN, +GN) of N, summed over k in [k_lo,
// k_hi).  a(r, k) and w(k, n) give the int8 operands; this masks the
// ragged rows, columns and k tail with zeros (exact for int32 sums).
// 256 threads, each a 4 x 4 block of outputs strided by 16 so the weight
// reads of a warp fall in distinct banks: acc[i][j] is output (row
// m0 + ty + 16 i, column n0 + tx + 16 j), tx = tid & 15, ty = tid >> 4.
template <typename ALoad, typename WLoad>
__device__ __forceinline__ void gemm_acc_i8(int R, int N, int k_lo, int k_hi,
                                            ALoad a, WLoad w,
                                            int (&acc)[4][4]) {
  __shared__ __align__(16) int8_t As[GM][GKP];
  __shared__ __align__(16) int8_t Ws[GN][GKP];   // transposed: k contiguous
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * GM, n0 = blockIdx.y * GN;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
  for (int k0 = k_lo; k0 < k_hi; k0 += GK) {
    for (int i = tid; i < GM * GK; i += GEMM_THREADS) {
      const int r = i / GK, k = i % GK;
      As[r][k] = (m0 + r < R && k0 + k < k_hi) ? a(m0 + r, k0 + k)
                                               : static_cast<int8_t>(0);
      const int n = i % GN, kk = i / GN;
      Ws[n][kk] = (n0 + n < N && k0 + kk < k_hi) ? w(k0 + kk, n0 + n)
                                                 : static_cast<int8_t>(0);
    }
    __syncthreads();
#pragma unroll
    for (int k4 = 0; k4 < GK / 4; ++k4) {
      int av[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        av[i] = *reinterpret_cast<const int*>(&As[ty + 16 * i][4 * k4]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wv[j] = *reinterpret_cast<const int*>(&Ws[tx + 16 * j][4 * k4]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// gemm_acc_i8's tile, then epi(r, n, acc) on each int32 sum: it returns
// the fp32 value whose magnitude the tile's absmax (the return value)
// tracks.
template <typename ALoad, typename WLoad, typename Epi>
__device__ __forceinline__ float gemm_tile_i8(int R, int N, int k_lo,
                                              int k_hi, ALoad a, WLoad w,
                                              Epi epi) {
  int acc[4][4];
  gemm_acc_i8(R, N, k_lo, k_hi, a, w, acc);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int m0 = blockIdx.x * GM, n0 = blockIdx.y * GN;
  float vmax = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (r < R && n < N) vmax = fmaxf(vmax, fabsf(epi(r, n, acc[i][j])));
    }
  return vmax;
}

// Grid of a per-image GEMM pass: (row tiles, column tiles, images).
static inline dim3 gemm_grid(int R, int N, int B) {
  return dim3((R + GM - 1) / GM, (N + GN - 1) / GN, B);
}

// Grid of a per-image elementwise pass over n elements of each image.
static inline dim3 elem_grid(long long n, int B) {
  return dim3(static_cast<unsigned>((n + ELEM_THREADS - 1) / ELEM_THREADS),
              B);
}

// Per-group act-quant of an fp32 map whose absmax words are final: group
// b is the n contiguous elements from b * n (one image, or one image's
// rows of a GEMM), quantized with scale_of(amax[b]); scales[b] is that
// scale.
__global__ void __launch_bounds__(ELEM_THREADS)
    i8_emit(const float* __restrict__ out,
            const unsigned int* __restrict__ amax_out, int8_t* __restrict__ q,
            float* __restrict__ scales, int n) {
  const int b = blockIdx.y;
  const int idx = blockIdx.x * ELEM_THREADS + threadIdx.x;
  const float s = scale_of(amax_out[b]);
  if (idx < n) q[(size_t)b * n + idx] = quant_i8(out[(size_t)b * n + idx], s);
  if (blockIdx.x == 0 && threadIdx.x == 0) scales[b] = s;
}

static inline cudaError_t i8_emit_pass(const float* out,
                                       const unsigned int* amax, int8_t* q,
                                       float* scales, int B, long long n,
                                       cudaStream_t s) {
  i8_emit<<<elem_grid(n, B), ELEM_THREADS, 0, s>>>(out, amax, q, scales,
                                                   static_cast<int>(n));
  return cudaGetLastError();
}
