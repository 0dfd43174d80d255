// mbconv_fused_int8 and mbconv_fused_int8_emit: int8 PW1 -> dequant ->
// Hardswish -> requant (whole image) -> int32 DW3x3 -> dequant -> stride ->
// Hardswish -> requant (whole image) -> int8 PW2 -> dequant, and for the
// emitting variant a per-image act-quant of the output (+ the fp output).
//
// Replaces the TPU kernels repro/kernels/mbconv/kernel.py::mbconv_fused_int8
// and ::mbconv_fused_int8_emit.  Each holds one image per grid step in
// VMEM and requantizes the mid map, the DW output and (emit) the block
// output with one absmax over the image.
//
// Bound on the H100 at B1@224: bytes, by the roofline (an int8 input and
// an fp32 output against a few thousand int8 operations per pixel, below
// the int8 tensor-core ridge of ~590 operations per byte).  In practice
// latency: a served site is a few microseconds of work per image, spread
// over three whole-image requant points.  The dependent chains of the
// IEEE divisions in the requants and in Hardswish (__fdiv_rn, kept for
// bit-exactness) take about a third of a launch, and PW2's DSMEM reads
// most of the rest.  A Hopper CTA has 227 KB of shared memory, so a whole
// image's maps fit one CTA only at the smallest sites; they do fit a
// cluster of up to 16.
//
// Design (mbconv_int8.cuh): where one image's maps fit a cluster and the
// batch's clusters fit the card at once (mbconv_int8_path in
// kernels/mbconv/kernel.py; at B1@224 every served site), one launch:
// the 16 ranks of an image split the mid channels, take each whole-image
// absmax through distributed shared memory, keep the fp32 mid and DW
// slices on chip, and split the output columns for PW2, whose A operand
// reads every rank's DW codes through DSMEM.  The emitting variant
// quantizes its output in the same launch.  Each image's work spreads
// over 16 SMs, two CTAs a SM at batch 8.  Elsewhere the three passes,
// with the fp32 mid and DW maps in device scratch, the absmax words
// zeroed by the wrapper, and i8_emit for the emitting variant.  Both
// GEMMs run on int8 tensor cores (int8_mma.cuh), and every fp32 value is
// quantized once per CTA that reads it.
#include "mbconv_int8.cuh"

// One site over B images.  ranks >= 1: the cluster kernel with that many
// CTAs per image (mid, dwo and amax unused); ranks == 0: the passes, with
// amax holding 3 * B words zeroed by the wrapper.  q and scales are null
// for the plain variant.
REPRO_EXPORT int mbconv_int8_i8(
    const int8_t* x, const float* xs, const int8_t* w1, const float* s1,
    const float* b1, const int8_t* dw, const float* dws, const float* dwb,
    const int8_t* w2, const float* s2, const float* b2, float* mid,
    float* dwo, float* out, unsigned int* amax, int8_t* q, float* scales,
    int B, int H, int W, int C, int M, int F, int stride, int ranks,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const MbI8Site a{ActIn{x, xs, nullptr, nullptr}, w1, dw, w2, s1, b1, dws,
                   dwb, s2, b2, nullptr, out, q, scales, H, W, C, M, F,
                   stride};
  if (ranks > 0) return (int)mbconv_i8_cluster(a, B, ranks, s);
  cudaError_t err = mbconv_i8_passes(a, mid, dwo, amax, q != nullptr, B, s);
  if (err != cudaSuccess || q == nullptr) return (int)err;
  return (int)i8_emit_pass(out, amax + 2 * B, q, scales, B,
                           (long long)(H / stride) * (W / stride) * F, s);
}

// Shared bytes of one CTA of the cluster kernel at `ranks` CTAs per
// image; Python mirror: kernels/mbconv/kernel.py.
REPRO_EXPORT long long mbconv_int8_cluster_smem_c(int H, int W, int C, int M,
                                                  int F, int stride,
                                                  int ranks) {
  return cl_layout(H, W, C, M, F, stride, ranks).total;
}

// The largest shared bytes of one CTA over the three passes.
REPRO_EXPORT long long mbconv_int8_pass_smem_c(int H, int W, int C, int M,
                                               int F, int stride) {
  const int g = max(gemm_pass_smem(C, M), gemm_pass_smem(M, F));
  return max(g, dw_pass_smem(H, W, stride));
}

// Clusters of `ranks` CTAs the card holds at once for this site; for the
// sweep.
REPRO_EXPORT int mbconv_int8_max_active_clusters(int B, int H, int W, int C,
                                                 int M, int F, int stride,
                                                 int ranks, int emit,
                                                 int* n) {
  const MbI8Site a{ActIn{nullptr, nullptr, nullptr, nullptr}, nullptr,
                   nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                   nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                   H, W, C, M, F, stride};
  return (int)mbconv_i8_cluster_occupancy(a, B, ranks, emit != 0, n);
}

// ---------------------------------------------------------------------------
// a test entry point of the int8 tensor-core tile
// ---------------------------------------------------------------------------

// One CTA: A (R x K int8, row-major) times W (K x N int8, row-major)
// through the staging (stage_rows_i8, stage_wt) and MMA tile of
// int8_mma.cuh into out_mma, and the same sums with __dp4a into
// out_dp4a, both (R, N) int32.  R, N <= 64.
__global__ void __launch_bounds__(NT)
    i8mma_selftest(const int8_t* __restrict__ A,
                   const int8_t* __restrict__ W, int* __restrict__ out_mma,
                   int* __restrict__ out_dp4a, int R, int K, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int pk = panel_pitch(K), kpad = round_up(K, KB);
  int8_t* As = reinterpret_cast<int8_t*>(smem);
  int8_t* Bs = As + 64 * pk;
  i8mma::stage_rows_i8(As, pk, A, K, R, K, kpad);
  i8mma::cp_async_commit();
  i8mma::stage_wt(Bs, pk, W, N, K, N, 64, kpad);
  i8mma::cp_async_wait_all();
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, wm = warp & 3, wn = warp >> 2;
  int acc[4][4];
  i8mma::zero_acc(acc);
  i8mma::warp_mma<4>(acc, As + wm * 16 * pk, pk, Bs + wn * 32 * pk, pk, 0,
                     kpad / KB, 4);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = wm * 16 + g + 8 * (i >> 1);
      const int n = wn * 32 + 8 * j + 2 * t + (i & 1);
      if (r < R && n < N) out_mma[r * N + n] = acc[j][i];
    }
  // the __dp4a sums, from the staged panels (k-contiguous on both sides)
  for (int e = threadIdx.x; e < R * N; e += NT) {
    const int r = e / N, n = e % N;
    int v = 0;
    for (int k = 0; k < kpad; k += 4)
      v = __dp4a(*reinterpret_cast<const int*>(As + r * pk + k),
                 *reinterpret_cast<const int*>(Bs + n * pk + k), v);
    out_dp4a[e] = v;
  }
}

REPRO_EXPORT int int8_mma_selftest_i8(const int8_t* A, const int8_t* W,
                                      int* out_mma, int* out_dp4a, int R,
                                      int K, int N, void* stream) {
  if (R < 1 || R > 64 || N < 1 || N > 64 || K < 1)
    return (int)cudaErrorInvalidValue;
  static size_t granted = 48 * 1024;
  const int smem = 2 * 64 * panel_pitch(K);
  cudaError_t err = allow_smem(i8mma_selftest, smem, &granted);
  if (err != cudaSuccess) return (int)err;
  i8mma_selftest<<<1, NT, smem, (cudaStream_t)stream>>>(A, W, out_mma,
                                                        out_dp4a, R, K, N);
  return (int)cudaGetLastError();
}
