// supersite_fused: an fp32 chain of consecutive conv sites (MBConv and
// DSConv members, residual adds included) in one launch, NHWC.
//
// Replaces the TPU kernel repro/kernels/supersite/kernel.py::
// supersite_fused, whose grid walks row bands of the chain's output and
// keeps a 32-row band of S1.ss0 (5.45 MB) or all of S2.ss0 (7.41 MB) of
// B1@224 in VMEM.  A Hopper CTA has 227 KB of shared memory: even one
// output row of S1.ss0 needs S1.mb0's 7-row, 114-column padded mid window,
// 204 KB at 64 channels.
//
// Bound on the H100: operations.  The members' 1x1 GEMMs do 2*(C + F)*M
// flops per pixel against a few bytes of chain input and output, far
// above the card's ~20 fp32 flops/byte ridge (67 TFLOP/s over 3.35 TB/s),
// and small bands add recompute on top.
//
// Design: one CTA per (image, band of R output rows of the last member).
// Walking the chain backwards (band_geometry in kernels/supersite/
// kernel.py) gives each member the input window the band needs.  The
// members run in order inside the CTA:
//   - the first member reads its window from device memory in place
//     (zero outside the map); every later member reads the previous
//     member's band output from shared memory;
//   - the DW stage's channels (MBConv: the mid channels after PW1 + bias
//     + Hardswish; DSConv: the input channels) are processed in chunks of
//     block_m into a padded window in shared memory.  Window rows outside
//     the feature map and the column pad ring are ZERO after the
//     activation (hardswish(b1) != 0, and the reference zero-pads the mid
//     map), so a band's halo never sees a neighbour's garbage;
//   - DW 3x3 + bias + Hardswish at the stride-s anchor s - 1 (the
//     reference's SAME anchor), then the 1x1 projection's partial sums,
//     accumulated over chunks in a shared band buffer;
//   - bias, then the residual add (out + input window row + 1), in the
//     band buffer, which is the next member's input; the last member
//     writes its rows straight to the output.
// PW1, DW and the projection are the register-tiled stages of
// mbconv_fp.cuh (4 x 4 FFMA tiles per thread, weights through cp.async),
// the same as mbconv_fused's.  Band buffers ping-pong between two shared
// regions.  Weights are read from the device-memory pack
// (kernels/supersite/pack.py) at the offsets the descriptor carries;
// S2.ss0's pack alone (346 KB) would not fit in shared memory, and every
// CTA reads the same one through L2.  Small bands recompute the halo of
// every member but the last (at R = 1 S1.mb0 computes 3 rows and S2.mb0
// 5 per chain output row).  fp32 FFMA on CUDA cores: TF32 tensor cores
// would break fp32 parity.
#include "mbconv_fp.cuh"

using namespace mbfp;

constexpr int SS_MAX_MEMBERS = 8;
// ints per member in the host descriptor: kind (0 MBConv, 1 DSConv),
// stride, residual, h_in, w_in, c_in, mid, f_out, c0, c1, length, n_out,
// block_m, 6 pack offsets (MBConv w1, b1, dw, dwb, w2, b2 / DSConv dw,
// dwb, pw, pwb).
constexpr int SS_DESC = 19;

struct SsMember {
  int kind, stride, residual, h_in, w_in, c_in, mid, f_out;
  int c0, c1, length, n_out, block_m;
  int off[6];
};

struct SsChain {
  int n;
  SsMember m[SS_MAX_MEMBERS];
};

// Channels of a member's DW stage (MBConv: mid; DSConv: the input's).
__host__ __device__ inline int dw_channels(const SsMember& m) {
  return m.kind == 0 ? m.mid : m.c_in;
}

__global__ void __launch_bounds__(NT, 1)
    supersite_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     float* __restrict__ out,
                     const __grid_constant__ SsChain ch, int h_out,
                     int buf0, int buf1, int x_n) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem + buf0 + buf1;  // PW1 staging | DW result
  float* win = xs + x_n;           // DW window | projection staging
  const int b = blockIdx.y, j = blockIdx.x;

  for (int k = 0; k < ch.n; ++k) {
    const SsMember& m = ch.m[k];
    const int H = m.h_in, W = m.w_in, C = m.c_in, s = m.stride;
    const int Wo = W / s, Wp = W + 2, L = m.length, n = m.n_out;
    const int M = dw_channels(m), F = m.f_out, bm = m.block_m;
    const int r0 = m.c0 + m.c1 * j;   // map row of window row 0
    const int o0 = (r0 + 2 - s) / s;  // map row of output row 0 (exact)
    const int lo = max(0, -r0), hi = min(L, H - r0);  // rows in the map
    const bool mb = m.kind == 0;
    const float* w1 = w + m.off[0];
    const float* b1 = w + m.off[1];
    const float* dww = w + (mb ? m.off[2] : m.off[0]);
    const float* dwb = w + (mb ? m.off[3] : m.off[1]);
    const float* w2 = w + (mb ? m.off[4] : m.off[2]);
    const float* b2 = w + (mb ? m.off[5] : m.off[3]);
    // the input window: the map itself for the first member (row r0 + t),
    // the previous member's band buffer after it (row t)
    const float* xb = x + (size_t)b * H * W * C;
    // band buffers: member k's output in buffer k % 2
    const float* in = (k - 1) & 1 ? smem + buf0 : smem;
    // window pixel q (row lo + q / W) at src + q * C
    const float* src = k > 0 ? in + (size_t)lo * W * C
                             : xb + (size_t)(r0 + lo) * W * C;
    float* acc = k & 1 ? smem + buf0 : smem;  // [n * Wo][F]
    const int P = n * Wo, NQ = (hi - lo) * W, bn2 = pw2_bn(P, F);

    for (int e = threadIdx.x; e < P * F; e += NT) acc[e] = 0.0f;
    for (int m0 = 0; m0 < M; m0 += bm) {
      const int mw = min(bm, M - m0);
      zero_border(win, L, Wp, bm, lo, hi);
      if (mb) {
        // the first member's input is the map in device memory, the
        // others' a band buffer in shared memory
        if (k > 0)
          mbconv_chunk<true>(src, NQ, lo, W, C, M, mw, bm, w1 + m0, b1 + m0,
                             dww + m0, dwb + m0, w2 + (size_t)m0 * F, F, bn2,
                             P, Wo, s, xs, win, acc);
        else
          mbconv_chunk<false>(src, NQ, lo, W, C, M, mw, bm, w1 + m0, b1 + m0,
                              dww + m0, dwb + m0, w2 + (size_t)m0 * F, F, bn2,
                              P, Wo, s, xs, win, acc);
        continue;
      }
      // DSConv: the input chunk itself is the DW stage's window
      for (int e = threadIdx.x; e < NQ * bm; e += NT) {
        const int c = e % bm, q = e / bm;
        win[((size_t)(lo + q / W) * Wp + q % W + 1) * bm + c] =
            c < mw ? src[(size_t)q * C + m0 + c] : 0.0f;
      }
      __syncthreads();
      dw3x3(win, Wp, bm, mw, P, Wo, s, dww + m0, M, dwb + m0, xs);
      __syncthreads();
      const AccEpi add{acc, F};
      MBFP_DISPATCH_BN(bn2, BN,
                       gemm_kmajor<BN>(xs, round4(P), P, mw,
                                       w2 + (size_t)m0 * F, F, F, win, add));
    }
    // bias, residual (stride 1, F == C: input window row r + 1 is map row
    // o0 + r), then the band buffer or, for the last member, the output
    const bool last = k == ch.n - 1;
    for (int idx = threadIdx.x; idx < P * F; idx += NT) {
      const int f = idx % F, p = idx / F;
      const int r = p / Wo, wo = p % Wo, go = o0 + r;
      float v = acc[idx] + __ldg(b2 + f);
      if (m.residual) {
        if (k > 0)
          v += in[((size_t)(r + 1) * W + wo) * C + f];
        else if (go >= 0 && go < H)
          v += xb[((size_t)go * W + wo) * C + f];
      }
      if (!last)
        acc[idx] = v;
      else if (go < h_out)
        out[(((size_t)b * h_out + go) * Wo + wo) * F + f] = v;
    }
    __syncthreads();
  }
}

// Shared memory of one CTA, in floats: the two band buffers (member k's
// output in buffer k % 2), region X (PW1 staging | DW result) and region
// Y (DW window | projection staging), each sized for its largest member
// and a multiple of 4 floats (float4 alignment).
// Python mirror: kernels/supersite/kernel.py::supersite_smem_floats.
static void supersite_smem(const SsChain& ch, int* buf, int* xr, int* yr) {
  buf[0] = buf[1] = *xr = *yr = 0;
  for (int k = 0; k < ch.n; ++k) {
    const SsMember& m = ch.m[k];
    const int P = m.n_out * (m.w_in / m.stride), bm = m.block_m;
    buf[k & 1] = max(buf[k & 1], round4(P * m.f_out));
    *xr = max(*xr, bm * round4(P));
    if (m.kind == 0) *xr = max(*xr, rows_stage_floats(bm));
    *yr = max(*yr, m.length * (m.w_in + 2) * bm);
    *yr = max(*yr, kmajor_stage_floats(pw2_bn(P, m.f_out)));
  }
}

REPRO_EXPORT int supersite_fused_f32(const float* x, const float* w,
                                     float* out, const int* desc,
                                     int n_members, int B, int h_out,
                                     int n_bands, void* stream) {
  if (n_members < 2 || n_members > SS_MAX_MEMBERS)
    return (int)cudaErrorInvalidValue;
  SsChain ch;
  ch.n = n_members;
  for (int k = 0; k < n_members; ++k) {
    const int* d = desc + k * SS_DESC;
    SsMember& m = ch.m[k];
    m.kind = d[0];
    m.stride = d[1];
    m.residual = d[2];
    m.h_in = d[3];
    m.w_in = d[4];
    m.c_in = d[5];
    m.mid = d[6];
    m.f_out = d[7];
    m.c0 = d[8];
    m.c1 = d[9];
    m.length = d[10];
    m.n_out = d[11];
    m.block_m = d[12];
    for (int i = 0; i < 6; ++i) m.off[i] = d[13 + i];
    if (m.block_m != 16 && m.block_m != 32 && m.block_m != 64 &&
        m.block_m != 128)
      return (int)cudaErrorInvalidValue;
  }
  int buf[2], xr, yr;
  supersite_smem(ch, buf, &xr, &yr);
  const size_t smem = sizeof(float) * ((size_t)buf[0] + buf[1] + xr + yr);
  static size_t granted = 48 * 1024;
  cudaError_t err = allow_smem(supersite_kernel, smem, &granted);
  if (err != cudaSuccess) return (int)err;
  supersite_kernel<<<dim3(n_bands, B), NT, smem, (cudaStream_t)stream>>>(
      x, w, out, ch, h_out, buf[0], buf[1], xr);
  return (int)cudaGetLastError();
}
