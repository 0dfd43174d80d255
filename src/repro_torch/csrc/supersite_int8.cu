// supersite_fused_int8: a FIX8 chain of consecutive conv sites (MBConv and
// DSConv members) in one call, bit-exact against running the sites one
// at a time with execute()'s fp residual adds and per-image requants.
//
// Replaces the TPU kernel repro/kernels/supersite/kernel.py::
// supersite_fused_int8, which holds one image's whole map per grid step
// in VMEM (2.68 MB at S1.ss0 of B1@224) and requantizes every member's
// mid map, DW map and output with one absmax over the image: 3 requant
// points per MBConv member, 9 for S2.ss0.  A Hopper CTA has 227 KB of
// shared memory and sees a tile of the image, so each requant point is a
// cross-CTA dependency.
//
// Bound on the H100 at B1@224: bytes, by the roofline (an int8 input, an
// fp32 + int8 output and the pack against a few hundred int8 operations
// per pixel).  The passes add the fp32 scratch maps crossing device
// memory (L2-resident at B1@224 batch 8: the largest, S1.mb0's mid map,
// is 25.7 MB) and one launch per requant point; measured, they are bound
// by the latency of their dependent IEEE division chains (the requants
// and Hardswish), not by those bytes.
//
// Design: a sequence of launches inside this one C entry point, on one
// stream, with no host work between them.  An MBConv member runs the
// passes of mbconv_int8.cuh (3 launches, the GEMMs on int8 tensor cores,
// every fp32 value quantized once per CTA that reads it), a DSConv member
// the passes of dsconv_int8.cuh (2 launches).  A member whose image fits
// mbconv_int8.cuh's cluster kernel (S2.mb1 and S2.mb2 at B1@224) still
// takes the passes: the cluster launch lost to them at that shape in
// chip_smoke.py's [mbconv_int8 sweep], at batch 1 and 8.  At a member
// boundary the PW epilogue adds the fp residual (cur_fp + out, one
// rounding, as execute() does) and folds the result into the boundary's
// per-image absmax words; the next member quantizes that fp32 map as it
// reads it (ActIn), so the boundary's int8 map is never stored and no
// torch op runs between members.  The fp32 mid, DW
// and boundary maps live in device scratch the wrapper allocates once per
// call.  One cudaMemsetAsync zeroes every absmax word of the chain.  An
// int8 exit adds one pass that quantizes the last output.
#include "dsconv_int8.cuh"
#include "mbconv_int8.cuh"

// ints per member in the host descriptor: kind (0 MBConv, 1 DSConv),
// stride, residual, H, W, C, mid, F, 3 int8 pack offsets (MBConv w1, dw,
// w2 / DSConv dw, pw), 6 fp32 pack offsets (MBConv s1, b1, dws, dwb, s2,
// b2 / DSConv dws, dwb, pws, pwb).
constexpr int SSQ_DESC = 17;

// amax: 3 * n_members * B words (zeroed here).  mid / dwo: the largest
// member's fp32 mid and DW maps; bnd0 / bnd1: ping-pong fp32 member
// outputs; out: the last member's fp32 output.  x_fp (the entry's kept fp
// map) is read only when member 0 is residual; q and scales are null
// unless the exit emits int8.
REPRO_EXPORT int supersite_fused_int8_i8(
    const int8_t* x, const float* xs, const float* x_fp, const int8_t* wq,
    const float* wf, float* mid, float* dwo, float* bnd0, float* bnd1,
    float* out, unsigned int* amax, int8_t* q, float* scales,
    const int* desc, int n_members, int B, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(
      amax, 0, sizeof(unsigned int) * 3 * n_members * B, s);
  if (err != cudaSuccess) return (int)err;
  ActIn in{x, xs, nullptr, nullptr};
  const float* cur_fp = x_fp;
  float* bnd[2] = {bnd0, bnd1};
  const unsigned int* a_out = nullptr;
  long long n_out = 0;
  for (int k = 0; k < n_members; ++k) {
    const int* d = desc + k * SSQ_DESC;
    const int kind = d[0], stride = d[1], residual = d[2];
    const int H = d[3], W = d[4], C = d[5], M = d[6], F = d[7];
    const bool last = k == n_members - 1;
    const bool emit = !last || q != nullptr;
    float* o = last ? out : bnd[k & 1];
    unsigned int* a = amax + 3 * k * B;
    const float* res = residual ? cur_fp : nullptr;
    if (kind == 0) {
      const MbI8Site site{in, wq + d[8], wq + d[9], wq + d[10], wf + d[11],
                          wf + d[12], wf + d[13], wf + d[14], wf + d[15],
                          wf + d[16], res, o, nullptr, nullptr, H, W, C, M,
                          F, stride};
      err = mbconv_i8_passes(site, mid, dwo, a, emit, B, s);
      a_out = a + 2 * B;
    } else {
      err = dsconv_i8_passes(in, wq + d[8], wf + d[11], wf + d[12],
                             wq + d[9], wf + d[13], wf + d[14], res, o, a,
                             emit, B, H, W, C, F, stride, 1, s);
      a_out = a + B;
    }
    if (err != cudaSuccess) return (int)err;
    in = ActIn{nullptr, nullptr, o, a_out};
    cur_fp = o;
    n_out = (long long)(H / stride) * (W / stride) * F;
  }
  if (q != nullptr) err = i8_emit_pass(out, a_out, q, scales, B, n_out, s);
  return (int)err;
}
