// Fused 3x3x3 convolution on (B, D, H, W, C) volumes, SAME zero padding in
// D, H and W, with the epilogue of conv_common.cuh (BN-fold or bias, then
// ReLU or none; no residual).
//
// Replaces the Pallas TPU kernel K3 of the JAX package:
//   realtime_stereo_matcher_tpu/kernels/cost_filter3d.py  fused_conv3d_flat
//   (body _build_kernel, launcher _conv3d_call), run five times by
//   fast_cost_filter: four 32 -> 32 conv+BN+ReLU layers and a 32 -> 1 conv
//   with bias.  Training (kernels/train_conv3d.py) also runs it on the
//   cotangent for dx, which adds the 1 -> 32 case.
// The TPU kernel's lane fold and pixel phases are not carried over; this
// computes the same function on the plain channels-last volume.
//
// What bounds it on an H100: one 32 -> 32 layer on the (1, 24, 90, 160, 32)
// bf16 volume of the 720p path does 19.1 GFLOP on 44 MB, about 430 FLOP per
// byte, above the card's ~295 FLOP/byte ridge: it is bound by operations
// (>= 19 us on bf16 tensor cores).
//
// Three designs, chosen by dtype and channel pair:
//   * bf16 32 -> 32 (4 of the 5 launches of a frame): rsm_conv3d_tc, the
//     tensor-core implicit GEMM of conv_tc.cuh (mma.sync m16n8k16, K = 864).
//     A block owns a 16 x 32 (h, w) tile and walks along D, keeping a ring of
//     4 input depth slabs (18 x 34 pixels each) in shared memory, filled by
//     cp.async one slab ahead, so that each slab is loaded once and serves
//     three output depths; the 54 KB of bf16 weights stay resident for the
//     block's life (dynamic shared memory, 220 KB in all, one block per SM).
//     At batch 1 the 90 x 160 plane holds only 30 tiles, so D is split into
//     chunks (each reloading its two halo slabs) until the grid fills the
//     card; the plan is kernels/cost_filter3d.py's conv3d_tc_plan.  Measured
//     on an H100 (PERF.md, tools/tc_compare.py), the mma.sync issue rate is
//     its limit: with the MMAs cut out the launch takes ~0.4 of its time,
//     with the A-fragment loads cut out ~0.9.  A wgmma form (A from the same
//     ldmatrix fragments in registers, B by descriptor from the weights laid
//     out in wgmma's core-matrix order, 8 wgmma m64n32k16 a tap per
//     warpgroup) measured ~10% slower; tools/conv_tc_wgmma.cuh keeps it for
//     that comparison.
//   * bf16 32 -> 1 (the head, the fifth launch of a frame) and 1 -> 32 (its
//     dx in training): rsm_conv3d_tc too, the kernels of
//     conv3d_narrow_tc.cuh over the same tile walk and slab ring (32 -> 1:
//     N = (kx, co), one A fragment serving three taps; 1 -> 32: 2-byte
//     pixels, K = the 27 taps padded to 32).
//   * float32: the CUDA-core template of conv_common.cuh (float32 FMAs,
//     weights staged a depth tap at a time, 36 KB, so no launch needs the
//     dynamic shared-memory opt-in), so that its checks hold at ~3e-6.
#include "conv3d_narrow_tc.cuh"
#include "conv_common.cuh"
#include "conv_tc.cuh"

namespace {

// float32 only: every bf16 conv runs on the tensor cores (rsm_conv3d_tc)
cudaError_t dispatch(const void* x, const void* w, const void* scale,
                     const void* bias, void* out, int n, int d, int h, int wd,
                     int cin, int cout, int act, cudaStream_t st) {
#define RSM_CASE(CI, CO)                                                     \
  if (cin == CI && cout == CO)                                               \
    return rsm::launch_conv<float, CI, CO, 1, 3>(x, w, scale, bias, nullptr, \
                                                 out, n, d, h, wd, h, wd, 1, \
                                                 1, act, 0.f, st);
  RSM_CASE(32, 32)
  RSM_CASE(32, 1)
  RSM_CASE(1, 32)  // dx of the 32 -> 1 head (training)
#undef RSM_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int rsm_conv3d(const void* x, const void* w, const void* scale,
                          const void* bias, void* out, int dtype, int n, int d,
                          int h, int wd, int cin, int cout, int act,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (dtype != rsm::kFloat32) return cudaErrorInvalidValue;  // bf16: _tc
  return dispatch(x, w, scale, bias, out, n, d, h, wd, cin, cout, act,
                  static_cast<cudaStream_t>(stream));
}

// bf16 on the tensor cores, cin -> cout 32 -> 32 (conv_tc.cuh), 32 -> 1 or
// 1 -> 32 (conv3d_narrow_tc.cuh), by the plan of kernels/cost_filter3d.py
// (conv3d_tc_plan): tile th x tw of (h, w), a ring of 4 slabs, `steps`
// depths per block, grid (gx, gy, gz), `smem` dynamic shared bytes.
extern "C" int rsm_conv3d_tc(const void* x, const void* w, const void* scale,
                             const void* bias, void* out, int n, int d, int h,
                             int wd, int cin, int cout, int th, int tw,
                             int ring, int steps, int gx, int gy, int gz,
                             int smem, int act, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cin == 32 && cout == 32)
    return rsm::tc::launch_tc<3>(x, w, scale, bias, nullptr, out, n, d, h, wd,
                                 1, th, tw, ring, steps, gx, gy, gz, smem, act,
                                 0.f, st);
  return rsm::tc::launch_conv3d_narrow_tc(x, w, scale, bias, out, n, d, h, wd,
                                          cin, cout, th, tw, ring, steps, gx,
                                          gy, gz, smem, act, st);
}
