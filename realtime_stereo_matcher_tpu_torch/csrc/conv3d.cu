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
// Weights: 27 x 32 x 32 are 110 KB in float32, more than the 48 KB a block
// may hold statically.  The shared kernel stages them one depth tap at a
// time (9 x 32 x 32 floats, 36 KB), so no launch needs the dynamic
// shared-memory opt-in.
//
// What bounds it on an H100: one 32 -> 32 layer on the (1, 24, 90, 160, 32)
// bf16 volume of the 720p path does 19.1 GFLOP on 44 MB, about 430 FLOP per
// byte, above the card's ~295 FLOP/byte ridge: it is bound by operations
// (>= 19 us on bf16 tensor cores).  This first kernel runs float32 FMAs on
// the CUDA cores (67 TFLOP/s peak, >= 0.29 ms a layer); a wgmma / TMA
// redesign is later work.
#include "conv_common.cuh"

namespace {

template <typename T>
cudaError_t dispatch(const void* x, const void* w, const void* scale,
                     const void* bias, void* out, int n, int d, int h, int wd,
                     int cin, int cout, int act, cudaStream_t st) {
#define RSM_CASE(CI, CO)                                                     \
  if (cin == CI && cout == CO)                                               \
    return rsm::launch_conv<T, CI, CO, 1, 3>(x, w, scale, bias, nullptr, out, \
                                             n, d, h, wd, h, wd, 1, 1, act,   \
                                             0.f, st);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rsm::kBFloat16)
    return dispatch<__nv_bfloat16>(x, w, scale, bias, out, n, d, h, wd, cin,
                                   cout, act, st);
  if (dtype == rsm::kFloat32)
    return dispatch<float>(x, w, scale, bias, out, n, d, h, wd, cin, cout, act,
                           st);
  return cudaErrorInvalidValue;
}
