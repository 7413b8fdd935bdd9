// Fused 3x3 convolution on NHWC tensors: stride 1 with dilation 1/2/4/8, and
// stride 2 (torch padding 1), each with the epilogue of conv_common.cuh.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   K1  realtime_stereo_matcher_tpu/kernels/conv3x3.py  fused_conv3x3_flat
//       (body _build_kernel, launcher _conv_call): stride-1 dilated 3x3 conv
//       with BN-fold, ReLU / leaky / none, and a residual after the
//       activation.  Training (kernels/train_conv.py, the port of K5
//       flat_conv3x3) runs it for the forward and for dx, which adds the
//       32 -> 4 and 1 -> 32 cases.
//   K2  realtime_stereo_matcher_tpu/kernels/conv3x3.py  fused_conv3x3_s2_flat
//       (body _build_s2_kernel, launcher _conv_s2_call): the stride-2 3x3
//       conv that halves H and W.  The 4x4 TF-SAME form (v3 U-Net) is not
//       ported yet.
// The TPU kernels fold 4 pixels x 32 channels into 128 lanes to feed its
// matrix unit; none of that is carried over.  This computes the same
// function on plain NHWC tensors.
//
// What bounds it on an H100: at 720x1280, 32 -> 32 channels in bf16 the conv
// does 17.0 GFLOP on 118 MB (177 MB with the residual), about 96 FLOP per
// byte, below the card's ~295 FLOP/byte ridge for bf16 tensor cores: with
// tensor cores the kernel would be memory-bound (35-53 us at 3.35 TB/s).
// This first kernel runs its FMAs on the CUDA cores in float32 (67 TFLOP/s
// peak), so it is bound by those operations instead (>= 0.25 ms for that
// launch).  A wgmma / TMA redesign that reaches the memory bound is later
// work.
//
// C interface (bound with ctypes by kernels/_build.py): pointers and the
// stream are void*, the rest int; the return value is the cudaError_t of the
// launch (cudaErrorInvalidValue for a shape this file does not instantiate).
#include "conv_common.cuh"

namespace {

using rsm::launch_conv;

template <typename T, int S>
cudaError_t dispatch(const void* x, const void* w, const void* scale,
                     const void* bias, const void* res, void* out, int n,
                     int h, int wd, int cin, int cout, int ho, int wo,
                     int dil, int act, float alpha, cudaStream_t st) {
  const int pad = dil;  // stride 1: SAME; stride 2: dil == 1, torch padding 1
#define RSM_CASE(CI, CO)                                                   \
  if (cin == CI && cout == CO)                                             \
    return launch_conv<T, CI, CO, S, 1>(x, w, scale, bias, res, out, n, 1, \
                                        h, wd, ho, wo, dil, pad, act,      \
                                        alpha, st);
  if constexpr (S == 1) {
    RSM_CASE(32, 32)
    RSM_CASE(4, 32)
    RSM_CASE(32, 1)
    RSM_CASE(32, 4)  // dx of the 4 -> 32 refine entry conv (training)
    RSM_CASE(1, 32)  // dx of the 32 -> 1 refine head (training)
  } else {
    RSM_CASE(32, 32)
    RSM_CASE(3, 32)
  }
#undef RSM_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int rsm_conv3x3(const void* x, const void* w, const void* scale,
                const void* bias, const void* res, void* out, int dtype,
                int n, int h, int wd, int cin, int cout, int ho, int wo,
                int stride, int dil, int act, float alpha, int device,
                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stride != 1 && !(stride == 2 && dil == 1)) return cudaErrorInvalidValue;
  if (dtype == rsm::kBFloat16) {
    return stride == 1
               ? dispatch<__nv_bfloat16, 1>(x, w, scale, bias, res, out, n, h,
                                            wd, cin, cout, ho, wo, dil, act,
                                            alpha, st)
               : dispatch<__nv_bfloat16, 2>(x, w, scale, bias, res, out, n, h,
                                            wd, cin, cout, ho, wo, dil, act,
                                            alpha, st);
  }
  if (dtype == rsm::kFloat32) {
    return stride == 1
               ? dispatch<float, 1>(x, w, scale, bias, res, out, n, h, wd,
                                    cin, cout, ho, wo, dil, act, alpha, st)
               : dispatch<float, 2>(x, w, scale, bias, res, out, n, h, wd,
                                    cin, cout, ho, wo, dil, act, alpha, st);
  }
  return cudaErrorInvalidValue;
}

const char* rsm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
