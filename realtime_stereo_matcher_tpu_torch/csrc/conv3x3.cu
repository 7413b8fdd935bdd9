// Fused 3x3 convolution on NHWC tensors: stride 1 with dilation 1/2/4/8, and
// stride 2 (torch padding 1); and the fused 4x4 stride-2 TF-SAME convolution;
// each with the epilogue of conv_common.cuh.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   K1  realtime_stereo_matcher_tpu/kernels/conv3x3.py  fused_conv3x3_flat
//       (body _build_kernel, launcher _conv_call): stride-1 dilated 3x3 conv
//       with BN-fold, ReLU / leaky / none, and a residual after the
//       activation.  Training (kernels/train_conv.py, the port of K5
//       flat_conv3x3) runs it for the forward and for dx, which adds the
//       32 -> 4 and 1 -> 32 cases; the v3 U-Net's stem adds 3 -> 32; the
//       v2 refine entry (disparity + left RGB + warped right RGB) adds
//       7 -> 32, and its dx 32 -> 7.  The JAX kernel zero-pads any
//       C_in <= 32 to 32; here each pair is an instantiation.
//   K2  realtime_stereo_matcher_tpu/kernels/conv3x3.py  fused_conv3x3_s2_flat
//       (body _build_s2_kernel, launcher _conv_s2_call): the stride-2 3x3
//       conv that halves H and W (32 -> 32, and 3 -> 32 at the encoders'
//       first stage).
//   K2-4x4  realtime_stereo_matcher_tpu/kernels/conv3x3.py
//       fused_conv4x4_s2_flat (the same launcher with the 4x4 taps): the v3
//       U-Net's 4x4 stride-2 downsampler with TF-SAME padding (output pixel
//       X reads input 2X-1 .. 2X+2), bias and leaky ReLU 0.2, 32 -> 32.
// The TPU kernels fold 4 pixels x 32 channels into 128 lanes to feed its
// matrix unit; none of that is carried over.  This computes the same
// function on plain NHWC tensors.
//
// What bounds it on an H100: at 720x1280, 32 -> 32 channels in bf16 the conv
// does 17.0 GFLOP on 118 MB (177 MB with the residual), about 96 FLOP per
// byte, below the card's ~295 FLOP/byte ridge for bf16 tensor cores: on
// tensor cores it is bound by memory (35-53 us at 3.35 TB/s).  The stride-2
// convs read 4x what they write: the 4x4 at 720x1280 -> 360x640, 32 -> 32 in
// bf16, does 7.55 GFLOP on 73.7 MB (22 us on memory, 102 FLOP per byte); the
// 3x3 at 360x640 -> 180x320 1.06 GFLOP on 18.4 MB (5.5 us on memory).
//
// Five designs, chosen by stride, dtype and channel pair:
//   * bf16 32 -> 32, stride 1 (50 of the 56 K1 launches of a 720p frame):
//     rsm_conv3x3_tc, the tensor-core implicit GEMM of conv_tc.cuh.  A block
//     owns a 64-column strip and walks down it 8 output rows a step, keeping
//     2 * 8 + 2 d input rows in a shared-memory ring filled by cp.async, so
//     each input row of the strip (with its d-column halo) comes from global
//     memory once per block; the rows of a dilation-8 halo come from L2, not
//     DRAM, because neighbouring blocks (blockIdx.x fastest) walk the same
//     row band.  MMAs are far above the ~96 FLOP/byte it needs, so its limit
//     is bytes: 16-byte cp.async loads, the residual prefetched into L2 a
//     step ahead, and 16-byte stores staged through shared memory.  Measured
//     on an H100 (PERF.md): ~0.58 of its bound at dilations 1 and 2 (two
//     blocks per SM); at dilations 4 and 8 the ring (137 and 190 KB) leaves
//     one 8-warp block per SM, and those launches lose to cuDNN.
//   * bf16 stride 1 with a narrow side, 1 / 3 / 4 / 7 -> 32 and 32 -> 1 / 4 /
//     7 (the refine entries and heads, their dx, the v3 stem): also
//     rsm_conv3x3_tc, the kernels of conv_narrow_tc.cuh, the same strip walk
//     and ring with the narrow side padded to 8 channels (taps packed two to
//     a k16 step for a narrow input; one n8 tile for a narrow output).
//   * bf16 32 -> 32, stride 2 (K2: 4 of the 6 stride-2 launches of a v1 or
//     v2 frame; K2-4x4: all 6 of a v3 frame): rsm_conv_s2_tc, the
//     tensor-core kernel of conv_s2_tc.cuh (KT = 3 or 4 taps a side): the
//     same implicit GEMM with the weights resident, each staged input row
//     de-interleaved by column parity so that a stride-2 A fragment reads 16
//     consecutive staged pixels without bank conflicts, and a ring of
//     4 * 8 + KT - 2 input rows for 8 x 32 output tiles.
//   * bf16 3 -> 32, stride 2 (K2: the other 2 of the 6 stride-2 launches of
//     a v1 or v2 frame, the encoders' stem): rsm_conv_s2_tc too, the
//     narrow-input kernel of conv_s2_tc.cuh (conv_s2_nin_tc_kernel): the
//     column-parity planes with the input pixels staged through registers,
//     padded to 8 channels, taps packed two to a k16 step.
//   * float32 (every pair): the CUDA-core template of conv_common.cuh,
//     float32 FMAs (67 TFLOP/s peak), bound by those operations.  float32
//     stays there so that its checks hold at ~3e-6 (TF32 tensor cores would
//     not).  Every bf16 launch runs on the tensor cores.

// C interface (bound with ctypes by kernels/_build.py): pointers and the
// stream are void*, the rest int; the return value is the cudaError_t of the
// launch (cudaErrorInvalidValue for a shape or plan this file does not take).
#include "conv_common.cuh"
#include "conv_narrow_tc.cuh"
#include "conv_s2_tc.cuh"
#include "conv_tc.cuh"

namespace {

using rsm::launch_conv;

// float32 only: every bf16 conv runs on the tensor cores (rsm_conv3x3_tc,
// rsm_conv_s2_tc)
template <int S>
cudaError_t dispatch(const void* x, const void* w, const void* scale,
                     const void* bias, const void* res, void* out, int n,
                     int h, int wd, int cin, int cout, int ho, int wo,
                     int dil, int act, float alpha, cudaStream_t st) {
  const int pad = dil;  // stride 1: SAME; stride 2: dil == 1, torch padding 1
#define RSM_CASE(CI, CO)                                                   \
  if (cin == CI && cout == CO)                                             \
    return launch_conv<float, CI, CO, S, 1>(x, w, scale, bias, res, out, n, \
                                            1, h, wd, ho, wo, dil, pad,    \
                                            act, alpha, st);
  if constexpr (S == 1) {
    RSM_CASE(32, 32)
    RSM_CASE(4, 32)
    RSM_CASE(32, 1)
    RSM_CASE(32, 4)  // dx of the 4 -> 32 refine entry conv (training)
    RSM_CASE(1, 32)  // dx of the 32 -> 1 refine head (training)
    RSM_CASE(3, 32)  // the v3 U-Net's stem
    RSM_CASE(7, 32)  // the v2 refine entry
    RSM_CASE(32, 7)  // dx of the v2 refine entry (training)
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
  if (dtype == rsm::kFloat32) {  // bf16 runs on the tensor cores
    return stride == 1
               ? dispatch<1>(x, w, scale, bias, res, out, n, h, wd, cin,
                             cout, ho, wo, dil, act, alpha, st)
               : dispatch<2>(x, w, scale, bias, res, out, n, h, wd, cin,
                             cout, ho, wo, dil, act, alpha, st);
  }
  return cudaErrorInvalidValue;
}

// bf16, stride 1, dilation dil, on the tensor cores, by the plan of
// kernels/conv3x3.py (conv3x3_tc_plan): tile th x tw, `ring` input rows,
// `steps` row tiles per block, grid (gx, gy, gz), `smem` dynamic shared
// bytes; cin -> cout 32 -> 32 (conv_tc.cuh) or a narrow pair
// (conv_narrow_tc.cuh).
int rsm_conv3x3_tc(const void* x, const void* w, const void* scale,
                   const void* bias, const void* res, void* out, int n, int h,
                   int wd, int cin, int cout, int dil, int th, int tw,
                   int ring, int steps, int gx, int gy, int gz, int smem,
                   int act, float alpha, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (dil < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cin == 32 && cout == 32)
    return rsm::tc::launch_tc<1>(x, w, scale, bias, res, out, n, 1, h, wd,
                                 dil, th, tw, ring, steps, gx, gy, gz, smem,
                                 act, alpha, st);
#define RSM_NARROW(CI, CO)                                                 \
  if (cin == CI && cout == CO)                                             \
    return rsm::tc::launch_narrow_tc<CI, CO>(x, w, scale, bias, res, out, n, \
                                             h, wd, dil, th, tw, ring, steps, \
                                             gx, gy, gz, smem, act, alpha, st);
  RSM_NARROW(4, 32)
  RSM_NARROW(7, 32)
  RSM_NARROW(3, 32)
  RSM_NARROW(1, 32)
  RSM_NARROW(32, 1)
  RSM_NARROW(32, 4)
  RSM_NARROW(32, 7)
#undef RSM_NARROW
  return cudaErrorInvalidValue;
}

// The 4x4 stride-2 TF-SAME conv in float32: pad_lo = 1, Ho = ceil(H / 2),
// 32 -> 32 (bf16 runs on the tensor cores, rsm_conv_s2_tc with taps = 4).
int rsm_conv4x4_s2(const void* x, const void* w, const void* scale,
                   const void* bias, void* out, int dtype, int n, int h,
                   int wd, int cin, int cout, int ho, int wo, int act,
                   float alpha, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cin != 32 || cout != 32) return cudaErrorInvalidValue;
  if (dtype == rsm::kFloat32)
    return rsm::launch_conv<float, 32, 32, 2, 1, 4>(
        x, w, scale, bias, nullptr, out, n, 1, h, wd, ho, wo, 1, 1, act,
        alpha, st);
  return cudaErrorInvalidValue;
}

// bf16 stride 2 on the tensor cores, `taps` (3 or 4) a side, cin -> 32
// (cin 32, or 3 with 3 taps), by the plan of kernels/conv3x3.py
// (conv_s2_tc_plan): tile th x tw output pixels, `ring` input rows, `steps`
// row tiles per block, grid (gx, gy, gz), `smem` dynamic shared bytes.
int rsm_conv_s2_tc(const void* x, const void* w, const void* scale,
                   const void* bias, void* out, int n, int h, int wd, int ho,
                   int wo, int cin, int taps, int th, int tw, int ring,
                   int steps, int gx, int gy, int gz, int smem, int act,
                   float alpha, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (taps == 4)
    return rsm::tc::launch_s2_tc<4>(x, w, scale, bias, out, n, h, wd, ho, wo,
                                    cin, th, tw, ring, steps, gx, gy, gz,
                                    smem, act, alpha, st);
  if (taps == 3)
    return rsm::tc::launch_s2_tc<3>(x, w, scale, bias, out, n, h, wd, ho, wo,
                                    cin, th, tw, ring, steps, gx, gy, gz,
                                    smem, act, alpha, st);
  return cudaErrorInvalidValue;
}

const char* rsm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
