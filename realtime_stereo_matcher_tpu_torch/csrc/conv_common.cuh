// Direct convolution with a fused epilogue on the CUDA cores, shared by the
// 3x3 kernels (conv3x3.cu: stride 1 and stride 2), the 4x4 stride-2 TF-SAME
// kernel (conv3x3.cu) and the 3x3x3 kernel (conv3d.cu), all in float32.
// Every bf16 conv runs on the tensor cores instead (conv_tc.cuh,
// conv_narrow_tc.cuh, conv_s2_tc.cuh, conv3d_narrow_tc.cuh).
//
// Layouts are channels-last and contiguous:
//   x   (N, D, H, W, CI)        T    (D = 1 for a 2D conv)
//   w   (KD, K, K, CI, CO)      T    (KD = 1 for a 2D conv; HWIO / DHWIO;
//                                     K = 3, or 4 for the 4x4 conv)
//   out (N, D, Ho, Wo, CO)      T
//   res (N, D, Ho, Wo, CO)      T    optional residual
// T is float (the conv entry points instantiate no other); products and
// sums are float32.
//
// Epilogue, in the order of the TPU kernel (kernels/conv3x3.py:276-291 of the
// JAX package): y = acc * scale + bias; ReLU, leaky ReLU or none; cast to T;
// then + residual, rounded to T again.
//
// Design: one thread owns kPix output pixels (kThreads apart in the
// flattened Ho*Wo plane) and all CO output channels, so each weight read from
// shared memory feeds kPix * 4 FMAs.  The weights of one depth tap
// (9 * CI * CO floats, 36 KB at 3x3, 32 -> 32) are staged in static shared
// memory; the 3x3x3 conv restages them for each of its 3 depth taps, and the
// 4x4 conv, whose 16 taps (64 KB at 32 -> 32) do not fit, stages one kernel
// row (4 taps, 16 KB) at a time, which keeps every launch under the 48 KB
// static limit; the products are summed in the same order either way.
// Input pixels are read from global memory as 16-byte vectors; the reuse of
// a pixel by neighbouring taps is served by L1/L2.
// The arithmetic runs on the CUDA cores in float32 (see the notes in
// conv3x3.cu and conv3d.cu for what bounds each kernel).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rsm {

constexpr int kThreads = 128;  // threads per block
constexpr int kPix = 2;        // output pixels per thread
constexpr int kBlockPix = kThreads * kPix;

enum Act { kActNone = 0, kActRelu = 1, kActLeaky = 2 };
enum DType { kFloat32 = 0, kBFloat16 = 1 };

// Raises `kernel`'s dynamic shared-memory opt-in (above 48 KB) on the
// current device to `smem` bytes where the plans launched so far needed
// less; `opted`, one entry per device and static at the caller, remembers
// what was set.  A card that holds less refuses it here.
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, int smem, int (&opted)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (smem > opted[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    opted[dev] = smem;
  }
  return cudaSuccess;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Loads N consecutive values at p as floats (16-byte vectors when N == 8;
// the caller guarantees 16-byte alignment then).
template <int N, typename T>
__device__ __forceinline__ void load_vec(const T* p, float* v) {
  if constexpr (N == 8 && sizeof(T) == 2) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else if constexpr (N == 8 && sizeof(T) == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = to_f(p[i]);
  }
}

// Stores N floats at p as T (16-byte vectors when N == 8).
template <int N, typename T>
__device__ __forceinline__ void store_vec(T* p, const float* v) {
  if constexpr (N == 8 && sizeof(T) == 2) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  } else if constexpr (N == 8 && sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = from_f<T>(v[i]);
  }
}

// grid: x = ceil(Ho * Wo / kBlockPix), y = N * D planes.
// Output pixel X reads input S * X - pad + k * dil, k < K (zero outside).
// Stride-1 convs pass pad = dil (SAME); the 3x3 stride-2 conv passes
// pad = dil = 1 (torch padding=1); the 4x4 stride-2 conv passes pad = 1 and
// takes Ho = ceil(H / 2) (TF-SAME: the far pad is whatever lies past H).
template <typename T, int CI, int CO, int S, int KD, int K = 3>
__global__ void __launch_bounds__(kThreads)
conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
            const float* __restrict__ scale, const float* __restrict__ bias,
            const T* __restrict__ res, T* __restrict__ out,
            int D, int H, int W, int Ho, int Wo, int dil, int pad, int act,
            float alpha) {
  constexpr int kRow = K * CI * CO;       // weights of one kernel row
  // kernel rows staged at once: all K where they fit in 40 KB, else one
  constexpr int kRows = (K * kRow * 4 <= 40 * 1024) ? K : 1;
  constexpr int CH = (CI % 8 == 0) ? 8 : CI;   // input channels per load
  constexpr int CHO = (CO % 8 == 0) ? 8 : CO;  // output channels per store
  __shared__ __align__(16) float w_s[kRows * kRow];

  const int plane = blockIdx.y;  // n * D + dz
  const int dz = plane % D;
  const int n_out = Ho * Wo;

  int oy[kPix], ox[kPix];
  bool live[kPix];
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const int q = blockIdx.x * kBlockPix + p * kThreads + threadIdx.x;
    live[p] = q < n_out;
    oy[p] = live[p] ? q / Wo : 0;
    ox[p] = live[p] ? q - oy[p] * Wo : 0;
  }

  float acc[kPix][CO];
#pragma unroll
  for (int p = 0; p < kPix; ++p)
#pragma unroll
    for (int c = 0; c < CO; ++c) acc[p][c] = 0.f;

  for (int kd = 0; kd < KD; ++kd) {
    const int iz = dz + kd - KD / 2;
    if (iz < 0 || iz >= D) continue;  // the same for the whole block
    const T* xplane = x + (size_t)(plane + kd - KD / 2) * H * W * CI;
    for (int r0 = 0; r0 < K; r0 += kRows) {
      __syncthreads();                // the previous rows' weights are used up
      const T* wk = w + ((size_t)kd * K + r0) * kRow;
      for (int i = threadIdx.x; i < kRows * kRow; i += kThreads)
        w_s[i] = to_f(wk[i]);
      __syncthreads();

      for (int ky = r0; ky < r0 + kRows; ++ky) {
        for (int kx = 0; kx < K; ++kx) {
          const float* wt = w_s + ((ky - r0) * K + kx) * CI * CO;
          const T* px[kPix];
          bool ok[kPix];
#pragma unroll
          for (int p = 0; p < kPix; ++p) {
            const int iy = oy[p] * S - pad + ky * dil;
            const int ix = ox[p] * S - pad + kx * dil;
            ok[p] = live[p] && iy >= 0 && iy < H && ix >= 0 && ix < W;
            px[p] = xplane + ((size_t)(ok[p] ? iy : 0) * W + (ok[p] ? ix : 0)) * CI;
          }
          for (int c0 = 0; c0 < CI; c0 += CH) {
            float xv[kPix][CH];
#pragma unroll
            for (int p = 0; p < kPix; ++p) {
              if (ok[p]) {
                load_vec<CH>(px[p] + c0, xv[p]);
              } else {
#pragma unroll
                for (int j = 0; j < CH; ++j) xv[p][j] = 0.f;
              }
            }
#pragma unroll
            for (int j = 0; j < CH; ++j) {
              const float* wr = wt + (c0 + j) * CO;
              if constexpr (CO % 4 == 0) {
#pragma unroll
                for (int c = 0; c < CO; c += 4) {
                  const float4 wv = *reinterpret_cast<const float4*>(wr + c);
#pragma unroll
                  for (int p = 0; p < kPix; ++p) {
                    acc[p][c] = fmaf(xv[p][j], wv.x, acc[p][c]);
                    acc[p][c + 1] = fmaf(xv[p][j], wv.y, acc[p][c + 1]);
                    acc[p][c + 2] = fmaf(xv[p][j], wv.z, acc[p][c + 2]);
                    acc[p][c + 3] = fmaf(xv[p][j], wv.w, acc[p][c + 3]);
                  }
                }
              } else {
#pragma unroll
                for (int c = 0; c < CO; ++c) {
                  const float wv = wr[c];
#pragma unroll
                  for (int p = 0; p < kPix; ++p)
                    acc[p][c] = fmaf(xv[p][j], wv, acc[p][c]);
                }
              }
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    if (!live[p]) continue;
    const size_t o = ((size_t)plane * n_out + (size_t)oy[p] * Wo + ox[p]) * CO;
#pragma unroll
    for (int c0 = 0; c0 < CO; c0 += CHO) {
      float r[CHO], y[CHO];
      if (res != nullptr) load_vec<CHO>(res + o + c0, r);
#pragma unroll
      for (int j = 0; j < CHO; ++j) {
        float v = fmaf(acc[p][c0 + j], __ldg(scale + c0 + j), __ldg(bias + c0 + j));
        if (act == kActRelu) {
          v = fmaxf(v, 0.f);
        } else if (act == kActLeaky) {
          v = fmaxf(v, 0.f) + alpha * fminf(v, 0.f);
        }
        v = to_f(from_f<T>(v));               // cast to T before the residual
        y[j] = (res != nullptr) ? v + r[j] : v;  // store_vec rounds once more
      }
      store_vec<CHO>(out + o + c0, y);
    }
  }
}

template <typename T, int CI, int CO, int S, int KD, int K = 3>
cudaError_t launch_conv(const void* x, const void* w, const void* scale,
                        const void* bias, const void* res, void* out, int n,
                        int d, int h, int wd, int ho, int wo, int dil, int pad,
                        int act, float alpha, cudaStream_t stream) {
  const dim3 grid((ho * wo + kBlockPix - 1) / kBlockPix, n * d);
  conv_kernel<T, CI, CO, S, KD, K><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const T*>(res), static_cast<T*>(out), d, h, wd, ho, wo,
      dil, pad, act, alpha);
  return cudaGetLastError();
}

}  // namespace rsm
