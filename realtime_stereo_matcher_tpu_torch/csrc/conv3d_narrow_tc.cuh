// Tensor-core implicit GEMM of the bf16 3x3x3 convolutions with a narrow
// side (conv3d.cu's entry point rsm_conv3d_tc):
//
//   32 -> 1   the cost filter's head (the fifth conv of fast_cost_filter:
//             bias, no ReLU), once in every frame and training step;
//   1 -> 32   its dx in training (kernels/train_conv3d.py: the same conv on
//             the cotangent, the kernel flipped and its channels swapped).
//
// Layouts as in conv_tc.cuh (NDHWC, DHWIO, bf16; scale and bias float32 of
// C_out); SAME zero padding in D, H and W; the epilogue is conv_common.cuh's
// without a residual.
//
// Replaces, at these pairs, the Pallas TPU kernel K3 of the JAX package
// (realtime_stereo_matcher_tpu/kernels/cost_filter3d.py fused_conv3d_flat),
// which zero-pads both sides to 32 channels.  Both kernels keep
// conv_tc_kernel<3>'s walk: a block owns a 16 x 32 (h, w) output tile and
// walks `steps` depths, with a ring of 4 input depth slabs of 18 x 34 pixels
// (three in use, the next one arriving); the plan (kernels/cost_filter3d.py
// conv3d_tc_plan with the pair) splits D into chunks until the grid fills
// the card.
//
// What bounds them on an H100: bytes.  32 -> 1 reads 64-byte pixels and
// writes 2-byte ones ((1, 24, 90, 160): 22 MB, 0.0068 ms at 3.35 TB/s);
// 1 -> 32 the other way round ((4, 24, 60, 80): 30 MB, 0.0091 ms).
//
// 32 -> 1.  The input slabs arrive by cp.async as 32-channel swizzled rows
// (conv_tc.cuh load_units).  With the 27 taps in K (K = 864, N = C_out
// padded to 8) every output pixel would read its 27 input pixels from
// shared memory once per tap: 54 ldmatrix of 512 B and 54 MMAs per 16
// pixels, ~600 MB of shared-memory reads a 720p launch.  So N holds the
// kernel column instead: N = (kx, co), 3 x 1 padded to 8, K = 32 input
// channels, and one A fragment (16 consecutive input pixels of a slab row)
// serves all three kx taps.  Row q of M is the flat position r * 34 + c of
// the tile's 16 x 34 input columns (r the output row, c = ox - x0 + 1 the
// input column), 544 = 34 M-tiles of 16; for depth tap dz and row tap dy it
// reads slab dz at pixel q + 34 dy.  So
//   P[q][kx] = sum over dz, dy, ci of x[dz][q + 34 dy][ci] w[dz, dy, kx, ci]
// accumulates in the MMA's registers over the 9 (dz, dy) taps (18 k16
// steps, their B fragments, 36 registers, held for the block's life), and
// the epilogue adds the three shifted partial columns through shared
// memory:  out[r][j] = P[r * 34 + j][0] + P[r * 34 + j + 1][1]
// + P[r * 34 + j + 2][2].  Per 16 output pixels that is 34 / 32 x 18 = 19
// ldmatrix and MMAs, against 54 with the taps in K (measured 17% slower
// on an H100, PERF.md).
//
// 1 -> 32.  The input pixels are 2 bytes: staged through registers (the
// next slab fetched before a step's MMAs and stored after them) into a
// compact ring of 2-byte pixels, 4.9 KB.  K holds the taps: k = dz * 9 +
// dy * 3 + kx, 27 padded to 32 (two k16 steps; at C_in = 1 that is what
// the JAX kernel's lane fold packs).  A fragments are gathered from the
// ring by 2-byte shared-memory loads, each lane at its own taps' offsets
// (the padded taps 27-31 read tap 26's pixel against zero weights); B (32
// taps x 32 output channels) stays in registers for the block's life.  Per
// 16 output pixels: 16 loads a lane and 8 MMAs, then conv_tc.cuh's
// epilogue (store_tile16: 16-byte staged stores of the 64-byte pixels).
//
// RSM_TC_CUT_A, RSM_TC_CUT_MMA and RSM_TC_CUT_STORE (conv_tc.cuh) cut the A
// fragment loads, the MMAs or the output stores out of these kernels too;
// no build of the package defines them.
#pragma once

#include "conv_tc.cuh"

namespace rsm {
namespace tc {

constexpr int kK3Slab = (Tile<3>::TH + 2) * (Tile<3>::TW + 2);  // 612 pixels
constexpr int kK3Ring = 4;                                      // slabs
constexpr int kK3Cols = Tile<3>::TW + 2;   // input columns of a slab row
constexpr int kK3Tiles = Tile<3>::TH * kK3Cols / 16;  // 34 M-tiles (32 -> 1)
// 32 -> 1: weights, 288 rows ((dz, dy) x 32 input channels) of 16 bytes
// (kx 0-2 of the one output channel, padded to 8 columns)
constexpr int kNout3WBytes = 9 * kC * 16;
// 1 -> 32: 32 rows (taps) of 32 output channels, and 2-byte pixels
constexpr int kNin3WBytes = 32 * kPixBytes;
constexpr int kNin3RingBytes = kK3Ring * kK3Slab * 2;
constexpr int kNin3Pre = (kK3Slab + kThreadsTc - 1) / kThreadsTc;  // 3

__host__ __device__ inline int conv3d_narrow_smem_bytes(int cin) {
  return cin == kC
             ? kNout3WBytes + kK3Ring * kK3Slab * kPixBytes + kStageBytes
             : kNin3WBytes + kNin3RingBytes + kStageBytes;
}

// grid: x = (h tiles) x (w tiles), y = depth chunks of `steps`, z = N.
__global__ void __launch_bounds__(kThreadsTc, 1)
conv3d_nout_tc_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ w,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ out, int D, int H, int W,
                      int steps, int act) {
  constexpr int TH = Tile<3>::TH, TW = Tile<3>::TW, UP = kK3Slab;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t w_s = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t ring_s = w_s + kNout3WBytes;
  unsigned char* stage = smem + kNout3WBytes + kK3Ring * UP * kPixBytes;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = blockIdx.z;
  const int tiles_w = (W + TW - 1) / TW;
  const int x0 = (blockIdx.x % tiles_w) * TW;
  const int y0 = (blockIdx.x / tiles_w) * TH;
  const int z0 = blockIdx.y * steps;  // first output depth
  const int u0 = z0 - 1;              // first input slab of the ring
  const int n_steps = min(steps, D - z0);

  // slabs step s needs beyond those of step s - 1 (all three for s = 0)
  auto load_step = [&](int s) {
    load_units<3, TH, TW>(ring_s, x, n, D, H, W, x0, y0, 1, UP, kK3Ring, u0,
                          s == 0 ? u0 : u0 + s + 2, u0 + s + 2, tid);
  };
  load_step(0);
  cp_async_commit();
  // weights: row (dz * 3 + dy) * 32 + ci holds w[dz, dy, kx, ci, 0] at
  // column kx < 3, zero at 3-7
  const unsigned short* wh = reinterpret_cast<const unsigned short*>(w);
  for (int q = tid; q < 9 * kC; q += kThreadsTc) {
    uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int kx = 0; kx < 3; ++kx)
      v[kx >> 1] |= (uint32_t)wh[((q >> 5) * 3 + kx) * kC + (q & 31)]
                    << (16 * (kx & 1));
    st_shared16(w_s + q * 16, make_uint4(v[0], v[1], v[2], v[3]));
  }
  __syncthreads();

  // the B fragments of the 9 (dz, dy) taps and 2 ci halves, for the
  // block's life
  uint32_t b[9][2][2];
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    uint32_t r[4];
    ldsm_x4_t(w_s + (t * kC + lane) * 16, r);
    b[t][0][0] = r[0]; b[t][0][1] = r[1];
    b[t][1][0] = r[2]; b[t][1][1] = r[3];
  }
  const int a_pix = lane & 15, a_chunk = lane >> 4;
  const float s0 = __ldg(scale), b0 = __ldg(bias);
  float* part = reinterpret_cast<float*>(stage);  // P[q][kx], 3 a row

  for (int s = 0; s < n_steps; ++s) {
    if (s + 1 < n_steps) {
      load_step(s + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // M-tiles warp + 8 i of the 34 (warps 0 and 1 own five)
    float acc[5][4];
#pragma unroll
    for (int i = 0; i < 5; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
#pragma unroll
    for (int dz = 0; dz < 3; ++dz) {
      const int unit = ((s + dz) & 3) * UP;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
          for (int i = 0; i < 5; ++i) {
            if (i < 4 || warp < kK3Tiles - 32) {
              uint32_t a[4];
#ifndef RSM_TC_CUT_A
              ldsm_x4(ring_s + swz(unit + (warp + 8 * i) * 16 + a_pix +
                                       dy * kK3Cols,
                                   kk * 2 + a_chunk),
                      a);
#else
              a[0] = a[1] = a[2] = a[3] = 0u;
#endif
#ifndef RSM_TC_CUT_MMA
              mma_bf16(acc[i], a, b[dz * 3 + dy][kk]);
#endif
            }
          }
        }
      }
    }
    // the partials P[q][kx] into the staging area, then each thread sums
    // the three shifted columns of two output pixels
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      if (i < 4 || warp < kK3Tiles - 32) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = (warp + 8 * i) * 16 + (lane >> 2) + 8 * h;
          if ((lane & 3) == 0) {
            part[q * 3] = acc[i][2 * h];
            part[q * 3 + 1] = acc[i][2 * h + 1];
          } else if ((lane & 3) == 1) {
            part[q * 3 + 2] = acc[i][2 * h];
          }
        }
      }
    }
    __syncthreads();
    const int z = z0 + s;
#pragma unroll
    for (int k = 0; k < TH * TW / kThreadsTc; ++k) {
      const int i = tid + k * kThreadsTc, r = i / TW, j = i % TW;
      const int q = r * kK3Cols + j;
      float v = fmaf(part[q * 3] + part[(q + 1) * 3 + 1] +
                         part[(q + 2) * 3 + 2],
                     s0, b0);
      if (act == kActRelu) v = fmaxf(v, 0.f);
      const int oy = y0 + r, ox = x0 + j;
#ifndef RSM_TC_CUT_STORE
      if (oy < H && ox < W)
        out[(((size_t)n * D + z) * H + oy) * W + ox] = __float2bfloat16_rn(v);
#else
      (void)v; (void)oy; (void)ox;
#endif
    }
    __syncthreads();  // the ring slots and partials of step s are free
  }
}

// grid: x = (h tiles) x (w tiles), y = depth chunks of `steps`, z = N.
__global__ void __launch_bounds__(kThreadsTc, 2)
conv3d_nin_tc_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, int D, int H, int W,
                     int steps, int act) {
  constexpr int TH = Tile<3>::TH, TW = Tile<3>::TW, UP = kK3Slab;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t w_s = (uint32_t)__cvta_generic_to_shared(smem);
  unsigned short* ring = reinterpret_cast<unsigned short*>(smem + kNin3WBytes);
  unsigned char* stage = smem + kNin3WBytes + kNin3RingBytes;
  const unsigned short* xh = reinterpret_cast<const unsigned short*>(x);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = blockIdx.z;
  const int tiles_w = (W + TW - 1) / TW;
  const int x0 = (blockIdx.x % tiles_w) * TW;
  const int y0 = (blockIdx.x / tiles_w) * TH;
  const int z0 = blockIdx.y * steps;
  const int u0 = z0 - 1;
  const int n_steps = min(steps, D - z0);

  // pixel i of slab u: input (u, y0 - 1 + i / 34, x0 - 1 + i % 34), zero
  // outside the volume (the SAME padding); ring slot (u - u0) % 4
  auto fetch = [&](int u, int i) -> unsigned short {
    const int iy = y0 - 1 + i / kK3Cols, ix = x0 - 1 + i % kK3Cols;
    const bool ok = u >= 0 && u < D && iy >= 0 && iy < H && ix >= 0 && ix < W;
    return ok ? xh[(((size_t)n * D + u) * H + iy) * W + ix] : 0;
  };
  for (int i = tid; i < 3 * UP; i += kThreadsTc)
    ring[((i / UP) & 3) * UP + i % UP] = fetch(u0 + i / UP, i % UP);
  // weights: row t (tap dz * 9 + dy * 3 + kx) holds 32 output channels,
  // zero for the padded taps 27-31, swizzled as conv_tc.cuh's
  for (int i = tid; i < 32 * 4; i += kThreadsTc) {
    const int q = i >> 2, j = i & 3;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (q < 27) v = *reinterpret_cast<const uint4*>(w + q * kC + j * 8);
    st_shared16(w_s + swz(q, j), v);
  }
  __syncthreads();

  // B fragments of the two k16 steps and four n-tiles, for the block's life
  uint32_t b[2][4][2];
  {
    const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int b_chunk = lane >> 4;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t r[4];
      ldsm_x4_t(w_s + swz(ks * 16 + b_row, b_chunk), r);
      b[ks][0][0] = r[0]; b[ks][0][1] = r[1];
      b[ks][1][0] = r[2]; b[ks][1][1] = r[3];
      ldsm_x4_t(w_s + swz(ks * 16 + b_row, 2 + b_chunk), r);
      b[ks][2][0] = r[0]; b[ks][2][1] = r[1];
      b[ks][3][0] = r[2]; b[ks][3][1] = r[3];
    }
  }
  // this lane's 8 taps (k = ks * 16 + 8 h + 2 (lane & 3) + e of the A
  // fragment): slab dz and offset dy * 34 + kx within it
  int tap_dz[2][2][2], tap_off[2][2][2];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = min(ks * 16 + 8 * h + 2 * (lane & 3) + e, 26);
        tap_dz[ks][h][e] = t / 9;
        tap_off[ks][h][e] = ((t % 9) / 3) * kK3Cols + t % 3;
      }
  unsigned char* st = stage + warp * 16 * kPixBytes;

  for (int s = 0; s < n_steps; ++s) {
    // the next step's new slab, fetched now and stored after the MMAs
    unsigned short pre[kNin3Pre];
    if (s + 1 < n_steps) {
#pragma unroll
      for (int k = 0; k < kNin3Pre; ++k) {
        const int i = tid + k * kThreadsTc;
        pre[k] = i < UP ? fetch(u0 + s + 3, i) : 0;
      }
    }
    int addr[2][2][2];  // ring index of each tap for output pixel (0, 0)
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          addr[ks][h][e] =
              ((s + tap_dz[ks][h][e]) & 3) * UP + tap_off[ks][h][e];
    const int z = z0 + s;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      // M-tile m: output row warp * 2 + m / 2, columns (m & 1) * 16 + 0..15;
      // this lane's A rows are columns + (lane >> 2) and + 8
      const int r = warp * 2 + (m >> 1), c = (m & 1) * 16 + (lane >> 2);
      const unsigned short* px = ring + r * kK3Cols + c;
      float acc[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t a[4];
#ifndef RSM_TC_CUT_A
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr)
            a[2 * h + rr] = (uint32_t)px[addr[ks][h][0] + 8 * rr] |
                            (uint32_t)px[addr[ks][h][1] + 8 * rr] << 16;
#else
        a[0] = a[1] = a[2] = a[3] = 0u;
#endif
#ifndef RSM_TC_CUT_MMA
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(&acc[nt * 4], a, b[ks][nt]);
#endif
      }
      const int oy = y0 + r, ox = x0 + (m & 1) * 16;
      store_tile16(acc, st, lane, scale, bias, act, 0.f, nullptr, out,
                   (((size_t)n * D + z) * H + oy) * W + ox,
                   oy < H ? min(16, W - ox) : 0);
    }
    if (s + 1 < n_steps) {
#pragma unroll
      for (int k = 0; k < kNin3Pre; ++k) {
        const int i = tid + k * kThreadsTc;
        if (i < UP) ring[((s + 3) & 3) * UP + i] = pre[k];
      }
    }
    __syncthreads();  // step s + 1's slab is in; step s's slot may refill
  }
}

// Launches one plan (kernels/cost_filter3d.py conv3d_tc_plan with the pair)
// of the 32 -> 1 or 1 -> 32 kernel.  Returns cudaErrorInvalidValue when the
// plan does not match it (tile shape, ring, shared-memory bytes, grid).
inline cudaError_t launch_conv3d_narrow_tc(
    const void* x, const void* w, const void* scale, const void* bias,
    void* out, int n, int d, int h, int wd, int cin, int cout, int th, int tw,
    int ring, int steps, int gx, int gy, int gz, int smem, int act,
    cudaStream_t st) {
  constexpr int TH = Tile<3>::TH, TW = Tile<3>::TW;
  const bool head = cin == kC && cout == 1, dx = cin == 1 && cout == kC;
  const int tiles_w = (wd + TW - 1) / TW, tiles_h = (h + TH - 1) / TH;
  if (!(head || dx) || th != TH || tw != TW || ring != kK3Ring ||
      steps < 1 || smem != conv3d_narrow_smem_bytes(cin) || gz != n ||
      gx != tiles_w * tiles_h || gy != (d + steps - 1) / steps ||
      gy > 65535 || gz > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid(gx, gy, gz);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  const auto* sf = static_cast<const float*>(scale);
  const auto* bf = static_cast<const float*>(bias);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  cudaError_t err;
  if (head) {
    static int opted[64] = {};  // per device
    err = opt_in_smem(conv3d_nout_tc_kernel, smem, opted);
    if (err != cudaSuccess) return err;
    conv3d_nout_tc_kernel<<<grid, kThreadsTc, smem, st>>>(xb, wb, sf, bf, ob,
                                                          d, h, wd, steps,
                                                          act);
  } else {
    static int opted[64] = {};
    err = opt_in_smem(conv3d_nin_tc_kernel, smem, opted);
    if (err != cudaSuccess) return err;
    conv3d_nin_tc_kernel<<<grid, kThreadsTc, smem, st>>>(xb, wb, sf, bf, ob,
                                                         d, h, wd, steps, act);
  }
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace rsm
