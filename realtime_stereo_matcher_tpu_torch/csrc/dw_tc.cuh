// Tensor-core weight gradient of the bf16 32 -> 32 training convolutions
// (dw_reduce.cu's entry point rsm_dw_reduce_tc):
//
//   2D  dW[ky, kx, ci, co]     = sum_{b,y,x} x[b, y+(ky-1)d, x+(kx-1)d, ci]
//                                            * g[b, y, x, co]
//   3D  dW[kz, ky, kx, ci, co] = sum_{b,z,y,x} x[b, z+kz-1, y+ky-1, x+kx-1, ci]
//                                              * g[b, z, y, x, co]
//
// x and g are bf16, contiguous (N, D, H, W, 32) (D = 1 in 2D); dW is float32
// (KD, 3, 3, 32, 32).  Out-of-range taps read zero.
//
// Replaces, at bf16 32 -> 32, the Pallas TPU kernel K4 of the JAX package
// (realtime_stereo_matcher_tpu/kernels/train_conv.py dw_reduce, body
// _build_dw_kernel); the 3D form is the dW of flat_conv3d
// (kernels/train_conv3d.py), which the JAX package left to 18 XLA dots.
//
// The GEMM is the transpose of the forward conv's: M = (tap, ci), N = co =
// 32, K = the pixels of g.  g and x are staged pixel-major (one 64-byte row
// per pixel, the 16-byte-chunk XOR swizzle of conv_tc.cuh), so both
// fragments come from ldmatrix.trans: A is x at the tap's shift, read as
// (ci, pixel), B is g, read as (pixel, co); mma.sync m16n8k16 accumulates in
// float32 registers.
//
// The rows of g are taken as one stack of N * D * H rows.  A block owns a
// strip of `tw` columns (16 to 80) and a chunk of that stack, and walks it
// kDwTH rows a step.  Its shared memory holds
//   ring  2 * kDwTH + 2 d rows of x, each tw + 2 d pixels (a d-column halo
//         on each side), filled by cp.async one step ahead (src-size 0 is
//         the zero padding at the left and right image edges);
//   g     two buffers of kDwTH rows of tw pixels.
// A wider strip runs more MMAs for each step's fixed costs (its barriers,
// its row tests, its halo), so the plan takes the widest strip that pads the
// image least.  More loads in flight did not help (a third stage, an L2
// prefetch of the rows two steps ahead: PERF.md); the MMA issue rate holds
// it back.
// The x row a g row reads at tap row ky is ky - 1 rows of dilation away in
// the stack (and, in 3D, (kz - 1) * H rows further for the depth tap kz):
// where that row lies in another image, plane or outside the stack the tap
// reads zero, so the warp skips it (the test is the same for the whole
// warp).  In 3D the depth tap kz is the grid's z: each block reduces the 9
// taps of one kz, 2D's problem with x shifted by whole planes.
//
// Warps: 12; warp w owns tap row ky = w % 3 (its three taps kx = 0..2, 96
// float32 accumulators a lane: 3 taps x 2 halves of ci x 4 n-tiles of 8 co)
// and rows w / 3 and w / 3 + 4 of each step, so one B fragment (g) serves
// three A fragments (x at the three kx shifts).  Per 16 pixels a warp issues
// 2 ldmatrix for g, 6 for x and 24 MMAs; the tests on a row (its image, its
// tap rows' range, its ring slot) are made once a row, and each thread
// copies at most one 16-byte chunk of each staged row.
//
// The sum over blocks has no atomics, so every run gives the same bits: the
// four warps of a tap row add their sums into shared memory in a fixed
// order, the block writes one partial dW (9 x 32 x 32 floats) to the
// workspace, and dw_reduce.cu's dw_sum_kernel adds the partials in a fixed
// order.  The plan (kernels/train_conv.py dw_tc_plan) gives about one block
// an SM, so the workspace is ~130 partials (4.8 MB) against the 59-157 MB
// that the largest launches read.
//
// RSM_TC_CUT_A and RSM_TC_CUT_MMA (conv_tc.cuh) cut the x fragment loads or
// the MMAs out of this kernel too (its results are then wrong); no build of
// the package defines them.
#pragma once

#include "conv_tc.cuh"

namespace rsm {
namespace tc {

constexpr int kDwWarps = 12;
constexpr int kDwThreads = kDwWarps * 32;
constexpr int kDwTH = 8;                  // g rows a step
constexpr int kDwSlices = kDwWarps / 3;   // warps of one tap row
constexpr int kDwOut = 9 * kC * kC;       // dW entries of one depth tap
constexpr int kDwRowsPerWarp = kDwTH / kDwSlices;

// dynamic shared memory of a plan: the x ring and the two g buffers, or the
// 36 KB of the block's partial dW if that is more
__host__ __device__ inline int dw_smem_bytes(int tw, int dil, int ring) {
  const int stream = (ring * (tw + 2 * dil) + 2 * kDwTH * tw) * kPixBytes;
  return stream > kDwOut * 4 ? stream : kDwOut * 4;
}

// grid: x = column strips of tw, y = chunks of `steps` steps of kDwTH rows of
// the (N * D * H)-row stack, z = the depth tap kz (KD = 3; 1 block in 2D).
// partial[(p * KD + kz) * kDwOut + i], p = blockIdx.y * gridDim.x +
// blockIdx.x: the partials dw_sum_kernel adds as n_parts = gx * gy rows of
// KD * kDwOut.
template <int KD>
__global__ void __launch_bounds__(kDwThreads, 1)
dw_tc_kernel(const __nv_bfloat16* __restrict__ x,
             const __nv_bfloat16* __restrict__ g,
             float* __restrict__ partial, int D, int H, int W, int rows,
             int dil, int tw, int ring, int steps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring_s = (uint32_t)__cvta_generic_to_shared(smem);
  const int UP = tw + 2 * dil;                       // pixels of an x row
  const uint32_t g_s = ring_s + ring * UP * kPixBytes;
  const int g_buf = kDwTH * tw * kPixBytes;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kz = KD == 1 ? 1 : (int)blockIdx.z;
  const int xoff = (kz - 1) * H;          // x row of tap (kz, 1, 1) - g row
  const int x0 = blockIdx.x * tw;
  const int r0 = blockIdx.y * steps * kDwTH;         // first g row
  const int u0 = r0 + xoff - dil;                    // first x row
  const int n_steps = min(steps, (rows - r0 + kDwTH - 1) / kDwTH);

  // x rows lo .. hi of the stack into their ring slots (zero outside):
  // thread tid copies chunk tid & 3 of staged pixel tid >> 2 of each row
  auto load_x = [&](int lo, int hi) {
    const int p = tid >> 2, j = tid & 3, ix = x0 - dil + p;
    if (p >= UP) return;
    const bool col_ok = ix >= 0 && ix < W;
    for (int u = lo; u <= hi; ++u) {
      const bool ok = col_ok && u >= 0 && u < rows;
      const __nv_bfloat16* src =
          ok ? x + ((size_t)u * W + ix) * kC + j * 8 : x;
      cp_async16(ring_s + swz(((u - u0) % ring) * UP + p, j), src, ok);
    }
  };
  // the g rows of step s into buffer s & 1, and the x rows step s needs
  // beyond those of step s - 1 (all of them for s = 0)
  auto load_step = [&](int s) {
    const int lo = s == 0 ? u0 : u0 + s * kDwTH + 2 * dil;
    load_x(lo, u0 + s * kDwTH + kDwTH - 1 + 2 * dil);
    const int p = tid >> 2, j = tid & 3;
    if (p >= tw) return;
    const uint32_t base = g_s + (s & 1) * g_buf;
    for (int r = 0; r < kDwTH; ++r) {
      const int row = r0 + s * kDwTH + r;
      const bool ok = row < rows && x0 + p < W;
      const __nv_bfloat16* src =
          ok ? g + ((size_t)row * W + x0 + p) * kC + j * 8 : g;
      cp_async16(base + swz(r * tw + p, j), src, ok);
    }
  };

  const int ky = warp % 3, slice = warp / 3;
  // ldmatrix.trans row addresses: A (x) matrices are (pixels 0-7, ci 0-7),
  // (0-7, 8-15), (8-15, 0-7), (8-15, 8-15); B (g) matrices are (pixels 0-7,
  // co tile 0), (8-15, 0), (0-7, 1), (8-15, 1) of a pair of n-tiles
  const int a_pix = (lane & 7) + (lane >> 4) * 8;
  const int a_chunk = (lane >> 3) & 1;
  const int b_pix = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int b_chunk = lane >> 4;

  // acc[kx][h][nt * 4 + e]: tap (ky, kx), ci half h, n-tile nt
  float acc[3][2][16];
#pragma unroll
  for (int kx = 0; kx < 3; ++kx)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[kx][h][e] = 0.f;

  load_step(0);
  cp_async_commit();
  for (int s = 0; s < n_steps; ++s) {
    if (s + 1 < n_steps) {
      load_step(s + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t gb = g_s + (s & 1) * g_buf;
#pragma unroll
    for (int rr = 0; rr < kDwRowsPerWarp; ++rr) {
      const int r = slice + rr * kDwSlices;
      const int row = r0 + s * kDwTH + r;
      if (row >= rows) break;
      const int y = row % H + (ky - 1) * dil;
      if (y < 0 || y >= H) continue;   // the tap row reads zero padding
      if constexpr (KD == 3) {
        const int z = (row / H) % D + kz - 1;
        if (z < 0 || z >= D) continue;
      }
      // the x row of tap row ky: stack row row + xoff + (ky - 1) d
      const int unit = ((s * kDwTH + r + ky * dil) % ring) * UP;
      for (int c0 = 0; c0 < tw && x0 + c0 < W; c0 += 16) {
        uint32_t b[4][2];
        {
          uint32_t t[4];
          ldsm_x4_t(gb + swz(r * tw + c0 + b_pix, b_chunk), t);  // n-tiles 0, 1
          b[0][0] = t[0]; b[0][1] = t[1]; b[1][0] = t[2]; b[1][1] = t[3];
          ldsm_x4_t(gb + swz(r * tw + c0 + b_pix, 2 + b_chunk), t);  // 2, 3
          b[2][0] = t[0]; b[2][1] = t[1]; b[3][0] = t[2]; b[3][1] = t[3];
        }
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t a[4];
#ifndef RSM_TC_CUT_A
            ldsm_x4_t(ring_s + swz(unit + c0 + kx * dil + a_pix,
                                   2 * h + a_chunk),
                      a);
#else
            a[0] = a[1] = a[2] = a[3] = 0u;
#endif
#ifndef RSM_TC_CUT_MMA
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
              mma_bf16(&acc[kx][h][nt * 4], a, b[nt]);
#endif
          }
        }
      }
    }
    __syncthreads();  // the ring slots and g buffer of step s may be refilled
  }

  // the block's partial dW: the four slices of each tap row added in order
  // in shared memory (no copy in flight: the last step waited for all)
  float* red = reinterpret_cast<float*>(smem);
  for (int sl = 0; sl < kDwSlices; ++sl) {
    if (slice == sl) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            const int nt = e >> 2, f = e & 3;
            const int ci = 16 * h + (lane >> 2) + 8 * (f >> 1);
            const int co = nt * 8 + (lane & 3) * 2 + (f & 1);
            float* p = red + ((ky * 3 + kx) * kC + ci) * kC + co;
            *p = sl == 0 ? acc[kx][h][e] : *p + acc[kx][h][e];
          }
    }
    __syncthreads();
  }
  const size_t part = (size_t)(blockIdx.y * gridDim.x + blockIdx.x) * KD +
                      (KD == 1 ? 0 : kz);
  float4* out = reinterpret_cast<float4*>(partial + part * kDwOut);
  for (int i = tid; i < kDwOut / 4; i += kDwThreads)
    out[i] = reinterpret_cast<const float4*>(red)[i];
}

}  // namespace tc
}  // namespace rsm
