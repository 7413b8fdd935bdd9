// Tensor-core weight gradient of the bf16 training convolutions (dw_reduce.cu's
// entry point rsm_dw_reduce_tc):
//
//   2D  dW[ky, kx, ci, co]     = sum_{b,y,x} x[b, y+(ky-1)d, x+(kx-1)d, ci]
//                                            * g[b, y, x, co]
//   3D  dW[kz, ky, kx, ci, co] = sum_{b,z,y,x} x[b, z+kz-1, y+ky-1, x+kx-1, ci]
//                                              * g[b, z, y, x, co]
//
// x and g are bf16, contiguous (N, D, H, W, CI) and (N, D, H, W, CO) (D = 1
// in 2D); dW is float32 (KD, 3, 3, CI, CO).  Out-of-range taps read zero.
// The pairs (CI, CO): 32 -> 32; the refine entries' 4 -> 32 and 7 -> 32
// (2D) and the heads' 32 -> 1 (2D, and 3D for the cost-filter head).
//
// Replaces, in bf16, the Pallas TPU kernel K4 of the JAX package
// (realtime_stereo_matcher_tpu/kernels/train_conv.py dw_reduce, body
// _build_dw_kernel); the 3D form is the dW of flat_conv3d
// (kernels/train_conv3d.py), which the JAX package left to 18 XLA dots.
//
// The GEMM is the transpose of the forward conv's: M = (tap, ci), N = co,
// K = the pixels of g.  g and x are staged pixel-major, so both fragments
// come from ldmatrix.trans: A is x at the tap's shift, read as (ci, pixel),
// B is g, read as (pixel, co); mma.sync m16n8k16 accumulates in float32
// registers.  A 32-channel operand is staged as one 64-byte row a pixel by
// cp.async (the 16-byte-chunk XOR swizzle of conv_tc.cuh); a narrow one (x
// of 4 or 7 channels, g of 1) as one 16-byte chunk a pixel, zero-padded to
// 8 channels, through registers (conv_tc.cuh narrow_fetch / narrow_commit:
// the next step's pixels are fetched before this step's MMAs and stored
// after them).  With ci padded to 8, a warp's tap row (3 taps) is M = 24,
// two m16 tiles: (kx 0, kx 1) and (kx 2, zero), each A fragment's two
// halves at their own tap shifts (lanes address their own rows); with co
// padded to 8, N is one n8 tile.
//
// The rows of g are taken as one stack of N * D * H rows.  A block owns a
// strip of `tw` columns (16 to 80) and a chunk of that stack, and walks it
// kDwTH rows a step.  Its shared memory holds
//   ring  2 * kDwTH + 2 d rows of x, each tw + 2 d pixels (a d-column halo
//         on each side), filled one step ahead (zero padding at the left
//         and right image edges);
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
// Warps: 12; warp w owns tap row ky = w % 3 (its three taps kx = 0..2) and
// rows w / 3 and w / 3 + 4 of each step, so one B fragment (g) serves all
// the A fragments (x at the three kx shifts) of the row.  At 32 -> 32 a lane
// holds 96 float32 accumulators (3 taps x 2 halves of ci x 4 n-tiles of 8
// co) and a warp issues, per 16 pixels, 2 ldmatrix for g, 6 for x and 24
// MMAs; at 4 / 7 -> 32, 2 for g, 2 for x and 8 MMAs; at 32 -> 1, 1 for g, 6
// for x and 6 MMAs.  The tests on a row (its image, its tap rows' range, its
// ring slot) are made once a row.
//
// The sum over blocks has no atomics, so every run gives the same bits: the
// four warps of a tap row add their sums into shared memory in a fixed
// order, the block writes one partial dW (9 x CI x CO floats a depth tap) to
// the workspace, and dw_reduce.cu's dw_sum_kernel adds the partials in a
// fixed order.  The plan (kernels/train_conv.py dw_tc_plan) gives about one
// block an SM, so the workspace is ~130 partials (4.8 MB at 32 -> 32)
// against the 59-157 MB that the largest launches read.
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
constexpr int kDwRowsPerWarp = kDwTH / kDwSlices;
constexpr int kDwPre = 2;  // narrow pixels a thread fetches ahead

// the staging and the fragments of a pair
template <int CI, int CO>
struct DwPair {
  static constexpr int kXPix = CI == kC ? kPixBytes : 16;  // staged x pixel
  static constexpr int kGPix = CO == kC ? kPixBytes : 16;  // staged g pixel
  static constexpr int kMT = CI == kC ? 6 : 2;  // m16 tiles of a tap row
  static constexpr int kNT = CO == kC ? 4 : 1;  // n8 tiles
  static constexpr int kOut = 9 * CI * CO;      // dW entries of a depth tap
  // blocks an SM may hold: 32 -> 32 holds 96 accumulators a thread, the
  // narrow pairs at most 32 (two blocks then fit in the registers)
  static constexpr int kBlocks = CI == kC && CO == kC ? 1 : 2;
  // packed channel pairs a narrow pixel holds in registers (1 if not narrow)
  static constexpr int kXWords = CI == kC ? 1 : Narrow<CI>::kWords;
  static constexpr int kGWords = CO == kC ? 1 : Narrow<CO>::kWords;
};

// dynamic shared memory of a plan: the x ring and the two g buffers, or the
// block's partial dW if that is more
template <int CI, int CO>
__host__ __device__ inline int dw_smem_bytes(int tw, int dil, int ring) {
  using P = DwPair<CI, CO>;
  const int stream = ring * (tw + 2 * dil) * P::kXPix +
                     2 * kDwTH * tw * P::kGPix;
  return stream > P::kOut * 4 ? stream : P::kOut * 4;
}

// grid: x = column strips of tw, y = chunks of `steps` steps of kDwTH rows of
// the (N * D * H)-row stack, z = the depth tap kz (KD = 3; 1 block in 2D).
// partial[(p * KD + kz) * kOut + i], p = blockIdx.y * gridDim.x +
// blockIdx.x: the partials dw_sum_kernel adds as n_parts = gx * gy rows of
// KD * kOut.
template <int KD, int CI, int CO>
__global__ void __launch_bounds__(kDwThreads, DwPair<CI, CO>::kBlocks)
dw_tc_kernel(const __nv_bfloat16* __restrict__ x,
             const __nv_bfloat16* __restrict__ g,
             float* __restrict__ partial, int D, int H, int W, int rows,
             int dil, int tw, int ring, int steps) {
  using P = DwPair<CI, CO>;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring_s = (uint32_t)__cvta_generic_to_shared(smem);
  const int UP = tw + 2 * dil;                       // pixels of an x row
  const uint32_t g_s = ring_s + ring * UP * P::kXPix;
  const int g_buf = kDwTH * tw * P::kGPix;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kz = KD == 1 ? 1 : (int)blockIdx.z;
  const int xoff = (kz - 1) * H;          // x row of tap (kz, 1, 1) - g row
  const int x0 = blockIdx.x * tw;
  const int r0 = blockIdx.y * steps * kDwTH;         // first g row
  const int u0 = r0 + xoff - dil;                    // first x row
  const int n_steps = min(steps, (rows - r0 + kDwTH - 1) / kDwTH);

  // 32-channel x rows lo .. hi into their ring slots by cp.async (zero
  // outside): thread tid copies chunk tid & 3 of staged pixel tid >> 2
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
  // first x row of the rows step s brings (all of its rows for s = 0)
  auto x_lo = [&](int s) { return s == 0 ? u0 : u0 + s * kDwTH + 2 * dil; };
  // the 32-channel operands of step s by cp.async: its new x rows and its
  // g rows into buffer s & 1
  auto load_async = [&](int s) {
    if constexpr (CI == kC)
      load_x(x_lo(s), u0 + s * kDwTH + kDwTH - 1 + 2 * dil);
    if constexpr (CO == kC) {
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
    }
  };
  // narrow pixel i of step s: x at stack row x_lo(s) + i / UP, column
  // x0 - dil + i % UP; g at row r0 + s kDwTH + i / tw, column x0 + i % tw
  auto x_src = [&](int s, int i, bool& ok) {
    const int u = x_lo(s) + i / UP, ix = x0 - dil + i % UP;
    ok = u >= 0 && u < rows && ix >= 0 && ix < W;
    return x + ((size_t)(ok ? u : 0) * W + (ok ? ix : 0)) * CI;
  };
  auto x_slot = [&](int s, int i) {
    return ring_s + (uint32_t)(((x_lo(s) + i / UP - u0) % ring) * UP +
                               i % UP) * 16;
  };
  auto g_src = [&](int s, int i, bool& ok) {
    const int row = r0 + s * kDwTH + i / tw, ix = x0 + i % tw;
    ok = row < rows && ix < W;
    return g + ((size_t)(ok ? row : 0) * W + (ok ? ix : 0)) * CO;
  };
  auto g_slot = [&](int s, int i) {
    return g_s + (uint32_t)((s & 1) * g_buf + i * 16);
  };
  const int x_count = kDwTH * UP, g_count = kDwTH * tw;  // a later step's
  // step 0's narrow pixels, fetched and stored at once
  auto load_narrow_now = [&]() {
    if constexpr (CI != kC) {
      for (int i = tid; i < (kDwTH + 2 * dil) * UP; i += kDwThreads) {
        bool ok;
        const __nv_bfloat16* src = x_src(0, i, ok);
        uint32_t v[P::kXWords];
        narrow_fetch<CI>(src, ok, v);
        narrow_commit<CI>(x_slot(0, i), v);
      }
    }
    if constexpr (CO != kC) {
      for (int i = tid; i < g_count; i += kDwThreads) {
        bool ok;
        const __nv_bfloat16* src = g_src(0, i, ok);
        uint32_t v[P::kGWords];
        narrow_fetch<CO>(src, ok, v);
        narrow_commit<CO>(g_slot(0, i), v);
      }
    }
  };
  // a later step's narrow pixels: kDwPre a thread (the plan keeps both
  // counts within kDwPre * kDwThreads)
  uint32_t pre_x[kDwPre][P::kXWords], pre_g[kDwPre][P::kGWords];
  auto fetch_ahead = [&](int s) {
#pragma unroll
    for (int k = 0; k < kDwPre; ++k) {
      const int i = tid + k * kDwThreads;
      bool ok = false;
      if constexpr (CI != kC)
        narrow_fetch<CI>(i < x_count ? x_src(s, i, ok) : x, ok, pre_x[k]);
      ok = false;
      if constexpr (CO != kC)
        narrow_fetch<CO>(i < g_count ? g_src(s, i, ok) : g, ok, pre_g[k]);
    }
  };
  auto commit_ahead = [&](int s) {
#pragma unroll
    for (int k = 0; k < kDwPre; ++k) {
      const int i = tid + k * kDwThreads;
      if constexpr (CI != kC)
        if (i < x_count) narrow_commit<CI>(x_slot(s, i), pre_x[k]);
      if constexpr (CO != kC)
        if (i < g_count) narrow_commit<CO>(g_slot(s, i), pre_g[k]);
    }
  };

  const int ky = warp % 3, slice = warp / 3;
  // ldmatrix.trans row addresses: 32-channel x matrices are (pixels 0-7,
  // ci 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15); narrow x matrices of
  // tile 0 are (pixels 0-7, kx 0), (0-7, kx 1), (8-15, kx 0), (8-15, kx 1),
  // a_chunk standing for kx; g matrices are (pixels 0-7, co tile 0),
  // (8-15, 0), (0-7, 1), (8-15, 1) of a pair of n-tiles
  const int a_pix = (lane & 7) + (lane >> 4) * 8;
  const int a_chunk = (lane >> 3) & 1;
  const int b_pix = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int b_chunk = lane >> 4;

  // acc[mt][nt * 4 + e]: m-tile mt (32 channels: tap kx = mt / 2, ci half
  // mt % 2; narrow: taps kx = 2 mt and 2 mt + 1), n-tile nt
  float acc[P::kMT][P::kNT * 4];
#pragma unroll
  for (int mt = 0; mt < P::kMT; ++mt)
#pragma unroll
    for (int e = 0; e < P::kNT * 4; ++e) acc[mt][e] = 0.f;

  load_async(0);
  load_narrow_now();
  cp_async_commit();
  for (int s = 0; s < n_steps; ++s) {
    if (s + 1 < n_steps) {
      load_async(s + 1);
      cp_async_commit();
      fetch_ahead(s + 1);
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
        uint32_t b[P::kNT][2];
        if constexpr (P::kNT == 4) {
          uint32_t t[4];
          ldsm_x4_t(gb + swz(r * tw + c0 + b_pix, b_chunk), t);  // n-tiles 0, 1
          b[0][0] = t[0]; b[0][1] = t[1]; b[1][0] = t[2]; b[1][1] = t[3];
          ldsm_x4_t(gb + swz(r * tw + c0 + b_pix, 2 + b_chunk), t);  // 2, 3
          b[2][0] = t[0]; b[2][1] = t[1]; b[3][0] = t[2]; b[3][1] = t[3];
        } else {  // one n-tile: pixels 0-7 and 8-15 of 16-byte rows
          ldsm_x2_t(gb + (r * tw + c0 + (lane & 15)) * 16, b[0]);
        }
#pragma unroll
        for (int mt = 0; mt < P::kMT; ++mt) {
          uint32_t a[4];
#ifndef RSM_TC_CUT_A
          if constexpr (CI == kC) {
            ldsm_x4_t(ring_s + swz(unit + c0 + (mt >> 1) * dil + a_pix,
                                   2 * (mt & 1) + a_chunk),
                      a);
          } else if (mt == 0) {  // taps kx 0 (m 0-7) and 1 (m 8-15)
            ldsm_x4_t(ring_s + (unit + c0 + a_chunk * dil + a_pix) * 16, a);
          } else {  // tap kx 2 (m 0-7), zero (m 8-15)
            uint32_t t[2];
            ldsm_x2_t(ring_s + (unit + c0 + 2 * dil + (lane & 15)) * 16, t);
            a[0] = t[0]; a[1] = 0u; a[2] = t[1]; a[3] = 0u;
          }
#else
          a[0] = a[1] = a[2] = a[3] = 0u;
#endif
#ifndef RSM_TC_CUT_MMA
#pragma unroll
          for (int nt = 0; nt < P::kNT; ++nt)
            mma_bf16(&acc[mt][nt * 4], a, b[nt]);
#endif
        }
      }
    }
    if (s + 1 < n_steps) commit_ahead(s + 1);
    __syncthreads();  // the ring slots and g buffer of step s may be refilled
  }

  // the block's partial dW: the four slices of each tap row added in order
  // in shared memory (no copy in flight: the last step waited for all)
  float* red = reinterpret_cast<float*>(smem);
  for (int sl = 0; sl < kDwSlices; ++sl) {
    if (slice == sl) {
#pragma unroll
      for (int mt = 0; mt < P::kMT; ++mt)
#pragma unroll
        for (int e = 0; e < P::kNT * 4; ++e) {
          const int nt = e >> 2, f = e & 3;
          const int m = (lane >> 2) + 8 * (f >> 1);  // row of the m-tile
          const int co = nt * 8 + (lane & 3) * 2 + (f & 1);
          const int kx = CI == kC ? mt >> 1 : 2 * mt + (m >> 3);
          const int ci = CI == kC ? 16 * (mt & 1) + m : m & 7;
          if (kx < 3 && ci < CI && co < CO) {
            float* p = red + ((ky * 3 + kx) * CI + ci) * CO + co;
            *p = sl == 0 ? acc[mt][e] : *p + acc[mt][e];
          }
        }
    }
    __syncthreads();
  }
  const size_t part = (size_t)(blockIdx.y * gridDim.x + blockIdx.x) * KD +
                      (KD == 1 ? 0 : kz);
  float4* out = reinterpret_cast<float4*>(partial + part * P::kOut);
  for (int i = tid; i < P::kOut / 4; i += kDwThreads)
    out[i] = reinterpret_cast<const float4*>(red)[i];
}

}  // namespace tc
}  // namespace rsm
