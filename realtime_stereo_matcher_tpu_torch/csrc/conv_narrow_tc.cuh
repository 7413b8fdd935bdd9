// Tensor-core implicit GEMM of the bf16 stride-1 3x3 convolutions whose input
// or output is narrow (conv3x3.cu's entry point rsm_conv3x3_tc):
//
//   narrow in   C_in = 1, 3, 4 or 7 -> 32: the refine entries (v1 4 -> 32,
//               v2 7 -> 32), the v3 U-Net stem (3 -> 32) and the dx of the
//               refine heads (1 -> 32);
//   narrow out  32 -> C_out = 1, 4 or 7: the refine heads (32 -> 1) and the
//               dx of the refine entries (32 -> 4, 32 -> 7).
//
// Layouts as in conv_tc.cuh (NHWC, HWIO, bf16; scale and bias float32 of
// C_out), any dilation; the epilogue is conv_common.cuh's.
//
// Replaces, at these pairs, the Pallas TPU kernel K1 of the JAX package
// (realtime_stereo_matcher_tpu/kernels/conv3x3.py fused_conv3x3_flat), which
// zero-pads C_in and C_out up to 32 (c_in_pad, c_out_pad) into its 32 -> 32
// matrix-unit contraction.  Padding to 32 here would waste 3/4 or more of
// every MMA and of every staged byte; the pairs are padded to 8 instead.
//
// What bounds them on an H100: bytes.  Narrow in writes 64-byte output
// pixels and reads 2-14 bytes a pixel (720 x 1280, 4 -> 32: 66 MB, 0.020 ms
// at 3.35 TB/s, against 1.2 M MMAs); narrow out reads 64-byte input pixels.
// Both walk a 64-column strip down 8 rows a step with conv_tc.cuh's ring, as
// the 32 -> 32 kernel does, and keep their B fragments (the weights) in
// registers for the block's life.
//
// Narrow in.  An input pixel is staged as one 16-byte chunk, its channels
// zero-padded to 8 (conv_tc.cuh narrow_fetch / narrow_commit: register-staged,
// the next step's pixels fetched before this step's MMAs and stored after),
// so a ring row is 64 + 2 d chunks and any 8 consecutive pixels are 128
// contiguous bytes (no swizzle needed).  K packs the taps as the JAX fold
// does: k = tap x 8 + ci, 72, padded to 80, five k16 steps, the taps two to
// a step.  An A fragment is four 8 x 8 ldmatrix tiles, each lane addressing
// its own row, so its k 0-7 half comes from tap 2 j and its k 8-15 half
// from tap 2 j + 1, each at its own row and column offset; the fifth step's
// k 8-15 half (a tenth tap) is zero in registers (ldmatrix.x2 loads the
// first half) and in the weights.  Per 16 output pixels: 5 ldmatrix and 20
// MMAs, then conv_tc.cuh's epilogue (store_tile16: 16-byte staged stores).
//
// Narrow out.  A fragments come from the 32-channel ring exactly as in
// conv_tc.cuh (cp.async, swizzled 64-byte rows); B is the 288 x 8 weight
// matrix, C_out zero-padded to 8: one n8 tile, 18 MMAs per 16 pixels.  A
// warp's output row (64 pixels x C_out channels, 128 to 896 contiguous
// bytes) is staged compactly in its 1 KB of shared memory and stored by
// consecutive lanes, not as scattered 2- to 14-byte pixels.
//
// RSM_TC_CUT_A, RSM_TC_CUT_MMA and RSM_TC_CUT_STORE (conv_tc.cuh) cut the A
// fragment loads, the MMAs or the output stores out of these kernels too;
// no build of the package defines them.
#pragma once

#include "conv_tc.cuh"

namespace rsm {
namespace tc {

constexpr int kNarrowPix = 16;                    // a staged narrow pixel
constexpr int kNinK = 80;                         // 9 taps x 8, padded
constexpr int kNinWBytes = kNinK * kPixBytes;     // 80 rows of 32 co
constexpr int kNoutWBytes = 9 * kC * kNarrowPix;  // 288 rows of 8 co
constexpr int kNinPre = 3;  // pixels a thread fetches ahead: 8 rows of <= 96

__host__ __device__ inline int nin_smem_bytes(int dil, int ring) {
  return kNinWBytes + ring * (Tile<1>::TW + 2 * dil) * kNarrowPix +
         kStageBytes;
}
__host__ __device__ inline int nout_smem_bytes(int dil, int ring) {
  return kNoutWBytes + ring * (Tile<1>::TW + 2 * dil) * kPixBytes +
         kStageBytes;
}

// grid: x = column strips of 64, y = row chunks of steps * 8, z = N.
template <int CI>
__global__ void __launch_bounds__(kThreadsTc, 2)
conv_nin_tc_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ w,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias,
                   const __nv_bfloat16* __restrict__ res,
                   __nv_bfloat16* __restrict__ out, int H, int W, int dil,
                   int ring, int steps, int act, float alpha) {
  constexpr int TH = Tile<1>::TH, TW = Tile<1>::TW;
  constexpr int kWords = Narrow<CI>::kWords;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t w_s = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t ring_s = w_s + kNinWBytes;
  const int UP = TW + 2 * dil;  // staged pixels of an input row
  unsigned char* stage = smem + kNinWBytes + ring * UP * kNarrowPix;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = blockIdx.z;
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * steps * TH;  // first output row
  const int u0 = y0 - dil;                 // first input row of the ring
  const int n_steps = min(steps, (H - y0 + TH - 1) / TH);

  // pixel i of the rows from lo: input (lo + i / UP, x0 - dil + i % UP),
  // and its ring slot
  auto src_of = [&](int lo, int i, bool& ok) {
    const int u = lo + i / UP, ix = x0 - dil + i % UP;
    ok = u >= 0 && u < H && ix >= 0 && ix < W;
    return x + (((size_t)n * H + (ok ? u : 0)) * W + (ok ? ix : 0)) * CI;
  };
  auto slot_of = [&](int lo, int i) {
    return ring_s +
           (uint32_t)((((lo + i / UP) - u0) % ring) * UP + i % UP) * kNarrowPix;
  };
  // `rows` rows from lo, fetched and stored at once (the first step's)
  auto load_rows = [&](int lo, int rows) {
    for (int i = tid; i < rows * UP; i += kThreadsTc) {
      bool ok;
      const __nv_bfloat16* src = src_of(lo, i, ok);
      uint32_t v[kWords];
      narrow_fetch<CI>(src, ok, v);
      narrow_commit<CI>(slot_of(lo, i), v);
    }
  };
  // the TH new rows from lo of the next step: fetched into registers before
  // this step's MMAs, stored after them (the rest at once, where a row is
  // longer than kNinPre * 256 / TH pixels: dilations above 16)
  uint32_t pre[kNinPre][kWords];
  auto fetch_ahead = [&](int lo) {
#pragma unroll
    for (int k = 0; k < kNinPre; ++k) {
      const int i = tid + k * kThreadsTc;
      bool ok = false;
      const __nv_bfloat16* src = i < TH * UP ? src_of(lo, i, ok) : x;
      narrow_fetch<CI>(src, ok, pre[k]);
    }
  };
  auto commit_ahead = [&](int lo) {
#pragma unroll
    for (int k = 0; k < kNinPre; ++k) {
      const int i = tid + k * kThreadsTc;
      if (i < TH * UP) narrow_commit<CI>(slot_of(lo, i), pre[k]);
    }
    for (int i = tid + kNinPre * kThreadsTc; i < TH * UP; i += kThreadsTc) {
      bool ok;
      const __nv_bfloat16* src = src_of(lo, i, ok);
      uint32_t v[kWords];
      narrow_fetch<CI>(src, ok, v);
      narrow_commit<CI>(slot_of(lo, i), v);
    }
  };

  // weights: row q = tap * 8 + ci holds 32 output channels (zero for
  // ci >= CI and for the tenth tap, rows 72-79), swizzled as conv_tc.cuh's
  for (int i = tid; i < kNinK * 4; i += kThreadsTc) {
    const int q = i >> 2, j = i & 3, t = q >> 3, ci = q & 7;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (t < 9 && ci < CI)
      v = *reinterpret_cast<const uint4*>(w + ((size_t)t * CI + ci) * kC +
                                          j * 8);
    st_shared16(w_s + swz(q, j), v);
  }
  load_rows(u0, TH + 2 * dil);
  __syncthreads();

  // B fragments of the five k16 steps and four n-tiles, for the block's life
  uint32_t b[5][4][2];
  {
    const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8;  // k within 16
    const int b_chunk = lane >> 4;                         // n-tile of a pair
#pragma unroll
    for (int ks = 0; ks < 5; ++ks) {
      uint32_t r[4];
      ldsm_x4_t(w_s + swz(ks * 16 + b_row, b_chunk), r);  // n-tiles 0, 1
      b[ks][0][0] = r[0]; b[ks][0][1] = r[1];
      b[ks][1][0] = r[2]; b[ks][1][1] = r[3];
      ldsm_x4_t(w_s + swz(ks * 16 + b_row, 2 + b_chunk), r);  // 2, 3
      b[ks][2][0] = r[0]; b[ks][2][1] = r[1];
      b[ks][3][0] = r[2]; b[ks][3][1] = r[3];
    }
  }
  // A: this lane addresses pixel a_pix of an M-tile at tap 2 ks + a_tap
  const int a_pix = lane & 15, a_tap = lane >> 4;
  unsigned char* st = stage + warp * 16 * kPixBytes;

  for (int s = 0; s < n_steps; ++s) {
    const int lo_next = y0 + (s + 1) * TH + dil;
    if (s + 1 < n_steps) fetch_ahead(lo_next);
    const int oy = y0 + s * TH + warp;  // this warp's output row
    int a_off[5];  // ring pixel of this lane's row at M-tile 0, per k16 step
#pragma unroll
    for (int ks = 0; ks < 5; ++ks) {
      const int t = min(2 * ks + a_tap, 8);
      const int u = oy + (t / 3 - 1) * dil;
      a_off[ks] = ((u - u0) % ring) * UP + (t % 3) * dil + a_pix;
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      float acc[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 5; ++ks) {
        uint32_t a[4];
        const uint32_t addr =
            ring_s + (uint32_t)(a_off[ks] + m * 16) * kNarrowPix;
#ifndef RSM_TC_CUT_A
        if (ks < 4) {
          ldsm_x4(addr, a);
        } else {  // taps 8 and (zero) 9
          ldsm_x2(addr, a);
          a[2] = a[3] = 0u;
        }
#else
        (void)addr;
        a[0] = a[1] = a[2] = a[3] = 0u;
#endif
#ifndef RSM_TC_CUT_MMA
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(&acc[nt * 4], a, b[ks][nt]);
#endif
      }
      const int ox = x0 + m * 16;
      store_tile16(acc, st, lane, scale, bias, act, alpha, res, out,
                   ((size_t)n * H + oy) * W + ox,
                   oy < H ? min(16, W - ox) : 0);
    }
    if (s + 1 < n_steps) commit_ahead(lo_next);
    __syncthreads();  // step s + 1's rows are in; step s's slots may refill
  }
}

// grid: x = column strips of 64, y = row chunks of steps * 8, z = N.
template <int CO>
__global__ void __launch_bounds__(kThreadsTc, 2)
conv_nout_tc_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ w,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias,
                    const __nv_bfloat16* __restrict__ res,
                    __nv_bfloat16* __restrict__ out, int H, int W, int dil,
                    int ring, int steps, int act, float alpha) {
  constexpr int TH = Tile<1>::TH, TW = Tile<1>::TW;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t w_s = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t ring_s = w_s + kNoutWBytes;
  const int UP = TW + 2 * dil;
  unsigned char* stage = smem + kNoutWBytes + ring * UP * kPixBytes;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = blockIdx.z;
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * steps * TH;
  const int u0 = y0 - dil;
  const int n_steps = min(steps, (H - y0 + TH - 1) / TH);

  auto load_step = [&](int s) {
    load_units<1, TH, TW>(ring_s, x, n, 1, H, W, x0, y0, dil, UP, ring, u0,
                          s == 0 ? u0 : y0 + s * TH + dil,
                          y0 + s * TH + TH - 1 + dil, tid);
  };
  load_step(0);
  cp_async_commit();
  // weights: row q = tap * 32 + ci holds output channels 0 .. CO - 1,
  // zero-padded to 8 (16 bytes)
  for (int q = tid; q < 9 * kC; q += kThreadsTc) {
    uint32_t v[Narrow<CO>::kWords];
    narrow_fetch<CO>(w + (size_t)q * CO, true, v);
    narrow_commit<CO>(w_s + q * kNarrowPix, v);
  }
  __syncthreads();

  // B fragments of the 18 k16 steps (tap t, ci half kk) of the one n-tile
  uint32_t b[9][2][2];
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    uint32_t r[4];
    ldsm_x4_t(w_s + (t * kC + lane) * kNarrowPix, r);
    b[t][0][0] = r[0]; b[t][0][1] = r[1];
    b[t][1][0] = r[2]; b[t][1][1] = r[3];
  }
  // this lane's output channels in the D fragment, and their epilogue
  float sc[2], bi[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int co = (lane & 3) * 2 + e;
    sc[e] = co < CO ? __ldg(scale + co) : 0.f;
    bi[e] = co < CO ? __ldg(bias + co) : 0.f;
  }
  const int a_pix = lane & 15, a_chunk = lane >> 4;
  __nv_bfloat16* st =
      reinterpret_cast<__nv_bfloat16*>(stage + warp * 16 * kPixBytes);

  for (int s = 0; s < n_steps; ++s) {
    if (s + 1 < n_steps) {
      load_step(s + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int oy = y0 + s * TH + warp;  // this warp's output row

    float acc[4][4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][e] = 0.f;
#pragma unroll
    for (int o = 0; o < 3; ++o) {
      const int unit = ((oy + (o - 1) * dil - u0) % ring) * UP;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            uint32_t a[4];
#ifndef RSM_TC_CUT_A
            ldsm_x4(ring_s + swz(unit + a_pix + m * 16 + i * dil,
                                 kk * 2 + a_chunk),
                    a);
#else
            a[0] = a[1] = a[2] = a[3] = 0u;
#endif
#ifndef RSM_TC_CUT_MMA
            mma_bf16(acc[m], a, b[o * 3 + i][kk]);
#endif
          }
        }
      }
    }

    // epilogue: y = acc * scale + bias, activation, bf16, staged compactly
    // (pixel p, channel co at p * CO + co), then + res (rounded to bf16
    // again) and stored by consecutive lanes
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int p = m * 16 + (lane >> 2) + 8 * h;
          const int co = (lane & 3) * 2 + e;
          if (co < CO) {
            float v = fmaf(acc[m][2 * h + e], sc[e], bi[e]);
            if (act == kActRelu) {
              v = fmaxf(v, 0.f);
            } else if (act == kActLeaky) {
              v = fmaxf(v, 0.f) + alpha * fminf(v, 0.f);
            }
            st[p * CO + co] = __float2bfloat16_rn(v);
          }
        }
    __syncwarp();
    const int valid = oy < H ? min(TW, W - x0) * CO : 0;
    const size_t base = (((size_t)n * H + oy) * W + x0) * CO;
    for (int e = lane; e < valid; e += 32) {
      __nv_bfloat16 v = st[e];
      if (res != nullptr)
        v = __float2bfloat16_rn(__bfloat162float(v) +
                                __bfloat162float(res[base + e]));
#ifndef RSM_TC_CUT_STORE
      out[base + e] = v;
#else
      (void)v;
#endif
    }
    __syncwarp();
    __syncthreads();  // the ring slots of step s may be refilled now
  }
}

// Launches one plan (kernels/conv3x3.py conv3x3_tc_plan with the pair) of
// the narrow-in (CO == 32) or narrow-out (CI == 32) kernel.  Returns
// cudaErrorInvalidValue when the plan does not match it.
template <int CI, int CO>
cudaError_t launch_narrow_tc(const void* x, const void* w, const void* scale,
                             const void* bias, const void* res, void* out,
                             int n, int h, int wd, int dil, int th, int tw,
                             int ring, int steps, int gx, int gy, int gz,
                             int smem, int act, float alpha,
                             cudaStream_t st) {
  static_assert((CO == kC) != (CI == kC), "one side narrow");
  constexpr int TH = Tile<1>::TH, TW = Tile<1>::TW;
  const int want = CO == kC ? nin_smem_bytes(dil, ring)
                            : nout_smem_bytes(dil, ring);
  const int tiles_w = (wd + TW - 1) / TW, tiles_h = (h + TH - 1) / TH;
  if (th != TH || tw != TW || ring != 2 * TH + 2 * dil || steps < 1 ||
      smem != want || gx != tiles_w || gy != (tiles_h + steps - 1) / steps ||
      gy > 65535 || gz != n)
    return cudaErrorInvalidValue;
  static int opted[64] = {};  // per device, for this instantiation
  const dim3 grid(gx, gy, gz);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  const auto* sf = static_cast<const float*>(scale);
  const auto* bf = static_cast<const float*>(bias);
  const auto* rb = static_cast<const __nv_bfloat16*>(res);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  cudaError_t err;
  if constexpr (CO == kC) {
    err = opt_in_smem(conv_nin_tc_kernel<CI>, smem, opted);
    if (err != cudaSuccess) return err;
    conv_nin_tc_kernel<CI><<<grid, kThreadsTc, smem, st>>>(
        xb, wb, sf, bf, rb, ob, h, wd, dil, ring, steps, act, alpha);
  } else {
    err = opt_in_smem(conv_nout_tc_kernel<CO>, smem, opted);
    if (err != cudaSuccess) return err;
    conv_nout_tc_kernel<CO><<<grid, kThreadsTc, smem, st>>>(
        xb, wb, sf, bf, rb, ob, h, wd, dil, ring, steps, act, alpha);
  }
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace rsm
