// Tensor-core stride-2 convolutions of bf16 (conv3x3.cu's entry point
// rsm_conv_s2_tc), KT x KT taps, KT = 4 or 3:
//
//   out[n, oy, ox, co] = act(scale[co] * sum_{ky,kx,ci}
//                         x[n, 2 oy + ky - 1, 2 ox + kx - 1, ci] w[ky, kx, ci, co]
//                         + bias[co]), cast to bf16
//
// Out-of-range input reads zero; Ho = ceil(H / 2), Wo = ceil(W / 2).  With
// KT = 4 that is the v3 U-Net's 4x4 TF-SAME conv (pad_lo 1; pad_hi 1 for an
// even size, 2 for an odd one); with KT = 3 the 3x3 conv with torch padding
// 1 of the v1 / v2 encoders, 32 -> 32, and 3 -> 32 at their first stage.
// No residual.
//
// Replaces the Pallas TPU kernel K2 of the JAX package
// (realtime_stereo_matcher_tpu/kernels/conv3x3.py fused_conv3x3_s2_flat,
// body _build_s2_kernel), which fused_conv4x4_s2_flat also reaches.
//
// 32 -> 32 (conv_s2_tc_kernel).  The GEMM is the forward conv's, as in
// conv_tc.cuh: M = output pixels, N = 32 output channels, K = KT^2 x 32 (512
// or 288), mma.sync m16n8k16 with float32 accumulators; the weights (32 KB
// or 18 KB) stay in shared memory for the block's life.
//
// Stride 2 puts the 16 input pixels of one A fragment (16 consecutive output
// columns at one tap) 128 bytes apart, where they fall in only 4 of the 8
// 16-byte bank groups: a 2-way conflict on every A load whatever the swizzle.
// So each staged input row is de-interleaved by column parity: input column
// 2 ox0 - 2 + 2 j + par (ox0 the block's first output column) is stored at
// position j of plane par, and tap kx of output column ox0 + i reads
// plane (kx + 1) & 1 at j = i + (kx + 1) / 2: 16 consecutive staged pixels,
// which conv_tc.cuh's swizzle keeps conflict-free.
//
// A block walks down a strip of kS2TW = 32 output columns, kS2TH = 8 output
// rows a step; warp w owns output row w of the step (2 M-tiles of 16
// columns).  A step reads 2 kS2TH + KT - 2 input rows and brings 2 kS2TH new
// ones; the ring holds 4 kS2TH + KT - 2 rows of 2 x (kS2TW + 2) pixels, so
// the rows of step s + 1 arrive by cp.async (src-size 0 is the zero
// padding) while step s runs its MMAs.  That ring is 148 KB (KT = 4): one
// block an SM.  Outputs are staged through 1 KB a warp and stored as 16-byte
// vectors, as in conv_tc.cuh.
//
// 3 -> 32 (conv_s2_nin_tc_kernel, KT = 3: the encoders' stem, 720 x 1280 ->
// 360 x 640 at 720p).  Bound by bytes: 5.5 MB of 6-byte input pixels and
// 14.7 MB of 64-byte output pixels, 0.006 ms at 3.35 TB/s.  The same strip
// walk, 8 output rows a step, with the input pixels staged through
// registers (the next step's 16 rows fetched before this step's MMAs and
// stored after them) as 8-byte chunks, the channels zero-padded to 4, in
// column order: staged pixel p of a row is input column 2 ox0 - 1 + p.  At
// stride 2 the taps kx = 0 and 1 of output column ox0 + i are then the two
// pixels of the 16-byte row at 2 i, and kx = 2 the first pixel of the row
// at 2 i + 2: one ldmatrix row each, 8 consecutive output columns 128
// contiguous bytes (conflict-free without a swizzle or parity planes).  So
// one k16 step holds a whole kernel row (k = kx x 4 + ci: lanes 0-15 address
// kx 0-1, lanes 16-31 kx 2), K = 3 x 16 = 48; the k 12-15 quarter (the
// next column's pixel) is zeroed in the A registers.  Per 16 output pixels:
// 3 ldmatrix and 12 MMAs (against 5 and 20 with 8 channels a pixel and
// the taps two to a step, PERF.md).  B stays in registers for the block's
// life.  The ring is 17 KB: two blocks an SM.
//
// RSM_TC_CUT_A, RSM_TC_CUT_MMA and RSM_TC_CUT_STORE (conv_tc.cuh) cut the A
// fragment loads, the MMAs or the output stores out of these kernels too; no
// build of the package defines them.
#pragma once

#include "conv_tc.cuh"

namespace rsm {
namespace tc {

constexpr int kS2TH = 8, kS2TW = 32;           // output rows x columns a step
constexpr int kS2Unit = 2 * (kS2TW + 2);       // pixels of a staged input row

template <int KT>
__host__ __device__ constexpr int s2_ring() {
  return 4 * kS2TH + KT - 2;
}

template <int KT>
__host__ __device__ constexpr int s2_smem_bytes() {
  return KT * KT * kC * kPixBytes + s2_ring<KT>() * kS2Unit * kPixBytes +
         kStageBytes;
}

// 3 -> 32: 48 weight rows (3 row taps x (3 column taps + a zero one) x 4
// input channels) of 32 output channels; a ring of s2_ring<3>() rows of 66
// staged 8-byte pixels
constexpr int kS2NinK = 48;
constexpr int kS2NinCols = 2 * kS2TW + 2;
constexpr int kS2NinPix = 8;
constexpr int kS2NinPre = 5;  // staged pixels a thread fetches ahead: 16 x 66

__host__ __device__ constexpr int s2_nin_smem_bytes() {
  return kS2NinK * kPixBytes + s2_ring<3>() * kS2NinCols * kS2NinPix +
         kStageBytes;
}

// grid: x = strips of kS2TW output columns, y = chunks of `steps` steps of
// kS2TH output rows, z = N.
template <int KT>
__global__ void __launch_bounds__(kThreadsTc, 1)
conv_s2_tc_kernel(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ w,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias,
                  __nv_bfloat16* __restrict__ out, int H, int W, int Ho,
                  int Wo, int steps, int act, float alpha) {
  constexpr int TH = kS2TH, TW = kS2TW, UP = kS2Unit, RING = s2_ring<KT>();
  constexpr int kTaps = KT * KT, kWBytes = kTaps * kC * kPixBytes;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t w_s = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t ring_s = w_s + kWBytes;
  unsigned char* stage = smem + kWBytes + RING * UP * kPixBytes;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = blockIdx.z;
  const int ox0 = blockIdx.x * TW;
  const int oy0 = blockIdx.y * steps * TH;  // first output row
  const int u0 = 2 * oy0 - 1;               // first input row of the ring
  const int c0 = 2 * ox0 - 2;               // input column of staged q = 0
  const int n_steps = min(steps, (Ho - oy0 + TH - 1) / TH);

  // input rows lo .. hi into their ring slots; staged column q (input column
  // c0 + q, read in order) goes to plane q & 1 at position q >> 1
  auto load_rows = [&](int lo, int hi) {
    for (int i = tid; i < (hi - lo + 1) * UP * 4; i += kThreadsTc) {
      const int u = lo + i / (UP * 4), q = (i % (UP * 4)) >> 2, j = i & 3;
      const int ix = c0 + q;
      const bool ok = u >= 0 && u < H && ix >= 0 && ix < W;
      const __nv_bfloat16* src =
          ok ? x + (((size_t)n * H + u) * W + ix) * kC + j * 8 : x;
      const int p = ((u - u0) % RING) * UP + (q & 1) * (TW + 2) + (q >> 1);
      cp_async16(ring_s + swz(p, j), src, ok);
    }
  };
  // rows step s needs beyond those of step s - 1 (all of them for s = 0)
  auto load_step = [&](int s) {
    const int hi = u0 + 2 * s * TH + 2 * TH + KT - 3;
    load_rows(s == 0 ? u0 : hi - 2 * TH + 1, hi);
  };

  // weights, once per block: row q = tap * 32 + ci holds 32 output channels
  for (int i = tid; i < kTaps * kC * 4; i += kThreadsTc)
    cp_async16(w_s + swz(i >> 2, i & 3), w + (size_t)i * 8, true);
  load_step(0);
  cp_async_commit();

  const int a_pix = lane & 15;          // the A row (output column) of a lane
  const int a_chunk = lane >> 4;        // its 8-channel half of 16
  const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8;  // k within 16
  const int b_chunk = lane >> 4;        // n-tile within a pair

  for (int s = 0; s < n_steps; ++s) {
    if (s + 1 < n_steps) {
      load_step(s + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int oy = oy0 + s * TH + warp;
    // acc[m][nt * 4 + e]: M-tile m (output columns 16 m ..), n-tile nt
    float acc[2][16];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[m][e] = 0.f;
    if (oy < Ho) {  // the same for the whole warp
#pragma unroll
      for (int ky = 0; ky < KT; ++ky) {
        const int unit = ((2 * oy - 1 + ky - u0) % RING) * UP;
#pragma unroll
        for (int kx = 0; kx < KT; ++kx) {
          const int t = ky * KT + kx;
          const int pix = unit + ((kx + 1) & 1) * (TW + 2) + ((kx + 1) >> 1);
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            uint32_t b[4][2];
            {
              uint32_t r[4];
              const int q = t * kC + kk * 16 + b_row;
              ldsm_x4_t(w_s + swz(q, b_chunk), r);      // n-tiles 0, 1
              b[0][0] = r[0]; b[0][1] = r[1]; b[1][0] = r[2]; b[1][1] = r[3];
              ldsm_x4_t(w_s + swz(q, 2 + b_chunk), r);  // n-tiles 2, 3
              b[2][0] = r[0]; b[2][1] = r[1]; b[3][0] = r[2]; b[3][1] = r[3];
            }
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              uint32_t a[4];
#ifndef RSM_TC_CUT_A
              ldsm_x4(ring_s + swz(pix + m * 16 + a_pix, kk * 2 + a_chunk), a);
#else
              a[0] = a[1] = a[2] = a[3] = 0u;
#endif
#ifndef RSM_TC_CUT_MMA
#pragma unroll
              for (int nt = 0; nt < 4; ++nt)
                mma_bf16(&acc[m][nt * 4], a, b[nt]);
#endif
            }
          }
        }
      }
    }

    // epilogue: y = acc * scale + bias, activation, bf16; staged through this
    // warp's 1 KB so that output stores are 16-byte vectors of consecutive
    // pixels
    unsigned char* st = stage + warp * 16 * kPixBytes;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int co = nt * 8 + (lane & 3) * 2;
        const float s0 = __ldg(scale + co), s1 = __ldg(scale + co + 1);
        const float b0 = __ldg(bias + co), b1 = __ldg(bias + co + 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0 = fmaf(acc[m][nt * 4 + 2 * h], s0, b0);
          float v1 = fmaf(acc[m][nt * 4 + 2 * h + 1], s1, b1);
          if (act == kActRelu) {
            v0 = fmaxf(v0, 0.f); v1 = fmaxf(v1, 0.f);
          } else if (act == kActLeaky) {
            v0 = fmaxf(v0, 0.f) + alpha * fminf(v0, 0.f);
            v1 = fmaxf(v1, 0.f) + alpha * fminf(v1, 0.f);
          }
          const int row = (lane >> 2) + 8 * h;
          *reinterpret_cast<__nv_bfloat162*>(
              st + swz(row, nt) + (lane & 3) * 4) = __floats2bfloat162_rn(v0, v1);
        }
      }
      __syncwarp();
#pragma unroll
      for (int it = 0; it < 2; ++it) {
        const int i = it * 32 + lane, p = i >> 2, j = i & 3;
        const int ox = ox0 + m * 16 + p;
        if (oy < Ho && ox < Wo) {
          const uint4 v = *reinterpret_cast<const uint4*>(st + swz(p, j));
#ifndef RSM_TC_CUT_STORE
          *reinterpret_cast<uint4*>(
              out + (((size_t)n * Ho + oy) * Wo + ox) * kC + j * 8) = v;
#else
          (void)v;
#endif
        }
      }
      __syncwarp();
    }
    __syncthreads();  // the ring slots of step s may be refilled now
  }
}

// grid: x = strips of kS2TW output columns, y = chunks of `steps` steps of
// kS2TH output rows, z = N.  3x3 taps, C_in = CI (<= 4) -> 32.
template <int CI>
__global__ void __launch_bounds__(kThreadsTc, 2)
conv_s2_nin_tc_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ w,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ out, int H, int W, int Ho,
                      int Wo, int steps, int act, float alpha) {
  static_assert(CI <= 4, "a staged pixel holds 4 channels");
  constexpr int TH = kS2TH, COLS = kS2NinCols, RING = s2_ring<3>();
  constexpr int kWords = Narrow<CI>::kWords;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t w_s = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t ring_s = w_s + kS2NinK * kPixBytes;
  unsigned char* stage = smem + kS2NinK * kPixBytes + RING * COLS * kS2NinPix;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = blockIdx.z;
  const int ox0 = blockIdx.x * kS2TW;
  const int oy0 = blockIdx.y * steps * TH;  // first output row
  const int u0 = 2 * oy0 - 1;               // first input row of the ring
  const int c0 = 2 * ox0 - 1;               // input column of staged p = 0
  const int n_steps = min(steps, (Ho - oy0 + TH - 1) / TH);

  // staged pixel i of the rows from lo: input (lo + i / COLS, c0 + i % COLS)
  // and its ring slot
  auto src_of = [&](int lo, int i, bool& ok) {
    const int u = lo + i / COLS, ix = c0 + i % COLS;
    ok = u >= 0 && u < H && ix >= 0 && ix < W;
    return x + (((size_t)n * H + (ok ? u : 0)) * W + (ok ? ix : 0)) * CI;
  };
  auto commit = [&](int lo, int i, const uint32_t* v) {
    const uint32_t dst =
        ring_s + (uint32_t)((((lo + i / COLS) - u0) % RING) * COLS + i % COLS) *
                     kS2NinPix;
    asm volatile("st.shared.v2.b32 [%0], {%1,%2};\n" ::"r"(dst), "r"(v[0]),
                 "r"(kWords > 1 ? v[kWords - 1] : 0u));
  };
  // the first step's 2 TH + 1 rows, fetched and stored at once
  for (int i = tid; i < (2 * TH + 1) * COLS; i += kThreadsTc) {
    bool ok;
    const __nv_bfloat16* src = src_of(u0, i, ok);
    uint32_t v[kWords];
    narrow_fetch<CI>(src, ok, v);
    commit(u0, i, v);
  }
  // weights: row q = ky * 16 + kx * 4 + ci holds 32 output channels (zero
  // for kx = 3 and ci >= CI), swizzled as conv_tc.cuh's
  for (int i = tid; i < kS2NinK * 4; i += kThreadsTc) {
    const int q = i >> 2, j = i & 3, ky = q >> 4, kx = (q >> 2) & 3, ci = q & 3;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (kx < 3 && ci < CI)
      v = *reinterpret_cast<const uint4*>(
          w + ((size_t)(ky * 3 + kx) * CI + ci) * kC + j * 8);
    st_shared16(w_s + swz(q, j), v);
  }
  __syncthreads();

  // B fragments of the three k16 steps (row taps) and four n-tiles, for the
  // block's life
  uint32_t b[3][4][2];
  {
    const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8;  // k within 16
    const int b_chunk = lane >> 4;                         // n-tile of a pair
#pragma unroll
    for (int ks = 0; ks < 3; ++ks) {
      uint32_t r[4];
      ldsm_x4_t(w_s + swz(ks * 16 + b_row, b_chunk), r);  // n-tiles 0, 1
      b[ks][0][0] = r[0]; b[ks][0][1] = r[1];
      b[ks][1][0] = r[2]; b[ks][1][1] = r[3];
      ldsm_x4_t(w_s + swz(ks * 16 + b_row, 2 + b_chunk), r);  // 2, 3
      b[ks][2][0] = r[0]; b[ks][2][1] = r[1];
      b[ks][3][0] = r[2]; b[ks][3][1] = r[3];
    }
  }
  // A: this lane addresses output column a_pix of an M-tile at the staged
  // pixels 2 a_pix (kx 0, 1) or 2 a_pix + 2 (kx 2 and the next column's,
  // whose k 12-15 the lanes with (lane & 3) >= 2 hold and zero)
  const int a_pix = 2 * (lane & 15) + 2 * (lane >> 4);
  const bool a_zero_hi = (lane & 3) >= 2;
  unsigned char* st = stage + warp * 16 * kPixBytes;

  for (int s = 0; s < n_steps; ++s) {
    // the 2 TH rows step s + 1 brings: fetched now, stored after the MMAs
    const int lo_next = u0 + 2 * TH * (s + 1) + 1;
    uint32_t pre[kS2NinPre][kWords];
    if (s + 1 < n_steps) {
#pragma unroll
      for (int k = 0; k < kS2NinPre; ++k) {
        const int i = tid + k * kThreadsTc;
        bool ok = false;
        const __nv_bfloat16* src = i < 2 * TH * COLS ? src_of(lo_next, i, ok)
                                                     : x;
        narrow_fetch<CI>(src, ok, pre[k]);
      }
    }
    const int oy = oy0 + s * TH + warp;
    if (oy < Ho) {  // the same for the whole warp
      int row[3];   // staged pixel 0 of input row 2 oy - 1 + ky
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
        row[ky] = ((2 * oy - 1 + ky - u0) % RING) * COLS + a_pix;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        float acc[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[e] = 0.f;
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          uint32_t a[4];
#ifndef RSM_TC_CUT_A
          ldsm_x4(ring_s + (uint32_t)(row[ky] + 32 * m) * kS2NinPix, a);
          if (a_zero_hi) a[2] = a[3] = 0u;
#else
          a[0] = a[1] = a[2] = a[3] = 0u;
#endif
#ifndef RSM_TC_CUT_MMA
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(&acc[nt * 4], a, b[ky][nt]);
#endif
        }
        const int ox = ox0 + m * 16;
        store_tile16(acc, st, lane, scale, bias, act, alpha, nullptr, out,
                     ((size_t)n * Ho + oy) * Wo + ox, min(16, Wo - ox));
      }
    }
    if (s + 1 < n_steps) {
#pragma unroll
      for (int k = 0; k < kS2NinPre; ++k) {
        const int i = tid + k * kThreadsTc;
        if (i < 2 * TH * COLS) commit(lo_next, i, pre[k]);
      }
    }
    __syncthreads();  // step s + 1's rows are in; step s's slots may refill
  }
}

// Launches one plan (kernels/conv3x3.py conv_s2_tc_plan): 32 -> 32 with KT
// taps a side, or (KT = 3) cin -> 32 with cin = 3.  Returns
// cudaErrorInvalidValue when the plan does not match the kernel (tile
// shape, ring size, shared-memory bytes, grid, output size).
template <int KT>
cudaError_t launch_s2_tc(const void* x, const void* w, const void* scale,
                         const void* bias, void* out, int n, int h, int wd,
                         int ho, int wo, int cin, int th, int tw, int ring,
                         int steps, int gx, int gy, int gz, int smem, int act,
                         float alpha, cudaStream_t st) {
  const bool narrow = KT == 3 && cin == 3;
  const int tiles_h = (ho + kS2TH - 1) / kS2TH;
  if ((cin != kC && !narrow) || th != kS2TH || tw != kS2TW ||
      ring != s2_ring<KT>() || steps < 1 ||
      smem != (narrow ? s2_nin_smem_bytes() : s2_smem_bytes<KT>()) ||
      ho != (h + 1) / 2 || wo != (wd + 1) / 2 ||
      gx != (wo + kS2TW - 1) / kS2TW || gy != (tiles_h + steps - 1) / steps ||
      gy > 65535 || gz != n)
    return cudaErrorInvalidValue;
  const dim3 grid(gx, gy, gz);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  const auto* sf = static_cast<const float*>(scale);
  const auto* bf = static_cast<const float*>(bias);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  cudaError_t err;
  if (narrow) {
    static int opted[64] = {};  // per device, for this instantiation
    err = opt_in_smem(conv_s2_nin_tc_kernel<3>, smem, opted);
    if (err != cudaSuccess) return err;
    conv_s2_nin_tc_kernel<3><<<grid, kThreadsTc, smem, st>>>(
        xb, wb, sf, bf, ob, h, wd, ho, wo, steps, act, alpha);
  } else {
    static int opted[64] = {};
    err = opt_in_smem(conv_s2_tc_kernel<KT>, smem, opted);
    if (err != cudaSuccess) return err;
    conv_s2_tc_kernel<KT><<<grid, kThreadsTc, smem, st>>>(
        xb, wb, sf, bf, ob, h, wd, ho, wo, steps, act, alpha);
  }
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace rsm
