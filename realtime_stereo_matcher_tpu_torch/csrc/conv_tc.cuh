// Tensor-core implicit-GEMM core of the bf16 32 -> 32 stride-1 convolutions:
// the dilated 3x3 conv (conv3x3.cu, KD = 1) and the 3x3x3 conv (conv3d.cu,
// KD = 3), each with the epilogue of conv_common.cuh.
//
// Layouts are channels-last and contiguous, bf16:
//   x   (N, D, H, W, 32)      (D = 1 for the 2D conv)
//   w   (KD, 3, 3, 32, 32)    HWIO / DHWIO
//   out (N, D, H, W, 32), res (N, H, W, 32) optional (2D only)
// scale and bias are float32 (32,).
//
// The GEMM: M = output pixels of a tile, N = 32 output channels, K = taps x
// 32 input channels (288 for the 3x3 conv, 864 for the 3x3x3).  Each warp
// owns 4 M-tiles of 16 pixels (64 pixels) and all 32 channels, in float32
// registers, and runs mma.sync m16n8k16 bf16 -> f32 on the tensor cores.
//
// Shared memory, all of it dynamic:
//   weights  KD * 9 * 32 rows of 64 B (one row = the 32 output channels of
//            one (tap, input channel)), staged once per block straight from
//            the HWIO / DHWIO tensor: 18 KB (3x3), 54 KB (3x3x3);
//   ring     `ring` units of input pixels (64 B each): for the 3x3 conv a
//            unit is one input row of TW + 2 d columns, for the 3x3x3 conv one
//            depth slab of (TH + 2) x (TW + 2) pixels;
//   staging  1 KB per warp: 16 output pixels on their way to global memory.
// A 64-byte row (pixel or weight row) holds four 16-byte chunks; chunk j of
// row p is stored at chunk j ^ ((p >> 1) & 3), so the eight rows an ldmatrix
// phase reads (eight consecutive pixels, at any tap offset or dilation) hit
// eight different bank groups.
//
// The block walks along one axis (down the rows of a column strip for the 3x3
// conv, along D for the 3x3x3 conv), `steps` output tiles in all.  Input units
// arrive by cp.async (16 B, src-size 0 outside the volume: that zero fill is
// the SAME padding) into the ring; the units of step s + 1 are in flight while
// step s runs its MMAs, and each unit is read from global memory once per
// block.  The tile plan (tile shape, ring size, steps, grid, shared-memory
// bytes) is computed by the Python wrappers (kernels/conv3x3.py,
// kernels/cost_filter3d.py) and checked here.
//
// The ring loader (load_units), the 16-pixel epilogue (store_tile16) and the
// register staging of narrow pixels (narrow_fetch, narrow_commit) are shared
// with the narrow-pair kernels (conv_narrow_tc.cuh) and K4 (dw_tc.cuh).
//
// RSM_TC_CUT_A, RSM_TC_CUT_MMA and RSM_TC_CUT_STORE cut the A-fragment loads,
// the MMAs or the output stores out of the kernel (its results are then
// wrong); no build of the package defines them.  tools/tc_compare.py
// defines them to time the kernel without that part of its work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_common.cuh"

namespace rsm {
namespace tc {

constexpr int kWarps = 8;
constexpr int kThreadsTc = kWarps * 32;
constexpr int kC = 32;          // channels in and out
constexpr int kPixBytes = 64;   // one bf16 pixel of 32 channels
constexpr int kStageBytes = kWarps * 16 * kPixBytes;

// output tile (rows x columns) of one step
template <int KD> struct Tile;
template <> struct Tile<1> { static constexpr int TH = 8, TW = 64; };
template <> struct Tile<3> { static constexpr int TH = 16, TW = 32; };

template <int KD>
__host__ __device__ constexpr int weight_bytes() {
  return KD * 9 * kC * kPixBytes;
}

// pixels of one ring unit
template <int KD>
__host__ __device__ constexpr int unit_pixels(int dil) {
  return KD == 1 ? Tile<1>::TW + 2 * dil
                 : (Tile<3>::TH + 2) * (Tile<3>::TW + 2);
}

template <int KD>
inline int smem_bytes(int dil, int ring) {
  return weight_bytes<KD>() + ring * unit_pixels<KD>(dil) * kPixBytes +
         kStageBytes;
}

__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return (uint32_t)row * kPixBytes + ((chunk ^ ((row >> 1) & 3)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

// Narrow pixels (C = 1, 3, 4 or 7 bf16 channels: 2 to 14 bytes, not 16-byte
// aligned, so cp.async cannot copy them) are staged as one 16-byte chunk a
// pixel, the channels zero-padded to 8, through registers: narrow_fetch
// loads a pixel as (C + 1) / 2 packed channel pairs (zero where !ok: the
// SAME padding), narrow_commit stores them with the padding.  A caller
// fetches the pixels of step s + 1 before the MMAs of step s and commits
// them after, so the loads are in flight while the tensor cores run.
template <int C>
struct Narrow {
  static constexpr int kWords = (C + 1) / 2;
};

template <int C>
__device__ __forceinline__ void narrow_fetch(const __nv_bfloat16* src,
                                             bool ok, uint32_t* v) {
#pragma unroll
  for (int i = 0; i < Narrow<C>::kWords; ++i) v[i] = 0u;
  if (!ok) return;
  if constexpr (C == 4) {  // 8-byte pixels, 8-byte aligned
    const uint2 u = *reinterpret_cast<const uint2*>(src);
    v[0] = u.x; v[1] = u.y;
  } else {
    const unsigned short* h = reinterpret_cast<const unsigned short*>(src);
#pragma unroll
    for (int c = 0; c < C; ++c) v[c >> 1] |= (uint32_t)h[c] << (16 * (c & 1));
  }
}

__device__ __forceinline__ void st_shared16(uint32_t dst, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1,%2,%3,%4};\n" ::"r"(dst),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w));
}

template <int C>
__device__ __forceinline__ void narrow_commit(uint32_t dst, const uint32_t* v) {
  uint32_t u[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < Narrow<C>::kWords; ++i) u[i] = v[i];
  st_shared16(dst, make_uint4(u[0], u[1], u[2], u[3]));
}

// Input units lo .. hi into their ring slots by cp.async (all threads; zero
// outside the volume): for KD = 1 a unit is input row u of UP = TW + 2 dil
// pixels from column x0 - dil, for KD = 3 the depth slab u of (TH + 2) x
// (TW + 2) pixels from (y0 - 1, x0 - 1).  Ring slot (u - u0) % ring.
template <int KD, int TH, int TW>
__device__ __forceinline__ void load_units(uint32_t ring_s,
                                           const __nv_bfloat16* x, int n,
                                           int D, int H, int W, int x0, int y0,
                                           int dil, int UP, int ring, int u0,
                                           int lo, int hi, int tid) {
  const int per_unit = UP * 4;  // 16-byte chunks
  for (int i = tid; i < (hi - lo + 1) * per_unit; i += kThreadsTc) {
    const int u = lo + i / per_unit, p = (i % per_unit) >> 2, j = i & 3;
    int iy, ix, iz;
    if constexpr (KD == 1) {
      iz = 0; iy = u; ix = x0 - dil + p;
    } else {
      iz = u; iy = y0 - 1 + p / (TW + 2); ix = x0 - 1 + p % (TW + 2);
    }
    const bool ok = iz >= 0 && iz < D && iy >= 0 && iy < H && ix >= 0 &&
                    ix < W;
    const __nv_bfloat16* src =
        ok ? x + ((((size_t)n * D + iz) * H + iy) * W + ix) * kC + j * 8 : x;
    cp_async16(ring_s + swz(((u - u0) % ring) * UP + p, j), src, ok);
  }
}

// The epilogue of one M-tile of 16 output pixels x 32 channels, from the
// mma D fragments acc[nt * 4 + e] (n-tile nt): y = acc * scale + bias,
// activation, bf16, staged through the warp's 1 KB `st` so that residual
// loads and output stores are 16-byte vectors of consecutive pixels; then
// + res (rounded to bf16 again).  Pixel p < valid of the 16 is output pixel
// pix0 + p.
__device__ __forceinline__ void store_tile16(
    const float* acc, unsigned char* st, int lane,
    const float* __restrict__ scale, const float* __restrict__ bias, int act,
    float alpha, const __nv_bfloat16* __restrict__ res,
    __nv_bfloat16* __restrict__ out, size_t pix0, int valid) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int co = nt * 8 + (lane & 3) * 2;
    const float s0 = __ldg(scale + co), s1 = __ldg(scale + co + 1);
    const float b0 = __ldg(bias + co), b1 = __ldg(bias + co + 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = fmaf(acc[nt * 4 + 2 * h], s0, b0);
      float v1 = fmaf(acc[nt * 4 + 2 * h + 1], s1, b1);
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
    if (p < valid) {
      const size_t o = (pix0 + p) * kC + j * 8;
      uint4 v = *reinterpret_cast<const uint4*>(st + swz(p, j));
      if (res != nullptr) {
        const uint4 r = *reinterpret_cast<const uint4*>(res + o);
        __nv_bfloat162* hv = reinterpret_cast<__nv_bfloat162*>(&v);
        const __nv_bfloat162* hr = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 a = __bfloat1622float2(hv[e]);
          const float2 c = __bfloat1622float2(hr[e]);
          hv[e] = __floats2bfloat162_rn(a.x + c.x, a.y + c.y);
        }
      }
#ifndef RSM_TC_CUT_STORE
      *reinterpret_cast<uint4*>(out + o) = v;
#else
      (void)v;
#endif
    }
  }
  __syncwarp();
}

// grid: KD = 1: x = column strips of TW, y = row chunks of steps * TH,
//               z = N;
//       KD = 3: x = (h tiles) x (w tiles), y = depth chunks of `steps`,
//               z = N.
// `ring` units: KD = 1: 2 * TH + 2 * dil rows; KD = 3: 4 slabs.
template <int KD>
__global__ void __launch_bounds__(kThreadsTc, KD == 1 ? 2 : 1)
conv_tc_kernel(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ w,
               const float* __restrict__ scale,
               const float* __restrict__ bias,
               const __nv_bfloat16* __restrict__ res,
               __nv_bfloat16* __restrict__ out, int D, int H, int W, int dil,
               int ring, int steps, int act, float alpha) {
  constexpr int TH = Tile<KD>::TH, TW = Tile<KD>::TW;
  constexpr int kTaps = KD * 9;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t w_s = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t ring_s = w_s + weight_bytes<KD>();
  const int UP = unit_pixels<KD>(dil);
  unsigned char* stage =
      smem + weight_bytes<KD>() + ring * UP * kPixBytes;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = blockIdx.z;
  // this block's tile origin and the first unit it walks from
  int x0, y0, u0, n_steps;
  if constexpr (KD == 1) {
    x0 = blockIdx.x * TW;
    y0 = blockIdx.y * steps * TH;       // first output row
    u0 = y0 - dil;                      // first input row of the ring
    n_steps = min(steps, (H - y0 + TH - 1) / TH);
  } else {
    const int tiles_w = (W + TW - 1) / TW;
    x0 = (blockIdx.x % tiles_w) * TW;
    y0 = (blockIdx.x / tiles_w) * TH;
    u0 = blockIdx.y * steps - 1;        // first input slab of the ring
    n_steps = min(steps, D - blockIdx.y * steps);
  }

  auto load_units_ = [&](int lo, int hi) {
    load_units<KD, TH, TW>(ring_s, x, n, D, H, W, x0, y0, dil, UP, ring, u0,
                           lo, hi, tid);
  };
  // units step s needs beyond those of step s - 1 (all of them for s = 0)
  auto load_step = [&](int s) {
    if constexpr (KD == 1) {
      load_units_(s == 0 ? u0 : y0 + s * TH + dil,
                  y0 + s * TH + TH - 1 + dil);
    } else {
      load_units_(s == 0 ? u0 : u0 + s + 2, u0 + s + 2);
    }
  };

  // weights, once per block: row q = tap * 32 + ci holds 32 output channels
  for (int i = tid; i < kTaps * kC * 4; i += kThreadsTc)
    cp_async16(w_s + swz(i >> 2, i & 3), w + (size_t)i * 8, true);
  load_step(0);
  cp_async_commit();

  // this warp's 4 M-tiles: tile pixels (warp * 4 + m) * 16 + 0..15,
  // row-major; a warp's 64 pixels are one output row (KD = 1) or two
  constexpr int kRowsPerWarp = 64 / TW;
  const int a_pix = lane & 15;          // the A row this lane addresses
  const int a_chunk = lane >> 4;        // its 8-channel half of 16
  // ring pixel of this lane's A row at tap (outer, 0, 0), from its unit's
  // first pixel, for M-tile 0; M-tile m adds m_off(m)
  const int a_base =
      (KD == 1 ? 0 : warp * kRowsPerWarp * (TW + 2)) + a_pix;
  auto m_row = [](int m) { return m * 16 / TW; };   // row within the warp
  auto m_col = [](int m) { return m * 16 % TW; };
  auto m_off = [&](int m) {
    return (KD == 1 ? 0 : m_row(m) * (TW + 2)) + m_col(m);
  };
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
    if (res != nullptr) {
      // the residual lines this warp adds in its epilogue, into L2 now, so
      // that their DRAM reads overlap the MMAs (one prefetch per 128 B)
      const int oy = y0 + s * TH + warp;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int ox = x0 + m_col(m) + (lane >> 1) * 2;
        if ((lane & 1) == 0 && lane < 16 && oy < H && ox < W)
          asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
              res + (((size_t)n * H + oy) * W + ox) * kC));
      }
    }

    // acc[m][nt * 4 + e]: M-tile m, n-tile nt, the mma D fragment
    float acc[4][16];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[m][e] = 0.f;

    // outer tap o: kernel row (KD = 1, input row of the warp's output row
    // shifted by (o - 1) * dil) or depth tap (KD = 3, input slab)
    auto unit_of = [&](int o) {
      const int u = KD == 1 ? y0 + s * TH + warp + (o - 1) * dil
                            : u0 + s + o;
      return ((u - u0) % ring) * UP;
    };
#pragma unroll
    for (int o = 0; o < 3; ++o) {
      const int unit = unit_of(o);
#pragma unroll
      for (int i = 0; i < kTaps / 3; ++i) {
        const int t = o * kTaps / 3 + i;  // HWIO / DHWIO tap
        const int inner = KD == 1 ? i * dil : (i / 3) * (TW + 2) + i % 3;
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
          for (int m = 0; m < 4; ++m) {
            uint32_t a[4];
#ifndef RSM_TC_CUT_A
            ldsm_x4(ring_s + swz(unit + a_base + m_off(m) + inner,
                                 kk * 2 + a_chunk),
                    a);
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

    // epilogue (store_tile16), one M-tile at a time
    unsigned char* st = stage + warp * 16 * kPixBytes;
    const int zz = KD == 1 ? 0 : blockIdx.y * steps + s;
    const int oy0 = y0 + (KD == 1 ? s * TH : 0) + warp * kRowsPerWarp;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int oy = oy0 + m_row(m), ox = x0 + m_col(m);
      store_tile16(acc[m], st, lane, scale, bias, act, alpha, res, out,
                   (((size_t)n * D + zz) * H + oy) * W + ox,
                   oy < H ? min(16, W - ox) : 0);
    }
    __syncthreads();  // the ring slots of step s may be refilled now
  }
}

// Launches one plan.  Returns cudaErrorInvalidValue when the plan does not
// match this kernel (tile shape, ring size, shared-memory bytes, grid).
template <int KD>
cudaError_t launch_tc(const void* x, const void* w, const void* scale,
                      const void* bias, const void* res, void* out, int n,
                      int d, int h, int wd, int dil, int th, int tw, int ring,
                      int steps, int gx, int gy, int gz, int smem, int act,
                      float alpha, cudaStream_t st) {
  constexpr int TH = Tile<KD>::TH, TW = Tile<KD>::TW;
  const int want_ring = KD == 1 ? 2 * TH + 2 * dil : 4;
  if (th != TH || tw != TW || ring != want_ring || steps < 1 ||
      smem != smem_bytes<KD>(dil, ring) || gz != n ||
      (KD == 3 && res != nullptr))
    return cudaErrorInvalidValue;
  const int tiles_w = (wd + TW - 1) / TW, tiles_h = (h + TH - 1) / TH;
  const bool grid_ok =
      KD == 1 ? gx == tiles_w && gy == (tiles_h + steps - 1) / steps
              : gx == tiles_w * tiles_h && gy == (d + steps - 1) / steps;
  if (!grid_ok) return cudaErrorInvalidValue;
  static int opted[64] = {};  // per device, for this instantiation
  const cudaError_t err = opt_in_smem(conv_tc_kernel<KD>, smem, opted);
  if (err != cudaSuccess) return err;
  conv_tc_kernel<KD><<<dim3(gx, gy, gz), kThreadsTc, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(scale),
      static_cast<const float*>(bias),
      static_cast<const __nv_bfloat16*>(res),
      static_cast<__nv_bfloat16*>(out), d, h, wd, dil, ring, steps, act,
      alpha);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace rsm
