// Weight gradient of a stride-1 SAME 3x3 convolution (dilation 1/2/4/8) and
// of a 3x3x3 SAME convolution, on channels-last tensors:
//
//   2D  dW[ky, kx, ci, co]     = sum_{b,y,x}   x[b, y+(ky-1)d, x+(kx-1)d, ci]
//                                              * g[b, y, x, co]
//   3D  dW[kz, ky, kx, ci, co] = sum_{b,z,y,x} x[b, z+kz-1, y+ky-1, x+kx-1, ci]
//                                              * g[b, z, y, x, co]
//
// Out-of-range taps read zero.  x and g are float32 or bfloat16; products
// and sums are float32 and so is dW.
//
// Replaces the Pallas TPU kernel K4 of the JAX package:
//   realtime_stereo_matcher_tpu/kernels/train_conv.py  dw_reduce (body
//   _build_dw_kernel), the dW of the training conv flat_conv3x3, without the
//   4-pixel lane fold and its unfold_weight_grad.  The 3D form computes the
//   dW of flat_conv3d (kernels/train_conv3d.py), which the JAX package left
//   to 18 XLA dots.  The channel pairs are those of the training convs:
//   32 -> 32, the refine entries 4 -> 32 (v1) and 7 -> 32 (v2), the refine
//   head 32 -> 1.
//
// What bounds it on an H100: the largest 2D launch of a training step, 4 x
// 480 x 640 at 32 -> 32 channels in bf16, reads 157 MB and does 22.6 GFLOP,
// 144 FLOP per byte, below the ~295 FLOP/byte ridge of bf16 tensor cores:
// bound by memory, 0.047 ms at 3.35 TB/s.  The largest 3D launch, (4, 24,
// 60, 80), reads 59 MB and does 25.5 GFLOP (432 FLOP per byte): bound by
// operations, 0.026 ms at 989 TFLOP/s.  On the CUDA cores' float32 FMAs
// (67 TFLOP/s) neither can go below 0.34 / 0.38 ms.
//
// Two designs, chosen by dtype (kernels/train_conv.py):
//   * bf16, every pair (all 59 launches of a v1 or v2 training step):
//     rsm_dw_reduce_tc, the tensor-core kernel of dw_tc.cuh, a transposed
//     implicit GEMM (M = tap x ci, N = co, K = pixels) on mma.sync with the
//     32-channel operands staged by cp.async and the narrow ones (x of 4 or
//     7 channels, g of 1) through registers, padded to 8 channels; one
//     partial dW per block (about one block an SM), then dw_sum_kernel.
//   * float32: the CUDA-core kernel below, float32 FMAs, so that the
//     float32 checks hold at ~1e-6 relative (TF32 tensor cores would not).

// The CUDA-core design.  The TPU kernel streamed the whole image through one
// core and kept its sum in VMEM from one grid step to the next; blocks on
// Hopper run in parallel and in no order, so the sum is taken in two passes,
// with no atomics (the result is the same bits on every run):
//   1. dw_partial_kernel: each block owns a tile of kTW output columns by a
//      run of rows of one image plane.  For each output row it stages, in
//      shared memory, the input rows that the 3 (or 3x3) row taps read
//      (with a halo of kHalo columns on each side, zeros outside the image)
//      and the row of g, then every thread adds its share of
//      x_tap^T g into registers: one tap (and, in 3D, its 3 depth taps),
//      CIT input and COT output channels, over a slice of the row's pixels.
//      The block writes its partial dW (one per pixel slice) to a workspace.
//   2. dw_sum_kernel sums the partials in a fixed order.
// The wrapper (kernels/train_conv.py) allocates the workspace with the size
// rsm_dw_workspace returns (rsm_dw_reduce_tc: the size of its plan).
#include "conv_common.cuh"
#include "dw_tc.cuh"

namespace {

using rsm::load_vec;

constexpr int kMaxDil = 8;         // largest 2D dilation: the staged halo
constexpr int kTargetBlocks = 528;  // 4 blocks for each of the 132 SMs
constexpr int kGroupThreads = 288;  // threads a block aims at

template <int KD, int CI, int CO>
struct DwCfg {
  static constexpr int kTW = KD == 1 ? 64 : 32;          // output columns
  static constexpr int kHalo = KD == 1 ? kMaxDil : 1;    // columns each side
  static constexpr int kCols = kTW + 2 * kHalo;
  static constexpr int kRows = 3 * KD;                   // staged input rows
  static constexpr int CIT = CI < 8 ? CI : 8;            // ci per thread
  static constexpr int COT = CO < 4 ? CO : 4;            // co per thread
  static constexpr int NCI = CI / CIT;
  static constexpr int NCO = CO / COT;
  static constexpr int kGroups = 9 * NCI * NCO;          // (ky,kx), ci, co
  static constexpr int PS = kGroups >= kGroupThreads ? 1
                                                     : kGroupThreads / kGroups;
  static constexpr int kThreads = kGroups * PS;          // PS pixel slices
  static constexpr int kOut = KD * 9 * CI * CO;          // dW entries
  static constexpr int XV = CI % 8 == 0 ? 8 : CI;        // x staging vector
  static constexpr int GV = CO % 8 == 0 ? 8 : CO;        // g staging vector
  static_assert(CI % CIT == 0 && CO % COT == 0, "channel split");
  static_assert(kThreads <= 1024, "block size");
  static_assert((kRows * kCols * CI + kTW * CO) * 4 <= 48 * 1024,
                "static shared memory");
};

// grid: x = column tiles, y = row chunks of `rows` rows, z = planes (n * D).
template <typename T, int KD, int CI, int CO>
__global__ void __launch_bounds__(DwCfg<KD, CI, CO>::kThreads)
dw_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                  float* __restrict__ partial, int D, int H, int W, int dil,
                  int rows) {
  using C = DwCfg<KD, CI, CO>;
  __shared__ __align__(16) float x_s[C::kRows * C::kCols * CI];
  __shared__ __align__(16) float g_s[C::kTW * CO];

  const int plane = blockIdx.z;  // n * D + z
  const int z = plane % D;
  const int x0 = blockIdx.x * C::kTW;
  const int y0 = blockIdx.y * rows;
  const int y1 = min(H, y0 + rows);
  const int n_px = min(C::kTW, W - x0);

  const int t = threadIdx.x;
  const int cog = t % C::NCO;
  int r = t / C::NCO;
  const int cig = r % C::NCI;
  r /= C::NCI;
  const int tap = r % 9;  // ky * 3 + kx
  const int slice = r / 9;
  const int ky = tap / 3, kx = tap % 3;
  const int col_off = C::kHalo + (kx - 1) * dil;  // staged col of pixel 0

  float acc[KD][C::CIT][C::COT];
#pragma unroll
  for (int kz = 0; kz < KD; ++kz)
#pragma unroll
    for (int i = 0; i < C::CIT; ++i)
#pragma unroll
      for (int j = 0; j < C::COT; ++j) acc[kz][i][j] = 0.f;

  for (int y = y0; y < y1; ++y) {
    __syncthreads();  // the previous row's tiles are used up
    // stage the input rows the taps of output row y read
    constexpr int kXVecs = C::kRows * C::kCols * (CI / C::XV);
    for (int i = t; i < kXVecs; i += C::kThreads) {
      const int v = i % (CI / C::XV);
      const int rc = i / (CI / C::XV);
      const int c = rc % C::kCols;
      const int sr = rc / C::kCols;  // kz * 3 + ky
      const int zz = z + sr / 3 - KD / 2;
      const int yy = y + (sr % 3 - 1) * dil;
      const int xx = x0 - C::kHalo + c;
      float* dst = x_s + rc * CI + v * C::XV;
      if (zz >= 0 && zz < D && yy >= 0 && yy < H && xx >= 0 && xx < W) {
        const T* src =
            x + (((size_t)(plane - z + zz) * H + yy) * W + xx) * CI + v * C::XV;
        load_vec<C::XV>(src, dst);
      } else {
#pragma unroll
        for (int j = 0; j < C::XV; ++j) dst[j] = 0.f;
      }
    }
    // stage the row of g
    constexpr int kGVecs = C::kTW * (CO / C::GV);
    for (int i = t; i < kGVecs; i += C::kThreads) {
      const int v = i % (CO / C::GV);
      const int p = i / (CO / C::GV);
      float* dst = g_s + p * CO + v * C::GV;
      if (p < n_px) {
        load_vec<C::GV>(g + (((size_t)plane * H + y) * W + x0 + p) * CO +
                            v * C::GV,
                        dst);
      } else {
#pragma unroll
        for (int j = 0; j < C::GV; ++j) dst[j] = 0.f;
      }
    }
    __syncthreads();

    for (int p = slice; p < n_px; p += C::PS) {
      float gv[C::COT];
      const float* gp = g_s + p * CO + cog * C::COT;
      if constexpr (C::COT == 4) {
        const float4 q = *reinterpret_cast<const float4*>(gp);
        gv[0] = q.x; gv[1] = q.y; gv[2] = q.z; gv[3] = q.w;
      } else {
#pragma unroll
        for (int j = 0; j < C::COT; ++j) gv[j] = gp[j];
      }
#pragma unroll
      for (int kz = 0; kz < KD; ++kz) {
        const float* xp =
            x_s + ((kz * 3 + ky) * C::kCols + p + col_off) * CI + cig * C::CIT;
        float xv[C::CIT];
        if constexpr (C::CIT % 4 == 0) {
#pragma unroll
          for (int i = 0; i < C::CIT; i += 4) {
            const float4 q = *reinterpret_cast<const float4*>(xp + i);
            xv[i] = q.x; xv[i + 1] = q.y; xv[i + 2] = q.z; xv[i + 3] = q.w;
          }
        } else {
#pragma unroll
          for (int i = 0; i < C::CIT; ++i) xv[i] = xp[i];
        }
#pragma unroll
        for (int i = 0; i < C::CIT; ++i)
#pragma unroll
          for (int j = 0; j < C::COT; ++j)
            acc[kz][i][j] = fmaf(xv[i], gv[j], acc[kz][i][j]);
      }
    }
  }

  // partial dW of this block and pixel slice, laid out like dW
  const size_t part =
      ((size_t)(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) *
          C::PS + slice;
  float* out = partial + part * C::kOut;
#pragma unroll
  for (int kz = 0; kz < KD; ++kz)
#pragma unroll
    for (int i = 0; i < C::CIT; ++i)
#pragma unroll
      for (int j = 0; j < C::COT; ++j)
        out[((kz * 9 + tap) * CI + cig * C::CIT + i) * CO + cog * C::COT + j] =
            acc[kz][i][j];
}

// out[i] = sum_p partial[p, i], p in order.  Block (32, 8): 32 outputs, each
// summed by 8 threads over interleaved partials, then across the 8 in order.
__global__ void __launch_bounds__(256)
dw_sum_kernel(const float* __restrict__ partial, float* __restrict__ out,
              int n_parts, int n_out) {
  __shared__ float s[8][33];
  const int i = blockIdx.x * 32 + threadIdx.x;
  float acc = 0.f;
  if (i < n_out)
    for (int p = threadIdx.y; p < n_parts; p += 8)
      acc += partial[(size_t)p * n_out + i];
  s[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && i < n_out) {
    float total = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) total += s[k][threadIdx.x];
    out[i] = total;
  }
}

struct Plan {
  dim3 grid;
  int rows;     // output rows a block walks
  int n_parts;  // partial dW written by pass 1
  int n_out;    // dW entries
};

template <int KD, int CI, int CO>
Plan make_plan(int n, int d, int h, int w) {
  using C = DwCfg<KD, CI, CO>;
  const int col_tiles = (w + C::kTW - 1) / C::kTW;
  const int planes = n * d;
  const int want = (kTargetBlocks + col_tiles * planes - 1) / (col_tiles * planes);
  const int chunks = max(1, min(h, want));
  const int rows = (h + chunks - 1) / chunks;
  const int row_chunks = (h + rows - 1) / rows;
  Plan p;
  p.grid = dim3(col_tiles, row_chunks, planes);
  p.rows = rows;
  p.n_parts = col_tiles * row_chunks * planes * C::PS;
  p.n_out = C::kOut;
  return p;
}

template <typename T, int KD, int CI, int CO>
cudaError_t launch(const void* x, const void* g, float* work, float* out,
                   int n, int d, int h, int w, int dil, cudaStream_t st) {
  using C = DwCfg<KD, CI, CO>;
  const Plan p = make_plan<KD, CI, CO>(n, d, h, w);
  dw_partial_kernel<T, KD, CI, CO><<<p.grid, C::kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), work, d, h, w, dil,
      p.rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dw_sum_kernel<<<(p.n_out + 31) / 32, dim3(32, 8), 0, st>>>(work, out,
                                                            p.n_parts, p.n_out);
  return cudaGetLastError();
}

// One CUDA-core launch, float32 (bf16 runs on the tensor cores,
// rsm_dw_reduce_tc).
template <int KD, int CI, int CO>
cudaError_t dispatch(const void* x, const void* g, float* work, float* out,
                     int dtype, int n, int d, int h, int w, int dil,
                     cudaStream_t st) {
  if (dtype == rsm::kFloat32)
    return launch<float, KD, CI, CO>(x, g, work, out, n, d, h, w, dil, st);
  return cudaErrorInvalidValue;
}

// The tensor-core kernel by a plan of kernels/train_conv.py (dw_tc_plan),
// then the fixed-order sum of its gx * gy partials.  cudaErrorInvalidValue
// for a plan this kernel does not take.
template <int KD, int CI, int CO>
cudaError_t launch_dw_tc(const void* x, const void* g, float* work,
                         long long work_floats, float* out, int n, int d,
                         int h, int w, int dil, int th, int tw, int ring,
                         int steps, int gx, int gy, int gz, int smem,
                         cudaStream_t st) {
  using namespace rsm::tc;
  using P = DwPair<CI, CO>;
  const int rows = n * d * h;
  const int tiles = (rows + kDwTH - 1) / kDwTH;
  // a staged 32-channel row is at most one 16-byte chunk a thread, a later
  // step's narrow pixels at most kDwPre a thread
  const int x_staged = CI == kC ? (tw + 2 * dil) * 4 : th * (tw + 2 * dil);
  const int g_staged = CO == kC ? tw * 4 : th * tw;
  const int x_most = CI == kC ? kDwThreads : kDwPre * kDwThreads;
  const int g_most = CO == kC ? kDwThreads : kDwPre * kDwThreads;
  const bool tile_ok = th == kDwTH && tw >= 16 && tw % 16 == 0 &&
                       x_staged <= x_most && g_staged <= g_most &&
                       ring == 2 * th + 2 * dil && steps >= 1;
  const bool grid_ok = gx == (w + tw - 1) / tw &&
                       gy == (tiles + steps - 1) / steps && gy <= 65535 &&
                       gz == KD;
  if (!tile_ok || !grid_ok || smem != dw_smem_bytes<CI, CO>(tw, dil, ring) ||
      work_floats != (long long)gx * gy * gz * P::kOut)
    return cudaErrorInvalidValue;
  static int opted[64] = {};  // per device, for this instantiation
  cudaError_t err = rsm::opt_in_smem(dw_tc_kernel<KD, CI, CO>, smem, opted);
  if (err != cudaSuccess) return err;
  dw_tc_kernel<KD, CI, CO><<<dim3(gx, gy, gz), kDwThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(g), work, d, h, w, rows, dil, tw,
      ring, steps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dw_sum_kernel<<<(KD * P::kOut + 31) / 32, dim3(32, 8), 0, st>>>(
      work, out, gx * gy, KD * P::kOut);
  return cudaGetLastError();
}

// The (KD, CI, CO) cases this file instantiates.
#define RSM_DW_CASES(X)                                           \
  X(1, 32, 32) X(1, 4, 32) X(1, 7, 32) X(1, 32, 1) X(3, 32, 32) \
  X(3, 32, 1)

bool valid_args(int kd, int dil) {
  return kd == 1 ? (dil >= 1 && dil <= kMaxDil) : (kd == 3 && dil == 1);
}

}  // namespace

extern "C" {

// Floats of workspace rsm_dw_reduce needs for this problem; -1 for a case
// that is not instantiated.  For a 2D conv pass d = 1 and kd = 1.
long long rsm_dw_workspace(int n, int d, int h, int w, int cin, int cout,
                           int kd, int dil) {
  if (!valid_args(kd, dil)) return -1;
#define RSM_CASE(KD, CI, CO)                                  \
  if (kd == KD && cin == CI && cout == CO) {                  \
    const Plan p = make_plan<KD, CI, CO>(n, d, h, w);         \
    return (long long)p.n_parts * p.n_out;                    \
  }
  RSM_DW_CASES(RSM_CASE)
#undef RSM_CASE
  return -1;
}

// x (n, d, h, w, cin), g (n, d, h, w, cout) float32 (`dtype`); work holds
// rsm_dw_workspace(...) floats; out (kd, 3, 3, cin, cout) float32.
int rsm_dw_reduce(const void* x, const void* g, void* work, void* out,
                  int dtype, int n, int d, int h, int w, int cin, int cout,
                  int kd, int dil, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!valid_args(kd, dil)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* wk = static_cast<float*>(work);
  float* o = static_cast<float*>(out);
#define RSM_CASE(KD, CI, CO)                                           \
  if (kd == KD && cin == CI && cout == CO)                             \
    return dispatch<KD, CI, CO>(x, g, wk, o, dtype, n, d, h, w, dil, st);
  RSM_DW_CASES(RSM_CASE)
#undef RSM_CASE
  return cudaErrorInvalidValue;
}

// bf16 on the tensor cores by the plan of kernels/train_conv.py
// (dw_tc_plan): kDwTH-row steps of `tw`-column strips, `ring` x rows,
// `steps` steps a block, grid (gx, gy, gz = kd), `smem` dynamic shared
// bytes; work holds work_floats = gx * gy * kd * 9 * cin * cout floats.
int rsm_dw_reduce_tc(const void* x, const void* g, void* work, void* out,
                     long long work_floats, int n, int d, int h, int w,
                     int cin, int cout, int kd, int dil, int th, int tw,
                     int ring, int steps, int gx, int gy, int gz, int smem,
                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!valid_args(kd, dil)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* wk = static_cast<float*>(work);
  float* o = static_cast<float*>(out);
#define RSM_CASE(KD, CI, CO)                                                \
  if (kd == KD && cin == CI && cout == CO)                                  \
    return launch_dw_tc<KD, CI, CO>(x, g, wk, work_floats, o, n, d, h, w,   \
                                    dil, th, tw, ring, steps, gx, gy, gz,   \
                                    smem, st);
  RSM_DW_CASES(RSM_CASE)
#undef RSM_CASE
  return cudaErrorInvalidValue;
}

}  // extern "C"
