// Dense FAST margin maps for sm_90a: per pixel the detection margin (the
// segment test gated by cv2's quick-rejection pairs) and the score (the
// pure segment-test margin = cv2 response + 1), with the 3-pixel border
// zeroed.  These are the threshold-free maps a detector sweep evaluates
// every threshold against.
//
// Replaces front_end_tpu/ops/pallas/fast_kernel.py::fast_margins_pallas
// (body _kernel).  Bit-identical to ops/fast.py::fast_margins_plain: see
// ops/kernels/fast_margins.py.
//
// Block = one 32 x 16 pixel window, four warps taking a row at a time (4
// rows a warp): a lane's column, its border test and its store offsets are
// fixed, a row's are uniform over the warp, and no index is divided.  The
// image tile with its 3-pixel circle halo (38 x 22) is staged in shared
// memory by `load_tile` (clamped reads, all of a thread's loads in flight); every
// pixel takes the full segment test (`margins`, fast_segment.cuh: there is
// no threshold, so nothing can be skipped), cv2's border is zeroed by a
// select, and a warp stores 32 consecutive floats of each map.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fast_segment.cuh"

namespace {

constexpr int SH = 16;                 // window rows
constexpr int NT = 8 * SH;             // a warp per 4 window rows
constexpr int IH = SH + 6;

template <int N, int K>
__global__ void __launch_bounds__(NT)
fast_margins_kernel(const float* __restrict__ img, float* __restrict__ detect,
                    float* __restrict__ score, int H, int W) {
  constexpr int SW = SCORE_W, IW = TILE_W, NW = NT / 32;
  __shared__ float s_img[IW * IH];
  const size_t base = (size_t)blockIdx.z * H * W;
  const int y0 = blockIdx.y * SH, x0 = blockIdx.x * SW;
  const int tid = threadIdx.x, lane = tid & 31;

  load_tile<IW, IH, NT>(img + base, s_img, y0 - 3, x0 - 3, H, W, tid);
  __syncthreads();

  const int gx = x0 + lane;
  if (gx >= W) return;
  // cv2 processes rows/cols [3, size - 4] for every pattern size
  const bool col_ok = gx >= 3 && gx <= W - 4;
  const float* px = s_img + 3 * IW + lane + 3;
  float* d = detect + base + gx;
  float* s = score + base + gx;
#pragma unroll
  for (int k = 0; k < SH / NW; ++k) {
    const int ly = (tid >> 5) + k * NW, gy = y0 + ly;
    if (gy >= H) break;
    float det, sc;
    margins<N, K, IW>(px + ly * IW, det, sc);
    const bool in = col_ok && gy >= 3 && gy <= H - 4;
    d[(size_t)gy * W] = in ? det : 0.f;
    s[(size_t)gy * W] = in ? sc : 0.f;
  }
}

}  // namespace

extern "C" int fast_margins_launch(const void* img, void* detect, void* score,
                                   int B, int H, int W, int n, void* stream) {
  const dim3 grid((W + SCORE_W - 1) / SCORE_W, (H + SH - 1) / SH, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* i = static_cast<const float*>(img);
  float* d = static_cast<float*>(detect);
  float* c = static_cast<float*>(score);
  if (n == 16) {
    fast_margins_kernel<16, 9><<<grid, NT, 0, s>>>(i, d, c, H, W);
  } else if (n == 12) {
    fast_margins_kernel<12, 7><<<grid, NT, 0, s>>>(i, d, c, H, W);
  } else if (n == 8) {
    fast_margins_kernel<8, 5><<<grid, NT, 0, s>>>(i, d, c, H, W);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
