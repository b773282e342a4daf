// Dense FAST detector for sm_90a: cv2-exact margins, threshold gate (one
// scalar, or a per-pixel map when the caller has one) and the optional
// tie-annihilating 3x3 NMS, written as the full-resolution map of surviving
// corner scores.
//
// Replaces front_end_tpu/ops/pallas/fast_kernel.py::fast_detect_pallas
// (body _detect_kernel, core _nms_survivors).  Bit-identical to
// ops/fast.py::detect_dense_plain: see ops/kernels/fast_detect.py.
//
// Block = one 32 x SH score window, a warp per window row: with NMS the
// window is the block's 30 x (SH - 2) output tile plus a 1-pixel ring,
// since the NMS compares the THRESHOLDED sparse scores of the 8
// neighbours; without NMS it is the tile.  Shared memory holds the image
// tile with a 3-pixel halo around the window (38 wide), read with clamped
// coordinates (no padded copy of the image exists), and the gated scores.
// The scores come from `gated_scores` (fast_segment.cuh): every pixel
// takes the cheap rejection bound, only the survivors, compacted into a
// list, take the segment test.  Then the tile is written out by rows.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fast_segment.cuh"

namespace {

// The threshold of one lane's pixel in row ly of a score window whose first
// row is y0, +inf where the pixel takes no part: cv2's border (it processes
// rows/cols [3, size - 4]) and everything off-image is 0.
struct DetectThreshold {
  bool col_ok;          // the lane's column is inside cv2's border
  int y0, H, W;
  float scalar;
  const float* column;  // the lane's column of the (H, W) map, or nullptr
  __device__ __forceinline__ float operator()(int ly) const {
    const int gy = y0 + ly;
    if (!col_ok || gy < 3 || gy > H - 4) return INFINITY;
    return column ? column[(size_t)gy * W] : scalar;
  }
};

template <int N, int K, bool NMS, int SH>
__global__ void __launch_bounds__(8 * SH)
fast_detect_kernel(const float* __restrict__ img, float thr_scalar,
                   const float* __restrict__ thr_map, long long thr_bstride,
                   float* __restrict__ out, int H, int W) {
  constexpr int NT = 8 * SH, NW = NT / 32;   // a warp per 4 window rows
  constexpr int RING = NMS ? 1 : 0;
  constexpr int SW = SCORE_W, IW = TILE_W, IH = SH + 6;
  constexpr int TW = SW - 2 * RING, TH = SH - 2 * RING;   // output tile
  __shared__ float s_img[IW * IH];
  __shared__ ScoreScratch<SH> ws;

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const float* im = img + (size_t)b * H * W;
  const float* tm = thr_map ? thr_map + (size_t)b * thr_bstride : nullptr;
  float* o = out + (size_t)b * H * W;
  const int tid = threadIdx.x;

  load_tile<IW, IH, NT>(im, s_img, y0 - 3 - RING, x0 - 3 - RING, H, W, tid);
  __syncthreads();

  // gated scores, origin (y0 - RING, x0 - RING)
  const int lane = tid & 31, wx = x0 - RING + lane;
  gated_scores<N, K, SH, NT>(
      s_img, ws, tid,
      DetectThreshold{wx >= 3 && wx <= W - 4, y0 - RING, H, W, thr_scalar,
                      tm ? tm + wx : nullptr});
  const float* s_sc = ws.score;

  const int gx = x0 + lane;
  if (lane >= TW || gx >= W) return;
  for (int ly = tid >> 5; ly < TH; ly += NW) {
    const int gy = y0 + ly;
    if (gy >= H) break;
    const float* s = s_sc + (ly + RING) * SW + lane + RING;
    float v = s[0];
    if constexpr (NMS) v = nms_survivor(s);
    o[(size_t)gy * W + gx] = v;
  }
}

template <int N, int K, int SH>
void launch_type(bool nms, int B, cudaStream_t s, const float* img, float t,
                 const float* tm, long long tb, float* out, int H, int W) {
  constexpr int NT = 8 * SH;
  if (nms) {
    const dim3 grid((W + SCORE_W - 3) / (SCORE_W - 2),
                    (H + SH - 3) / (SH - 2), B);
    fast_detect_kernel<N, K, true, SH><<<grid, NT, 0, s>>>(
        img, t, tm, tb, out, H, W);
  } else {
    const dim3 grid((W + SCORE_W - 1) / SCORE_W, (H + SH - 1) / SH, B);
    fast_detect_kernel<N, K, false, SH><<<grid, NT, 0, s>>>(
        img, t, tm, tb, out, H, W);
  }
}

template <int SH>
int launch(int n, bool nms, int B, cudaStream_t s, const float* img, float t,
           const float* tm, long long tb, float* out, int H, int W) {
  if (n == 16) {
    launch_type<16, 9, SH>(nms, B, s, img, t, tm, tb, out, H, W);
  } else if (n == 12) {
    launch_type<12, 7, SH>(nms, B, s, img, t, tm, tb, out, H, W);
  } else if (n == 8) {
    launch_type<8, 5, SH>(nms, B, s, img, t, tm, tb, out, H, W);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// thr_map == nullptr: the scalar threshold gates every pixel.  Otherwise
// thr_map holds per-pixel thresholds, image b's at thr_map + b * thr_bstride
// (0 shares one (H, W) map across the batch).  The height of a block's
// score window, 32 or 16 rows, follows from the size of the image: see
// choose_rows.
extern "C" int fast_detect_launch(const void* img, float thr_scalar,
                                  const void* thr_map, long long thr_bstride,
                                  void* out, int B, int H, int W, int n,
                                  int nms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* i = static_cast<const float*>(img);
  const float* tm = static_cast<const float*>(thr_map);
  float* o = static_cast<float*>(out);
  const int tw = nms ? SCORE_W - 2 : SCORE_W;    // a 32-row window's tile
  if (choose_rows((W + tw - 1) / tw * ((H + tw - 1) / tw) * B) == 32)
    return launch<32>(n, nms != 0, B, s, i, thr_scalar, tm, thr_bstride, o, H,
                      W);
  return launch<16>(n, nms != 0, B, s, i, thr_scalar, tm, thr_bstride, o, H,
                    W);
}
