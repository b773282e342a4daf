// Dense FAST detector for sm_90a: cv2-exact margins, threshold gate (one
// scalar, or a per-pixel map when the caller has one) and the optional
// tie-annihilating 3x3 NMS, written as the full-resolution map of surviving
// corner scores.
//
// Replaces front_end_tpu/ops/pallas/fast_kernel.py::fast_detect_pallas
// (body _detect_kernel, core _nms_survivors).  Bit-identical to
// ops/fast.py::detect_dense_plain: see ops/kernels/fast_detect.py.
//
// Block = 256 threads = one 32x32 tile of output pixels.  Shared memory
// holds the image tile with a (3 + RING)-pixel halo, read with clamped
// coordinates (no padded copy of the image exists), and — with NMS — the
// gated scores of the tile plus a 1-pixel ring, since the NMS compares the
// THRESHOLDED sparse scores of the 8 neighbours.  Without NMS there is no
// ring and each thread writes its gated score straight out.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fast_segment.cuh"

namespace {

constexpr int TILE = 32;               // output pixels per tile side
constexpr int NTHREADS = 256;

template <int N, int K, bool NMS>
__global__ void __launch_bounds__(NTHREADS)
fast_detect_kernel(const float* __restrict__ img, float thr_scalar,
                   const float* __restrict__ thr_map, long long thr_bstride,
                   float* __restrict__ out, int H, int W) {
  constexpr int RING = NMS ? 1 : 0;
  constexpr int S0 = TILE + 2 * RING;    // gated scores
  constexpr int IMG = S0 + 6;            // image: + 3-pixel circle halo
  __shared__ float s_img[IMG * IMG];
  __shared__ float s_sc[NMS ? S0 * S0 : 1];

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TILE, x0 = blockIdx.x * TILE;
  const float* im = img + (size_t)b * H * W;
  const float* tm = thr_map ? thr_map + (size_t)b * thr_bstride : nullptr;
  float* o = out + (size_t)b * H * W;
  const int tid = threadIdx.x;

  load_tile<IMG, NTHREADS>(im, s_img, y0 - 3 - RING, x0 - 3 - RING, H, W,
                           tid);
  __syncthreads();

  // gated scores, origin (y0 - RING, x0 - RING); cv2's border and
  // everything off-image is 0
  for (int i = tid; i < S0 * S0; i += NTHREADS) {
    const int ly = i / S0, lx = i % S0;
    const int gy = y0 - RING + ly, gx = x0 - RING + lx;
    float s = 0.f;
    if (fast_interior(gy, gx, H, W)) {
      float det, sc;
      margins<N, K, IMG>(s_img, ly + 3, lx + 3, det, sc);
      const float t = tm ? tm[(size_t)gy * W + gx] : thr_scalar;
      s = det > t ? sc : 0.f;
    }
    if (NMS) {
      s_sc[i] = s;
    } else if (gy < H && gx < W) {
      o[(size_t)gy * W + gx] = s;
    }
  }
  if (!NMS) return;
  __syncthreads();

  for (int i = tid; i < TILE * TILE; i += NTHREADS) {
    const int ly = 1 + i / TILE, lx = 1 + i % TILE;
    const int gy = y0 + ly - 1, gx = x0 + lx - 1;
    if (gy >= H || gx >= W) continue;
    const float s0 = s_sc[ly * S0 + lx];
    float nb = s_sc[(ly - 1) * S0 + lx - 1];
    nb = fmaxf(nb, s_sc[(ly - 1) * S0 + lx]);
    nb = fmaxf(nb, s_sc[(ly - 1) * S0 + lx + 1]);
    nb = fmaxf(nb, s_sc[ly * S0 + lx - 1]);
    nb = fmaxf(nb, s_sc[ly * S0 + lx + 1]);
    nb = fmaxf(nb, s_sc[(ly + 1) * S0 + lx - 1]);
    nb = fmaxf(nb, s_sc[(ly + 1) * S0 + lx]);
    nb = fmaxf(nb, s_sc[(ly + 1) * S0 + lx + 1]);
    o[(size_t)gy * W + gx] = s0 > nb ? s0 : 0.f;
  }
}

template <int N, int K>
void launch(bool nms, dim3 grid, cudaStream_t s, const float* img, float t,
            const float* tm, long long tb, float* out, int H, int W) {
  if (nms) {
    fast_detect_kernel<N, K, true><<<grid, NTHREADS, 0, s>>>(img, t, tm, tb,
                                                             out, H, W);
  } else {
    fast_detect_kernel<N, K, false><<<grid, NTHREADS, 0, s>>>(img, t, tm, tb,
                                                              out, H, W);
  }
}

}  // namespace

// thr_map == nullptr: the scalar threshold gates every pixel.  Otherwise
// thr_map holds per-pixel thresholds, image b's at thr_map + b * thr_bstride
// (0 shares one (H, W) map across the batch).
extern "C" int fast_detect_launch(const void* img, float thr_scalar,
                                  const void* thr_map, long long thr_bstride,
                                  void* out, int B, int H, int W, int n,
                                  int nms, void* stream) {
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* i = static_cast<const float*>(img);
  const float* tm = static_cast<const float*>(thr_map);
  float* o = static_cast<float*>(out);
  if (n == 16) {
    launch<16, 9>(nms != 0, grid, s, i, thr_scalar, tm, thr_bstride, o, H, W);
  } else if (n == 12) {
    launch<12, 7>(nms != 0, grid, s, i, thr_scalar, tm, thr_bstride, o, H, W);
  } else if (n == 8) {
    launch<8, 5>(nms != 0, grid, s, i, thr_scalar, tm, thr_bstride, o, H, W);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
