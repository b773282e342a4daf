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
// Block = 256 threads = one 32x32 tile of pixels; the image tile with its
// 3-pixel circle halo (38x38) is staged in shared memory with clamped
// reads, then each thread computes 4 pixels and writes both maps.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fast_segment.cuh"

namespace {

constexpr int TILE = 32;
constexpr int IMG = TILE + 6;
constexpr int NTHREADS = 256;

template <int N, int K>
__global__ void __launch_bounds__(NTHREADS)
fast_margins_kernel(const float* __restrict__ img, float* __restrict__ detect,
                    float* __restrict__ score, int H, int W) {
  __shared__ float s_img[IMG * IMG];
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TILE, x0 = blockIdx.x * TILE;
  const size_t base = (size_t)b * H * W;
  const int tid = threadIdx.x;

  load_tile<IMG, IMG, NTHREADS>(img + base, s_img, y0 - 3, x0 - 3, H, W,
                                tid);
  __syncthreads();

  for (int i = tid; i < TILE * TILE; i += NTHREADS) {
    const int ly = i / TILE, lx = i % TILE;
    const int gy = y0 + ly, gx = x0 + lx;
    if (gy >= H || gx >= W) continue;
    float det = 0.f, sc = 0.f;
    if (fast_interior(gy, gx, H, W)) {
      margins<N, K, IMG>(s_img + (ly + 3) * IMG + lx + 3, det, sc);
    }
    const size_t o = base + (size_t)gy * W + gx;
    detect[o] = det;
    score[o] = sc;
  }
}

}  // namespace

extern "C" int fast_margins_launch(const void* img, void* detect, void* score,
                                   int B, int H, int W, int n, void* stream) {
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* i = static_cast<const float*>(img);
  float* d = static_cast<float*>(detect);
  float* c = static_cast<float*>(score);
  if (n == 16) {
    fast_margins_kernel<16, 9><<<grid, NTHREADS, 0, s>>>(i, d, c, H, W);
  } else if (n == 12) {
    fast_margins_kernel<12, 7><<<grid, NTHREADS, 0, s>>>(i, d, c, H, W);
  } else if (n == 8) {
    fast_margins_kernel<8, 5><<<grid, NTHREADS, 0, s>>>(i, d, c, H, W);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
