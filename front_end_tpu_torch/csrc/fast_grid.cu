// Fused grid FAST detector for sm_90a: cv2-exact FAST margins, per-pixel
// cell threshold, tie-annihilating 3x3 NMS, per-cell 2x2 winner pooling and
// exact per-cell survivor counts, in one pass over the image.
//
// Replaces front_end_tpu/ops/pallas/fast_kernel.py::fast_detect_grid_pallas.
// Semantics are those of the XLA path (fast.detect_dense + the pooling of
// grid._detect_from_map): see front_end_tpu_torch/ops/kernels/fast_grid.py.
//
// Block = 16x16 threads = one 16x16 tile of pooled blocks (32x32 pixels) of
// ONE cell.  Shared memory holds the image tile with a 4-pixel halo
// (40x40) and the thresholded pre-NMS scores with a 1-pixel halo (34x34).
// The segment test itself is shared with the dense kernels
// (fast_segment.cuh); only subtractions, min, max and compares touch the
// pixel values, so the result is bit-identical to the plain version in any
// evaluation order.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fast_segment.cuh"

namespace {

constexpr int TP = 16;                 // pooled blocks per tile side
constexpr int TPIX = 2 * TP;           // output pixels per tile side
constexpr int S0 = TPIX + 2;           // scores: 1-pixel NMS halo
constexpr int IMG = S0 + 6;            // image: + 3-pixel circle halo
constexpr int NTHREADS = TP * TP;

template <int N, int K>
__global__ void __launch_bounds__(NTHREADS)
fast_grid_kernel(const float* __restrict__ img, const float* __restrict__ thr,
                 float* __restrict__ pooled, uint8_t* __restrict__ code,
                 int* __restrict__ counts, int H, int W, int Gr, int Gc,
                 int ch, int cw, int ph, int pw) {
  __shared__ float s_img[IMG * IMG];
  __shared__ float s_sc[S0 * S0];

  const int cellz = blockIdx.z;                   // (b * Gr + gr) * Gc + gc
  const int b = cellz / (Gr * Gc);
  const int gr = (cellz / Gc) % Gr;
  const int gc = cellz % Gc;
  const int py0 = blockIdx.y * TP, px0 = blockIdx.x * TP;
  const int y0 = gr * ch + 2 * py0;               // tile's first pixel
  const int x0 = gc * cw + 2 * px0;
  const float* im = img + (size_t)b * H * W;
  const float* th = thr + (size_t)b * Gr * Gc;
  const int tid = threadIdx.y * TP + threadIdx.x;

  // 1. image tile, origin (y0 - 4, x0 - 4), edge-clamped reads
  load_tile<IMG, NTHREADS>(im, s_img, y0 - 4, x0 - 4, H, W, tid);
  __syncthreads();

  // 2. thresholded scores of the ring, origin (y0 - 1, x0 - 1); cv2's
  //    border (rows/cols [3, size - 4]) and everything off-image is 0
  for (int i = tid; i < S0 * S0; i += NTHREADS) {
    const int ly = i / S0, lx = i % S0;
    const int gy = y0 - 1 + ly, gx = x0 - 1 + lx;
    float s = 0.f;
    if (fast_interior(gy, gx, H, W)) {
      float det, sc;
      margins<N, K, IMG>(s_img, ly + 3, lx + 3, det, sc);
      const float t = th[min(gy / ch, Gr - 1) * Gc + min(gx / cw, Gc - 1)];
      s = det > t ? sc : 0.f;
    }
    s_sc[i] = s;
  }
  __syncthreads();

  // 3. NMS of this thread's 2x2 block, pooling, survivor count
  const int py = py0 + threadIdx.y, px = px0 + threadIdx.x;
  int alive = 0;
  if (py < ph && px < pw) {
    float v[2][2];
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        float s = 0.f;
        // cell-local row/col; the zero pad of an odd cell is not a pixel
        if (2 * py + dy < ch && 2 * px + dx < cw) {
          const int ly = 1 + 2 * threadIdx.y + dy;
          const int lx = 1 + 2 * threadIdx.x + dx;
          const float s0 = s_sc[ly * S0 + lx];
          float nb = s_sc[(ly - 1) * S0 + lx - 1];
          nb = fmaxf(nb, s_sc[(ly - 1) * S0 + lx]);
          nb = fmaxf(nb, s_sc[(ly - 1) * S0 + lx + 1]);
          nb = fmaxf(nb, s_sc[ly * S0 + lx - 1]);
          nb = fmaxf(nb, s_sc[ly * S0 + lx + 1]);
          nb = fmaxf(nb, s_sc[(ly + 1) * S0 + lx - 1]);
          nb = fmaxf(nb, s_sc[(ly + 1) * S0 + lx]);
          nb = fmaxf(nb, s_sc[(ly + 1) * S0 + lx + 1]);
          s = s0 > nb ? s0 : 0.f;
          alive += s > 0.f;
        }
        v[dy][dx] = s;
      }
    }
    // column pair first (ties to A), then the row pair (ties to A)
    const float m1a = fmaxf(v[0][0], v[0][1]);
    const float m1b = fmaxf(v[1][0], v[1][1]);
    const int w1a = v[0][1] > v[0][0];
    const int w1b = v[1][1] > v[1][0];
    const int w2 = m1b > m1a;
    const size_t o = (size_t)cellz * ph * pw + (size_t)py * pw + px;
    pooled[o] = fmaxf(m1a, m1b);
    code[o] = (uint8_t)(2 * w2 + (w2 ? w1b : w1a));
  }
  const int warp_alive = __reduce_add_sync(0xffffffffu, alive);
  if ((tid & 31) == 0 && warp_alive) atomicAdd(&counts[cellz], warp_alive);
}

}  // namespace

extern "C" int fast_grid_launch(const void* img, const void* thr,
                                void* pooled, void* code, void* counts, int B,
                                int H, int W, int Gr, int Gc, int ch, int cw,
                                int n, void* stream) {
  const int ph = (ch + 1) / 2, pw = (cw + 1) / 2;
  const dim3 grid((pw + TP - 1) / TP, (ph + TP - 1) / TP, B * Gr * Gc);
  const dim3 block(TP, TP);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* i = static_cast<const float*>(img);
  const float* t = static_cast<const float*>(thr);
  float* p = static_cast<float*>(pooled);
  uint8_t* c = static_cast<uint8_t*>(code);
  int* k = static_cast<int*>(counts);
  if (n == 16) {
    fast_grid_kernel<16, 9><<<grid, block, 0, s>>>(i, t, p, c, k, H, W, Gr,
                                                   Gc, ch, cw, ph, pw);
  } else if (n == 12) {
    fast_grid_kernel<12, 7><<<grid, block, 0, s>>>(i, t, p, c, k, H, W, Gr,
                                                   Gc, ch, cw, ph, pw);
  } else if (n == 8) {
    fast_grid_kernel<8, 5><<<grid, block, 0, s>>>(i, t, p, c, k, H, W, Gr,
                                                  Gc, ch, cw, ph, pw);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
