// The FAST segment test shared by the three FAST kernels (fast_grid.cu,
// fast_detect.cu, fast_margins.cu): circle offsets, the arc margin, cv2's
// quick-rejection gate, the per-pixel (detect, score) margins and the
// edge-clamped staging of an image tile in shared memory.  One copy, so a
// change of a tie rule reaches every kernel (the JAX package shares
// `_arc_margin` / `_quick_margin` / `_nms_survivors` for the same reason).
//
// Only subtractions, negations, min, max and compares touch the pixel
// values, so each result is bit-identical to the plain version in
// `ops/fast.py` in any evaluation order.  Compile without fast-math.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Circle offsets (dx, dy), y down, OpenCV makeOffsets order.
__constant__ int8_t kC16[16][2] = {
    {0, 3}, {1, 3}, {2, 2}, {3, 1}, {3, 0}, {3, -1}, {2, -2}, {1, -3},
    {0, -3}, {-1, -3}, {-2, -2}, {-3, -1}, {-3, 0}, {-3, 1}, {-2, 2},
    {-1, 3}};
__constant__ int8_t kC12[12][2] = {
    {0, 2}, {1, 2}, {2, 1}, {2, 0}, {2, -1}, {1, -2}, {0, -2}, {-1, -2},
    {-2, -1}, {-2, 0}, {-2, 1}, {-1, 2}};
__constant__ int8_t kC8[8][2] = {
    {0, 1}, {1, 1}, {1, 0}, {1, -1}, {0, -1}, {-1, -1}, {-1, 0}, {-1, 1}};

template <int N>
__device__ __forceinline__ int cdx(int i) {
  return N == 16 ? kC16[i][0] : (N == 12 ? kC12[i][0] : kC8[i][0]);
}
template <int N>
__device__ __forceinline__ int cdy(int i) {
  return N == 16 ? kC16[i][1] : (N == 12 ? kC12[i][1] : kC8[i][1]);
}

__host__ __device__ constexpr int floor_log2(int k) {
  return k < 2 ? 0 : 1 + floor_log2(k / 2);
}

// max over circular starts s of min over the K-window of w[(s + j) % N]:
// sparse-table doubling, then one overlapping combine (min is idempotent).
template <int N, int K>
__device__ __forceinline__ float arc_margin(float (&w)[N]) {
  constexpr int LOG = floor_log2(K);
#pragma unroll
  for (int pass = 0; pass < LOG; ++pass) {
    const int width = 1 << pass;
    float t[N];
#pragma unroll
    for (int i = 0; i < N; ++i) t[i] = fminf(w[i], w[(i + width) % N]);
#pragma unroll
    for (int i = 0; i < N; ++i) w[i] = t[i];
  }
  constexpr int REST = K - (1 << LOG);
  if (REST > 0) {
    float t[N];
#pragma unroll
    for (int i = 0; i < N; ++i) t[i] = fminf(w[i], w[(i + REST) % N]);
#pragma unroll
    for (int i = 0; i < N; ++i) w[i] = t[i];
  }
  float best = w[0];
#pragma unroll
  for (int i = 1; i < N; ++i) best = fmaxf(best, w[i]);
  return best;
}

// min over cv2's 8 quick-test pairs (k, (k + 8) mod N) of the pair max.
template <int N>
__device__ __forceinline__ float quick_margin(const float (&d)[N]) {
  float m = fmaxf(d[0], d[8 % N]);
#pragma unroll
  for (int k = 1; k < 8; ++k) m = fminf(m, fmaxf(d[k % N], d[(k + 8) % N]));
  return m;
}

// (detect, score) margins of the pixel at (ty, tx) of an image tile whose
// rows are STRIDE floats apart.
template <int N, int K, int STRIDE>
__device__ __forceinline__ void margins(const float* tile, int ty, int tx,
                                        float& detect, float& score) {
  const float p = tile[ty * STRIDE + tx];
  float dark[N], bright[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    dark[i] = p - tile[(ty + cdy<N>(i)) * STRIDE + tx + cdx<N>(i)];
    bright[i] = -dark[i];
  }
  float qd = 0.f, qb = 0.f;
  if (N != 16) {
    qd = quick_margin<N>(dark);
    qb = quick_margin<N>(bright);
  }
  const float rd = arc_margin<N, K>(dark);
  const float rb = arc_margin<N, K>(bright);
  score = fmaxf(rd, rb);
  detect = N == 16 ? score : fmaxf(fminf(rd, qd), fminf(rb, qb));
}

// Stage the SIDE x SIDE image tile whose first pixel is (y0, x0) — which may
// lie off the image — with edge-clamped reads.  The caller synchronizes.
template <int SIDE, int NTHREADS>
__device__ __forceinline__ void load_tile(const float* __restrict__ im,
                                          float* tile, int y0, int x0, int H,
                                          int W, int tid) {
  for (int i = tid; i < SIDE * SIDE; i += NTHREADS) {
    const int gy = min(max(y0 + i / SIDE, 0), H - 1);
    const int gx = min(max(x0 + i % SIDE, 0), W - 1);
    tile[i] = im[(size_t)gy * W + gx];
  }
}

// cv2 processes rows/cols [3, size - 4] for every pattern size.
__device__ __forceinline__ bool fast_interior(int gy, int gx, int H, int W) {
  return gy >= 3 && gy <= H - 4 && gx >= 3 && gx <= W - 4;
}

}  // namespace
