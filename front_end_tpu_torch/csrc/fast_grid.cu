// Fused grid FAST detector for sm_90a: cv2-exact FAST margins, per-pixel
// cell threshold, tie-annihilating 3x3 NMS, per-cell 2x2 winner pooling and
// exact per-cell survivor counts, in one pass over the image.
//
// Replaces front_end_tpu/ops/pallas/fast_kernel.py::fast_detect_grid_pallas.
// Semantics are those of the XLA path (fast.detect_dense + the pooling of
// grid._detect_from_map): see front_end_tpu_torch/ops/kernels/fast_grid.py.
//
// Block = one 30 x (SH - 2) pixel tile of ONE cell, whose score window with
// the 1-pixel NMS halo is 32 x SH: a warp is a window row.  Shared memory
// holds the image tile with a 4-pixel halo (38 wide) and the thresholded
// pre-NMS scores.  The scores come from `gated_scores` (fast_segment.cuh):
// every pixel takes the 4-tap rejection bound, only the survivors,
// compacted into a list, take the segment test.  Each pixel's threshold is
// looked up in a 3 x 3 table of the tile's cell and its neighbours (the
// 1-pixel halo reaches no further), so no per-pixel division and no (H, W)
// threshold map exist.  Then one thread per pooled 2x2 block applies the
// NMS, pools and counts.  Only subtractions, min, max and compares touch
// the pixel values, so the result is bit-identical to the plain version in
// any evaluation order.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fast_segment.cuh"

namespace {

// The threshold of one lane's pixel in row ly of a tile's score window, +inf
// where the pixel takes no part: only pixels within one pixel of the cell
// are read by the NMS of the cell's pixels, and cv2 processes rows/cols
// [3, size - 4].  The lane's column fixes three candidates — the cell row
// above, the tile's own and the one below — and the row picks one.
struct GridThreshold {
  float above, own, below;   // +inf if the lane's column takes no part
  int y0, ry0, ch, H;        // the window's first row, in the image and cell
  __device__ __forceinline__ float operator()(int ly) const {
    const int ry = ry0 + ly, gy = y0 + ly;
    const float t = ry < 0 ? above : (ry >= ch ? below : own);
    return ry >= -1 && ry <= ch && gy >= 3 && gy <= H - 4 ? t : INFINITY;
  }
};

template <int N, int K, int SH>
__global__ void __launch_bounds__(8 * SH)
fast_grid_kernel(const float* __restrict__ img, const float* __restrict__ thr,
                 float* __restrict__ pooled, uint8_t* __restrict__ code,
                 int* __restrict__ counts, int H, int W, int Gr, int Gc,
                 int ch, int cw, int ph, int pw, float inv_cells,
                 float inv_gc) {
  constexpr int NT = 8 * SH;                 // a warp per 4 window rows
  constexpr int SW = SCORE_W, IW = TILE_W, IH = SH + 6;
  constexpr int TPX = (SW - 2) / 2, TPY = (SH - 2) / 2;   // pooled blocks
  static_assert(16 * TPY <= NT, "a thread per pooled block");
  __shared__ float s_img[IW * IH];
  __shared__ ScoreScratch<SH> ws;
  __shared__ float s_thr[9];

  // cellz = (b * Gr + gr) * Gc + gc; small integers, so a float multiply by
  // the reciprocal, taken at the half, divides exactly
  const int cellz = blockIdx.z;
  const int b = (int)((cellz + 0.5f) * inv_cells);
  const int row = (int)((cellz + 0.5f) * inv_gc);      // b * Gr + gr
  const int gr = row - b * Gr, gc = cellz - row * Gc;
  const int py0 = blockIdx.y * TPY, px0 = blockIdx.x * TPX;
  const int y0 = gr * ch + 2 * py0;               // tile's first pixel
  const int x0 = gc * cw + 2 * px0;
  const float* im = img + (size_t)b * H * W;
  const int tid = threadIdx.x;

  // 1. image tile, origin (y0 - 4, x0 - 4), edge-clamped reads; thresholds
  //    of the cell and its 8 neighbours (pixels beyond the last whole cell
  //    take the edge cell's)
  if (tid < 9) {
    const int r = min(max(gr + tid / 3 - 1, 0), Gr - 1);
    const int c = min(max(gc + tid % 3 - 1, 0), Gc - 1);
    s_thr[tid] = thr[((size_t)b * Gr + r) * Gc + c];
  }
  load_tile<IW, IH, NT>(im, s_img, y0 - 4, x0 - 4, H, W, tid);
  __syncthreads();

  // 2. thresholded scores of the window, origin (y0 - 1, x0 - 1); cv2's
  //    border (rows/cols [3, size - 4]) and everything off-image is 0
  {
    const int lane = tid & 31;
    const int rx = 2 * px0 - 1 + lane, gx = x0 - 1 + lane;
    const bool col_ok = rx >= -1 && rx <= cw && gx >= 3 && gx <= W - 4;
    const float* t3 = s_thr + (rx >= cw) - (rx < 0) + 1;
    const GridThreshold thr{col_ok ? t3[0] : INFINITY,
                            col_ok ? t3[3] : INFINITY,
                            col_ok ? t3[6] : INFINITY,
                            y0 - 1, 2 * py0 - 1, ch, H};
    gated_scores<N, K, SH, NT>(s_img, ws, tid, thr);
  }
  const float* s_sc = ws.score;

  // 3. NMS of this thread's 2x2 block, pooling, survivor count.  The 4
  //    pixels are neighbours of one another, so only the largest of them
  //    can survive, and a tie for the largest kills both: one NMS per block
  const int ty = tid / 16, tx = tid % 16;
  const int py = py0 + ty, px = px0 + tx;
  int alive = 0;
  if (ty < TPY && tx < TPX && py < ph && px < pw) {
    const float* s00 = s_sc + (1 + 2 * ty) * SW + 1 + 2 * tx;
    // cell-local row/col; the zero pad of an odd cell is not a pixel
    const bool row1 = 2 * py + 1 < ch, col1 = 2 * px + 1 < cw;
    int best = 0;
    float top = s00[0];
    if (col1 && s00[1] > top) top = s00[1], best = 1;
    if (row1 && s00[SW] > top) top = s00[SW], best = SW;
    if (row1 && col1 && s00[SW + 1] > top) top = s00[SW + 1], best = SW + 1;
    const float s = nms_survivor(s00 + best);
    alive = s > 0.f;
    float v[2][2];
    v[0][0] = best == 0 ? s : 0.f;
    v[0][1] = best == 1 ? s : 0.f;
    v[1][0] = best == SW ? s : 0.f;
    v[1][1] = best == SW + 1 ? s : 0.f;
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
  const int block_alive = __syncthreads_count(alive);
  if (tid == 0 && block_alive) atomicAdd(&counts[cellz], block_alive);
}

template <int SH>
int launch(int n, cudaStream_t s, const float* i, const float* t, float* p,
           uint8_t* c, int* k, int B, int H, int W, int Gr, int Gc, int ch,
           int cw) {
  constexpr int TPX = (SCORE_W - 2) / 2, TPY = (SH - 2) / 2;
  const int ph = (ch + 1) / 2, pw = (cw + 1) / 2;
  const dim3 grid((pw + TPX - 1) / TPX, (ph + TPY - 1) / TPY, B * Gr * Gc);
  constexpr int NT = 8 * SH;
  const float inv_cells = 1.f / (Gr * Gc), inv_gc = 1.f / Gc;
  if (n == 16) {
    fast_grid_kernel<16, 9, SH><<<grid, NT, 0, s>>>(
        i, t, p, c, k, H, W, Gr, Gc, ch, cw, ph, pw, inv_cells, inv_gc);
  } else if (n == 12) {
    fast_grid_kernel<12, 7, SH><<<grid, NT, 0, s>>>(
        i, t, p, c, k, H, W, Gr, Gc, ch, cw, ph, pw, inv_cells, inv_gc);
  } else if (n == 8) {
    fast_grid_kernel<8, 5, SH><<<grid, NT, 0, s>>>(
        i, t, p, c, k, H, W, Gr, Gc, ch, cw, ph, pw, inv_cells, inv_gc);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The height of a block's score window, 32 or 16 rows (a tile is 30 wide and
// two rows lower), follows from the size of the image: see choose_rows.
extern "C" int fast_grid_launch(const void* img, const void* thr,
                                void* pooled, void* code, void* counts, int B,
                                int H, int W, int Gr, int Gc, int ch, int cw,
                                int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* i = static_cast<const float*>(img);
  const float* t = static_cast<const float*>(thr);
  float* p = static_cast<float*>(pooled);
  uint8_t* c = static_cast<uint8_t*>(code);
  int* k = static_cast<int*>(counts);
  const int ph = (ch + 1) / 2, pw = (cw + 1) / 2;
  if (choose_rows((pw + 14) / 15 * ((ph + 14) / 15) * B * Gr * Gc) == 32)
    return launch<32>(n, s, i, t, p, c, k, B, H, W, Gr, Gc, ch, cw);
  return launch<16>(n, s, i, t, p, c, k, B, H, W, Gr, Gc, ch, cw);
}
