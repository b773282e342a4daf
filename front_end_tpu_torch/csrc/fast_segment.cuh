// The FAST segment test shared by the three FAST kernels (fast_grid.cu,
// fast_detect.cu, fast_margins.cu): circle offsets, the arc margin, cv2's
// quick-rejection gate, the per-pixel (detect, score) margins, the exact
// early-rejection bounds, the edge-clamped staging of an image tile in
// shared memory, and `gated_scores`, the two-phase evaluation of the
// thresholded scores of a tile that the detect and grid kernels share.  One
// copy, so a change of a tie rule reaches every kernel (the JAX package
// shares `_arc_margin` / `_quick_margin` / `_nms_survivors` for the same
// reason).
//
// Only min, max, compares and one subtraction per margin touch the pixel
// values, and rounding is monotone, so each result equals the plain
// version in `ops/fast.py`, which subtracts first, in any evaluation order
// (a zero may come out with the other sign; it compares equal).  Compile
// without fast-math.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace {

// Circle offsets (dx, dy), y down, OpenCV makeOffsets order.
template <int N>
__host__ __device__ constexpr int circle_dx(int i) {
  constexpr int c16[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2,
                           -1};
  constexpr int c12[12] = {0, 1, 2, 2, 2, 1, 0, -1, -2, -2, -2, -1};
  constexpr int c8[8] = {0, 1, 1, 1, 0, -1, -1, -1};
  return N == 16 ? c16[i % 16] : (N == 12 ? c12[i % 12] : c8[i % 8]);
}
template <int N>
__host__ __device__ constexpr int circle_dy(int i) {
  constexpr int c16[16] = {3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1, 0, 1, 2,
                           3};
  constexpr int c12[12] = {2, 2, 1, 0, -1, -2, -2, -2, -1, 0, 1, 2};
  constexpr int c8[8] = {1, 1, 0, -1, -1, -1, 0, 1};
  return N == 16 ? c16[i % 16] : (N == 12 ? c12[i % 12] : c8[i % 8]);
}

// Offset of circle point I from its centre in a tile whose rows are STRIDE
// floats apart: a compile-time constant, so a tap is one load with an
// immediate offset.
template <int N, int STRIDE, int I>
struct Tap {
  static constexpr int off = circle_dy<N>(I) * STRIDE + circle_dx<N>(I);
};

// The segment test works on the ring's pixel values c_i themselves, not on
// the differences to the centre p: rounding is monotone, so
//   min_i fl(c_i - p) = fl(min_i c_i - p),
//   min_i fl(p - c_i) = fl(p - max_i c_i)
// and likewise for the outer max over arcs, bit for bit.  The bright margin
// is (max over arcs of the min over the arc) - p, the dark margin
// p - (min over arcs of the max over the arc): one subtraction per class
// instead of one per ring pixel and a negation.
template <bool MIN>
__device__ __forceinline__ float pick(float a, float b) {
  return MIN ? fminf(a, b) : fmaxf(a, b);
}

// c[I] = the ring pixel I of the pixel at `px` (tile rows STRIDE apart).
template <int N, int STRIDE, int... I>
__device__ __forceinline__ void load_ring(const float* px, float (&c)[N],
                                          std::integer_sequence<int, I...>) {
  ((c[I] = px[Tap<N, STRIDE, I>::off]), ...);
}
template <int N, int STRIDE>
__device__ __forceinline__ void load_ring(const float* px, float (&c)[N]) {
  load_ring<N, STRIDE>(px, c, std::make_integer_sequence<int, N>{});
}

// BRIGHT: max over circular starts s of min over the K-window of
// w[(s + j) % N]; dark: min over starts of the max over the window.  K odd.
//
// The network rests on one identity of min and max (they only select
// values, so it is bit-exact, +-inf included):
//   max(min(C, x), min(C, y)) = min(C, max(x, y)).
// The windows that start at A .. A + M - 1 all hold the core
// [A + M - 1, A + K), so their best is min(core, best of what is left of
// each), and what is left has the same shape again: for start s it is
// [s, A + M - 1) u [A + K, s + K).  Halving the group of starts, each half
// takes out its own core, [A + H - 1, A + M - 1) or [A + K, A + K + H),
// and the halves of two starts leave one value each, w[A] and w[A + K]
// (`arc_group`).  The ring is cut into groups of M starts, M the largest
// power of 2 <= K that divides N (`arc_group_size`).  Every core begins at
// an odd index and has an even length, so all of them are taken from the
// N / 2 pair extremes of w[2j + 1], w[2j + 2].  Per class: 41 min/max for
// 9_16, 29 for 7_12, 17 for 5_8; `chip_smoke.py::arc_ops` counts the same
// recursion.
template <int N, int K>
__host__ __device__ constexpr int arc_group_size() {
  int m = 1;
  while (2 * m <= K && N % (2 * m) == 0) m *= 2;
  return m;
}

// The extreme of one kind over w[O .. O + L) (indices mod N; O odd, L
// even) from the pair extremes p[j] of w[2j + 1], w[2j + 2].
template <int N, bool MIN, int O, int L>
__device__ __forceinline__ float span(const float (&p)[N / 2]) {
  constexpr int J = (O - 1) / 2;
  float r = p[J % (N / 2)];
#pragma unroll
  for (int i = 1; i < L / 2; ++i) r = pick<MIN>(r, p[(J + i) % (N / 2)]);
  return r;
}

// Best over the starts s in [A, A + M) of the extreme over
// [s, A + M - 1) u [A + K, s + K).
template <int N, int K, bool BRIGHT, int A, int M>
__device__ __forceinline__ float arc_group(const float (&w)[N],
                                           const float (&p)[N / 2]) {
  if constexpr (M == 2) {
    return pick<!BRIGHT>(w[A % N], w[(A + K) % N]);
  } else {
    constexpr int H = M / 2;
    const float lo = pick<BRIGHT>(span<N, BRIGHT, A + H - 1, H>(p),
                                  arc_group<N, K, BRIGHT, A, H>(w, p));
    const float hi = pick<BRIGHT>(span<N, BRIGHT, A + K, H>(p),
                                  arc_group<N, K, BRIGHT, A + H, H>(w, p));
    return pick<!BRIGHT>(lo, hi);
  }
}

// Best over the groups 0 .. G of M starts, each with its core.
template <int N, int K, bool BRIGHT, int G>
__device__ __forceinline__ float arc_groups(const float (&w)[N],
                                            const float (&p)[N / 2]) {
  constexpr int M = arc_group_size<N, K>(), A = G * M;
  const float g = pick<BRIGHT>(span<N, BRIGHT, A + M - 1, K - M + 1>(p),
                               arc_group<N, K, BRIGHT, A, M>(w, p));
  if constexpr (G == 0) {
    return g;
  } else {
    return pick<!BRIGHT>(arc_groups<N, K, BRIGHT, G - 1>(w, p), g);
  }
}

template <int N, int K, bool BRIGHT>
__device__ __forceinline__ float arc_extreme(const float (&w)[N]) {
  static_assert(N % 2 == 0 && K % 2 == 1 && 2 < K && K < N,
                "odd arcs of an even ring");
  float p[N / 2];
#pragma unroll
  for (int j = 0; j < N / 2; ++j)
    p[j] = pick<BRIGHT>(w[2 * j + 1], w[(2 * j + 2) % N]);
  return arc_groups<N, K, BRIGHT, N / arc_group_size<N, K>() - 1>(w, p);
}

// cv2's 8 quick-test pairs (k, (k + 8) mod N).  BRIGHT: min over the pairs
// of the pair max; dark: max over the pairs of the pair min.
template <int N, bool BRIGHT>
__device__ __forceinline__ float quick_extreme(const float (&c)[N]) {
  float m = pick<!BRIGHT>(c[0], c[8 % N]);
#pragma unroll
  for (int k = 1; k < 8; ++k)
    m = pick<BRIGHT>(m, pick<!BRIGHT>(c[k % N], c[(k + 8) % N]));
  return m;
}

// The arc margin of ONE brightness class of the pixel at `px`.
template <int N, int K, int STRIDE, bool BRIGHT>
__device__ __forceinline__ float class_margin(const float* px) {
  float c[N];
  load_ring<N, STRIDE>(px, c);
  const float e = arc_extreme<N, K, BRIGHT>(c);
  return BRIGHT ? e - px[0] : px[0] - e;
}

// The same with the class given at run time, sign = +1 (bright) or -1
// (dark), so that lanes of both classes share one code path: the dark
// margin p - min_arcs max_arc c is (max_arcs min_arc of -c) + p, and a
// product with +-1 is exact.  Costs N + 1 multiplications more.
template <int N, int K, int STRIDE>
__device__ __forceinline__ float class_margin(const float* px, float sign) {
  float c[N];
  load_ring<N, STRIDE>(px, c);
#pragma unroll
  for (int i = 0; i < N; ++i) c[i] *= sign;
  return arc_extreme<N, K, true>(c) - px[0] * sign;
}

// (detect, score) margins of the pixel at `px`.
template <int N, int K, int STRIDE>
__device__ __forceinline__ void margins(const float* px, float& detect,
                                        float& score) {
  const float p = px[0];
  float c[N];
  load_ring<N, STRIDE>(px, c);
  float qd = 0.f, qb = 0.f;
  if (N != 16) {
    qd = p - quick_extreme<N, false>(c);
    qb = quick_extreme<N, true>(c) - p;
  }
  const float rd = p - arc_extreme<N, K, false>(c);
  const float rb = arc_extreme<N, K, true>(c) - p;
  score = fmaxf(rd, rb);
  detect = N == 16 ? score : fmaxf(fminf(rd, qd), fminf(rb, qb));
}

// Upper bounds of the two classes' contributions to `detect`:
// detect <= max(bd, bb), and the dark (bright) class alone can lift
// detect above a threshold t only if bd > t (bb > t).
//   16 points: every arc of 9 holds one point of each antipodal pair, so
//     the bright margin is at most min_k max(c_k, c_{k+8}) - p; four of the
//     points (0, 4, 8, 12: the compass points) give the weaker
//     min(max(c0, c8), max(c4, c12)) - p from 4 taps, and the dark class
//     p - max(min(c0, c8), min(c4, c12)).
//   12 and 8 points: detect = max(min(rd, qd), min(rb, qb)) <= max(qd, qb)
//     with cv2's own quick margins.
// Exact in floats: min and max only select values, rounding is monotone.
template <int N, int STRIDE>
__device__ __forceinline__ void reject_bounds(const float* px, float& bd,
                                              float& bb) {
  const float p = px[0];
  if constexpr (N == 16) {
    const float c0 = px[Tap<16, STRIDE, 0>::off];
    const float c4 = px[Tap<16, STRIDE, 4>::off];
    const float c8 = px[Tap<16, STRIDE, 8>::off];
    const float c12 = px[Tap<16, STRIDE, 12>::off];
    bd = p - fmaxf(fminf(c0, c8), fminf(c4, c12));
    bb = fminf(fmaxf(c0, c8), fmaxf(c4, c12)) - p;
  } else {
    float c[N];
    load_ring<N, STRIDE>(px, c);
    bd = p - quick_extreme<N, false>(c);
    bb = quick_extreme<N, true>(c) - p;
  }
}

// Stage the IW x IH image tile (32 <= IW <= 64) whose first pixel is
// (y0, x0) — which may lie off the image — with edge-clamped reads, by
// rows: a warp reads 32 consecutive pixels of one row (its clamped column
// is computed once, its row once per pass), then the IW - 32 columns that
// are left are spread over the threads.  The caller synchronizes.
template <int IW, int IH, int NT>
__device__ __forceinline__ void load_tile(const float* __restrict__ im,
                                          float* tile, int y0, int x0, int H,
                                          int W, int tid) {
  static_assert(IW >= 32 && IW <= 64 && NT % 32 == 0, "one warp per row");
  constexpr int NW = NT / 32, XW = IW - 32;
  const int lane = tid & 31, warp = tid >> 5;
  constexpr int PASSES = (IH + NW - 1) / NW;
  constexpr int XPASSES = (XW * IH + NT - 1) / NT;
  const int gx = min(max(x0 + lane, 0), W - 1);
  // every load of the thread is in flight before the first store waits for one
  float v[PASSES], x[XPASSES];
#pragma unroll
  for (int k = 0; k < PASSES; ++k) {
    const int gy = min(max(y0 + warp + k * NW, 0), H - 1);
    v[k] = im[(size_t)gy * W + gx];
  }
#pragma unroll
  for (int k = 0; k < XPASSES; ++k) {
    const int i = min(tid + k * NT, XW * IH - 1);
    const int gy = min(max(y0 + i / XW, 0), H - 1);
    x[k] = im[(size_t)gy * W + min(max(x0 + 32 + i % XW, 0), W - 1)];
  }
#pragma unroll
  for (int k = 0; k < PASSES; ++k) {
    const int r = warp + k * NW;
    if (r < IH) tile[r * IW + lane] = v[k];
  }
#pragma unroll
  for (int k = 0; k < XPASSES; ++k) {
    const int i = tid + k * NT;
    if (i < XW * IH) tile[(i / XW) * IW + 32 + i % XW] = x[k];
  }
}

constexpr int SCORE_W = 32;            // width of a score window
constexpr int TILE_W = SCORE_W + 6;    // width of its staged image tile

// Shared memory of `gated_scores` for a window of SH rows.
template <int SH>
struct ScoreScratch {
  float score[SCORE_W * SH];           // the result
  float dark[SCORE_W * SH];            // dark margins awaiting the bright ones
  uint16_t list[2 * SCORE_W * SH];     // per warp: dark entries, bright entries
};

// The thresholded scores s = detect > t ? score : 0 of the 32 x SH pixels
// whose image tile 38 x (SH + 6), 3-pixel halo included, is staged in
// `s_img`, written to `ws.score` (rows 32 apart).  `thr(ly)` gives the
// threshold of the calling lane's pixel in window row ly, +inf where the
// pixel takes no part (cv2's border and everything the caller will not
// read) and scores 0.  The window is 32 wide so that a warp is a row: a
// lane's column, and everything `thr` derives from it, is fixed, and a
// row's part is uniform over the warp.
//
// Most pixels are no corners, and the segment test is ~60 loads and
// operations per class, so each warp does the work of its rows in two
// phases:
//   A. every pixel: the cheap bounds of `reject_bounds`.  A pixel with
//      both bounds <= t has detect <= t and scores exactly 0.  The others
//      are appended to the warp's lists in shared memory (warp ballot and
//      prefix popcount; no atomics, a list's running length is
//      warp-uniform; the order does not matter, every result lands at its
//      own index) and leave their threshold in `ws.score`.
//   B. the warp walks its lists with all lanes.  For the 16-point circle a
//      class whose bound is <= t has its arc margin <= t, so it cannot
//      lift `detect` above t, and where the other class does, score =
//      max(rd, rb) is that class's margin: there is a list per class, and
//      an entry evaluates that class only.  A pixel on both lists parks its
//      dark margin in `ws.dark`, and its bright entry, always handled
//      later, takes the max.  Full passes of 32 entries of one class run
//      that class's own code; what is left of the two lists shares one
//      pass, with the class as a run-time sign, if it fits into one (at a
//      detector's usual thresholds a warp's 128 pixels leave fewer than 32
//      entries, and this pass is all there is).  For 12 and 8 points the
//      score needs both classes whenever the gate passes, so there is one
//      list and the full `margins`.
// Holds for any threshold (negative ones and a per-pixel t included): with
// t = -inf every pixel is a candidate of both classes and the lists hold
// the whole window twice.  The tile must be staged before the call (one
// __syncthreads() by the caller); the scores are complete, and the block
// synchronized, on return.  NT threads; SH rows, a multiple of the NT / 32
// warps.
template <int N, int K, int SH, int NT, class Thr>
__device__ __forceinline__ void gated_scores(const float* s_img,
                                             ScoreScratch<SH>& ws, int tid,
                                             const Thr& thr) {
  constexpr int SW = SCORE_W, IW = TILE_W;
  constexpr int NW = NT / 32, ROWS = SH / NW, CAP = ROWS * SW;
  constexpr unsigned FULL = 0xffffffffu;
  static_assert(NT % 32 == 0 && SH % NW == 0, "whole rows per warp");
  static_assert(2 * SW * SH <= 65536, "an entry is 16 bits");
  const int lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  uint16_t* darks = ws.list + warp * 2 * CAP;
  uint16_t* brights = darks + CAP;
  int nd = 0, nb = 0;

#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int ly = warp + k * NW;
    const int i = ly * SW + lane;
    float bd, bb;
    reject_bounds<N, IW>(s_img + (ly + 3) * IW + lane + 3, bd, bb);
    const float t = thr(ly);
    const bool fd = bd > t, fb = bb > t;
    ws.score[i] = (fd || fb) ? t : 0.f;
    if constexpr (N == 16) {
      // entry = 2 * pixel + (the pixel is on both lists)
      const int both = fd && fb;
      const unsigned md = __ballot_sync(FULL, fd);
      const unsigned mb = __ballot_sync(FULL, fb);
      if (fd) darks[nd + __popc(md & below)] = (uint16_t)(2 * i + both);
      if (fb) brights[nb + __popc(mb & below)] = (uint16_t)(2 * i + both);
      nd += __popc(md);
      nb += __popc(mb);
    } else {
      const unsigned m = __ballot_sync(FULL, fd || fb);
      if (fd || fb) darks[nd + __popc(m & below)] = (uint16_t)i;
      nd += __popc(m);
    }
  }
  __syncwarp();

  const auto pixel = [&](int i) {
    return s_img + (i / SW + 3) * IW + i % SW + 3;
  };
  const auto gate = [&](int i, float r) {
    ws.score[i] = r > ws.score[i] ? r : 0.f;
  };
  if constexpr (N == 16) {
    const auto dark_entry = [&](int v) {
      const float r = class_margin<N, K, IW, false>(pixel(v >> 1));
      if (v & 1) {
        ws.dark[v >> 1] = r;
      } else {
        gate(v >> 1, r);
      }
    };
    const auto bright_entry = [&](int v) {
      float r = class_margin<N, K, IW, true>(pixel(v >> 1));
      if (v & 1) r = fmaxf(r, ws.dark[v >> 1]);
      gate(v >> 1, r);
    };
    // full dark passes; the dark tail and the first nb % 32 bright entries;
    // the other bright entries, in full passes
    const int full_d = nd & ~31, tail_d = nd & 31, tail_b = nb & 31;
    for (int e = lane; e < full_d; e += 32) dark_entry(darks[e]);
    if (tail_d + tail_b <= 32) {
      const bool is_d = lane < tail_d;
      const bool is_b = !is_d && lane < tail_d + tail_b;
      int v = 0;
      float r = 0.f;
      if (is_d || is_b) {
        v = is_d ? darks[full_d + lane] : brights[lane - tail_d];
        r = class_margin<N, K, IW>(pixel(v >> 1), is_b ? 1.f : -1.f);
      }
      if (is_d && (v & 1)) ws.dark[v >> 1] = r;
      __syncwarp();
      if (is_b && (v & 1)) r = fmaxf(r, ws.dark[v >> 1]);
      if (is_b || (is_d && !(v & 1))) gate(v >> 1, r);
    } else {
      if (lane < tail_d) dark_entry(darks[full_d + lane]);
      __syncwarp();
      if (lane < tail_b) bright_entry(brights[lane]);
    }
    if (nb >= 32) {
      __syncwarp();
      for (int e = tail_b + lane; e < nb; e += 32) bright_entry(brights[e]);
    }
  } else {
    for (int e = lane; e < nd; e += 32) {
      const int i = darks[e];
      float det, sc;
      margins<N, K, IW>(pixel(i), det, sc);
      ws.score[i] = det > ws.score[i] ? sc : 0.f;
    }
  }
  __syncthreads();
}

// Tie-annihilating 3x3 NMS of the score at `s` of a score window: it
// survives iff strictly greater than all 8 neighbours.  A zero score stays
// zero whatever its neighbours are, and most scores are zero.
__device__ __forceinline__ float nms_survivor(const float* s) {
  constexpr int SW = SCORE_W;
  const float s0 = s[0];
  if (s0 == 0.f) return 0.f;
  float nb = s[-SW - 1];
  nb = fmaxf(nb, s[-SW]);
  nb = fmaxf(nb, s[-SW + 1]);
  nb = fmaxf(nb, s[-1]);
  nb = fmaxf(nb, s[1]);
  nb = fmaxf(nb, s[SW - 1]);
  nb = fmaxf(nb, s[SW]);
  nb = fmaxf(nb, s[SW + 1]);
  return s0 > nb ? s0 : 0.f;
}

// The height of a block's score window, 32 or 16 rows, for an image that
// windows of 32 rows cut into `blocks32` blocks.  A block's phases run one
// after another, so a card with fewer than 1.5 such blocks per SM sits
// half idle: then the windows are halved (measured on an H100: 16 rows win
// at 218 x 718, 192 blocks of 32 rows on 132 SMs, and lose from 261 x 862,
// 261 blocks, upwards, where twice the blocks cost more to dispatch).
inline int choose_rows(int blocks32) {
  static const int sms = [] {      // asked once; the cards of one host are alike
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    return n;
  }();
  return 2 * blocks32 < 3 * sms ? 16 : 32;
}

}  // namespace
