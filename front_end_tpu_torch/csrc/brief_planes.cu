// Dense BRIEF bitplanes for sm_90a: for every pixel p of a box-blurred image
// and every pattern pair (a, b), bit = img[clamp(p + a)] < img[clamp(p + b)],
// packed 32 per uint32 word; out is (B, n_words, H, W).
//
// Replaces front_end_tpu/ops/pallas/brief_kernel.py::brief_bitplanes.
// See front_end_tpu_torch/ops/kernels/brief_planes.py for the design note.
//
// Block = 32 x 8 threads over a 32 x 32 pixel tile; each thread owns one
// column and 4 rows of it, 8 apart.  The tile plus a 23-pixel halo is
// staged in shared memory with edge-clamped reads (== the plain version's
// edge padding).  A compare is two 4-byte shared loads, which bound the
// kernel; the rest of a pair's cost is spread over its 4 compares: the
// pair is one 32-bit word of the launch's own parameters (the two offsets
// folded on the host into byte offsets in the shared tile), so a warp
// reads it once as a uniform value, adds it to its base address once, and
// loads the 8 values of its 4 rows with immediate offsets.  More rows a
// thread amortise the pair further but take more registers and leave
// fewer warps to hide the loads' latency: 8 rows were slower (PERF.md
// section 6).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 23;                  // max |pattern offset|
constexpr int TX = 32;                 // tile columns = lanes
constexpr int BY = 8;                  // thread rows
constexpr int RPT = 4;                 // rows per thread, BY apart
constexpr int TY = BY * RPT;           // tile rows
constexpr int NT = TX * BY;
constexpr int SW = TX + 2 * R, SH = TY + 2 * R;
constexpr int MAX_BITS = 512;

// Pair i as (off_b << 16) | (off_a & 0xffff), each offset (dy * SW + dx)
// * 4 in bytes of the shared tile (|offset| <= 4 * R * (SW + 1) fits 16
// bits).  Passed by value with the launch, so no copy precedes it on the
// stream; all threads of a warp read the same word at once, a
// constant-bank broadcast.
struct Pattern {
  int32_t pair[MAX_BITS];
};

// All ones where a < b, else 0 (false for NaN, as `<` is).  Masking a
// full word with the pair's bit ran faster than shifting a 0/1 compare
// into place (PERF.md section 6).
__device__ __forceinline__ uint32_t lt_mask(float a, float b) {
  return a < b ? ~0u : 0u;
}

__global__ void __launch_bounds__(NT)
brief_planes_kernel(const float* __restrict__ img, uint32_t* __restrict__ out,
                    int H, int W, int n_words,
                    const __grid_constant__ Pattern pat) {
  __shared__ float s[SH * SW];
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const float* im = img + (size_t)b * H * W;
  const int lane = threadIdx.x, ty = threadIdx.y;

  // stage by rows: a warp reads 32 consecutive pixels of a row (3 column
  // chunks, clamped once), a batch of rows with all its loads in flight
  {
    constexpr int CH = (SW + 31) / 32, ROWS = (SH + BY - 1) / BY;
    constexpr int BATCH = 5;
    int gx[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c)
      gx[c] = min(max(x0 - R + c * 32 + lane, 0), W - 1);
#pragma unroll
    for (int k0 = 0; k0 < ROWS; k0 += BATCH) {
      float v[BATCH][CH];
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        const int gy = min(max(y0 - R + ty + (k0 + k) * BY, 0), H - 1);
        const float* row = im + (size_t)gy * W;
#pragma unroll
        for (int c = 0; c < CH; ++c) v[k][c] = row[gx[c]];
      }
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        const int r = ty + (k0 + k) * BY;
#pragma unroll
        for (int c = 0; c < CH; ++c)
          if (k0 + k < ROWS && r < SH && c * 32 + lane < SW)
            s[r * SW + c * 32 + lane] = v[k][c];
      }
    }
  }
  __syncthreads();

  // the thread's first pixel, in bytes of the tile: a pair costs two
  // 32-bit additions, and its rows are immediate offsets
  const char* c0 =
      reinterpret_cast<const char*>(s + (R + ty) * SW + R + lane);
  const int x = x0 + lane;
  uint32_t* o = out + (size_t)b * n_words * H * W + x;
  for (int w = 0; w < n_words; ++w) {
    uint32_t acc[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) acc[r] = 0u;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int32_t pr = pat.pair[w * 32 + j];
      const float* pa = reinterpret_cast<const float*>(c0 + (int16_t)pr);
      const float* pb = reinterpret_cast<const float*>(c0 + (pr >> 16));
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        acc[r] |= lt_mask(pa[r * BY * SW], pb[r * BY * SW]) & (1u << j);
    }
    if (x < W) {
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int y = y0 + ty + r * BY;
        if (y < H) o[((size_t)w * H + y) * W] = acc[r];
      }
    }
  }
}

}  // namespace

// offsets: n_bits x [ax, ay, bx, by] int8, |offset| <= R (the wrapper checks).
extern "C" int brief_planes_launch(const void* img, void* out,
                                   const void* offsets, int B, int H, int W,
                                   int n_bits, void* stream) {
  if (n_bits <= 0 || n_bits % 32 != 0 || n_bits > MAX_BITS)
    return (int)cudaErrorInvalidValue;
  const int8_t* off = static_cast<const int8_t*>(offsets);
  Pattern pat = {};
  for (int i = 0; i < n_bits; ++i) {
    const int8_t* p = off + 4 * i;
    const int da = 4 * (p[1] * SW + p[0]), db = 4 * (p[3] * SW + p[2]);
    pat.pair[i] = (int32_t)(((uint32_t)db << 16) | ((uint32_t)da & 0xffffu));
  }
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
  const dim3 block(TX, BY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  brief_planes_kernel<<<grid, block, 0, s>>>(
      static_cast<const float*>(img), static_cast<uint32_t*>(out), H, W,
      n_bits / 32, pat);
  return (int)cudaGetLastError();
}
