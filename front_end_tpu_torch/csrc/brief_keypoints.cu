// BRIEF evaluated at the keypoints for sm_90a: for keypoint pixel
// p = clamp(round(xy)) and every pattern pair (a, b),
// bit = img[clamp(p + a)] < img[clamp(p + b)], packed 32 per uint32 word;
// out is (B, N, n_words).  The same bits as gathering the dense planes of
// brief_planes.cu at p, the image border included.
//
// Replaces front_end_tpu/ops/pallas/brief_kernel.py::describe_dense_pallas
// and describe_pair_pallas (brief_bitplanes + _gather_words) in one launch.
// See front_end_tpu_torch/ops/kernels/brief_keypoints.py for the design
// note.
//
// One warp per keypoint.  The 2 n_bits sample points come as a table sorted
// by (dy, dx): entry = dx | dy << 8 | (2 bit + side) << 16.  A gather costs
// the load unit one pass per distinct 128-byte line a warp instruction
// touches, so lanes walk the table in sorted order (32 neighbouring samples
// lie on a few image rows) and drop each value into shared memory at its
// sample index; then lane j compares the two samples of bit j of each word
// and __ballot_sync delivers the packed word.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_WORDS = 16;          // 512 bits
constexpr int WARPS = 4;               // keypoints per block
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(WARPS * 32)
brief_keypoints_kernel(const float* __restrict__ img,
                       const float2* __restrict__ xy,
                       const uint32_t* __restrict__ table,
                       uint32_t* __restrict__ out, int total, int N, int H,
                       int W, int n_words) {
  __shared__ __align__(8) float s_val[WARPS][64 * MAX_WORDS];
  const int kp = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (kp >= total) return;             // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  float* val = s_val[threadIdx.x >> 5];
  const float2 p = xy[kp];
  // rintf rounds half to even, as torch.round does; the clamp in float
  // equals the integer clamp for every finite coordinate, puts +-inf on the
  // edge and NaN on pixel 0 (fmaxf returns its other operand)
  const int px = (int)fminf(fmaxf(rintf(p.x), 0.f), (float)(W - 1));
  const int py = (int)fminf(fmaxf(rintf(p.y), 0.f), (float)(H - 1));
  const float* im = img + (size_t)(kp / N) * H * W;

#pragma unroll 8
  for (int k = lane; k < 64 * n_words; k += 32) {
    const uint32_t e = __ldg(table + k);
    const int x = min(max(px + (int)(int8_t)(e & 0xffu), 0), W - 1);
    const int y = min(max(py + (int)(int8_t)((e >> 8) & 0xffu), 0), H - 1);
    val[(e >> 16) & (64 * MAX_WORDS - 1)] = __ldg(im + (size_t)y * W + x);
  }
  __syncwarp();
  uint32_t mine = 0;
  for (int w = 0; w < n_words; ++w) {  // n_words is uniform over the grid
    const float2 v = reinterpret_cast<const float2*>(val)[w * 32 + lane];
    const uint32_t word = __ballot_sync(FULL, v.x < v.y);
    if (lane == w) mine = word;
  }
  if (lane < n_words) out[(size_t)kp * n_words + lane] = mine;
}

}  // namespace

extern "C" int brief_keypoints_launch(const void* img, const void* xy,
                                      const void* table, void* out, int B,
                                      int N, int H, int W, int n_bits,
                                      void* stream) {
  if (n_bits % 32 != 0 || n_bits > 32 * MAX_WORDS || n_bits <= 0)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * N;
  if (total <= 0 || total > (1ll << 26)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((total + WARPS - 1) / WARPS));
  brief_keypoints_kernel<<<grid, WARPS * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float2*>(xy),
      static_cast<const uint32_t*>(table), static_cast<uint32_t*>(out),
      (int)total, N, H, W, n_bits / 32);
  return (int)cudaGetLastError();
}
