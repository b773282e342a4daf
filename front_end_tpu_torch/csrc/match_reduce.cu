// Streaming masked-Hamming match reductions for sm_90a, without the
// (Nq, Nt) distance matrix.
//
// Replaces front_end_tpu/ops/pallas/match_kernel.py::match_reduce_pallas.
// See front_end_tpu_torch/ops/kernels/match_reduce.py for the design note.
//
// Per query row: d1 = min, i1 = first-index argmin, d2 = min over columns
// other than i1, capped at BIG.  Per train column: min and first-index arg.
//
// Grid = train splits x query tiles of 128.  A block stages its split's
// train columns in shared memory, every warp computes 32 x 8 tiles of
// distances on the tensor cores (popc(a & ~b) + popc(~a & b) by
// mma.m16n8k256.b1), and everything is reduced as 32-bit keys (distance code << 22 | index): rows in registers,
// columns through a warp butterfly and one shared atomicMin.  A block
// writes a partial per row and split and per column and tile; `finalize`
// merges them.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float BIG = 1e9f;
constexpr int WARPS = 4;
constexpr int MQ = 2;                      // 16-row tiles per warp
constexpr int QPB = WARPS * MQ * 16;       // queries per block (128)
constexpr int CH = 256;                    // train columns staged per pass
constexpr unsigned FULL = 0xffffffffu;
constexpr int IDX_BITS = 22;
constexpr uint32_t IDX_MASK = (1u << IDX_BITS) - 1;
constexpr uint32_t GATED = ~IDX_MASK;      // distance code 1023: a gated pair

// The xy of an invalid or missing point is NaN, which fails every compare;
// with no gate (MODE 0) x holds 0 for a valid point instead.
template <int MODE>
__device__ __forceinline__ bool gate(float2 q, float2 t, float p1, float p2,
                                     float p3) {
  if (MODE == 0) return q.x + t.x == 0.f;
  const float dy = fabsf(q.y - t.y);
  if (MODE == 1) {                         // stereo: epi + disparity window
    const float d = q.x - t.x;
    return dy <= p1 && d >= p2 && d <= p3;
  }
  if (MODE == 2) return dy <= p1;          // epi
  return fabsf(q.x - t.x) <= p1 && dy <= p1;   // roi
}

template <int MODE>
__device__ __forceinline__ float2 gate_xy(bool valid, float2 xy) {
  const float nan = __int_as_float(0x7fc00000);
  if (!valid) return make_float2(nan, nan);
  return MODE == 0 ? make_float2(0.f, 0.f) : xy;
}

// D += popc(A & B) over 256 bits: A 16 rows, B 8 columns.  Thread
// (g = lane / 4, tig = lane % 4) holds of A the words tig and tig + 4 of
// rows g and g + 8, of B the words tig and tig + 4 of column g, and of D
// the entries (g, 2 tig), (g, 2 tig + 1), (g + 8, 2 tig), (g + 8, 2 tig + 1).
__device__ __forceinline__ void mma_and_popc(int (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (k1, k2) = the two smallest keys seen; keys of real pairs are distinct.
__device__ __forceinline__ void push_key(uint32_t& k1, uint32_t& k2,
                                         uint32_t a1, uint32_t a2) {
  k2 = min(min(k2, a2), max(k1, a1));
  k1 = min(k1, a1);
}

template <int NW, int MODE>
__global__ void __launch_bounds__(WARPS * 32, 4)
match_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ t,
             const float2* __restrict__ xyq, const float2* __restrict__ xyt,
             const uint8_t* __restrict__ vq, const uint8_t* __restrict__ vt,
             int Nq, int Nt, int split_cols, float p1, float p2, float p3,
             uint2* __restrict__ rowpart, uint32_t* __restrict__ colpart) {
  constexpr int KS = (NW + 7) / 8;         // 256-bit steps of the product
  constexpr int ROWS = 2 * MQ;             // rows a thread holds
  __shared__ __align__(16) uint32_t s_w[CH * NW];
  __shared__ __align__(16) float2 s_xy[CH];
  __shared__ __align__(8) uint32_t s_idx[CH];  // column index
  __shared__ uint32_t s_col[CH];               // the block's column minima

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int qbase = blockIdx.y * QPB + (threadIdx.x >> 5) * (MQ * 16);

  // this thread's rows: r = m * 2 + h is row qbase + m * 16 + h * 8 + g.
  // Hamming = popc(a & ~b) + popc(~a & b): two products into one
  // accumulator, so the rows are held as fragments of a and ~a.
  uint32_t a[MQ][KS][4], na[MQ][KS][4];
  uint32_t rowid[ROWS], k1[ROWS], k2[ROWS];
  float2 qxy[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int qi = qbase + (r >> 1) * 16 + (r & 1) * 8 + g;
    const bool in = qi < Nq;
    rowid[r] = in ? (uint32_t)qi : IDX_MASK;
    qxy[r] = gate_xy<MODE>(in && vq[qi],
                           in ? xyq[qi] : make_float2(0.f, 0.f));
    k1[r] = k2[r] = FULL;
    const uint32_t* row = q + (size_t)qi * NW;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const bool hi = NW >= 8;             // NW == 4: the upper words are 0
      const uint32_t w0 = in ? row[s * 8 + tig] : 0u;
      const uint32_t w1 = (in && hi) ? row[s * 8 + tig + 4] : 0u;
      a[r >> 1][s][r & 1] = w0;
      a[r >> 1][s][2 + (r & 1)] = w1;
      na[r >> 1][s][r & 1] = in ? ~w0 : 0u;
      na[r >> 1][s][2 + (r & 1)] = (in && hi) ? ~w1 : 0u;
    }
  }

  const int cbeg = blockIdx.x * split_cols;
  const int cend = min(Nt, cbeg + split_cols);
  for (int c0 = cbeg; c0 < cend; c0 += CH) {
    const int cn = min(CH, cend - c0);
    const int cn8 = (cn + 7) & ~7;         // whole 8-column tiles, padded
    for (int i = threadIdx.x; i < cn8; i += WARPS * 32) {
      const int c = c0 + i;
      const bool in = i < cn;
      const uint4* src = reinterpret_cast<const uint4*>(t + (size_t)c * NW);
#pragma unroll
      for (int w = 0; w < NW / 4; ++w)
        reinterpret_cast<uint4*>(s_w)[i * (NW / 4) + w] =
            in ? src[w] : make_uint4(0, 0, 0, 0);
      s_xy[i] = gate_xy<MODE>(in && vt[c],
                              in ? xyt[c] : make_float2(0.f, 0.f));
      s_idx[i] = in ? (uint32_t)c : IDX_MASK;   // padding: the all-ones key
      s_col[i] = FULL;
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < cn8; j += 8) {
      // ham[m][h * 2 + e]: row m * 2 + h against column j + 2 tig + e
      int ham[MQ][4];
      const int ca = j + 2 * tig;
#pragma unroll
      for (int m = 0; m < MQ; ++m)
        ham[m][0] = ham[m][1] = ham[m][2] = ham[m][3] = 0;
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        const uint32_t* col = s_w + (j + g) * NW + s * 8 + tig;
        const uint32_t b0 = col[0];
        const uint32_t b1 = NW >= 8 ? col[4] : 0u;
        const uint32_t nb1 = NW >= 8 ? ~b1 : 0u;
#pragma unroll
        for (int m = 0; m < MQ; ++m) {
          mma_and_popc(ham[m], a[m][s], ~b0, nb1);
          mma_and_popc(ham[m], na[m][s], b0, b1);
        }
      }
      const float4 txy = *reinterpret_cast<const float4*>(s_xy + ca);
      const uint2 idx = *reinterpret_cast<const uint2*>(s_idx + ca);
      uint32_t cm[2] = {FULL, FULL};
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float2 tp = e ? make_float2(txy.z, txy.w)
                              : make_float2(txy.x, txy.y);
          const bool ok = gate<MODE>(qxy[r], tp, p1, p2, p3);
          const uint32_t code =
              (ok ? (uint32_t)ham[r >> 1][(r & 1) * 2 + e]
                  : GATED >> IDX_BITS) << IDX_BITS;
          push_key(k1[r], k2[r], code | (e ? idx.y : idx.x), FULL);
          cm[e] = min(cm[e], code | rowid[r]);
        }
      }
      // the 8 groups of the warp hold 8 x ROWS rows of the same columns
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        cm[0] = min(cm[0], __shfl_xor_sync(FULL, cm[0], off));
        cm[1] = min(cm[1], __shfl_xor_sync(FULL, cm[1], off));
      }
      if (g == 0) {
        atomicMin(&s_col[ca], cm[0]);
        atomicMin(&s_col[ca + 1], cm[1]);
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < cn; i += WARPS * 32)
      colpart[(size_t)blockIdx.y * Nt + c0 + i] = s_col[i];
    // the next pass's staging starts after every warp has passed the
    // barrier above, and entry i of s_col is read and rewritten by one thread
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const uint32_t o1 = __shfl_xor_sync(FULL, k1[r], off);
      const uint32_t o2 = __shfl_xor_sync(FULL, k2[r], off);
      push_key(k1[r], k2[r], o1, o2);
    }
    if (tig == 0 && rowid[r] != IDX_MASK)
      rowpart[(size_t)blockIdx.x * Nq + rowid[r]] = make_uint2(k1[r], k2[r]);
  }
}

__device__ __forceinline__ float key_distance(uint32_t key) {
  const uint32_t code = key >> IDX_BITS;
  return code == (GATED >> IDX_BITS) ? BIG : (float)code;
}

// One warp per row merges the splits' (k1, k2); one warp per column takes
// the min over the query tiles.
__global__ void finalize(const uint2* __restrict__ rowpart,
                         const uint32_t* __restrict__ colpart, int Nq, int Nt,
                         int n_splits, int n_tiles, float* __restrict__ d1,
                         float* __restrict__ d2, int* __restrict__ i1,
                         float* __restrict__ cmin, int* __restrict__ carg) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  // launched while match_kernel still runs: wait until it has finished and
  // its partials are visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (i < Nq) {
    uint32_t k1 = FULL, k2 = FULL;
    for (int s = lane; s < n_splits; s += 32) {
      const uint2 p = rowpart[(size_t)s * Nq + i];
      push_key(k1, k2, p.x, p.y);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const uint32_t o1 = __shfl_xor_sync(FULL, k1, off);
      const uint32_t o2 = __shfl_xor_sync(FULL, k2, off);
      push_key(k1, k2, o1, o2);
    }
    if (lane == 0) {
      d1[i] = key_distance(k1);
      d2[i] = key_distance(k2);
      i1[i] = (int)(k1 & IDX_MASK);
    }
  } else if (i - Nq < Nt) {
    const int c = i - Nq;
    uint32_t k = FULL;
    for (int s = lane; s < n_tiles; s += 32)
      k = min(k, colpart[(size_t)s * Nt + c]);
    k = __reduce_min_sync(FULL, k);
    if (lane == 0) {
      cmin[c] = key_distance(k);
      carg[c] = (int)(k & IDX_MASK);
    }
  }
}

}  // namespace

// rowpart holds n_splits x Nq
// uint2, colpart n_tiles x Nt uint32, n_tiles = ceil(Nq / 128) and
// n_splits = ceil(Nt / split_cols); split_cols is a multiple of 8.
extern "C" int match_reduce_launch(
    const void* q, const void* t, const void* xyq, const void* xyt,
    const void* vq, const void* vt, int Nq, int Nt, int nw, int mode,
    float p1, float p2, float p3, int split_cols, int n_tiles, void* d1,
    void* d2, void* i1, void* cmin, void* carg, void* rowpart, void* colpart,
    void* stream) {
  if (Nq <= 0 || Nt <= 0 || Nq > (int)IDX_MASK || Nt > (int)IDX_MASK ||
      split_cols <= 0 || split_cols % 8 != 0 || mode < 0 || mode > 3 ||
      n_tiles != (Nq + QPB - 1) / QPB)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_splits = (Nt + split_cols - 1) / split_cols;
  const dim3 grid(n_splits, n_tiles), block(WARPS * 32);
#define MATCH_ARGS                                                           \
  static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(t),           \
      static_cast<const float2*>(xyq), static_cast<const float2*>(xyt),       \
      static_cast<const uint8_t*>(vq), static_cast<const uint8_t*>(vt), Nq,   \
      Nt, split_cols, p1, p2, p3, static_cast<uint2*>(rowpart),               \
      static_cast<uint32_t*>(colpart)
#define MATCH_MODE(NW)                                                       \
  switch (mode) {                                                            \
    case 0: match_kernel<NW, 0><<<grid, block, 0, s>>>(MATCH_ARGS); break;   \
    case 1: match_kernel<NW, 1><<<grid, block, 0, s>>>(MATCH_ARGS); break;   \
    case 2: match_kernel<NW, 2><<<grid, block, 0, s>>>(MATCH_ARGS); break;   \
    default: match_kernel<NW, 3><<<grid, block, 0, s>>>(MATCH_ARGS);         \
  }
  if (nw == 4) { MATCH_MODE(4) }
  else if (nw == 8) { MATCH_MODE(8) }
  else if (nw == 16) { MATCH_MODE(16) }
  else return (int)cudaErrorInvalidValue;
#undef MATCH_MODE
#undef MATCH_ARGS
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // programmatic dependent launch: the card sets `finalize` up while the
  // main kernel drains; `finalize` itself waits for the partials
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((Nq + Nt + 7) / 8);
  cfg.blockDim = dim3(256);
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(
      &cfg, finalize, static_cast<const uint2*>(rowpart),
      static_cast<const uint32_t*>(colpart), Nq, Nt, n_splits, n_tiles,
      static_cast<float*>(d1), static_cast<float*>(d2), static_cast<int*>(i1),
      static_cast<float*>(cmin), static_cast<int*>(carg));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
