// Segment SpMM: ELL-padded sparse aggregation for Hopper (sm_90a).
//
//   out[v, :] = sum over s with adj[v, s] >= 0 of float(x[adj[v, s], :])
//               (mode mean: divided by max(#valid, 1))
//
// Replaces the Pallas TPU kernel `segment_spmm`
// (src/repro/kernels/segment_spmm/segment_spmm.py:48, body `_spmm_kernel`),
// which scalar-prefetched the adjacency and let the BlockSpec index map
// gather one (1, block_f) feature tile per step of a sequential
// (row, feature block, slot) grid, accumulating in the output's VMEM tile.
// It is the gather-reduce of csrc/embedding_bag.cu with a slot list of any
// length: one warp owns one row; it walks the row's Dmax slots 32 at a time,
// each lane reading one id of the tile and the warp broadcasting them with
// shuffles, so no shared index list limits Dmax (grqc's rows are 2,843
// wide). The lanes stride over the features, 128 columns per pass, each
// column summing the slots in order 0..Dmax-1 in an f32 register (a -1 slot
// adds nothing and its row is never loaded), so the result is bit-equal to
// the plain version's slot-ordered sum; the mean divides by an f32
// max(count, 1). Rows are read as f32 or bf16 (widened), and row offsets
// are 64-bit.
//
// Bound by bytes: each valid slot reads one row of F elements, every id is
// read once and every output float written once. This first version issues
// 2- or 4-byte loads per lane (wider loads are later work).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kColsPerLane = 4;      // a pass covers 32 * 4 = 128 columns

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, bool kMean>
__global__ void segment_spmm_kernel(const T* __restrict__ x,
                                    const int* __restrict__ adj,
                                    float* __restrict__ out,
                                    int n, int f, int dmax) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int v = blockIdx.x * kWarpsPerBlock + warp;
  if (v >= n) return;                          // warp-uniform
  const int* ids = adj + static_cast<int64_t>(v) * dmax;
  float* dst = out + static_cast<int64_t>(v) * f;
  for (int c0 = 0; c0 < f; c0 += 32 * kColsPerLane) {
    float acc[kColsPerLane];
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) acc[c] = 0.f;
    int cnt = 0;
    for (int s0 = 0; s0 < dmax; s0 += 32) {
      const int mine = s0 + lane < dmax ? ids[s0 + lane] : -1;
      cnt += __popc(__ballot_sync(0xffffffffu, mine >= 0));
      const int width = min(32, dmax - s0);
      for (int j = 0; j < width; ++j) {
        const int row = __shfl_sync(0xffffffffu, mine, j);
        if (row < 0) continue;                 // warp-uniform
        const T* src = x + static_cast<int64_t>(row) * f;
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c) {
          const int col = c0 + lane + 32 * c;
          if (col < f) acc[c] += widen(src[col]);
        }
      }
    }
    const float denom = static_cast<float>(cnt > 1 ? cnt : 1);
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) {
      const int col = c0 + lane + 32 * c;
      if (col < f) dst[col] = kMean ? acc[c] / denom : acc[c];
    }
  }
}

template <typename T, bool kMean>
int launch(const void* x, const int* adj, float* out, int n, int f, int dmax,
           cudaStream_t stream) {
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  segment_spmm_kernel<T, kMean><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      static_cast<const T*>(x), adj, out, n, f, dmax);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_bf16: 0 = f32 features, 1 = bf16 features; mean: 0 = sum, 1 = mean.
extern "C" int segment_spmm_launch(const void* x, const int* adj, float* out,
                                   int n, int f, int dmax, int x_bf16,
                                   int mean, cudaStream_t stream) {
  if (x_bf16)
    return mean ? launch<__nv_bfloat16, true>(x, adj, out, n, f, dmax, stream)
                : launch<__nv_bfloat16, false>(x, adj, out, n, f, dmax, stream);
  return mean ? launch<float, true>(x, adj, out, n, f, dmax, stream)
              : launch<float, false>(x, adj, out, n, f, dmax, stream);
}
