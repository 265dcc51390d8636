// EmbeddingBag forward (gather + bag reduce) for Hopper (sm_90a).
//
//   out[b, :] = sum over l with idx[b, l] >= 0 of float(table[idx[b, l], :])
//               (mode mean: divided by max(#valid, 1))
//
// Replaces the Pallas TPU kernel `embedding_bag`
// (src/repro/kernels/embedding_bag/embedding_bag.py:49, body `_bag_kernel`),
// which scalar-prefetched the indices into SMEM and let the BlockSpec index
// map gather one (1, block_d) row tile per step of a sequential slot grid
// axis, accumulating in the output's VMEM tile. Here one warp owns one bag:
// it reads the bag's L indices once into shared memory and counts the valid
// ones with a warp reduction, then its lanes stride over D, each column
// summing its L slots in order 0..L-1 in an f32 register (a -1 slot adds
// 0.0 and its row is never loaded), so the result is bit-equal to the
// plain version's slot-ordered sum. The table's element type (f32 or bf16,
// widened to f32) and the mode are template parameters. Row offsets are
// 64-bit: at the full vocabulary idx * D reaches 50,331,647 * 256, past
// 2^31. Indices >= V are a precondition, as in the Pallas kernel.
//
// Bound by bytes: each bag reads L rows of D elements, L indices and
// writes D floats. The rows are random (one 512-byte bf16 row per slot at
// D = 256), so the loads are scattered row reads; this first version
// issues 2- or 4-byte loads per lane (wider loads and several bags per
// warp are later work).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, bool kMean>
__global__ void embedding_bag_kernel(const T* __restrict__ table,
                                     const int* __restrict__ indices,
                                     float* __restrict__ out,
                                     int b, int l, int d) {
  extern __shared__ int slots[];                 // kWarpsPerBlock x l
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int bag = blockIdx.x * kWarpsPerBlock + warp;
  if (bag >= b) return;                          // warp-uniform; no block barrier below
  int* idx = slots + warp * l;
  const int* src = indices + static_cast<size_t>(bag) * l;
  int cnt = 0;
  for (int j = lane; j < l; j += 32) {
    const int v = src[j];
    idx[j] = v;
    cnt += v >= 0 ? 1 : 0;
  }
  for (int off = 16; off > 0; off >>= 1)
    cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
  __syncwarp();
  const float denom = static_cast<float>(cnt > 1 ? cnt : 1);
  float* dst = out + static_cast<size_t>(bag) * d;
  for (int c = lane; c < d; c += 32) {
    float acc = 0.f;
    for (int s = 0; s < l; ++s) {
      const int row = idx[s];
      float v = 0.f;
      if (row >= 0) v = widen(table[static_cast<int64_t>(row) * d + c]);
      acc += v;
    }
    dst[c] = kMean ? acc / denom : acc;
  }
}

template <typename T, bool kMean>
int launch(const void* table, const int* indices, float* out, int b, int l,
           int d, cudaStream_t stream) {
  const int blocks = (b + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const size_t smem = sizeof(int) * kWarpsPerBlock * static_cast<size_t>(l);
  embedding_bag_kernel<T, kMean><<<blocks, 32 * kWarpsPerBlock, smem, stream>>>(
      static_cast<const T*>(table), indices, out, b, l, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table_bf16: 0 = f32 table, 1 = bf16 table; mean: 0 = sum, 1 = mean.
extern "C" int embedding_bag_launch(const void* table, const int* indices,
                                    float* out, int b, int l, int d,
                                    int table_bf16, int mean,
                                    cudaStream_t stream) {
  if (table_bf16)
    return mean ? launch<__nv_bfloat16, true>(table, indices, out, b, l, d, stream)
                : launch<__nv_bfloat16, false>(table, indices, out, b, l, d, stream);
  return mean ? launch<float, true>(table, indices, out, b, l, d, stream)
              : launch<float, false>(table, indices, out, b, l, d, stream);
}
