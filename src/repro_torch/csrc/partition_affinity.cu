// Partition-affinity histogram (paper Eq. 1, batched) for Hopper (sm_90a).
//
//   scores[w, k] = #{d : labels[w, d] == k}     deg[w] = #{d : labels[w, d] >= 0}
//
// Replaces the Pallas TPU kernel `partition_affinity`
// (src/repro/kernels/partition_affinity/partition_affinity.py:47), which
// tiled (W, D) into VMEM blocks and accumulated over a sequential D grid
// axis. Here one warp owns one window row: its lanes stride over D with
// coalesced loads and count into a per-warp histogram of K ints in shared
// memory (integer atomics, so the order of the adds is irrelevant and the
// result exact), and deg comes from a warp reduction. Labels outside
// [0, K) count in no bin. Any W and D are taken as they are, with no
// padding. Bound by bytes: (W*D + W*K + W) * 4 read and written once,
// well under a microsecond at the session's shapes, so the launch itself
// sets the time.
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void partition_affinity_kernel(const int* __restrict__ labels,
                                          int* __restrict__ scores,
                                          int* __restrict__ deg,
                                          int w, int d, int k) {
  extern __shared__ int hist[];                  // kWarpsPerBlock x k
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + warp;
  if (row >= w) return;                          // warp-uniform; no block barrier below
  int* h = hist + warp * k;
  for (int j = lane; j < k; j += 32) h[j] = 0;
  __syncwarp();
  const int* lr = labels + static_cast<size_t>(row) * d;
  int cnt = 0;
  for (int j = lane; j < d; j += 32) {
    const int l = lr[j];
    if (l >= 0) {
      ++cnt;
      if (l < k) atomicAdd(&h[l], 1);
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
  __syncwarp();
  int* sr = scores + static_cast<size_t>(row) * k;
  for (int j = lane; j < k; j += 32) sr[j] = h[j];
  if (lane == 0) deg[row] = cnt;
}

}  // namespace

extern "C" int partition_affinity_launch(const int* labels, int* scores,
                                         int* deg, int w, int d, int k,
                                         cudaStream_t stream) {
  const int blocks = (w + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const size_t smem = sizeof(int) * kWarpsPerBlock * static_cast<size_t>(k);
  partition_affinity_kernel<<<blocks, 32 * kWarpsPerBlock, smem, stream>>>(
      labels, scores, deg, w, d, k);
  return static_cast<int>(cudaGetLastError());
}
