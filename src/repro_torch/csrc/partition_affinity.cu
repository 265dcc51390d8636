// Partition-affinity histogram (paper Eq. 1, batched) for Hopper (sm_90a).
//
//   scores[w, k] = #{d : labels[w, d] == k}     deg[w] = #{d : labels[w, d] >= 0}
//
// Replaces the Pallas TPU kernel `partition_affinity`
// (src/repro/kernels/partition_affinity/partition_affinity.py:47), which
// tiled (W, D) into VMEM blocks and accumulated over a sequential D grid
// axis. Labels outside [0, K) count in no bin; any W, D and K up to
// partition_affinity_max_k() (58,112) are taken as they are, with no padding.
//
// Bound by bytes: (W*D + W*K + W) * 4 read and written once, 0.064 us at the
// session's (256, 192, 16) — so a launch and the chain of memory round trips
// inside it set the time. The design keeps that chain to one load round:
//
// * One warp a window row. Each lane issues all its loads of the row at
//   once — 16-byte loads where the row is 16-byte aligned (D % 4 == 0 and an
//   aligned base: 192 labels are 48 of them), else 4-byte ones, up to
//   kLoads a lane — and only then counts. A row wider than 32 kLoads loads
//   takes further rounds.
// * K <= kRegK: every lane counts 16 or 32 bins in registers, a byte a bin,
//   and the warp adds them with two reductions a word of four bins (no
//   shared memory, no atomics). Larger K:
//   a per-warp histogram of K ints in shared memory with integer atomics,
//   the block holding as many warps (rows) as kWarps and the 232,448 bytes
//   of shared memory allow — one warp a block at K = 58,112. Whether the
//   register counts or the shared atomics are faster at K = 16 was measured
//   on the card (python -m repro_torch.kernels.partition_affinity.sweep;
//   PERF.md).
//
// Exact: integer counts, the order of the adds is irrelevant.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;            // rows a block at most
constexpr int kLoads = 8;            // loads a lane issues before it counts
constexpr int kRegK = 32;            // K up to here: counts in registers
static_assert(kRegK <= 32, "a bin a lane");
static_assert(kLoads >= 1 && 4 * kLoads < 256, "a lane's bin count a byte");
constexpr int kSmemMax = 232448;     // shared memory a block can have
constexpr unsigned kAll = 0xffffffffu;

// A lane's labels of one load round: kLoads loads of V ints each.
template <int V>
struct Round {
  int lab[kLoads * V];
};

// The loads of round `j0` that hold labels of a row of d: the same for the
// whole warp, so the loops below stop there instead of predicating off the
// rest.
template <int V>
__device__ __forceinline__ int round_loads(int d, int j0) {
  const int n = (d - j0 + 32 * V - 1) / (32 * V);
  return n < kLoads ? n : kLoads;
}

// Loads round `j0` of a row (labels j0 .. j0 + 32 kLoads V - 1), all issued
// before any is used; labels past the row's end read as -1.
template <int V>
__device__ __forceinline__ void load_round(const int* row, int d, int j0,
                                           int lane, Round<V>& r) {
  const int nq = round_loads<V>(d, j0);
#pragma unroll
  for (int q = 0; q < kLoads; ++q) {
    if (q == nq) break;
    const int j = j0 + V * (lane + 32 * q);
    if constexpr (V == 4) {                      // d % 4 == 0: whole or none
      int4 x = make_int4(-1, -1, -1, -1);
      if (j < d) x = __ldg(reinterpret_cast<const int4*>(row + j));
      r.lab[4 * q] = x.x;
      r.lab[4 * q + 1] = x.y;
      r.lab[4 * q + 2] = x.z;
      r.lab[4 * q + 3] = x.w;
    } else {
      r.lab[q] = j < d ? __ldg(row + j) : -1;
    }
  }
}

// K <= KB <= kRegK: KB bins counted in registers, four to a word (a byte a
// bin: a lane counts at most 4 kLoads < 256 labels a round), the words
// widened to two 16-bit halves and added over the warp each round
template <int V, int KB>
__global__ void __launch_bounds__(32 * kWarps)
affinity_registers(const int* __restrict__ labels, int* __restrict__ scores,
                   int* __restrict__ deg, int w, int d, int k) {
  constexpr int kWords = KB / 4;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= w) return;                          // warp-uniform
  const int* lr = labels + static_cast<int64_t>(row) * d;
  int cnt = 0, mine = 0;
  for (int j0 = 0; j0 < d; j0 += 32 * kLoads * V) {
    Round<V> r;
    load_round<V>(lr, d, j0, lane, r);
    unsigned c[kWords];
#pragma unroll
    for (int i = 0; i < kWords; ++i) c[i] = 0;
    const int nq = round_loads<V>(d, j0);
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      if (q == nq) break;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int l = r.lab[V * q + e];
        cnt += l >= 0;
        // bin l is byte l & 3 of word l >> 2 (no word for l < 0 or l >= KB)
        const unsigned inc = 1u << (8 * (l & 3));
#pragma unroll
        for (int i = 0; i < kWords; ++i) c[i] += (l >> 2) == i ? inc : 0u;
      }
    }
    // bins 4i, 4i + 2 in the halves of the even bytes; 4i + 1, 4i + 3 odd
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      const unsigned even = __reduce_add_sync(kAll, c[i] & 0x00ff00ffu);
      const unsigned odd = __reduce_add_sync(kAll, (c[i] >> 8) & 0x00ff00ffu);
      if ((lane >> 2) == i)
        mine += ((lane & 1 ? odd : even) >> (16 * ((lane >> 1) & 1))) & 0xffffu;
    }
  }
  cnt = __reduce_add_sync(kAll, cnt);
  if (lane < k) scores[static_cast<int64_t>(row) * k + lane] = mine;
  if (lane == 0) deg[row] = cnt;
}

// any K: a per-warp shared histogram, `warps` rows a block
template <int V>
__global__ void __launch_bounds__(32 * kWarps)
affinity_shared(const int* __restrict__ labels, int* __restrict__ scores,
                int* __restrict__ deg, int w, int d, int k, int warps) {
  extern __shared__ int hist[];                  // warps x k
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * warps + warp;
  if (row >= w) return;                          // warp-uniform; no block barrier
  int* h = hist + static_cast<int64_t>(warp) * k;
  const int* lr = labels + static_cast<int64_t>(row) * d;
  Round<V> r;
  load_round<V>(lr, d, 0, lane, r);              // in flight while h is zeroed
  for (int j = lane; j < k; j += 32) h[j] = 0;
  __syncwarp();
  int cnt = 0;
  for (int j0 = 0;;) {
    const int nq = round_loads<V>(d, j0);
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      if (q == nq) break;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int l = r.lab[V * q + e];
        if (l >= 0) {
          ++cnt;
          if (l < k) atomicAdd(&h[l], 1);
        }
      }
    }
    j0 += 32 * kLoads * V;
    if (j0 >= d) break;
    load_round<V>(lr, d, j0, lane, r);
  }
  cnt = __reduce_add_sync(kAll, cnt);
  __syncwarp();
  int* sr = scores + static_cast<int64_t>(row) * k;
  for (int j = lane; j < k; j += 32) sr[j] = h[j];
  if (lane == 0) deg[row] = cnt;
}

template <int V>
cudaError_t launch(const int* labels, int* scores, int* deg, int w, int d,
                   int k, cudaStream_t stream) {
  const int blocks = (w + kWarps - 1) / kWarps;
  if (k <= 16 && k <= kRegK) {
    affinity_registers<V, 16><<<blocks, 32 * kWarps, 0, stream>>>(
        labels, scores, deg, w, d, k);
    return cudaGetLastError();
  }
  if (k <= kRegK) {
    affinity_registers<V, 32><<<blocks, 32 * kWarps, 0, stream>>>(
        labels, scores, deg, w, d, k);
    return cudaGetLastError();
  }
  const int per_row = static_cast<int>(sizeof(int)) * k;
  int warps = kSmemMax / per_row;
  warps = warps < kWarps ? warps : kWarps;
  if (warps < 1) return cudaErrorInvalidValue;
  const int smem = warps * per_row;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        affinity_shared<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
  }
  affinity_shared<V><<<(w + warps - 1) / warps, 32 * warps, smem, stream>>>(
      labels, scores, deg, w, d, k, warps);
  return cudaGetLastError();
}

}  // namespace

// The most partitions a launch takes: one row's histogram in a block's
// shared memory.
extern "C" int partition_affinity_max_k() {
  return kSmemMax / static_cast<int>(sizeof(int));
}

extern "C" int partition_affinity_launch(const int* labels, int* scores,
                                         int* deg, int w, int d, int k,
                                         cudaStream_t stream) {
  if (k < 1 || k > partition_affinity_max_k())
    return static_cast<int>(cudaErrorInvalidValue);
  const bool wide = d % 4 == 0
      && reinterpret_cast<uintptr_t>(labels) % 16 == 0;
  return static_cast<int>(wide ? launch<4>(labels, scores, deg, w, d, k, stream)
                               : launch<1>(labels, scores, deg, w, d, k, stream));
}
