// EmbeddingBag forward (gather + bag reduce) for Hopper (sm_90a).
//
//   out[b, :] = sum over l with idx[b, l] >= 0 of float(table[idx[b, l], :])
//               (mode mean: divided by max(#valid, 1))
//
// Replaces the Pallas TPU kernel `embedding_bag`
// (src/repro/kernels/embedding_bag/embedding_bag.py:49, body `_bag_kernel`),
// which scalar-prefetched the indices into SMEM and let the BlockSpec index
// map gather one (1, block_d) row tile per step of a sequential slot grid
// axis, accumulating in the output's VMEM tile.
//
// Bound by bytes: every valid slot's row, the ids and the f32 output. The
// rows are random (one 512-byte bf16 row a slot at the recsys config's
// D = 256), so the card's L2 gives almost no reuse and what sets the speed
// is how many row bytes are in flight. The design:
//
// * One warp a bag, its lanes across the row, each lane owning V bytes of
//   it (V = 16, 8, 4 or the element width, the widest that the row width
//   and the table's base alignment allow: the wrapper picks it and passes
//   it here). A bf16 row of D = 256 is one warp-wide 16-byte load.
// * Every row of a chunk in flight before any add: the bag's ids come in
//   with one load (32 slots a load) and reach every lane by shuffles; the
//   kChunk rows of a chunk are loaded, then added in slot order, then the
//   next chunk. Rows are read with read-only loads that do not allocate in
//   L1 (each is touched once), the output is written with streaming stores.
// * One warp a bag is the whole grid. What sets the speed is occupancy:
//   kChunk 4 keeps the kernel at about 60 registers, 32 warps an SM. The
//   constants were picked by timing the alternatives on the card (python
//   -m repro_torch.kernels.embedding_bag.sweep; PERF.md), where 8 rows in
//   flight, blocks forced by registers and a strided grid that loads a
//   warp's next bag's ids ahead were slower.
//
// Exactness: each column sums its bag's valid slots in order 0..L-1 in an
// f32 register that starts at +0.0 — the plain version's order. A -1 slot
// is skipped, which is exact: the plain version adds +0.0 there, and adding
// +0.0 to a sum that started at +0.0 never changes it (such a sum is never
// -0.0). bf16 widens to f32 exactly (a shift). Row offsets are 64-bit: at
// the full vocabulary idx * D reaches 50,331,647 * 256, past 2^31. Ids >= V
// are a precondition, as in the Pallas kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;          // warps (bags in flight) a block
constexpr int kChunk = 4;          // rows loaded before any of them is added
constexpr unsigned kAll = 0xffffffffu;

static_assert(32 % kChunk == 0, "a chunk lies inside one 32-slot id load");

// V bytes of a row, loaded read-only without allocating in L1
template <int V> struct Raw { unsigned u[V >= 4 ? V / 4 : 1]; };

template <int V>
__device__ __forceinline__ Raw<V> load_row(const void* p) {
  Raw<V> r;
  if constexpr (V == 16) {
    asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(r.u[0]), "=r"(r.u[1]), "=r"(r.u[2]), "=r"(r.u[3]) : "l"(p));
  } else if constexpr (V == 8) {
    asm("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];"
        : "=r"(r.u[0]), "=r"(r.u[1]) : "l"(p));
  } else if constexpr (V == 4) {
    asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(r.u[0]) : "l"(p));
  } else {
    unsigned short h;
    asm("ld.global.nc.L1::no_allocate.u16 %0, [%1];" : "=h"(h) : "l"(p));
    r.u[0] = h;
  }
  return r;
}

__device__ __forceinline__ int load_id(const int* p) {
  int v;
  asm("ld.global.nc.L1::no_allocate.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// element e of a raw load, widened to f32
template <typename T, int V>
__device__ __forceinline__ float widen(const Raw<V>& r, int e) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(r.u[e]);
  } else {
    const unsigned half = V >= 4 ? (r.u[e >> 1] >> (16 * (e & 1))) & 0xffffu
                                 : r.u[0];
    return __uint_as_float(half << 16);
  }
}

// E consecutive floats, E * 4-byte aligned, written with streaming stores
template <int E>
__device__ __forceinline__ void store_out(float* dst, const float (&a)[E]) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int q = 0; q < E; q += 4)
      __stcs(reinterpret_cast<float4*>(dst + q),
             make_float4(a[q], a[q + 1], a[q + 2], a[q + 3]));
  } else if constexpr (E == 2) {
    __stcs(reinterpret_cast<float2*>(dst), make_float2(a[0], a[1]));
  } else {
    __stcs(dst, a[0]);
  }
}

// T: the table's element (float or bf16); V: the bytes a lane loads of a
// row; kMean: divide by max(#valid, 1).
template <typename T, int V, bool kMean>
__global__ void __launch_bounds__(32 * kWarps)
embedding_bag_kernel(const T* __restrict__ table,
                     const int* __restrict__ indices, float* __restrict__ out,
                     int b, int l, int d) {
  constexpr int E = V / static_cast<int>(sizeof(T));   // elements a load
  const int lane = threadIdx.x & 31;
  const int nv = d / E;                                // loads a row
  const int bag = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (bag >= b) return;                                // warp-uniform
  const int* bag_ids = indices + static_cast<int64_t>(bag) * l;
  float* dst = out + static_cast<int64_t>(bag) * d;
  // the bag's first 32 ids, one a lane (-1 past the bag's end)
  const int ids = lane < l ? load_id(bag_ids + lane) : -1;
  int cnt = 0;
  for (int v0 = 0; v0 < nv; v0 += 32) {                // a lane's V bytes
    const int vi = v0 + lane;
    const bool mine = vi < nv;
    const T* col = table + static_cast<int64_t>(vi) * E;
    float acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.0f;
    for (int s0 = 0; s0 < l; s0 += 32) {
      const int piece = s0 == 0 ? ids
          : (s0 + lane < l ? load_id(bag_ids + s0 + lane) : -1);
      if (v0 == 0) cnt += __popc(__ballot_sync(kAll, piece >= 0));
      for (int c0 = 0; c0 < 32 && s0 + c0 < l; c0 += kChunk) {
        int row[kChunk];
        Raw<V> raw[kChunk];
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          row[u] = __shfl_sync(kAll, piece, c0 + u);     // -1 past the bag
          if (row[u] >= 0 && mine)
            raw[u] = load_row<V>(col + static_cast<int64_t>(row[u]) * d);
        }
#pragma unroll
        for (int u = 0; u < kChunk; ++u)
          if (row[u] >= 0) {
#pragma unroll
            for (int e = 0; e < E; ++e) acc[e] += widen<T, V>(raw[u], e);
          }
      }
    }
    if (mine) {
      if (kMean) {
        const float denom = static_cast<float>(cnt > 1 ? cnt : 1);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] = acc[e] / denom;
      }
      store_out<E>(dst + static_cast<int64_t>(vi) * E, acc);
    }
  }
}

template <typename T, int V, bool kMean>
cudaError_t launch(const void* table, const int* indices, float* out, int b,
                   int l, int d, cudaStream_t stream) {
  embedding_bag_kernel<T, V, kMean><<<(b + kWarps - 1) / kWarps, 32 * kWarps,
                                      0, stream>>>(
      static_cast<const T*>(table), indices, out, b, l, d);
  return cudaGetLastError();
}

template <typename T, bool kMean>
cudaError_t launch_width(const void* table, const int* indices, float* out,
                         int b, int l, int d, int width, cudaStream_t stream) {
  switch (width) {
    case 16: return launch<T, 16, kMean>(table, indices, out, b, l, d, stream);
    case 8: return launch<T, 8, kMean>(table, indices, out, b, l, d, stream);
    case 4: return launch<T, 4, kMean>(table, indices, out, b, l, d, stream);
    case 2:
      if constexpr (sizeof(T) == 2)
        return launch<T, 2, kMean>(table, indices, out, b, l, d, stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// table_bf16: 0 = f32 table, 1 = bf16 table; mean: 0 = sum, 1 = mean;
// width: the bytes a lane loads of a row (16, 8, 4, or 2 for bf16), which
// must divide D * sizeof(element) and the table's base address.
extern "C" int embedding_bag_launch(const void* table, const int* indices,
                                    float* out, int b, int l, int d,
                                    int table_bf16, int mean, int width,
                                    cudaStream_t stream) {
  const int elem = table_bf16 ? 2 : 4;
  if (width < elem || (d * elem) % width != 0
      || reinterpret_cast<uintptr_t>(table) % width != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (table_bf16)
    err = mean ? launch_width<__nv_bfloat16, true>(table, indices, out, b, l,
                                                   d, width, stream)
               : launch_width<__nv_bfloat16, false>(table, indices, out, b, l,
                                                    d, width, stream);
  else
    err = mean ? launch_width<float, true>(table, indices, out, b, l, d,
                                           width, stream)
               : launch_width<float, false>(table, indices, out, b, l, d,
                                            width, stream);
  return static_cast<int>(err);
}
