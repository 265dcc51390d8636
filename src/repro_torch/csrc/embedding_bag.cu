// EmbeddingBag forward (gather + bag reduce) for Hopper (sm_90a), and its
// backward (the dense table gradient) at the end of the file.
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

// ---------------------------------------------------------------------------
// Backward: the dense f32 table gradient of a bag lookup
//
//   dtable[r, :] = sum over flat positions p = b * L + l, in ascending order,
//                  with idx[b, l] == r of g'[b, :]
//   g'[b, :]     = g[b, :]                      (mode sum)
//                = g[b, :] / max(#valid_b, 1)   (mode mean)
//
// Replaces the XLA scatter of `bag_lookup`'s custom_vjp backward
// (src/repro/kernels/embedding_bag/ops.py:24, `_bwd`): the bag gradient
// broadcast to every slot, zeroed on -1 slots (whose index becomes 0) and
// scatter-added with `.at[].add` into a zero (V, d) table. It has no Pallas
// counterpart. XLA's CPU scatter and torch's `index_add_` on the host add a
// row's contributions in ascending position order, starting from +0.0; the
// card's `index_add_` adds them with atomics in no fixed order.
//
// Design: deterministic, in that order, so bit-equal to the plain version
// run on the host and to JAX's `_bwd`.
// * The wrapper builds the order: the int64 keys row << 32 | position
//   (a -1 slot keyed to the sentinel row V) sorted with torch.sort, which
//   puts each row's positions in one ascending run; and each bag's count
//   of valid slots. That is index preparation, timed apart in PERF.md.
//   It also zero-fills the dense gradient (one torch.zeros).
// * One warp a sorted key; the warp at the head of a run (its row differs
//   from the key before) walks the run in order and writes the row, the
//   others return at once. Each lane owns columns lane, lane + 32, ...:
//   every load of a g row and every store of the output row is one
//   128-byte line a warp instruction, kBwdCols of them in flight a lane.
// * A -1 slot is skipped. JAX adds +0.0 for it into row 0, which never
//   changes a sum that starts at +0.0 (such a sum is never -0.0, and
//   x + +0.0 == x for every other x, NaN and infinities included), so
//   skipping it gives the same bits, and a bag padded to a long L does not
//   pile every pad onto row 0's warp.
// * Mean divides with IEEE division (__fdiv_rn, never a reciprocal
//   multiply) as JAX divides g by the count before broadcasting: the same
//   quotient for each of the bag's slots.
// Bound by bytes: g read (rows read again by each of their slots mostly hit
// L2 at the recsys config), the keys, and the touched rows written; the
// zero fill of the untouched rows is the dense gradient's own cost.
namespace {

constexpr int kBwdWarps = 8;       // warps (sorted keys) a block
constexpr int kBwdCols = 8;        // columns a lane owns a pass: 256 a warp

template <bool kMean>
__global__ void __launch_bounds__(32 * kBwdWarps)
embedding_bag_backward_kernel(const float* __restrict__ g,
                              const long long* __restrict__ keys,
                              const int* __restrict__ counts,
                              float* __restrict__ dtable, int n, int l,
                              int d, int v) {
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kBwdWarps + (threadIdx.x >> 5);
  if (w >= n) return;                                  // warp-uniform
  const long long head = keys[w];
  const int row = static_cast<int>(head >> 32);
  if (row >= v) return;                                // -1 slots' sentinel
  if (w > 0 && static_cast<int>(keys[w - 1] >> 32) == row) return;
  float* dst = dtable + static_cast<int64_t>(row) * d;
  for (int c0 = 0; c0 < d; c0 += 32 * kBwdCols) {
    float acc[kBwdCols];
#pragma unroll
    for (int e = 0; e < kBwdCols; ++e) acc[e] = 0.0f;
    long long key = head;
    for (int i = w; ; ) {
      const int pos = static_cast<int>(key & 0xffffffffll);
      const int bag = pos / l;
      const float* src = g + static_cast<int64_t>(bag) * d + c0 + lane;
      float x[kBwdCols];
#pragma unroll
      for (int e = 0; e < kBwdCols; ++e)
        x[e] = c0 + lane + 32 * e < d ? __ldg(src + 32 * e) : 0.0f;
      if (kMean) {
        const int cnt = counts[bag];
        const float denom = static_cast<float>(cnt > 1 ? cnt : 1);
#pragma unroll
        for (int e = 0; e < kBwdCols; ++e) x[e] = __fdiv_rn(x[e], denom);
      }
#pragma unroll
      for (int e = 0; e < kBwdCols; ++e) acc[e] = __fadd_rn(acc[e], x[e]);
      if (++i >= n) break;
      key = keys[i];
      if (static_cast<int>(key >> 32) != row) break;
    }
#pragma unroll
    for (int e = 0; e < kBwdCols; ++e)
      if (c0 + lane + 32 * e < d) dst[c0 + lane + 32 * e] = acc[e];
  }
}

}  // namespace

// g: (B, d) f32 bag gradient; keys: the n = B * L sorted int64 keys
// row << 32 | position (row V for a -1 slot); counts: (B,) int32 valid
// slots a bag (read for mean only); dtable: (V, d) f32, zero-filled by the
// caller. n < 2^31.
extern "C" int embedding_bag_backward_launch(const float* g,
                                             const long long* keys,
                                             const int* counts, float* dtable,
                                             int n, int l, int d, int v,
                                             int mean, cudaStream_t stream) {
  if (n <= 0 || l <= 0 || d <= 0 || v <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + kBwdWarps - 1) / kBwdWarps;
  if (mean)
    embedding_bag_backward_kernel<true><<<blocks, 32 * kBwdWarps, 0, stream>>>(
        g, keys, counts, dtable, n, l, d, v);
  else
    embedding_bag_backward_kernel<false><<<blocks, 32 * kBwdWarps, 0,
                                           stream>>>(
        g, keys, counts, dtable, n, l, d, v);
  return static_cast<int>(cudaGetLastError());
}

