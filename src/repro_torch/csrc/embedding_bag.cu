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
// Bound by bytes: the dense table is written whole (V * d * 4 bytes: 4.29 GB
// at the two-tower config's 4,194,304 x 256 f32 user table), g and the ids
// are read. Every row is written exactly once, so what the design has to
// keep out of the way is everything else:
//
// (a) The order, as int32 arrays (the wrapper's `backward_order`): per-row
//     counts by atomics, an exclusive scan of them to CSR offsets over V + 1
//     entries, and each valid slot's position placed in its row's run by an
//     atomic cursor. Placement leaves a run's positions in no fixed order;
//     the pass sorts a run of at most 32 in registers (one warp-wide load,
//     a bitonic network of shuffles), and the longer runs (> 32 slots: hot
//     rows) are sorted in place by `bwd_sort_long`, one block a run
//     (bitonic, in shared memory up to kSortSmem positions, in device memory
//     beyond). Each bag's count of valid slots is counted beside (mean).
// (b) One row-major pass over all V rows (`bwd_pass`), one warp a group of
//     32 rows: an untouched row (an empty run) gets zeros, written with
//     16-byte streaming stores where the row width allows; a touched row
//     gets its ordered sum. No zero fill before it: each row is written once.
//     Except the rows whose run is one slot (most touched rows of the
//     recsys bags: 1,048,576 user slots over 928,066 of 4,194,304 rows):
//     walking those row by row reads a bag's 1 KB g row once for each of its
//     slots, and at 134 MB g does not stay in the 50 MB L2, so those reads
//     came from HBM. `bwd_singles` writes them from their bags instead, one
//     warp a bag, reading the bag's g row once for all of its single-slot
//     rows. The two kernels write disjoint rows; together, each row once.
// (c) The walk of a longer run: the warp loads up to 32 positions of its
//     run in one load and shares them by shuffles; kBwdChunk slots' g rows
//     are in flight before any is added; then the adds, strictly in
//     ascending position order from +0.0, so the chain is the adds, not the
//     loads. A run is never split across warps (that would change the
//     rounding).
//
// Exactness (bit-equal to the plain version on the host and to JAX's
// `_bwd`): a -1 slot is skipped — JAX adds +0.0 for it into row 0, which
// never changes a sum that starts at +0.0 (such a sum is never -0.0, and
// x + +0.0 == x for every other x, NaN and infinities included). Mean
// divides with IEEE division (__fdiv_rn, never a reciprocal multiply), as
// JAX divides g by the count before broadcasting: the same quotient for each
// of the bag's slots. The file is built with -fmad=false. Ids >= V are a
// precondition (they are skipped here, never written out of bounds).
namespace {

constexpr int kCountThreads = 256;
constexpr int kScanThreads = 512;
constexpr int kScanItems = 8;
constexpr int kScanTile = kScanThreads * kScanItems;   // counts a scan block
constexpr int kLongRun = 32;       // runs longer than this: bwd_sort_long
constexpr int kSortThreads = 1024;
constexpr int kSortSmem = 8192;    // positions a run sorted in shared memory
constexpr int kSortBlocks = 264;   // blocks that share the long runs
constexpr int kPassWarps = 8;      // warps (32-row groups) a block
constexpr int kBwdChunk = 4;       // g rows in flight before any add

// per-row counts (rows in [0, v)) and each bag's count of valid slots
__global__ void __launch_bounds__(kCountThreads)
bwd_count(const int* __restrict__ idx, int n, int b, int l, int v,
          int* __restrict__ cnt, int* __restrict__ bag_cnt) {
  const int i = blockIdx.x * kCountThreads + threadIdx.x;
  if (i < n) {
    const int r = idx[i];
    if (r >= 0 && r < v) atomicAdd(cnt + r, 1);
  }
  if (i < b) {
    const int* ids = idx + static_cast<int64_t>(i) * l;
    int c = 0;
    for (int j = 0; j < l; ++j) c += ids[j] >= 0;
    bag_cnt[i] = c;
  }
}

// the block's sum of x (every thread gets it); `red` holds 32 ints
__device__ __forceinline__ int block_sum(int x, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kAll, x, o);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  int t = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(kAll, t, o);
  __syncthreads();
  return t;
}

// the exclusive prefix of x over the block's threads; `red` holds 32 ints
__device__ __forceinline__ int block_exclusive(int x, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kAll, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) red[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int nw = static_cast<int>(blockDim.x >> 5);
    int w = lane < nw ? red[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kAll, w, o);
      if (lane >= o) w += y;
    }
    if (lane < nw) red[lane] = w;             // inclusive over warps
  }
  __syncthreads();
  const int before = warp > 0 ? red[warp - 1] : 0;
  __syncthreads();
  return before + inc - x;
}

// scan pass 1: each tile's sum of counts
__global__ void __launch_bounds__(kScanThreads)
bwd_scan_reduce(const int* __restrict__ cnt, int v, int* __restrict__ part) {
  __shared__ int red[32];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kScanTile;
  int x = 0;
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    const int64_t i = base + j * kScanThreads + threadIdx.x;
    if (i < v) x += cnt[i];
  }
  x = block_sum(x, red);
  if (threadIdx.x == 0) part[blockIdx.x] = x;
}

// scan pass 2 (one block): the tiles' sums to exclusive prefixes in place;
// part[tiles] = the total, part[tiles + 1] = 0 (the long-run counter)
__global__ void __launch_bounds__(1024)
bwd_scan_tiles(int* __restrict__ part, int tiles) {
  __shared__ int red[32];
  int carry = 0;
  for (int t0 = 0; t0 < tiles; t0 += 1024) {
    const int t = t0 + threadIdx.x;
    const int x = t < tiles ? part[t] : 0;
    const int ex = block_exclusive(x, red);
    if (t < tiles) part[t] = carry + ex;
    carry += block_sum(x, red);
  }
  if (threadIdx.x == 0) {
    part[tiles] = carry;
    part[tiles + 1] = 0;
  }
}

// scan pass 3: the offsets of each tile's rows; rows with a long run are
// listed for bwd_sort_long. The tile goes through shared memory, so both
// its loads and its stores are coalesced while each thread scans 8
// consecutive counts
__global__ void __launch_bounds__(kScanThreads)
bwd_scan_apply(const int* __restrict__ cnt, int v, const int* part,
               int tiles, int* __restrict__ offsets,
               int* __restrict__ long_rows, int* long_n) {
  __shared__ int tile[kScanTile];
  __shared__ int red[32];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kScanTile;
  const int t = threadIdx.x;
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    const int i = j * kScanThreads + t;
    tile[i] = base + i < v ? cnt[base + i] : 0;
  }
  __syncthreads();
  int c[kScanItems];
  int x = 0;
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    c[j] = tile[t * kScanItems + j];
    x += c[j];
  }
  int run = part[blockIdx.x] + block_exclusive(x, red);
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    const int i = t * kScanItems + j;
    tile[i] = run;
    if (c[j] > kLongRun)
      long_rows[atomicAdd(long_n, 1)] = static_cast<int>(base + i);
    run += c[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    const int i = j * kScanThreads + t;
    if (base + i < v) offsets[base + i] = tile[i];
  }
  if (blockIdx.x == 0 && t == 0) offsets[v] = part[tiles];
}

// each valid slot's position into its row's run (atomic cursor from the
// run's end: the counts end at zero)
__global__ void __launch_bounds__(kCountThreads)
bwd_place(const int* __restrict__ idx, int n, int v,
          const int* __restrict__ offsets, int* __restrict__ cnt,
          int* __restrict__ perm) {
  const int i = blockIdx.x * kCountThreads + threadIdx.x;
  if (i >= n) return;
  const int r = idx[i];
  if (r < 0 || r >= v) return;
  perm[offsets[r] + atomicSub(cnt + r, 1) - 1] = i;
}

// one compare-exchange stage of an ascending bitonic sort of s[0, len)
// (positions >= len read as +infinity, so they never move): pair i of the
// stage (k, j) is (a, a + j), or for j == k / 2 an element and its mirror
// in its k-block; every pair puts its smaller value at its lower index
__device__ __forceinline__ void bitonic_stage(int* s, int len, int npairs,
                                              int k, int j) {
  for (int i = threadIdx.x; i < npairs; i += blockDim.x) {
    int a, c;
    if (j == (k >> 1)) {
      const int blk = i / j, x = i - blk * j;
      a = blk * k + x;
      c = blk * k + k - 1 - x;
    } else {
      a = 2 * j * (i / j) + i % j;
      c = a + j;
    }
    if (c < len) {
      const int p = s[a], q = s[c];
      if (q < p) {
        s[a] = q;
        s[c] = p;
      }
    }
  }
}

__device__ void bitonic_sort(int* s, int len) {
  int np2 = 1;
  while (np2 < len) np2 <<= 1;
  for (int k = 2; k <= np2; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      bitonic_stage(s, len, np2 >> 1, k, j);
      __syncthreads();
    }
}

// the runs longer than kLongRun, each sorted ascending in place, one block
// a run
__global__ void __launch_bounds__(kSortThreads)
bwd_sort_long(const int* __restrict__ offsets, int* perm,
              const int* __restrict__ long_rows, const int* long_n) {
  __shared__ int s[kSortSmem];
  const int nl = *long_n;
  for (int j = blockIdx.x; j < nl; j += gridDim.x) {
    const int r = long_rows[j];
    const int lo = offsets[r], len = offsets[r + 1] - lo;
    int* run = perm + lo;
    if (len <= kSortSmem) {
      for (int i = threadIdx.x; i < len; i += kSortThreads) s[i] = run[i];
      __syncthreads();
      bitonic_sort(s, len);
      for (int i = threadIdx.x; i < len; i += kSortThreads) run[i] = s[i];
    } else {
      bitonic_sort(run, len);        // in device memory, same block
    }
    __syncthreads();
  }
}

// 32 values, one a lane, sorted ascending over the lanes
__device__ __forceinline__ int warp_sort(int x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int y = __shfl_xor_sync(kAll, x, j);
      const bool up = (lane & k) == 0, lower = (lane & j) == 0;
      x = lower == up ? min(x, y) : max(x, y);
    }
  return x;
}

// kVec: floats a lane moves at once (4: d % 4 == 0 and g 16-byte aligned);
// a lane owns kCols vectors of a 256-column pass
template <int kVec> struct Vec;
template <> struct Vec<4> {
  using T = float4;
  static constexpr int kCols = 2;
  static __device__ __forceinline__ float4 zero() {
    return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  static __device__ __forceinline__ float4 load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void store(float* p, float4 x) {
    __stcs(reinterpret_cast<float4*>(p), x);
  }
  static __device__ __forceinline__ float4 add(float4 a, float4 b) {
    return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                       __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
  }
  static __device__ __forceinline__ float4 div(float4 a, float q) {
    return make_float4(__fdiv_rn(a.x, q), __fdiv_rn(a.y, q),
                       __fdiv_rn(a.z, q), __fdiv_rn(a.w, q));
  }
};
template <> struct Vec<1> {
  using T = float;
  static constexpr int kCols = 8;
  static __device__ __forceinline__ float zero() { return 0.0f; }
  static __device__ __forceinline__ float load(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ void store(float* p, float x) {
    __stcs(p, x);
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float div(float a, float q) {
    return __fdiv_rn(a, q);
  }
};

// a row's run of more than one position, perm[lo, hi), walked into `dst`:
// the positions loaded 32 at a time (one a lane) and, for a short run
// (placed in no fixed order), sorted across the lanes; kBwdChunk slots' g
// rows in flight before any is added; the adds in ascending position order
// from +0.0
template <int kVec, bool kMean>
__device__ __forceinline__ void walk_run(
    const float* __restrict__ g, const int* __restrict__ perm,
    const int* __restrict__ bag_cnt, float* dst, int lo, int hi, int l,
    int d) {
  using V = Vec<kVec>;
  using T = typename V::T;
  constexpr int kCols = V::kCols;
  const int lane = threadIdx.x & 31;
  const int nvec = d / kVec;
  const bool short_run = hi - lo <= kLongRun;
  for (int c0 = 0; c0 < nvec; c0 += 32 * kCols) {
    T acc[kCols];
#pragma unroll
    for (int e = 0; e < kCols; ++e) acc[e] = V::zero();
    for (int s0 = lo; s0 < hi; s0 += 32) {
      const int cnt = min(32, hi - s0);
      int p = lane < cnt ? perm[s0 + lane] : 0x7fffffff;
      if (short_run) p = warp_sort(p);
      for (int u0 = 0; u0 < cnt; u0 += kBwdChunk) {
        T x[kBwdChunk][kCols];
        float den[kBwdChunk];
#pragma unroll
        for (int u = 0; u < kBwdChunk; ++u) {
          const int pos = __shfl_sync(kAll, p, (u0 + u) & 31);
          den[u] = 1.0f;
          if (u0 + u < cnt) {
            const int bag = pos / l;
            const float* src = g + static_cast<int64_t>(bag) * d;
#pragma unroll
            for (int e = 0; e < kCols; ++e) {
              const int q = c0 + lane + 32 * e;
              x[u][e] = q < nvec ? V::load(src + q * kVec) : V::zero();
            }
            if (kMean) {
              const int c = bag_cnt[bag];
              den[u] = static_cast<float>(c > 1 ? c : 1);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kBwdChunk; ++u)
          if (u0 + u < cnt) {
#pragma unroll
            for (int e = 0; e < kCols; ++e)
              acc[e] = V::add(acc[e], kMean ? V::div(x[u][e], den[u])
                                            : x[u][e]);
          }
      }
    }
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      const int q = c0 + lane + 32 * e;
      if (q < nvec) V::store(dst + q * kVec, acc[e]);
    }
  }
}

// the rows whose run is one slot, written from their bag: one warp a bag
// loads its ids and each id's run length, and, where any is 1, the bag's g
// row once; each such row gets +0.0 + g' (-0.0 becomes +0.0, as in a sum
// from +0.0). A run of one slot is its row's only writer.
template <int kVec, bool kMean>
__global__ void __launch_bounds__(32 * kPassWarps)
bwd_singles(const float* __restrict__ g, const int* __restrict__ idx,
            const int* __restrict__ offsets, const int* __restrict__ bag_cnt,
            float* __restrict__ out, int b, int l, int v, int d) {
  using V = Vec<kVec>;
  using T = typename V::T;
  constexpr int kCols = V::kCols;
  const int lane = threadIdx.x & 31;
  const int bag = blockIdx.x * kPassWarps + (threadIdx.x >> 5);
  if (bag >= b) return;                                // warp-uniform
  const int* ids = idx + static_cast<int64_t>(bag) * l;
  const float* src = g + static_cast<int64_t>(bag) * d;
  float den = 1.0f;
  if (kMean) {
    const int c = bag_cnt[bag];
    den = static_cast<float>(c > 1 ? c : 1);
  }
  const int nvec = d / kVec;
  for (int s0 = 0; s0 < l; s0 += 32) {
    const int r = s0 + lane < l ? ids[s0 + lane] : -1;
    const bool single = r >= 0 && r < v && offsets[r + 1] - offsets[r] == 1;
    const unsigned m = __ballot_sync(kAll, single);
    if (!m) continue;
    for (int c0 = 0; c0 < nvec; c0 += 32 * kCols) {
      T y[kCols];
#pragma unroll
      for (int e = 0; e < kCols; ++e) {
        const int q = c0 + lane + 32 * e;
        const T x = q < nvec ? V::load(src + q * kVec) : V::zero();
        y[e] = V::add(V::zero(), kMean ? V::div(x, den) : x);
      }
      for (unsigned mm = m; mm; mm &= mm - 1) {
        const int row = __shfl_sync(kAll, r, __ffs(mm) - 1);
        float* dst = out + static_cast<int64_t>(row) * d;
#pragma unroll
        for (int e = 0; e < kCols; ++e) {
          const int q = c0 + lane + 32 * e;
          if (q < nvec) V::store(dst + q * kVec, y[e]);
        }
      }
    }
  }
}

// the other rows, row-major: one warp a group of 32 rows, each lane holding
// one row's run bounds; every untouched row of the group gets zeros, then
// each run of two or more slots goes through walk_run (a run of one is
// bwd_singles' row)
template <int kVec, bool kMean>
__global__ void __launch_bounds__(32 * kPassWarps)
bwd_pass(const float* __restrict__ g, const int* __restrict__ offsets,
         const int* __restrict__ perm, const int* __restrict__ bag_cnt,
         float* __restrict__ out, int v, int l, int d) {
  using V = Vec<kVec>;
  const int lane = threadIdx.x & 31;
  const int r0 = (blockIdx.x * kPassWarps + (threadIdx.x >> 5)) * 32;
  if (r0 >= v) return;                                 // warp-uniform
  const int r = r0 + lane;
  const int my_lo = r < v ? offsets[r] : 0;
  const int my_n = r < v ? offsets[r + 1] - my_lo : -1;
  const int nvec = d / kVec;
  float* base = out + static_cast<int64_t>(r0) * d;
  for (unsigned m = __ballot_sync(kAll, my_n == 0); m; m &= m - 1) {
    float* dst = base + static_cast<int64_t>(__ffs(m) - 1) * d;
    for (int q = lane; q < nvec; q += 32) V::store(dst + q * kVec, V::zero());
  }
  for (unsigned m = __ballot_sync(kAll, my_n > 1); m; m &= m - 1) {
    const int j = __ffs(m) - 1;
    const int lo = __shfl_sync(kAll, my_lo, j);
    const int n = __shfl_sync(kAll, my_n, j);
    walk_run<kVec, kMean>(g, perm, bag_cnt, base + static_cast<int64_t>(j) * d,
                          lo, lo + n, l, d);
  }
}

template <int kVec, bool kMean>
cudaError_t pass_launch(const float* g, const int* idx, const int* offsets,
                        const int* perm, const int* bag_cnt, float* out,
                        int b, int v, int l, int d, cudaStream_t stream) {
  if (b > 0 && l > 0) {
    bwd_singles<kVec, kMean><<<(b + kPassWarps - 1) / kPassWarps,
                               32 * kPassWarps, 0, stream>>>(
        g, idx, offsets, bag_cnt, out, b, l, v, d);
  }
  const int64_t warps = (static_cast<int64_t>(v) + 31) / 32;
  const int blocks = static_cast<int>((warps + kPassWarps - 1) / kPassWarps);
  bwd_pass<kVec, kMean><<<blocks, 32 * kPassWarps, 0, stream>>>(
      g, offsets, perm, bag_cnt, out, v, l, d);
  return cudaGetLastError();
}

}  // namespace

// counts a scan block covers: the wrapper sizes `part` as
// ceil(v / this) + 2 ints
extern "C" int embedding_bag_backward_scan_tile() { return kScanTile; }

// The order of the backward (a): idx (b, l) int32; cnt (v,) int32, zeroed
// by the caller (it ends zeroed); offsets (v + 1,) the CSR offsets of each
// row's run; perm (b * l,) the runs' positions (the first offsets[v] used;
// runs of more than 32 ascending, shorter ones in no fixed order); bag_cnt
// (b,) each bag's count of valid slots; part (ceil(v / tile) + 2,) and
// long_rows (b * l / 33 + 1,) scratch. b * l < 2^31.
extern "C" int embedding_bag_backward_order(const int* idx, int b, int l,
                                            int v, int* cnt, int* offsets,
                                            int* perm, int* bag_cnt,
                                            int* part, int* long_rows,
                                            cudaStream_t stream) {
  if (b < 0 || l < 0 || v <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = b * l;
  const int tiles = (v + kScanTile - 1) / kScanTile;
  const int count_n = n > b ? n : b;
  if (count_n > 0)
    bwd_count<<<(count_n + kCountThreads - 1) / kCountThreads, kCountThreads,
                0, stream>>>(idx, n, b, l, v, cnt, bag_cnt);
  bwd_scan_reduce<<<tiles, kScanThreads, 0, stream>>>(cnt, v, part);
  bwd_scan_tiles<<<1, 1024, 0, stream>>>(part, tiles);
  bwd_scan_apply<<<tiles, kScanThreads, 0, stream>>>(
      cnt, v, part, tiles, offsets, long_rows, part + tiles + 1);
  if (n > 0) {
    bwd_place<<<(n + kCountThreads - 1) / kCountThreads, kCountThreads, 0,
                stream>>>(idx, n, v, offsets, cnt, perm);
    const int cap = n / (kLongRun + 1) + 1;
    bwd_sort_long<<<cap < kSortBlocks ? cap : kSortBlocks, kSortThreads, 0,
                    stream>>>(offsets, perm, long_rows, part + tiles + 1);
  }
  return static_cast<int>(cudaGetLastError());
}

// The pass (b, c): g (B, d) f32 bag gradient; idx (B, l) the bags; the
// order above; out (v, d) f32, every row written (no zero fill needed).
// vec = 4 needs d % 4 == 0 and g and out 16-byte aligned, vec = 1 takes any
// d.
extern "C" int embedding_bag_backward_pass(const float* g, const int* idx,
                                           const int* offsets,
                                           const int* perm,
                                           const int* bag_cnt, float* out,
                                           int b, int v, int l, int d,
                                           int mean, int vec,
                                           cudaStream_t stream) {
  if (b < 0 || l < 0 || v <= 0 || d <= 0 || (vec != 1 && vec != 4)
      || (vec == 4 && (d % 4 != 0
                       || reinterpret_cast<uintptr_t>(g) % 16 != 0
                       || reinterpret_cast<uintptr_t>(out) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (vec == 4)
    err = mean ? pass_launch<4, true>(g, idx, offsets, perm, bag_cnt, out, b,
                                      v, l, d, stream)
               : pass_launch<4, false>(g, idx, offsets, perm, bag_cnt, out,
                                       b, v, l, d, stream);
  else
    err = mean ? pass_launch<1, true>(g, idx, offsets, perm, bag_cnt, out, b,
                                      v, l, d, stream)
               : pass_launch<1, false>(g, idx, offsets, perm, bag_cnt, out,
                                       b, v, l, d, stream);
  return static_cast<int>(err);
}
