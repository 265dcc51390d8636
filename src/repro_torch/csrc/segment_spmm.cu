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
//
// Bound by bytes: each distinct row of x that a valid slot names read once,
// every id read once, every output float written once. A random gather
// cannot reach that bound from L2: a row is named by about 15 slots
// (twitter's ELL), so the kernel's real traffic is one row read per valid
// slot, and what sets its speed is how many of those reads are in flight.
// The design:
//
// * Valid slots only, ids read once. One warp owns one output row of one
//   column slab; a chunk of 32 ids becomes a ballot mask of the valid
//   slots, walked in slot order (about 15 of twitter's 192). Where F fits
//   one slab the warp reads the row's ids straight from the adjacency;
//   where it spans several, `compact_kernel` first writes each row's valid
//   ids, in slot order, to a packed (N, Dmax) scratch with an (N,) count
//   (ballot + popc give each id's place; no scan), so every slab reads
//   about 15 ids a row, not 192.
// * Column slabs: F is cut into slabs of kSlabBytes a row (128 f32 or 256
//   bf16 columns); the grid is (row blocks, slabs) with the row blocks in
//   blockIdx.x, so CTAs run slab by slab and one slab of x (41.6 MB of
//   twitter's f32 x) is what the rows gather from at a time.
// * Wide loads, many rows in flight: a lane owns 16 bytes of the slab and
//   reads each gathered row with one 16-byte load where the row's slab
//   start is 16-byte aligned, else with 8-, 4- or 2-byte loads (f32 rows of
//   F = 1433 are 5,732 bytes apart, so their alignment differs row to row;
//   it is the same for the whole warp, so the choice does not diverge). A
//   lane never reads past its row's end. kUnroll slots' rows are loaded
//   before they are added, in slot order. Few registers a thread and small
//   CTAs (kUnroll 2, kWarps 4) keep the most warps — and so the most rows —
//   in flight on each SM; the slab width, kUnroll and kWarps were picked by
//   timing the alternatives on the card (python -m
//   repro_torch.kernels.segment_spmm.sweep; its numbers are in PERF.md).
//
// Exactness: each column sums its row's valid slots in order 0..Dmax-1 in
// an f32 register that starts at +0.0 — the plain version's order. A -1 slot
// is skipped, which is exact: the plain version adds +0.0 there, and adding
// +0.0 to a sum that started at +0.0 never changes it (such a sum is never
// -0.0). Rows are read as f32 or bf16 (widened), row offsets are 64-bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kSlabBytes = 512;                  // one row's share of a slab
constexpr int kLaneBytes = kSlabBytes / 32;      // a warp owns a row
constexpr int kWarps = 4;
constexpr int kUnroll = 2;                       // rows in flight per lane
constexpr unsigned kAll = 0xffffffffu;

static_assert(kLaneBytes % 16 == 0, "a lane's span is whole 16-byte words");

__global__ void __launch_bounds__(32 * kWarps)
compact_kernel(const int* __restrict__ adj, int* __restrict__ packed,
               int* __restrict__ count, int n, int dmax) {
  const int lane = threadIdx.x & 31;
  const int v = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (v >= n) return;                            // warp-uniform
  const int* ids = adj + static_cast<int64_t>(v) * dmax;
  int* dst = packed + static_cast<int64_t>(v) * dmax;
  const unsigned below = (1u << lane) - 1u;
  int total = 0;
  for (int s0 = 0; s0 < dmax; s0 += 32) {
    const int id = s0 + lane < dmax ? __ldg(ids + s0 + lane) : -1;
    const unsigned valid = __ballot_sync(kAll, id >= 0);
    if (id >= 0) dst[total + __popc(valid & below)] = id;
    total += __popc(valid);
  }
  if (lane == 0) count[v] = total;
}

template <typename T>
struct Elem {
  static constexpr int kVec = kLaneBytes / static_cast<int>(sizeof(T));
  static constexpr int kCols = kSlabBytes / static_cast<int>(sizeof(T));
};
constexpr int kWords = kLaneBytes / 4;

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  const unsigned short b = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned>(b) << 16);
}

// 32-bit words of a lane's span as floats (f32: one each; bf16: two each,
// the low half first — little-endian element order)
__device__ __forceinline__ void widen_words(const unsigned (&w)[kWords],
                                            float (&v)[kWords]) {
#pragma unroll
  for (int i = 0; i < kWords; ++i) v[i] = __uint_as_float(w[i]);
}
__device__ __forceinline__ void widen_words(const unsigned (&w)[kWords],
                                            float (&v)[2 * kWords]) {
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// The lane's kVec elements of one gathered row, from p on: 16-byte loads
// where p is 16-byte aligned, else the widest aligned pieces; at the row's
// end (nvalid < kVec) element by element, never past it.
template <typename T>
__device__ __forceinline__ void load_span(const T* p, int nvalid,
                                          float (&v)[Elem<T>::kVec]) {
  constexpr int kVec = Elem<T>::kVec;
  const unsigned a = static_cast<unsigned>(reinterpret_cast<uintptr_t>(p));
  unsigned w[kWords];
  if (nvalid >= kVec && (a & 15u) == 0) {
#pragma unroll
    for (int i = 0; i < kWords; i += 4) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p) + i / 4);
      w[i] = q.x; w[i + 1] = q.y; w[i + 2] = q.z; w[i + 3] = q.w;
    }
  } else if (nvalid >= kVec && (a & 7u) == 0) {
#pragma unroll
    for (int i = 0; i < kWords; i += 2) {
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(p) + i / 2);
      w[i] = q.x; w[i + 1] = q.y;
    }
  } else if (nvalid >= kVec && (a & 3u) == 0) {
#pragma unroll
    for (int i = 0; i < kWords; ++i)
      w[i] = __ldg(reinterpret_cast<const unsigned*>(p) + i);
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) v[e] = e < nvalid ? load1(p + e) : 0.f;
    return;
  }
  widen_words(w, v);
}

// Four output floats from p on, with the widest aligned stores; at the
// row's end element by element.
__device__ __forceinline__ void store4(float* p, int nvalid, const float* v) {
  const unsigned a = static_cast<unsigned>(reinterpret_cast<uintptr_t>(p));
  if (nvalid >= 4 && (a & 15u) == 0) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if (nvalid >= 4 && (a & 7u) == 0) {
    reinterpret_cast<float2*>(p)[0] = make_float2(v[0], v[1]);
    reinterpret_cast<float2*>(p)[1] = make_float2(v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < nvalid) p[e] = v[e];
  }
}

// One warp per output row of one slab. kRaw: the row's ids come straight
// from the (N, Dmax) adjacency (F fits one slab, so they are read once
// anyway); else from the compacted scratch. Either way a chunk of 32 ids
// becomes a ballot mask of its valid slots, walked kUnroll at a time.
template <typename T, bool kMean, bool kRaw>
__global__ void __launch_bounds__(32 * kWarps)
gather_kernel(const T* __restrict__ x, const int* __restrict__ ids_in,
              const int* __restrict__ count, float* __restrict__ out, int n,
              int f, int dmax) {
  constexpr int kVec = Elem<T>::kVec;
  const int lane = threadIdx.x & 31;
  const int v = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (v >= n) return;                            // warp-uniform
  const int width = kRaw ? dmax : __ldg(count + v);
  const int c0 = blockIdx.y * Elem<T>::kCols + lane * kVec;
  const int nvalid = f - c0;                     // <= 0: the lane holds none
  const int* ids = ids_in + static_cast<int64_t>(v) * dmax;
  const bool mine_cols = nvalid > 0;
  int cnt = 0;
  float acc[kVec];
#pragma unroll
  for (int c = 0; c < kVec; ++c) acc[c] = 0.f;
  for (int s0 = 0; s0 < width; s0 += 32) {
    const int mine = s0 + lane < width ? __ldg(ids + s0 + lane) : -1;
    unsigned mask = __ballot_sync(kAll, mine >= 0);
    cnt += __popc(mask);
    while (mask) {                               // warp-uniform
      float val[kUnroll][kVec];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        int row = -1;
        if (mask) {
          row = __shfl_sync(kAll, mine, __ffs(mask) - 1);
          mask &= mask - 1;
        }
        if (row >= 0 && mine_cols) {
          load_span(x + static_cast<int64_t>(row) * f + c0, nvalid, val[u]);
        } else {
#pragma unroll
          for (int c = 0; c < kVec; ++c) val[u][c] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int c = 0; c < kVec; ++c) acc[c] += val[u][c];
    }
  }
  if (!mine_cols) return;
  if (kMean) {
    const float denom = static_cast<float>(cnt > 1 ? cnt : 1);
#pragma unroll
    for (int c = 0; c < kVec; ++c) acc[c] = acc[c] / denom;
  }
  float* dst = out + static_cast<int64_t>(v) * f + c0;
#pragma unroll
  for (int h = 0; h < kVec; h += 4) store4(dst + h, nvalid - h, acc + h);
}

template <typename T, bool kMean>
int launch(const void* x, const int* adj, int* packed, int* count, float* out,
           int n, int f, int dmax, cudaStream_t stream) {
  const dim3 grid((n + kWarps - 1) / kWarps,
                  (f + Elem<T>::kCols - 1) / Elem<T>::kCols);
  if (grid.y == 1) {
    gather_kernel<T, kMean, true><<<grid, 32 * kWarps, 0, stream>>>(
        static_cast<const T*>(x), adj, nullptr, out, n, f, dmax);
    return static_cast<int>(cudaGetLastError());
  }
  compact_kernel<<<grid.x, 32 * kWarps, 0, stream>>>(adj, packed, count, n,
                                                      dmax);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_kernel<T, kMean, false><<<grid, 32 * kWarps, 0, stream>>>(
      static_cast<const T*>(x), packed, count, out, n, f, dmax);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of one row's slab (its columns: kSlabBytes / element size).
extern "C" int segment_spmm_slab_bytes() { return kSlabBytes; }

// x_bf16: 0 = f32 features, 1 = bf16 features; mean: 0 = sum, 1 = mean.
// packed (n, dmax) and count (n,) are int32 scratch the caller allocates.
extern "C" int segment_spmm_launch(const void* x, const int* adj, int* packed,
                                   int* count, float* out, int n, int f,
                                   int dmax, int x_bf16, int mean,
                                   cudaStream_t stream) {
  if (x_bf16)
    return mean ? launch<__nv_bfloat16, true>(x, adj, packed, count, out, n, f,
                                              dmax, stream)
                : launch<__nv_bfloat16, false>(x, adj, packed, count, out, n,
                                               f, dmax, stream);
  return mean ? launch<float, true>(x, adj, packed, count, out, n, f, dmax,
                                    stream)
              : launch<float, false>(x, adj, packed, count, out, n, f, dmax,
                                     stream);
}
