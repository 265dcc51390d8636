// Windows' random draws for Hopper (sm_90a): the engines' one random number
// per event — randint(fold_in(key, t0 + i), (), 0, m) — as the (w, K) table of
// the draw for every partition count m = 1..K (transition.rand_index_table),
// which the window kernels index at num_partitions - 1; for L (key, t0) pairs
// at once, an (L, w, K) block of tables in one launch. Each slot's two 32-bit
// words (rng.draw_words: fold_in is one threefry-2x32 block of (0, t0 + i)
// under the key, randint's key split two more blocks and its two draws two
// more) are reduced onto [0, m) for every m.
//
// Ports no Pallas kernel: in the JAX package these draws are XLA ops inside
// the jitted window programs (src/repro/core/transition.py:374,
// rand_index_table, and the fold_in at src/repro/core/windowed.py:140); the
// port drew them with ~600 small torch ops a window.
//
// Exactness: every operation is uint32 arithmetic, wrapping as the plain
// version masks to 32 bits — the event index t0 + i included (a uint32 sum,
// as fold_in's data is). randint's range reduction is done in uint32: its
// operands are below 2^32, and each product or sum that the plain version
// forms in 64 bits is masked to 32 bits before its modulo, which is what a
// wrapping uint32 product or sum gives.
//
// Bound: the table's bytes (4 L w K out) for a wide K, the slots' threefry
// chains (five blocks of 20 rounds, ~550 integer operations, three blocks a
// dependent chain of ~1,400 cycles: an estimate, not measured) for a narrow
// one; and below both, for a single window, the launch itself. The design:
// * One thread a slot runs the slot's chain once and leaves its two words
//   in shared memory; then the block's threads write the slots' K entries
//   each, consecutive threads on consecutive entries (coalesced stores).
// * A block covers as many slots as keep its entries near kEntries (all
//   kThreads slots at K <= 16, one slot at K >= 4,096), and no more than
//   leave kMinBlocks blocks to the grid, so the grid fills the card whether
//   K is 1 or 9,587 and whether the launch draws one window or a thousand.
// * blockIdx.y is the table: one launch draws a sweep step's tables for all
//   of its lanes, or a run of many windows' rows of one session.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kEntries = 4096;     // table entries a block aims at
constexpr int kMinBlocks = 264;    // blocks a launch aims at (2 an SM)

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// threefry-2x32, 20 rounds (rng.threefry2x32)
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int j = 0; j < 5; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = rotl(x1, kRot[j % 2][r]);
      x1 ^= x0;
    }
    x0 += ks[(j + 1) % 3];
    x1 += ks[(j + 2) % 3] + static_cast<uint32_t>(j + 1);
  }
}

// rng.randint_words: the words (hi, lo) reduced onto [0, m), m >= 1
__device__ __forceinline__ int randint_words(uint32_t hi, uint32_t lo,
                                             uint32_t m) {
  uint32_t mult = 65536u % m;
  mult = (mult * mult) % m;
  const uint32_t off = (hi % m) * mult + lo % m;
  return static_cast<int>(off % m);
}

// grid (ceil(w / slots), L); every table's slots start at event t0
__global__ void __launch_bounds__(kThreads)
window_rng_kernel(const uint32_t* __restrict__ keys, uint32_t t0,
                  int* __restrict__ table, int w, int k, int slots) {
  __shared__ uint32_t hi_s[kThreads], lo_s[kThreads];
  const int lane_table = blockIdx.y;
  const int i0 = blockIdx.x * slots;
  const int n = min(slots, w - i0);                    // slots of this block
  const int t = threadIdx.x;
  if (t < n) {
    const uint32_t k0 = keys[2 * lane_table], k1 = keys[2 * lane_table + 1];
    // fold_in(key, t0 + i): the event's key
    uint32_t y0 = 0u, y1 = t0 + static_cast<uint32_t>(i0 + t);
    threefry2x32(k0, k1, y0, y1);
    // randint's split (counters 0 and 1), then one word from each half
    uint32_t a0 = 0u, a1 = 0u, b0 = 0u, b1 = 1u;
    threefry2x32(y0, y1, a0, a1);
    threefry2x32(y0, y1, b0, b1);
    uint32_t h0 = 0u, h1 = 0u, l0 = 0u, l1 = 0u;
    threefry2x32(a0, a1, h0, h1);
    threefry2x32(b0, b1, l0, l1);
    hi_s[t] = h0 ^ h1;
    lo_s[t] = l0 ^ l1;
  }
  __syncthreads();
  // the block's n slots' rows are n * k consecutive entries
  int* out = table + (static_cast<int64_t>(lane_table) * w + i0) * k;
  const int64_t entries = static_cast<int64_t>(n) * k;
  // entry e = s * k + (m - 1), advanced by kThreads without a division
  int s = t / k, m = t - s * k;
  const int ds = kThreads / k, dm = kThreads - ds * k;
  for (int64_t e = t; e < entries; e += kThreads) {
    out[e] = randint_words(hi_s[s], lo_s[s], static_cast<uint32_t>(m + 1));
    m += dm;
    s += ds;
    if (m >= k) {
      m -= k;
      ++s;
    }
  }
}

}  // namespace

// The (l, w, k) block of tables: table j holds the draws for m = 1..k
// partitions of slots 0..w-1 of the window starting at event t0 (sums
// taken modulo 2^32) under key j of the (l, 2) uint32 `keys`, both on the
// card.
extern "C" int window_rng_launch(const uint32_t* keys, unsigned int t0,
                                 int* table, int l, int w, int k,
                                 cudaStream_t stream) {
  if (l <= 0 || l > 65535 || w <= 0 || k <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t spread = (static_cast<int64_t>(w) * l + kMinBlocks - 1)
                         / kMinBlocks;             // slots a block at most
  int64_t slots = kEntries / k < spread ? kEntries / k : spread;
  slots = slots < 1 ? 1 : (slots > kThreads ? kThreads : slots);
  const dim3 grid(static_cast<unsigned>((w + slots - 1) / slots), l);
  window_rng_kernel<<<grid, kThreads, 0, stream>>>(
      keys, t0, table, w, k, static_cast<int>(slots));
  return static_cast<int>(cudaGetLastError());
}
