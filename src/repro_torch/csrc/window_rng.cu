// A window's random draws for Hopper (sm_90a): the engines' one random number
// per event — randint(fold_in(key, t0 + i), (), 0, m) — for the W events of a
// window, in one launch, as the (W, K) table of the draw for every partition
// count m = 1..K (transition.rand_index_table), which the window kernels
// index at num_partitions - 1. Each slot's two 32-bit words (rng.draw_words:
// fold_in is one threefry-2x32 block of (0, t0 + i) under the key, randint's
// key split two more blocks and its two draws two more) are reduced onto
// [0, m) for every m.
//
// Ports no Pallas kernel: in the JAX package these draws are XLA ops inside
// the jitted window programs (src/repro/core/transition.py:374,
// rand_index_table, and the fold_in at src/repro/core/windowed.py:140); the
// port drew them with ~600 small torch ops a window.
//
// Exactness: every operation is uint32 arithmetic, wrapping as the plain
// version masks to 32 bits — the event index t0 + i included (a uint32 sum,
// as fold_in's data is). randint's range reduction multiplies two values
// below 2^32 in 64 bits and masks the product to 32 bits before its modulo,
// as the plain version does.
//
// Bound: one block a slot. Its threads all run the slot's five threefry
// blocks (20 rounds each, ~550 integer operations; three of the blocks
// depend on each other, ~3 x 117 operations at ~4 cycles each, ~1,400
// cycles — an estimate, not measured) and then split the K table entries;
// the bytes (4 W K out) and operations are few, so that chain — latency —
// sets the time.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;

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

// rng.randint_words: the words (hi, lo) reduced onto [0, m) (m <= 0 draws 0)
__device__ __forceinline__ int randint_words(uint32_t hi, uint32_t lo, int m) {
  const uint64_t span = m <= 0 ? 1u : static_cast<uint64_t>(m);
  uint64_t mult = 65536u % span;
  mult = ((mult * mult) & 0xffffffffull) % span;
  const uint64_t off = (((hi % span) * mult) & 0xffffffffull) + (lo % span);
  return static_cast<int>((off & 0xffffffffull) % span);
}

__global__ void __launch_bounds__(kThreads)
window_rng_kernel(const uint32_t* __restrict__ key, uint32_t t0,
                  int* __restrict__ table, int k) {
  const int i = blockIdx.x;
  const uint32_t k0 = key[0], k1 = key[1];
  // fold_in(key, t0 + i): the event's key
  uint32_t y0 = 0u, y1 = t0 + static_cast<uint32_t>(i);
  threefry2x32(k0, k1, y0, y1);
  // randint's split (counters 0 and 1), then one word from each half
  uint32_t a0 = 0u, a1 = 0u, b0 = 0u, b1 = 1u;
  threefry2x32(y0, y1, a0, a1);
  threefry2x32(y0, y1, b0, b1);
  uint32_t h0 = 0u, h1 = 0u, l0 = 0u, l1 = 0u;
  threefry2x32(a0, a1, h0, h1);
  threefry2x32(b0, b1, l0, l1);
  const uint32_t hi = h0 ^ h1, lo = l0 ^ l1;
  int* row = table + static_cast<size_t>(i) * k;
  for (int m = threadIdx.x; m < k; m += kThreads)
    row[m] = randint_words(hi, lo, m + 1);
}

}  // namespace

// The (w, k) table of the draws for m = 1..k partitions of slots 0..w-1 of
// the window starting at event t0 (taken modulo 2^32). `key` is the (2,)
// uint32 key on the card.
extern "C" int window_rng_launch(const uint32_t* key, unsigned int t0,
                                 int* table, int w, int k,
                                 cudaStream_t stream) {
  if (w <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  window_rng_kernel<<<w, kThreads, 0, stream>>>(key, t0, table, k);
  return static_cast<int>(cudaGetLastError());
}
