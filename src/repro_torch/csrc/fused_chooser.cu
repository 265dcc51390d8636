// Fused mixed-window chooser for Hopper (sm_90a): one warp decides the W
// slots of one window in order — run the policy, merge counters and the
// pairwise cut matrix, record the slot's label, scale out before an ADD
// and scale in after a DEL_VERTEX — while two producer warps resolve the
// labels of the next slots through the touch tables and histogram them.
// Two kernels, chosen by K on the host: the lanes kernel (K <= 192, its
// partitions on the decider's lanes, described here) and the large-K kernel
// (any K whose vectors fit shared memory, described where it starts). The
// pure-ADD window's fixup runs on the same two layouts, with their decider
// code (its two kernels are described where they start). The sweep form
// runs one window of each of L sweep lanes in one launch, a block a lane,
// on either layout (described where it starts).
//
// Replaces the Pallas TPU kernel `fused_window_choose`
// (src/repro/kernels/fused_chooser/fused_chooser.py:245), which kept the
// window in VMEM and walked the slots in a fori_loop.
//
// Bound: by bytes it would take ~W*(9 + 2D + K)*4 bytes at HBM speed
// (0.126 us at (W, D, K) = (256, 192, 16)), but the window is a chain of W
// dependent slots — slot i + 1 reads the label slot i chose — so latency
// bounds it. The latency floor is W times the shortest chain of one slot:
// read the previous slot's label from shared memory (~30 cycles), count
// the labels (shared atomics, a warp sync and a read back: ~100 cycles),
// the K-wide choice (SDP's longest path: a warp reduction, two IEEE
// divisions, the variance gathered to every lane and summed left to right
// in 15 dependent adds, a square root: ~300 cycles at K = 16) and the
// merge up to the next label write (~60 cycles): about 490 cycles a slot,
// 125,000 cycles = 0.063 ms a window at 1.98 GHz. What the design still
// spends above that floor is the decider warp's instruction issue: the
// choice, the merge and the scale-in of every slot.
//
// * One warp carries the decision chain, so the slot loop synchronises
//   with __syncwarp and shared-memory flags only, never a block barrier.
//   Partition j lives on lane j % 32 (entry j / 32 of the lane's arrays;
//   KT entries cover K <= 32 KT): its edge_load, vertex_count and slot
//   histogram stay in registers, the active set is a warp-uniform bit
//   mask, and the scalar counters are replicated in every lane. The cut
//   matrix, w_label and remap sit in shared memory.
// * The K-wide loops are warp reductions that keep the plain version's
//   answers: argmin / argmax as (value, index) reductions whose ties go to
//   the smallest index (__reduce_min/max_sync), nth_active as a ballot plus
//   a popc prefix, integer sums in any order. The two f32 K-sums of
//   load_stats stay left to right: the sum of loads is the integer sum
//   converted once when every partial sum is exact in f32 (loads in
//   [0, 2^24] summing to at most 2^24, the case in practice), else its
//   terms are staged in shared memory and added in order; the variance's
//   terms reach every lane by shuffles (K <= 32) or the same staging, and
//   are added in order.
// * The histogram is off the chain. Producer warp p counts the slots
//   s = p, p + 2, ... into buffer s & 1, with the slot's random and scalar
//   rows, and publishes it through a flag. It counts slot s while the
//   decider decides slot s - 1: its global loads (the (D,) src_lbl and
//   touch rows, 32 kBatch columns at a time) are issued before it waits
//   for slots up to s - 2 to be final; it leaves out the entries slot
//   s - 1 touched and only counts them. The decider then adds those under
//   slot s - 1's final label, and if slot s - 1 scaled in, moves src's
//   count to dst — labels the producer read before or after that relabel
//   end up counted the same. Labels are counted with shared atomic
//   increments (the hardware merges a warp's increments of one entry) and
//   the degree with one warp sum.
//
// Exactness: all counting is integer. The few f32 operations follow the
// plain version one by one (make_slot_step in
// repro_torch/kernels/fused_chooser/fused_chooser.py, merge_slot and the
// choosers in repro_torch/core/transition.py); the file is built with
// -fmad=false so nothing is contracted, except the two multiply-adds that
// XLA's CPU backend (and hence the JAX reference) fuses — the SDP guard's
// w_dev - load_dev and Fennel's scores - cost — which are explicit
// __fmaf_rn here and exact FMAs in the plain version. grid.x carries sweep
// lanes in the sweep form (described where it starts).
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

// POLICIES order of repro_torch.core.config
enum Policy { kSdp = 0, kLdg = 1, kFennel = 2, kHash = 3, kRandom = 4, kGreedy = 5 };

// per-slot scalar row layout (ops._prepare_window)
enum Ev { EV_ET = 0, EV_V, EV_FRESH, EV_WAS, EV_EXISTS, EV_VLBL, EV_VTOUCH,
          EV_ULBL, EV_UTOUCH, EV_COLS };
// scalars layout
enum Scal { S_NP = 0, S_TOTAL, S_CUT, S_DENIED, S_SCALE, SCAL_N };
// knobs layout (transition.Knobs)
enum Knob { K_MAX_CAP = 0, K_SCALE_IN_L, K_SCALE_IN_DEST, K_LDG_CAP_NUM,
            K_FENNEL_GAMMA, K_FENNEL_GM1, K_FENNEL_ALPHA, KNOB_N };

constexpr unsigned kAll = 0xffffffffu;
constexpr int kBig = 1 << 30;
constexpr int kEventAdd = 0;
constexpr int kEventDelVertex = 1;
constexpr int kThreads = 96;      // a decider warp and two producer warps
constexpr int kEvPad = 12;        // a scalar row's ints in shared memory
constexpr int kBatch = 6;         // 32-column rounds loaded before resolving
constexpr int kMaxKt = 6;         // K <= 192
constexpr int kExact = 1 << 24;   // integers up to here are exact in f32
constexpr size_t kSmemMax = 232448;   // shared memory a block can have

__device__ __forceinline__ float f_inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

// The window's per-lane view: partition j = lane + 32 t is entry t.
template <int KT>
struct Lanes {
  int lane, k;
  __device__ bool real(int t) const { return lane + 32 * t < k; }
  __device__ bool active(const unsigned (&act)[KT], int t) const {
    return (act[t] >> lane) & 1u;
  }
  // a[j] in every lane
  __device__ int pick(const int (&a)[KT], int j) const {
    int x = a[0];
#pragma unroll
    for (int t = 1; t < KT; ++t)
      if ((j >> 5) == t) x = a[t];
    return __shfl_sync(kAll, x, j & 31);
  }
  // the first index of the least val[j] over real j (the plain version's
  // argmin: ties to the smallest index)
  __device__ int argmin(const int (&val)[KT]) const {
    int best = INT_MAX, idx = INT_MAX;
#pragma unroll
    for (int t = 0; t < KT; ++t)
      if (real(t) && (idx == INT_MAX || val[t] < best)) {
        best = val[t];
        idx = lane + 32 * t;
      }
    const int m = __reduce_min_sync(kAll, best);
    return __reduce_min_sync(kAll, best == m ? idx : INT_MAX);
  }
  // masked_argmin(x, mask): masked-out entries count as kBig
  __device__ int masked_argmin(const int (&x)[KT],
                               const bool (&mask)[KT]) const {
    int val[KT];
#pragma unroll
    for (int t = 0; t < KT; ++t) val[t] = mask[t] ? x[t] : kBig;
    return argmin(val);
  }
  // nth_active(active, i): the i-th active partition, i modulo the count
  // (0 when none is active) — a ballot prefix
  __device__ int nth_active(const unsigned (&act)[KT], int i) const {
    int cnt = 0;
#pragma unroll
    for (int t = 0; t < KT; ++t) cnt += __popc(act[t]);
    i = floor_mod(i, cnt > 1 ? cnt : 1);
    const unsigned below = (1u << lane) - 1u;
    int found = 0, before = 0;
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      const bool hit = active(act, t)
          && before + __popc(act[t] & below) == i;
      const unsigned b = __ballot_sync(kAll, hit);
      if (b) found = 32 * t + __ffs(b) - 1;
      before += __popc(act[t]);
    }
    return found;
  }
};

// Window state that every lane holds (scalars replicated, K-vectors split).
template <int KT>
struct State {
  unsigned act[KT];
  int el[KT], vc[KT], sc[KT];
  int np, total, cut, denied, scale;
};

// stage[0] + stage[1] + ... + stage[k - 1], left to right (transition's
// _seq_sum); for K <= 32 unrolled, so that all the shared loads are issued
// ahead of the dependent adds
template <int KT>
__device__ __forceinline__ float seq_sum(const float* stage, int k) {
  float x = stage[0];
  if (KT == 1) {
#pragma unroll
    for (int j = 1; j < 32; ++j)
      if (j < k) x = x + stage[j];
  } else {
    for (int j = 1; j < k; ++j) x = x + stage[j];
  }
  return x;
}

// transition.load_stats: (avg_d, load_dev) over active partitions. `stage`
// is a per-warp shared f32 array of K. Also returns the least active load
// (INT_MAX when none is active), which SDP's least-loaded pick reuses.
template <int KT>
__device__ void load_stats(const Lanes<KT>& L, const State<KT>& s,
                           float* stage, float* avg_d, float* load_dev,
                           int* least) {
  int cnt = 0, mx = INT_MIN, mn = INT_MAX;
  unsigned usum = 0;
#pragma unroll
  for (int t = 0; t < KT; ++t) {
    cnt += __popc(s.act[t]);
    if (L.active(s.act, t)) {
      const int e = s.el[t];
      mx = max(mx, e);
      mn = min(mn, e);
      usum += static_cast<unsigned>(e);
    }
  }
  mx = __reduce_max_sync(kAll, mx);
  mn = __reduce_min_sync(kAll, mn);
  usum = __reduce_add_sync(kAll, usum);
  *least = mn;
  const float p = fmaxf(static_cast<float>(cnt), 1.0f);
  // max / min of the converted loads: conversion is monotone
  const float maxl = cnt ? static_cast<float>(mx) : -f_inf();
  const float minl = cnt ? static_cast<float>(mn) : f_inf();
  *avg_d = (maxl - minl) / p;
  float sum;
  if (mn >= 0 && mx <= kExact && usum <= static_cast<unsigned>(kExact)) {
    // loads in [0, 2^24] summing to at most 2^24 (at most 192 of them, so
    // the unsigned sum cannot wrap): every partial sum of the left-to-right
    // f32 sum is an integer below 2^24, hence exact — the sum is the
    // integer sum, converted once
    sum = static_cast<float>(usum);
  } else {
#pragma unroll
    for (int t = 0; t < KT; ++t)
      if (L.real(t))
        stage[L.lane + 32 * t] =
            L.active(s.act, t) ? static_cast<float>(s.el[t]) : 0.0f;
    __syncwarp();
    sum = seq_sum<KT>(stage, L.k);
    __syncwarp();
  }
  const float mean = sum / p;
  float term[KT];
#pragma unroll
  for (int t = 0; t < KT; ++t) {
    const float dv = static_cast<float>(s.el[t]) - mean;
    term[t] = L.active(s.act, t) ? dv * dv : 0.0f;
  }
  float var;
  if (KT == 1) {        // the terms gathered by shuffles, added in order
    var = __shfl_sync(kAll, term[0], 0);
#pragma unroll
    for (int j = 1; j < 32; ++j) {
      const float x = __shfl_sync(kAll, term[0], j);
      if (j < L.k) var = var + x;
    }
  } else {
#pragma unroll
    for (int t = 0; t < KT; ++t)
      if (L.real(t)) stage[L.lane + 32 * t] = term[t];
    __syncwarp();
    // no warp sync after these reads: stage is next written in the next
    // slot, past publish()'s
    var = seq_sum<KT>(stage, L.k);
  }
  *load_dev = sqrtf(var / p);
}

// transition._affinity_choice_at
template <int KT>
__device__ int affinity_choice(const Lanes<KT>& L, const State<KT>& s,
                               int ridx) {
  int sv[KT];
  int best = INT_MIN;
#pragma unroll
  for (int t = 0; t < KT; ++t) {
    sv[t] = L.active(s.act, t) ? s.sc[t] : -1;
    if (L.real(t)) best = max(best, sv[t]);
  }
  best = __reduce_max_sync(kAll, best);
  // both candidates, then a select: straight-line code the compiler can
  // interleave with the caller's reductions
  bool tied[KT];
#pragma unroll
  for (int t = 0; t < KT; ++t) tied[t] = L.active(s.act, t) && sv[t] == best;
  const int p_tie = L.masked_argmin(s.el, tied);
  const int p_rand = L.nth_active(s.act, ridx);
  return best > 0 ? p_tie : p_rand;
}

// argmax of h over active partitions with a 1e-6 tie band, ties broken by
// the smallest vertex count (LDG and Fennel)
template <int KT>
__device__ int banded_pick(const Lanes<KT>& L, const State<KT>& s,
                           const float (&h)[KT]) {
  float best = -f_inf();
#pragma unroll
  for (int t = 0; t < KT; ++t) best = fmaxf(best, h[t]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    best = fmaxf(best, __shfl_xor_sync(kAll, best, off));
  const float floor_ = best - 1e-6f;
  bool tied[KT];
#pragma unroll
  for (int t = 0; t < KT; ++t) tied[t] = L.active(s.act, t) && h[t] >= floor_;
  return L.masked_argmin(s.vc, tied);
}

template <int POLICY, bool ALG1, int KT>
__device__ int choose(const Lanes<KT>& L, const State<KT>& s, float* stage,
                      int deg, int v, int ridx, const float (&kn)[KNOB_N]) {
  const int np = s.np;
  if (POLICY == kSdp) {
    float avg_d, load_dev;
    int least;
    load_stats(L, s, stage, &avg_d, &load_dev, &least);
    const int p_aff = affinity_choice(L, s, ridx);
    const float cut = fmaxf(static_cast<float>(s.cut), 1.0f);
    const float ratio = static_cast<float>(s.total) / cut;
    const float th = __fmaf_rn(ratio, load_dev, -load_dev);
    // masked_argmin(el, active): the first active index holding the least
    // active load, when that load is below the mask's 2^30 (else the
    // general reduction, where a masked entry can tie)
    bool act[KT];
    int first = INT_MAX;
#pragma unroll
    for (int t = KT - 1; t >= 0; --t) {
      act[t] = L.active(s.act, t);
      if (act[t] && s.el[t] == least) first = L.lane + 32 * t;
    }
    const int p_min = least < kBig ? __reduce_min_sync(kAll, first)
                                   : L.masked_argmin(s.el, act);
    if (ALG1) return (np > 1 && load_dev > th) ? p_aff : p_min;
    return (np > 1 && avg_d > th) ? p_min : p_aff;
  } else if (POLICY == kLdg) {
    const float kk = fmaxf(static_cast<float>(np), 1.0f);
    const float cap = kn[K_LDG_CAP_NUM] / kk;
    float h[KT];
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      const float w = 1.0f - static_cast<float>(s.vc[t]) / cap;
      const float hv = static_cast<float>(s.sc[t]) * fmaxf(w, 0.0f);
      h[t] = L.active(s.act, t) ? hv : -f_inf();
    }
    return banded_pick(L, s, h);
  } else if (POLICY == kFennel) {
    const float m = static_cast<float>(s.total) + static_cast<float>(deg);
    int vsum = 0;
#pragma unroll
    for (int t = 0; t < KT; ++t) vsum += L.real(t) ? s.vc[t] : 0;
    vsum = __reduce_add_sync(kAll, vsum);
    const float nt = fmaxf(static_cast<float>(vsum), 1.0f);
    const float kk = fmaxf(static_cast<float>(np), 1.0f);
    const float alpha = kn[K_FENNEL_ALPHA] * sqrtf(kk) * m / powf(nt, 1.5f);
    const float coef = alpha * kn[K_FENNEL_GAMMA];
    float h[KT];
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      h[t] = -f_inf();
      if (L.active(s.act, t)) {
        const float vcp = powf(static_cast<float>(s.vc[t]), kn[K_FENNEL_GM1]);
        h[t] = __fmaf_rn(-coef, vcp, static_cast<float>(s.sc[t]));
      }
    }
    return banded_pick(L, s, h);
  } else if (POLICY == kHash) {
    return L.nth_active(s.act, floor_mod(v, np > 1 ? np : 1));
  } else if (POLICY == kRandom) {
    return L.nth_active(s.act, ridx);
  } else {
    return affinity_choice(L, s, ridx);
  }
}

// a flag in shared memory, read past the compiler's caches
__device__ __forceinline__ int load_flag(const int* f) {
  return *static_cast<const volatile int*>(f);
}
// wait until *f >= v; traps (a launch error, not a hang) if it never comes
__device__ __forceinline__ void wait_flag(const int* f, int v) {
  for (long long spin = 0; load_flag(f) < v; ++spin)
    if (spin > (1ll << 28)) __trap();
  __threadfence_block();
}
// *f = v once this warp's earlier shared-memory writes are visible
__device__ __forceinline__ void publish(int* f, int v) {
  __threadfence_block();
  __syncwarp();
  if ((threadIdx.x & 31) == 0) *static_cast<volatile int*>(f) = v;
}

// The decider's state from the window-start counters: the K-vectors on the
// lanes, the active set as ballots, the scalars in every lane.
template <int KT>
__device__ __forceinline__ void load_state(const Lanes<KT>& L, State<KT>& s,
                                           const int* __restrict__ active_in,
                                           const int* __restrict__ el_in,
                                           const int* __restrict__ vc_in,
                                           const int* __restrict__ scal_in) {
#pragma unroll
  for (int t = 0; t < KT; ++t) {
    const int j = L.lane + 32 * t;
    const bool real = j < L.k;
    s.act[t] = __ballot_sync(kAll, real && active_in[j] != 0);
    s.el[t] = real ? el_in[j] : 0;
    s.vc[t] = real ? vc_in[j] : 0;
    s.sc[t] = 0;
  }
  s.np = scal_in[S_NP];
  s.total = scal_in[S_TOTAL];
  s.cut = scal_in[S_CUT];
  s.denied = scal_in[S_DENIED];
  s.scale = scal_in[S_SCALE];
}

// The window's counters out: the K-vectors, the cut matrix from shared
// memory (row stride ks) and the scalars.
template <int KT>
__device__ __forceinline__ void store_state(const Lanes<KT>& L,
                                            const State<KT>& s, const int* cm,
                                            int ks, int* __restrict__ active_out,
                                            int* __restrict__ loads_out,
                                            int* __restrict__ cm_out,
                                            int* __restrict__ scal_out) {
  const int lane = L.lane, k = L.k;
#pragma unroll
  for (int t = 0; t < KT; ++t) {
    const int j = lane + 32 * t;
    if (L.real(t)) {
      active_out[j] = L.active(s.act, t) ? 1 : 0;
      loads_out[j] = s.el[t];
      loads_out[k + j] = s.vc[t];
    }
  }
  for (int j = lane; j < k * k; j += 32) {
    const int r = j / k;
    cm_out[j] = cm[r * ks + (j - r * k)];
  }
  if (lane == 0) {
    scal_out[S_NP] = s.np;
    scal_out[S_TOTAL] = s.total;
    scal_out[S_CUT] = s.cut;
    scal_out[S_DENIED] = s.denied;
    scal_out[S_SCALE] = s.scale;
  }
}

// transition.scale_out in the decider warp: if MAXCAP <= |E| / |P|,
// activate the first inactive partition (or count a denied scale-out when
// none is free)
template <int KT>
__device__ __forceinline__ void scale_out(const Lanes<KT>& L, State<KT>& s,
                                          const float (&kn)[KNOB_N]) {
  const float p = fmaxf(static_cast<float>(s.np), 1.0f);
  const float thr = static_cast<float>(s.total) / p;
  const bool want = kn[K_MAX_CAP] <= thr;
  int slot = -1;
#pragma unroll
  for (int t = KT - 1; t >= 0; --t) {
    const unsigned b = __ballot_sync(kAll, L.real(t) && !L.active(s.act, t));
    if (b) slot = 32 * t + __ffs(b) - 1;
  }
  if (want && slot >= 0) {
#pragma unroll
    for (int t = 0; t < KT; ++t)
      if ((slot >> 5) == t) s.act[t] |= 1u << (slot & 31);
    s.np += 1;
    s.scale += 1;
  } else if (want) {
    s.denied += 1;
  }
}

// transition.merge_slot from the slot's histogram s.sc: a fresh ADD commits
// to p, a DEL_VERTEX of a present vertex removes from p_dv, an existing
// DEL_EDGE removes the (p_dv, pu) edge — the K-vectors and the scalars in
// registers, then the cut matrix in shared memory (row stride ks). The next
// reader of the cut matrix syncs the warp first.
template <int KT>
__device__ __forceinline__ void merge_slot(const Lanes<KT>& L, State<KT>& s,
                                           int* cm, int ks, int p, int deg,
                                           int fresh, int was, int exists,
                                           int p_dv, int pu) {
  const int lane = L.lane;
  const int d_add = fresh ? deg : 0;
  const int d_dv = was ? deg : 0;
  const int cutdec = (exists && p_dv != pu) ? 1 : 0;
  const int sca_p = fresh ? L.pick(s.sc, p) : 0;
  const int scd_pdv = was ? L.pick(s.sc, p_dv) : 0;
#pragma unroll
  for (int t = 0; t < KT; ++t) {
    const int j = lane + 32 * t;
    int e_j = s.el[t] + (fresh ? s.sc[t] : 0) - (was ? s.sc[t] : 0);
    if (j == p) e_j += d_add;
    if (j == p_dv) e_j -= d_dv + exists;
    if (j == pu) e_j -= exists;
    s.el[t] = e_j;
    if (j == p) s.vc[t] += fresh;
    if (j == p_dv) s.vc[t] -= was;
  }
  s.total = s.total + d_add - d_dv - exists;
  s.cut = s.cut + (d_add - sca_p) - (d_dv - scd_pdv) - cutdec;

  // cut-matrix row/column adds: lane j owns [q][j] and [j][q]; a slot is
  // one event type, so at most one of the three updates runs
  if (fresh || was) {
    const int q = fresh ? p : p_dv;
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      const int j = lane + 32 * t;
      const int add = fresh ? s.sc[t] : -s.sc[t];
      if (L.real(t) && add) {
        if (j == q) {
          cm[q * ks + q] += 2 * add;
        } else {
          cm[q * ks + j] += add;
          cm[j * ks + q] += add;
        }
      }
    }
  } else if (exists && lane == 0) {
    cm[p_dv * ks + pu] -= 1;
    cm[pu * ks + p_dv] -= 1;
  }
}

// The lanes kernel's body: one window's slot loop in the block that calls it
// (the single-session kernel below and the sweep form, a block a lane).
template <int POLICY, bool ALG1, int KT>
__device__ __forceinline__ void
fused_chooser_body(const int* __restrict__ ev, const int* __restrict__ src_lbl,
                     const int* __restrict__ touch, const int* __restrict__ rand_tab,
                     const int* __restrict__ active_in, const int* __restrict__ el_in,
                     const int* __restrict__ vc_in, const int* __restrict__ cm_in,
                     const int* __restrict__ scal_in, const float* __restrict__ knobs,
                     int* __restrict__ w_label_out, int* __restrict__ psel_out,
                     int* __restrict__ remap_out, int* __restrict__ active_out,
                     int* __restrict__ loads_out, int* __restrict__ cm_out,
                     int* __restrict__ scal_out, int w, int d, int k,
                     int autoscaling) {
  const int lane = threadIdx.x & 31;
  const int ks = k + 1;                   // cut-matrix row stride (banks)
  extern __shared__ int smem[];
  int* flags = smem;             // [decided, ready x2, deg x2, pend x2, -]
  int* ev_s = smem + 8;                   // [2][kEvPad] two slots' scalar rows
  int* w_label = ev_s + 2 * kEvPad;       // [w]
  int* remap = w_label + w;               // [k], right after w_label
  int* hist = remap + k;                  // [2][k] two slots' histograms
  int* rand_s = hist + 2 * k;             // [2][k] two slots' random rows
  float* stage = reinterpret_cast<float*>(rand_s + 2 * k);   // [k]
  int* cm = rand_s + 3 * k;               // [k][ks]
  int* decided = flags;                   // slots whose labels are final
  int* ready = flags + 1;        // per buffer: 1 + the slot counted in it

  for (int j = threadIdx.x; j < w; j += kThreads) w_label[j] = -1;
  for (int j = threadIdx.x; j < k; j += kThreads) remap[j] = j;
  for (int j = threadIdx.x; j < 2 * k; j += kThreads) hist[j] = 0;
  for (int j = threadIdx.x; j < k * k; j += kThreads) {
    const int r = j / k;
    cm[r * ks + (j - r * k)] = cm_in[j];
  }
  if (threadIdx.x < 8) flags[threadIdx.x] = 0;
  __syncthreads();                        // the only block barrier

  // the current label: the last in-window decision if touched, else the
  // committed label through the scale-in remap — one load, no branch
  auto label_at = [&](int lc, int t) {
    const int lab = w_label[t >= 0 ? t : w + max(lc, 0)];   // remap follows
    return (t >= 0 || lc >= 0) ? lab : -1;
  };

  if (threadIdx.x >= 32) {
    const int producer = (threadIdx.x >> 5) - 1;    // 0 or 1
    // Producer warp p counts slots p, p + 2, ... (paper Eq. 1): slot s
    // while the decider decides slot s - 1. It reads labels once slots up
    // to s - 2 are final, leaves out the entries that slot s - 1 touched
    // (their count goes to the decider, which knows their label), and
    // hands over the counts with the slot's random and scalar rows. Its
    // global loads are issued before it waits, off the decider's chain.
    for (int sl = producer; sl < w; sl += 2) {
      const int* srow = src_lbl + static_cast<size_t>(sl) * d;
      const int* trow = touch + static_cast<size_t>(sl) * d;
      const int buf = sl & 1;
      int* h = hist + buf * k;
      int seen = 0, pend = 0;
      const int skip = sl - 1;            // the slot decided meanwhile
      int rv[KT];                         // the slot's random and scalar rows
#pragma unroll
      for (int t = 0; t < KT; ++t)
        rv[t] = lane + 32 * t < k
            ? __ldg(rand_tab + static_cast<size_t>(sl) * k + lane + 32 * t) : 0;
      const int evv = lane < EV_COLS
          ? __ldg(ev + static_cast<size_t>(sl) * EV_COLS + lane) : 0;
      for (int j0 = 0; j0 < d; j0 += 32 * kBatch) {
        int lc[kBatch], tt[kBatch], lab[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int j = min(j0 + 32 * b + lane, d - 1);
          lc[b] = __ldg(srow + j);
          tt[b] = __ldg(trow + j);
        }
        if (j0 == 0) wait_flag(decided, sl - 1);   // slots <= sl - 2 final
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const bool in = j0 + 32 * b + lane < d;
          const bool left = in && sl > 0 && tt[b] == skip;
          pend += left;
          lab[b] = in && !left ? label_at(lc[b], tt[b]) : -1;
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          seen += lab[b] >= 0;
          if (lab[b] >= 0 && lab[b] < k) atomicAdd(&h[lab[b]], 1);
        }
      }
      if (d == 0) wait_flag(decided, sl - 1);
#pragma unroll
      for (int t = 0; t < KT; ++t)
        if (lane + 32 * t < k) rand_s[buf * k + lane + 32 * t] = rv[t];
      if (lane < EV_COLS) ev_s[buf * kEvPad + lane] = evv;
      seen = __reduce_add_sync(kAll, seen);
      pend = __reduce_add_sync(kAll, pend);
      if (lane == 0) {
        flags[3 + buf] = seen;
        flags[5 + buf] = pend;
      }
      publish(ready + buf, sl + 1);
    }
    return;
  }

  // The decider warp.
  const Lanes<KT> L{lane, k};
  State<KT> s;
  load_state(L, s, active_in, el_in, vc_in, scal_in);
  float kn[KNOB_N];
#pragma unroll
  for (int j = 0; j < KNOB_N; ++j) kn[j] = knobs[j];
  // slot i - 1's scale-in (src < 0: none), which slot i's counts predate
  int in_src = -1, in_dst = 0;

  for (int i = 0; i < w; ++i) {
    wait_flag(ready + (i & 1), i + 1);
    const int buf = i & 1;
    const int* e = ev_s + buf * kEvPad;
    const int et = e[EV_ET];
    const int v = e[EV_V];
    const int fresh = e[EV_FRESH] != 0;
    const int was = e[EV_WAS] != 0;
    const int exists = e[EV_EXISTS] != 0;
    const bool add_i = et == kEventAdd;
    const bool dv_i = et == kEventDelVertex;

    // slot i's histogram: the producer's counts, relabelled as slot i - 1's
    // scale-in did (src's count moves to dst), plus the entries slot i - 1
    // touched, under its final label
    int* h = hist + buf * k;
#pragma unroll
    for (int t = 0; t < KT; ++t)
      if (L.real(t)) {
        s.sc[t] = h[lane + 32 * t];
        h[lane + 32 * t] = 0;
      }
    int deg = flags[3 + buf];
    const int n_pend = flags[5 + buf];
    if (in_src >= 0) {
      const int moved = L.pick(s.sc, in_src);
#pragma unroll
      for (int t = 0; t < KT; ++t) {
        const int j = lane + 32 * t;
        if (j == in_dst) s.sc[t] += moved;
        if (j == in_src) s.sc[t] = 0;
      }
    }
    if (n_pend) {
      const int lab = w_label[i - 1];
      deg += lab >= 0 ? n_pend : 0;
#pragma unroll
      for (int t = 0; t < KT; ++t)
        if (lane + 32 * t == lab) s.sc[t] += n_pend;
    }
    in_src = -1;

    if (autoscaling && add_i) scale_out(L, s, kn);

    // the DEL subjects' labels do not depend on this slot's choice
    const int vl = label_at(e[EV_VLBL], e[EV_VTOUCH]);
    const int ul = label_at(e[EV_ULBL], e[EV_UTOUCH]);
    const int np1 = s.np > 1 ? s.np : 1;
    const int ridx = rand_s[buf * k + np1 - 1];
    const int p = choose<POLICY, ALG1, KT>(L, s, stage, deg, v, ridx, kn);

    merge_slot(L, s, cm, ks, p, deg, fresh, was, exists, vl > 0 ? vl : 0,
               ul > 0 ? ul : 0);

    if (lane == 0) {
      const int new_lbl = add_i ? (fresh ? p : vl) : (dv_i ? -1 : vl);
      w_label[i] = (add_i || dv_i) ? new_lbl : -1;
      psel_out[i] = p;
    }

    if (autoscaling && dv_i) {                          // scale_in_trigger
      int under = 0;
      bool act[KT], act2[KT];
#pragma unroll
      for (int t = 0; t < KT; ++t) {
        act[t] = L.active(s.act, t);
        under += act[t] && (static_cast<float>(s.el[t]) < kn[K_SCALE_IN_L]);
      }
      const int n_under = __reduce_add_sync(kAll, under);
      const int src = L.masked_argmin(s.el, act);
#pragma unroll
      for (int t = 0; t < KT; ++t) act2[t] = act[t] && lane + 32 * t != src;
      const int dst = L.masked_argmin(s.el, act2);
      const int el_src = L.pick(s.el, src), el_dst = L.pick(s.el, dst);
      const bool fits =
          static_cast<float>(el_src + el_dst) <= kn[K_SCALE_IN_DEST];
      if (s.np > 1 && n_under >= 2 && fits) {           // scale in
        in_src = src;
        in_dst = dst;
        const int vc_src = L.pick(s.vc, src);
        __syncwarp();                                   // the slot's cm adds
        s.cut -= cm[src * ks + dst];
        // merge_cut_matrix: row src into row dst and column src into
        // column dst, then row and column src cleared
        const int ss = cm[src * ks + src];
        int a[KT], row_d[KT], col_d[KT];
#pragma unroll
        for (int t = 0; t < KT; ++t) {
          const int j = lane + 32 * t;
          if (L.real(t)) {
            a[t] = cm[src * ks + j];
            row_d[t] = cm[dst * ks + j];
            col_d[t] = cm[j * ks + dst];
          }
        }
        __syncwarp();
#pragma unroll
        for (int t = 0; t < KT; ++t) {
          const int j = lane + 32 * t;
          if (!L.real(t)) continue;
          if (j == dst) {
            cm[dst * ks + dst] = row_d[t] + a[t] + a[t] + ss;
          } else {
            cm[dst * ks + j] = row_d[t] + a[t];
            cm[j * ks + dst] = col_d[t] + a[t];
          }
        }
        __syncwarp();
#pragma unroll
        for (int t = 0; t < KT; ++t) {
          const int j = lane + 32 * t;
          if (L.real(t)) {
            cm[src * ks + j] = 0;
            cm[j * ks + src] = 0;
          }
        }
        for (int j = lane; j <= i; j += 32)
          if (w_label[j] == src) w_label[j] = dst;
        for (int j = lane; j < k; j += 32)
          if (remap[j] == src) remap[j] = dst;
#pragma unroll
        for (int t = 0; t < KT; ++t) {
          const int j = lane + 32 * t;
          if (j == dst) {
            s.el[t] += el_src;
            s.vc[t] += vc_src;
          }
          if (j == src) {
            s.el[t] = 0;
            s.vc[t] = 0;
          }
        }
#pragma unroll
        for (int t = 0; t < KT; ++t)
          if ((src >> 5) == t) s.act[t] &= ~(1u << (src & 31));
        s.np -= 1;
        s.scale += 1;
      }
    }
    publish(decided, i + 1);              // labels, cut matrix settled
  }

  for (int j = lane; j < w; j += 32) w_label_out[j] = w_label[j];
  for (int j = lane; j < k; j += 32) remap_out[j] = remap[j];
  store_state(L, s, cm, ks, active_out, loads_out, cm_out, scal_out);
}

template <int POLICY, bool ALG1, int KT>
__global__ void __launch_bounds__(kThreads)
fused_chooser_kernel(const int* __restrict__ ev, const int* __restrict__ src_lbl,
                     const int* __restrict__ touch, const int* __restrict__ rand_tab,
                     const int* __restrict__ active_in, const int* __restrict__ el_in,
                     const int* __restrict__ vc_in, const int* __restrict__ cm_in,
                     const int* __restrict__ scal_in, const float* __restrict__ knobs,
                     int* __restrict__ w_label_out, int* __restrict__ psel_out,
                     int* __restrict__ remap_out, int* __restrict__ active_out,
                     int* __restrict__ loads_out, int* __restrict__ cm_out,
                     int* __restrict__ scal_out, int w, int d, int k,
                     int autoscaling) {
  fused_chooser_body<POLICY, ALG1, KT>(
      ev, src_lbl, touch, rand_tab, active_in, el_in, vc_in, cm_in, scal_in,
      knobs, w_label_out, psel_out, remap_out, active_out, loads_out, cm_out,
      scal_out, w, d, k, autoscaling);
}

// ---------------------------------------------------------------------------
// The large-K kernel (K > 32 kMaxKt): the same slot loop, the same producer
// warps, but the decider keeps its K-vectors in shared memory — partition j
// at index j of edge_load, vertex_count and the slot histogram, bit j of a
// word array for the active set, an f32 stage for the banded policies — and
// the K x K cut matrix in device memory (cm_out, copied from the input by
// the launch and updated in place: only the decider warp writes it, each
// entry of a pass from one lane, with warp syncs between passes). The
// K-wide loops walk K in 32-lane strides with the same (value, index)
// reductions and ties as the lanes kernel; nth_active runs a warp prefix
// over the active words. The f32 K-sums of load_stats stay left to right
// over the active partitions (an inactive entry adds +0.0 to a sum that is
// never -0.0, so skipping it is exact); the sum of loads is the 64-bit
// integer sum converted once when every partial sum is exact in f32. Its
// shared memory is 4 (32 + W + 6 K + K / 32) bytes, so at W = 256 it takes
// K up to 9,587 (fused_chooser_large_max_k).
// ---------------------------------------------------------------------------

// the current label of a score source or a DEL subject: the last in-window
// decision if a slot touched it (t >= 0), else its committed label lc through
// the scale-in remap, which follows w_label in shared memory — one load, no
// branch
__device__ __forceinline__ int label_at(const int* w_label, int w, int lc,
                                        int t) {
  const int lab = w_label[t >= 0 ? t : w + max(lc, 0)];
  return (t >= 0 || lc >= 0) ? lab : -1;
}

// The large-K kernel's producer warps (threads 32..95): the lanes kernel's
// producer loop, less the random row, which the large-K decider reads from
// device memory. Producer warp p counts slots p, p + 2, ... (paper Eq. 1):
// slot s while the decider decides slot s - 1. It reads labels once slots
// up to s - 2 are final, leaves out the entries that slot s - 1 touched
// (their count goes to the decider, which knows their label), and hands
// over the counts with the slot's scalar row. Its global loads are issued
// before it waits, off the decider's chain.
__device__ __forceinline__ void produce(
    const int* __restrict__ ev, const int* __restrict__ src_lbl,
    const int* __restrict__ touch, int* flags, int* ev_s,
    const int* w_label, int* hist, int w, int d, int k) {
  const int lane = threadIdx.x & 31;
  const int producer = (threadIdx.x >> 5) - 1;    // 0 or 1
  int* decided = flags;
  int* ready = flags + 1;
  for (int sl = producer; sl < w; sl += 2) {
    const int* srow = src_lbl + static_cast<size_t>(sl) * d;
    const int* trow = touch + static_cast<size_t>(sl) * d;
    const int buf = sl & 1;
    int* h = hist + buf * k;
    int seen = 0, pend = 0;
    const int skip = sl - 1;            // the slot decided meanwhile
    const int evv = lane < EV_COLS   // the slot's scalar row
        ? __ldg(ev + static_cast<size_t>(sl) * EV_COLS + lane) : 0;
    for (int j0 = 0; j0 < d; j0 += 32 * kBatch) {
      int lc[kBatch], tt[kBatch], lab[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int j = min(j0 + 32 * b + lane, d - 1);
        lc[b] = __ldg(srow + j);
        tt[b] = __ldg(trow + j);
      }
      if (j0 == 0) wait_flag(decided, sl - 1);   // slots <= sl - 2 final
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const bool in = j0 + 32 * b + lane < d;
        const bool left = in && sl > 0 && tt[b] == skip;
        pend += left;
        lab[b] = in && !left ? label_at(w_label, w, lc[b], tt[b]) : -1;
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        seen += lab[b] >= 0;
        if (lab[b] >= 0 && lab[b] < k) atomicAdd(&h[lab[b]], 1);
      }
    }
    if (d == 0) wait_flag(decided, sl - 1);
    if (lane < EV_COLS) ev_s[buf * kEvPad + lane] = evv;
    seen = __reduce_add_sync(kAll, seen);
    pend = __reduce_add_sync(kAll, pend);
    if (lane == 0) {
      flags[3 + buf] = seen;
      flags[5 + buf] = pend;
    }
    publish(ready + buf, sl + 1);
  }
}

namespace wide {

constexpr int kStrides = 8;    // strides of a cut-matrix pass in flight

// The large-K decider's view of the window: K-vectors in shared memory.
struct Wide {
  int lane, k, nw;          // nw = ceil(k / 32) words of the active set
  int* el;                  // [k] edge loads
  int* vc;                  // [k] vertex counts
  unsigned* act;            // [nw] active set, bit j & 31 of word j >> 5
  float* stage;             // [k] f32 terms of the banded policies
  __device__ bool active(int j) const { return (act[j >> 5] >> (j & 31)) & 1u; }
  // the first index of the least val(j) over j < k (ties to the smallest
  // index, as Lanes::argmin)
  template <typename F>
  __device__ int argmin(F val) const {
    int best = INT_MAX, idx = INT_MAX;
    for (int j = lane; j < k; j += 32) {
      const int v = val(j);
      if (idx == INT_MAX || v < best) {
        best = v;
        idx = j;
      }
    }
    const int m = __reduce_min_sync(kAll, best);
    return __reduce_min_sync(kAll, best == m ? idx : INT_MAX);
  }
  // masked_argmin(x, mask): masked-out entries count as kBig
  template <typename M>
  __device__ int masked_argmin(const int* x, M mask) const {
    return argmin([&](int j) { return mask(j) ? x[j] : kBig; });
  }
  // nth_active(active, i): the i-th active partition, i modulo the count
  // (0 when none is active)
  __device__ int nth_active(int i) const {
    int cnt = 0;
    for (int t = lane; t < nw; t += 32) cnt += __popc(act[t]);
    cnt = __reduce_add_sync(kAll, cnt);
    i = floor_mod(i, cnt > 1 ? cnt : 1);
    int before = 0;
    for (int t0 = 0; t0 < nw; t0 += 32) {
      const unsigned word = t0 + lane < nw ? act[t0 + lane] : 0u;
      const int c = __popc(word);
      int incl = c;                     // inclusive prefix over the lanes
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kAll, incl, off);
        if (lane >= off) incl += y;
      }
      const unsigned hit =
          __ballot_sync(kAll, before + incl - c <= i && i < before + incl);
      if (hit) {
        const int src = __ffs(hit) - 1;
        unsigned bits = __shfl_sync(kAll, word, src);
        for (int r = i - before - __shfl_sync(kAll, incl - c, src); r > 0; --r)
          bits &= bits - 1;
        return 32 * (t0 + src) + __ffs(bits) - 1;
      }
      before += __shfl_sync(kAll, incl, 31);
    }
    return 0;
  }
  // +0.0 + term(j) + ... over the active j in index order (transition's
  // _seq_sum of a where(active, term, 0.0) vector); every lane gets it
  template <typename F>
  __device__ float active_sum(F term) const {
    float x = 0.0f;
    for (int t = 0; t < nw; ++t)
      for (unsigned bits = act[t]; bits; bits &= bits - 1)
        x = x + term(32 * t + __ffs(bits) - 1);
    return x;
  }
};

struct Scalars {
  int np, total, cut, denied, scale;
};

// transition.load_stats over the shared K-vectors
__device__ void load_stats(const Wide& S, float* avg_d, float* load_dev) {
  int cnt = 0, mx = INT_MIN, mn = INT_MAX;
  long long sum = 0;
  for (int j = S.lane; j < S.k; j += 32)
    if (S.active(j)) {
      const int e = S.el[j];
      ++cnt;
      mx = max(mx, e);
      mn = min(mn, e);
      sum += e;
    }
  cnt = __reduce_add_sync(kAll, cnt);
  mx = __reduce_max_sync(kAll, mx);
  mn = __reduce_min_sync(kAll, mn);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(kAll, sum, off);
  const float p = fmaxf(static_cast<float>(cnt), 1.0f);
  const float maxl = cnt ? static_cast<float>(mx) : -f_inf();
  const float minl = cnt ? static_cast<float>(mn) : f_inf();
  *avg_d = (maxl - minl) / p;
  // loads in [0, 2^24] summing to at most 2^24: every partial sum of the
  // left-to-right f32 sum is an integer below 2^24, hence exact (a 64-bit
  // sum: K loads of up to 2^31 each would wrap 32 bits past K = 2)
  const float total = (mn >= 0 && mx <= kExact && sum <= kExact)
      ? static_cast<float>(sum)
      : S.active_sum([&](int j) { return static_cast<float>(S.el[j]); });
  const float mean = total / p;
  const float var = S.active_sum([&](int j) {
    const float dv = static_cast<float>(S.el[j]) - mean;
    return dv * dv;
  });
  *load_dev = sqrtf(var / p);
}

// transition._affinity_choice_at
__device__ int affinity_choice(const Wide& S, const int* sc, int ridx) {
  int best = INT_MIN;
  for (int j = S.lane; j < S.k; j += 32)
    best = max(best, S.active(j) ? sc[j] : -1);
  best = __reduce_max_sync(kAll, best);
  if (best <= 0) return S.nth_active(ridx);
  return S.masked_argmin(S.el,
                         [&](int j) { return S.active(j) && sc[j] == best; });
}

// argmax of stage (h, -inf where inactive) with a 1e-6 tie band, ties
// broken by the smallest vertex count (LDG and Fennel)
__device__ int banded_pick(const Wide& S) {
  float best = -f_inf();
  for (int j = S.lane; j < S.k; j += 32) best = fmaxf(best, S.stage[j]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    best = fmaxf(best, __shfl_xor_sync(kAll, best, off));
  const float floor_ = best - 1e-6f;
  return S.masked_argmin(
      S.vc, [&](int j) { return S.active(j) && S.stage[j] >= floor_; });
}

template <int POLICY, bool ALG1>
__device__ int choose(const Wide& S, const int* sc, const Scalars& s, int deg,
                      int v, int ridx, const float (&kn)[KNOB_N]) {
  const int np = s.np;
  if (POLICY == kSdp) {
    float avg_d, load_dev;
    load_stats(S, &avg_d, &load_dev);
    const int p_aff = affinity_choice(S, sc, ridx);
    const float cut = fmaxf(static_cast<float>(s.cut), 1.0f);
    const float ratio = static_cast<float>(s.total) / cut;
    const float th = __fmaf_rn(ratio, load_dev, -load_dev);
    const int p_min = S.masked_argmin(S.el, [&](int j) { return S.active(j); });
    if (ALG1) return (np > 1 && load_dev > th) ? p_aff : p_min;
    return (np > 1 && avg_d > th) ? p_min : p_aff;
  } else if (POLICY == kLdg) {
    const float kk = fmaxf(static_cast<float>(np), 1.0f);
    const float cap = kn[K_LDG_CAP_NUM] / kk;
    for (int j = S.lane; j < S.k; j += 32) {
      const float w = 1.0f - static_cast<float>(S.vc[j]) / cap;
      const float hv = static_cast<float>(sc[j]) * fmaxf(w, 0.0f);
      S.stage[j] = S.active(j) ? hv : -f_inf();
    }
    __syncwarp();
    const int p = banded_pick(S);
    __syncwarp();                       // stage is written again next slot
    return p;
  } else if (POLICY == kFennel) {
    const float m = static_cast<float>(s.total) + static_cast<float>(deg);
    unsigned vsum = 0;                  // int32 sum, wrapping as torch's does
    for (int j = S.lane; j < S.k; j += 32) vsum += static_cast<unsigned>(S.vc[j]);
    vsum = __reduce_add_sync(kAll, vsum);
    const float nt = fmaxf(static_cast<float>(static_cast<int>(vsum)), 1.0f);
    const float kk = fmaxf(static_cast<float>(np), 1.0f);
    const float alpha = kn[K_FENNEL_ALPHA] * sqrtf(kk) * m / powf(nt, 1.5f);
    const float coef = alpha * kn[K_FENNEL_GAMMA];
    for (int j = S.lane; j < S.k; j += 32) {
      float h = -f_inf();
      if (S.active(j)) {
        const float vcp = powf(static_cast<float>(S.vc[j]), kn[K_FENNEL_GM1]);
        h = __fmaf_rn(-coef, vcp, static_cast<float>(sc[j]));
      }
      S.stage[j] = h;
    }
    __syncwarp();
    const int p = banded_pick(S);
    __syncwarp();
    return p;
  } else if (POLICY == kHash) {
    return S.nth_active(floor_mod(v, np > 1 ? np : 1));
  } else if (POLICY == kRandom) {
    return S.nth_active(ridx);
  } else {
    return affinity_choice(S, sc, ridx);
  }
}

// transition.scale_out, in the decider warp: if MAXCAP <= |E| / |P|,
// activate the first inactive partition (or count a denied scale-out when
// none is free)
__device__ __forceinline__ void scale_out(const Wide& S, Scalars& s,
                                          const float (&kn)[KNOB_N]) {
  const int lane = S.lane, k = S.k, nw = S.nw;
  const float p = fmaxf(static_cast<float>(s.np), 1.0f);
  const float thr = static_cast<float>(s.total) / p;
  const bool want = kn[K_MAX_CAP] <= thr;
  int slot = -1;
  for (int t0 = 0; t0 < nw && slot < 0; t0 += 32) {
    const int t = t0 + lane;
    const int left = k - 32 * t;
    const unsigned real = left >= 32 ? kAll : (left > 0 ? (1u << left) - 1u : 0u);
    const unsigned free_ = t < nw ? ~S.act[t] & real : 0u;
    const unsigned b = __ballot_sync(kAll, free_ != 0);
    if (b) {
      const int src = __ffs(b) - 1;
      slot = 32 * (t0 + src) + __ffs(__shfl_sync(kAll, free_, src)) - 1;
    }
  }
  if (want && slot >= 0) {
    if (lane == 0) S.act[slot >> 5] |= 1u << (slot & 31);
    s.np += 1;
    s.scale += 1;
  } else if (want) {
    s.denied += 1;
  }
  __syncwarp();
}

// transition.merge_slot from the slot's histogram (sc, deg): a fresh ADD
// commits to p, a DEL_VERTEX of a present vertex removes from p_dv, an
// existing DEL_EDGE removes the (p_dv, pu) edge — the K-vectors and the
// scalars, then the cut matrix in device memory. The caller syncs the warp
// before it reads el, vc or cm again.
__device__ __forceinline__ void merge_slot(const Wide& S, const int* sc,
                                           Scalars& s, int* cm, int p,
                                           int deg, int fresh, int was,
                                           int exists, int p_dv, int pu) {
  const int lane = S.lane, k = S.k;
  int* el = S.el;
  int* vc = S.vc;
  const int d_add = fresh ? deg : 0;
  const int d_dv = was ? deg : 0;
  const int cutdec = (exists && p_dv != pu) ? 1 : 0;
  const int sca_p = fresh ? sc[p] : 0;
  const int scd_pdv = was ? sc[p_dv] : 0;
  for (int j = lane; j < k; j += 32) {
    int e_j = el[j] + (fresh ? sc[j] : 0) - (was ? sc[j] : 0);
    if (j == p) e_j += d_add;
    if (j == p_dv) e_j -= d_dv + exists;
    if (j == pu) e_j -= exists;
    el[j] = e_j;
    if (j == p) vc[j] += fresh;
    if (j == p_dv) vc[j] -= was;
  }
  s.total = s.total + d_add - d_dv - exists;
  s.cut = s.cut + (d_add - sca_p) - (d_dv - scd_pdv) - cutdec;

  // cut-matrix row/column adds in device memory: lane j % 32 owns [q][j]
  // and [j][q]; a slot is one event type, so at most one update runs.
  // kStrides strides' entries are read before any is written (no entry
  // is touched twice in a pass), so their reads are in flight together.
  if (fresh || was) {
    const int q = fresh ? p : p_dv;
    int* row_q = cm + static_cast<size_t>(q) * k;
    for (int j0 = lane; j0 < k; j0 += 32 * kStrides) {
      int add[kStrides], row[kStrides], col[kStrides];
#pragma unroll
      for (int u = 0; u < kStrides; ++u) {
        const int j = j0 + 32 * u;
        add[u] = j < k ? (fresh ? sc[j] : -sc[j]) : 0;
        if (add[u]) {
          row[u] = row_q[j];
          col[u] = cm[static_cast<size_t>(j) * k + q];
        }
      }
#pragma unroll
      for (int u = 0; u < kStrides; ++u) {
        const int j = j0 + 32 * u;
        if (add[u] && j == q) {
          row_q[q] = row[u] + 2 * add[u];
        } else if (add[u]) {
          row_q[j] = row[u] + add[u];
          cm[static_cast<size_t>(j) * k + q] = col[u] + add[u];
        }
      }
    }
  } else if (exists && lane == 0) {
    cm[static_cast<size_t>(p_dv) * k + pu] -= 1;
    cm[static_cast<size_t>(pu) * k + p_dv] -= 1;
  }
}

}  // namespace wide

// The large-K kernel's body, as fused_chooser_body is the lanes kernel's.
template <int POLICY, bool ALG1>
__device__ __forceinline__ void
fused_chooser_large_body(
    const int* __restrict__ ev, const int* __restrict__ src_lbl,
    const int* __restrict__ touch, const int* __restrict__ rand_tab,
    const int* __restrict__ active_in, const int* __restrict__ el_in,
    const int* __restrict__ vc_in, const int* __restrict__ scal_in,
    const float* __restrict__ knobs, int* __restrict__ w_label_out,
    int* __restrict__ psel_out, int* __restrict__ remap_out,
    int* __restrict__ active_out, int* __restrict__ loads_out,
    int* cm, int* __restrict__ scal_out, int w, int d, int k,
    int autoscaling) {
  const int lane = threadIdx.x & 31;
  const int nw = (k + 31) >> 5;
  extern __shared__ int smem[];
  int* flags = smem;             // [decided, ready x2, deg x2, pend x2, -]
  int* ev_s = smem + 8;                   // [2][kEvPad] two slots' scalar rows
  int* w_label = ev_s + 2 * kEvPad;       // [w]
  int* remap = w_label + w;               // [k], right after w_label
  int* hist = remap + k;                  // [2][k] two slots' histograms
  float* stage = reinterpret_cast<float*>(hist + 2 * k);     // [k]
  int* el = hist + 3 * k;                 // [k]
  int* vc = el + k;                       // [k]
  unsigned* act = reinterpret_cast<unsigned*>(vc + k);       // [nw]
  int* decided = flags;
  int* ready = flags + 1;

  for (int j = threadIdx.x; j < w; j += kThreads) w_label[j] = -1;
  for (int j = threadIdx.x; j < k; j += kThreads) {
    remap[j] = j;
    hist[j] = 0;
    hist[k + j] = 0;
    el[j] = el_in[j];
    vc[j] = vc_in[j];
  }
  for (int t = threadIdx.x; t < nw; t += kThreads) {
    unsigned bits = 0;
    for (int b = 0; b < 32 && 32 * t + b < k; ++b)
      bits |= (active_in[32 * t + b] != 0 ? 1u : 0u) << b;
    act[t] = bits;
  }
  if (threadIdx.x < 8) flags[threadIdx.x] = 0;
  __syncthreads();                        // the only block barrier

  if (threadIdx.x >= 32) {
    produce(ev, src_lbl, touch, flags, ev_s, w_label, hist, w, d, k);
    return;
  }

  // The decider warp.
  using wide::kStrides;
  const wide::Wide S{lane, k, nw, el, vc, act, stage};
  wide::Scalars s{scal_in[S_NP], scal_in[S_TOTAL], scal_in[S_CUT], scal_in[S_DENIED],
            scal_in[S_SCALE]};
  float kn[KNOB_N];
#pragma unroll
  for (int j = 0; j < KNOB_N; ++j) kn[j] = knobs[j];
  int in_src = -1, in_dst = 0;    // slot i - 1's scale-in, as in the lanes kernel

  for (int i = 0; i < w; ++i) {
    // the slot's random index is entry np - 1 of its row, np after the
    // slot's scale-out: one of two entries, both loaded before the wait
    const int np0 = s.np;
    const int* rrow = rand_tab + static_cast<size_t>(i) * k;
    const int r_keep = __ldg(rrow + (np0 > 1 ? np0 : 1) - 1);
    const int r_grow = __ldg(rrow + min(np0, k - 1));
    wait_flag(ready + (i & 1), i + 1);
    const int buf = i & 1;
    const int* e = ev_s + buf * kEvPad;
    const int et = e[EV_ET];
    const int v = e[EV_V];
    const int fresh = e[EV_FRESH] != 0;
    const int was = e[EV_WAS] != 0;
    const int exists = e[EV_EXISTS] != 0;
    const bool add_i = et == kEventAdd;
    const bool dv_i = et == kEventDelVertex;

    // slot i's histogram, in place: slot i - 1's scale-in moves src's count
    // to dst, then the entries slot i - 1 touched count under its label
    int* sc = hist + buf * k;
    int deg = flags[3 + buf];
    const int n_pend = flags[5 + buf];
    const int lab = n_pend ? w_label[i - 1] : -1;
    deg += lab >= 0 ? n_pend : 0;
    if (lane == 0) {
      if (in_src >= 0) {
        sc[in_dst] += sc[in_src];
        sc[in_src] = 0;
      }
      if (lab >= 0) sc[lab] += n_pend;
    }
    in_src = -1;
    __syncwarp();

    if (autoscaling && add_i) wide::scale_out(S, s, kn);

    // the DEL subjects' labels do not depend on this slot's choice
    const int vl = label_at(w_label, w, e[EV_VLBL], e[EV_VTOUCH]);
    const int ul = label_at(w_label, w, e[EV_ULBL], e[EV_UTOUCH]);
    const int ridx = s.np == np0 ? r_keep : r_grow;
    const int p = wide::choose<POLICY, ALG1>(S, sc, s, deg, v, ridx, kn);

    wide::merge_slot(S, sc, s, cm, p, deg, fresh, was, exists,
                     vl > 0 ? vl : 0, ul > 0 ? ul : 0);

    if (lane == 0) {
      const int new_lbl = add_i ? (fresh ? p : vl) : (dv_i ? -1 : vl);
      w_label[i] = (add_i || dv_i) ? new_lbl : -1;
      psel_out[i] = p;
    }
    __syncwarp();                       // el, vc, cm and w_label settled

    if (autoscaling && dv_i) {                          // scale_in_trigger
      int under = 0;
      for (int j = lane; j < k; j += 32)
        under += S.active(j) && (static_cast<float>(el[j]) < kn[K_SCALE_IN_L]);
      const int n_under = __reduce_add_sync(kAll, under);
      const int src = S.masked_argmin(el, [&](int j) { return S.active(j); });
      const int dst = S.masked_argmin(
          el, [&](int j) { return S.active(j) && j != src; });
      const int el_src = el[src], el_dst = el[dst];
      const bool fits =
          static_cast<float>(el_src + el_dst) <= kn[K_SCALE_IN_DEST];
      if (s.np > 1 && n_under >= 2 && fits) {           // scale in
        in_src = src;
        in_dst = dst;
        const int vc_src = vc[src];
        int* row_s = cm + static_cast<size_t>(src) * k;
        int* row_d = cm + static_cast<size_t>(dst) * k;
        const int a_dst = row_s[dst];   // [src][dst], rewritten below as [j][dst]
        const int ss = row_s[src];
        s.cut -= a_dst;
        __syncwarp();
        // merge_cut_matrix: row src into row dst and column src into
        // column dst (each entry read and written by one lane, kStrides
        // strides read before any is written), then row and column src
        // cleared
        for (int j0 = lane; j0 < k; j0 += 32 * kStrides) {
          int a[kStrides], rd[kStrides], cd[kStrides];
#pragma unroll
          for (int u = 0; u < kStrides; ++u) {
            const int j = j0 + 32 * u;
            if (j < k) {
              a[u] = j == dst ? a_dst : row_s[j];
              rd[u] = row_d[j];
              cd[u] = cm[static_cast<size_t>(j) * k + dst];
            }
          }
#pragma unroll
          for (int u = 0; u < kStrides; ++u) {
            const int j = j0 + 32 * u;
            if (j < k && j == dst) {
              row_d[dst] = rd[u] + a[u] + a[u] + ss;
            } else if (j < k) {
              row_d[j] = rd[u] + a[u];
              cm[static_cast<size_t>(j) * k + dst] = cd[u] + a[u];
            }
          }
        }
        __syncwarp();
        for (int j = lane; j < k; j += 32) {
          row_s[j] = 0;
          cm[static_cast<size_t>(j) * k + src] = 0;
        }
        for (int j = lane; j <= i; j += 32)
          if (w_label[j] == src) w_label[j] = dst;
        for (int j = lane; j < k; j += 32)
          if (remap[j] == src) remap[j] = dst;
        if (lane == 0) {
          el[dst] += el_src;
          vc[dst] += vc_src;
          el[src] = 0;
          vc[src] = 0;
          act[src >> 5] &= ~(1u << (src & 31));
        }
        s.np -= 1;
        s.scale += 1;
      }
    }
    __syncwarp();
    for (int j = lane; j < k; j += 32) sc[j] = 0;   // the buffer of slot i + 2
    publish(decided, i + 1);              // labels, cut matrix settled
  }

  for (int j = lane; j < w; j += 32) w_label_out[j] = w_label[j];
  for (int j = lane; j < k; j += 32) {
    remap_out[j] = remap[j];
    active_out[j] = S.active(j) ? 1 : 0;
    loads_out[j] = el[j];
    loads_out[k + j] = vc[j];
  }
  if (lane == 0) {
    scal_out[S_NP] = s.np;
    scal_out[S_TOTAL] = s.total;
    scal_out[S_CUT] = s.cut;
    scal_out[S_DENIED] = s.denied;
    scal_out[S_SCALE] = s.scale;
  }
}

template <int POLICY, bool ALG1>
__global__ void __launch_bounds__(kThreads)
fused_chooser_large_kernel(
    const int* __restrict__ ev, const int* __restrict__ src_lbl,
    const int* __restrict__ touch, const int* __restrict__ rand_tab,
    const int* __restrict__ active_in, const int* __restrict__ el_in,
    const int* __restrict__ vc_in, const int* __restrict__ scal_in,
    const float* __restrict__ knobs, int* __restrict__ w_label_out,
    int* __restrict__ psel_out, int* __restrict__ remap_out,
    int* __restrict__ active_out, int* __restrict__ loads_out,
    int* cm, int* __restrict__ scal_out, int w, int d, int k,
    int autoscaling) {
  fused_chooser_large_body<POLICY, ALG1>(
      ev, src_lbl, touch, rand_tab, active_in, el_in, vc_in, scal_in, knobs,
      w_label_out, psel_out, remap_out, active_out, loads_out, cm, scal_out,
      w, d, k, autoscaling);
}

// ---------------------------------------------------------------------------
// The sweep form (the traced-policy form of the Pallas kernel,
// fused_chooser.py:199-216 with policy=None): one window of each of L sweep
// lanes in one launch, lane b on block b. A lane's arrays are its slice of
// the (L, ...) inputs and outputs; its policy and scale gate are its row of
// lane_flags (L, 2) = [policy, gate], read once at block entry, and the block
// runs that policy's instantiation of the single-session body — the same
// code, so each policy keeps its exact arithmetic. A lane scales out and in
// where dynamic && gate (JAX's gate_dv = dv_i & do_scale). W, D, K and the
// balance guard are shared by every lane (the sweep requires one k_max and
// one balance_guard), so one layout and one ALG1 serve the whole launch. A
// block's work and shared memory are the single-session kernel's, so up to
// one lane per SM (132) a launch takes about the slowest lane's time.
// ---------------------------------------------------------------------------

template <int P>
struct PolicyTag {
  static constexpr int value = P;
};

// f(PolicyTag<policy>{}) for a policy read at run time: one instantiation of
// the body per policy, the block taking the one its lane names
template <typename F>
__device__ __forceinline__ void with_policy(int policy, F&& f) {
  switch (policy) {
    case kSdp: f(PolicyTag<kSdp>{}); break;
    case kLdg: f(PolicyTag<kLdg>{}); break;
    case kFennel: f(PolicyTag<kFennel>{}); break;
    case kHash: f(PolicyTag<kHash>{}); break;
    case kRandom: f(PolicyTag<kRandom>{}); break;
    case kGreedy: f(PolicyTag<kGreedy>{}); break;
    default: __trap();                    // names no policy: fail the launch
  }
}

template <bool ALG1, int KT>
__global__ void __launch_bounds__(kThreads)
fused_chooser_sweep_kernel(
    const int* __restrict__ ev, const int* __restrict__ src_lbl,
    const int* __restrict__ touch, const int* __restrict__ rand_tab,
    const int* __restrict__ active_in, const int* __restrict__ el_in,
    const int* __restrict__ vc_in, const int* __restrict__ cm_in,
    const int* __restrict__ scal_in, const float* __restrict__ knobs,
    const int* __restrict__ lane_flags, int* __restrict__ w_label_out,
    int* __restrict__ psel_out, int* __restrict__ remap_out,
    int* __restrict__ active_out, int* __restrict__ loads_out,
    int* __restrict__ cm_out, int* __restrict__ scal_out, int w, int d, int k,
    int dynamic) {
  const size_t b = blockIdx.x;
  const size_t sw = w, sd = d, sk = k;
  const int autoscaling = dynamic && lane_flags[2 * b + 1] != 0;
  with_policy(lane_flags[2 * b], [&](auto tag) {
    fused_chooser_body<decltype(tag)::value, ALG1, KT>(
        ev + b * sw * EV_COLS, src_lbl + b * sw * sd, touch + b * sw * sd,
        rand_tab + b * sw * sk, active_in + b * sk, el_in + b * sk,
        vc_in + b * sk, cm_in + b * sk * sk, scal_in + b * SCAL_N,
        knobs + b * KNOB_N, w_label_out + b * sw, psel_out + b * sw,
        remap_out + b * sk, active_out + b * sk, loads_out + b * 2 * sk,
        cm_out + b * sk * sk, scal_out + b * SCAL_N, w, d, k, autoscaling);
  });
}

// The large-K sweep form: cm is the (L, K, K) output, copied from the input
// by the launch and updated in place, each lane's block its own slice.
template <bool ALG1>
__global__ void __launch_bounds__(kThreads)
fused_chooser_large_sweep_kernel(
    const int* __restrict__ ev, const int* __restrict__ src_lbl,
    const int* __restrict__ touch, const int* __restrict__ rand_tab,
    const int* __restrict__ active_in, const int* __restrict__ el_in,
    const int* __restrict__ vc_in, const int* __restrict__ scal_in,
    const float* __restrict__ knobs, const int* __restrict__ lane_flags,
    int* __restrict__ w_label_out, int* __restrict__ psel_out,
    int* __restrict__ remap_out, int* __restrict__ active_out,
    int* __restrict__ loads_out, int* cm, int* __restrict__ scal_out, int w,
    int d, int k, int dynamic) {
  const size_t b = blockIdx.x;
  const size_t sw = w, sd = d, sk = k;
  const int autoscaling = dynamic && lane_flags[2 * b + 1] != 0;
  with_policy(lane_flags[2 * b], [&](auto tag) {
    fused_chooser_large_body<decltype(tag)::value, ALG1>(
        ev + b * sw * EV_COLS, src_lbl + b * sw * sd, touch + b * sw * sd,
        rand_tab + b * sw * sk, active_in + b * sk, el_in + b * sk,
        vc_in + b * sk, scal_in + b * SCAL_N, knobs + b * KNOB_N,
        w_label_out + b * sw, psel_out + b * sw, remap_out + b * sk,
        active_out + b * sk, loads_out + b * 2 * sk, cm + b * sk * sk,
        scal_out + b * SCAL_N, w, d, k, autoscaling);
  });
}

// ---------------------------------------------------------------------------
// The pure-ADD window's fixup: the slot loop of an ADD-only window, the
// reference's lax.scan at src/repro/core/windowed.py:138-169 (no Pallas
// kernel; the port ran it as a Python loop of ~40 torch ops a slot).
// partition_affinity has scored every slot against the window-start state;
// slot i then adds its neighbours among the window's earlier slots
// (win_pos[i, d] < i): each counts in its degree, and under its label if its
// slot committed one. Scale-out before every ADD (pads skip it), the policy
// and the merge for a fresh one; no deletions and no scale-in. A pad or a
// vertex present at the window's start commits nothing, so the decider
// skips its histogram and choice. Two kernels, chosen by K on the host
// (fused_chooser.add_dispatch):
//
// * add_lanes_kernel (add_window_lanes_launch, K <= 192): the lanes
//   kernel's structure and device code — the decider warp's K-vectors on
//   its lanes (load_state, scale_out, choose, merge_slot), the cut matrix
//   in shared memory — fed by the two producer warps of produce_adds: one
//   loads slot s's win_pos row, score row, random row and scalars while the
//   decider decides s - 1, then, once slots <= s - 2 are final, stores the
//   score row into the slot's buffer and counts the earlier slots' labels
//   from w_assign into it, leaving out the entries at position s - 1 — the
//   decider adds those under slot s - 1's label, if it committed one. The
//   degree needs no label, so the producer counts it whole.
// * add_window_kernel (add_window_launch, any K whose vectors fit): one
//   decider warp on the large-K kernel's layout — the K-vectors in shared
//   memory, the cut matrix in device memory (cm_out, copied from the input
//   by the launch) — and its device code (wide::scale_out, wide::choose,
//   wide::merge_slot); it counts each slot's row itself.
//
// Bound: a latency chain of W dependent slots (slot i reads the labels
// earlier slots chose); its bytes, W (K + 2 D + 3) + K (K + 3) ints read and
// written once, are far below a microsecond of HBM time. An estimate, not
// measured: the lanes kernel's chain a committing slot is the fused
// chooser's (~490 cycles: the slot's flag, its histogram, the choice, the
// merge; see the note at the top), ~125,000 cycles = 0.063 ms a window of
// 256 at 1.98 GHz; a slot that commits nothing costs its flag's round trip
// (~100 cycles). Shared memory: the lanes kernel 4 (32 + W + 5 K + K (K +
// 1)) bytes, the large one 4 (W + 4 K + ceil(K / 32)).
// ---------------------------------------------------------------------------

size_t add_smem_bytes(int w, int k) {
  return sizeof(int) * (static_cast<size_t>(w) + 4 * static_cast<size_t>(k)
                        + (k + 31) / 32);
}

template <int POLICY, bool ALG1>
__global__ void __launch_bounds__(32)
add_window_kernel(const int* __restrict__ scores_c, const int* __restrict__ deg_c,
                  const int* __restrict__ win_pos,
                  const unsigned char* __restrict__ fresh_c,
                  const int* __restrict__ vs, const int* __restrict__ rand_tab,
                  const int* __restrict__ active_in, const int* __restrict__ el_in,
                  const int* __restrict__ vc_in, const int* __restrict__ scal_in,
                  const float* __restrict__ knobs, int* __restrict__ w_assign_out,
                  int* __restrict__ active_out, int* __restrict__ loads_out,
                  int* cm, int* __restrict__ scal_out, int w, int d, int k,
                  int autoscaling) {
  const int lane = threadIdx.x;
  const int nw = (k + 31) >> 5;
  extern __shared__ int smem[];
  int* w_assign = smem;                                   // [w]
  int* sc = w_assign + w;                                 // [k] slot histogram
  float* stage = reinterpret_cast<float*>(sc + k);        // [k]
  int* el = sc + 2 * k;                                   // [k]
  int* vc = el + k;                                       // [k]
  unsigned* act = reinterpret_cast<unsigned*>(vc + k);    // [nw]
  for (int j = lane; j < w; j += 32) w_assign[j] = -1;
  for (int j = lane; j < k; j += 32) {
    sc[j] = 0;
    el[j] = el_in[j];
    vc[j] = vc_in[j];
  }
  for (int t = lane; t < nw; t += 32) {
    unsigned bits = 0;
    for (int b = 0; b < 32 && 32 * t + b < k; ++b)
      bits |= (active_in[32 * t + b] != 0 ? 1u : 0u) << b;
    act[t] = bits;
  }
  __syncwarp();
  const wide::Wide S{lane, k, nw, el, vc, act, stage};
  wide::Scalars s{scal_in[S_NP], scal_in[S_TOTAL], scal_in[S_CUT],
                  scal_in[S_DENIED], scal_in[S_SCALE]};
  float kn[KNOB_N];
#pragma unroll
  for (int j = 0; j < KNOB_N; ++j) kn[j] = knobs[j];

  for (int i = 0; i < w; ++i) {
    const int vi = __ldg(vs + i);
    // the reference scales out before every ADD (pads skip it)
    if (autoscaling && vi >= 0) wide::scale_out(S, s, kn);
    if (!__ldg(fresh_c + i)) continue;                // warp-uniform
    const int* wp = win_pos + static_cast<size_t>(i) * d;
    int intra = 0;
    for (int j = lane; j < d; j += 32) {
      const int pos = __ldg(wp + j);
      if (pos >= 0 && pos < i) {
        ++intra;
        const int lab = w_assign[pos];
        if (lab >= 0) atomicAdd(&sc[lab], 1);
      }
    }
    const int deg = __ldg(deg_c + i) + __reduce_add_sync(kAll, intra);
    __syncwarp();
    const int* srow = scores_c + static_cast<size_t>(i) * k;
    for (int j = lane; j < k; j += 32) sc[j] += __ldg(srow + j);
    __syncwarp();
    const int np1 = s.np > 1 ? s.np : 1;
    const int ridx = __ldg(rand_tab + static_cast<size_t>(i) * k + np1 - 1);
    const int p = wide::choose<POLICY, ALG1>(S, sc, s, deg, vi, ridx, kn);
    wide::merge_slot(S, sc, s, cm, p, deg, 1, 0, 0, 0, 0);
    if (lane == 0) w_assign[i] = p;
    __syncwarp();                       // el, vc, cm and w_assign settled
    for (int j = lane; j < k; j += 32) sc[j] = 0;
    __syncwarp();
  }

  __syncwarp();
  for (int j = lane; j < w; j += 32) w_assign_out[j] = w_assign[j];
  for (int j = lane; j < k; j += 32) {
    active_out[j] = S.active(j) ? 1 : 0;
    loads_out[j] = el[j];
    loads_out[k + j] = vc[j];
  }
  if (lane == 0) {
    scal_out[S_NP] = s.np;
    scal_out[S_TOTAL] = s.total;
    scal_out[S_CUT] = s.cut;
    scal_out[S_DENIED] = s.denied;
    scal_out[S_SCALE] = s.scale;
  }
}

// The pure-ADD lanes kernel's producer warps (threads 32..95): producer p
// takes slots p, p + 2, ... Slot s's scalars, score row, random row and
// first kBatch rounds of win_pos are loaded before it waits for slots up to
// s - 2 to be final; then, for a fresh slot, the score row goes into the
// slot's buffer and the labels of its neighbours at positions < s - 1 are
// counted into it (shared atomics), the neighbours at s - 1 only counted.
template <int KT>
__device__ __forceinline__ void produce_adds(
    const int* __restrict__ scores_c, const int* __restrict__ deg_c,
    const int* __restrict__ win_pos, const unsigned char* __restrict__ fresh_c,
    const int* __restrict__ vs, const int* __restrict__ rand_tab, int* flags,
    int* ev_s, const int* w_assign, int* hist, int* rand_s, int w, int d,
    int k) {
  const int lane = threadIdx.x & 31;
  const int producer = (threadIdx.x >> 5) - 1;    // 0 or 1
  int* decided = flags;
  int* ready = flags + 1;
  for (int sl = producer; sl < w; sl += 2) {
    const int buf = sl & 1;
    int* h = hist + buf * k;
    const size_t rk = static_cast<size_t>(sl) * k;
    const int* wp = win_pos + static_cast<size_t>(sl) * d;
    const int fresh = __ldg(fresh_c + sl);
    const int vv = __ldg(vs + sl);
    const int dg = __ldg(deg_c + sl);
    int rv[KT], sv[KT];
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      const int j = lane + 32 * t;
      rv[t] = j < k ? __ldg(rand_tab + rk + j) : 0;
      sv[t] = j < k ? __ldg(scores_c + rk + j) : 0;
    }
    int intra = 0, pend = 0;
    for (int j0 = 0; j0 < d; j0 += 32 * kBatch) {
      int pos[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        pos[b] = __ldg(wp + min(j0 + 32 * b + lane, d - 1));
      if (j0 == 0) {
        wait_flag(decided, sl - 1);               // slots <= sl - 2 final
#pragma unroll
        for (int t = 0; t < KT; ++t)
          if (fresh && lane + 32 * t < k) h[lane + 32 * t] = sv[t];
        __syncwarp();
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const bool in = j0 + 32 * b + lane < d && pos[b] >= 0 && pos[b] < sl;
        intra += in;
        if (in && fresh && pos[b] == sl - 1) {
          ++pend;
        } else if (in && fresh) {
          const int lab = w_assign[pos[b]];
          if (lab >= 0) atomicAdd(&h[lab], 1);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < KT; ++t)
      if (lane + 32 * t < k) rand_s[buf * k + lane + 32 * t] = rv[t];
    intra = __reduce_add_sync(kAll, intra);
    pend = __reduce_add_sync(kAll, pend);
    if (lane == 0) {
      int* e = ev_s + buf * kEvPad;
      e[0] = vv;
      e[1] = fresh;
      e[2] = dg + intra;
      e[3] = pend;
    }
    publish(ready + buf, sl + 1);
  }
}

template <int POLICY, bool ALG1, int KT>
__global__ void __launch_bounds__(kThreads)
add_lanes_kernel(const int* __restrict__ scores_c, const int* __restrict__ deg_c,
                 const int* __restrict__ win_pos,
                 const unsigned char* __restrict__ fresh_c,
                 const int* __restrict__ vs, const int* __restrict__ rand_tab,
                 const int* __restrict__ active_in, const int* __restrict__ el_in,
                 const int* __restrict__ vc_in, const int* __restrict__ cm_in,
                 const int* __restrict__ scal_in, const float* __restrict__ knobs,
                 int* __restrict__ w_assign_out, int* __restrict__ active_out,
                 int* __restrict__ loads_out, int* __restrict__ cm_out,
                 int* __restrict__ scal_out, int w, int d, int k,
                 int autoscaling) {
  const int lane = threadIdx.x & 31;
  const int ks = k + 1;                   // cut-matrix row stride (banks)
  extern __shared__ int smem[];
  int* flags = smem;                      // [decided, ready x2, -]
  int* ev_s = smem + 8;                   // [2][kEvPad] vs, fresh, deg, pend
  int* w_assign = ev_s + 2 * kEvPad;      // [w]
  int* hist = w_assign + w;               // [2][k] two slots' score rows
  int* rand_s = hist + 2 * k;             // [2][k] two slots' random rows
  float* stage = reinterpret_cast<float*>(rand_s + 2 * k);   // [k]
  int* cm = rand_s + 3 * k;               // [k][ks]
  for (int j = threadIdx.x; j < w; j += kThreads) w_assign[j] = -1;
  for (int j = threadIdx.x; j < k * k; j += kThreads) {
    const int r = j / k;
    cm[r * ks + (j - r * k)] = cm_in[j];
  }
  if (threadIdx.x < 8) flags[threadIdx.x] = 0;
  __syncthreads();                        // the only block barrier

  if (threadIdx.x >= 32) {
    produce_adds<KT>(scores_c, deg_c, win_pos, fresh_c, vs, rand_tab, flags,
                     ev_s, w_assign, hist, rand_s, w, d, k);
    return;
  }

  // The decider warp.
  const Lanes<KT> L{lane, k};
  State<KT> s;
  load_state(L, s, active_in, el_in, vc_in, scal_in);
  float kn[KNOB_N];
#pragma unroll
  for (int j = 0; j < KNOB_N; ++j) kn[j] = knobs[j];
  int* decided = flags;
  int* ready = flags + 1;

  for (int i = 0; i < w; ++i) {
    const int buf = i & 1;
    wait_flag(ready + buf, i + 1);
    const int* e = ev_s + buf * kEvPad;
    const int vi = e[0];
    // the reference scales out before every ADD (pads skip it)
    if (autoscaling && vi >= 0) scale_out(L, s, kn);
    if (e[1]) {                                        // a fresh ADD
      const int deg = e[2];
      const int n_pend = e[3];
      const int* h = hist + buf * k;
#pragma unroll
      for (int t = 0; t < KT; ++t) s.sc[t] = L.real(t) ? h[lane + 32 * t] : 0;
      if (n_pend) {            // the neighbours at slot i - 1, under its label
        const int lab = w_assign[i - 1];
#pragma unroll
        for (int t = 0; t < KT; ++t)
          if (lane + 32 * t == lab) s.sc[t] += n_pend;
      }
      const int np1 = s.np > 1 ? s.np : 1;
      const int ridx = rand_s[buf * k + np1 - 1];
      const int p = choose<POLICY, ALG1, KT>(L, s, stage, deg, vi, ridx, kn);
      merge_slot(L, s, cm, ks, p, deg, 1, 0, 0, 0, 0);
      if (lane == 0) w_assign[i] = p;
    }
    publish(decided, i + 1);              // w_assign, cut matrix settled
  }

  for (int j = lane; j < w; j += 32) w_assign_out[j] = w_assign[j];
  store_state(L, s, cm, ks, active_out, loads_out, cm_out, scal_out);
}

size_t smem_bytes(int w, int k) {
  const size_t kk = static_cast<size_t>(k);
  return sizeof(int) * (8 + 2 * kEvPad + static_cast<size_t>(w) + 6 * kk
                        + kk * (kk + 1));
}

template <int POLICY, bool ALG1, int KT>
cudaError_t launch(const int* ev, const int* src_lbl, const int* touch,
                   const int* rand_tab, const int* active, const int* el,
                   const int* vc, const int* cm, const int* scal,
                   const float* knobs, int* w_label, int* psel, int* remap,
                   int* active_out, int* loads, int* cm_out, int* scal_out,
                   int w, int d, int k, int autoscaling, cudaStream_t stream) {
  auto kernel = fused_chooser_kernel<POLICY, ALG1, KT>;
  const size_t smem = smem_bytes(w, k);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<1, kThreads, smem, stream>>>(ev, src_lbl, touch, rand_tab, active, el,
                                  vc, cm, scal, knobs, w_label, psel, remap,
                                  active_out, loads, cm_out, scal_out, w, d, k,
                                  autoscaling);
  return cudaGetLastError();
}

template <int POLICY, bool ALG1>
cudaError_t launch_k(const int* ev, const int* src_lbl, const int* touch,
                     const int* rand_tab, const int* active, const int* el,
                     const int* vc, const int* cm, const int* scal,
                     const float* knobs, int* w_label, int* psel, int* remap,
                     int* active_out, int* loads, int* cm_out, int* scal_out,
                     int w, int d, int k, int autoscaling, cudaStream_t stream) {
  if (k > 32 * kMaxKt) return cudaErrorInvalidValue;
  return (k <= 32 ? launch<POLICY, ALG1, 1> : launch<POLICY, ALG1, kMaxKt>)(
      ev, src_lbl, touch, rand_tab, active, el, vc, cm, scal, knobs, w_label,
      psel, remap, active_out, loads, cm_out, scal_out, w, d, k, autoscaling,
      stream);
}

size_t large_smem_bytes(int w, int k) {
  return sizeof(int) * (8 + 2 * kEvPad + static_cast<size_t>(w)
                        + 6 * static_cast<size_t>(k) + (k + 31) / 32);
}

template <int POLICY, bool ALG1>
cudaError_t launch_large(const int* ev, const int* src_lbl, const int* touch,
                         const int* rand_tab, const int* active, const int* el,
                         const int* vc, const int* cm, const int* scal,
                         const float* knobs, int* w_label, int* psel,
                         int* remap, int* active_out, int* loads, int* cm_out,
                         int* scal_out, int w, int d, int k, int autoscaling,
                         cudaStream_t stream) {
  auto kernel = fused_chooser_large_kernel<POLICY, ALG1>;
  const size_t smem = large_smem_bytes(w, k);
  if (k <= 0 || smem > kSmemMax) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  // the kernel updates the cut matrix in place, in the output
  const cudaError_t err = cudaMemcpyAsync(
      cm_out, cm, sizeof(int) * static_cast<size_t>(k) * k,
      cudaMemcpyDeviceToDevice, stream);
  if (err != cudaSuccess) return err;
  kernel<<<1, kThreads, smem, stream>>>(ev, src_lbl, touch, rand_tab, active,
                                        el, vc, scal, knobs, w_label, psel,
                                        remap, active_out, loads, cm_out,
                                        scal_out, w, d, k, autoscaling);
  return cudaGetLastError();
}

template <int POLICY, bool ALG1>
cudaError_t launch_add(const int* scores_c, const int* deg_c,
                       const int* win_pos, const unsigned char* fresh_c,
                       const int* vs, const int* rand_tab, const int* active,
                       const int* el, const int* vc, const int* cm,
                       const int* scal, const float* knobs, int* w_assign,
                       int* active_out, int* loads, int* cm_out,
                       int* scal_out, int w, int d, int k, int autoscaling,
                       cudaStream_t stream) {
  auto kernel = add_window_kernel<POLICY, ALG1>;
  const size_t smem = add_smem_bytes(w, k);
  if (w <= 0 || k <= 0 || smem > kSmemMax) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  // the kernel updates the cut matrix in place, in the output
  const cudaError_t err = cudaMemcpyAsync(
      cm_out, cm, sizeof(int) * static_cast<size_t>(k) * k,
      cudaMemcpyDeviceToDevice, stream);
  if (err != cudaSuccess) return err;
  kernel<<<1, 32, smem, stream>>>(scores_c, deg_c, win_pos, fresh_c, vs,
                                  rand_tab, active, el, vc, scal, knobs,
                                  w_assign, active_out, loads, cm_out,
                                  scal_out, w, d, k, autoscaling);
  return cudaGetLastError();
}

size_t add_lanes_smem_bytes(int w, int k) {
  const size_t kk = static_cast<size_t>(k);
  return sizeof(int) * (8 + 2 * kEvPad + static_cast<size_t>(w) + 5 * kk
                        + kk * (kk + 1));
}

template <int POLICY, bool ALG1, int KT>
cudaError_t launch_add_lanes_kt(const int* scores_c, const int* deg_c,
                                const int* win_pos,
                                const unsigned char* fresh_c, const int* vs,
                                const int* rand_tab, const int* active,
                                const int* el, const int* vc, const int* cm,
                                const int* scal, const float* knobs,
                                int* w_assign, int* active_out, int* loads,
                                int* cm_out, int* scal_out, int w, int d,
                                int k, int autoscaling, cudaStream_t stream) {
  auto kernel = add_lanes_kernel<POLICY, ALG1, KT>;
  const size_t smem = add_lanes_smem_bytes(w, k);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<1, kThreads, smem, stream>>>(scores_c, deg_c, win_pos, fresh_c, vs,
                                        rand_tab, active, el, vc, cm, scal,
                                        knobs, w_assign, active_out, loads,
                                        cm_out, scal_out, w, d, k,
                                        autoscaling);
  return cudaGetLastError();
}

template <int POLICY, bool ALG1>
cudaError_t launch_add_lanes(const int* scores_c, const int* deg_c,
                             const int* win_pos, const unsigned char* fresh_c,
                             const int* vs, const int* rand_tab,
                             const int* active, const int* el, const int* vc,
                             const int* cm, const int* scal,
                             const float* knobs, int* w_assign,
                             int* active_out, int* loads, int* cm_out,
                             int* scal_out, int w, int d, int k,
                             int autoscaling, cudaStream_t stream) {
  if (w <= 0 || d <= 0 || k <= 0 || k > 32 * kMaxKt
      || add_lanes_smem_bytes(w, k) > kSmemMax)
    return cudaErrorInvalidValue;
  return (k <= 32 ? launch_add_lanes_kt<POLICY, ALG1, 1>
                  : launch_add_lanes_kt<POLICY, ALG1, kMaxKt>)(
      scores_c, deg_c, win_pos, fresh_c, vs, rand_tab, active, el, vc, cm,
      scal, knobs, w_assign, active_out, loads, cm_out, scal_out, w, d, k,
      autoscaling, stream);
}

#define SWEEP_PARAMS                                                          \
  const int *ev, const int *src_lbl, const int *touch, const int *rand_tab,  \
      const int *active, const int *el, const int *vc, const int *cm,        \
      const int *scal, const float *knobs, const int *lane_flags,            \
      int *w_label, int *psel, int *remap, int *active_out, int *loads,      \
      int *cm_out, int *scal_out, int lanes, int w, int d, int k,            \
      int dynamic, cudaStream_t stream
#define SWEEP_ARGS ev, src_lbl, touch, rand_tab, active, el, vc, cm, scal,   \
                   knobs, lane_flags, w_label, psel, remap, active_out,      \
                   loads, cm_out, scal_out, lanes, w, d, k, dynamic, stream

template <bool ALG1, int KT>
cudaError_t launch_sweep_kt(SWEEP_PARAMS) {
  auto kernel = fused_chooser_sweep_kernel<ALG1, KT>;
  const size_t smem = smem_bytes(w, k);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<lanes, kThreads, smem, stream>>>(
      ev, src_lbl, touch, rand_tab, active, el, vc, cm, scal, knobs,
      lane_flags, w_label, psel, remap, active_out, loads, cm_out, scal_out,
      w, d, k, dynamic);
  return cudaGetLastError();
}

template <bool ALG1>
cudaError_t launch_sweep(SWEEP_PARAMS) {
  if (lanes <= 0 || k <= 0 || k > 32 * kMaxKt || smem_bytes(w, k) > kSmemMax)
    return cudaErrorInvalidValue;
  return (k <= 32 ? launch_sweep_kt<ALG1, 1>
                  : launch_sweep_kt<ALG1, kMaxKt>)(SWEEP_ARGS);
}

template <bool ALG1>
cudaError_t launch_large_sweep(SWEEP_PARAMS) {
  auto kernel = fused_chooser_large_sweep_kernel<ALG1>;
  const size_t smem = large_smem_bytes(w, k);
  if (lanes <= 0 || k <= 0 || smem > kSmemMax) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  // every lane's cut matrix is updated in place, in the output: one copy
  const cudaError_t err = cudaMemcpyAsync(
      cm_out, cm,
      sizeof(int) * static_cast<size_t>(lanes) * static_cast<size_t>(k) * k,
      cudaMemcpyDeviceToDevice, stream);
  if (err != cudaSuccess) return err;
  kernel<<<lanes, kThreads, smem, stream>>>(
      ev, src_lbl, touch, rand_tab, active, el, vc, scal, knobs, lane_flags,
      w_label, psel, remap, active_out, loads, cm_out, scal_out, w, d, k,
      dynamic);
  return cudaGetLastError();
}

}  // namespace

#define FUSED_ARGS ev, src_lbl, touch, rand_tab, active, el, vc, cm, scal, knobs, \
                   w_label, psel, remap, active_out, loads, cm_out, scal_out,     \
                   w, d, k, autoscaling, stream

#define POLICY_SWITCH(LAUNCH, ARGS)                                           \
  switch (policy * 2 + (alg1 ? 1 : 0)) {                                      \
    case kSdp * 2: return static_cast<int>(LAUNCH<kSdp, false>(ARGS));        \
    case kSdp * 2 + 1: return static_cast<int>(LAUNCH<kSdp, true>(ARGS));     \
    case kLdg * 2: return static_cast<int>(LAUNCH<kLdg, false>(ARGS));        \
    case kLdg * 2 + 1: return static_cast<int>(LAUNCH<kLdg, true>(ARGS));     \
    case kFennel * 2:                                                         \
      return static_cast<int>(LAUNCH<kFennel, false>(ARGS));                  \
    case kFennel * 2 + 1:                                                     \
      return static_cast<int>(LAUNCH<kFennel, true>(ARGS));                   \
    case kHash * 2: return static_cast<int>(LAUNCH<kHash, false>(ARGS));      \
    case kHash * 2 + 1:                                                       \
      return static_cast<int>(LAUNCH<kHash, true>(ARGS));                     \
    case kRandom * 2:                                                         \
      return static_cast<int>(LAUNCH<kRandom, false>(ARGS));                  \
    case kRandom * 2 + 1:                                                     \
      return static_cast<int>(LAUNCH<kRandom, true>(ARGS));                   \
    case kGreedy * 2:                                                         \
      return static_cast<int>(LAUNCH<kGreedy, false>(ARGS));                  \
    case kGreedy * 2 + 1:                                                     \
      return static_cast<int>(LAUNCH<kGreedy, true>(ARGS));                   \
    default: return static_cast<int>(cudaErrorInvalidValue);                  \
  }

// The most partition slots the lanes kernel takes (K <= 192).
extern "C" int fused_chooser_max_k() { return 32 * kMaxKt; }

// The most partition slots the large-K kernel takes at a window of w slots:
// its shared memory, 4 (32 + w + 6 K + ceil(K / 32)) bytes, within the
// 232,448 a block can have.
extern "C" int fused_chooser_large_max_k(int w) {
  int k = 0;
  while (large_smem_bytes(w, k + 1) <= kSmemMax) ++k;
  return k;
}

// The window's slot loop in the lanes kernel (K <= 192).
extern "C" int fused_chooser_launch(
    const int* ev, const int* src_lbl, const int* touch, const int* rand_tab,
    const int* active, const int* el, const int* vc, const int* cm,
    const int* scal, const float* knobs, int* w_label, int* psel, int* remap,
    int* active_out, int* loads, int* cm_out, int* scal_out, int w, int d,
    int k, int policy, int alg1, int autoscaling, cudaStream_t stream) {
  POLICY_SWITCH(launch_k, FUSED_ARGS)
}

// The window's slot loop in the large-K kernel (any K up to
// fused_chooser_large_max_k(w)).
extern "C" int fused_chooser_large_launch(
    const int* ev, const int* src_lbl, const int* touch, const int* rand_tab,
    const int* active, const int* el, const int* vc, const int* cm,
    const int* scal, const float* knobs, int* w_label, int* psel, int* remap,
    int* active_out, int* loads, int* cm_out, int* scal_out, int w, int d,
    int k, int policy, int alg1, int autoscaling, cudaStream_t stream) {
  POLICY_SWITCH(launch_large, FUSED_ARGS)
}

#define ADD_ARGS scores_c, deg_c, win_pos, fresh_c, vs, rand_tab, active, el, vc, \
                 cm, scal, knobs, w_assign, active_out, loads, cm_out, scal_out, \
                 w, d, k, autoscaling, stream

// A pure-ADD window's fixup: committed scores (w, k) and degrees (w,), the
// window positions of the rows' neighbours (w, d), the fresh flags and
// subjects (w,), the random table (w, k), the window-start counters; out the
// slots' labels (w,) and the new counters, as fused_chooser_launch's. The
// large kernel, any K whose vectors fit its shared memory.
extern "C" int add_window_launch(
    const int* scores_c, const int* deg_c, const int* win_pos,
    const unsigned char* fresh_c, const int* vs, const int* rand_tab,
    const int* active, const int* el, const int* vc, const int* cm,
    const int* scal, const float* knobs, int* w_assign, int* active_out,
    int* loads, int* cm_out, int* scal_out, int w, int d, int k, int policy,
    int alg1, int autoscaling, cudaStream_t stream) {
  POLICY_SWITCH(launch_add, ADD_ARGS)
}

// The same fixup in the lanes kernel (K <= 192).
extern "C" int add_window_lanes_launch(
    const int* scores_c, const int* deg_c, const int* win_pos,
    const unsigned char* fresh_c, const int* vs, const int* rand_tab,
    const int* active, const int* el, const int* vc, const int* cm,
    const int* scal, const float* knobs, int* w_assign, int* active_out,
    int* loads, int* cm_out, int* scal_out, int w, int d, int k, int policy,
    int alg1, int autoscaling, cudaStream_t stream) {
  POLICY_SWITCH(launch_add_lanes, ADD_ARGS)
}

// The sweep form of the lanes kernel (K <= 192): one window of each of
// `lanes` sweep lanes, every input and output with a leading lane axis, and
// lane_flags (lanes, 2) = [policy, scale gate] per lane.
extern "C" int fused_chooser_sweep_launch(
    const int* ev, const int* src_lbl, const int* touch, const int* rand_tab,
    const int* active, const int* el, const int* vc, const int* cm,
    const int* scal, const float* knobs, const int* lane_flags, int* w_label,
    int* psel, int* remap, int* active_out, int* loads, int* cm_out,
    int* scal_out, int lanes, int w, int d, int k, int alg1, int dynamic,
    cudaStream_t stream) {
  return static_cast<int>(alg1 ? launch_sweep<true>(SWEEP_ARGS)
                               : launch_sweep<false>(SWEEP_ARGS));
}

// The sweep form of the large-K kernel (any K up to
// fused_chooser_large_max_k(w)).
extern "C" int fused_chooser_large_sweep_launch(
    const int* ev, const int* src_lbl, const int* touch, const int* rand_tab,
    const int* active, const int* el, const int* vc, const int* cm,
    const int* scal, const float* knobs, const int* lane_flags, int* w_label,
    int* psel, int* remap, int* active_out, int* loads, int* cm_out,
    int* scal_out, int lanes, int w, int d, int k, int alg1, int dynamic,
    cudaStream_t stream) {
  return static_cast<int>(alg1 ? launch_large_sweep<true>(SWEEP_ARGS)
                               : launch_large_sweep<false>(SWEEP_ARGS));
}
