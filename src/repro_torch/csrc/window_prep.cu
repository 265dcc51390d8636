// The mixed window's prep scan for Hopper (sm_90a): one block walks the W
// slots of a window in order — the choice-independent half of a mixed window
// (ref.prepare_window_ref in repro_torch/kernels/fused_chooser). Per slot it
// reads the subject's adjacency row, writes the slot's scalar row (event,
// subject, fresh / was / exists, the subjects' committed labels and last
// touching slots) and its (D,) tables of score-source labels and touch
// indices, then makes the faithful adjacency row writes in place.
//
// Ports no Pallas kernel: in the JAX package this is a lax.scan inside the
// jitted window program (src/repro/kernels/fused_chooser/ops.py:113,
// _prepare_window); the port ran it as a Python loop of ~30 torch ops a slot.
//
// * The block's threads split the D columns: column c is always thread
//   c % blockDim's, so every adjacency read and write of a column — the
//   subject's row, write 1 into it, write 2 into row u after write 1 (for a
//   self-loop u == v the same entry, read back by the thread that wrote it)
//   — stays inside one thread, in program order. No barrier is needed for
//   the adjacency.
// * Presence needs no O(n) copy: a vertex that a slot of this window touched
//   is present iff that last touching slot is an ADD; an untouched one has
//   its committed presence. last_touch (n, -1 on entry) is the output array
//   itself, and slot i's write to it is made while slot i + 1 runs (by thread
//   0): slot i + 1 takes that one pending value from registers, and the
//   write is visible to slot i + 2 past slot i + 1's barrier.
// * One barrier a slot: in_adj = any(own_row == u) is a block-wide OR
//   (__syncthreads_or), which also orders the slot's last_touch write before
//   the next slot's reads. The slot's scalar row is written after it.
//
// Bound: a latency chain of W dependent slots (slot i + 1 reads the adjacency
// and touch indices slot i wrote), each a few dependent global loads (the
// subject, its last touch, its row, the row's labels and touches) and one
// barrier; the bytes — W (2 + 9 + 3 D) ints and the adjacency rows read and
// written — are far below a microsecond of HBM time. An estimate, not
// measured: a slot's chain is the next slot's read of what this one wrote
// to last_touch and the adjacency, through the L2 (~270 cycles), past the
// barrier (~30), so ~300 cycles a slot: W = 256 slots ~77,000 cycles,
// ~0.039 ms at 1.98 GHz.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// per-slot scalar row layout (fused_chooser.EV_*)
enum Ev { EV_ET = 0, EV_V, EV_FRESH, EV_WAS, EV_EXISTS, EV_VLBL, EV_VTOUCH,
          EV_ULBL, EV_UTOUCH, EV_COLS };
constexpr int kEventAdd = 0;
constexpr int kEventDelVertex = 1;
constexpr int kEventDelEdge = 2;
constexpr int kEventPad = 3;
constexpr int kMaxThreads = 512;

__global__ void __launch_bounds__(kMaxThreads)
window_prep_kernel(const int* __restrict__ ets_in, const int* __restrict__ vs_in,
                   const int* __restrict__ rows, const int* __restrict__ label0,
                   const unsigned char* __restrict__ present0, int* adj,
                   int* last_touch, int* __restrict__ ev,
                   int* __restrict__ src_lbl, int* __restrict__ touch, int w,
                   int d) {
  extern __shared__ int smem[];
  int* et_s = smem;           // [w] event types, pad where the subject is -1
  int* v_s = et_s + w;        // [w] subjects, pads as vertex 0
  int* u_s = v_s + w;         // [w] the rows' first entries
  const int tid = threadIdx.x;
  for (int i = tid; i < w; i += blockDim.x) {
    const int v = vs_in[i];
    et_s[i] = v >= 0 ? ets_in[i] : kEventPad;
    v_s[i] = v >= 0 ? v : 0;
    u_s[i] = rows[static_cast<size_t>(i) * d];
  }
  __syncthreads();

  // slot i - 1's last_touch write, pending while slot i runs (pend_v < 0:
  // none)
  int pend_v = -1, pend_t = -1;
  auto last_touch_of = [&](int x) {
    return x == pend_v ? pend_t : last_touch[x];
  };
  auto present_of = [&](int x, int lt) {
    return lt >= 0 ? et_s[lt] == kEventAdd : present0[x] != 0;
  };

  for (int i = 0; i < w; ++i) {
    const int et = et_s[i], v = v_s[i], u = u_s[i];
    const int su = u > 0 ? u : 0;
    const bool add = et == kEventAdd;
    const bool dv = et == kEventDelVertex;
    const bool de = et == kEventDelEdge;
    if (tid == 0 && pend_v >= 0) last_touch[pend_v] = pend_t;
    const int lt_v = last_touch_of(v);
    const bool pv = present_of(v, lt_v);
    const bool fresh = add && !pv;

    const int* row = rows + static_cast<size_t>(i) * d;
    int* row_v = adj + static_cast<size_t>(v) * d;
    int* row_u = adj + static_cast<size_t>(su) * d;
    int* lbl_out = src_lbl + static_cast<size_t>(i) * d;
    int* touch_out = touch + static_cast<size_t>(i) * d;
    bool hit_any = false;
    for (int c = tid; c < d; c += blockDim.x) {
      const int own = row_v[c];                  // pre-event adjacency
      const int r = row[c];
      const bool hit = own == u && u >= 0;
      hit_any |= hit;
      // an ADD scores its event row, a DEL_VERTEX its own adjacency row
      const int src = add ? r : (dv ? own : -1);
      lbl_out[c] = src >= 0 ? label0[src] : -1;
      touch_out[c] = src >= 0 ? last_touch_of(src) : -1;
      // faithful adjacency row writes (windowed._window_mixed_lane)
      if (fresh || de) row_v[c] = add ? r : (hit ? -1 : own);
      if (de) {
        const int ru = row_u[c];                 // after write 1 (self-loops)
        row_u[c] = ru == v && u >= 0 ? -1 : ru;
      }
    }
    const bool in_adj = __syncthreads_or(hit_any) != 0;
    if (tid == 0) {
      const int lt_u = last_touch_of(su);
      const bool pu = present_of(su, lt_u);
      int* e = ev + static_cast<size_t>(i) * EV_COLS;
      e[EV_ET] = et;
      e[EV_V] = v;
      e[EV_FRESH] = fresh;
      e[EV_WAS] = dv && pv;
      e[EV_EXISTS] = de && pv && pu && in_adj;
      e[EV_VLBL] = label0[v];
      e[EV_VTOUCH] = lt_v;
      e[EV_ULBL] = label0[su];
      e[EV_UTOUCH] = lt_u;
    }
    // presence / touch updates (add and del_vertex touch the subject)
    pend_v = add || dv ? v : -1;
    pend_t = i;
  }
  if (tid == 0 && pend_v >= 0) last_touch[pend_v] = pend_t;
}

// the threads of the block for rows of d columns: a column each, up to 512
int threads_for(int d) {
  const int t = (d + 31) / 32 * 32;
  return t > kMaxThreads ? kMaxThreads : t;
}

}  // namespace

// One mixed window's prep scan: ets, vs (w,), rows (w, d), label0 and
// present0 (n,) in; adj (n, d) updated in place, last_touch (n,) filled with
// -1 by the caller and written; ev (w, 9), src_lbl and touch (w, d) out.
extern "C" int window_prep_launch(const int* ets, const int* vs,
                                  const int* rows, const int* label0,
                                  const unsigned char* present0, int* adj,
                                  int* last_touch, int* ev, int* src_lbl,
                                  int* touch, int w, int d,
                                  cudaStream_t stream) {
  if (w <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(int) * 3 * static_cast<size_t>(w);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        window_prep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  window_prep_kernel<<<1, threads_for(d), smem, stream>>>(
      ets, vs, rows, label0, present0, adj, last_touch, ev, src_lbl, touch, w,
      d);
  return static_cast<int>(cudaGetLastError());
}
