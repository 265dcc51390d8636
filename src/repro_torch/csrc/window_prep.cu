// The mixed window's prep scan for Hopper (sm_90a) — the choice-independent
// half of a mixed window (ref.prepare_window_ref in
// repro_torch/kernels/fused_chooser). Per slot it writes the scalar row
// (event, subject, fresh / was / exists, the subjects' committed labels and
// last touching slots) and the (D,) tables of score-source labels and touch
// indices; it makes the window's adjacency row writes in place, and writes
// the committed journal label0 and the final last_touch of every vertex.
//
// Ports no Pallas kernel: in the JAX package this is a lax.scan inside the
// jitted window program (src/repro/kernels/fused_chooser/ops.py:113,
// _prepare_window). Its row-block form (window_prep_rows_kernel, at the
// end) is round 1 of the vertex-sharded window, the shard-local scan of
// src/repro/runtime/shard_session.py:113-157: the same tables and chains,
// over one block of rows, writing the owner-masked emissions the mesh sums.
//
// The serial scan carries three things from slot to slot: presence,
// last_touch and the adjacency. The first two follow from the window's
// (event, subject) list alone, and each adjacency row is read and written
// only by the slots that name it. So the kernel runs one block per slot, and
// every block first builds the same tables from the event list in shared
// memory:
//
// * A hash table keyed by vertex (open addressing, 4 W entries or more, so
//   at most half full) holding, for the subjects of ADD and DEL_VERTEX
//   slots, the first and last such slot and their count. touch_before(x, i),
//   the last ADD / DEL_VERTEX slot before i whose subject is x, is then -1
//   (x absent, or its first touch >= i), its last touch (< i), its first
//   (exactly two touches and the last >= i), or else found by a scan down
//   from i - 1 that stops at the first touch. This is the serial scan's
//   last_touch[x] as it stood when slot i ran: that array is written at an
//   ADD or DEL_VERTEX slot and nowhere else.
// * Presence at slot i: x is present iff its last touch before i is an ADD,
//   and when no slot touched it, iff it was present at the window's start.
//   fresh = ADD and the subject absent, was = DEL_VERTEX and present.
// * The row chains. Row x is written by a fresh ADD of x (write 1: the event
//   row), a DEL_EDGE (v, u) with v = x (write 1: entries equal to u cleared)
//   and a DEL_EDGE with u = x != v (write 2: entries equal to v cleared; for
//   a self-loop write 2 follows write 1 into the same row and clears
//   nothing more), and read by a DEL_VERTEX of x (its score sources) and a
//   DEL_EDGE with v = x (in_adj). A DEL_EDGE with u = -1 writes its row
//   back unchanged and finds nothing, so it is no chain slot. Row x's chain
//   is those slots in order; the first of them owns the row. Its block loads
//   the row once (columns split over its threads, kCols a thread in
//   registers), walks the chain in slot order — each warp finds the slots
//   with a ballot over the slot list — and stores the row once if a slot
//   wrote it. Every write is column-wise (entry c of the new row depends on
//   entry c of the old one and the slot's event), so the threads need no
//   barrier; in_adj is the one reduction across the row, an OR that each
//   warp adds into shared memory, written out after the block's last
//   barrier.
//
// Why each output equals the serial scan's: ev's columns and the ADD slots'
// tables read only the event list, label0 (committed labels, which no slot
// writes) and last_touch as it stood before the slot (touch_before); a
// DEL_VERTEX's tables and a DEL_EDGE's in_adj read its row as the serial
// scan would, because the owner has applied exactly the row's earlier chain
// slots, in order, and no other slot writes that row; the final row is the
// chain's last state; last_touch[x] is x's last touch in the window (-1 if
// none) and label0[x] = present ? assignment : -1, both written once by a
// grid-stride loop. Pads and DEL_EDGEs with u = -1 have -1 tables. No output
// is written twice, and none is read by another block, so the blocks need
// no order among themselves.
//
// Bound: bytes. It must read the events, each slot's u and each ADD's row,
// the adjacency rows the chains own and the gathered labels, and write the
// tables (2 W D ints), the scalar rows and the two (n,) arrays
// (chip_smoke.py's _prep_bytes counts a window's; PERF.md has the twitter
// session's). An estimate of the time, not measured: one block's critical
// path is the event loads and the shared tables (~2,000 cycles), one round
// of row loads and one of label gathers (~1,000), and the chains (a global
// round per fresh ADD and DEL_VERTEX on them): ~4,000 cycles, ~2 us at
// 1.98 GHz, past a launch.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

// per-slot scalar row layout (fused_chooser.EV_*)
enum Ev { EV_ET = 0, EV_V, EV_FRESH, EV_WAS, EV_EXISTS, EV_VLBL, EV_VTOUCH,
          EV_ULBL, EV_UTOUCH, EV_COLS };
constexpr int kEventAdd = 0;
constexpr int kEventDelVertex = 1;
constexpr int kEventDelEdge = 2;
constexpr int kEventPad = 3;
constexpr int kMinThreads = 128;
constexpr int kMaxThreads = 512;
constexpr int kCols = 8;                // columns of a row a thread holds
constexpr unsigned kAll = 0xffffffffu;
constexpr size_t kSmemMax = 232448;     // shared memory a block can have
// per-slot flags: fresh, present subject, present u, a chain slot of row v,
// a chain slot of row u (!= v)
constexpr int F_FRESH = 1, F_PV = 2, F_PU = 4, F_CV = 8, F_CU = 16;
// a hash entry's count: touches in the low 16 bits, chain slots above
constexpr int kChainOne = 1 << 16;

// The window's tables in shared memory, the same in every block.
struct Window {
  int w, hbits;
  int* et;      // [w] event types, pad where the subject is -1
  int* v;       // [w] subjects, pads as vertex 0
  int* u;       // [w] the rows' first entries
  int* fl;      // [w] F_* flags
  int* hit;     // [w] in_adj of the DEL_EDGEs whose row v this block owns
  int* key;     // [H] vertex, -1 empty
  int* first;   // [H] first ADD / DEL_VERTEX slot of the vertex (INT_MAX)
  int* last;    // [H] last such slot (-1)
  int* cnt;     // [H] touches + kChainOne x chain slots
  int* head;    // [H] first chain slot of the vertex's row (INT_MAX)

  __device__ unsigned hash(int x) const {
    return (static_cast<unsigned>(x) * 2654435769u) >> (32 - hbits);
  }
  __device__ int insert(int x) const {
    const unsigned mask = (1u << hbits) - 1u;
    for (unsigned h = hash(x);; h = (h + 1u) & mask) {
      const int prev = atomicCAS(&key[h], -1, x);
      if (prev == -1 || prev == x) return static_cast<int>(h);
    }
  }
  __device__ int find(int x) const {
    const unsigned mask = (1u << hbits) - 1u;
    for (unsigned h = hash(x);; h = (h + 1u) & mask) {
      const int k = key[h];
      if (k == x) return static_cast<int>(h);
      if (k == -1) return -1;
    }
  }
  __device__ bool touches(int j) const {
    return et[j] == kEventAdd || et[j] == kEventDelVertex;
  }
  // the last ADD / DEL_VERTEX slot before i whose subject is x, -1 if none
  __device__ int touch_before(int x, int i) const {
    const int h = find(x);
    if (h < 0) return -1;
    const int f = first[h];
    if (f >= i) return -1;
    const int l = last[h];
    if (l < i) return l;
    if ((cnt[h] & (kChainOne - 1)) == 2) return f;
    for (int j = i - 1; j > f; --j)
      if (touches(j) && v[j] == x) return j;
    return f;
  }
  // a chain slot of row x
  __device__ bool in_chain(int j, int x) const {
    return ((fl[j] & F_CV) && v[j] == x) || ((fl[j] & F_CU) && u[j] == x);
  }
};

__device__ __forceinline__ int committed(const int* __restrict__ assign,
                                         const unsigned char* __restrict__ present0,
                                         int x) {
  const int a = __ldg(assign + x);
  return __ldg(present0 + x) ? a : -1;
}

// Row x's chain, walked by the block that owns it (its first chain slot is
// the block's slot i); the row is row ri of adj (x itself in the dense
// form, x - lo in the row-block form). A DEL_VERTEX slot scores
// its current row: the dense form writes the row's committed labels and
// touch indices (src_lbl, touch), the row-block form (kRows) the row itself,
// +2, into rows_dv (src_lbl's place; touch unused).
template <bool kRows>
__device__ void walk_chain(const Window& win, int x, int i, int d,
                           int* __restrict__ adj, int ri,
                           const int* __restrict__ rows,
                           const int* __restrict__ assign,
                           const unsigned char* __restrict__ present0,
                           int* __restrict__ src_lbl,
                           int* __restrict__ touch) {
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int steps = win.cnt[win.find(x)] / kChainOne;
  int* row_x = adj + static_cast<size_t>(ri) * d;
  for (int c0 = 0; c0 < d; c0 += nt * kCols) {
    int row[kCols];
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int c = c0 + tid + k * nt;
      row[k] = c < d ? row_x[c] : -1;
    }
    bool wrote = false;
    int left = steps;
    for (int base = i; left > 0; base += 32) {
      const int j = base + lane;
      unsigned m = __ballot_sync(kAll, j < win.w && win.in_chain(j, x));
      left -= __popc(m);
      for (; m; m &= m - 1u) {
        const int s = base + __ffs(m) - 1;
        const int es = win.et[s];
        const size_t off = static_cast<size_t>(s) * d;
        if (es == kEventAdd) {                 // a fresh ADD: its event row
#pragma unroll
          for (int k = 0; k < kCols; ++k) {
            const int c = c0 + tid + k * nt;
            row[k] = c < d ? __ldg(rows + off + c) : -1;
          }
          wrote = true;
        } else if (es == kEventDelVertex) {    // scores its current row
#pragma unroll
          for (int k = 0; k < kCols; ++k) {
            const int c = c0 + tid + k * nt;
            if (c >= d) continue;
            const int r = row[k];
            if (kRows) {
              src_lbl[off + c] = r + 2;
            } else {
              src_lbl[off + c] = r >= 0 ? committed(assign, present0, r) : -1;
              touch[off + c] = r >= 0 ? win.touch_before(r, s) : -1;
            }
          }
        } else if (win.v[s] == x) {            // DEL_EDGE, write 1 (u >= 0)
          const int us = win.u[s];
          bool any = false;
#pragma unroll
          for (int k = 0; k < kCols; ++k) {
            const bool h = row[k] == us;       // padding columns hold -1
            any |= h;
            row[k] = h ? -1 : row[k];
          }
          // a self-loop's write 2 clears entries equal to v = u: none left
          any = __any_sync(kAll, any);
          if (lane == 0) atomicOr(&win.hit[s], any ? 3 : 2);
          wrote = true;
        } else {                               // DEL_EDGE, write 2 into row u
          const int vs = win.v[s];
#pragma unroll
          for (int k = 0; k < kCols; ++k) row[k] = row[k] == vs ? -1 : row[k];
          wrote = true;
        }
      }
    }
    if (wrote) {
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const int c = c0 + tid + k * nt;
        if (c < d) row_x[c] = row[k];
      }
    }
  }
}

// The window's tables in shared memory, the same in every block: five (w,)
// slot arrays, then the hash table.
__device__ Window window_layout(int* smem, int w, int hbits) {
  const int hsize = 1 << hbits;
  Window win;
  win.w = w;
  win.hbits = hbits;
  win.et = smem;
  win.v = win.et + w;
  win.u = win.v + w;
  win.fl = win.u + w;
  win.hit = win.fl + w;
  win.key = win.hit + w;
  win.first = win.key + hsize;
  win.last = win.first + hsize;
  win.cnt = win.last + hsize;
  win.head = win.cnt + hsize;
  return win;
}

// The rest of the tables, built by every block from the event list once
// each thread has loaded its slots' et, v, u, fl (the subjects' presence at
// the window's start, F_PV and F_PU) and hit (0) — each kernel loads them
// itself: routing the dense form's presence reads through a shared loader
// cost it 8 / 36 bytes more spills and 0.5-1.6 % of its time (PERF.md, PR
// 22). Builds the hash table of touches and row chains, and each slot's F_*
// flags.
__device__ void build_tables(const Window& win) {
  const int tid = threadIdx.x, nt = blockDim.x, w = win.w;
  for (int h = tid; h < (1 << win.hbits); h += nt) {
    win.key[h] = -1;
    win.first[h] = INT_MAX;
    win.last[h] = -1;
    win.cnt[h] = 0;
    win.head[h] = INT_MAX;
  }
  __syncthreads();

  // the touches: every ADD / DEL_VERTEX subject, and the rows DEL_EDGEs name
  for (int j = tid; j < w; j += nt) {
    const int e = win.et[j];
    const bool de = e == kEventDelEdge && win.u[j] >= 0;
    if (e == kEventAdd || e == kEventDelVertex) {
      const int h = win.insert(win.v[j]);
      atomicMin(&win.first[h], j);
      atomicMax(&win.last[h], j);
      atomicAdd(&win.cnt[h], 1);
    } else if (de) {
      win.insert(win.v[j]);
    }
    if (de) win.insert(win.u[j]);
  }
  __syncthreads();

  // presence and freshness at each slot, then the row chains (the chain
  // counts only add above the touch counts that touch_before reads)
  for (int j = tid; j < w; j += nt) {
    const int e = win.et[j], vj = win.v[j], uj = win.u[j];
    const int p0 = win.fl[j];
    const int ltv = win.touch_before(vj, j);
    const int ltu = win.touch_before(uj >= 0 ? uj : 0, j);
    const bool pv = ltv >= 0 ? win.et[ltv] == kEventAdd : (p0 & F_PV) != 0;
    const bool pu = ltu >= 0 ? win.et[ltu] == kEventAdd : (p0 & F_PU) != 0;
    const bool fresh = e == kEventAdd && !pv;
    const bool cv = fresh || e == kEventDelVertex
        || (e == kEventDelEdge && uj >= 0);
    const bool cu = e == kEventDelEdge && uj >= 0 && uj != vj;
    if (cv) {
      const int h = win.find(vj);
      atomicMin(&win.head[h], j);
      atomicAdd(&win.cnt[h], kChainOne);
    }
    if (cu) {
      const int h = win.find(uj);
      atomicMin(&win.head[h], j);
      atomicAdd(&win.cnt[h], kChainOne);
    }
    win.fl[j] = (fresh ? F_FRESH : 0) | (pv ? F_PV : 0) | (pu ? F_PU : 0)
        | (cv ? F_CV : 0) | (cu ? F_CU : 0);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kMaxThreads)
window_prep_kernel(const int* __restrict__ ets_in, const int* __restrict__ vs_in,
                   const int* __restrict__ rows, const int* __restrict__ assign,
                   const unsigned char* __restrict__ present0,
                   int* __restrict__ adj, int* __restrict__ label0,
                   int* __restrict__ last_touch, int* __restrict__ ev,
                   int* __restrict__ src_lbl, int* __restrict__ touch, int w,
                   int d, int n, int hbits) {
  extern __shared__ int smem[];
  const Window win = window_layout(smem, w, hbits);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int i = blockIdx.x;                    // this block's slot

  // the events, and the committed presence of each slot's two vertices
  for (int j = tid; j < w; j += nt) {
    const int vj = __ldg(vs_in + j);
    const int uj = __ldg(rows + static_cast<size_t>(j) * d);
    const int sv = vj >= 0 ? vj : 0, su = uj >= 0 ? uj : 0;
    win.et[j] = vj >= 0 ? __ldg(ets_in + j) : kEventPad;
    win.v[j] = sv;
    win.u[j] = uj;
    win.fl[j] = (__ldg(present0 + sv) ? F_PV : 0)
        | (__ldg(present0 + su) ? F_PU : 0);
    win.hit[j] = 0;
  }
  build_tables(win);

  const int e = win.et[i], vi = win.v[i], ui = win.u[i];
  const int su = ui >= 0 ? ui : 0;
  const int f = win.fl[i];
  if (tid == 0) {                              // the slot's scalar row
    int* r = ev + static_cast<size_t>(i) * EV_COLS;
    r[EV_ET] = e;
    r[EV_V] = vi;
    r[EV_FRESH] = (f & F_FRESH) ? 1 : 0;
    r[EV_WAS] = e == kEventDelVertex && (f & F_PV);
    // a DEL_EDGE's exists waits for in_adj, from the owner of its row v
    if (!(f & F_CV) || e != kEventDelEdge) r[EV_EXISTS] = 0;
    r[EV_VLBL] = committed(assign, present0, vi);
    r[EV_VTOUCH] = win.touch_before(vi, i);
    r[EV_ULBL] = committed(assign, present0, su);
    r[EV_UTOUCH] = win.touch_before(su, i);
  }
  // the slot's tables, but a DEL_VERTEX's (its row's owner writes them): an
  // ADD scores its event row, pads and DEL_EDGEs score nothing
  if (e != kEventDelVertex) {
    const size_t off = static_cast<size_t>(i) * d;
    for (int c = tid; c < d; c += nt) {
      int lbl = -1, t = -1;
      if (e == kEventAdd) {
        const int r = __ldg(rows + off + c);
        if (r >= 0) {
          lbl = committed(assign, present0, r);
          t = win.touch_before(r, i);
        }
      }
      src_lbl[off + c] = lbl;
      touch[off + c] = t;
    }
  }
  if ((f & F_CV) && win.head[win.find(vi)] == i)
    walk_chain<false>(win, vi, i, d, adj, vi, rows, assign, present0, src_lbl,
                      touch);
  if ((f & F_CU) && win.head[win.find(ui)] == i)
    walk_chain<false>(win, ui, i, d, adj, ui, rows, assign, present0, src_lbl,
                      touch);

  // the (n,) outputs, over the grid
  for (int x = blockIdx.x * nt + tid; x < n; x += gridDim.x * nt) {
    label0[x] = committed(assign, present0, x);
    const int h = win.find(x);
    last_touch[x] = h >= 0 ? win.last[h] : -1;
  }
  __syncthreads();                             // the chains' in_adj ORs
  for (int j = tid; j < w; j += nt) {
    const int hit = win.hit[j];
    if (hit & 2)
      ev[static_cast<size_t>(j) * EV_COLS + EV_EXISTS] =
          (hit & 1) && (win.fl[j] & F_PV) && (win.fl[j] & F_PU);
  }
}

// The row-block form: one block of a vertex-sharded state — rows [lo, lo +
// n_loc) of the adjacency and presence — against the whole window. The same
// tables as the dense form; a block walks only the chains of rows it owns
// (so the adjacency writes of other rows are dropped) and writes, for each
// slot, the owner-masked emissions the mesh sums: the deleted vertex's row
// +2 (rows_dv, 0 unless this block owns it) and flags (w, 4) = [fresh, was,
// the DEL_EDGE's half at row v (present and in_adj), u present], each 0
// unless this block owns the vertex it reads. A row's state at a slot is its
// chain's state there, so a DEL_VERTEX's row and a DEL_EDGE's in_adj come
// from the walk, as in the dense form. Bound: bytes — each slot's event,
// subject and u in, and the rows of the fresh ADDs the block owns; the
// emissions (W D + 4 W ints) out; the block's chain rows read and written
// (chip_smoke.py's _rows_bytes counts a window's). Its critical path is the
// dense form's (the shared tables, then the chains).
__global__ void __launch_bounds__(kMaxThreads)
window_prep_rows_kernel(const int* __restrict__ ets_in,
                        const int* __restrict__ vs_in,
                        const int* __restrict__ rows,
                        const unsigned char* __restrict__ present_blk,
                        int* __restrict__ adj_blk, int* __restrict__ rows_dv,
                        int* __restrict__ flags, int w, int d, int lo,
                        int n_loc, int hbits) {
  extern __shared__ int smem[];
  const auto owned = [&](int x) { return x >= lo && x - lo < n_loc; };
  const Window win = window_layout(smem, w, hbits);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int i = blockIdx.x;                    // this block's slot

  // the events, and the presence at the window's start of each slot's two
  // vertices: false for a row another block of the mesh owns
  for (int j = tid; j < w; j += nt) {
    const int vj = __ldg(vs_in + j);
    const int uj = __ldg(rows + static_cast<size_t>(j) * d);
    const int sv = vj >= 0 ? vj : 0, su = uj >= 0 ? uj : 0;
    win.et[j] = vj >= 0 ? __ldg(ets_in + j) : kEventPad;
    win.v[j] = sv;
    win.u[j] = uj;
    win.fl[j] = (owned(sv) && __ldg(present_blk + (sv - lo)) ? F_PV : 0)
        | (owned(su) && __ldg(present_blk + (su - lo)) ? F_PU : 0);
    win.hit[j] = 0;
  }
  build_tables(win);

  const int e = win.et[i], vi = win.v[i], ui = win.u[i];
  const int f = win.fl[i];
  const bool ov = owned(vi), ou = owned(ui >= 0 ? ui : 0);
  if (tid == 0) {
    int* r = flags + static_cast<size_t>(i) * 4;
    r[0] = ov && (f & F_FRESH);
    r[1] = ov && e == kEventDelVertex && (f & F_PV);
    // the v half of a DEL_EDGE waits for in_adj, from the owner of row v
    if (!(ov && (f & F_CV) && e == kEventDelEdge)) r[2] = 0;
    r[3] = ou && (f & F_PU);
  }
  if (!(ov && e == kEventDelVertex)) {         // the row's owner writes it
    const size_t off = static_cast<size_t>(i) * d;
    for (int c = tid; c < d; c += nt) rows_dv[off + c] = 0;
  }
  if ((f & F_CV) && ov && win.head[win.find(vi)] == i)
    walk_chain<true>(win, vi, i, d, adj_blk, vi - lo, rows, nullptr, nullptr,
                     rows_dv, nullptr);
  if ((f & F_CU) && owned(ui) && win.head[win.find(ui)] == i)
    walk_chain<true>(win, ui, i, d, adj_blk, ui - lo, rows, nullptr, nullptr,
                     rows_dv, nullptr);
  __syncthreads();                             // the chains' in_adj ORs
  for (int j = tid; j < w; j += nt) {
    const int hit = win.hit[j];
    if (hit & 2)
      flags[static_cast<size_t>(j) * 4 + 2] = (hit & 1) && (win.fl[j] & F_PV);
  }
}

// the hash table's entries: the least power of two >= 4 w, as log2
int hash_bits(int w) {
  int b = 2;
  while ((1 << b) < 4 * w) ++b;
  return b;
}

size_t smem_bytes(int w) {
  return sizeof(int) * (5 * static_cast<size_t>(w)
                        + 5 * (static_cast<size_t>(1) << hash_bits(w)));
}

// a block's threads for rows of d columns: a column each, 128 to 512
int threads_for(int d) {
  const int t = (d + 31) / 32 * 32;
  return t < kMinThreads ? kMinThreads : (t > kMaxThreads ? kMaxThreads : t);
}

}  // namespace

// The longest window the kernel takes: its shared memory, 4 (5 w + 5 H)
// bytes with H the least power of two >= 4 w, within the 232,448 a block
// can have.
extern "C" int window_prep_max_w() {
  int w = 0;
  while (smem_bytes(w + 1) <= kSmemMax) ++w;
  return w;
}

// One mixed window's prep: ets, vs (w,), rows (w, d), assignment and
// present0 (n,) in; adj (n, d) updated in place; label0 and last_touch (n,),
// ev (w, 9), src_lbl and touch (w, d) out.
extern "C" int window_prep_launch(const int* ets, const int* vs,
                                  const int* rows, const int* assign,
                                  const unsigned char* present0, int* adj,
                                  int* label0, int* last_touch, int* ev,
                                  int* src_lbl, int* touch, int w, int d,
                                  int n, cudaStream_t stream) {
  if (w <= 0 || d <= 0 || n <= 0 || smem_bytes(w) > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(w);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        window_prep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  window_prep_kernel<<<w, threads_for(d), smem, stream>>>(
      ets, vs, rows, assign, present0, adj, label0, last_touch, ev, src_lbl,
      touch, w, d, n, hash_bits(w));
  return static_cast<int>(cudaGetLastError());
}

// One block of a vertex-sharded state against one mixed window: ets, vs (w,),
// rows (w, d), present_blk (n_loc,) in; adj_blk (n_loc, d), rows lo ..
// lo + n_loc - 1 of the adjacency, updated in place; rows_dv (w, d) and
// flags (w, 4) out.
extern "C" int window_prep_rows_launch(const int* ets, const int* vs,
                                       const int* rows,
                                       const unsigned char* present_blk,
                                       int* adj_blk, int* rows_dv, int* flags,
                                       int w, int d, int lo, int n_loc,
                                       cudaStream_t stream) {
  if (w <= 0 || d <= 0 || n_loc <= 0 || lo < 0 || smem_bytes(w) > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(w);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        window_prep_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  window_prep_rows_kernel<<<w, threads_for(d), smem, stream>>>(
      ets, vs, rows, present_blk, adj_blk, rows_dv, flags, w, d, lo, n_loc,
      hash_bits(w));
  return static_cast<int>(cudaGetLastError());
}
