// Fused mixed-window chooser for Hopper (sm_90a): one CTA walks the W slots
// of one window — resolve labels through the touch tables, histogram them,
// run the policy, merge counters and the pairwise cut matrix, record the
// slot's label, scale out before an ADD and scale in after a DEL_VERTEX.
//
// Replaces the Pallas TPU kernel `fused_window_choose`
// (src/repro/kernels/fused_chooser/fused_chooser.py:245), which kept the
// window in VMEM and walked the slots in a fori_loop. Here the window's
// counters, decisions (w_label, p_sel), scale-in remap and cut matrix live
// in shared memory (~4.5 KB at W=256, K=16); a slot's src_lbl/touch rows
// (D wide, too many for shared memory at D=256) stream from global memory
// while every thread resolves and histograms a stride of them; one thread
// then runs scale-out, the policy and the scalar/K-vector merge in exactly
// the plain PyTorch version's op order (make_slot_step in
// repro_torch/kernels/fused_chooser/fused_chooser.py, merge_slot in
// repro_torch/core/transition.py), and all threads apply the cut-matrix
// row/column adds and the scale-in fold. The kernel is bound by latency —
// W dependent slots with four to six block barriers each — not by its
// ~W*(9 + 2D + K)*4 bytes; grid.x is left for sweep lanes.
//
// Exactness: all counting is integer. The few f32 operations follow the
// plain version one by one; the file is built with -fmad=false so nothing
// is contracted, except the two multiply-adds that XLA's CPU backend (and
// hence the JAX reference) fuses — the SDP guard's w_dev - load_dev and
// Fennel's scores - cost — which are explicit __fmaf_rn here and exact
// FMAs in the plain version. K-reductions are summed left to right.
#include <cuda_runtime.h>

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
// broadcast slots in shared memory (leader -> all threads)
enum Misc { B_NP = 0, B_TOTAL, B_CUT, B_DENIED, B_SCALE, B_DEG, B_P, B_PDV,
            B_PU, B_SCA, B_SCD, B_E, B_SRC, B_DST, B_DO, MISC_N };

constexpr int kThreads = 256;
constexpr int kBig = 1 << 30;
constexpr int kEventAdd = 0;
constexpr int kEventDelVertex = 1;

__device__ __forceinline__ float f_inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

// The leader thread's view of the window state (all in shared memory).
struct Win {
  int k;
  int* active;
  int* el;
  int* vc;
  int* sc;
  int* cm;
  int* misc;
};

__device__ int masked_argmin(const int* x, const int* mask, int k) {
  int best = 0, idx = 0;
  for (int j = 0; j < k; ++j) {
    const int val = mask[j] ? x[j] : kBig;
    if (j == 0 || val < best) { best = val; idx = j; }
  }
  return idx;
}

__device__ int nth_active(const int* active, int k, int i) {
  int cnt = 0;
  for (int j = 0; j < k; ++j) cnt += active[j] != 0;
  i = floor_mod(i, cnt > 1 ? cnt : 1);
  int cum = -1;
  for (int j = 0; j < k; ++j) {
    cum += active[j] != 0;
    if (active[j] && cum == i) return j;
  }
  return 0;
}

// (avg_d, load_dev) over active partitions (transition.load_stats)
__device__ void load_stats(const Win& s, float* avg_d, float* load_dev) {
  int cnt = 0;
  for (int j = 0; j < s.k; ++j) cnt += s.active[j] != 0;
  const float p = fmaxf(static_cast<float>(cnt), 1.0f);
  float maxl = -f_inf(), minl = f_inf();
  for (int j = 0; j < s.k; ++j) {
    const float l = static_cast<float>(s.el[j]);
    maxl = fmaxf(maxl, s.active[j] ? l : -f_inf());
    minl = fminf(minl, s.active[j] ? l : f_inf());
  }
  *avg_d = (maxl - minl) / p;
  float sum = s.active[0] ? static_cast<float>(s.el[0]) : 0.0f;
  for (int j = 1; j < s.k; ++j)
    sum = sum + (s.active[j] ? static_cast<float>(s.el[j]) : 0.0f);
  const float mean = sum / p;
  float var = 0.0f;
  for (int j = 0; j < s.k; ++j) {
    const float dv = static_cast<float>(s.el[j]) - mean;
    const float term = s.active[j] ? dv * dv : 0.0f;
    var = (j == 0) ? term : var + term;
  }
  *load_dev = sqrtf(var / p);
}

// SDP guard threshold TH = w_dev - load_dev with w_dev = (|E|/cut) * dev
__device__ float sdp_threshold(const Win& s, float load_dev) {
  const float cut = fmaxf(static_cast<float>(s.misc[B_CUT]), 1.0f);
  const float ratio = static_cast<float>(s.misc[B_TOTAL]) / cut;
  return __fmaf_rn(ratio, load_dev, -load_dev);
}

__device__ int affinity_choice(const Win& s, int ridx) {
  int best = 0;
  for (int j = 0; j < s.k; ++j) {
    const int v = s.active[j] ? s.sc[j] : -1;
    if (j == 0 || v > best) best = v;
  }
  int p_tie = 0, tie_best = 0;
  for (int j = 0; j < s.k; ++j) {       // masked_argmin(el, tied)
    const bool tied = s.active[j] && (s.sc[j] == best);
    const int val = tied ? s.el[j] : kBig;
    if (j == 0 || val < tie_best) { tie_best = val; p_tie = j; }
  }
  return best > 0 ? p_tie : nth_active(s.active, s.k, ridx);
}

// argmax of h over active partitions with a 1e-6 tie band, ties broken by
// the smallest vertex count (LDG and Fennel)
__device__ int banded_pick(const Win& s, const float* h) {
  float best = -f_inf();
  for (int j = 0; j < s.k; ++j) best = fmaxf(best, h[j]);
  const float floor_ = best - 1e-6f;
  int idx = 0, vbest = 0;
  for (int j = 0; j < s.k; ++j) {
    const bool tied = s.active[j] && (h[j] >= floor_);
    const int val = tied ? s.vc[j] : kBig;
    if (j == 0 || val < vbest) { vbest = val; idx = j; }
  }
  return idx;
}

template <int POLICY, bool ALG1>
__device__ int choose(const Win& s, int deg, int v, int ridx,
                      const float* kn, float* h) {
  const int np = s.misc[B_NP];
  if (POLICY == kSdp) {
    const int p_aff = affinity_choice(s, ridx);
    float avg_d, load_dev;
    load_stats(s, &avg_d, &load_dev);
    const float th = sdp_threshold(s, load_dev);
    const int p_min = masked_argmin(s.el, s.active, s.k);
    if (ALG1) return (np > 1 && load_dev > th) ? p_aff : p_min;
    return (np > 1 && avg_d > th) ? p_min : p_aff;
  } else if (POLICY == kLdg) {
    const float kk = fmaxf(static_cast<float>(np), 1.0f);
    const float cap = kn[K_LDG_CAP_NUM] / kk;
    for (int j = 0; j < s.k; ++j) {
      const float w = 1.0f - static_cast<float>(s.vc[j]) / cap;
      const float hv = static_cast<float>(s.sc[j]) * fmaxf(w, 0.0f);
      h[j] = s.active[j] ? hv : -f_inf();
    }
    return banded_pick(s, h);
  } else if (POLICY == kFennel) {
    const float m = static_cast<float>(s.misc[B_TOTAL]) + static_cast<float>(deg);
    int vsum = 0;
    for (int j = 0; j < s.k; ++j) vsum += s.vc[j];
    const float nt = fmaxf(static_cast<float>(vsum), 1.0f);
    const float kk = fmaxf(static_cast<float>(np), 1.0f);
    const float alpha = kn[K_FENNEL_ALPHA] * sqrtf(kk) * m / powf(nt, 1.5f);
    const float coef = alpha * kn[K_FENNEL_GAMMA];
    for (int j = 0; j < s.k; ++j) {
      const float vcp = powf(static_cast<float>(s.vc[j]), kn[K_FENNEL_GM1]);
      const float hv = __fmaf_rn(-coef, vcp, static_cast<float>(s.sc[j]));
      h[j] = s.active[j] ? hv : -f_inf();
    }
    return banded_pick(s, h);
  } else if (POLICY == kHash) {
    return nth_active(s.active, s.k, floor_mod(v, np > 1 ? np : 1));
  } else if (POLICY == kRandom) {
    return nth_active(s.active, s.k, ridx);
  } else {
    return affinity_choice(s, ridx);
  }
}

template <int POLICY, bool ALG1>
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
  extern __shared__ int smem[];
  int* w_label = smem;             // [w]
  int* psel = w_label + w;         // [w]
  int* remap = psel + w;           // [k]
  int* active = remap + k;         // [k]
  int* el = active + k;            // [k]
  int* vc = el + k;                // [k]
  int* sc = vc + k;                // [k] per-slot histogram
  int* cm = sc + k;                // [k*k]
  int* cm2 = cm + k * k;           // [k*k] scale-in fold scratch
  int* misc = cm2 + k * k;         // [MISC_N]
  float* h = reinterpret_cast<float*>(misc + MISC_N);   // [k] leader scratch

  const int tid = threadIdx.x;
  const int kk = k * k;
  for (int j = tid; j < w; j += blockDim.x) w_label[j] = -1;
  for (int j = tid; j < k; j += blockDim.x) {
    remap[j] = j;
    active[j] = active_in[j] != 0;
    el[j] = el_in[j];
    vc[j] = vc_in[j];
  }
  for (int j = tid; j < kk; j += blockDim.x) cm[j] = cm_in[j];
  if (tid < SCAL_N) misc[B_NP + tid] = scal_in[tid];
  float kn[KNOB_N];
  for (int j = 0; j < KNOB_N; ++j) kn[j] = knobs[j];
  const Win s{k, active, el, vc, sc, cm, misc};
  __syncthreads();

  for (int i = 0; i < w; ++i) {
    // (1) clear the slot histogram
    for (int j = tid; j < k; j += blockDim.x) sc[j] = 0;
    if (tid == 0) misc[B_DEG] = 0;
    __syncthreads();

    // (2) effective neighbour labels + histogram (paper Eq. 1)
    const int* srow = src_lbl + static_cast<size_t>(i) * d;
    const int* trow = touch + static_cast<size_t>(i) * d;
    int cnt = 0;
    for (int j = tid; j < d; j += blockDim.x) {
      const int t = trow[j];
      const int lc = srow[j];
      const int lab = t >= 0 ? w_label[t] : (lc >= 0 ? remap[lc] : -1);
      if (lab >= 0) {
        ++cnt;
        if (lab < k) atomicAdd(&sc[lab], 1);
      }
    }
    for (int off = 16; off > 0; off >>= 1)
      cnt += __shfl_down_sync(0xffffffffu, cnt, off);
    if ((tid & 31) == 0 && cnt) atomicAdd(&misc[B_DEG], cnt);
    __syncthreads();

    // (3) leader: scale-out, policy, counter merge, slot label, scale-in trigger
    if (tid == 0) {
      const int* e = ev + static_cast<size_t>(i) * EV_COLS;
      const int et = e[EV_ET];
      const int v = e[EV_V];
      const int fresh = e[EV_FRESH] != 0;
      const int was = e[EV_WAS] != 0;
      const int exists = e[EV_EXISTS] != 0;
      const bool add_i = et == kEventAdd;
      const bool dv_i = et == kEventDelVertex;

      if (autoscaling && add_i) {                       // scale_out
        const float p = fmaxf(static_cast<float>(misc[B_NP]), 1.0f);
        const float thr = static_cast<float>(misc[B_TOTAL]) / p;
        const bool want = kn[K_MAX_CAP] <= thr;
        int slot = -1;
        for (int j = 0; j < k; ++j)
          if (!active[j]) { slot = j; break; }
        if (want && slot >= 0) {
          active[slot] = 1;
          misc[B_NP] += 1;
          misc[B_SCALE] += 1;
        } else if (want) {
          misc[B_DENIED] += 1;
        }
      }

      const int deg = misc[B_DEG];
      const int np1 = misc[B_NP] > 1 ? misc[B_NP] : 1;
      const int ridx = rand_tab[static_cast<size_t>(i) * k + (np1 - 1)];
      const int p = choose<POLICY, ALG1>(s, deg, v, ridx, kn, h);

      auto label_at = [&](int lc, int t) {
        return t >= 0 ? w_label[t] : (lc >= 0 ? remap[lc] : -1);
      };
      const int vl = label_at(e[EV_VLBL], e[EV_VTOUCH]);
      const int ul = label_at(e[EV_ULBL], e[EV_UTOUCH]);
      const int p_dv = vl > 0 ? vl : 0;
      const int pu = ul > 0 ? ul : 0;
      const int d_add = fresh ? deg : 0;
      const int d_dv = was ? deg : 0;
      const int cutdec = (exists && p_dv != pu) ? 1 : 0;

      const int sca_p = fresh ? sc[p] : 0;
      const int scd_pdv = was ? sc[p_dv] : 0;
      for (int j = 0; j < k; ++j)
        el[j] = el[j] + (fresh ? sc[j] : 0) - (was ? sc[j] : 0);
      el[p] += d_add;
      el[p_dv] -= d_dv;
      el[p_dv] -= exists;
      el[pu] -= exists;
      vc[p] += fresh;
      vc[p_dv] -= was;
      misc[B_TOTAL] = misc[B_TOTAL] + d_add - d_dv - exists;
      misc[B_CUT] = misc[B_CUT] + (d_add - sca_p) - (d_dv - scd_pdv) - cutdec;

      const int new_lbl = add_i ? (fresh ? p : vl) : (dv_i ? -1 : vl);
      w_label[i] = (add_i || dv_i) ? new_lbl : -1;
      psel[i] = p;

      int do_in = 0, src = 0, dst = 0;
      if (autoscaling && dv_i) {                        // scale_in_trigger
        int n_under = 0;
        for (int j = 0; j < k; ++j)
          n_under += active[j] && (static_cast<float>(el[j]) < kn[K_SCALE_IN_L]);
        src = masked_argmin(el, active, k);
        int best = 0;
        for (int j = 0; j < k; ++j) {                   // masked_argmin(el, active & j != src)
          const int val = (active[j] && j != src) ? el[j] : kBig;
          if (j == 0 || val < best) { best = val; dst = j; }
        }
        const bool fits =
            static_cast<float>(el[src] + el[dst]) <= kn[K_SCALE_IN_DEST];
        do_in = misc[B_NP] > 1 && n_under >= 2 && fits;
      }
      misc[B_P] = p;
      misc[B_PDV] = p_dv;
      misc[B_PU] = pu;
      misc[B_SCA] = fresh;
      misc[B_SCD] = was;
      misc[B_E] = exists;
      misc[B_SRC] = src;
      misc[B_DST] = dst;
      misc[B_DO] = do_in;
    }
    __syncthreads();

    // (4) cut-matrix row/column adds of the slot (commit / delete / edge)
    {
      const int p = misc[B_P], p_dv = misc[B_PDV], pu = misc[B_PU];
      const int use_a = misc[B_SCA], use_d = misc[B_SCD], e = misc[B_E];
      for (int j = tid; j < kk; j += blockDim.x) {
        const int r = j / k, c = j - r * k;
        int delta = 0;
        if (use_a) delta += (r == p ? sc[c] : 0) + (c == p ? sc[r] : 0);
        if (use_d) delta -= (r == p_dv ? sc[c] : 0) + (c == p_dv ? sc[r] : 0);
        if (r == p_dv && c == pu) delta -= e;
        if (r == pu && c == p_dv) delta -= e;
        cm[j] += delta;
      }
    }
    __syncthreads();

    // (5) scale-in: fold src into dst (merge_cut_matrix) and relabel
    if (misc[B_DO]) {
      const int src = misc[B_SRC], dst = misc[B_DST];
      for (int j = tid; j < kk; j += blockDim.x) {
        const int r = j / k, c = j - r * k;
        int val = cm[j];
        if (r == dst) val += cm[src * k + c];
        if (c == dst) val += cm[src * k + r];
        if (r == dst && c == dst) val += cm[src * k + src];
        cm2[j] = (r == src || c == src) ? 0 : val;
      }
      for (int j = tid; j < w; j += blockDim.x)
        if (w_label[j] == src) w_label[j] = dst;
      for (int j = tid; j < k; j += blockDim.x)
        if (remap[j] == src) remap[j] = dst;
      if (tid == 0) {
        misc[B_CUT] -= cm[src * k + dst];
        el[dst] += el[src];
        el[src] = 0;
        vc[dst] += vc[src];
        vc[src] = 0;
        active[src] = 0;
        misc[B_NP] -= 1;
        misc[B_SCALE] += 1;
      }
      __syncthreads();
      for (int j = tid; j < kk; j += blockDim.x) cm[j] = cm2[j];
      __syncthreads();
    }
  }

  for (int j = tid; j < w; j += blockDim.x) {
    w_label_out[j] = w_label[j];
    psel_out[j] = psel[j];
  }
  for (int j = tid; j < k; j += blockDim.x) {
    remap_out[j] = remap[j];
    active_out[j] = active[j];
    loads_out[j] = el[j];
    loads_out[k + j] = vc[j];
  }
  for (int j = tid; j < kk; j += blockDim.x) cm_out[j] = cm[j];
  if (tid < SCAL_N) scal_out[tid] = misc[B_NP + tid];
}

template <int POLICY, bool ALG1>
cudaError_t launch(const int* ev, const int* src_lbl, const int* touch,
                   const int* rand_tab, const int* active, const int* el,
                   const int* vc, const int* cm, const int* scal,
                   const float* knobs, int* w_label, int* psel, int* remap,
                   int* active_out, int* loads, int* cm_out, int* scal_out,
                   int w, int d, int k, int autoscaling, cudaStream_t stream) {
  auto kernel = fused_chooser_kernel<POLICY, ALG1>;
  const size_t smem = sizeof(int) * (2 * static_cast<size_t>(w) + 6 * k
                                     + 2 * static_cast<size_t>(k) * k + MISC_N);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<1, kThreads, smem, stream>>>(ev, src_lbl, touch, rand_tab, active,
                                        el, vc, cm, scal, knobs, w_label, psel,
                                        remap, active_out, loads, cm_out,
                                        scal_out, w, d, k, autoscaling);
  return cudaGetLastError();
}

}  // namespace

#define FUSED_ARGS ev, src_lbl, touch, rand_tab, active, el, vc, cm, scal, knobs, \
                   w_label, psel, remap, active_out, loads, cm_out, scal_out,     \
                   w, d, k, autoscaling, stream

extern "C" int fused_chooser_launch(
    const int* ev, const int* src_lbl, const int* touch, const int* rand_tab,
    const int* active, const int* el, const int* vc, const int* cm,
    const int* scal, const float* knobs, int* w_label, int* psel, int* remap,
    int* active_out, int* loads, int* cm_out, int* scal_out, int w, int d,
    int k, int policy, int alg1, int autoscaling, cudaStream_t stream) {
  cudaError_t err;
  switch (policy * 2 + (alg1 ? 1 : 0)) {
    case kSdp * 2: err = launch<kSdp, false>(FUSED_ARGS); break;
    case kSdp * 2 + 1: err = launch<kSdp, true>(FUSED_ARGS); break;
    case kLdg * 2: err = launch<kLdg, false>(FUSED_ARGS); break;
    case kLdg * 2 + 1: err = launch<kLdg, true>(FUSED_ARGS); break;
    case kFennel * 2: err = launch<kFennel, false>(FUSED_ARGS); break;
    case kFennel * 2 + 1: err = launch<kFennel, true>(FUSED_ARGS); break;
    case kHash * 2: err = launch<kHash, false>(FUSED_ARGS); break;
    case kHash * 2 + 1: err = launch<kHash, true>(FUSED_ARGS); break;
    case kRandom * 2: err = launch<kRandom, false>(FUSED_ARGS); break;
    case kRandom * 2 + 1: err = launch<kRandom, true>(FUSED_ARGS); break;
    case kGreedy * 2: err = launch<kGreedy, false>(FUSED_ARGS); break;
    case kGreedy * 2 + 1: err = launch<kGreedy, true>(FUSED_ARGS); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
