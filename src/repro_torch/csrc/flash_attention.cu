// Flash attention forward (tiled online softmax) for Hopper (sm_90a).
//
//   o[b, h, i, :] = softmax_j(mask(cap(q[b,h,i,:] . k[b,h/G,j,:] * D^-1/2)))
//                   @ v[b, h/G, :, :]
//
// with query i at position q_offset + i and key j at position j; a key is
// visible if j < Sk, q_pos >= j (causal) and q_pos - j < window (window >
// 0); cap(s) = softcap * tanh(s / softcap) (softcap > 0); masked logits are
// -1e30; G = H / Hkv query heads share one kv head (GQA).
//
// Replaces the Pallas TPU kernel `flash_attention`
// (src/repro/kernels/flash_attention/flash_attention.py:133, body
// `_flash_kernel`), which walked a sequential (B*H, q-block, k-block) grid
// with the running max / denominator / accumulator in VMEM scratch and
// folded GQA through the k/v BlockSpec index map. Every kernel here folds
// the GQA group's query heads into the rows (row = pos * G + g), so a K/V
// tile is read once for the whole group, and addresses every tensor
// through its own batch / head / sequence strides with D contiguous, so
// (B, H, S, D) tensors, the model's (B, S, H, D) views and slices of the
// decode cache launch without copies. Three designs, chosen by the wrapper
// from the dtype and the shape:
//
// * f32 (`flash_attention_kernel`): one CTA per (batch, kv head, 16*R
//   rows), 32-key K/V tiles staged in shared memory, every inner product an
//   explicit __fmaf_rn chain on the CUDA cores (the build passes -fmad=false
//   for the session kernels' bit-identity). It holds the f32 tolerance of
//   tests/test_kernels.py (2e-5), which only full f32 arithmetic meets.
//
// * bf16 prefill (`prefill_kernel`): bound by operations (4 * D flops per
//   visible (query, key) pair and head), so both products run on the
//   tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate),
//   fragments loaded by ldmatrix. One CTA of 4 warps owns 64 folded rows
//   (16 a warp); K and V arrive as bf16 tiles (32 keys at D = 256, so two
//   CTAs fit an SM; 64 below) through a two-stage cp.async ring.
//   Shared rows are padded by 16 B, so the 8 rows an ldmatrix reads fall in
//   distinct banks (D = 256 rows are 512 B), and zero-filled from d to the
//   instantiated width, so no guard splits the mma stream. Each iteration
//   scores tile t + 1 and sums tile t, the two mma streams interleaved in
//   source order (ptxas keeps the order of the mma's), then takes the
//   softmax of tile t + 1 in f32 registers on the accumulator fragments:
//   logits in log2 units so that each exponential is one exp2f, with the
//   accurate tanhf (softcap * tanh multiplies tanh's error by the cap).
//   P.V takes P as bf16 hi + bf16 lo (P - hi) in two mma's into one
//   accumulator: about 2^-17 relative error, where one bf16 P leaves 2^-9
//   and misses the bf16 check's 1e-5 floor at outputs that cancel. The
//   longest causal row tiles of every head start first, and K/V tiles
//   masked for every row of the CTA are skipped (exact, as in the f32
//   kernel).
//
// * bf16 decode (`split_kernel` + `combine_kernel`): a decode step has G
//   rows per kv head, so a CTA per (batch, kv head) would leave most SMs
//   idle while it streams the cache. The wrapper splits the visible key
//   range into n_split chunks (ref.split_plan); one CTA per (chunk, kv
//   head, batch) streams its chunk with 16-byte loads, several keys in
//   flight per lane, scores the rows on the CUDA cores in f32 (about 2
//   flops a byte: bound by bytes), and writes a partial (m, l, acc[D]) per
//   row in f32 (m in log2 units); the combine kernel rescales the
//   partials by 2^(m_i - m) and writes sum(acc) / sum(l) in bf16. A
//   masked key has weight exactly 0 here, so a chunk that no row can see
//   adds neither weight nor NaN.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;   // 16 row groups (tm) x 16 column groups (tn)
constexpr int kBlockN = 32;     // keys per K/V tile; a thread scores 2
constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int sq, sk, d, group, causal, window, q_offset;
  float scale, softcap;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
template <int R, int DMAX>
constexpr int smem_floats() {
  // Q (16R x DP), K and V (32 x DP each), P transposed (32 x (16R + 4))
  return 16 * R * (DMAX + 4) + 2 * kBlockN * (DMAX + 4) + kBlockN * (16 * R + 4);
}

// T: element type of q, k, v, o. R: query rows per thread (the CTA owns
// 16 * R rows). DMAX: the head dim rounded up to 64, 128 or 256.
template <typename T, int R, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const Args a) {
  constexpr int kBlockM = 16 * R;
  constexpr int kPst = kBlockM + 4;     // row stride of the transposed P tile
  constexpr int kCols = DMAX / 64;      // float4 output groups per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int d = a.d;
  const int dp = d + 4;                 // padded row stride (keeps float4 alignment)
  float* qs = smem;                     // [kBlockM][dp]
  float* ks = qs + kBlockM * dp;        // [kBlockN][dp]
  float* vs = ks + kBlockN * dp;        // [kBlockN][dp]
  float* ps = vs + kBlockN * dp;        // [kBlockN][kPst]

  const int tid = threadIdx.x;
  const int tm = tid >> 4;
  const int tn = tid & 15;
  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int rows = a.sq * a.group;
  const int row0 = blockIdx.x * kBlockM;
  const int row_last = min(row0 + kBlockM, rows) - 1;
  const int d4 = d >> 2;

  const T* qg = static_cast<const T*>(a.q);
  const T* kg = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  // the CTA's query tile, rows past the end zero-filled
  for (int idx = tid; idx < kBlockM * d4; idx += kThreads) {
    const int r = idx / d4;
    const int c = (idx - r * d4) * 4;
    const int rg = row0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (rg < rows) {
      const int pos = rg / a.group;
      const int head = kvh * a.group + (rg - pos * a.group);
      x = load4(qg + b * a.q_sb + head * a.q_sh + pos * a.q_ss + c);
    }
    store4(qs + r * dp + c, x);
  }

  // each thread's rows: tm * R + i; their absolute positions
  int qpos[R];
#pragma unroll
  for (int i = 0; i < R; ++i)
    qpos[i] = a.q_offset + min(row0 + tm * R + i, rows - 1) / a.group;

  // the keys any row of this CTA can see
  const int p_first = a.q_offset + row0 / a.group;
  const int p_last = a.q_offset + row_last / a.group;
  int k_lo = 0;
  int k_hi = a.sk;
  if (a.window > 0) k_lo = max(0, p_first - a.window + 1);
  if (a.causal) k_hi = min(a.sk, p_last + 1);
  k_lo = (k_lo / kBlockN) * kBlockN;

  float m[R], l[R], acc[R][kCols][4];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

  for (int kb = k_lo; kb < k_hi; kb += kBlockN) {
    __syncthreads();                    // the previous tile is consumed
    for (int idx = tid; idx < kBlockN * d4; idx += kThreads) {
      const int n = idx / d4;
      const int c = (idx - n * d4) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vx = kx;
      if (kb + n < a.sk) {
        kx = load4(kg + (kb + n) * a.k_ss + c);
        vx = load4(vg + (kb + n) * a.v_ss + c);
      }
      store4(ks + n * dp + c, kx);
      store4(vs + n * dp + c, vx);
    }
    __syncthreads();

    // scores of rows tm*R+i against keys tn and tn+16
    float s[R][2];
#pragma unroll
    for (int i = 0; i < R; ++i) s[i][0] = s[i][1] = 0.f;
    for (int c = 0; c < d; c += 4) {
      float4 kv0 = *reinterpret_cast<const float4*>(ks + tn * dp + c);
      float4 kv1 = *reinterpret_cast<const float4*>(ks + (tn + 16) * dp + c);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + (tm * R + i) * dp + c);
        s[i][0] = __fmaf_rn(qv.x, kv0.x, s[i][0]);
        s[i][0] = __fmaf_rn(qv.y, kv0.y, s[i][0]);
        s[i][0] = __fmaf_rn(qv.z, kv0.z, s[i][0]);
        s[i][0] = __fmaf_rn(qv.w, kv0.w, s[i][0]);
        s[i][1] = __fmaf_rn(qv.x, kv1.x, s[i][1]);
        s[i][1] = __fmaf_rn(qv.y, kv1.y, s[i][1]);
        s[i][1] = __fmaf_rn(qv.z, kv1.z, s[i][1]);
        s[i][1] = __fmaf_rn(qv.w, kv1.w, s[i][1]);
      }
    }

    // mask, online softmax update, P into shared memory (transposed)
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kp = kb + tn + 16 * j;
        float x = s[i][j] * a.scale;
        if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
        bool vis = kp < a.sk;
        if (a.causal) vis = vis && qpos[i] >= kp;
        if (a.window > 0) vis = vis && (qpos[i] - kp) < a.window;
        s[i][j] = vis ? x : kNegInf;
      }
      float mx = fmaxf(s[i][0], s[i][1]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float p0 = expf(s[i][0] - m_new);
      const float p1 = expf(s[i][1] - m_new);
      const float alpha = expf(m[i] - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] *= alpha;
      ps[tn * kPst + tm * R + i] = p0;
      ps[(tn + 16) * kPst + tm * R + i] = p1;
    }
    __syncthreads();

    // acc[rows][cols] += P[rows][keys] @ V[keys][cols]; thread's columns are
    // 4*tn + 64*j + e
    for (int n = 0; n < kBlockN; ++n) {
      float p[R];
#pragma unroll
      for (int i = 0; i < R; ++i) p[i] = ps[n * kPst + tm * R + i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = 4 * tn + 64 * j;
        if (c < d) {
          const float4 vv = *reinterpret_cast<const float4*>(vs + n * dp + c);
#pragma unroll
          for (int i = 0; i < R; ++i) {
            acc[i][j][0] = __fmaf_rn(p[i], vv.x, acc[i][j][0]);
            acc[i][j][1] = __fmaf_rn(p[i], vv.y, acc[i][j][1]);
            acc[i][j][2] = __fmaf_rn(p[i], vv.z, acc[i][j][2]);
            acc[i][j][3] = __fmaf_rn(p[i], vv.w, acc[i][j][3]);
          }
        }
      }
    }
  }

  T* og = static_cast<T*>(a.o);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int rg = row0 + tm * R + i;
    if (rg >= rows) continue;
    const int pos = rg / a.group;
    const int head = kvh * a.group + (rg - pos * a.group);
    const float denom = l[i] == 0.f ? 1.f : l[i];
    T* dst = og + b * a.o_sb + head * a.o_sh + pos * a.o_ss;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = 4 * tn + 64 * j;
      if (c < d)
        store4(dst + c, make_float4(acc[i][j][0] / denom, acc[i][j][1] / denom,
                                    acc[i][j][2] / denom, acc[i][j][3] / denom));
    }
  }
}

template <typename T, int R, int DMAX>
int launch(const Args& a, int b, int hkv, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * smem_floats<R, DMAX>();
  auto kernel = flash_attention_kernel<T, R, DMAX>;
  static bool configured = false;   // once per instantiation, before any capture
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int rows = a.sq * a.group;
  const dim3 grid((rows + 16 * R - 1) / (16 * R), hkv, b);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int R>
int launch_d(const Args& a, int b, int hkv, cudaStream_t stream) {
  if (a.d <= 64) return launch<T, R, 64>(a, b, hkv, stream);
  if (a.d <= 128) return launch<T, R, 128>(a, b, hkv, stream);
  return launch<T, R, 256>(a, b, hkv, stream);
}

template <typename T>
int launch_t(const Args& a, int b, int hkv, cudaStream_t stream) {
  // a decode step's few rows (GQA group x 1 position) take 16-row tiles
  if (a.sq * a.group <= 16) return launch_d<T, 1>(a, b, hkv, stream);
  return launch_d<T, 4>(a, b, hkv, stream);
}


// ---------------------------------------------------------------------------
// bf16 building blocks: cp.async, ldmatrix, mma.sync, bf16 <-> f32
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; bytes == 0 writes zeros instead
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d (16x8, f32) += a (16x16 bf16, row) . b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// (x, y) = hi + lo with hi = bf16(x, y) and lo = bf16((x, y) - hi), both
// packed as an mma A-fragment register (lower column in the low half)
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t& hi,
                                             uint32_t& lo) {
  hi = pack_bf16x2(x, y);
  lo = pack_bf16x2(x - bf16_lo(hi), y - bf16_hi(hi));
}

__device__ __forceinline__ bool visible(const Args& a, int qpos, int key) {
  bool vis = key < a.sk;
  if (a.causal) vis = vis && qpos >= key;
  if (a.window > 0) vis = vis && (qpos - key) < a.window;
  return vis;
}

// The bf16 kernels keep logits in log2 units, x * log2(e), so that every
// exponential is one exp2f: cap(s) * log2(e) = (softcap * log2(e)) *
// tanh(dot * (scale / softcap)), or dot * (scale * log2(e)) with no cap.
// tanhf is the accurate one (tanh.approx's 2^-11 would become about 0.02 in
// a logit capped at 50).
constexpr float kLog2e = 1.4426950408889634f;

struct Logit {
  float mul;   // multiplies the inner product
  float cap;   // softcap * log2(e), or 0 for no cap
};

__device__ __forceinline__ Logit logit_of(const Args& a) {
  if (a.softcap > 0.f) return {a.scale / a.softcap, a.softcap * kLog2e};
  return {a.scale * kLog2e, 0.f};
}

__device__ __forceinline__ float logit2(const Logit& lg, float dot) {
  return lg.cap > 0.f ? lg.cap * tanhf(dot * lg.mul) : dot * lg.mul;
}

// ---------------------------------------------------------------------------
// bf16 prefill on the tensor cores
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockM = 16 * kWarps;   // folded rows per CTA, 16 per warp

template <int DMAX>
struct Cfg {
  // keys per K/V tile: 32 at D = 256 keeps two CTAs (8 warps) on an SM
  static constexpr int kBlockN = DMAX == 256 ? 32 : 64;
  static constexpr int kStride = DMAX + 8;   // bf16 per shared row (+16 B)
  // Q, then two stages of K and V
  static constexpr int kSmemBytes =
      (kBlockM + 4 * kBlockN) * kStride * static_cast<int>(sizeof(bf16));
};

// DMAX: the head dim rounded up to 64, 128 or 256; d is a multiple of 16.
// Grid (kv head, batch, row tile), the row tiles reversed so that the
// longest causal rows of every head start first.
template <int DMAX>
__global__ void __launch_bounds__(kThreads)
prefill_kernel(const Args a) {
  constexpr int BN = Cfg<DMAX>::kBlockN;
  constexpr int ST = Cfg<DMAX>::kStride;
  constexpr int CH = DMAX / 8;                 // 16-byte chunks of a row
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);   // [kBlockM][ST]
  bf16* ks = qs + kBlockM * ST;                // [2][BN][ST]
  bf16* vs = ks + 2 * BN * ST;                 // [2][BN][ST]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;      // the fragment row (and row + 8)
  const int tig = lane & 3;     // the fragment column pair
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int rows = a.sq * a.group;
  const int row0 = (gridDim.z - 1 - blockIdx.z) * kBlockM;
  const int row_last = min(row0 + kBlockM, rows) - 1;
  const int d = a.d;

  const bf16* qg = static_cast<const bf16*>(a.q) + b * a.q_sb;
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  // the keys any row of this CTA can see, in whole tiles
  const int p_first = a.q_offset + row0 / a.group;
  const int p_last = a.q_offset + row_last / a.group;
  int k_lo = 0;
  int k_hi = a.sk;
  if (a.window > 0) k_lo = max(0, p_first - a.window + 1);
  if (a.causal) k_hi = min(a.sk, p_last + 1);
  k_lo = (k_lo / BN) * BN;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BN - 1) / BN : 0;

  // Shared rows are DMAX wide: columns d .. DMAX - 1 are zero-filled, so
  // the products run over DMAX with no per-step guard (a guard splits the
  // mma stream into blocks the scheduler cannot overlap).
  // K or V rows of tile t into a stage (keys past Sk as zeros)
  auto load_tile = [&](bf16* stage, const bf16* src, int64_t stride, int t) {
    const int kb = k_lo + t * BN;
#pragma unroll
    for (int idx = tid; idx < BN * CH; idx += kThreads) {
      const int n = idx / CH;
      const int c = (idx % CH) * 8;
      const bool in = kb + n < a.sk && c < d;
      const int64_t key = in ? kb + n : 0;
      cp_async16(stage + n * ST + c, src + key * stride + (in ? c : 0),
                 in ? 16 : 0);
    }
  };

  // the query tile (rows past the end zero-filled)
  for (int idx = tid; idx < kBlockM * CH; idx += kThreads) {
    const int r = idx / CH;
    const int c = (idx % CH) * 8;
    const int rg = row0 + r;
    const bool in = rg < rows && c < d;
    const bf16* src = qg;
    if (in) {
      const int pos = rg / a.group;
      const int head = kvh * a.group + (rg - pos * a.group);
      src = qg + head * a.q_sh + pos * a.q_ss + c;
    }
    cp_async16(qs + r * ST + c, src, in ? 16 : 0);
  }

  // this thread's two rows: 16 * warp + g and + 8
  int qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    qpos[h] = a.q_offset + min(row0 + 16 * warp + g + 8 * h, rows - 1) / a.group;

  float o[DMAX / 8][4];
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max, log2 units
  float l[2] = {0.f, 0.f};          // this thread's share of the row sums
  const Logit lg = logit_of(a);
  float s[BN / 8][4];               // S of the tile being scored
  uint32_t ph[BN / 16][4], pl[BN / 16][4];   // P of the tile being summed

  // one k-step (16 of the head dim) of S = Q K^T for the warp's 16 rows,
  // K in `kt`
  auto score_step = [&](const bf16* kt, int kk) {
    uint32_t qa[4];
    ldmatrix_x4(qa, qs + (16 * warp + (lane & 15)) * ST + kk * 16 +
                        (lane >> 4) * 8);
#pragma unroll
    for (int jn = 0; jn < BN / 16; ++jn) {
      uint32_t kb4[4];
      ldmatrix_x4(kb4, kt + (16 * jn + (lane & 7) + ((lane >> 4) << 3)) * ST +
                           kk * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(s[2 * jn], qa, kb4[0], kb4[1]);
      mma_bf16(s[2 * jn + 1], qa, kb4[2], kb4[3]);
    }
  };
  auto clear_s = [&]() {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  };

  // scale, cap and (unless every row sees the whole tile) mask S of tile t
  // in log2 units; update the running max and sums, rescale O, and leave
  // P as bf16 hi + lo in the A-fragment layout (the S fragments of keys
  // 16 i .. 16 i + 15 are the A fragment of that k-step)
  auto softmax = [&](int t) {
    const int kb = k_lo + t * BN;
    const bool whole = kb + BN <= a.sk &&
                       (!a.causal || kb + BN - 1 <= p_first) &&
                       (a.window <= 0 || p_last - kb < a.window);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = logit2(lg, s[j][e]);
    if (!whole) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!visible(a, qpos[e >> 1], kb + 8 * j + 2 * tig + (e & 1)))
            s[j][e] = kNegInf;
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    float alpha[2];
    float rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        rsum[e >> 1] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rsum[h];
#pragma unroll
    for (int j = 0; j < DMAX / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
#pragma unroll
    for (int i = 0; i < BN / 16; ++i) {
      split_bf16x2(s[2 * i][0], s[2 * i][1], ph[i][0], pl[i][0]);
      split_bf16x2(s[2 * i][2], s[2 * i][3], ph[i][1], pl[i][1]);
      split_bf16x2(s[2 * i + 1][0], s[2 * i + 1][1], ph[i][2], pl[i][2]);
      split_bf16x2(s[2 * i + 1][2], s[2 * i + 1][3], ph[i][3], pl[i][3]);
    }
  };

  // O += P V for keys 16 i .. 16 i + 15 and the 32 columns of blocks jd,
  // jd + 1 (unit u), V in `vt`: the four hi products first, then the four
  // lo ones into the same accumulators, so no mma waits on the one before
  auto sum_pair = [&](const bf16* vt, int u) {
    const int i = u / (DMAX / 32);
    const int jd = (u % (DMAX / 32)) * 2;
    uint32_t vb[2][4];
#pragma unroll
    for (int w = 0; w < 2; ++w)
      ldmatrix_x4_trans(vb[w], vt + (16 * i + (lane & 7) +
                                     ((lane >> 3) & 1) * 8) * ST +
                                   16 * (jd + w) + (lane >> 4) * 8);
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      mma_bf16(o[2 * (jd + w)], ph[i], vb[w][0], vb[w][1]);
      mma_bf16(o[2 * (jd + w) + 1], ph[i], vb[w][2], vb[w][3]);
    }
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      mma_bf16(o[2 * (jd + w)], pl[i], vb[w][0], vb[w][1]);
      mma_bf16(o[2 * (jd + w) + 1], pl[i], vb[w][2], vb[w][3]);
    }
  };

  // Software pipeline over the K/V tiles: iteration t scores tile t + 1
  // and sums tile t, two independent streams of mma's interleaved step by
  // step (each k-step of Q K^T beside BN / 32 units of P V; the mma's
  // issue in source order), then takes the softmax of tile t + 1. Loads
  // run a tile ahead: the group issued at iteration t - 1 holds V_t and
  // K_(t+1); K stage t&1 and V stage (t+1)&1 are free once every warp has
  // finished iteration t - 1.
  if (n_tiles > 0) load_tile(ks, kg, a.k_ss, 0);
  cp_async_commit();                         // Q, K_0
  if (n_tiles > 0) load_tile(vs, vg, a.v_ss, 0);
  if (n_tiles > 1) load_tile(ks + BN * ST, kg, a.k_ss, 1);
  cp_async_commit();                         // V_0, K_1
  cp_async_wait<1>();
  __syncthreads();
  if (n_tiles > 0) {
    clear_s();
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk) score_step(ks, kk);
    softmax(0);
  }
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < n_tiles)
      load_tile(vs + ((t + 1) & 1) * BN * ST, vg, a.v_ss, t + 1);
    if (t + 2 < n_tiles) load_tile(ks + (t & 1) * BN * ST, kg, a.k_ss, t + 2);
    cp_async_commit();
    const bf16* kt = ks + ((t + 1) & 1) * BN * ST;
    const bf16* vt = vs + (t & 1) * BN * ST;
    if (t + 1 < n_tiles) {
      clear_s();
#pragma unroll
      for (int kk = 0; kk < DMAX / 16; ++kk) {
        score_step(kt, kk);
#pragma unroll
        for (int r = 0; r < BN / 32; ++r) sum_pair(vt, kk * (BN / 32) + r);
      }
      softmax(t + 1);
    } else {
#pragma unroll
      for (int u = 0; u < (BN / 16) * (DMAX / 32); ++u) sum_pair(vt, u);
    }
  }
  cp_async_wait<0>();

  bf16* og = static_cast<bf16*>(a.o);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lsum = l[h];
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    const int rg = row0 + 16 * warp + g + 8 * h;
    if (rg >= rows) continue;
    const int pos = rg / a.group;
    const int head = kvh * a.group + (rg - pos * a.group);
    const float denom = lsum == 0.f ? 1.f : lsum;
    bf16* dst = og + b * a.o_sb + head * a.o_sh + pos * a.o_ss;
#pragma unroll
    for (int j = 0; j < DMAX / 8; ++j) {
      const int c = 8 * j + 2 * tig;
      if (c < d)
        *reinterpret_cast<uint32_t*>(dst + c) =
            pack_bf16x2(o[j][2 * h] / denom, o[j][2 * h + 1] / denom);
    }
  }
}

template <int DMAX>
int launch(const Args& a, int b, int hkv, cudaStream_t stream) {
  constexpr int smem = Cfg<DMAX>::kSmemBytes;
  auto kernel = prefill_kernel<DMAX>;
  static bool configured = false;   // once per instantiation, before any capture
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int rows = a.sq * a.group;
  const dim3 grid(hkv, b, (rows + kBlockM - 1) / kBlockM);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// ---------------------------------------------------------------------------
// bf16 decode: split over the keys, then combine
// ---------------------------------------------------------------------------

namespace split {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kCombineThreads = 256;

struct Plan {
  float* part;    // [b][hkv][n_split][rows][2 + d]: m, l, acc
  int lo, hi;     // the visible keys [lo, hi) of the union of the rows
  int chunk;      // keys per split
  int n_split;
};

template <int RMAX, int DMAX>
struct Cfg {
  static constexpr int kLanes = DMAX / 8;          // lanes per key, 16 B each
  static constexpr int kGroups = 32 / kLanes;      // keys per warp step
  static constexpr int kParts = kWarps * kGroups;  // partials per CTA
  // keys in flight per lane, fewer as the rows' registers grow
  static constexpr int kUnroll = RMAX <= 2 ? 4 : 2;
  static constexpr int kSmemBytes =
      kParts * RMAX * (DMAX + 2) * static_cast<int>(sizeof(float));
};

// One CTA per (split, kv head, batch); rows = Sq * G <= RMAX <= 8.
template <int RMAX, int DMAX>
__global__ void __launch_bounds__(kThreads)
split_kernel(const Args a, const Plan p) {
  using C = Cfg<RMAX, DMAX>;
  constexpr int LG = C::kLanes;
  constexpr int U = C::kUnroll;
  constexpr int kStep = C::kParts;     // keys per CTA step
  extern __shared__ float4 smem4[];
  float* sacc = reinterpret_cast<float*>(smem4);        // [kParts][RMAX][DMAX]
  float* sm = sacc + C::kParts * RMAX * DMAX;           // [kParts][RMAX]
  float* sl = sm + C::kParts * RMAX;                    // [kParts][RMAX]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int li = lane % LG;                 // the lane's 8 columns: 8 li ..
  const int grp = lane / LG;                // the lane's key in a warp step
  const int part = (tid >> 5) * C::kGroups + grp;
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int rows = a.sq * a.group;
  const int c0 = p.lo + split * p.chunk;
  const int c1 = min(c0 + p.chunk, p.hi);
  const bool cols = 8 * li < a.d;

  const bf16* qg = static_cast<const bf16*>(a.q) + b * a.q_sb;
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh +
                   8 * li;
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh +
                   8 * li;

  const Logit lg = logit_of(a);
  uint4 q[RMAX];
  int qpos[RMAX];
  float m[RMAX], l[RMAX], acc[RMAX][8];   // m in log2 units
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    const int rr = min(r, rows - 1);
    const int pos = rr / a.group;
    const int head = kvh * a.group + (rr - pos * a.group);
    q[r] = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows && cols)
      q[r] = __ldg(reinterpret_cast<const uint4*>(qg + head * a.q_sh +
                                                   pos * a.q_ss + 8 * li));
    qpos[r] = a.q_offset + pos;
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;
  }

  // base is uniform across the warp, so every lane takes each shuffle
  for (int base = c0 + (tid >> 5) * C::kGroups; base < c1;
       base += kStep * U) {
    uint4 kv[U], vv[U];
    int key[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      key[u] = base + grp + u * kStep;
      kv[u] = vv[u] = make_uint4(0u, 0u, 0u, 0u);
      if (key[u] < c1 && cols) {
        kv[u] = __ldg(reinterpret_cast<const uint4*>(kg + key[u] * a.k_ss));
        vv[u] = __ldg(reinterpret_cast<const uint4*>(vg + key[u] * a.v_ss));
      }
    }
    float s[U][RMAX];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const uint32_t kw[4] = {kv[u].x, kv[u].y, kv[u].z, kv[u].w};
#pragma unroll
      for (int r = 0; r < RMAX; ++r) {
        const uint32_t qw[4] = {q[r].x, q[r].y, q[r].z, q[r].w};
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          x = __fmaf_rn(bf16_lo(qw[e]), bf16_lo(kw[e]), x);
          x = __fmaf_rn(bf16_hi(qw[e]), bf16_hi(kw[e]), x);
        }
#pragma unroll
        for (int off = LG / 2; off > 0; off >>= 1)
          x += __shfl_xor_sync(0xffffffffu, x, off);
        s[u][r] = x;
      }
    }
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      float mx = m[r];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        // a masked key (or one past the chunk) gets -inf: weight exactly 0
        const bool vis = r < rows && key[u] < c1 && visible(a, qpos[r], key[u]);
        s[u][r] = vis ? logit2(lg, s[u][r]) : __int_as_float(0xff800000);
        mx = fmaxf(mx, s[u][r]);
      }
      const float alpha = exp2f(m[r] - mx);
      m[r] = mx;
      float psum = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[r][e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float pr = exp2f(s[u][r] - mx);
        psum += pr;
        const uint32_t vw[4] = {vv[u].x, vv[u].y, vv[u].z, vv[u].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[r][2 * e] = __fmaf_rn(pr, bf16_lo(vw[e]), acc[r][2 * e]);
          acc[r][2 * e + 1] = __fmaf_rn(pr, bf16_hi(vw[e]), acc[r][2 * e + 1]);
        }
      }
      l[r] = l[r] * alpha + psum;
    }
  }

  // merge the CTA's partials (one per warp and key group) in shared memory
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    if (cols)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        sacc[(part * RMAX + r) * DMAX + 8 * li + e] = acc[r][e];
    if (li == 0) {
      sm[part * RMAX + r] = m[r];
      sl[part * RMAX + r] = l[r];
    }
  }
  __syncthreads();
  float* out = p.part + static_cast<int64_t>(
      ((b * gridDim.y + kvh) * p.n_split + split) * rows) * (a.d + 2);
  for (int idx = tid; idx < rows * a.d; idx += kThreads) {
    const int r = idx / a.d;
    const int c = idx - r * a.d;
    float mm = kNegInf;
#pragma unroll
    for (int i = 0; i < C::kParts; ++i) mm = fmaxf(mm, sm[i * RMAX + r]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int i = 0; i < C::kParts; ++i) {
      const float w = exp2f(sm[i * RMAX + r] - mm);
      ll += sl[i * RMAX + r] * w;
      aa += sacc[(i * RMAX + r) * DMAX + c] * w;
    }
    float* dst = out + r * (a.d + 2);
    dst[2 + c] = aa;
    if (c == 0) {
      dst[0] = mm;
      dst[1] = ll;
    }
  }
}

// One CTA per (kv head, batch): sum the splits' partials, rescaled to the
// largest running max, and divide (a row that saw no key gets 0).
__global__ void __launch_bounds__(kCombineThreads)
combine_kernel(const Args a, const Plan p) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int rows = a.sq * a.group;
  const int w = a.d + 2;
  const float* in = p.part + static_cast<int64_t>(
      (b * gridDim.x + kvh) * p.n_split * rows) * w;
  bf16* og = static_cast<bf16*>(a.o);
  for (int idx = threadIdx.x; idx < rows * a.d; idx += kCombineThreads) {
    const int r = idx / a.d;
    const int c = idx - r * a.d;
    float mm = kNegInf;
    for (int s = 0; s < p.n_split; ++s) mm = fmaxf(mm, in[(s * rows + r) * w]);
    float ll = 0.f, aa = 0.f;
    for (int s = 0; s < p.n_split; ++s) {
      const float* x = in + (s * rows + r) * w;
      const float e = exp2f(x[0] - mm);
      ll += x[1] * e;
      aa += x[2 + c] * e;
    }
    const int pos = r / a.group;
    const int head = kvh * a.group + (r - pos * a.group);
    og[b * a.o_sb + head * a.o_sh + pos * a.o_ss + c] =
        __float2bfloat16_rn(aa / (ll == 0.f ? 1.f : ll));
  }
}

template <int RMAX, int DMAX>
int launch(const Args& a, const Plan& p, int b, int hkv, cudaStream_t stream) {
  constexpr int smem = Cfg<RMAX, DMAX>::kSmemBytes;
  auto kernel = split_kernel<RMAX, DMAX>;
  static bool configured = false;   // once per instantiation, before any capture
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  kernel<<<dim3(p.n_split, hkv, b), kThreads, smem, stream>>>(a, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  combine_kernel<<<dim3(hkv, b), kCombineThreads, 0, stream>>>(a, p);
  return static_cast<int>(cudaGetLastError());
}

template <int RMAX>
int launch_d(const Args& a, const Plan& p, int b, int hkv,
             cudaStream_t stream) {
  if (a.d <= 64) return launch<RMAX, 64>(a, p, b, hkv, stream);
  if (a.d <= 128) return launch<RMAX, 128>(a, p, b, hkv, stream);
  return launch<RMAX, 256>(a, p, b, hkv, stream);
}

}  // namespace split

}  // namespace

#define FA_ARGS                                                              \
  const void *q, const void *k, const void *v, void *o, int b, int h,       \
      int hkv, int sq, int sk, int d, long long q_sb, long long q_sh,       \
      long long q_ss, long long k_sb, long long k_sh, long long k_ss,       \
      long long v_sb, long long v_sh, long long v_ss, long long o_sb,       \
      long long o_sh, long long o_ss, int causal, int window, int q_offset, \
      float scale, float softcap
#define FA_STRUCT                                                          \
  Args a {                                                                 \
    q, k, v, o, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, \
        o_sh, o_ss, sq, sk, d, h / hkv, causal, window, q_offset, scale,    \
        softcap                                                            \
  }

// Strides are in elements (D is contiguous). f32: the wrapper checks that
// D is a multiple of 4 and at most 256, every stride a multiple of 4 and
// every base pointer aligned to 16 bytes.
extern "C" int flash_attention_f32_launch(FA_ARGS, cudaStream_t stream) {
  FA_STRUCT;
  return launch_t<float>(a, b, hkv, stream);
}

// bf16: the wrapper checks that D is a multiple of 16 and at most 256,
// every stride a multiple of 8 and every base pointer aligned to 16 bytes.
extern "C" int flash_attention_prefill_launch(FA_ARGS, cudaStream_t stream) {
  FA_STRUCT;
  if (a.d <= 64) return tc::launch<64>(a, b, hkv, stream);
  if (a.d <= 128) return tc::launch<128>(a, b, hkv, stream);
  return tc::launch<256>(a, b, hkv, stream);
}

// bf16 with sq * (h / hkv) <= 8 rows; part holds
// b * hkv * n_split * rows * (d + 2) floats; the splits cover [lo, hi)
// in chunks of `chunk` keys (ref.split_plan).
extern "C" int flash_attention_split_launch(FA_ARGS, float* part, int lo,
                                            int hi, int chunk, int n_split,
                                            cudaStream_t stream) {
  FA_STRUCT;
  const split::Plan p{part, lo, hi, chunk, n_split};
  const int rows = sq * (h / hkv);
  if (rows <= 1) return split::launch_d<1>(a, p, b, hkv, stream);
  if (rows <= 2) return split::launch_d<2>(a, p, b, hkv, stream);
  return split::launch_d<8>(a, p, b, hkv, stream);
}
