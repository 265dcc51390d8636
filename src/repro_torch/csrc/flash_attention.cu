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
// (src/repro/kernels/flash_attention/flash_attention.py:90, body
// `_flash_kernel`), which walked a sequential (B*H, q-block, k-block) grid
// with the running max / denominator / accumulator in VMEM scratch and
// folded GQA through the k/v BlockSpec index map. Here one CTA owns one
// (batch, kv head, tile of 16*R query rows), where the rows are the GQA
// group's query heads folded into the positions (row = pos * G + g), so
// each K/V tile is read once for the whole group. The CTA loops over K/V
// tiles of 32 keys staged in shared memory as f32, keeps the running max,
// denominator and accumulator of its rows in f32 registers, and at the end
// divides by the denominator (0 -> 1, as the TPU kernel does). Tiles wholly
// masked for the CTA's rows (past the causal diagonal, before the sliding
// window) are skipped: that is exact, since a masked logit's exp is 0 once
// a visible key has set the running max.
//
// Inputs are f32 or bf16 (widened to f32 in shared memory); arithmetic is
// f32 on the CUDA cores, each inner product a chain of explicit
// __fmaf_rn (the build passes -fmad=false for the session kernels'
// bit-identity). Every tensor is addressed through its own batch / head /
// sequence strides with D contiguous, so (B, H, S, D) tensors, the model's
// (B, S, H, D) views and slices of the decode cache launch without copies.
//
// What bounds it on the card: prefill is bound by operations (4 * D flops
// per visible (query, key) pair and head); decode (one query position) by
// bytes (the visible keys' K and V rows, read once per kv head). This first
// version uses the CUDA cores in f32, not the tensor cores (mma/wgmma, TMA
// and split-KV decode are later work).
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
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
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

}  // namespace

// Strides are in elements (D is contiguous); the wrapper checks that D is
// a multiple of 4 and at most 256, that every stride is a multiple of 4 and
// that every base pointer is aligned to 4 elements.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int b, int h,
    int hkv, int sq, int sk, int d, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, int causal, int window, int q_offset,
    float scale, float softcap, int bf16, cudaStream_t stream) {
  Args a{q, k, v, o, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
         o_sb, o_sh, o_ss, sq, sk, d, h / hkv, causal, window, q_offset,
         scale, softcap};
  if (bf16) return launch_t<__nv_bfloat16>(a, b, hkv, stream);
  return launch_t<float>(a, b, hkv, stream);
}
