// Flash attention (forward) for Hopper (sm_90a):
//
//   o[b, i, h, :] = sum_j p_ij v[b, j, h/(H/KV), :] / max(sum_j p_ij, 1e-20)
//   p_ij = mask_ij ? exp(s_ij - max_j' s_ij') : 0,
//   s_ij = (q[b, i, h, :] / sqrt(D)) . k[b, j, h/(H/KV), :]
//
// with query i at absolute position i + Sk - Sq (the keys before the
// queries are their history), and key j masked when causal and
// j > i + Sk - Sq, or with a window when j <= i + Sk - Sq - window.  The
// port pads nothing, so the Pallas kernel's valid_k is always Sk here:
// the keys past Sk in the last tile are the only padded ones, masked.
// Masked scores are -2e9 (not -inf), so a row with no live key stays
// finite and comes out as 0.  m, l and the accumulator are fp32
// whatever the input type (fp32 or bf16); the output is in q's type.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/
// kernel.py (_flash_kernel / flash_attention_bhsd).  There the grid's
// innermost, sequential k axis carried (m, l, acc) in VMEM scratch from
// one grid step to the next, over (BH, S, D) copies padded to block
// multiples.  Here:
//
//   * one block of 128 threads owns one (b, h, 64-query tile) and walks
//     the key tiles in a loop, so (m, l, acc) stay in registers;
//   * it reads the (B, S, H, D) tensors in place through their strides
//     and masks the ragged ends itself: no pad or transpose copies;
//   * GQA: K/V keep their KV heads, and query head h reads KV head
//     h / (H / KV), so the H/KV-fold repeated K/V is never written;
//   * key tiles that lie wholly before a tile's window or after its
//     last query (causal) are skipped: they would add p = 0 only;
//   * q^T (pre-scaled), k^T, v and p^T tiles are staged in shared memory
//     as fp32; each thread owns a 4-row x 8-key block of the scores and
//     a 4-row x D/8 block of the accumulator, so every float4 load from
//     shared memory feeds 8-32 FMAs.  The row max is taken across the 8
//     threads of a row by warp shuffles; the row sum l is kept per thread
//     (the rescale factor is the same for all 8) and added up at the end;
//   * blocks are issued heaviest first (the last query tiles of a causal
//     row see the most keys).
//
// What bounds it on an H100: at the serving shapes (D = 64, bf16) the
// QK^T and PV products, 4 D flops per live (query, key) pair; on the
// tensor cores that is ~69 us a launch at (4, 2048, 32, 64) causal.
// This first kernel does them as fp32 FMAs without tensor cores (67
// TFLOP/s peak), which also keeps fp32 inputs within fp32 rounding of
// the reference.  wgmma/TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // queries per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 128;  // 16 row groups of 4 rows x 8 threads each
constexpr int PAD = 4;        // keeps float4 alignment, spreads banks
constexpr int QS = BQ + PAD;  // row stride of q^T and p^T in shared memory
constexpr int KS = BK + PAD;  // row stride of k^T
constexpr float NEG_INF = -2.0e9f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h;
  int H, KV, Sq, Sk, causal, window;  // window 0 = none
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

template <int D>
constexpr int smem_bytes() {
  return (D * QS + D * KS + BK * D + BK * QS) * (int)sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(Params p) {
  constexpr int VEC = D >= 32 ? 4 : 2;  // accumulator dims per load
  constexpr int NCH = D / (8 * VEC);    // such loads per key
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;            // [D][QS]  q^T * scale
  float* kt = qt + D * QS;     // [D][KS]  k^T
  float* vs = kt + D * KS;     // [BK][D]  v
  float* pt = vs + BK * D;     // [BK][QS] p^T

  const int tid = threadIdx.x;
  const int rg = tid >> 3;  // rows 4 rg .. 4 rg + 3 of the tile
  const int cg = tid & 7;   // keys 4 cg + {0..3} and 32 + 4 cg + {0..3}
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.KV);
  const T* q = static_cast<const T*>(p.q) + b * p.q_b + h * p.q_h;
  const T* k = static_cast<const T*>(p.k) + b * p.k_b + hk * p.k_h;
  const T* v = static_cast<const T*>(p.v) + b * p.v_b + hk * p.v_h;
  T* o = static_cast<T*>(p.o) + b * p.o_b + h * p.o_h;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D;
    qt[d * QS + r] =
        q0 + r < p.Sq ? to_f(q[(q0 + r) * p.q_s + d]) * p.scale : 0.f;
  }

  // keys any row of this tile can see: [kbeg, kend)
  const int offset = p.Sk - p.Sq;
  const int qlo = q0 + offset;
  const int qhi = min(q0 + BQ, p.Sq) - 1 + offset;
  const int kend = p.causal ? min(p.Sk, qhi + 1) : p.Sk;
  const int kbeg = p.window > 0 ? max(0, qlo - p.window + 1) : 0;

  float acc[4][NCH * VEC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NCH * VEC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = kbeg / BK * BK; k0 < kend; k0 += BK) {
    __syncthreads();  // the last tile's k^T, v and p^T are no longer read
    for (int e = tid; e < BK * D; e += THREADS) {
      const int c = e / D, d = e % D;
      const bool in = k0 + c < p.Sk;
      kt[d * KS + c] = in ? to_f(k[(k0 + c) * p.k_s + d]) : 0.f;
      vs[c * D + d] = in ? to_f(v[(k0 + c) * p.v_s + d]) : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&qt[d * QS + 4 * rg]);
      const float4 b0 = *reinterpret_cast<const float4*>(&kt[d * KS + 4 * cg]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&kt[d * KS + 32 + 4 * cg]);
      const float ar[4] = {a.x, a.y, a.z, a.w};
      const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(ar[i], br[j], s[i][j]);
    }

    // mask, then the online softmax of rows 4 rg + i over this tile
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * rg + i + offset;
      bool live[8];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + (j < 4 ? 4 * cg + j : 32 + 4 * cg + j - 4);
        live[j] = kpos < p.Sk && (!p.causal || kpos <= qpos) &&
                  (p.window <= 0 || kpos > qpos - p.window);
        s[i][j] = live[j] ? s[i][j] : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = live[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += s[i][j];
      }
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NCH * VEC; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = j < 4 ? 4 * cg + j : 32 + 4 * cg + j - 4;
      *reinterpret_cast<float4*>(&pt[c * QS + 4 * rg]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(&pt[c * QS + 4 * rg]);
      const float ar[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
        const float* vrow = &vs[c * D + 8 * VEC * ch + VEC * cg];
        float vr[VEC];
        if constexpr (VEC == 4) {
          const float4 t = *reinterpret_cast<const float4*>(vrow);
          vr[0] = t.x; vr[1] = t.y; vr[2] = t.z; vr[3] = t.w;
        } else {
          const float2 t = *reinterpret_cast<const float2*>(vrow);
          vr[0] = t.x; vr[1] = t.y;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[i][ch * VEC + e] = fmaf(ar[i], vr[e], acc[i][ch * VEC + e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    li += __shfl_xor_sync(0xffffffffu, li, 4);
    const float denom = fmaxf(li, 1e-20f);
    const int r = q0 + 4 * rg + i;
    if (r >= p.Sq) continue;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        o[r * p.o_s + 8 * VEC * ch + VEC * cg + e] =
            from_f<T>(acc[i][ch * VEC + e] / denom);
  }
}

template <typename T, int D>
int launch(const Params& p, int B, cudaStream_t stream) {
  // above 48 KB of dynamic shared memory only after this (per device)
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<D>());
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((p.Sq + BQ - 1) / BQ), (unsigned)p.H,
                  (unsigned)B);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem_bytes<D>(), stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const Params& p, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(p, B, stream);
    case 32: return launch<T, 32>(p, B, stream);
    case 64: return launch<T, 64>(p, B, stream);
    case 128: return launch<T, 128>(p, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Sq, H, D), k and v (B, Sk, KV, D), o (B, Sq, H, D), each with
// unit stride in D and the strides given for b, s and h (in elements).
// dtype 0 = float32, 1 = bfloat16 (all four tensors).  window <= 0 means
// none.  Launches on `stream`; returns the CUDA error (0 = launched).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int KV, int Sq, int Sk, int D, long long q_b, long long q_s,
    long long q_h, long long k_b, long long k_s, long long k_h,
    long long v_b, long long v_s, long long v_h, long long o_b,
    long long o_s, long long o_h, int causal, int window, float scale,
    int dtype, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk <= 0 ||
      H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const Params p{q,   k,   v,   o,   q_b, q_s, q_h,    k_b,    k_s,
                 k_h, v_b, v_s, v_h, o_b, o_s, o_h,    H,      KV,
                 Sq,  Sk,  causal, window, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(p, B, D, s);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(p, B, D, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
