// Chunked gated linear attention (GLA / WKV) for Hopper (sm_90a):
//
//   S_t = diag(exp(log_w_t)) S_{t-1} + k_t v_t^T       (S: Dk x Dv, fp32)
//   mamba: y_t = q_t . S_t
//   rwkv:  y_t = q_t . S_{t-1} + (q_t . (u * k_t)) v_t
//
// over q, k, log_w (B, L, H, Dk) and v (B, L, H, Dv), each read in its
// own dtype (float32 or bfloat16) through its strides; y comes out in
// v's dtype, rounded once; the state in and out is fp32 (B, H, Dk, Dv).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssm_scan/kernel.py
// (_gla_kernel / gla_chunked_bhncd).  There the grid was (B*H, chunks),
// the chunk axis sequential, the state in a VMEM scratch, and each chunk
// padded to a multiple of the chunk length by the wrapper.  Here:
//
//   * one block owns one (b, h, slice of Dv) and loops over the chunks,
//     the state slice in shared memory.  A slice needs all of q, k and
//     log_w but only its own columns of v, y and S.  The slice is 64
//     columns when B*H blocks fill most of the SMs (rwkv6 at batch 4:
//     128 blocks), else 16: four slices of Dv = 64 give 128 blocks for
//     32 heads at batch 1, at the price of computing the scores 4 times;
//   * within a chunk, the 16-row query sub-chunks depend only on the
//     chunk's inputs and the state it starts from, so groups of 256
//     threads take one each at a time (4 groups with 16 columns, 2 with
//     64: what shared memory holds), one thread per (query row, key);
//   * rows past L are masked as JAX pads them (q = k = v = 0,
//     log_w = 0), so the final state is exact and nothing is copied;
//   * the intra-chunk decay is NOT JAX's q*exp(lc) times k*exp(-lc),
//     which overflows float32 once a chunk decays by more than e^88
//     (rwkv6-1.6b at init: ln 2 a step, 2^128 over a 128-step chunk).
//     The chunk is cut into 16-row sub-chunks.  Query sub-chunk i
//     against an earlier key sub-chunk j scales q by exp(q_lc_t - r_i),
//     k by exp(e_j - lc_s) and their product by g_ij = exp(r_i - e_j),
//     r_i = q_lc on i's first row, e_j = lc on j's last row; the
//     diagonal 16 x 16 block takes exp(q_lc_t - lc_s) pair by pair.
//     Every exponent is <= 0.  q_lc is lc (mamba) or lc one row earlier
//     (rwkv).  The inter-chunk terms are JAX's, already <= 0.
//   * lc is summed in order down each column, as torch.cumsum does on
//     the GPU along a dimension that is not the innermost, so this
//     kernel and its plain version (repro_torch.nn.linear_attn.
//     gla_chunked, the same arithmetic) see the same exponents.  The
//     products' fp32 sums run in order over their inner index, as
//     cuBLAS's GEMMs take them in the plain version; the diagonal
//     blocks' sums, which the plain version takes with torch.sum, are
//     summed in fp64 in both and rounded once.  So the two agree to far
//     below fp32 summation noise (an output of size ~10 sums terms of
//     size ~8, whose reordering alone moves it by ~1e-5).
//
// What bounds it on an H100: at rwkv6-1.6b's prefill (C = 128,
// Dk = Dv = 64) the flops, C(C-1)/2 live pairs x (2 Dk + 2 Dv) plus
// 4 C Dk Dv per chunk and head: ~0.13 ms at the fp32 FMA peak for
// (4, 2048, 32 heads), against ~0.06 ms for its 204 MB.  This first
// kernel does them as fp32 FMAs from shared memory (no tensor cores;
// at batch 1 the scores are recomputed per Dv slice), plus ~1k expf per
// query row on the diagonal blocks; wgmma/TMA are later work.  No fast
// math: denormals and an accurate expf matter in the decayed terms.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int SUB = 16;           // rows of a sub-chunk
constexpr int CMAX = 128;         // longest chunk
constexpr int DKMAX = 64;         // widest Dk
constexpr int GROUP = SUB * SUB;  // threads of one sub-chunk group
constexpr int DKS = DKMAX + 1;    // odd row stride: rows on distinct banks

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* w;
  const float* bonus;  // (H, Dk)
  const float* s0;     // (B, H, Dk, Dv) or null (zeros)
  void* y;
  float* sfin;         // (B, H, Dk, Dv)
  long long q_b, q_l, q_h, k_b, k_l, k_h, v_b, v_l, v_h, w_b, w_l, w_h,
      y_b, y_l, y_h;
  int L, H, Dk, Dv, C, rwkv;
  int q_bf, k_bf, v_bf, w_bf;  // 1 = bfloat16, 0 = float32 (y: v_bf)
};

// what one group needs for its query sub-chunk
struct Group {
  float att[SUB][CMAX + 1];  // the sub-chunk's scores
  float qh[SUB][DKS];        // q-hat
  float qx[SUB][DKS];        // q * exp(q_lc): the state's readout
  float g[CMAX / SUB][DKS];  // exp(r_i - e_j) for each earlier j
};

template <int DVS, int NG>
struct Smem {
  float q[CMAX][DKS];
  float k[CMAX][DKS];
  float lc[CMAX][DKS];   // log_w, then its inclusive cumsum down C
  float kh[CMAX][DKS];   // k-hat, then k decayed to the chunk's end
  float v[CMAX][DVS];
  float s[DKMAX][DVS];   // the state slice
  float u[DKMAX];
  Group grp[NG];
};

// read-only global loads (ld.global.nc): the compiler may issue them
// ahead of the shared-memory stores between them
__device__ __forceinline__ float ld(const void* p, long long i, int bf) {
  return bf ? __bfloat162float(__ushort_as_bfloat16(
                  __ldg(static_cast<const unsigned short*>(p) + i)))
            : __ldg(static_cast<const float*>(p) + i);
}

__device__ __forceinline__ void st(void* p, long long i, float x, int bf) {
  if (bf)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(x);  // nearest even
  else
    static_cast<float*>(p)[i] = x;
}

// the query side's cumulative log-decay on `row`
__device__ __forceinline__ float q_lc(const float (*lc)[DKS], int row, int d,
                                      int rwkv) {
  return rwkv ? (row > 0 ? lc[row - 1][d] : 0.f) : lc[row][d];
}

// scores of query row tr of the group's sub-chunk against key
// j * SUB + tc of each of the NJ earlier sub-chunks: one fp32 FMA chain
// per j, in order over d
template <int NJ>
__device__ __forceinline__ void off_diagonal(Group& gr,
                                             const float (*kh)[DKS], int tr,
                                             int tc, int Dk) {
  float acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.f;
  for (int d = 0; d < Dk; ++d) {
    const float qd = gr.qh[tr][d];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      acc[j] = fmaf(qd * gr.g[j][d], kh[j * SUB + tc][d], acc[j]);
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) gr.att[tr][j * SUB + tc] = acc[j];
}

// NG groups of 256 threads each take a query sub-chunk of the chunk at
// a time (sub-chunks depend only on the chunk's inputs and the state it
// starts from), in a zigzag so that their work, which grows with the
// sub-chunk's index, evens out
template <int DVS, int NG>
__global__ void __launch_bounds__(GROUP * NG) ssm_scan_kernel(Params p) {
  constexpr int NT = GROUP * NG;
  constexpr int YC = DVS / SUB;       // y columns per thread
  constexpr int TPR = NT / DKMAX;     // threads per state row
  constexpr int SC = DVS / TPR;       // state columns per thread
  static_assert(SC >= 1 && DVS % TPR == 0, "state update map");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<DVS, NG>& sm = *reinterpret_cast<Smem<DVS, NG>*>(smem_raw);
  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int dv0 = blockIdx.y * DVS;
  const int ncol = min(DVS, p.Dv - dv0);
  const int Dk = p.Dk, C = p.C, rwkv = p.rwkv, ns = C / SUB;
  const long long qo = b * p.q_b + h * p.q_h, ko = b * p.k_b + h * p.k_h,
                  vo = b * p.v_b + h * p.v_h + dv0,
                  wo = b * p.w_b + h * p.w_h,
                  yo = b * p.y_b + h * p.y_h + dv0;
  const long long so = (long long)bh * Dk * p.Dv + dv0;
  const int gi = tid / GROUP;   // this thread's group
  const int lt = tid % GROUP;   // and its place in it:
  const int tr = lt / SUB;      // query row in the sub-chunk
  const int tc = lt % SUB;      // key in a sub-chunk; y columns tc + SUB m
  const int sd = tid / TPR;     // the state update's row d, and its
  const int sr = tid % TPR;     // columns sr + TPR m (distinct banks)
  Group& gr = sm.grp[gi];

  for (int e = tid; e < DKMAX * DVS; e += NT) {
    const int d = e / DVS, c = e % DVS;
    sm.s[d][c] = (p.s0 != nullptr && d < Dk && c < ncol)
                     ? p.s0[so + (long long)d * p.Dv + c]
                     : 0.f;
  }
  for (int d = tid; d < DKMAX; d += NT)
    sm.u[d] = d < Dk ? p.bonus[h * Dk + d] : 0.f;

  const int nchunks = (p.L + C - 1) / C;
  for (int n = 0; n < nchunks; ++n) {
    const int l0 = n * C;
    __syncthreads();  // the last chunk's state update is done with smem
#pragma unroll 4
    for (int e = tid; e < C * Dk; e += NT) {
      const int t = e / Dk, d = e % Dk;
      const long long l = l0 + t;
      const bool ok = l < p.L;
      sm.q[t][d] = ok ? ld(p.q, qo + l * p.q_l + d, p.q_bf) : 0.f;
      sm.k[t][d] = ok ? ld(p.k, ko + l * p.k_l + d, p.k_bf) : 0.f;
      sm.lc[t][d] = ok ? ld(p.w, wo + l * p.w_l + d, p.w_bf) : 0.f;
    }
#pragma unroll 4
    for (int e = tid; e < C * DVS; e += NT) {
      const int t = e / DVS, c = e % DVS;
      const long long l = l0 + t;
      sm.v[t][c] = (l < p.L && c < ncol)
                       ? ld(p.v, vo + l * p.v_l + c, p.v_bf)
                       : 0.f;
    }
    __syncthreads();
    if (tid < Dk) {  // in order down the column, as torch.cumsum
      float acc = 0.f;
      for (int t = 0; t < C; ++t) {
        acc += sm.lc[t][tid];
        sm.lc[t][tid] = acc;
      }
    }
    __syncthreads();
    for (int e = tid; e < C * Dk; e += NT) {
      const int t = e / Dk, d = e % Dk;
      const float last = sm.lc[(t / SUB) * SUB + SUB - 1][d];
      sm.kh[t][d] = sm.k[t][d] * expf(last - sm.lc[t][d]);
    }

    for (int r = 0; r * NG < ns; ++r) {
      const int i = r * NG + (r % 2 ? NG - 1 - gi : gi);
      const bool active = i < ns;
      const int t0 = i * SUB;
      const int row = t0 + tr;
      if (active) {
        for (int e = lt; e < SUB * Dk; e += GROUP) {
          const int t = e / Dk, d = e % Dk;
          const float ql = q_lc(sm.lc, t0 + t, d, rwkv);
          gr.qh[t][d] = sm.q[t0 + t][d] * expf(ql - q_lc(sm.lc, t0, d, rwkv));
          gr.qx[t][d] = sm.q[t0 + t][d] * expf(ql);
        }
        for (int e = lt; e < i * Dk; e += GROUP) {
          const int j = e / Dk, d = e % Dk;
          gr.g[j][d] =
              expf(q_lc(sm.lc, t0, d, rwkv) - sm.lc[j * SUB + SUB - 1][d]);
        }
      }
      __syncthreads();
      if (active) {
        switch (i) {  // a compile-time count of chains for each i
          case 1: off_diagonal<1>(gr, sm.kh, tr, tc, Dk); break;
          case 2: off_diagonal<2>(gr, sm.kh, tr, tc, Dk); break;
          case 3: off_diagonal<3>(gr, sm.kh, tr, tc, Dk); break;
          case 4: off_diagonal<4>(gr, sm.kh, tr, tc, Dk); break;
          case 5: off_diagonal<5>(gr, sm.kh, tr, tc, Dk); break;
          case 6: off_diagonal<6>(gr, sm.kh, tr, tc, Dk); break;
          case 7: off_diagonal<7>(gr, sm.kh, tr, tc, Dk); break;
          default: break;
        }
        // the diagonal block, pair by pair after the mask, summed in fp64
        // and rounded once (the plain version's sum takes its own order);
        // rwkv's bonus takes the (masked) diagonal
        const int key = t0 + tc;
        double acc = 0.0;
        if (rwkv ? tc < tr : tc <= tr) {
          for (int d = 0; d < Dk; ++d)
            acc = fma((double)sm.q[row][d] * (double)sm.k[key][d],
                      (double)expf(q_lc(sm.lc, row, d, rwkv) - sm.lc[key][d]),
                      acc);
        } else if (rwkv && tc == tr) {
          for (int d = 0; d < Dk; ++d)
            acc = fma((double)sm.q[row][d] * (double)sm.u[d],
                      (double)sm.k[row][d], acc);
        }
        gr.att[tr][key] = (float)acc;
      }
      __syncthreads();
      if (active) {  // y = att v + q_x S, each sum in order, as the GEMMs
        float intra[YC], inter[YC];
#pragma unroll
        for (int m = 0; m < YC; ++m) intra[m] = inter[m] = 0.f;
        for (int s = 0; s < t0 + SUB; ++s) {
          const float a = gr.att[tr][s];
#pragma unroll
          for (int m = 0; m < YC; ++m)
            intra[m] = fmaf(a, sm.v[s][tc + SUB * m], intra[m]);
        }
        for (int d = 0; d < Dk; ++d) {
          const float x = gr.qx[tr][d];
#pragma unroll
          for (int m = 0; m < YC; ++m)
            inter[m] = fmaf(x, sm.s[d][tc + SUB * m], inter[m]);
        }
        const long long l = l0 + row;
#pragma unroll
        for (int m = 0; m < YC; ++m)
          if (l < p.L && tc + SUB * m < ncol)
            st(p.y, yo + l * p.y_l + tc + SUB * m, intra[m] + inter[m],
               p.v_bf);
      }
      __syncthreads();  // before the groups' buffers are rewritten
    }

    // S <- S * exp(lc_C) + (k * exp(lc_C - lc))^T v
    for (int e = tid; e < C * Dk; e += NT) {
      const int t = e / Dk, d = e % Dk;
      sm.kh[t][d] = sm.k[t][d] * expf(sm.lc[C - 1][d] - sm.lc[t][d]);
    }
    __syncthreads();
    if (sd < Dk) {  // each sum in order over t, as the plain GEMM
      float a[SC];
#pragma unroll
      for (int m = 0; m < SC; ++m) a[m] = 0.f;
      for (int t = 0; t < C; ++t) {
        const float kv = sm.kh[t][sd];
#pragma unroll
        for (int m = 0; m < SC; ++m)
          a[m] = fmaf(kv, sm.v[t][sr + TPR * m], a[m]);
      }
      const float decay = expf(sm.lc[C - 1][sd]);
#pragma unroll
      for (int m = 0; m < SC; ++m)  // rounded twice, as the plain version
        sm.s[sd][sr + TPR * m] =
            __fadd_rn(__fmul_rn(sm.s[sd][sr + TPR * m], decay), a[m]);
    }
  }
  __syncthreads();
  for (int e = tid; e < Dk * DVS; e += NT) {
    const int d = e / DVS, c = e % DVS;
    if (c < ncol) p.sfin[so + (long long)d * p.Dv + c] = sm.s[d][c];
  }
}

template <int DVS, int NG>
int launch(const Params& p, int B, cudaStream_t stream) {
  const int bytes = (int)sizeof(Smem<DVS, NG>);
  // above 48 KB of dynamic shared memory only after this (per device)
  const cudaError_t err = cudaFuncSetAttribute(
      ssm_scan_kernel<DVS, NG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * p.H), (unsigned)((p.Dv + DVS - 1) / DVS));
  ssm_scan_kernel<DVS, NG><<<grid, GROUP * NG, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, w (log_w) (B, L, H, Dk); v, y (B, L, H, Dv); unit stride in the
// last axis and the strides given for b, l and h (in elements).  bonus
// (H, Dk) fp32 (zeros for mamba); s0 (B, H, Dk, Dv) fp32 contiguous or
// null; sfin (B, H, Dk, Dv) fp32 contiguous.  *_bf: 1 = bfloat16,
// 0 = float32 (y takes v's).  1 <= Dk <= 64; C a multiple of 16 up to
// 128.  Launches on `stream`; returns the CUDA error (0 = launched).
extern "C" int ssm_scan_fwd(
    const void* q, const void* k, const void* v, const void* w,
    const float* bonus, const float* s0, void* y, float* sfin, int B,
    int L, int H, int Dk, int Dv, int C, int rwkv, long long q_b,
    long long q_l, long long q_h, long long k_b, long long k_l,
    long long k_h, long long v_b, long long v_l, long long v_h,
    long long w_b, long long w_l, long long w_h, long long y_b,
    long long y_l, long long y_h, int q_bf, int k_bf, int v_bf, int w_bf,
    void* stream) {
  if (B <= 0 || H <= 0 || L < 0 || Dk < 1 || Dk > DKMAX || Dv < 1 ||
      C < SUB || C > CMAX || C % SUB != 0 ||
      (long long)B * H > 0x7fffffffLL || (Dv + 15) / 16 > 65535)
    return (int)cudaErrorInvalidValue;
  const Params p{q,   k,   v,   w,   bonus, s0,   y,    sfin, q_b,  q_l,
                 q_h, k_b, k_l, k_h, v_b,   v_l,  v_h,  w_b,  w_l,  w_h,
                 y_b, y_l, y_h, L,   H,     Dk,   Dv,   C,    rwkv, q_bf,
                 k_bf, v_bf, w_bf};
  // a block owns 64 columns of Dv when that still gives most SMs a block
  // (the scores are computed once for every column), else 16 (the
  // scores are recomputed for each of the narrower slices, but there are
  // 4 times as many blocks)
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // (the groups of a block: as many as fit in shared memory)
  if (4LL * B * H * ((Dv + 63) / 64) >= 3LL * sms)
    return launch<64, 2>(p, B, s);
  return launch<16, 4>(p, B, s);
}

extern "C" const char* ssm_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
