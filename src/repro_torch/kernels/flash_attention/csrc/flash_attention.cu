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
// multiples.  Here a block owns one (b, h, 64-query tile) and walks the
// key tiles in a loop, (m, l, acc) in registers; it reads the
// (B, S, H, D) tensors in place through their strides; K/V keep their KV
// heads (query head h reads KV head h / (H / KV)); key tiles wholly
// outside a query tile's causal or window range are skipped.  Two
// kernels sit behind the one entry point, chosen by dtype:
//
// bf16 (the serve path): the tensor cores, flash_fwd_tc_kernel.
//   What bounds it: the QK^T and PV products, 4 D bf16 tensor-core flops
//   per live (query, key) pair, ~69 us a launch at (4, 2048, 32/8, 64)
//   causal at the dense bf16 peak; at D = 64 the exp of each pair (MUFU,
//   16 a clock an SM) takes about as long, so the two share the pace.
//   Design (Hopper's own path: wgmma with TMA staging):
//   * one warpgroup (4 warps) computes the block's 64 query rows, 16 a
//     warp; a fifth warp is the producer: one thread loads the Q tile,
//     then the K/V tiles of 64 keys, by TMA into a ring of two stages
//     with mbarriers (tile j + 1 lands while tile j computes).  TMA
//     swizzles the tiles as the wgmma descriptors read them and
//     zero-fills rows past Sq or Sk.  3 blocks an SM (2 at D = 112 and
//     128, 1 at 256).
//   * D = 112 (zamba2-7b's shared attention) is staged and multiplied as
//     DP = 128: TMA's tensor map keeps the real 112 columns and fills
//     columns 112-127 with zeros, which add nothing to the scores; P V's
//     columns past 112 are never stored.  It costs 1/8 more MMA work.
//     D = 256 (gemma-7b) holds a 64 x 256 fp32 output tile, 128
//     registers a thread, beside S and P's halves; P V runs as
//     m64n256k16 wgmmas (two a k-step: P's hi and lo halves).
//   * S = QK^T by wgmma m64n64k16 with both operands in shared memory
//     (bf16 in, exact products, fp32 sums); the 1/sqrt(D) scale (times
//     log2 e) is applied to the fp32 score, never to bf16 q.  The online
//     softmax stays in registers: the row max from quad shuffles of the
//     accumulator layout, l summed in fp32 from the unrounded p.
//   * O += PV by wgmma with P from registers: the accumulator fragment of
//     S is the A fragment of the next product (as in FlashAttention-3),
//     V (MN-major) from shared memory.  P is split into p_hi = bf16(p)
//     and p_lo = bf16(p - p_hi), two wgmmas against the same V, so the
//     product sees p to ~16 bits.  One bf16 rounding of p (what SDPA's
//     flash path does) breaks this kernel's bar against its plain
//     version, one bf16 ulp of the output: emulated on the CPU with
//     N(0, 1) inputs it puts 13,556 of 131,072 elements beyond it at
//     (1, 512, 4, 64) causal, 14,111 at (1, 1024, 2, 64) with a window of
//     256, 1,670 of 16,384 at D = 16 and 6,681 of 65,536 at D = 128; TF32
//     P still 126-1,023; the hi/lo split none (max error 1.95e-3).  The
//     split costs 1.5x the function's MMA flops, and the tensor cores set
//     the pace (a timing-only build without the exp was no faster, one
//     without the lo product markedly faster).
//   * Key tiles wholly inside the causal and window range and inside Sk
//     take a body with no mask arithmetic (a template flag); only tiles
//     that straddle the diagonal, the window's lower edge or Sk's end
//     take the masked body.
//   * Blocks are issued heaviest first: the grid's slowest axis walks
//     the query tiles from the last (which sees the most keys) down.
//   The same design with mma.sync m16n8k16 and cp.async staging
//   (FlashAttention-2's shape) was built first and was slower at both
//   serve shapes; this one replaced it.  Overlapping one tile's softmax
//   with the next tile's QK^T, 128-key tiles, a third stage, two
//   warpgroups a block (two query tiles, or two heads sharing each K/V
//   tile) and 4 blocks an SM without the producer warp were each tried
//   and measured no faster at these shapes.
//
// fp32: the SIMT kernel, flash_fwd_kernel.  q^T (pre-scaled), k^T, v and
//   p^T tiles staged in shared memory as fp32; each thread owns a 4-row x
//   8-key block of the scores and a 4-row x D/8 block of the
//   accumulator, fp32 FMAs (67 TFLOP/s peak), which keeps fp32 inputs
//   within fp32 rounding of the reference.  At D = 256 its tiles take
//   222,208 bytes of shared memory, under the 232,448 a block may opt
//   into.  Only tests and checks pass fp32.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

template <int D>
constexpr int smem_bytes() {
  return (D * QS + D * KS + BK * D + BK * QS) * (int)sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(Params p) {
  // accumulator dims per load (2 where 32 does not divide D: 16, 112)
  constexpr int VEC = D % 32 == 0 ? 4 : 2;
  constexpr int NCH = D / (8 * VEC);  // such loads per key
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


// ------------------------------------------------- bf16: wgmma and TMA

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int THREADS = 160;  // one consumer warpgroup + one producer warp
constexpr int STAGES = 2;     // K/V ring
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  CUtensorMap qmap, kmap, vmap;  // (D, heads, S, B) in boxes of 64 rows
  void* o;
  long long o_b, o_s, o_h;
  int H, KV, Sq, Sk, causal, window;
  float scale;
};

// A tile of 64 rows in shared memory: D >= 64 as DP / 64 blocks of
// 128-byte rows (64 columns), each block swizzled as TMA's 128B mode
// writes it; D = 32 and 16 as one block of 64- or 32-byte rows in the
// 64B / 32B modes.  The wgmma descriptors name the same swizzle (MODE).
// DP is D rounded up to a whole block (112 -> 128): TMA zero-fills the
// columns past D, which add nothing to Q K^T and give P V columns that
// are never stored, so the products run at DP and only D is written.
template <int D>
struct Geo {
  static constexpr int DP = D < 64 ? D : (D + 63) / 64 * 64;
  static constexpr int RB = DP >= 64 ? 128 : 2 * DP;  // bytes a row a block
  static constexpr int NSUB = DP >= 64 ? DP / 64 : 1;
  static constexpr uint32_t MODE = RB == 128 ? 1 : RB == 64 ? 2 : 3;
  static constexpr int TILE = BQ * DP * 2;  // bytes of a Q, K or V tile
  static constexpr int SMEM = 1024 + (1 + 2 * STAGES) * TILE + 64;
  // blocks an SM: shared memory allows 3 up to DP = 64, 2 at 128, 1 at 256
  static constexpr int BLOCKS = DP >= 256 ? 1 : DP >= 128 ? 2 : 3;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory matrix descriptor
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint32_t mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)mode << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// returns once the barrier's phase with this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// the box at coordinates (c0 innermost .. c3) of `map` into shared
// memory, completing transaction bytes on `bar`; boxes past the tensor's
// end are zero-filled
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accesses of r across a wgmma fence/wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[BK / 16][4]) {
#pragma unroll
  for (int i = 0; i < BK / 16; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (+)= A B, m64n64k16: A (64 x 16) and B (16 x 64, K-major) from
// shared memory through their descriptors; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d += A B, m64nNk16 with N = 2 x d's length: A (64 x 16) from
// registers (the m16n8k16 A fragment, warp w of the group holding rows
// 16 w .. 16 w + 15), B (16 x N, MN-major) from shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[8],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7},"
      " {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}

__device__ __forceinline__ float ex2(float x) {  // 2^x, 0 for -inf
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // a in the low half
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Thread (warp w, lane) holds rows 16 w + g and 16 w + g + 8 (g = lane / 4)
// of the S and O tiles: element 4 j + e is column 8 j + 2 (lane % 4) + e % 2
// of row 16 w + g + 8 (e / 2), the m16n8k16 C layout repeated along N.

// S = Q K^T over DP in k-steps of 16, issued and awaited
template <int D>
__device__ __forceinline__ void qk(float (&s)[BK / 2], uint32_t q_a,
                                   uint32_t k_a) {
  using G = Geo<D>;
  constexpr int KPA = G::RB / 32;  // k-steps within a block's row
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < G::DP / 16; ++ks) {
    const uint32_t off = (ks / KPA) * (BQ * G::RB) + (ks % KPA) * 32;
    wgmma_ss(s, desc(q_a + off, 0, 8 * G::RB, G::MODE),
             desc(k_a + off, 0, 8 * G::RB, G::MODE), ks > 0);
  }
  wgmma_commit();
  wgmma_wait();
  fence_regs(s);
}

// O += P V over the tile's keys in k-steps of 16, P as bf16 hi and lo
// halves, issued and awaited.  V (keys x D) is MN-major: 8-key groups
// SBO apart, 64-column blocks LBO apart.
template <int D>
__device__ __forceinline__ void pv(float (&o)[Geo<D>::DP / 2],
                                   uint32_t (&ph)[BK / 16][4],
                                   uint32_t (&pl)[BK / 16][4],
                                   uint32_t v_a) {
  using G = Geo<D>;
  fence_regs(o);
  fence_regs(ph);
  fence_regs(pl);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t vd =
        desc(v_a + kk * 16 * G::RB, BK * G::RB, 8 * G::RB, G::MODE);
    wgmma_rs(o, ph[kk], vd);
    wgmma_rs(o, pl[kk], vd);
  }
  wgmma_commit();
  wgmma_wait();
  fence_regs(o);
}

// The online softmax of one tile: s becomes p (0 where masked), m and l
// move on, O is rescaled.  MASK: the tile straddles the diagonal, the
// window's lower edge or Sk's end; the others take no mask arithmetic.
template <int D, bool MASK>
__device__ __forceinline__ void softmax(float (&s)[BK / 2],
                                        float (&o)[Geo<D>::DP / 2],
                                        float (&m)[2], float (&l)[2], int k0,
                                        int qpos, const Params& p, float c,
                                        int lane) {
  if constexpr (MASK) {
    const int t2 = 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int kpos = k0 + 8 * (i / 4) + t2 + (i & 1);
      const int qp = qpos + 8 * ((i >> 1) & 1);
      const bool dead = kpos >= p.Sk || (p.causal && kpos > qp) ||
                        (p.window > 0 && kpos <= qp - p.window);
      if (dead) s[i] = __int_as_float(0xff800000);  // -inf: p = 0
    }
  }
  // the 4 threads of a quad hold one row's 64 scores
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = m[r];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float corr = ex2((m[r] - mx) * c);
    const float ms = mx * c;
    m[r] = mx;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        s[4 * j + e] = ex2(fmaf(s[4 * j + e], c, -ms));
        sum += s[4 * j + e];
      }
    l[r] = l[r] * corr + sum;
#pragma unroll
    for (int j = 0; j < Geo<D>::DP / 8; ++j) {
      o[4 * j + 2 * r] *= corr;
      o[4 * j + 2 * r + 1] *= corr;
    }
  }
}

// S's C fragment as the A fragment of PV (as in FlashAttention-2):
// k-step kk holds keys 16 kk .. 16 kk + 15.  Each p is split into
// hi = bf16(p) and lo = bf16(p - hi).
__device__ __forceinline__ void split_p(const float (&s)[BK / 2],
                                        uint32_t (&ph)[BK / 16][4],
                                        uint32_t (&pl)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = s[8 * kk + 2 * i], b = s[8 * kk + 2 * i + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      const float2 hf = __bfloat1622float2(h);
      ph[kk][i] = *reinterpret_cast<const uint32_t*>(&h);
      pl[kk][i] = pack(a - hf.x, b - hf.y);
    }
}

// Warps 0-3 (one warpgroup) compute the block's 64 query rows; warp 4
// is the producer: one thread loads Q, then the K/V tiles into a ring
// of STAGES, each stage's `full` barrier counting its bytes in and its
// `empty` barrier the 4 consumer warps out.
template <int D>
__global__ void __launch_bounds__(THREADS, Geo<D>::BLOCKS)
    flash_fwd_tc_kernel(const __grid_constant__ Params p) {
  using G = Geo<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t q_a = (smem_addr(smem_raw) + 1023) & ~1023u;  // 1 KB atoms
  const uint32_t k_a = q_a + G::TILE;            // [STAGES] K tiles
  const uint32_t v_a = k_a + STAGES * G::TILE;   // [STAGES] V tiles
  const uint32_t bar = v_a + STAGES * G::TILE;   // full, empty, q
  auto full = [&](int i) { return bar + 8 * (i % STAGES); };
  auto empty = [&](int i) { return bar + 8 * (STAGES + i % STAGES); };
  auto k_at = [&](int i) { return k_a + (i % STAGES) * G::TILE; };
  auto v_at = [&](int i) { return v_a + (i % STAGES) * G::TILE; };
  const uint32_t qbar = bar + 16 * STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // heaviest first
  const int h = blockIdx.x, b = blockIdx.y;

  // key tiles [t0, t1) that any row of this tile can see
  const int offset = p.Sk - p.Sq;
  const int qlo = q0 + offset;
  const int qhi = min(q0 + BQ, p.Sq) - 1 + offset;
  const int kend = p.causal ? min(p.Sk, qhi + 1) : p.Sk;
  const int kbeg = p.window > 0 ? max(0, qlo - p.window + 1) : 0;
  const int t0 = kbeg / BK, n = kend > 0 ? max((kend + BK - 1) / BK - t0, 0)
                                         : 0;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {  // the producer
    if (lane == 0) {
      const int hk = h / (p.H / p.KV);
      mbar_expect_tx(qbar, G::TILE);
      for (int sub = 0; sub < G::NSUB; ++sub)
        tma_load(q_a + sub * BQ * G::RB, &p.qmap, qbar, 64 * sub, h, q0, b);
      for (int i = 0; i < n; ++i) {
        if (i >= STAGES) mbar_wait(empty(i), (i / STAGES - 1) & 1);
        mbar_expect_tx(full(i), 2 * G::TILE);
        const int k0 = (t0 + i) * BK;
        for (int sub = 0; sub < G::NSUB; ++sub) {
          tma_load(k_at(i) + sub * BK * G::RB, &p.kmap, full(i), 64 * sub,
                   hk, k0, b);
          tma_load(v_at(i) + sub * BK * G::RB, &p.vmap, full(i), 64 * sub,
                   hk, k0, b);
        }
      }
    }
    return;
  }

  const int row = 16 * warp + (lane >> 2);  // the thread's row g
  const int qpos = q0 + row + offset;
  const float c = p.scale * LOG2E;  // scores to log2 units, in fp32
  float o[G::DP / 2], s[BK / 2], m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < G::DP / 2; ++i) o[i] = 0.f;
  uint32_t ph[BK / 16][4], pl[BK / 16][4];

  mbar_wait(qbar, 0);
  for (int i = 0; i < n; ++i) {
    mbar_wait(full(i), (i / STAGES) & 1);
    qk<D>(s, q_a, k_at(i));
    const int k0 = (t0 + i) * BK;
    if (k0 + BK <= p.Sk && (!p.causal || k0 + BK - 1 <= qlo) &&
        (p.window <= 0 || k0 > qhi - p.window))
      softmax<D, false>(s, o, m, l, k0, qpos, p, c, lane);
    else
      softmax<D, true>(s, o, m, l, k0, qpos, p, c, lane);
    split_p(s, ph, pl);
    pv<D>(o, ph, pl, v_at(i));
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(i));
  }

  // o = acc / l, rounded once to bf16, through this warp's own 16 rows
  // of the Q tile (no other warp reads them) for 16-byte stores of the
  // first D columns
  constexpr int CA = G::RB / 16;  // 16-byte chunks a row a block
  auto at = [&](int r, int ch) {
    return q_a + (ch / CA) * (BQ * G::RB) + r * G::RB +
           ((ch % CA) ^ (r % CA)) * 16;
  };
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-20f);
  }
#pragma unroll
  for (int j = 0; j < G::DP / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at(row + 8 * r, j) +
                                                     4 * (lane & 3)),
                   "r"(pack(o[4 * j + 2 * r] / l[r],
                            o[4 * j + 2 * r + 1] / l[r]))
                   : "memory");
  __syncwarp();
  bf16* out = static_cast<bf16*>(p.o) + b * p.o_b + h * p.o_h;
#pragma unroll
  for (int it = 0; it < 2 * D / 32; ++it) {
    const int i = it * 32 + lane;  // chunk i of the warp's 16 x D / 8
    const int r = 16 * warp + i / (D / 8), ch = i % (D / 8);
    uint4 val;
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(val.x), "=r"(val.y), "=r"(val.z), "=r"(val.w)
                 : "r"(at(r, ch))
                 : "memory");
    if (q0 + r < p.Sq)
      *reinterpret_cast<uint4*>(out + (long long)(q0 + r) * p.o_s + ch * 8) =
          val;
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// (B, S, heads, D) bf16 with element strides s_b, s_s, s_h, read in
// boxes of 64 rows of one head and at most 64 columns, swizzled as Geo
// says; rows past S and columns past D read as zeros
bool make_map(CUtensorMap* map, const void* base, int D, int S, int heads,
              int B, long long s_b, long long s_s, long long s_h) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s_h * 2, (cuuint64_t)s_s * 2,
                                 (cuuint64_t)s_b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)(D < 64 ? D : 64), 1, BQ, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = D >= 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                           : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const ::Params& a, int B, cudaStream_t stream) {
  Params p;
  if (!make_map(&p.qmap, a.q, D, a.Sq, a.H, B, a.q_b, a.q_s, a.q_h) ||
      !make_map(&p.kmap, a.k, D, a.Sk, a.KV, B, a.k_b, a.k_s, a.k_h) ||
      !make_map(&p.vmap, a.v, D, a.Sk, a.KV, B, a.v_b, a.v_s, a.v_h))
    return (int)cudaErrorInvalidValue;
  p.o = a.o;
  p.o_b = a.o_b;
  p.o_s = a.o_s;
  p.o_h = a.o_h;
  p.H = a.H;
  p.KV = a.KV;
  p.Sq = a.Sq;
  p.Sk = a.Sk;
  p.causal = a.causal;
  p.window = a.window;
  p.scale = a.scale;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Geo<D>::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)a.H, (unsigned)B,
                  (unsigned)((a.Sq + BQ - 1) / BQ));
  flash_fwd_tc_kernel<D><<<grid, THREADS, Geo<D>::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace tc

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

// fp32: the SIMT kernel; bf16: the tensor-core kernel
int dispatch(const Params& p, int B, int D, int dtype, cudaStream_t s) {
  if (dtype == 0) {
    switch (D) {
      case 16: return launch<float, 16>(p, B, s);
      case 32: return launch<float, 32>(p, B, s);
      case 64: return launch<float, 64>(p, B, s);
      case 112: return launch<float, 112>(p, B, s);
      case 128: return launch<float, 128>(p, B, s);
      case 256: return launch<float, 256>(p, B, s);
    }
  } else if (dtype == 1) {
    switch (D) {
      case 16: return tc::launch<16>(p, B, s);
      case 32: return tc::launch<32>(p, B, s);
      case 64: return tc::launch<64>(p, B, s);
      case 112: return tc::launch<112>(p, B, s);
      case 128: return tc::launch<128>(p, B, s);
      case 256: return tc::launch<256>(p, B, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (B, Sq, H, D), k and v (B, Sk, KV, D), o (B, Sq, H, D), each with
// unit stride in D and the strides given for b, s and h (in elements).
// dtype 0 = float32, 1 = bfloat16 (all four tensors; bf16 also needs
// 16-byte aligned pointers and strides that are multiples of 8, for
// TMA).  window <= 0 means none.  Launches on `stream`; returns the CUDA
// error (0 = launched).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int KV, int Sq, int Sk, int D, long long q_b, long long q_s,
    long long q_h, long long k_b, long long k_s, long long k_h,
    long long v_b, long long v_s, long long v_h, long long o_b,
    long long o_s, long long o_h, int causal, int window, float scale,
    int dtype, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk <= 0 ||
      H > 65535 || B > 65535 || (Sq + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  const Params p{q,   k,   v,   o,   q_b, q_s, q_h,    k_b,    k_s,
                 k_h, v_b, v_s, v_h, o_b, o_s, o_h,    H,      KV,
                 Sq,  Sk,  causal, window, scale};
  return dispatch(p, B, D, dtype, static_cast<cudaStream_t>(stream));
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
