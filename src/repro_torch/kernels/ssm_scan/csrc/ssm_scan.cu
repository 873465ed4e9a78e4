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
// the chunk axis sequential, the state in a VMEM scratch.  A loop over
// the chunks inside one block serializes the whole sequence on one SM,
// so here the chunks run in parallel between two passes over the state
// (FLA's chunk_fwd_h / chunk_fwd_o, Yang et al., arXiv:2312.06635 §4),
// three launches a call:
//
//   1. ssm_chunk_state_kernel, a block per (b, h, chunk n): the chunk's
//      own contribution to the state, dS_n = (k * exp(lc_C - lc))^T v
//      (Dk x C x Dv on the tensor cores), and its decay exp(lc_C), into
//      a scratch of (B, H, N, Dk, Dv) states the wrapper allocates.
//   2. ssm_state_scan_kernel, a thread per state element: walks n, writes
//      each chunk's starting state S_n over dS_n in place, and the final
//      state; S_{n+1} = S_n * exp(lc_C) + dS_n, rounded twice as the
//      plain version rounds it.  The only serial path: B*H*Dk*Dv
//      independent chains of N steps (a multiply, then an add), bound by
//      the scratch's bytes.
//   3. ssm_chunk_output_kernel, a block per (b, h, chunk n), a warp per
//      16-row query sub-chunk i: y = intra-chunk attention +
//      (q * exp(q_lc)) . S_n.
//
// (FLA's alternative, one block per (b, h, slice of v's columns)
// walking the chunks with the state in registers and writing S_n as it
// goes, two launches a call, was built and gave the same bits, but keeps
// a 16- or 128-chunk serial chain per block: 157-160 us against 139 us
// for passes 1 and 2 at (4, 2048, 32, 64) and 724 against 295 us at
// (1, 16384) on an H100 (PERF.md).  The scan's chain is one fp32 step a
// chunk.)
//
// Numerics.  The intra-chunk decay is NOT JAX's q*exp(lc) times
// k*exp(-lc), which overflows float32 once a chunk decays by more than
// e^88 (rwkv6-1.6b at init: ln 2 a step, 2^128 over a 128-step chunk).
// The chunk is cut into 16-row sub-chunks.  Query sub-chunk i against an
// earlier key sub-chunk j scales q by exp(q_lc_t - r_i), k by
// exp(e_j - lc_s) and their product by g_ij = exp(r_i - e_j),
// r_i = q_lc on i's first row, e_j = lc on j's last row: every exponent
// is <= 0.  q_lc is lc (mamba) or lc one row earlier (rwkv).  These are
// the plain version's factors, computed by the same expressions.
//   * The diagonal block (j = i) is one more 16 x 16 x Dk product, then
//     the causal mask, instead of a per-pair exp: q * exp(q_lc_t - r_i)
//     times k * exp(r_i - lc_s).  Each argument's rounding error is
//     folded back in (exp_diff), so that a term is exp of the exact
//     argument, as the plain version's per-pair exp(q_lc_t - lc_s) is to
//     a few ulps (without it, the rounded differences near a chunk's
//     start, where small lc values are not within a factor of two of
//     each other, dominate the error).  The form is safe while
//     the block's decay span max_d (r_i - e_i) stays under SPAN_MAX = 60:
//     every factor is then within [e^-60, e^60] of q and k, a normal fp32
//     (and TF32: same exponent range) number for |q|, |k| in [1e-11,
//     1e11], and the masked pairs' products (up to e^60 |q k|) stay
//     finite.  rwkv6 at init spans about 16 ln 2 = 11.  A block whose span
//     is larger (strong decay) takes exp(q_lc_t - lc_s) pair by pair,
//     summed in fp64 as the plain version sums it: a branch on the data,
//     warp-uniform, not a fallback.
//   * lc is summed in order down each column, as torch.cumsum does on
//     the GPU along a dimension that is not the innermost, so both see
//     the same exponents (a reordered cumsum moves lc ~ -88 by ulps,
//     ~1e-5 of every decay factor).
//   * Products run on the tensor cores in TF32.  The bar against the plain
//     version (y within 1e-5 / 1e-4 in fp32) is as tight as fp32
//     summation noise at rwkv6's scale (outputs ~10 summing terms up to
//     ~50), so precision is spent where an emulation of the arithmetic on
//     the CPU (tests/test_torch_ssm_numerics.py) shows it matters:
//       - att . v takes exact products: att split into three TF32 parts
//         (x = x1 + x2 + x3 exactly), v exact in TF32 when bf16 (3
//         products) or split too (6);
//       - the scores likewise (6 products);
//       - the state's readout and update take 3xTF32 (x = hi + lo;
//         lo*hi + hi*lo + hi*hi, ~2^-21 of a term; 2 products when v is
//         bf16), as alpha_combine does; one TF32 product (~2^-11) misses
//         the bar by far;
//       - each k-step's products go into fresh accumulators, added to
//         the sum by fp32 adds: the tensor cores round their adds toward
//         zero (measured on the H100, PERF.md), and that bias would
//         accumulate along a running sum.
//   So the kernel agrees with its plain version (repro_torch.nn.
//   linear_attn.gla_chunked, the same arithmetic in PyTorch) within the
//   bars chip_smoke.py states (y within 1e-5 / 1e-4 in fp32 and one ulp
//   in bf16, the state within 1e-5 / 1e-4), and so does it with the plain
//   version's products summed in float64; no longer bit for bit: the
//   sums run in another order.
//
// Layout.  Inputs are staged into shared memory by 16-byte cp.async in
// their own dtype (bf16 stays bf16; each kernel is instantiated for the
// dtypes, so no read branches on them); rows past L and columns past D
// are zero-filled, as JAX pads them (q = k = v = 0, log_w = 0).  Row
// strides are padded so that every fragment read is free of bank
// conflicts.  The output kernel's 110 KB (bf16 q, k, v at C = 128,
// Dk = Dv = 64) let two blocks share an SM, so one block's loads overlap
// the other's products; q, k and log_w come first, so that the cumsum
// and rwkv's bonus overlap the copies of v and S_n.  Each warp takes its
// readout and its diagonal block while q and k are in shared memory;
// then k-hat (fp32) overwrites them, in two halves, for the earlier
// sub-chunks' scores.  Warps w and w + 4 share a scheduler and take
// sub-chunks i and 7 - i, whose work (growing with i) sums to the same.
//
// mma.sync.m16n8k8 TF32 fragments: A (16 x 8, row) a0 (g, q), a1
// (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4); B (8 x 8, col) b0 (q, g),
// b1 (q + 4, g); C c0 (g, 2q), c1 (g, 2q + 1), c2 (g + 8, 2q), c3
// (g + 8, 2q + 1), with g = lane / 4, q = lane % 4.  The scores' C
// fragments feed att . v as A fragments directly: key 2q of an 8-key
// step takes k-index q and key 2q + 1 takes q + 4 (v's B fragment reads
// the same keys).
//
// What bounds it on an H100 (rwkv6-1.6b prefill, C = 128, Dk = Dv = 64):
// the function's bytes (205 MB at (4, 2048, 32 heads): 0.061 ms at
// 3.35 TB/s) over its flops (8.6 G: 0.017 ms at the 495 TFLOP/s TF32
// peak).  The kernels' own floor is higher: the split products (about
// 4.5 TF32 multiply-adds per multiply-add of the function on the main
// path) take ~0.07 ms at the TF32 peak (mma.sync reached about two
// thirds of it in a probe on the H100), and the state passes add the
// scratch (2 x 34 MB written and read) and a second read of k, v and
// log_w.  What bounds the output kernel is neither: its warps issue
// several instructions (splits, exps, partial sums) per MMA, mostly in
// dependent chains, and 16 warps an SM (two blocks, by shared memory)
// do not hide their latency (PERF.md).  No fast math: denormals and an
// accurate expf matter in the decayed terms.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int SUB = 16;             // rows of a sub-chunk: one m16 tile
constexpr int CMAX = 128;           // longest chunk
constexpr int DKMAX = 64;           // widest Dk
constexpr int DVS = 64;             // columns of v, y and S a block owns
constexpr int NSUB = CMAX / SUB;    // sub-chunks of the longest chunk
constexpr int OUT_THREADS = 32 * NSUB;  // a warp per query sub-chunk
constexpr int STATE_THREADS = 256;      // two warps per 16 rows of dS
constexpr int SCAN_THREADS = 256;
// the diagonal block's largest decay span for the factored form: e^60
// and e^-60 keep every factor a normal number (see the header)
constexpr float SPAN_MAX = 60.f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* w;
  const float* bonus;  // (H, Dk)
  const float* s0;     // (B, H, Dk, Dv) or null (zeros)
  void* y;
  float* sfin;         // (B, H, Dk, Dv)
  float* states;       // (B*H*N, Dk, DVP): dS_n, then S_n
  float* decay;        // (B*H*N, Dk): exp(lc_C)
  long long q_b, q_l, q_h, k_b, k_l, k_h, v_b, v_l, v_h, w_b, w_l, w_h,
      y_b, y_l, y_h;
  int L, H, Dk, Dv, C, N, DVP, rwkv;
  int q_bf, k_bf, v_bf, w_bf;  // 1 = bfloat16, 0 = float32 (y: v_bf)
};

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}
// a tile's row stride in elements: 16-byte rows, padded so that the
// fragment reads spread over the banks
__host__ __device__ inline int tile_ld(int cols, int bf) {
  return cols + (bf ? 8 : 4);
}
__host__ __device__ inline int tile_bytes(int rows, int cols, int bf) {
  return rows * tile_ld(cols, bf) * (bf ? 2 : 4);
}

// an element of a tile of `ld`-element rows in shared memory
template <bool BF>
__device__ __forceinline__ float tile_at(const unsigned char* p, int ld,
                                         int r, int c) {
  return BF ? __uint_as_float(
                  (uint32_t)reinterpret_cast<const uint16_t*>(p)[r * ld + c]
                  << 16)
            : reinterpret_cast<const float*>(p)[r * ld + c];
}

// a tile in shared memory: rows of `ld` float32 or bfloat16 elements
// (the kernels make `bf` a compile-time constant where they can)
struct Tile {
  unsigned char* p;
  int ld;
  int bf;
  __device__ __forceinline__ float at(int r, int c) const {
    return bf ? tile_at<true>(p, ld, r, c) : tile_at<false>(p, ld, r, c);
  }
};

__device__ __forceinline__ void store(void* p, long long i, float x,
                                      int bf) {
  if (bf)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(x);  // nearest even
  else
    static_cast<float*>(p)[i] = x;
}

// 16 bytes global -> shared, the last 16 - bytes zero-filled (all 16 when
// bytes = 0: then nothing is read)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void cp_async_wait_all() {
  cp_async_commit();
  cp_async_wait<0>();
}

// rows [0, C) of chunk l0 of a (B, L, H, D) tensor into a tile: columns
// [0, cols) from element `base` (b, h and the first column) on, of which
// `valid` exist; rows past L and columns past `valid` are zero-filled
__device__ __forceinline__ void stage(const Tile& t, const void* src,
                                      long long base, long long row_stride,
                                      int l0, int L, int C, int cols,
                                      int valid, int tid, int nthreads) {
  const int es = t.bf ? 2 : 4;
  const int pieces = cols * es / 16;
  const int vbytes = valid * es;
  const int dr = nthreads / pieces, dpc = nthreads % pieces;
  const char* s = static_cast<const char*>(src);
  for (int r = tid / pieces, pc = tid % pieces; r < C;) {
    const long long l = l0 + r;
    const int bytes = l < L ? min(16, max(0, vbytes - pc * 16)) : 0;
    const char* g = bytes ? s + (base + l * row_stride) * es + pc * 16 : s;
    cp_async16(t.p + r * t.ld * es + pc * 16, g, bytes);
    pc += dpc;
    r += dr;
    if (pc >= pieces) {
      pc -= pieces;
      ++r;
    }
  }
}

// log_w's inclusive cumsum down column d, in order (as torch.cumsum on
// the GPU), into lc (in place when log_w is fp32); 16 rows are loaded
// ahead of their adds, so that only the adds form the serial chain
__device__ __forceinline__ void cumsum(const Tile& w, float* lc, int lcld,
                                       int C, int d) {
  float acc = 0.f;
  for (int t0 = 0; t0 < C; t0 += SUB) {
    float x[SUB];
#pragma unroll
    for (int u = 0; u < SUB; ++u) x[u] = w.at(t0 + u, d);
#pragma unroll
    for (int u = 0; u < SUB; ++u) {
      acc += x[u];
      lc[(t0 + u) * lcld + d] = acc;
    }
  }
}

// x = hi + lo: hi is x rounded to TF32 (to nearest, ties away from zero:
// add half a TF32 ulp, clear the 13 low bits); lo = x - hi is exact in
// fp32, and half an ulp is added to it so that the tensor cores, which
// ignore a TF32 operand's 13 low bits, see lo rounded the same way.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = x1 + x2 + x3 exactly, each a TF32 value (x1 and x2 rounded to
// nearest, x3 the <= 2 bits left of 24)
__device__ __forceinline__ void split3(float x, uint32_t& x1, uint32_t& x2,
                                      uint32_t& x3) {
  x1 = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  const float r = __fsub_rn(x, __uint_as_float(x1));
  x2 = (__float_as_uint(r) + 0x1000u) & 0xFFFFE000u;
  x3 = __float_as_uint(__fsub_rn(r, __uint_as_float(x2)));
}

// d = a . b, the accumulator's input zero (a fresh partial sum)
__device__ __forceinline__ void mma_tf32_first(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// A fragments split in 2 (3xTF32) or 3 (exact) TF32 parts
struct Frag2 {
  uint32_t h[4], l[4];
  __device__ __forceinline__ explicit Frag2(const float (&x)[4]) {
#pragma unroll
    for (int m = 0; m < 4; ++m) split(x[m], h[m], l[m]);
  }
};
struct Frag3 {
  uint32_t p1[4], p2[4], p3[4];
  __device__ __forceinline__ explicit Frag3(const float (&x)[4]) {
#pragma unroll
    for (int m = 0; m < 4; ++m) split3(x[m], p1[m], p2[m], p3[m]);
  }
};

// Each k-step's products go into a fresh accumulator, added to the sum
// in fp32 (round to nearest) outside the tensor cores: their own adds
// round toward zero (measured on the H100, PERF.md), and that bias
// would accumulate along a running sum.
__device__ __forceinline__ void add4(float (&acc)[4], const float (&t)[4]) {
#pragma unroll
  for (int m = 0; m < 4; ++m) acc[m] = __fadd_rn(acc[m], t[m]);
}

// t = a . b in 3xTF32: lo*hi + hi*lo + hi*hi; b exact in TF32 (bf16)
// takes two products
template <bool B_EXACT>
__device__ __forceinline__ void mma_3x(float (&t)[4], const Frag2& a,
                                       float b0, float b1) {
  if (B_EXACT) {
    mma_tf32_first(t, a.l, __float_as_uint(b0), __float_as_uint(b1));
    mma_tf32(t, a.h, __float_as_uint(b0), __float_as_uint(b1));
  } else {
    uint32_t bh0, bl0, bh1, bl1;
    split(b0, bh0, bl0);
    split(b1, bh1, bl1);
    mma_tf32_first(t, a.l, bh0, bh1);
    mma_tf32(t, a.h, bl0, bl1);
    mma_tf32(t, a.h, bh0, bh1);
  }
}

// t = a . b with every product exact: a in 3 parts; b exact in TF32
// (bf16: 3 products) or in 3 parts (6 products, dropping the terms of
// 2^-33 and below), small terms first
template <bool B_EXACT>
__device__ __forceinline__ void mma_exact(float (&t)[4], const Frag3& a,
                                          float b0, float b1) {
  if (B_EXACT) {
    const uint32_t u0 = __float_as_uint(b0), u1 = __float_as_uint(b1);
    mma_tf32_first(t, a.p3, u0, u1);
    mma_tf32(t, a.p2, u0, u1);
    mma_tf32(t, a.p1, u0, u1);
  } else {
    uint32_t c1[2], c2[2], c3[2];
    split3(b0, c1[0], c2[0], c3[0]);
    split3(b1, c1[1], c2[1], c3[1]);
    mma_tf32_first(t, a.p3, c1[0], c1[1]);
    mma_tf32(t, a.p1, c3[0], c3[1]);
    mma_tf32(t, a.p2, c2[0], c2[1]);
    mma_tf32(t, a.p2, c1[0], c1[1]);
    mma_tf32(t, a.p1, c2[0], c2[1]);
    mma_tf32(t, a.p1, c1[0], c1[1]);
  }
}

// exp(x - y), the subtraction's rounding error folded back in (TwoSum:
// s + err = x - y exactly; exp(x - y) = exp(s) (1 + err)), so that a
// product of two such factors is exp of the exact sum of the arguments
__device__ __forceinline__ float exp_diff(float x, float y) {
  const float s = __fsub_rn(x, y);
  const float bb = __fsub_rn(s, x);
  const float err =
      __fadd_rn(__fsub_rn(x, __fsub_rn(s, bb)), __fsub_rn(-y, bb));
  const float e = expf(s);
  return fmaf(e, err, e);
}

// ---------------------------------------------------------------- pass 1

// the shared-memory layout of ssm_chunk_state_kernel
struct StateLayout {
  int k, v, w, lc, bytes;  // byte offsets of the tiles
  __host__ __device__ StateLayout(const Params& p, int nv) {
    const int dkp = round_up(p.Dk, SUB);
    k = 0;
    v = k + tile_bytes(p.C, dkp, p.k_bf);
    w = v + tile_bytes(p.C, nv, p.v_bf);
    lc = w + (p.w_bf ? tile_bytes(p.C, dkp, 1) : 0);
    bytes = lc + tile_bytes(p.C, dkp, 0);
  }
};

// dS_n = (k * exp(lc_C - lc))^T v over the chunk: A (Dk x C) is k-tilde
// transposed; warps w and w + 4 own its rows 16 (w % 4) on, each half
// of the slice's columns
template <bool KBF, bool VBF>
__global__ void __launch_bounds__(STATE_THREADS, 3)  // 3 blocks an SM
    ssm_chunk_state_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const long long bhn = blockIdx.x;
  const long long bh = bhn / p.N;
  const int n = (int)(bhn % p.N), b = (int)(bh / p.H), h = (int)(bh % p.H);
  const int C = p.C, Dk = p.Dk, dkp = round_up(Dk, SUB);
  const int dv0 = blockIdx.y * DVS;
  const int nv = min(DVS, p.DVP - dv0), nnt = nv / 8;
  const int l0 = n * C;
  const StateLayout lay(p, nv);
  const Tile K{smem + lay.k, tile_ld(dkp, KBF), KBF};
  const Tile V{smem + lay.v, tile_ld(nv, VBF), VBF};
  const Tile W{smem + lay.w, tile_ld(dkp, p.w_bf), p.w_bf};
  float* lc = reinterpret_cast<float*>(smem + lay.lc);
  const int lcld = tile_ld(dkp, 0);

  stage(K, p.k, b * p.k_b + h * p.k_h, p.k_l, l0, p.L, C, dkp, Dk, tid,
        STATE_THREADS);
  stage(V, p.v, b * p.v_b + h * p.v_h + dv0, p.v_l, l0, p.L, C, nv,
        max(0, min(nv, p.Dv - dv0)), tid, STATE_THREADS);
  stage(W, p.w, b * p.w_b + h * p.w_h, p.w_l, l0, p.L, C, dkp, Dk, tid,
        STATE_THREADS);
  cp_async_wait_all();
  __syncthreads();
  if (tid < dkp) cumsum(W, lc, lcld, C, tid);
  __syncthreads();
  if (blockIdx.y == 0 && tid < Dk)
    p.decay[bhn * Dk + tid] = expf(lc[(C - 1) * lcld + tid]);

  const int m0 = (warp % 4) * SUB, half = warp / 4;
  if (m0 >= Dk) return;
  const int r0 = m0 + g, r1 = r0 + 8;
  const float lt0 = lc[(C - 1) * lcld + r0], lt1 = lc[(C - 1) * lcld + r1];
  float acc[DVS / 16][4];
#pragma unroll
  for (int j = 0; j < DVS / 16; ++j)
#pragma unroll
    for (int m = 0; m < 4; ++m) acc[j][m] = 0.f;

#pragma unroll 2
  for (int t = q; t < C; t += 8) {
    // k-tilde's A fragment: rows d (r0, r1), columns t (t, t + 4)
    const float x[4] = {
        K.at(t, r0) * expf(lt0 - lc[t * lcld + r0]),
        K.at(t, r1) * expf(lt1 - lc[t * lcld + r1]),
        K.at(t + 4, r0) * expf(lt0 - lc[(t + 4) * lcld + r0]),
        K.at(t + 4, r1) * expf(lt1 - lc[(t + 4) * lcld + r1])};
    const Frag2 a(x);
#pragma unroll
    for (int j = 0; j < DVS / 16; ++j)
      if (half * (DVS / 16) + j < nnt) {
        const int c = (half * (DVS / 16) + j) * 8 + g;
        float part[4];
        mma_3x<VBF>(part, a, tile_at<VBF>(V.p, V.ld, t, c),
                    tile_at<VBF>(V.p, V.ld, t + 4, c));
        add4(acc[j], part);
      }
  }
  float* out = p.states + bhn * Dk * p.DVP + dv0 + 2 * q;
#pragma unroll
  for (int j = 0; j < DVS / 16; ++j) {
    const int c = (half * (DVS / 16) + j) * 8;
    if (c / 8 < nnt) {
      if (r0 < Dk)
        *reinterpret_cast<float2*>(out + (long long)r0 * p.DVP + c) =
            make_float2(acc[j][0], acc[j][1]);
      if (r1 < Dk)
        *reinterpret_cast<float2*>(out + (long long)r1 * p.DVP + c) =
            make_float2(acc[j][2], acc[j][3]);
    }
  }
}

// ---------------------------------------------------------------- pass 2

// S_0 = s0; S_{n+1} = S_n * exp(lc_C) + dS_n, each chunk's S_n written
// over its dS_n, the last into sfin.  A thread per element of the
// (B, H, Dk, DVP) states; loads run 8 chunks ahead of the chain.
__global__ void __launch_bounds__(SCAN_THREADS)
    ssm_state_scan_kernel(Params p, long long total) {
  const long long idx = (long long)blockIdx.x * SCAN_THREADS + threadIdx.x;
  if (idx >= total) return;
  const long long per = (long long)p.Dk * p.DVP;
  const long long bh = idx / per, e = idx % per;
  const int d = (int)(e / p.DVP), c = (int)(e % p.DVP);
  const long long fin = (bh * p.Dk + d) * p.Dv + c;
  float s = (p.s0 != nullptr && c < p.Dv) ? p.s0[fin] : 0.f;
  float* x = p.states + bh * p.N * per + e;
  const float* dc = p.decay + bh * p.N * p.Dk + d;
  for (int n0 = 0; n0 < p.N; n0 += 8) {
    float ds[8], dk[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (n0 + u < p.N) {
        ds[u] = x[(n0 + u) * per];
        dk[u] = dc[(long long)(n0 + u) * p.Dk];
      }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (n0 + u < p.N) {
        x[(n0 + u) * per] = s;
        s = __fadd_rn(__fmul_rn(s, dk[u]), ds[u]);  // as the plain version
      }
  }
  if (c < p.Dv) p.sfin[fin] = s;
}

// ---------------------------------------------------------------- pass 3

// the shared-memory layout of ssm_chunk_output_kernel; k-hat (fp32)
// later overwrites q and k, which are at least as large
struct OutLayout {
  int q, k, v, w, lc, s, r, e, bon, bytes;
  __host__ __device__ OutLayout(const Params& p, int nv) {
    const int dkp = round_up(p.Dk, SUB);
    q = 0;
    k = q + tile_bytes(p.C, dkp, p.q_bf);
    v = k + tile_bytes(p.C, dkp, p.k_bf);
    w = v + tile_bytes(p.C, nv, p.v_bf);
    lc = w + (p.w_bf ? tile_bytes(p.C, dkp, 1) : 0);
    s = lc + tile_bytes(p.C, dkp, 0);
    r = s + dkp * (nv + 8) * 4;
    e = r + NSUB * dkp * 4;
    bon = e + NSUB * dkp * 4 + DKMAX * 4;  // (u before it)
    bytes = bon + CMAX * 4;
  }
};

// att . v_j into y: the scores' C fragments are att's A fragments, key
// 2q at k-index q and key 2q + 1 at q + 4; every product exact
template <bool VBF>
__device__ __forceinline__ void att_v(float (&y)[DVS / 8][4],
                                      const float (&sc)[2][4], const Tile& V,
                                      int key0, int nnt, int g, int q) {
  const float x0[4] = {sc[0][0], sc[0][2], sc[0][1], sc[0][3]};
  const float x1[4] = {sc[1][0], sc[1][2], sc[1][1], sc[1][3]};
  const Frag3 a0(x0), a1(x1);
  const int key = key0 + 2 * q;
#pragma unroll
  for (int c = 0; c < DVS / 8; ++c)
    if (c < nnt) {
      float t[4];
      mma_exact<VBF>(t, a0, tile_at<VBF>(V.p, V.ld, key, c * 8 + g),
                     tile_at<VBF>(V.p, V.ld, key + 1, c * 8 + g));
      add4(y[c], t);
      mma_exact<VBF>(t, a1, tile_at<VBF>(V.p, V.ld, key + 8, c * 8 + g),
                     tile_at<VBF>(V.p, V.ld, key + 9, c * 8 + g));
      add4(y[c], t);
    }
}

// (q, k and v each in the dtype the template names, so that the tiles'
// reads need no branch on it)
template <bool QBF, bool KBF, bool VBF>
__global__ void __launch_bounds__(OUT_THREADS, 2)
    ssm_chunk_output_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const long long bhn = blockIdx.x;
  const long long bh = bhn / p.N;
  const int n = (int)(bhn % p.N), b = (int)(bh / p.H), h = (int)(bh % p.H);
  const int C = p.C, Dk = p.Dk, dkp = round_up(Dk, SUB), nks = dkp / 8;
  const int ns = C / SUB, rwkv = p.rwkv;
  const int dv0 = blockIdx.y * DVS;
  const int nv = min(DVS, p.DVP - dv0), nnt = nv / 8;
  const int l0 = n * C;
  const OutLayout lay(p, nv);
  const Tile Q{smem + lay.q, tile_ld(dkp, QBF), QBF};
  const Tile K{smem + lay.k, tile_ld(dkp, KBF), KBF};
  const Tile V{smem + lay.v, tile_ld(nv, VBF), VBF};
  const Tile W{smem + lay.w, tile_ld(dkp, p.w_bf), p.w_bf};
  float* lc = reinterpret_cast<float*>(smem + lay.lc);
  const int lcld = tile_ld(dkp, 0);
  float* S = reinterpret_cast<float*>(smem + lay.s);
  const int sld = nv + 8;
  float* R = reinterpret_cast<float*>(smem + lay.r);    // [NSUB][dkp]
  float* E = reinterpret_cast<float*>(smem + lay.e);    // [NSUB][dkp]
  float* bon = reinterpret_cast<float*>(smem + lay.bon);
  float* kh = reinterpret_cast<float*>(smem);           // [C][lcld]

  stage(Q, p.q, b * p.q_b + h * p.q_h, p.q_l, l0, p.L, C, dkp, Dk, tid,
        OUT_THREADS);
  stage(K, p.k, b * p.k_b + h * p.k_h, p.k_l, l0, p.L, C, dkp, Dk, tid,
        OUT_THREADS);
  stage(W, p.w, b * p.w_b + h * p.w_h, p.w_l, l0, p.L, C, dkp, Dk, tid,
        OUT_THREADS);
  cp_async_commit();  // the cumsum and the bonus need only these
  stage(V, p.v, b * p.v_b + h * p.v_h + dv0, p.v_l, l0, p.L, C, nv,
        max(0, min(nv, p.Dv - dv0)), tid, OUT_THREADS);
  {  // S_n, rows past Dk zero
    const float* src = p.states + bhn * Dk * p.DVP + dv0;
    const int pieces = nv / 4;
    for (int e = tid; e < dkp * pieces; e += OUT_THREADS) {
      const int d = e / pieces, pc = e % pieces;
      cp_async16(S + d * sld + pc * 4,
                 d < Dk ? src + (long long)d * p.DVP + pc * 4 : p.states,
                 d < Dk ? 16 : 0);
    }
  }
  float* u = E + NSUB * dkp;  // the bonus vector (before bon)
  if (rwkv)
    for (int d = tid; d < dkp; d += OUT_THREADS)
      u[d] = d < Dk ? __ldg(p.bonus + h * Dk + d) : 0.f;
  cp_async_commit();
  cp_async_wait<1>();  // q, k and log_w have landed
  __syncthreads();
  if (tid < dkp) {
    cumsum(W, lc, lcld, C, tid);
  } else if (rwkv) {
    // meanwhile the bonus on the diagonal, summed in fp64 as the plain
    // version sums it
    for (int t = tid - dkp; t < C; t += OUT_THREADS - dkp) {
      double acc = 0.0;
      for (int d0 = 0; d0 < dkp; d0 += SUB) {  // u past Dk is zero
        float qq[SUB], kk[SUB];
#pragma unroll
        for (int e = 0; e < SUB; ++e) {
          qq[e] = Q.at(t, d0 + e);
          kk[e] = K.at(t, d0 + e);
        }
#pragma unroll
        for (int e = 0; e < SUB; ++e)
          acc = fma((double)qq[e] * (double)u[d0 + e], (double)kk[e], acc);
      }
      bon[t] = (float)acc;
    }
  }
  cp_async_wait<0>();  // v and S_n too
  __syncthreads();

  // the query side's cumulative log-decay on row t
  auto qlc = [&](int t, int d) -> float {
    return rwkv ? (t > 0 ? lc[(t - 1) * lcld + d] : 0.f) : lc[t * lcld + d];
  };
  for (int e = tid; e < ns * dkp; e += OUT_THREADS) {
    const int i = e / dkp, d = e % dkp;
    R[e] = qlc(i * SUB, d);
    E[e] = lc[(i * SUB + SUB - 1) * lcld + d];
  }
  __syncthreads();

  // warps w and w + 4 share a scheduler: give them sub-chunks i and
  // 7 - i, whose work (growing with i) sums to the same
  const int i = warp < 4 ? warp : 11 - warp;
  const bool active = i < ns;
  const int t0 = i * SUB, ra = t0 + g, rb = ra + 8;
  float y[DVS / 8][4];
#pragma unroll
  for (int c = 0; c < DVS / 8; ++c)
#pragma unroll
    for (int m = 0; m < 4; ++m) y[c][m] = 0.f;
  float qh[DKMAX / 8][4];  // q-hat's A fragments, by k-step
  if (active) {
    // the state's readout, y = (q * exp(q_lc)) . S_n (3xTF32)
#pragma unroll
    for (int ks = 0; ks < DKMAX / 8; ++ks) {
      if (ks >= nks) break;
      const int d0 = ks * 8 + q, d1 = d0 + 4;
      const float x[4] = {Q.at(ra, d0) * expf(qlc(ra, d0)),
                          Q.at(rb, d0) * expf(qlc(rb, d0)),
                          Q.at(ra, d1) * expf(qlc(ra, d1)),
                          Q.at(rb, d1) * expf(qlc(rb, d1))};
      const Frag2 a(x);
#pragma unroll
      for (int c = 0; c < DVS / 8; ++c)
        if (c < nnt) {
          float part[4];
          mma_3x<false>(part, a, S[d0 * sld + c * 8 + g],
                        S[d1 * sld + c * 8 + g]);
          add4(y[c], part);
        }
    }

    // the diagonal block, from q and k while they are in shared memory;
    // its decay span decides its form
    float span = 0.f;
    for (int d = lane; d < dkp; d += 32)
      span = fmaxf(span, R[i * dkp + d] - E[i * dkp + d]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      span = fmaxf(span, __shfl_xor_sync(0xffffffffu, span, o));
    const bool factored = span < SPAN_MAX;
    float sc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int m = 0; m < 4; ++m) sc[nt][m] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DKMAX / 8; ++ks) {
      if (ks >= nks) break;
      const int d0 = ks * 8 + q, d1 = d0 + 4;
      const float r0 = R[i * dkp + d0], r1 = R[i * dkp + d1];
      const int rows[4] = {ra, rb, ra, rb}, cols[4] = {d0, d0, d1, d1};
      float x[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        // q-hat = q * exp(q_lc - r_i), the plain version's factor; the
        // diagonal's factor adds the subtraction's rounding error back
        const float ql = qlc(rows[m], cols[m]), r = m < 2 ? r0 : r1;
        const float sd = __fsub_rn(ql, r), bb = __fsub_rn(sd, ql);
        const float err =
            __fadd_rn(__fsub_rn(ql, __fsub_rn(sd, bb)), __fsub_rn(-r, bb));
        const float e = expf(sd), qv = Q.at(rows[m], cols[m]);
        qh[ks][m] = qv * e;
        x[m] = qv * fmaf(e, err, e);
      }
      if (factored) {
        // (q * exp(q_lc_t - r_i)) . (k * exp(r_i - lc_s))^T, each factor
        // exp of its exact argument (exp_diff), so that every term is exp
        // of the plain version's per-pair argument to a few ulps
        const Frag3 a(x);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int s = t0 + nt * 8 + g;
          float part[4];
          mma_exact<false>(
              part, a, K.at(s, d0) * exp_diff(r0, lc[s * lcld + d0]),
              K.at(s, d1) * exp_diff(r1, lc[s * lcld + d1]));
          add4(sc[nt], part);
        }
      }
    }
    if (!factored) {
      // strong decay: exp(q_lc_t - lc_s) pair by pair, summed in fp64
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int rr = g + 8 * (m / 2), cc = nt * 8 + 2 * q + m % 2;
          const int t = t0 + rr, s = t0 + cc;
          if (rwkv ? cc < rr : cc <= rr) {
            double acc = 0.0;
            for (int d = 0; d < Dk; ++d)
              acc = fma((double)Q.at(t, d) * (double)K.at(s, d),
                        (double)expf(qlc(t, d) - lc[s * lcld + d]), acc);
            sc[nt][m] = (float)acc;
          }
        }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)  // the causal mask; rwkv's bonus
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int rr = g + 8 * (m / 2), cc = nt * 8 + 2 * q + m % 2;
        if (rwkv ? cc >= rr : cc > rr)
          sc[nt][m] = (rwkv && cc == rr) ? bon[t0 + rr] : 0.f;
      }
    att_v<VBF>(y, sc, V, t0, nnt, g, q);
  }

  // k-hat = k * exp(e_j - lc) (fp32) over q and k, once every warp is
  // done with q and k.  A thread takes column tid % 64 of every fourth
  // row.  The first half's rows land on q alone; the second half's
  // overwrite rows of k that they read, so they go through registers.
  constexpr int RPT = CMAX / (OUT_THREADS / DKMAX);  // rows a thread takes
  const int cd = tid % DKMAX, rt = tid / DKMAX;
  auto khat = [&](int t) {
    return K.at(t, cd) * expf(E[(t / SUB) * dkp + cd] - lc[t * lcld + cd]);
  };
  __syncthreads();
#pragma unroll
  for (int m = 0; m < RPT / 2; ++m) {
    const int t = rt + m * (OUT_THREADS / DKMAX);
    if (t < C / 2 && cd < dkp) kh[t * lcld + cd] = khat(t);
  }
  float kv[RPT / 2];
#pragma unroll
  for (int m = 0; m < RPT / 2; ++m) {
    const int t = C / 2 + rt + m * (OUT_THREADS / DKMAX);
    if (t < C && cd < dkp) kv[m] = khat(t);
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < RPT / 2; ++m) {
    const int t = C / 2 + rt + m * (OUT_THREADS / DKMAX);
    if (t < C && cd < dkp) kh[t * lcld + cd] = kv[m];
  }
  __syncthreads();
  if (!active) return;

  // the earlier key sub-chunks j: (q-hat * g_ij) . k-hat_j^T, exact
  // products, g_ij = exp(r_i - e_j); then att . v_j
  for (int j = 0; j < i; ++j) {
    // lane (g, q) takes g_ij for d = 8 g + q (+ 4); the k-steps shuffle it
    const float gv0 = g < nks ? expf(R[i * dkp + g * 8 + q] -
                                     E[j * dkp + g * 8 + q]) : 0.f;
    const float gv1 = g < nks ? expf(R[i * dkp + g * 8 + q + 4] -
                                     E[j * dkp + g * 8 + q + 4]) : 0.f;
    float sc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int m = 0; m < 4; ++m) sc[nt][m] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DKMAX / 8; ++ks) {
      if (ks >= nks) break;
      const int d0 = ks * 8 + q, d1 = d0 + 4;
      const float g0 = __shfl_sync(0xffffffffu, gv0, ks * 4 + q);
      const float g1 = __shfl_sync(0xffffffffu, gv1, ks * 4 + q);
      const float x[4] = {qh[ks][0] * g0, qh[ks][1] * g0, qh[ks][2] * g1,
                          qh[ks][3] * g1};
      const Frag3 a(x);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int s = j * SUB + nt * 8 + g;
        float part[4];
        mma_exact<false>(part, a, kh[s * lcld + d0], kh[s * lcld + d1]);
        add4(sc[nt], part);
      }
    }
    att_v<VBF>(y, sc, V, j * SUB, nnt, g, q);
  }

  const long long yo = b * p.y_b + h * p.y_h;
#pragma unroll
  for (int c = 0; c < DVS / 8; ++c)
    if (c < nnt)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const long long l = l0 + (m < 2 ? ra : rb);
        const int col = dv0 + c * 8 + 2 * q + m % 2;
        if (l < p.L && col < p.Dv)
          store(p.y, yo + l * p.y_l + col, y[c][m], p.v_bf);
      }
}

// ---------------------------------------------------------------- launch

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

template <bool QBF, bool KBF, bool VBF>
int launch(const Params& p, int B, cudaStream_t st) {
  static int state_allowed = 48 * 1024, out_allowed = 48 * 1024;
  const long long bhn = (long long)B * p.H * p.N;
  const dim3 grid((unsigned)bhn, (unsigned)((p.DVP + DVS - 1) / DVS));
  const int nv = min(DVS, p.DVP);
  const StateLayout sl(p, nv);
  const OutLayout ol(p, nv);
  cudaError_t err;
  if (p.N > 0) {
    err = allow_smem(ssm_chunk_state_kernel<KBF, VBF>, sl.bytes,
                     state_allowed);
    if (err != cudaSuccess) return (int)err;
    ssm_chunk_state_kernel<KBF, VBF>
        <<<grid, STATE_THREADS, sl.bytes, st>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long total = (long long)B * p.H * p.Dk * p.DVP;
  ssm_state_scan_kernel<<<(unsigned)((total + SCAN_THREADS - 1) /
                                     SCAN_THREADS),
                          SCAN_THREADS, 0, st>>>(p, total);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.N == 0) return (int)err;
  err = allow_smem(ssm_chunk_output_kernel<QBF, KBF, VBF>, ol.bytes,
                   out_allowed);
  if (err != cudaSuccess) return (int)err;
  ssm_chunk_output_kernel<QBF, KBF, VBF>
      <<<grid, OUT_THREADS, ol.bytes, st>>>(p);
  return (int)cudaGetLastError();
}

bool valid_shape(int B, int L, int H, int Dk, int Dv, int C) {
  if (B <= 0 || H <= 0 || L < 0 || Dk < 1 || Dk > DKMAX || Dv < 1 ||
      C < SUB || C > CMAX || C % SUB != 0)
    return false;
  const long long n = (L + C - 1) / C;
  return (long long)B * H * n <= 0x7fffffffLL &&
         (round_up(Dv, 8) + DVS - 1) / DVS <= 65535 &&
         (long long)B * H * Dk * round_up(Dv, 8) / SCAN_THREADS < 0x7fffffffLL;
}

}  // namespace

// The kernels a call launches (3, or 1, the scan alone, when L = 0) and
// the fp32 scratch it needs, in floats: the (B, H, N, Dk, DVP) states
// and the (B, H, N, Dk) decays, DVP = Dv rounded up to 8.  0 kernels for
// a shape the kernels do not take.
extern "C" int ssm_scan_plan(int B, int L, int H, int Dk, int Dv, int C,
                             long long* scratch_floats) {
  if (!valid_shape(B, L, H, Dk, Dv, C)) return 0;
  const long long n = (L + C - 1) / C;
  *scratch_floats = (long long)B * H * n * Dk * (round_up(Dv, 8) + 1);
  return n > 0 ? 3 : 1;
}

// q, k, w (log_w) (B, L, H, Dk); v, y (B, L, H, Dv); unit stride in the
// last axis and the strides given for b, l and h (in elements), each a
// multiple of 16 bytes, as the data pointers.  bonus (H, Dk) fp32 (zeros
// for mamba); s0 (B, H, Dk, Dv) fp32 contiguous or null; sfin (B, H, Dk,
// Dv) fp32 contiguous; scratch as ssm_scan_plan says.  *_bf: 1 =
// bfloat16, 0 = float32 (y takes v's).  1 <= Dk <= 64; C a multiple of
// 16 up to 128.  Launches on `stream`; returns the CUDA error (0 =
// launched).
extern "C" int ssm_scan_fwd(
    const void* q, const void* k, const void* v, const void* w,
    const float* bonus, const float* s0, void* y, float* sfin,
    float* scratch, int B, int L, int H, int Dk, int Dv, int C, int rwkv,
    long long q_b, long long q_l, long long q_h, long long k_b,
    long long k_l, long long k_h, long long v_b, long long v_l,
    long long v_h, long long w_b, long long w_l, long long w_h,
    long long y_b, long long y_l, long long y_h, int q_bf, int k_bf,
    int v_bf, int w_bf, void* stream) {
  if (!valid_shape(B, L, H, Dk, Dv, C)) return (int)cudaErrorInvalidValue;
  const int N = (L + C - 1) / C, DVP = round_up(Dv, 8);
  float* decay = scratch + (long long)B * H * N * Dk * DVP;
  const Params p{q,   k,   v,   w,   bonus, s0,  y,   sfin, scratch, decay,
                 q_b, q_l, q_h, k_b, k_l,   k_h, v_b, v_l,  v_h,     w_b,
                 w_l, w_h, y_b, y_l, y_h,   L,   H,   Dk,   Dv,      C,
                 N,   DVP, rwkv, q_bf, k_bf, v_bf, w_bf};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((q_bf ? 4 : 0) | (k_bf ? 2 : 0) | (v_bf ? 1 : 0)) {
    case 0: return launch<false, false, false>(p, B, st);
    case 1: return launch<false, false, true>(p, B, st);
    case 2: return launch<false, true, false>(p, B, st);
    case 3: return launch<false, true, true>(p, B, st);
    case 4: return launch<true, false, false>(p, B, st);
    case 5: return launch<true, false, true>(p, B, st);
    case 6: return launch<true, true, false>(p, B, st);
    default: return launch<true, true, true>(p, B, st);
  }
}

extern "C" const char* ssm_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
