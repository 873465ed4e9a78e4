// Weighted source->target parameter mixing for Hopper (sm_90a):
//
//   out[t, p] = sum_s alpha[s, t] * theta[s, p]      float32 in and out
//
// Replaces the Pallas TPU kernel src/repro/kernels/alpha_combine/kernel.py
// (_combine_kernel / alpha_combine_flat).  There the grid walks P in
// blocks with the whole alpha matrix resident in VMEM.  Here the product
// is a GEMM, out^T (P x T) = theta^T (P x S) . alpha (S x T), run on the
// tensor cores in TF32 with the 3xTF32 split:
//
//   x_hi = tf32(x), x_lo = tf32(x - x_hi) for theta and alpha, and
//   out = th_lo a_hi + th_hi a_lo + th_hi a_hi, summed in fp32
//
// (th_lo a_lo, ~2^-22 of a term, is dropped).  A term then carries about
// 2^-21 of |a th| of error, fp32 SGEMM's accuracy and well inside the
// 1e-5 bar against the plain version (cuBLAS SGEMM with TF32 off); one
// TF32 product carries ~2^-11 and fails it (tests/test_torch_combine_
// numerics.py emulates both on the CPU).  Rows of any length are read
// with 4-byte copies (P = 48,158 is not a multiple of 4, so theta's rows
// are not 16-byte aligned and TMA cannot describe them); ragged edges
// are zero-filled.  Two kernels sit behind the one entry point:
//
// T <= 16 (the transfer, S = T = 10, P = 48,158): alpha_combine_tc_kernel
//   with mma.sync m16n8k8.  Bound by its bytes (3.85 MB, ~1.2 us at 3.35
//   TB/s) and the launch: 4 warps own 256 p and all 16 t, theta staged by
//   cp.async in chunks of 32 sources, alpha split into hi and lo once per
//   block in shared memory, theta's fragments split in registers, the
//   tile stored through shared memory along p.
//
// T > 16 (the simulator's S = T = 256): alpha_combine_wgmma_kernel.
//   The function's floor is its 98.6 MB of bytes (~29 us at 3.35 TB/s;
//   its 6.3 GFLOP take ~13 us at the 495 TFLOP/s TF32 peak), but the
//   split's three products take ~38 us at that peak: the kernel's own
//   floor is its MMAs.
//   * split_alpha_kernel splits alpha into hi and lo once a call, into a
//     scratch of 16-source x 256-target (hi, lo) pairs laid out as the
//     wgmma descriptors read them (K-major, 64B swizzle).  Splitting in
//     each block, as the TPU kernel holds alpha, made every one of 377
//     blocks re-split all of alpha, and was slower.
//   * A block owns 128 p and 256 t, so theta is streamed from device
//     memory once for T <= 256: two warpgroups of 64 p, each products of
//     m64n256k8 with theta's fragments as the register A operand (split
//     into hi and lo there) and alpha's pair as the shared-memory B
//     operand.
//   * A ring of 4 chunks: one thread bulk-copies each pair (an mbarrier
//     counts its bytes), all threads copy theta by cp.async; the products
//     of two chunks are in flight while the next chunks land.  The first
//     product overwrites the accumulators (a zeroing instruction would
//     make the compiler serialize every wgmma).
//   * The accumulator tile leaves through shared memory, so each warp
//     stores whole rows of `out` along p.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool full) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(full ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

// ------------------------------------------ T <= 16: mma.sync on the tensor cores

namespace tc {

constexpr int THREADS = 128;        // 4 warps, each 64 p x all 16 t
constexpr int NJ = 2;               // n-tiles of 8 t a warp
constexpr int BP = 256;             // p per block
constexpr int TB = 8 * NJ;          // t per block: every target
constexpr int KC = 32;              // s per staged chunk
constexpr int TH_LD = BP + 8;       // theta chunk row stride (words)
constexpr int AL_LD = TB + 8;       // alpha chunk row stride (words)
constexpr int OUT_LD = BP + 4;      // epilogue tile row stride (words)
constexpr int TH_WORDS = KC * TH_LD;
constexpr int AL_WORDS = KC * AL_LD;
// theta x2, raw alpha x2, alpha hi and lo
constexpr int SMEM_WORDS = 2 * TH_WORDS + 4 * AL_WORDS;
constexpr int SMEM_BYTES = SMEM_WORDS * 4;
// copies: a thread copies theta column tid (+ THREADS) of every row, and
// alpha column tid % TB of rows tid / TB, + A_ROWS, ..
constexpr int A_ROWS = THREADS / TB;
static_assert(TB * OUT_LD <= SMEM_WORDS, "epilogue tile must fit");
static_assert(BP % THREADS == 0 && THREADS % TB == 0, "");

__global__ void __launch_bounds__(THREADS, 1)
alpha_combine_tc_kernel(const float* __restrict__ theta,
                        const float* __restrict__ alpha,
                        float* __restrict__ out, int S, int T, long long P) {
  extern __shared__ __align__(16) float smem[];
  float* th_sh = smem;                                 // [2][KC][TH_LD]
  float* ar_sh = th_sh + 2 * TH_WORDS;                 // [2][KC][AL_LD]
  uint32_t* ah_sh = reinterpret_cast<uint32_t*>(ar_sh + 2 * AL_WORDS);
  uint32_t* al_sh = ah_sh + AL_WORDS;                  // [KC][AL_LD] each

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;              // mma fragment coords
  const long long p_base = (long long)blockIdx.x * BP;
  const int t_width = (T + 7) / 8 * 8;               // columns MMAs read
  const int chunks = (S + KC - 1) / KC;
  const int a_c = tid % TB, a_r = tid / TB;

  // rows of chunk k that are staged: S's rows rounded up to a k-step
  auto rows_of = [&](int k) { return min(KC, (S - k * KC + 7) / 8 * 8); };

  auto issue = [&](int k) {
    const int s0 = k * KC, rows = rows_of(k);
    float* th = th_sh + (k & 1) * TH_WORDS;
    float* ar = ar_sh + (k & 1) * AL_WORDS;
#pragma unroll
    for (int u = 0; u < BP / THREADS; ++u) {
      const int c = tid + u * THREADS;
      const bool p_in = p_base + c < P;
      const float* src = theta + (long long)s0 * P + p_base + c;
      for (int r = 0; r < rows; ++r) {
        const bool in = p_in && s0 + r < S;
        cp_async4(&th[r * TH_LD + c], in ? src : theta, in);
        src += P;
      }
    }
    if (a_c < t_width) {
      const float* src = alpha + (long long)(s0 + a_r) * T + a_c;
      for (int r = a_r; r < rows; r += A_ROWS) {
        const bool in = a_c < T && s0 + r < S;
        cp_async4(&ar[r * AL_LD + a_c], in ? src : alpha, in);
        src += (long long)A_ROWS * T;
      }
    }
    cp_async_commit();
  };

  float acc[4][NJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  issue(0);
  for (int k = 0; k < chunks; ++k) {
    if (k + 1 < chunks) {
      issue(k + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const int rows = rows_of(k);
    __syncthreads();  // chunk k has landed for every thread
    if (a_c < t_width) {
      const float* ar = ar_sh + (k & 1) * AL_WORDS;
      for (int r = a_r; r < rows; r += A_ROWS) {
        uint32_t hi, lo;
        split(ar[r * AL_LD + a_c], hi, lo);
        ah_sh[r * AL_LD + a_c] = hi;
        al_sh[r * AL_LD + a_c] = lo;
      }
    }
    __syncthreads();  // alpha's hi and lo are ready
    const float* th = th_sh + (k & 1) * TH_WORDS;
#pragma unroll
    for (int ks = 0; ks < KC / 8; ++ks) {
      if (ks * 8 >= rows) break;
      const int k0 = ks * 8;
      // alpha's B fragments for the NJ n-tiles, hi and lo
      uint32_t bh[NJ][2], bl[NJ][2];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int o0 = (k0 + q) * AL_LD + j * 8 + g;
        bh[j][0] = ah_sh[o0];
        bh[j][1] = ah_sh[o0 + 4 * AL_LD];
        bl[j][0] = al_sh[o0];
        bl[j][1] = al_sh[o0 + 4 * AL_LD];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // theta's A fragment of m-tile i, split in registers
        const int p0 = warp * 64 + i * 16 + g;
        uint32_t xh[4], xl[4];
        split(th[(k0 + q) * TH_LD + p0], xh[0], xl[0]);
        split(th[(k0 + q) * TH_LD + p0 + 8], xh[1], xl[1]);
        split(th[(k0 + q + 4) * TH_LD + p0], xh[2], xl[2]);
        split(th[(k0 + q + 4) * TH_LD + p0 + 8], xh[3], xl[3]);
        // three passes over the n-tiles, so consecutive MMAs write
        // different accumulators
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          if (j * 8 < T) mma_tf32(acc[i][j], xl, bh[j][0], bh[j][1]);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          if (j * 8 < T) mma_tf32(acc[i][j], xh, bl[j][0], bl[j][1]);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          if (j * 8 < T) mma_tf32(acc[i][j], xh, bh[j][0], bh[j][1]);
      }
    }
    __syncthreads();  // stage k & 1 and the split are no longer read
  }

  // the accumulator tile as [t][p] in shared memory, then whole rows out
  float* o_sh = smem;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int p0 = warp * 64 + i * 16 + g, t0 = j * 8 + 2 * q;
      o_sh[t0 * OUT_LD + p0] = acc[i][j][0];
      o_sh[(t0 + 1) * OUT_LD + p0] = acc[i][j][1];
      o_sh[t0 * OUT_LD + p0 + 8] = acc[i][j][2];
      o_sh[(t0 + 1) * OUT_LD + p0 + 8] = acc[i][j][3];
    }
  __syncthreads();
  const int p_live = (int)min((long long)BP, P - p_base);
  for (int t = warp; t < T; t += THREADS / 32) {
    float* row = out + (long long)t * P + p_base;
#pragma unroll
    for (int c = lane; c < BP; c += 32)
      if (c < p_live) row[c] = o_sh[t * OUT_LD + c];
  }
}

cudaError_t launch(const float* theta, const float* alpha, float* out, int S,
                   int T, long long P, cudaStream_t st) {
  // set on every call: the attribute is per device, and the caller's
  // current device may change between calls
  const cudaError_t err = cudaFuncSetAttribute(
      alpha_combine_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return err;
  alpha_combine_tc_kernel<<<(unsigned)((P + BP - 1) / BP), THREADS,
                            SMEM_BYTES, st>>>(theta, alpha, out, S, T, P);
  return cudaGetLastError();
}

}  // namespace tc

// ------------------------------------------ T > 16: wgmma on the tensor cores

namespace wg {

constexpr int THREADS = 256;        // two warpgroups, 64 p each
constexpr int BP = 128;             // p per block
constexpr int TB = 256;             // t per block: wgmma's N
constexpr int KW = 16;              // s per staged chunk
constexpr int STAGES = 4;           // ring of chunks: 3 in flight
constexpr int B_TILE = TB * KW * 4; // bytes of a [t][s] alpha tile, 16 KB
constexpr int PAIR = 2 * B_TILE;    // hi tile, then lo tile
constexpr int TH_LD = BP + 8;       // theta chunk row stride (words)
constexpr int TH_BYTES = KW * TH_LD * 4;
constexpr int OUT_LD = BP + 4;      // epilogue tile row stride (words)
// the ring of (hi, lo) pairs, the ring of theta chunks, an mbarrier a
// pair; 1 KB of slack to align the tiles to their swizzle atoms
constexpr int SMEM_BYTES = 1024 + STAGES * (PAIR + TH_BYTES) + 8 * STAGES;
static_assert(TB * OUT_LD * 4 <= STAGES * (PAIR + TH_BYTES),
              "the epilogue tile fits below the mbarriers");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// byte offset of (t, s) in a [t][s] tile of 64-byte rows in the 64B
// swizzle that the wgmma descriptor names: 16-byte chunk c of row t is
// stored at chunk c ^ ((t / 2) % 4)
__device__ __forceinline__ int swz(int t, int s) {
  return t * 64 + (((s >> 2) ^ ((t >> 1) & 3)) << 4) + (s & 3) * 4;
}
// wgmma shared-memory matrix descriptor, 64B swizzle, K-major: rows of 64
// bytes, 8-row groups 512 bytes apart
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(512 >> 4) << 32) |
         ((uint64_t)2 << 62);
}
__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// all but the newest group of products are done
__device__ __forceinline__ void wait_prev() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// keeps the compiler from touching r between a wgmma and its wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[KW / 8][4]) {
#pragma unroll
  for (int i = 0; i < KW / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}
// one (hi, lo) pair of `bytes` from global memory by the bulk-copy engine,
// completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
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

// d (+)= A B, m64n256k8 TF32: A (64 x 8) from registers (the m16n8k8 A
// fragment, warp w of the group holding rows 16 w .. 16 w + 15), B
// (8 x 256, K-major) from shared memory through its descriptor;
// scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_tf32(float (&d)[128],
                                           const uint32_t (&a)[4],
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127},"
      " {%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// alpha (S, T) -> for each 256-target tile y and 16-source chunk k, the
// pair [hi tile | lo tile] of the split, each a swizzled [t][s] tile as
// the main kernel's wgmma reads it, zero past S and T.  SPLIT_PARTS
// blocks a pair.
constexpr int SPLIT_PARTS = 8;
__global__ void __launch_bounds__(THREADS)
split_alpha_kernel(const float* __restrict__ alpha, uint32_t* __restrict__ hl,
                   int S, int T) {
  const int k = blockIdx.x, y = blockIdx.y, chunks = gridDim.x;
  uint32_t* hi = hl + ((long long)y * chunks + k) * (PAIR / 4);
  uint32_t* lo = hi + B_TILE / 4;
  constexpr int PART = TB * KW / SPLIT_PARTS;
  for (int e = blockIdx.z * PART + threadIdx.x; e < (blockIdx.z + 1) * PART;
       e += THREADS) {
    const int s = e / TB, t = e % TB;  // coalesced along t in alpha
    const int gs = k * KW + s, gt = y * TB + t;
    uint32_t h = 0, l = 0;
    if (gs < S && gt < T) split(alpha[(long long)gs * T + gt], h, l);
    hi[swz(t, s) / 4] = h;
    lo[swz(t, s) / 4] = l;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
alpha_combine_wgmma_kernel(const float* __restrict__ theta,
                           const uint32_t* __restrict__ hl,
                           float* __restrict__ out, int S, int T,
                           long long P) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // chunk k's alpha pair, theta and mbarrier: ring slot k % STAGES
  auto pair_of = [&](int k) { return base + (k % STAGES) * PAIR; };
  auto th_of = [&](int k) {
    return reinterpret_cast<float*>(base + STAGES * PAIR +
                                    (k % STAGES) * TH_BYTES);
  };
  const uint32_t bar0 = smem_addr(base + STAGES * (PAIR + TH_BYTES));

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int p0 = warp * 16;          // warp w of warpgroup w / 4: 16 rows
  const long long p_base = (long long)blockIdx.x * BP;
  const int t_base = blockIdx.y * TB;
  const int t_rem = min(TB, T - t_base);
  const int chunks = (S + KW - 1) / KW;
  const uint32_t* hl_y = hl + (long long)blockIdx.y * chunks * (PAIR / 4);

  // theta: 4-byte copies (rows of any length need no alignment), a thread
  // copies column th_c of rows th_r, th_r + 2, ..; rows past S are zero.
  // alpha: one bulk copy of the pair, by one thread.  One commit group
  // per chunk, empty past the last.
  const int th_c = tid % BP, th_r = tid / BP;
  const bool p_in = p_base + th_c < P;
  auto issue = [&](int k) {
    if (k < chunks) {
      const int s0 = k * KW;
      float* th = th_of(k);
      const float* src = theta + (long long)(s0 + th_r) * P + p_base + th_c;
#pragma unroll
      for (int r = 0; r < KW; r += THREADS / BP) {
        const bool in = p_in && s0 + r + th_r < S;
        cp_async4(&th[(r + th_r) * TH_LD + th_c], in ? src : theta, in);
        src += (THREADS / BP) * P;
      }
      if (tid == 0)
        bulk_load(smem_addr(pair_of(k)), hl_y + (long long)k * (PAIR / 4),
                  PAIR, bar0 + 8 * (k % STAGES));
    }
    cp_async_commit();
  };

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(bar0 + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the first product overwrites acc: a non-wgmma instruction defining it
  // (zeroing it) would make the compiler serialize every wgmma
  float acc[128];
  // theta's A fragments, hi and lo, of two chunks: chunk k's set is read
  // by its products while chunk k + 1's is filled
  uint32_t xh0[KW / 8][4], xl0[KW / 8][4], xh1[KW / 8][4], xl1[KW / 8][4];

  // chunk k: wait for it, start chunk k + 2's copies into the slot of
  // chunk k - 2 (whose products are done), fill its fragments, issue its
  // products; then wait for chunk k - 1's products, so that at most two
  // chunks' products are in flight and their slots and fragments stay
  // untouched until done
  auto step = [&](int k, uint32_t (&xh)[KW / 8][4], uint32_t (&xl)[KW / 8][4],
                  uint32_t (&ph)[KW / 8][4], uint32_t (&pl)[KW / 8][4]) {
    cp_async_wait<1>();
    mbar_wait(bar0 + 8 * (k % STAGES), (k / STAGES) & 1);
    __syncthreads();  // chunk k has landed for every thread
    issue(k + 2);
    const float* th = th_of(k);
#pragma unroll
    for (int ks = 0; ks < KW / 8; ++ks) {
      const int r0 = (ks * 8 + q) * TH_LD + p0 + g, r1 = r0 + 4 * TH_LD;
      split(th[r0], xh[ks][0], xl[ks][0]);
      split(th[r0 + 8], xh[ks][1], xl[ks][1]);
      split(th[r1], xh[ks][2], xl[ks][2]);
      split(th[r1 + 8], xh[ks][3], xl[ks][3]);
    }
    fence();
    // every k-step, rows past S being zero: a wgmma under a branch makes
    // the compiler wait for it before the branches join
    const uint32_t hi_a = smem_addr(pair_of(k)), lo_a = hi_a + B_TILE;
#pragma unroll
    for (int ks = 0; ks < KW / 8; ++ks) {
      wgmma_tf32(acc, xl[ks], desc(hi_a + 32 * ks), k > 0 || ks > 0);
      wgmma_tf32(acc, xh[ks], desc(lo_a + 32 * ks), 1);
      wgmma_tf32(acc, xh[ks], desc(hi_a + 32 * ks), 1);
    }
    commit();
    wait_prev();
    fence_regs(ph);
    fence_regs(pl);
  };

  issue(0);
  issue(1);
  for (int k = 0; k < chunks; k += 2) {
    step(k, xh0, xl0, xh1, xl1);
    if (k + 1 < chunks) step(k + 1, xh1, xl1, xh0, xl0);
  }
  wait_all();
  fence_regs(acc);
  cp_async_wait<0>();
  __syncthreads();  // every slot is read: the epilogue reuses them

  // the accumulator tile as [t][p] in shared memory, then whole rows out
  float* o_sh = reinterpret_cast<float*>(base);
#pragma unroll
  for (int j = 0; j < TB / 8; ++j) {
    const int t0 = 8 * j + 2 * q, pr = p0 + g;
    o_sh[t0 * OUT_LD + pr] = acc[4 * j];
    o_sh[(t0 + 1) * OUT_LD + pr] = acc[4 * j + 1];
    o_sh[t0 * OUT_LD + pr + 8] = acc[4 * j + 2];
    o_sh[(t0 + 1) * OUT_LD + pr + 8] = acc[4 * j + 3];
  }
  __syncthreads();
  const int p_live = (int)min((long long)BP, P - p_base);
  for (int t = warp; t < t_rem; t += THREADS / 32) {
    float* row = out + (long long)(t_base + t) * P + p_base;
#pragma unroll
    for (int c = lane; c < BP; c += 32)
      if (c < p_live) row[c] = o_sh[t * OUT_LD + c];
  }
}

// The bytes of the split alpha for (S, T): the caller's scratch.
long long split_bytes(int S, int T) {
  return (long long)((T + TB - 1) / TB) * ((S + KW - 1) / KW) * PAIR;
}

cudaError_t launch(const float* theta, const float* alpha, float* out, int S,
                   int T, long long P, uint32_t* hl, cudaStream_t st) {
  // set on every call: the attribute is per device (see tc::launch)
  cudaError_t err = cudaFuncSetAttribute(
      alpha_combine_wgmma_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const unsigned ty = (unsigned)((T + TB - 1) / TB);
  split_alpha_kernel<<<dim3((unsigned)((S + KW - 1) / KW), ty, SPLIT_PARTS),
                       THREADS, 0, st>>>(alpha, hl, S, T);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  alpha_combine_wgmma_kernel<<<dim3((unsigned)((P + BP - 1) / BP), ty),
                               THREADS, SMEM_BYTES, st>>>(theta, hl, out, S,
                                                          T, P);
  return cudaGetLastError();
}

}  // namespace wg

}  // namespace

// theta (S, P), alpha (S, T), out (T, P): contiguous float32 on the device;
// scratch: the bytes alpha_combine_plan(S, T) names on it (null when 0).
// Launches on `stream` as many kernels as alpha_combine_plan says; returns
// the first failing launch's cudaError_t (0 = launched).
extern "C" int alpha_combine_f32(const float* theta, const float* alpha,
                                 float* out, int S, int T, long long P,
                                 void* scratch, void* stream) {
  if (S <= 0 || T <= 0 || P <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  // up to 16 targets (the transfer's T = 10) the bytes bound it: mma.sync
  // in blocks of 256 p x 16 t; beyond, alpha split once into `scratch`
  // and wgmma in blocks of 128 p x 256 t
  if (T <= tc::TB) return (int)tc::launch(theta, alpha, out, S, T, P, st);
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  return (int)wg::launch(theta, alpha, out, S, T, P,
                         static_cast<uint32_t*>(scratch), st);
}

// How alpha_combine_f32 runs (S, T): returns the number of kernels it
// launches (1 up to 16 targets, then 2: the split and the product) and
// sets *scratch_bytes to the scratch it needs (0 up to 16 targets).
extern "C" int alpha_combine_plan(int S, int T, long long* scratch_bytes) {
  if (S <= 0 || T <= 0) return 0;
  *scratch_bytes = T <= tc::TB ? 0 : wg::split_bytes(S, T);
  return T <= tc::TB ? 1 : 2;
}

extern "C" const char* alpha_combine_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
