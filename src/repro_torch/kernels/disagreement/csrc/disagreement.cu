// Pairwise prediction-disagreement counts for Hopper (sm_90a):
//
//   counts[i, j] = sum_m valid[m] * [preds[i, m] != preds[j, m]]   (fp32)
//
// and, when asked, the normalised matrix counts / max(sum_m valid[m], 1)
// (one IEEE division, as the JAX wrapper divides).  A null `valid` means
// every weight is 1.
//
// Replaces the Pallas TPU kernel src/repro/kernels/disagreement/kernel.py
// (_disagree_kernel / disagreement_counts).  The TPU kernel walks the m
// axis as a sequential grid dimension with a VMEM accumulator; blocks on
// the GPU run in no order, so here the m axis is cut among a thread-block
// cluster and reduced through distributed shared memory in one launch:
//
//   * one cluster of CL <= 8 blocks per BN x BN output tile, only the
//     tiles on and above the diagonal (counts is symmetric: an
//     off-diagonal tile is written twice, once transposed); block r of
//     the cluster sums the r-th slice of m.  The caller picks CL from
//     how many clusters of each size the card holds at once
//     (disagreement_max_clusters): at N = 256 clusters of 7 or 8 need two
//     waves of the 36 tiles, clusters of 6 one;
//   * inside a block each thread owns a 4 x 4 block of outputs in
//     registers: per step of m it loads 4 + 4 predictions (two 16-byte
//     shared-memory loads) and one weight, and does 16 compare-adds.  The
//     threads of a block form G groups that share the tile and split each
//     staged chunk of m among them (G = 4 at BN = 32, 16 at BN = 16, so a
//     10 x 10 output still keeps 256 threads busy);
//   * the prediction tiles are staged by cp.async in a ring of two: the
//     chunk of m + BM lands while chunk m is compared.  The copies are 4
//     bytes each, so a row of any length M (777, 2,500) needs no
//     alignment; the staging layout is [m][row], padded so a warp's copies
//     hit 32 distinct banks and its 16-byte reads are conflict-free;
//     ragged N and M are zero-filled (a masked m has weight 0);
//   * each thread sums a chunk into its own partial and adds the partial
//     to its total at the chunk's end, so a long slice of fractional
//     weights is summed in blocks (chip_smoke.py prints the error of
//     this order against a float64 sum);
//   * the groups' totals are added in group order, then the cluster's
//     blocks add their tiles in rank order, each block finishing 1/CL of
//     the tile from all ranks' shared memory.  The order of every sum is
//     fixed by the shapes, so fractional weights give the same bits run
//     to run; 0/1 weights are integers below 2^24 and exact in any order.
//
// What bounds it on an H100: the compare-adds (a set-predicate and a
// predicated add each), N^2 M of them (4.2 G at N = 256, M = 64,000; the
// diagonal tiles halve them), against 65.5 MB of reads: operations, not
// bytes.  The set-predicates run on the 16-lane integer pipe, half the
// rate of the fp32 adds.  At N = 10 the whole job is one cluster, a few
// microseconds, most of it fixed (latency of the first chunk, the
// reductions).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int STAGES = 2;

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

// One stage of the ring: the m-chunk of the two prediction tiles, as
// [m][row] with rows padded to BN + 4 words, and its weights.
template <int BN, int BM>
struct __align__(16) Stage {
  int pi[BM][BN + 4];
  int pj[BM][BN + 4];
  float v[BM];
};

template <int BN, int BM>
__global__ void __launch_bounds__(THREADS, 2)
disagreement_kernel(const int* __restrict__ preds,
                    const float* __restrict__ valid,
                    float* __restrict__ out, int N, long long M,
                    long long slice, int normalize) {
  constexpr int TPT = (BN / 4) * (BN / 4);  // threads per tile
  constexpr int G = THREADS / TPT;          // groups splitting each chunk
  constexpr int CPG = BM / G;               // columns per group per chunk
  constexpr int NN = BN * BN;
  static_assert(THREADS % TPT == 0 && BM % G == 0 && BM <= THREADS, "");
  using St = Stage<BN, BM>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  St* stage = reinterpret_cast<St*>(smem_raw);  // [STAGES]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cl = (int)cluster.num_blocks();
  const int tid = threadIdx.x;
  const int g = tid / TPT, lt = tid % TPT;
  const int ta = lt / (BN / 4), tb = lt % (BN / 4);

  // the tile (I, J), I <= J, of this cluster: row-major over the upper
  // triangle of the nt x nt tile grid
  const int nt = (N + BN - 1) / BN;
  int I = 0, rem = blockIdx.y;
  while (rem >= nt - I) {
    rem -= nt - I;
    ++I;
  }
  const int J = I + rem;
  const int i0 = I * BN, j0 = J * BN;

  const long long m_begin = (long long)rank * slice;
  const long long m_end = min(M, m_begin + slice);
  const int chunks =
      m_begin < m_end ? (int)((m_end - m_begin + BM - 1) / BM) : 0;

  // stage chunk k: each warp copies 8 consecutive m of 4 rows (whole
  // 32-byte sectors of preds, 32 distinct banks of the [m][row] layout).
  // Thread tid copies row r_t of both tiles at the chunk's columns
  // c0 + kk * CSTEP, so a copy is a base pointer plus a constant.
  constexpr int MG = 32 / BN, CSTEP = 8 * MG, CPT = BM / CSTEP;
  const int r_t = (tid / 8) % BN, c0 = tid % 8 + 8 * (tid / (8 * BN));
  const bool in_i = i0 + r_t < N, in_j = j0 + r_t < N;
  const int* src_i = preds + (long long)min(i0 + r_t, N - 1) * M + m_begin + c0;
  const int* src_j = preds + (long long)min(j0 + r_t, N - 1) * M + m_begin + c0;
  auto issue = [&](int k) {
    St& st = stage[k % STAGES];
    const long long off = (long long)k * BM;
    const long long lim = m_end - m_begin - off - c0;  // columns left
#pragma unroll
    for (int kk = 0; kk < CPT; ++kk) {
      const int c = c0 + kk * CSTEP;
      const bool m_in = kk * CSTEP < lim;
      cp_async4(&st.pi[c][r_t], in_i && m_in ? src_i + off + kk * CSTEP : preds,
                in_i && m_in);
      cp_async4(&st.pj[c][r_t], in_j && m_in ? src_j + off + kk * CSTEP : preds,
                in_j && m_in);
    }
    if (tid < BM) {
      const long long m = m_begin + off + tid;
      if (valid != nullptr)
        cp_async4(&st.v[tid], m < m_end ? valid + m : valid, m < m_end);
      else
        st.v[tid] = m < m_end ? 1.f : 0.f;
    }
  };

  // a chunk's partial sums are added to totals of up to M / (CL * BM)
  // chunks
  float acc[4][4], vsum = 0.f;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

  // one commit group per chunk (empty past the last), so waiting for all
  // but STAGES - 2 groups means chunk k has landed
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    if (k < chunks) issue(k);
    cp_async_commit();
  }
  for (int k = 0; k < chunks; ++k) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk k has landed, chunk k - 1 is read
    if (k + STAGES - 1 < chunks) issue(k + STAGES - 1);
    cp_async_commit();
    const St& st = stage[k % STAGES];
    float part[4][4], vpart = 0.f;
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) part[a][b] = 0.f;
#pragma unroll 4
    for (int cc = 0; cc < CPG; ++cc) {
      const int c = g * CPG + cc;
      const int4 pa = *reinterpret_cast<const int4*>(&st.pi[c][4 * ta]);
      const int4 pb = *reinterpret_cast<const int4*>(&st.pj[c][4 * tb]);
      const float v = st.v[c];
      const int av[4] = {pa.x, pa.y, pa.z, pa.w};
      const int bv[4] = {pb.x, pb.y, pb.z, pb.w};
      vpart += v;
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (av[a] != bv[b]) part[a][b] += v;
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] += part[a][b];
    vsum += vpart;
  }
  cp_async_wait<0>();
  __syncthreads();  // every stage is read: the reduction reuses them

  // groups in order, inside the block: red[g][a][b], then the tile's sum
  float* red = reinterpret_cast<float*>(smem_raw);  // G * NN floats
  float* vred = red + G * NN;                    // G
  float* tile = vred + G;                        // NN + 1 (sum of weights)
  static_assert((G * NN + G + NN + 1) * sizeof(float) <= STAGES * sizeof(St),
                "the reduction reuses the ring");
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      red[g * NN + (4 * ta + a) * BN + 4 * tb + b] = acc[a][b];
  if (lt == 0) vred[g] = vsum;
  __syncthreads();
  for (int e = tid; e < NN; e += THREADS) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < G; ++q) s += red[q * NN + e];
    tile[e] = s;
  }
  if (tid == 0) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < G; ++q) s += vred[q];
    tile[NN] = s;
  }

  // the cluster's blocks in rank order; block `rank` finishes the tile's
  // elements e = rank (mod cl)
  cluster.sync();
  float denom = 1.f;
  if (normalize) {
    float s = 0.f;
    for (int q = 0; q < cl; ++q) s += cluster.map_shared_rank(tile, q)[NN];
    denom = fmaxf(s, 1.f);
  }
  for (int e = tid * cl + rank; e < NN; e += THREADS * cl) {
    float s = 0.f;
    for (int q = 0; q < cl; ++q) s += cluster.map_shared_rank(tile, q)[e];
    const float val = normalize ? __fdiv_rn(s, denom) : s;
    const int i = i0 + e / BN, j = j0 + e % BN;
    if (i < N && j < N) {
      out[(long long)i * N + j] = val;
      if (I != J) out[(long long)j * N + i] = val;
    }
  }
  cluster.sync();  // no block leaves while another reads its tile
}

// The launch of a (cl x tiles) grid in clusters of cl blocks along x.
template <int BN, int BM>
struct Launch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  Launch(int cl, unsigned tiles, cudaStream_t st) {
    cfg.gridDim = dim3((unsigned)cl, tiles, 1);
    cfg.blockDim = dim3(THREADS, 1, 1);
    cfg.dynamicSmemBytes = STAGES * sizeof(Stage<BN, BM>);
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cl;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  // set on every call: the attribute is per device, and the caller's
  // current device may change between calls
  static cudaError_t allow_smem() {
    return cudaFuncSetAttribute(
        disagreement_kernel<BN, BM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(STAGES * sizeof(Stage<BN, BM>)));
  }
};

template <int BN, int BM>
cudaError_t launch(const int* preds, const float* valid, float* out, int N,
                   long long M, int cl, int normalize, cudaStream_t st) {
  const int nt = (N + BN - 1) / BN;
  const long long tiles = (long long)nt * (nt + 1) / 2;
  if (tiles > 65535) return cudaErrorInvalidValue;
  // slices are whole chunks: ceil(M / cl) rounded up to BM
  const long long slice = ((M + cl - 1) / cl + BM - 1) / BM * BM;
  const cudaError_t err = Launch<BN, BM>::allow_smem();
  if (err != cudaSuccess) return err;
  Launch<BN, BM> l(cl, (unsigned)tiles, st);
  return cudaLaunchKernelEx(&l.cfg, disagreement_kernel<BN, BM>, preds, valid,
                            out, N, M, slice, normalize);
}

template <int BN, int BM>
cudaError_t max_clusters(int cl, int* count) {
  const cudaError_t err = Launch<BN, BM>::allow_smem();
  if (err != cudaSuccess) return err;
  Launch<BN, BM> l(cl, 1, 0);
  return cudaOccupancyMaxActiveClusters(count, disagreement_kernel<BN, BM>,
                                        &l.cfg);
}

}  // namespace

// preds (N, M) int32, valid (M,) float32 or null (every weight 1), out
// (N, N) float32: contiguous on the device.  bn (16 or 32) is the output
// tile edge and cl (1..8) the cluster size along m, both chosen by the
// caller; normalize != 0 divides by max(sum(valid), 1).  One launch on
// `stream`; returns its cudaError_t (0 = launched).
extern "C" int disagreement_f32(const int* preds, const float* valid,
                                float* out, int N, long long M, int bn,
                                int cl, int normalize, void* stream) {
  if (N <= 0 || M <= 0 || cl < 1 || cl > 8)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (bn == 16)
    err = launch<16, 128>(preds, valid, out, N, M, cl, normalize, st);
  else if (bn == 32)
    err = launch<32, 64>(preds, valid, out, N, M, cl, normalize, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// *count = how many clusters of cl blocks of the bn-tile kernel the
// current device holds at once (the caller asks once per device).
extern "C" int disagreement_max_clusters(int bn, int cl, int* count) {
  if (cl < 1 || cl > 8) return (int)cudaErrorInvalidValue;
  if (bn == 16) return (int)max_clusters<16, 128>(cl, count);
  if (bn == 32) return (int)max_clusters<32, 64>(cl, count);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* disagreement_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
