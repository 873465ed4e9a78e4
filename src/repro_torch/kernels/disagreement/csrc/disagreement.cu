// Pairwise prediction-disagreement counts for Hopper (sm_90a):
//
//   counts[i, j] = sum_m valid[m] * [preds[i, m] != preds[j, m]]   (fp32)
//
// Replaces the Pallas TPU kernel src/repro/kernels/disagreement/kernel.py
// (_disagree_kernel / disagreement_counts).  The TPU kernel walks the m
// axis as a sequential grid dimension with a VMEM accumulator; blocks on
// the GPU run in no order, so here the m axis is a loop inside the block:
//
//   * one block per BN x BN output tile and slice of m; thread (tx, ty)
//     owns column j0 + tx and rows i0 + ty + k * ROWS, its BN / ROWS sums
//     in registers;
//   * each BM-wide chunk of the two prediction tiles and of `valid` is
//     staged in shared memory (rows padded by one word: the column reads
//     of a warp fall in 32 distinct banks, the row reads are broadcasts);
//   * ragged N and M are masked in the kernel (a masked m has weight 0);
//   * a few output tiles cannot fill 132 SMs (N = 10 is one tile), so m
//     is cut into `splits` slices, one block each; every slice writes its
//     own partial counts and a second kernel adds them in slice order,
//     so the result does not depend on which block finishes first.
//
// What bounds it on an H100: the compare-adds, N^2 M of them (4.2 G at
// N = 256, M = 64,000, against 65.5 MB of reads), so it is bound by
// operations, not bytes.  Weights of 0 and 1 are counted exactly in
// fp32 up to 2^24, so on a bool mask the result equals the plain version
// bit for bit whatever the order of the sums.
#include <cuda_runtime.h>

namespace {

constexpr int BN = 32;    // output tile edge
constexpr int ROWS = 8;   // threadIdx.y extent: BN / ROWS rows per thread
constexpr int BM = 64;    // m-chunk staged in shared memory
constexpr int THREADS = BN * ROWS;

__global__ void __launch_bounds__(THREADS)
disagreement_kernel(const int* __restrict__ preds,
                    const float* __restrict__ valid,
                    float* __restrict__ out, int N, long long M,
                    long long slice) {
  __shared__ int pi_sh[BN][BM + 1];
  __shared__ int pj_sh[BN][BM + 1];
  __shared__ float v_sh[BM];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * BN + tx;
  const int i0 = blockIdx.y * BN, j0 = blockIdx.x * BN;
  const long long m_begin = (long long)blockIdx.z * slice;
  const long long m_end = min(M, m_begin + slice);
  out += (long long)blockIdx.z * N * N;  // this slice's partial counts

  float acc[BN / ROWS];
#pragma unroll
  for (int r = 0; r < BN / ROWS; ++r) acc[r] = 0.f;

  for (long long m0 = m_begin; m0 < m_end; m0 += BM) {
    __syncthreads();  // the previous chunk is no longer read
    for (int e = tid; e < BN * BM; e += THREADS) {
      const int r = e / BM, c = e % BM;
      const long long m = m0 + c;
      const bool in_m = m < m_end;
      pi_sh[r][c] = (in_m && i0 + r < N) ? preds[(long long)(i0 + r) * M + m] : 0;
      pj_sh[r][c] = (in_m && j0 + r < N) ? preds[(long long)(j0 + r) * M + m] : 0;
    }
    if (tid < BM) v_sh[tid] = (m0 + tid < m_end) ? valid[m0 + tid] : 0.f;
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < BM; ++c) {
      const int b = pj_sh[tx][c];
      const float v = v_sh[c];
#pragma unroll
      for (int r = 0; r < BN / ROWS; ++r)
        acc[r] += (pi_sh[ty + r * ROWS][c] != b) ? v : 0.f;
    }
  }
  const int j = j0 + tx;
#pragma unroll
  for (int r = 0; r < BN / ROWS; ++r) {
    const int i = i0 + ty + r * ROWS;
    if (i < N && j < N) out[(long long)i * N + j] = acc[r];
  }
}

// counts[e] = sum over slices z, in order, of partials[z][e].
__global__ void sum_slices(const float* __restrict__ partials,
                           float* __restrict__ counts, long long nn,
                           int splits) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= nn) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += partials[(long long)z * nn + e];
  counts[e] = s;
}

}  // namespace

// preds (N, M) int32, valid (M,) float32, counts (N, N) float32, and with
// splits > 1 a scratch `partials` of (splits, N, N) float32: contiguous on
// the device.  Launches on `stream`; returns cudaGetLastError().
extern "C" int disagreement_counts_f32(const int* preds, const float* valid,
                                       float* counts, float* partials,
                                       int N, long long M, int splits,
                                       void* stream) {
  if (N <= 0 || M <= 0 || splits <= 0 || splits > 65535 ||
      (splits > 1 && partials == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const unsigned nb = (unsigned)((N + BN - 1) / BN);
  // slices are whole chunks: ceil(M / splits) rounded up to BM
  const long long slice = ((M + splits - 1) / splits + BM - 1) / BM * BM;
  disagreement_kernel<<<dim3(nb, nb, splits), dim3(BN, ROWS), 0, st>>>(
      preds, valid, splits > 1 ? partials : counts, N, M, slice);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long nn = (long long)N * N;
  sum_slices<<<(unsigned)((nn + 255) / 256), 256, 0, st>>>(partials, counts,
                                                          nn, splits);
  return (int)cudaGetLastError();
}

extern "C" const char* disagreement_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
