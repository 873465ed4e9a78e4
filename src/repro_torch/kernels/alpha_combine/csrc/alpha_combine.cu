// Weighted source->target parameter mixing for Hopper (sm_90a):
//
//   out[t, p] = sum_s alpha[s, t] * theta[s, p]      float32, FMA only
//
// Replaces the Pallas TPU kernel src/repro/kernels/alpha_combine/kernel.py
// (_combine_kernel / alpha_combine_flat).  There the grid walks P in
// blocks with the whole alpha matrix resident in VMEM; here:
//
//   * blocks tile P (one p per thread, neighbouring threads on
//     neighbouring p, so every theta row is read coalesced) and T
//     (TILE_T targets per block, accumulated in registers);
//   * a TILE_S x TILE_T slab of alpha is staged in shared memory per
//     pass over s, so S * T of any size fits (the TPU kernel needed all
//     of alpha in VMEM at once);
//   * ragged P, S and T are masked in the kernel; the wrapper pads
//     nothing.
//
// What bounds it on an H100: at the transfer's shape (S = T = 10,
// P = 48,158) the bytes (3.85 MB, ~1.2 us at 3.35 TB/s) and the launch;
// at S = T = 256 the fp32 FMAs (6.3 GFLOP, ~94 us at 67 TFLOP/s without
// tensor cores).  Plain fp32 FMA keeps the result within float rounding
// of the fp32 reference (no TF32); theta is re-read once per T tile.
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK_P = 256;  // threads per block, one p each
constexpr int TILE_T = 32;    // targets per block: accumulators per thread
constexpr int TILE_S = 64;    // alpha rows staged in shared memory per pass

__global__ void __launch_bounds__(BLOCK_P)
alpha_combine_kernel(const float* __restrict__ theta,
                     const float* __restrict__ alpha,
                     float* __restrict__ out, int S, int T, long long P) {
  __shared__ __align__(16) float a_sh[TILE_S][TILE_T];
  const long long p = (long long)blockIdx.x * BLOCK_P + threadIdx.x;
  const int t0 = blockIdx.y * TILE_T;
  const bool live = p < P;

  float acc[TILE_T];
#pragma unroll
  for (int k = 0; k < TILE_T; ++k) acc[k] = 0.f;

  for (int s0 = 0; s0 < S; s0 += TILE_S) {
    const int ns = min(TILE_S, S - s0);
    __syncthreads();  // the previous slab is no longer read
    for (int e = threadIdx.x; e < TILE_S * TILE_T; e += BLOCK_P) {
      const int ls = e / TILE_T, lt = e % TILE_T;
      a_sh[ls][lt] = (ls < ns && t0 + lt < T)
                         ? alpha[(long long)(s0 + ls) * T + t0 + lt]
                         : 0.f;
    }
    __syncthreads();
    if (live) {
      const float* th_col = theta + (long long)s0 * P + p;
#pragma unroll 4
      for (int ls = 0; ls < ns; ++ls) {
        const float th = th_col[(long long)ls * P];
        const float4* row = reinterpret_cast<const float4*>(a_sh[ls]);
#pragma unroll
        for (int k = 0; k < TILE_T / 4; ++k) {
          const float4 a = row[k];
          acc[4 * k + 0] = fmaf(a.x, th, acc[4 * k + 0]);
          acc[4 * k + 1] = fmaf(a.y, th, acc[4 * k + 1]);
          acc[4 * k + 2] = fmaf(a.z, th, acc[4 * k + 2]);
          acc[4 * k + 3] = fmaf(a.w, th, acc[4 * k + 3]);
        }
      }
    }
  }
  if (live) {
#pragma unroll
    for (int k = 0; k < TILE_T; ++k)
      if (t0 + k < T) out[(long long)(t0 + k) * P + p] = acc[k];
  }
}

}  // namespace

// theta (S, P), alpha (S, T), out (T, P): contiguous float32 on the device.
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int alpha_combine_f32(const float* theta, const float* alpha,
                                 float* out, int S, int T, long long P,
                                 void* stream) {
  if (S <= 0 || T <= 0 || P <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((P + BLOCK_P - 1) / BLOCK_P),
                  (unsigned)((T + TILE_T - 1) / TILE_T));
  alpha_combine_kernel<<<grid, BLOCK_P, 0, (cudaStream_t)stream>>>(
      theta, alpha, out, S, T, P);
  return (int)cudaGetLastError();
}

extern "C" const char* alpha_combine_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
