// Batched inverse of symmetric positive definite matrices by Gauss-Jordan
// elimination without pivoting, in exact f32, for Hopper (sm_90a).
//
// Replaces the TPU kernel matrix_factorization_tpu/ops/pallas_spd.py:56
// `_gj_kernel` (launched by `gj_inverse`), the leaf of the Schur-recursion
// inverse `ops/spd.py::spd_inverse` for blocks of d <= 128. Every ALS and
// iALS sweep reaches it through `spd_solve` (the two Schur halves of
// d = 201 are d = 104 and 97; k = 100 gives d = 101; ImplicitALS's default
// gives d = 64).
//
// Step j of d, on the (d, d) matrix M (initially A):
//
//   p = M[j][j]
//   u = M[:, j] - e_j
//   v = (M[j, :] + e_j) * (1 / p)      exact division, no fast math
//   M = M - u (x) v                     rank-1 update
//
// The e_j shifts fold the rewrites of the pivot row, column and diagonal
// into the one update (the 1x1 case: p - (p - 1)(p + 1)/p = 1/p). For an SPD
// A the pivots are the positive diagonals of successive Schur complements,
// so no pivoting is needed; a matrix that is not SPD gives garbage, as on the
// TPU, and the callers Jacobi-scale first. This kernel reads the pivot
// column from shared memory. (The TPU kernel rebuilt it from the pivot row
// by GJ's sign symmetry, because Mosaic could not load a dynamic column;
// for SPD input the two agree up to rounding.) The compiler contracts the
// update into one FMA per element.
//
// Design. One CTA per matrix: the matrix lives in dynamic shared memory
// (d^2 floats, plus u and v: 43 KB at d = 104, 65 KB at d = 128, which needs
// the opt-in above 48 KB) from one coalesced load to one coalesced store, so
// device memory sees each byte once. Each step computes u and v into shared
// memory, synchronises, then warp w updates rows w, w + 8, ... with lane l
// on columns l, l + 32, ... (v's entries for those columns in registers, u_i
// broadcast), and synchronises again. `out` may alias `A`: a CTA reads its
// whole matrix before it writes any of it. The grid is E CTAs (gridDim.x
// takes 2^31 - 1) and offsets are 64-bit.
//
// What bounds it on an H100 SXM: operations. A matrix takes 2 d^3 FLOP and
// moves 8 d^2 bytes (read once, written once). At E = 15,625 and d = 104
// (the larger Schur half of a config-3 user chunk at k = 200) that is
// 35.2 GFLOP, 0.53 ms at 67 TFLOP/s f32, against 1.35 GB, 0.40 ms at
// 3.35 TB/s. chip_smoke.py computes the bound from the shapes it runs. This
// simple kernel is bound well short of it by shared-memory traffic (a load
// and a store of M per FMA) and two block barriers a step. Later work: keep
// each thread's elements in registers and broadcast only the pivot row and
// column; give small d one warp per matrix.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxD = 128;
constexpr int kMaxWarps = 8;

// CPL: columns a lane owns, ceil(d / 32) <= 4.
template <int CPL>
__global__ void __launch_bounds__(kMaxWarps * 32)
gj_inverse_kernel(const float* A, float* out, int d) {
  extern __shared__ float smem[];
  const int n = d * d;
  float* M = smem;
  float* u = smem + n;
  float* v = u + d;
  const size_t base = static_cast<size_t>(blockIdx.x) * static_cast<size_t>(n);
  for (int k = threadIdx.x; k < n; k += blockDim.x) M[k] = A[base + k];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int j = 0; j < d; ++j) {
    const float inv_p = 1.0f / M[j * d + j];
    for (int t = threadIdx.x; t < d; t += blockDim.x) {
      const float e = t == j ? 1.0f : 0.0f;
      u[t] = M[t * d + j] - e;
      v[t] = (M[j * d + t] + e) * inv_p;
    }
    __syncthreads();
    float vc[CPL];
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
      const int c = lane + 32 * q;
      vc[q] = c < d ? v[c] : 0.0f;
    }
    for (int i = warp; i < d; i += n_warps) {
      const float ui = u[i];
      float* row = M + i * d;
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        const int c = lane + 32 * q;
        if (c < d) row[c] -= ui * vc[q];
      }
    }
    __syncthreads();
  }

  for (int k = threadIdx.x; k < n; k += blockDim.x) out[base + k] = M[k];
}

template <int CPL>
int launch(const float* A, float* out, long long E, int d, cudaStream_t s) {
  const int warps = d < kMaxWarps ? d : kMaxWarps;
  const size_t smem = (static_cast<size_t>(d) * d + 2 * d) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gj_inverse_kernel<CPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gj_inverse_kernel<CPL><<<static_cast<unsigned int>(E), warps * 32, smem, s>>>(
      A, out, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A and out: E row-major (d, d) f32 matrices, contiguous; out may be A. Runs
// on `stream`, allocates nothing, and returns cudaGetLastError() after the
// launch; a shape it does not take (E outside [1, 2^31 - 1], d outside
// [1, 128]) returns cudaErrorInvalidValue without launching.
extern "C" int mf_gj_inverse(const void* A, void* out, long long E, int d,
                             void* stream) {
  if (E <= 0 || E > 2147483647LL || d <= 0 || d > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* a = static_cast<const float*>(A);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((d + 31) / 32) {
    case 1:
      return launch<1>(a, o, E, d, s);
    case 2:
      return launch<2>(a, o, E, d, s);
    case 3:
      return launch<3>(a, o, E, d, s);
    default:
      return launch<4>(a, o, E, d, s);
  }
}

extern "C" const char* mf_spd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
