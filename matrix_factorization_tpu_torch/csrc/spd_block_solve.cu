// Batched SPD solves A x = b, one right-hand side a system, by one level of
// Schur block elimination of the Jacobi-scaled system, for Hopper (sm_90a),
// in exact f32 with a float64 residual.
//
// Replaces no TPU kernel: the JAX package (ops/spd.py::spd_solve) and the
// port before it formed the explicit Schur-recursion inverse of the scaled
// system and applied it by batched matrix-vector products. At the ALS
// shape of k = 200 (d = 201) that assembled four blocks into a 161.6 KB
// inverse a system with strided copies, then read it back three times,
// each pass bound by the bytes of a whole matrix. A solve never needs the
// inverse. ops/spd.py::_block_solve takes systems of 128 < d <= 232:
//
//   ds  = 1 / sqrt(max(diag A, FLT_MIN)),  As = D A D,  D = diag(ds)
//   m   = ((d / 2 + 7) / 8) * 8,  n = d - m       (split at a multiple of 8)
//   inv11 = As11^-1,  W = inv11 As12,  invS = (As22 - As12^T W)^-1
//
// the inverses by the Gauss-Jordan leaf (csrc/spd_gj.cu) and the two
// products by the batched f32 product, between the two kernels here:
//
// spd_split_kernel (mf_spd_split): one block an entity reads the diagonal,
// forms ds with the correctly rounded square root and reciprocal (as
// torch.reciprocal(torch.sqrt(.)) does on either device), then streams the
// rows of A once and writes (A_ij ds_i) ds_j into three contiguous blocks,
// As11 (E, m, m), As12 (E, m, n) and As22 (E, n, n), and ds (E, d). The
// lower-left block is As12^T: it is neither read nor written. A warp takes
// a row, a lane up to kLanes of its columns, all loads before the stores.
// What bounds it: bytes, 2 (m^2 + m n + n^2) + 2 d floats an entity.
//
// block_solve_kernel (mf_spd_block_solve): one persistent block of
// kSolveThreads an SM walks the entities e, e + grid, ... For each it
// stages inv11, As12, invS and W (d^2 floats together, 161.6 KB at
// d = 201) in shared memory by cp.async, one commit group a block in the
// order the elimination reads them, and solves the scaled system
//
//   y1 = inv11 rs1,  t = rs2 - As12^T y1,  x2 = invS t,  x1 = y1 - W x2
//
// with rs = ds b and x = ds [x1; x2], the first steps running while the
// later blocks still arrive. Then `refine` steps of iterative refinement
// against the unscaled A: r = b - A x summed in float64 (each f32 product
// is exact there), streamed once through the block, a warp four rows at a
// time; then x += ds elim(ds r) from the staged blocks. It writes only x
// (E, d). The next entity's blocks are staged during this one's last
// elimination, each into the region its block frees once every thread
// has read it, so that the card's memory keeps streaming through the
// block's compute. (On an H100, prefetching A into L2 ahead of the
// residual, this entity's or the next one's, gained nothing or lost
// up to 3%.)
// A row product (y1, x2, W x2) takes a warp four rows at a time, each
// lane's slice of the vector in registers; the column product As12^T y1
// takes kGroups partial sums a column, added in group order. Every sum
// has a fixed order: the same bits in every run, no atomics. What bounds
// it: bytes, the staged blocks, A, ds, b and x: 2 d^2 + 4 d floats an
// entity at one refinement. Shared memory bounds d: the blocks and the
// vectors of d = 232 take 222,976 of the 232,448 bytes a block may have.
//
// Every block may start anywhere a float may (a source 1-3 floats past a
// 16-byte boundary is staged with its region shifted by as much, the
// head and tail copied by plain loads): an entity's invS lies n^2 floats
// past the last one's, so at an odd n (d = 201: n = 97) three entities in
// four start off a boundary, however its tensor is allocated. Offsets are 64-bit; the split's
// grid is E blocks (up to 2^31 - 1). The back-solve's launch plan (its
// shared bytes and grid) comes from ops/cuda_spd_solve.py::solve_smem and
// solve_grid and is checked here against what this file computes.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMinD = 129;  // below: the Gauss-Jordan leaf inverts the whole system
constexpr int kMaxD = 232;  // above: the staged blocks outgrow shared memory
constexpr int kMaxSmem = 232448;
constexpr int kSplitThreads = 256;
constexpr int kSolveThreads = 512;
constexpr int kWarps = kSolveThreads / 32;
constexpr int kLanes = (kMaxD + 31) / 32;  // columns of a row a lane takes at most
constexpr int kHalfLanes = 4;              // the same for a block's side (m, n <= 128)
constexpr int kColTile = 128;              // columns of the column product a pass
constexpr int kGroups = kSolveThreads / kColTile;  // its partial sums a column

__host__ __device__ constexpr int split_of(int d) { return ((d / 2 + 7) / 8) * 8; }

// floats of a block's shared region: its size rounded up to 16 bytes, and
// 4 floats for a source that starts off a 16-byte boundary
__host__ __device__ constexpr int region(int n) { return (n + 3) / 4 * 4 + 4; }

// dynamic shared memory of the back-solve: the four staged blocks, then
// ds, b, rs, u, v and x (d each) and the column product's partial sums
__host__ __device__ constexpr int solve_smem(int d) {
  return (region(split_of(d) * split_of(d)) +
          2 * region(split_of(d) * (d - split_of(d))) +
          region((d - split_of(d)) * (d - split_of(d))) + 6 * d +
          kGroups * kColTile) *
         4;
}

static_assert(solve_smem(kMaxD) <= kMaxSmem, "the largest d fits one block");
static_assert(kMaxD - split_of(kMaxD) <= kColTile && split_of(kMaxD) <= 32 * kHalfLanes,
              "a block's side fits the row and column products");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Offset in floats of p past a 16-byte boundary.
__device__ __forceinline__ int misalign(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// ---------------------------------------------------------------------------
// The split
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kSplitThreads)
spd_split_kernel(const float* __restrict__ A, int d, int m, float* __restrict__ A11,
                 float* __restrict__ A12, float* __restrict__ A22,
                 float* __restrict__ ds_out) {
  __shared__ float ds[kMaxD];
  const size_t e = blockIdx.x;
  const int n = d - m;
  const float* Ae = A + e * d * d;
  for (int i = threadIdx.x; i < d; i += kSplitThreads) {
    float a = Ae[static_cast<size_t>(i) * (d + 1)];
    a = a < FLT_MIN ? FLT_MIN : a;  // clamp_min(tiny): a NaN stays a NaN
    const float s = __frcp_rn(__fsqrt_rn(a));
    ds[i] = s;
    ds_out[e * d + i] = s;
  }
  __syncthreads();
  float* o11 = A11 + e * m * m;
  float* o12 = A12 + e * m * n;
  float* o22 = A22 + e * n * n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < d; i += kSplitThreads / 32) {
    const float* row = Ae + static_cast<size_t>(i) * d;
    const int j0 = i < m ? 0 : m;  // rows of As22 skip As21
    float v[kLanes];
#pragma unroll
    for (int t = 0; t < kLanes; ++t) {
      const int j = j0 + lane + 32 * t;
      if (j < d) v[t] = __ldcs(row + j);
    }
    const float si = ds[i];
#pragma unroll
    for (int t = 0; t < kLanes; ++t) {
      const int j = j0 + lane + 32 * t;
      if (j < d) {
        const float y = __fmul_rn(__fmul_rn(v[t], si), ds[j]);
        if (i >= m)
          o22[(i - m) * n + (j - m)] = y;
        else if (j < m)
          o11[i * m + j] = y;
        else
          o12[i * n + (j - m)] = y;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The back-solve
// ---------------------------------------------------------------------------

struct SolveArgs {
  const float* inv11;  // (E, m, m)
  const float* A12;    // (E, m, n) As12
  const float* invS;   // (E, n, n)
  const float* W;      // (E, m, n)
  const float* ds;     // (E, d)
  const float* A;      // (E, d, d) the unscaled systems
  const float* b;      // (E, d)
  float* x;            // (E, d)
  long long E;
  int d, m, refine;
};

// Issue the copy of n floats from src into the shared region `reg`: a
// scalar head up to src's next 16-byte boundary, 16-byte cp.async copies,
// a scalar tail, the region shifted by src's misalignment so that both
// sides of every 16-byte copy are aligned. Returns where the block starts.
__device__ __forceinline__ float* stage(float* reg, const float* src, int n, int tid) {
  const int mis = misalign(src);
  float* dst = reg + mis;
  const int head = min(n, (4 - mis) & 3);
  const int nvec = (n - head) / 4;
  for (int k = tid; k < head; k += kSolveThreads) dst[k] = src[k];
  for (int k = tid; k < nvec; k += kSolveThreads)
    cp_async16(smem_u32(dst + head + 4 * k), src + head + 4 * k);
  for (int k = head + 4 * nvec + tid; k < n; k += kSolveThreads) dst[k] = src[k];
  return dst;
}

// The sums s[0..3] of four rows, each spread over a warp's lanes, into
// one lane each: a butterfly that halves the values a lane holds at its
// first two steps (2 + 1 + 3 shuffles, not 4 x 5). Lane l ends with the
// sum of row 2 bit4(l) + bit3(l).
template <typename T>
__device__ __forceinline__ T sum_four(const T (&s)[4], int lane) {
  const bool h16 = lane & 16, h8 = lane & 8;
  T k0 = h16 ? s[2] : s[0], k1 = h16 ? s[3] : s[1];
  k0 += __shfl_xor_sync(0xffffffffu, h16 ? s[0] : s[2], 16);
  k1 += __shfl_xor_sync(0xffffffffu, h16 ? s[1] : s[3], 16);
  T k = h8 ? k1 : k0;
  k += __shfl_xor_sync(0xffffffffu, h8 ? k0 : k1, 8);
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) k += __shfl_xor_sync(0xffffffffu, k, o);
  return k;
}

__device__ __forceinline__ int row_of_lane(int lane) {
  return 2 * ((lane >> 4) & 1) + ((lane >> 3) & 1);
}

// out[i] = (sub ? sub[i] - s : s), s = sum_j M[i][j] v[j] for i < rows,
// j < cols (<= 32 kHalfLanes): a warp four rows at a time, lane l's
// v[l + 32 t] in registers, one sum_four.
__device__ __forceinline__ void row_product(const float* M, int rows, int cols,
                                            const float* v, const float* sub,
                                            float* out, int warp, int lane) {
  float vr[kHalfLanes];
#pragma unroll
  for (int t = 0; t < kHalfLanes; ++t) {
    const int j = lane + 32 * t;
    vr[t] = j < cols ? v[j] : 0.f;
  }
  for (int i0 = 4 * warp; i0 < rows; i0 += 4 * kWarps) {
    float s[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float* row = M + min(i0 + r, rows - 1) * cols;  // past the end: discarded
      s[r] = 0.f;
#pragma unroll
      for (int t = 0; t < kHalfLanes; ++t) {
        const int j = lane + 32 * t;
        if (j < cols) s[r] = fmaf(row[j], vr[t], s[r]);
      }
    }
    const float k = sum_four(s, lane);
    const int i = i0 + row_of_lane(lane);
    if ((lane & 7) == 0 && i < rows) out[i] = sub != nullptr ? sub[i] - k : k;
  }
}

// Floats of staged block k of a system: inv11, As12, invS, W.
__device__ __forceinline__ int block_floats(int k, int m, int n) {
  return k == 0 ? m * m : k == 2 ? n * n : m * n;
}

// Stage block k of entity e into its region as one commit group; returns
// where it starts.
__device__ __forceinline__ const float* stage_block(const SolveArgs& a, int k,
                                                    long long e, float* reg, int tid) {
  const int m = a.m, n = a.d - a.m, size = block_floats(k, m, n);
  const float* src = k == 0 ? a.inv11 : k == 1 ? a.A12 : k == 2 ? a.invS : a.W;
  const float* p = stage(reg, src + e * static_cast<size_t>(size), size, tid);
  cp_async_commit();
  return p;
}

// v = As^-1 rs by the staged blocks blk (inv11, As12, invS, W): y1 into
// u[0, m), t into u[m, d), x2 into v[m, d), x1 into v[0, m). With `wait`,
// each step first waits for the commit group of the block it reads (the
// entity's first elimination). With nx >= 0 (its last), each block, once
// every thread has read it, is staged again from entity nx into the same
// region and blk[k] points there: the next entity's blocks stream in
// while this one's steps run. Groups complete in commit order, so a step
// waits until at most the groups committed after its block's are pending:
// 3 - k of this entity's, and k of the next one's when it stages them.
__device__ __forceinline__ void eliminate(const SolveArgs& a, const float* (&blk)[4],
                                          float* const (&reg)[4], bool wait,
                                          long long nx, const float* rs, float* u,
                                          float* v, float* part, int tid) {
  const int d = a.d, m = a.m, n = d - m, warp = tid >> 5, lane = tid & 31;
  if (wait) cp_async_wait<3>();
  __syncthreads();
  row_product(blk[0], m, m, rs, nullptr, u, warp, lane);
  if (wait) nx >= 0 ? cp_async_wait<3>() : cp_async_wait<2>();
  __syncthreads();
  if (nx >= 0) blk[0] = stage_block(a, 0, nx, reg[0], tid);
  {  // t = rs2 - As12^T y1: kGroups partial sums a column, in group order
    const int c = tid % kColTile, g = tid / kColTile;
    const float* A12 = blk[1];
    float s = 0.f;
    if (c < n) {
#pragma unroll 4
      for (int i = g; i < m; i += kGroups) s = fmaf(A12[i * n + c], u[i], s);
    }
    part[g * kColTile + c] = s;
    __syncthreads();
    if (nx >= 0) blk[1] = stage_block(a, 1, nx, reg[1], tid);
    if (tid < n) {
      float p = part[tid];
#pragma unroll
      for (int k = 1; k < kGroups; ++k) p += part[k * kColTile + tid];
      u[m + tid] = rs[m + tid] - p;
    }
  }
  if (wait) nx >= 0 ? cp_async_wait<3>() : cp_async_wait<1>();
  __syncthreads();
  row_product(blk[2], n, n, u + m, nullptr, v + m, warp, lane);
  if (wait) nx >= 0 ? cp_async_wait<3>() : cp_async_wait<0>();
  __syncthreads();
  if (nx >= 0) blk[2] = stage_block(a, 2, nx, reg[2], tid);
  row_product(blk[3], m, n, v + m, u, v, warp, lane);
  __syncthreads();
  if (nx >= 0) blk[3] = stage_block(a, 3, nx, reg[3], tid);
}

__global__ void __launch_bounds__(kSolveThreads, 1) block_solve_kernel(SolveArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int d = a.d, m = a.m, n = d - m;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t dd = static_cast<size_t>(d) * d;
  float* const reg[4] = {smem, smem + region(m * m), smem + region(m * m) + region(m * n),
                         smem + region(m * m) + region(m * n) + region(n * n)};
  float* const ds = reg[3] + region(m * n);
  float* const bv = ds + d;
  float* const rs = bv + d;
  float* const u = rs + d;
  float* const v = u + d;
  float* const x = v + d;
  float* const part = x + d;

  // A persistent block walks the entities e, e + grid, ...: the next
  // entity's blocks are staged during this one's last elimination.
  const float* blk[4];
  for (int k = 0; k < 4; ++k) blk[k] = stage_block(a, k, blockIdx.x, reg[k], tid);
  for (long long e = blockIdx.x; e < a.E; e += gridDim.x) {
    const long long nx = e + gridDim.x < a.E ? e + gridDim.x : -1;
    const float* Ae = a.A + e * dd;
    for (int i = tid; i < d; i += kSolveThreads) {
      const float s = a.ds[e * d + i], bi = a.b[e * d + i];
      ds[i] = s;
      bv[i] = bi;
      rs[i] = __fmul_rn(s, bi);
    }

    // -- x = ds elim(ds b)
    eliminate(a, blk, reg, true, a.refine == 0 ? nx : -1, rs, u, v, part, tid);
    for (int i = tid; i < d; i += kSolveThreads) x[i] = __fmul_rn(ds[i], v[i]);
    __syncthreads();

    // -- refinement: r = b - A x in float64, x += ds elim(ds r)
    for (int step = 0; step < a.refine; ++step) {
      double xr[kLanes];
#pragma unroll
      for (int t = 0; t < kLanes; ++t) {
        const int j = lane + 32 * t;
        xr[t] = j < d ? static_cast<double>(x[j]) : 0.0;
      }
      for (int i0 = 4 * warp; i0 < d; i0 += 4 * kWarps) {  // a warp four rows at a time
        float ar[4][kLanes];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float* row = Ae + static_cast<size_t>(min(i0 + r, d - 1)) * d;
#pragma unroll
          for (int t = 0; t < kLanes; ++t) {
            const int j = lane + 32 * t;
            ar[r][t] = j < d ? __ldcs(row + j) : 0.f;
          }
        }
        double s[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          s[r] = 0.0;
#pragma unroll
          for (int t = 0; t < kLanes; ++t)
            s[r] = fma(static_cast<double>(ar[r][t]), xr[t], s[r]);
        }
        const double k = sum_four(s, lane);
        const int i = i0 + row_of_lane(lane);
        if ((lane & 7) == 0 && i < d)
          rs[i] = __fmul_rn(ds[i], static_cast<float>(static_cast<double>(bv[i]) - k));
      }
      eliminate(a, blk, reg, false, step == a.refine - 1 ? nx : -1, rs, u, v, part, tid);
      for (int i = tid; i < d; i += kSolveThreads)
        x[i] = __fadd_rn(x[i], __fmul_rn(ds[i], v[i]));
      __syncthreads();
    }

    for (int i = tid; i < d; i += kSolveThreads) a.x[e * d + i] = x[i];
  }
}

bool shape_ok(long long E, int d) {
  return E >= 1 && E <= 2147483647LL && d >= kMinD && d <= kMaxD;
}

}  // namespace

extern "C" {

// ds (E, d) and the Jacobi-scaled blocks As11 (E, m, m), As12 (E, m, n)
// and As22 (E, n, n), m = ((d / 2 + 7) / 8) * 8, of the E row-major
// (d, d) f32 matrices A, all contiguous, for 129 <= d <= 232. Runs on
// `stream`, allocates nothing, and returns cudaGetLastError() after the
// launch; a shape it does not take returns cudaErrorInvalidValue without
// launching.
int mf_spd_split(const void* A, long long E, int d, void* A11, void* A12, void* A22,
                 void* ds, void* stream) {
  if (!shape_ok(E, d)) return static_cast<int>(cudaErrorInvalidValue);
  spd_split_kernel<<<static_cast<unsigned int>(E), kSplitThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(A), d, split_of(d), static_cast<float*>(A11),
      static_cast<float*>(A12), static_cast<float*>(A22), static_cast<float*>(ds));
  return static_cast<int>(cudaGetLastError());
}

// x (E, d), the solutions of A x = b by the blocks of the scaled system
// (inv11 (E, m, m), As12 (E, m, n), invS (E, n, n), W = inv11 As12
// (E, m, n)) and its scaling ds (E, d), then `refine` steps of iterative
// refinement against A (E, d, d); every tensor f32 and contiguous, for
// 129 <= d <= 232 and refine >= 0. `grid` persistent blocks (one an
// SM: ops/cuda_spd_solve.py::solve_grid) take the entities in turn;
// smem_bytes must be what this file computes for d
// (ops/cuda_spd_solve.py::solve_smem). Runs on `stream`, allocates
// nothing, and returns cudaGetLastError() after the launch; what it does
// not take returns cudaErrorInvalidValue without launching.
int mf_spd_block_solve(const void* inv11, const void* A12, const void* invS,
                       const void* W, const void* ds, const void* A, const void* b,
                       void* x, long long E, int d, int refine, int grid,
                       int smem_bytes, void* stream) {
  if (!shape_ok(E, d) || refine < 0 || grid < 1 || grid > E ||
      smem_bytes != solve_smem(d))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      block_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  SolveArgs a;
  a.inv11 = static_cast<const float*>(inv11);
  a.A12 = static_cast<const float*>(A12);
  a.invS = static_cast<const float*>(invS);
  a.W = static_cast<const float*>(W);
  a.ds = static_cast<const float*>(ds);
  a.A = static_cast<const float*>(A);
  a.b = static_cast<const float*>(b);
  a.x = static_cast<float*>(x);
  a.E = E;
  a.d = d;
  a.m = split_of(d);
  a.refine = refine;
  block_solve_kernel<<<grid, kSolveThreads, smem_bytes,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* mf_spd_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
