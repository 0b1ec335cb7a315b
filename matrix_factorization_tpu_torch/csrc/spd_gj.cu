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
//   M = M - u (x) v                     rank-1 update, one fmaf an element
//
// The e_j shifts fold the rewrites of the pivot row, column and diagonal
// into the one update (the 1x1 case: p - (p - 1)(p + 1)/p = 1/p). For an SPD
// A the pivots are the positive diagonals of successive Schur complements,
// so no pivoting is needed; a matrix that is not SPD gives garbage, as on the
// TPU, and the callers Jacobi-scale first. (The TPU kernel rebuilt the pivot
// column from the pivot row by GJ's sign symmetry, because Mosaic could not
// load a dynamic column; this kernel uses the column itself. For SPD input
// the two agree up to rounding.)
//
// What bounds it on an H100 SXM: operations. A matrix takes 2 d^3 FLOP and
// moves 8 d^2 bytes (read once, written once). At E = 15,625 and d = 104
// (the larger Schur half of a config-3 user chunk at k = 200) that is
// 35.2 GFLOP, 0.53 ms at 67 TFLOP/s f32, against 1.35 GB, 0.40 ms at
// 3.35 TB/s. chip_smoke.py computes the bound from the shapes it runs.
//
// Design: the matrix lives in registers. A matrix gets S x S threads
// (S = 16, or S = 8 for d <= 64 with four matrices a block, so that a block
// has 8 warps), and thread (ty, tx) holds the R x R elements of rows
// ty + S a and columns tx + S b (R = ceil(d / S); 7 x 7 at d = 104);
// elements past d are zeros and stay zeros. The owners of pivot column j
// (tx == j mod S) and row j (ty == j mod S) publish them, as they stand,
// into shared slots; every thread forms its own u, v and 1 / p from the
// slots with 16-byte broadcast reads and does its R^2 FMAs, so M itself
// never touches shared memory and no one warp carries the division. Steps
// go in rounds of two behind one block barrier: each thread also forms
// step j + 1's pivot row and column after step j from the slots, with the
// same fmaf the owners do, so the bits are those of one step a barrier.
// Look-ahead: each round first updates the register row and column that
// hold the next round's pivots, publishes them into the other parity's
// slots, and only then runs its other FMAs. Steps are walked as j = t0 + S
// b with b unrolled, so the owned register row and column (b) is a
// compile-time constant and no register array is indexed at run time. The
// launch bounds keep the registers spill-free (2 blocks an SM, 4 for small
// R). The matrices pass through shared memory once on the way in and once
// on the way out, as 16-byte copies of the block's contiguous span of the
// batch; `out` may alias `A`, since a block reads its whole span before it
// writes any of it. The grid is ceil(E / per block) blocks (up to 2^31 - 1)
// and offsets are 64-bit. The launch plan (S, R, matrices a block, shared
// bytes) comes from ops/cuda_spd.py::gj_plan and is checked here against
// what this file computes.
//
// Measured (PERF.md): 2.45 ms at (15,625, 104), 2.7x the one-CTA shared-
// memory design this replaced, 21% of the operations bound. Halving the
// barriers (the rounds of two) moved it by 2%, so what bounds it is the
// rate at which warps dispatch instructions: per step a warp runs its 49
// FMAs beside ~35 other instructions (slot reads, reciprocals, u and v, the
// publication, the loop), 16 warps an SM at 120 registers, and 16% of the
// FMAs go to the padding of d = 104 to 112.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxD = 128;
constexpr int kMaxSmem = 232448;

// floats a thread's slot takes in the pivot buffers: 16-byte aligned, and
// for R > 4 (two 16-byte reads) 12 floats, so that eight neighbouring
// threads' 16-byte reads fall in eight different bank groups
__host__ __device__ constexpr int slot_floats(int r) { return r <= 4 ? 4 : 12; }

// dynamic shared memory: per matrix, for two parities, the pivot column
// and row slots of a round's two steps; then the staged matrices with 3
// floats of slack to align the 16-byte copies
__host__ __device__ constexpr int gj_pivot_floats(int s, int r, int mpb) {
  return mpb * 2 * 2 * 2 * s * slot_floats(r);
}
__host__ __device__ constexpr int gj_smem(int s, int r, int mpb, int d) {
  return (gj_pivot_floats(s, r, mpb) + mpb * d * d + 4) * 4;
}

// Offset in floats of p past a 16-byte boundary.
__device__ __forceinline__ int misalign(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// Copy n floats between device memory and shared memory, src and dst
// `mis` floats past a 16-byte boundary both: 16 bytes at a time between a
// scalar head and tail.
__device__ __forceinline__ void copy_span(float* dst, const float* src, int n,
                                          int mis, int tid, int nthreads) {
  const int head = min(n, (4 - mis) & 3);
  const int nvec = (n - head) / 4;
  for (int k = tid; k < head; k += nthreads) dst[k] = src[k];
  const float4* s4 = reinterpret_cast<const float4*>(src + head);
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  for (int k = tid; k < nvec; k += nthreads) d4[k] = s4[k];
  for (int k = head + 4 * nvec + tid; k < n; k += nthreads) dst[k] = src[k];
}

// Publish step j's pivot column and row as they stand, into the slots cb
// and rb: the owners of column j (tx == t0) write M[i][j] for their rows,
// the owners of row j (ty == t0) write M[j][c] for their columns, 16 bytes
// a store. `jb` is j's register index (j = t0 + S jb), a constant once the
// caller is unrolled.
template <int S, int R>
__device__ __forceinline__ void publish(const float (&M)[R][R], float* cb,
                                        float* rb, int ty, int tx, int t0,
                                        int jb) {
  constexpr int RP = slot_floats(R);
  constexpr int NV = (R + 3) / 4;
  if (tx == t0) {
#pragma unroll
    for (int k = 0; k < NV; ++k)
      *reinterpret_cast<float4*>(cb + ty * RP + 4 * k) = make_float4(
          M[min(4 * k, R - 1)][jb], M[min(4 * k + 1, R - 1)][jb],
          M[min(4 * k + 2, R - 1)][jb], M[min(4 * k + 3, R - 1)][jb]);
  }
  if (ty == t0) {
#pragma unroll
    for (int k = 0; k < NV; ++k)
      *reinterpret_cast<float4*>(rb + tx * RP + 4 * k) = make_float4(
          M[jb][min(4 * k, R - 1)], M[jb][min(4 * k + 1, R - 1)],
          M[jb][min(4 * k + 2, R - 1)], M[jb][min(4 * k + 3, R - 1)]);
  }
}

// A round takes two steps, j and j + 1 (j even), behind one barrier. The
// slots hold pivot columns and rows j and j + 1 as they stood before step
// j. Step j's u_i = M[i][j] - [i == j] for the thread's rows and v_c =
// (M[j][c] + [c == j]) / M[j][j] for its columns come from them directly:
// i == j is (ty == t0 && a == jb), c == j is (tx == t0 && c == jb), and
// each slot element is found at its owner's slot, element jb. Step j + 1's
// are the same of column and row j + 1 after step j, which every thread
// forms itself with the fmaf its owner does: M'[i][j+1] = fmaf(-u_i,
// v_{j+1}, M[i][j+1]) and M'[j+1][c] = fmaf(-u_{j+1}, v_c, M[j+1][c]). So
// the bits are those of one step a barrier. (u skips the subtraction of 0,
// which leaves every float as it is; v keeps the addition of 0, which turns
// -0 into +0, as the reference does. 1 / p is __frcp_rn(p), the correctly
// rounded reciprocal, which is 1.0f / p.)
template <int R>
__device__ __forceinline__ void load_slot(const float* slot, float* w) {
#pragma unroll
  for (int k = 0; k < (R + 3) / 4; ++k) {
    const float4 x = *reinterpret_cast<const float4*>(slot + 4 * k);
    w[4 * k] = x.x; w[4 * k + 1] = x.y; w[4 * k + 2] = x.z; w[4 * k + 3] = x.w;
  }
}

// One step's update M -= u (x) v, one fmaf an element. With look-ahead
// (has_next), the elements of register row and column nb, which hold the
// next round's pivot rows and columns (for the threads that own them), go
// first; then that round's two steps are published, then the other FMAs
// run.
template <int S, int R>
__device__ __forceinline__ void update(float (&M)[R][R], const float* u,
                                       const float* v, int nb, bool has_next,
                                       bool has_next2, float* nc0, float* nr0,
                                       float* nc1, float* nr1, int ty, int tx,
                                       int nt0) {
#pragma unroll
  for (int c = 0; c < R; ++c) M[nb][c] = fmaf(-u[nb], v[c], M[nb][c]);
#pragma unroll
  for (int a = 0; a < R; ++a)
    if (a != nb) M[a][nb] = fmaf(-u[a], v[nb], M[a][nb]);
  if (has_next) {
    publish<S, R>(M, nc0, nr0, ty, tx, nt0, nb);
    if (has_next2) publish<S, R>(M, nc1, nr1, ty, tx, nt0 + 1, nb);
  }
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int c = 0; c < R; ++c)
      if (a != nb && c != nb) M[a][c] = fmaf(-u[a], v[c], M[a][c]);
}

// blocks an SM should hold, as far as the registers of R^2 elements, a
// step's u and v and the addressing allow without spilling
__host__ __device__ constexpr int gj_min_blocks(int r) {
  return r <= 4 ? 4 : 2;
}

template <int S, int R, int MPB>
__global__ void __launch_bounds__(S * S * MPB, gj_min_blocks(R))
gj_inverse_kernel(const float* A, float* out, long long E, int d) {
  constexpr int kThreads = S * S * MPB;
  constexpr int RP = slot_floats(R);
  constexpr int NV = (R + 3) / 4;  // 16-byte reads of a slot
  static_assert(S * S % 32 == 0, "a warp never spans two matrices");
  extern __shared__ __align__(16) float smem[];
  float* stage = smem + gj_pivot_floats(S, R, MPB);

  const int tid = threadIdx.x;
  const int m = tid / (S * S);  // matrix of the block
  const int ty = (tid % (S * S)) / S;
  const int tx = tid % S;
  const long long e0 = static_cast<long long>(blockIdx.x) * MPB;
  const int n_here = static_cast<int>(E - e0 < MPB ? E - e0 : MPB);
  const bool live = m < n_here;
  const int dd = d * d;
  const size_t g0 = static_cast<size_t>(e0) * static_cast<size_t>(dd);
  // slots: [parity][step of the round][column | row][S][RP]
  float* piv = smem + m * (2 * 2 * 2 * S * RP);
  auto slot = [&](int par, int k, int kind) {
    return piv + ((par * 2 + k) * 2 + kind) * S * RP;
  };

  // -- load: the block's span of A into shared memory, then registers ----
  float M[R][R];
  {
    const float* src = A + g0;
    float* st = stage + misalign(src);
    copy_span(st, src, n_here * dd, misalign(src), tid, kThreads);
    __syncthreads();
    st += m * dd;
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int b = 0; b < R; ++b) {
        const int i = ty + S * a, c = tx + S * b;
        M[a][b] = (live && i < d && c < d) ? st[i * d + c] : 0.f;
      }
  }

  // -- d steps in rounds of two. Step j = t0 + S b is held by register
  // column / row b of its owners; t0 is even and S is even, so both steps
  // of a round have the same b. Each round publishes the next round's two
  // pivot rows and columns into the other parity's slots before the bulk
  // of its second update, so one barrier a round separates a round's
  // writes from its reads.
  publish<S, R>(M, slot(0, 0, 0), slot(0, 0, 1), ty, tx, 0, 0);
  if (d > 1) publish<S, R>(M, slot(0, 1, 0), slot(0, 1, 1), ty, tx, 1, 0);
#pragma unroll
  for (int b = 0; b < R; ++b) {
    for (int t0 = 0; t0 < S; t0 += 2) {
      const int j = t0 + S * b;
      if (j >= d) break;  // the same for every thread of the block
      const int par = (j >> 1) & 1;
      const float* c0 = slot(par, 0, 0);
      const float* r0 = slot(par, 0, 1);
      const float* c1 = slot(par, 1, 0);
      const float* r1 = slot(par, 1, 1);
      const bool has2 = j + 1 < d;
      __syncthreads();
      // step j
      float u[4 * NV], v[4 * NV];
      load_slot<R>(c0 + ty * RP, u);
      load_slot<R>(r0 + tx * RP, v);
      const float inv_p = __frcp_rn(r0[t0 * RP + b]);
      // step j + 1's pivot: v_{j+1} and u_{j+1} of step j, then M'[j+1][j+1]
      const float vj1 = (r0[(t0 + 1) * RP + b] + 0.0f) * inv_p;
      const float uj1 = c0[(t0 + 1) * RP + b];
      const float inv_p1 =
          __frcp_rn(fmaf(-uj1, vj1, r1[(t0 + 1) * RP + b]));
      if (ty == t0) u[b] -= 1.0f;
#pragma unroll
      for (int c = 0; c < R; ++c)
        v[c] = (v[c] + ((c == b && tx == t0) ? 1.0f : 0.0f)) * inv_p;
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int c = 0; c < R; ++c) M[a][c] = fmaf(-u[a], v[c], M[a][c]);
      if (!has2) break;  // j was the last step
      // step j + 1, from column and row j + 1 after step j
      float w[4 * NV];
      load_slot<R>(c1 + ty * RP, w);
#pragma unroll
      for (int a = 0; a < R; ++a) u[a] = fmaf(-u[a], vj1, w[a]);
      if (ty == t0 + 1) u[b] -= 1.0f;
      load_slot<R>(r1 + tx * RP, w);
#pragma unroll
      for (int c = 0; c < R; ++c)
        v[c] = (fmaf(-uj1, v[c], w[c]) + ((c == b && tx == t0 + 1) ? 1.0f : 0.0f)) *
               inv_p1;
      const int npar = par ^ 1;
      const bool has_next = j + 2 < d, has_next2 = j + 3 < d;
      if (t0 + 2 < S)
        update<S, R>(M, u, v, b, has_next, has_next2, slot(npar, 0, 0),
                     slot(npar, 0, 1), slot(npar, 1, 0), slot(npar, 1, 1), ty,
                     tx, t0 + 2);
      else  // the next round is register column b + 1's first
        update<S, R>(M, u, v, b + 1 < R ? b + 1 : R - 1, has_next, has_next2,
                     slot(npar, 0, 0), slot(npar, 0, 1), slot(npar, 1, 0),
                     slot(npar, 1, 1), ty, tx, 0);
    }
  }

  // -- store: registers into shared memory, then the span out -----------
  float* dst = out + g0;
  float* st = stage + misalign(dst);
  __syncthreads();  // every thread has read its elements of the load
  if (live) {
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int b = 0; b < R; ++b) {
        const int i = ty + S * a, c = tx + S * b;
        if (i < d && c < d) st[m * dd + i * d + c] = M[a][b];
      }
  }
  __syncthreads();
  copy_span(dst, st, n_here * dd, misalign(dst), tid, kThreads);
}

template <int S, int R, int MPB>
int launch(const float* A, float* out, long long E, int d, int smem,
           cudaStream_t stream) {
  if (S * R < d || smem != gj_smem(S, R, MPB, d))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = gj_inverse_kernel<S, R, MPB>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (E + MPB - 1) / MPB;
  kernel<<<static_cast<unsigned int>(blocks), S * S * MPB, smem, stream>>>(
      A, out, E, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A and out: E row-major (d, d) f32 matrices, contiguous; out may be A. The
// launch plan (ops/cuda_spd.py::gj_plan): side S of a matrix's thread
// square, R x R elements a thread, per_block matrices a block and
// smem_bytes of dynamic shared memory, which must be what this file
// computes for the plan. Runs on `stream`, allocates nothing, and returns
// cudaGetLastError() after the launch; a shape or plan it does not take
// (E outside [1, 2^31 - 1], d outside [1, 128]) returns
// cudaErrorInvalidValue without launching.
extern "C" int mf_gj_inverse(const void* A, void* out, long long E, int d,
                             int side, int regs, int per_block,
                             int smem_bytes, void* stream) {
  if (E <= 0 || E > 2147483647LL || d <= 0 || d > kMaxD || smem_bytes <= 0 ||
      smem_bytes > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* a = static_cast<const float*>(A);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int key = side * 10000 + regs * 100 + per_block;
  switch (key) {
    case 80104: return launch<8, 1, 4>(a, o, E, d, smem_bytes, s);
    case 80204: return launch<8, 2, 4>(a, o, E, d, smem_bytes, s);
    case 80404: return launch<8, 4, 4>(a, o, E, d, smem_bytes, s);
    case 80804: return launch<8, 8, 4>(a, o, E, d, smem_bytes, s);
    case 160501: return launch<16, 5, 1>(a, o, E, d, smem_bytes, s);
    case 160601: return launch<16, 6, 1>(a, o, E, d, smem_bytes, s);
    case 160701: return launch<16, 7, 1>(a, o, E, d, smem_bytes, s);
    case 160801: return launch<16, 8, 1>(a, o, E, d, smem_bytes, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* mf_spd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
