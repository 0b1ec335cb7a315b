// ALS normal equations of a batch of entities, each entity's rating rows
// gathered straight from the other side's table: the ridged grams
// A = X^T X + ridge I (both triangles) and the right-hand sides b = X^T y,
// in exact f32 on the FFMA units of Hopper.
//
// Replaces no TPU kernel: the JAX package (ops/ials.py::_jit_bucket_sweep)
// and the port's plain version (ops/ials.py::plain_normal_equations)
// gather an (E, L, d) design block, multiply the mask into it, and form the
// grams and the right-hand sides with batched products over the padded
// slots. At MovieLens-25M's shape (d = 201, power-of-two buckets) that
// writes, rewrites and reads ~58 GB of design an epoch and spends ~30% of
// the products on padding. Here the block never exists.
//
// What bounds it: operations. A rating row adds the upper triangle of
// z z^T, z = [x | y] the d design values and the target, (d + 1)(d + 2)/2
// FMAs (20,503 at d = 201) against the ~808 bytes of the row, most of
// them L2 hits; a short list is bound by the write of its d x d gram.
//
// Layout. A staged row holds the k factors of the other side's row
// (columns [0, kc), kc = k rounded up to 4, copied by cp.async), the
// constant column at kc and the target at kc + 1: an augmented row of
// D = kc + 2 positions, cut into 8 x 8 microtiles, t = ceil(D / 8) a side.
// Each thread of a block holds one upper-triangle microtile of z z^T's
// sum in 64 registers (positions k .. kc - 1, where k % 4 != 0, are read
// and never written out). The microtiles are ordered in bands of 4
// microtile rows, each band column by column (the head triangle first),
// so that a warp reads ~4 distinct row offsets and ~8 distinct column
// offsets of a staged row (tile_of). Above kMaxThreads microtiles (k past
// 212) an entity takes several blocks (groups).
//
// A block takes one entity's slots [s * kSlice, (s + 1) * kSlice). It
// reads their masks, ids and ratings once, with the bias and constant of
// each live slot's row, forms the target (r - mu - b_other) * m and the
// constant * m, and compacts the live slots (mask != 0; input order kept:
// a masked slot contributes nothing and costs nothing). It then streams
// their rows by cp.async into a ring of kStages stages of `rows` rows,
// each stage's constant and target written beside the copy, one barrier a
// stage (a mask other than 0 and 1 scales the factors first), and adds
// each row's products to the registers, the next row's operands loaded
// while this row's run: one f32 FMA chain a gram entry, in slot order.
// Lists up to kSlice slots take one block (slices == 1), which writes A
// and b; longer lists are cut into slices of kSlice slots, each block
// writes its partial sums, and normal_eq_finish_kernel adds an entity's
// partials in slice order and writes A and b the same way. Both orders
// are fixed: the result is the same bits in every run, and no float
// atomics are used. A sum runs over at most kSlice rows, then over the
// slices: no longer a chain than the batched product's K loop (at one
// slice the same chain: A is the batched product's bits).
//
// The write (write_gram). A row of A is d floats, not 16-byte aligned at
// d = 201, so one block an entity stages `band` rows of A at a time (each
// entry and its mirror) in the shared region the ring used, at an odd row
// stride with a pad word after every 8 columns, so that a warp's
// scattered entries fall in distinct banks, then writes each row out
// whole and coalesced. With several blocks an entity each block writes
// its own entries straight to A.
//
// gram_dtype 'bf16' rounds each design value to bf16 (nearest even) as
// it is multiplied into the gram; the right-hand side multiplies the
// unrounded values, as ops/ials.py::_gram and the JAX package do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMT = 8;          // microtile side
constexpr int kBand = 4;        // microtile rows a band of the order holds
constexpr int kStages = 3;      // staged row chunks (cp.async groups)
constexpr int kSlice = 1024;    // slots a block takes at most
constexpr int kMaxThreads = 384;  // one block an SM: 64 sums a thread
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use

struct Args {
  const float* other;  // (n, ldo) the other side's table
  long long ldo;
  const int* ids;         // (E, L) other-side rows of the slots
  const float* ratings;   // (E, L)
  const float* mask;      // (E, L)
  const float* mu;        // the global mean, on the device
  const float* ridge;     // (E,) the ridge of each entity, or null: reg for all
  float* A;               // (E, d, d)
  float* b;               // (E, d)
  float* partial;         // (E * slices, 16, M) float4s when slices > 1
  float reg;
  int L, k, kc, o_bias, o_const;
  int t, M, groups, per_group, rows, width, band, stride, work, slices;
};

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

// Round to the nearest bf16, ties to even (torch's float -> bfloat16 for
// every finite value), kept as f32.
template <bool kBf16>
__device__ __forceinline__ float to_gram(float x) {
  if (!kBf16) return x;
  uint32_t u = __float_as_uint(x);
  u += 0x7FFFu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xFFFF0000u);
}

// Microtile p of the order (tests/test_torch_normal_eq.py holds a model
// of it to these statements): bands of kBand microtile rows; in a band
// first the head triangle (column c holds rows r0 .. r0 + c), then the
// columns right of it, each with the band's h rows.
__device__ __forceinline__ void tile_of(int p, int t, int& ti, int& tj) {
  int r0 = 0;
  for (;;) {
    const int h = min(kBand, t - r0);
    const int cnt = h * (h + 1) / 2 + (t - r0 - h) * h;
    if (p < cnt) break;
    p -= cnt;
    r0 += kBand;
  }
  const int h = min(kBand, t - r0);
  const int head = h * (h + 1) / 2;
  if (p < head) {
    int c = 0;
    while ((c + 1) * (c + 2) / 2 <= p) ++c;
    ti = r0 + p - c * (c + 1) / 2;
    tj = r0 + c;
  } else {
    p -= head;
    tj = r0 + h + p / h;
    ti = r0 + p % h;
  }
}

// The column of A (or d: b) that position p of an augmented row holds;
// -1 for the positions between the factors and the constant.
__device__ __forceinline__ int column_of(int p, int k, int kc) {
  return p < k ? p : p == kc ? k : p == kc + 1 ? k + 1 : -1;
}

// Entry (i, j) of A (columns of A, or -1) and its mirror, the ridge on the
// diagonal; an entry outside A is dropped. A diagonal microtile writes
// each of its entries once (its entries below the diagonal are the same
// FMA chains as those above).
__device__ __forceinline__ void store_entry(float* Ae, int d, bool diag, int i, int j, float v,
                                            float ridge) {
  if (i < 0 || i >= d || j < 0 || j >= d) return;
  Ae[static_cast<size_t>(i) * d + j] = (i == j) ? v + ridge : v;
  if (!diag) Ae[static_cast<size_t>(j) * d + i] = v;
}

// The sums `acc` of microtile (ti, tj) of entity e into A and b. One block
// an entity (groups == 1) stages `band` rows of A at a time in shared
// memory (row stride `stride`, odd, a pad word after every 8 columns, so
// that a warp's scattered entries fall in distinct banks) and writes each
// row out whole and coalesced; where an entity's microtiles span several
// blocks, each writes its own entries. Every thread of the block calls it.
__device__ __forceinline__ void write_gram(const float (&acc)[kMT][kMT], float* work,
                                           const Args& a, long long e, int ti, int tj,
                                           bool mine, bool owner, float ridge) {
  const int k = a.k, kc = a.kc, d = k + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  // the columns of A that the microtile's rows and columns hold
  int ci[kMT], cj[kMT];
#pragma unroll
  for (int m = 0; m < kMT; ++m) {
    ci[m] = column_of(ti * kMT + m, k, kc);
    cj[m] = column_of(tj * kMT + m, k, kc);
  }
  if (owner) {
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int q = 0; q < kMT; ++q)
        if (ci[m] >= 0 && ci[m] < d && cj[q] == d)
          a.b[static_cast<size_t>(e) * d + ci[m]] = acc[m][q];
  }
  float* Ae = a.A + static_cast<size_t>(e) * d * d;
  const bool diag = ti == tj;
  if (a.groups > 1) {
    if (mine) {
#pragma unroll
      for (int m = 0; m < kMT; ++m)
#pragma unroll
        for (int q = 0; q < kMT; ++q) store_entry(Ae, d, diag, ci[m], cj[q], acc[m][q], ridge);
    }
    return;
  }
  // An offset below 0 marks an entry that is not in the band or not A's.
  constexpr int kOff = -(1 << 30);
  __syncthreads();  // every thread is done with the shared region
  for (int r0 = 0; r0 < d; r0 += a.band) {
    const int r1 = min(d, r0 + a.band);
    if (mine) {
      int row_i[kMT], col_i[kMT], row_j[kMT], col_j[kMT];
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        const int i = ci[m], j = cj[m];
        const bool ai = i >= 0 && i < d, aj = j >= 0 && j < d;
        row_i[m] = ai && i >= r0 && i < r1 ? (i - r0) * a.stride : kOff;
        col_i[m] = ai ? i + (i >> 3) : kOff;
        row_j[m] = aj && !diag && j >= r0 && j < r1 ? (j - r0) * a.stride : kOff;
        col_j[m] = aj ? j + (j >> 3) : kOff;
      }
#pragma unroll
      for (int m = 0; m < kMT; ++m)
#pragma unroll
        for (int q = 0; q < kMT; ++q) {
          const float v = acc[m][q];
          const int at = row_i[m] + col_j[q], mirror = row_j[q] + col_i[m];
          if (at >= 0) work[at] = (m == q && diag) ? v + ridge : v;
          if (mirror >= 0) work[mirror] = v;
        }
    }
    __syncthreads();
    for (int r = r0 + warp; r < r1; r += nwarps) {
      const float* src = work + (r - r0) * a.stride + lane + (lane >> 3);
      float* dst = Ae + static_cast<size_t>(r) * d + lane;
#pragma unroll 4
      for (int c = lane; c < d; c += 32, src += 36, dst += 32) *dst = *src;
    }
    __syncthreads();
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kMaxThreads, 1) normal_eq_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int W = a.width, R = a.rows, k = a.k, kc = a.kc;
  float* work = smem;  // the ring, the uncompacted slots, then A's bands
  int* s_oid = reinterpret_cast<int*>(work + a.work);
  float* s_c = reinterpret_cast<float*>(s_oid + kSlice);
  float* s_y = s_c + kSlice;
  float* s_m = s_y + kSlice;
  int* s_cnt = reinterpret_cast<int*>(s_m + kSlice);  // 32 group offsets, the count, a flag

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long e = blockIdx.x / a.slices;
  const int s = static_cast<int>(blockIdx.x % a.slices);
  const int s0 = s * kSlice, len = min(kSlice, a.L - s0);
  const size_t slot0 = static_cast<size_t>(e) * a.L + s0;
  const int ng = (len + 31) >> 5;
  const float mu = *a.mu;
  const float ridge = a.ridge ? a.ridge[e] : a.reg;  // read early: used at the end

  // 1. read the slice's slots once; the live ones (mask != 0) in slot order
  int* u_oid = reinterpret_cast<int*>(work);
  float* u_c = work + kSlice;
  float* u_y = work + 2 * kSlice;
  float* u_m = work + 3 * kSlice;
  if (tid == 0) s_cnt[33] = 0;
  __syncthreads();
  for (int g = warp; g < ng; g += nwarps) {
    const int j = g * 32 + lane;
    const float m = j < len ? a.mask[slot0 + j] : 0.0f;
    const bool live = m != 0.0f;
    if (j < len) u_m[j] = m;
    if (live) {
      const int id = a.ids[slot0 + j];
      const float* row = a.other + static_cast<size_t>(id) * a.ldo;
      u_oid[j] = id;
      u_c[j] = row[a.o_const] * m;
      u_y[j] = ((a.ratings[slot0 + j] - mu) - row[a.o_bias]) * m;
      if (m != 1.0f) s_cnt[33] = 1;  // the factors need scaling
    }
    const unsigned bal = __ballot_sync(0xffffffffu, live);
    if (lane == 0) s_cnt[g] = __popc(bal);
  }
  __syncthreads();
  if (warp == 0) {
    const int c = lane < ng ? s_cnt[lane] : 0;
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane < ng) s_cnt[lane] = incl - c;
    if (lane == 31) s_cnt[32] = incl;
  }
  __syncthreads();
  for (int g = warp; g < ng; g += nwarps) {
    const int j = g * 32 + lane;
    const bool live = j < len && u_m[j] != 0.0f;
    const unsigned bal = __ballot_sync(0xffffffffu, live);
    if (live) {
      const int pos = s_cnt[g] + __popc(bal & ((1u << lane) - 1u));
      s_oid[pos] = u_oid[j];
      s_c[pos] = u_c[j];
      s_y[pos] = u_y[j];
      s_m[pos] = u_m[j];
    }
  }
  __syncthreads();  // the slots are compacted: the ring is free
  const int n = s_cnt[32];
  const bool scale = s_cnt[33] != 0;

  // 2. this thread's microtile
  const int p = blockIdx.y * a.per_group + tid;
  const bool mine = tid < a.per_group && p < a.M;
  int ti = 0, tj = 0;
  if (mine) tile_of(p, a.t, ti, tj);
  const bool owner = mine && tj == a.t - 1;  // its columns hold the target's

  // 3. stream the live rows through the ring and add their products
  const int pieces = kc >> 2;  // 16-byte pieces of the factors
  const int n_chunks = (n + R - 1) / R;
  auto issue = [&](int c) {
    float* st = work + (c % kStages) * R * W;
    const int r0 = c * R, nr = min(R, n - r0), total = nr * pieces;
    for (int q = tid; q < total; q += blockDim.x) {
      const int rr = q / pieces, cc = q - rr * pieces;
      cp_async16(smem_u32(st + rr * W + cc * 4),
                 a.other + static_cast<size_t>(s_oid[r0 + rr]) * a.ldo + cc * 4);
    }
    for (int rr = tid; rr < nr; rr += blockDim.x) {
      st[rr * W + kc] = s_c[r0 + rr];
      st[rr * W + kc + 1] = s_y[r0 + rr];
    }
  };

  float acc[kMT][kMT];
  float accy[kMT];  // bf16 only: the right-hand side from unrounded values
#pragma unroll
  for (int m = 0; m < kMT; ++m) {
    accy[m] = 0.0f;
#pragma unroll
    for (int q = 0; q < kMT; ++q) acc[m][q] = 0.0f;
  }

#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < n_chunks) issue(c);
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk c has landed; chunk c - 1's stage is free
    float* st = work + (c % kStages) * R * W;
    const int r0 = c * R, nr = min(R, n - r0);
    if (scale) {  // a mask other than 0 and 1: the factors times the mask
      for (int rr = warp; rr < nr; rr += nwarps) {
        const float m = s_m[r0 + rr];
        for (int j = lane; j < k; j += 32) st[rr * W + j] *= m;
      }
      __syncthreads();
    }
    if (c + kStages - 1 < n_chunks) issue(c + kStages - 1);
    cp_async_commit();
    const float* pa = st + ti * kMT;
    const float* pb = st + tj * kMT;
    const float* py = st + kc + 1;
    float4 a0 = *reinterpret_cast<const float4*>(pa);
    float4 a1 = *reinterpret_cast<const float4*>(pa + 4);
    float4 b0 = *reinterpret_cast<const float4*>(pb);
    float4 b1 = *reinterpret_cast<const float4*>(pb + 4);
#pragma unroll 2
    for (int rr = 0; rr < nr; ++rr) {
      const float av[kMT] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[kMT] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      // the next row's operands while this row's products run (a read past
      // the chunk stays in shared memory and is never used)
      pa += W;
      pb += W;
      a0 = *reinterpret_cast<const float4*>(pa);
      a1 = *reinterpret_cast<const float4*>(pa + 4);
      b0 = *reinterpret_cast<const float4*>(pb);
      b1 = *reinterpret_cast<const float4*>(pb + 4);
      float ar[kMT], br[kMT];
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        ar[m] = to_gram<kBf16>(av[m]);
        br[m] = to_gram<kBf16>(bv[m]);
      }
#pragma unroll
      for (int m = 0; m < kMT; ++m)
#pragma unroll
        for (int q = 0; q < kMT; ++q) acc[m][q] = fmaf(ar[m], br[q], acc[m][q]);
      if (kBf16 && owner) {
        const float yv = *py;
#pragma unroll
        for (int m = 0; m < kMT; ++m) accy[m] = fmaf(av[m], yv, accy[m]);
      }
      py += W;
    }
  }
  cp_async_wait<0>();

  // 4. write: the slice's partial, or A and b
  if (kBf16 && owner) {
    const int ny = kc + 1 - tj * kMT;
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int q = 0; q < kMT; ++q)
        if (q == ny) acc[m][q] = accy[m];
  }
  if (a.slices > 1) {
    // quad qd of every microtile together: a warp writes 512 contiguous bytes
    if (!mine) return;
    float4* dst = reinterpret_cast<float4*>(a.partial) + static_cast<size_t>(blockIdx.x) * a.M * 16;
#pragma unroll
    for (int m = 0; m < kMT; ++m) {
      dst[(2 * m) * a.M + p] = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
      dst[(2 * m + 1) * a.M + p] = make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
    }
    return;
  }
  write_gram(acc, work, a, e, ti, tj, mine, owner, ridge);
}

// The slices' partial grams of entity blockIdx.x added in slice order,
// each thread its microtile's 64 sums (as the slices' blocks held them),
// then written as the one-slice path writes them.
__global__ void __launch_bounds__(kMaxThreads, 1) normal_eq_finish_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const long long e = blockIdx.x;
  const float ridge = a.ridge ? a.ridge[e] : a.reg;
  const int tid = threadIdx.x;
  const int p = blockIdx.y * a.per_group + tid;
  const bool mine = tid < a.per_group && p < a.M;
  int ti = 0, tj = 0;
  if (mine) tile_of(p, a.t, ti, tj);
  const bool owner = mine && tj == a.t - 1;
  float acc[kMT][kMT];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int q = 0; q < kMT; ++q) acc[m][q] = 0.0f;
  if (mine) {
    const float4* src = reinterpret_cast<const float4*>(a.partial) +
                        static_cast<size_t>(e) * a.slices * a.M * 16 + p;
    for (int s = 0; s < a.slices; ++s, src += static_cast<size_t>(a.M) * 16) {
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        const float4 lo = src[(2 * m) * a.M], hi = src[(2 * m + 1) * a.M];
        acc[m][0] += lo.x;
        acc[m][1] += lo.y;
        acc[m][2] += lo.z;
        acc[m][3] += lo.w;
        acc[m][4] += hi.x;
        acc[m][5] += hi.y;
        acc[m][6] += hi.z;
        acc[m][7] += hi.w;
      }
    }
  }
  write_gram(acc, smem, a, e, ti, tj, mine, owner, ridge);
}


// Floats of the shared region that holds the ring, then the uncompacted
// slots, then A's bands.
int work_floats(int rows, int width, int band, int stride) {
  const int ring = kStages * rows * width, bands = band * stride;
  const int w = ring > 4 * kSlice ? ring : 4 * kSlice;
  return w > bands ? w : bands;
}

int smem_bytes(int work) { return (work + 4 * kSlice + 34) * 4; }

template <bool kBf16>
cudaError_t launch(const Args& a, long long E, int groups, int threads, int smem,
                   cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(normal_eq_kernel<kBf16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  normal_eq_kernel<kBf16><<<dim3(static_cast<unsigned>(E * a.slices), groups), threads, smem,
                            s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.slices == 1) return err;
  err = cudaFuncSetAttribute(normal_eq_finish_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  normal_eq_finish_kernel<<<dim3(static_cast<unsigned>(E), groups), threads, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// A (E, d, d) and b (E, d), d = k + 1, of E entities' (E, L) slots
// against the table `other` (rows of ldo floats, 16-byte aligned, at least
// k + 2 columns rounded up to 4), by the launch plan of
// ops/cuda_normal_eq.py::normal_eq_plan (groups, per_group, threads,
// rows, width, band, stride, slices, smem), which this checks against what
// the kernel computes. `partial` holds E * slices * M * 64 floats when
// slices > 1.
extern "C" int mf_normal_eq(const void* other, long long ldo, const void* ids,
                            const void* ratings, const void* mask, long long E, int L,
                            const void* mu, int k, int o_bias, int o_const, float reg,
                            const void* ridge, int bf16, int groups, int per_group,
                            int threads, int rows, int width, int band, int stride,
                            int slices, int smem, void* A, void* b, void* partial,
                            void* stream) {
  const int d = k + 1, kc = (k + 3) / 4 * 4, t = (kc + 2 + kMT - 1) / kMT;
  const int M = t * (t + 1) / 2;
  const int want_slices = L <= kSlice ? 1 : (L + kSlice - 1) / kSlice;
  const int want_stride = (d + (d - 1) / 8) | 1;
  const bool plan_ok =
      k >= 1 && L >= 0 && E >= 0 && width == t * kMT && slices == want_slices &&
      ldo >= (k + 5) / 4 * 4 && ldo % 4 == 0 && (o_bias == k || o_bias == k + 1) &&
      (o_const == k || o_const == k + 1) && o_bias != o_const && per_group >= 1 &&
      groups == (M + per_group - 1) / per_group && threads % 32 == 0 &&
      threads >= per_group && threads <= kMaxThreads && rows >= 1 && band >= 1 &&
      stride == want_stride && smem == smem_bytes(work_floats(rows, width, band, stride)) &&
      smem <= kMaxSmem && E * slices <= 2147483647LL && groups <= 65535 &&
      (slices == 1 || partial != nullptr);
  if (!plan_ok) return static_cast<int>(cudaErrorInvalidValue);
  if (E == 0) return 0;
  Args a;
  a.other = static_cast<const float*>(other);
  a.ldo = ldo;
  a.ids = static_cast<const int*>(ids);
  a.ratings = static_cast<const float*>(ratings);
  a.mask = static_cast<const float*>(mask);
  a.mu = static_cast<const float*>(mu);
  a.ridge = static_cast<const float*>(ridge);
  a.A = static_cast<float*>(A);
  a.b = static_cast<float*>(b);
  a.partial = static_cast<float*>(partial);
  a.reg = reg;
  a.L = L;
  a.k = k;
  a.kc = kc;
  a.o_bias = o_bias;
  a.o_const = o_const;
  a.t = t;
  a.M = M;
  a.groups = groups;
  a.per_group = per_group;
  a.rows = rows;
  a.width = width;
  a.band = band;
  a.stride = stride;
  a.work = work_floats(rows, width, band, stride);
  a.slices = slices;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = bf16 ? launch<true>(a, E, groups, threads, smem, s)
                               : launch<false>(a, E, groups, threads, smem, s);
  return static_cast<int>(err);
}

extern "C" const char* mf_normal_eq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
