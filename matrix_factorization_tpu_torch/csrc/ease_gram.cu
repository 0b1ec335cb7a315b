// EASE's item gram G = X^T X, exact, on the int8 tensor cores of Hopper.
//
// Replaces no TPU kernel: the JAX package builds the gram with XLA's f32
// product of dense user slabs (matrix_factorization_tpu/ops/ease.py::
// item_gram), as the port's f32 path does. It was added because at the
// Million Song Dataset's size (571,355 users, 41,144 padded items) that
// product is 1.93e15 f32 operations, about 37 s at the port's exact-f32
// rate, while an interaction matrix of small integers multiplies exactly
// in int8 with int32 sums, on tensor cores at 1,979 TOP/s.
//
// Exactness (ops/ease.py::int8_exact decides): every weight is an integer
// of magnitude <= 127 and no (user, item) pair repeats, so a slab entry is
// an int8; and the largest diagonal sum over any item's plays of w^2 is
// below 2^24, so every partial sum |sum_u x_ui x_uj| (Cauchy-Schwarz) fits
// an int32 and converts to f32 exactly. The result equals the exact-f32
// gram bit for bit.
//
// Three kernels, all named ease_gram_*:
//   ease_gram_slab_kernel   writes one user chunk's pairs into a zeroed
//                           item-major int8 slab Dt (rows: items padded to
//                           a multiple of 128; columns: the chunk's users);
//   ease_gram_tile_kernel   adds Dt Dt^T to the int32 gram, one 128 x 128
//                           output tile a block, upper-triangle tiles only
//                           (the gram is symmetric), the tiles in the order
//                           of the host's list (groups of 8 tile rows, so
//                           that resident blocks share their panels in L2);
//   ease_gram_finish_kernel converts the int32 gram to f32 in place and
//                           mirrors the upper tiles into the lower ones.
//
// What bounds it: operations. A 128 x 128 tile reads 256 bytes of slab a
// user and does 2 x 128 x 128 int8 operations with them, 128 per byte
// from L2; cp.async stages (3 of 128 users each) keep the loads in flight
// while mma.sync m16n8k32 (s8 x s8 + s32) runs on the previous stage; each
// warp holds a 64 x 64 block of int32 sums in registers over the whole
// chunk. The accumulator is read and written once a chunk (16,384 users),
// a small share of the chunk's products. mma.sync is not wgmma: Hopper's
// full int8 rate needs warpgroup products fed by TMA, a later redesign.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;     // output tile rows = columns (kBM = kBN)
constexpr int kBK = 128;       // users (bytes of a slab row) a stage
constexpr int kStages = 3;
constexpr int kThreads = 128;  // 4 warps, 2 x 2, each 64 x 64
constexpr int kStageBytes = 2 * kTile * kBK;  // A and B tiles, 32 KB
constexpr int kSmem = kStages * kStageBytes;  // 96 KB

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

__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of 16-byte chunk c of row r in a (128 x 128 B) stage tile:
// the chunk index XOR the row's low bits, so that the 8 rows one
// ldmatrix phase reads fall in 8 different bank groups.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * kBK + ((c ^ (r & 7)) << 4));
}

__global__ void ease_gram_slab_kernel(const int* __restrict__ lu, const int* __restrict__ ii,
                                      const float* __restrict__ w, long long n_pairs,
                                      int8_t* __restrict__ slab, int ld) {
  const long long p = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (p >= n_pairs) return;
  const float v = w[p];
  if (v != 0.0f)  // weight-0 pads write nothing
    slab[static_cast<size_t>(ii[p]) * ld + lu[p]] = static_cast<int8_t>(__float2int_rn(v));
}

__global__ void __launch_bounds__(kThreads, 2)
    ease_gram_tile_kernel(const int8_t* __restrict__ slab, int ld, int k_tiles,
                          const int2* __restrict__ tiles, int* __restrict__ G, int n) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int2 tile = tiles[blockIdx.x];
  const int bm = tile.x * kTile, bn = tile.y * kTile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 64, wn = (warp & 1) * 64;
  const int8_t* a_src = slab + static_cast<size_t>(bm) * ld;
  const int8_t* b_src = slab + static_cast<size_t>(bn) * ld;
  const uint32_t s_base = smem_u32(smem);

  auto load = [&](int stage, int kt) {
    const uint32_t sa = s_base + stage * kStageBytes, sb = sa + kTile * kBK;
    const size_t k0 = static_cast<size_t>(kt) * kBK;
#pragma unroll
    for (int i = 0; i < (kTile * kBK / 16) / kThreads; ++i) {
      const int q = tid + i * kThreads, r = q >> 3, c = q & 7;
      const size_t off = static_cast<size_t>(r) * ld + k0 + c * 16;
      cp_async16(sa + swz(r, c), a_src + off);
      cp_async16(sb + swz(r, c), b_src + off);
    }
  };

  int acc[4][8][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt has landed; stage kt - 1 is free again
    const int nk = kt + kStages - 1;
    if (nk < k_tiles) load(nk % kStages, nk);
    cp_async_commit();
    const uint32_t sa = s_base + (kt % kStages) * kStageBytes, sb = sa + kTile * kBK;
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm + mi * 16 + (lane & 15);
        const int c = ks * 2 + (lane >> 4);
        ldmatrix_x4(af[mi][0], af[mi][1], af[mi][2], af[mi][3], sa + swz(r, c));
      }
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t b0, b1, b2, b3;
        const int r = wn + nj * 16 + (lane & 7) + ((lane >> 4) << 3);
        const int c = ks * 2 + ((lane >> 3) & 1);
        ldmatrix_x4(b0, b1, b2, b3, sb + swz(r, c));
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          mma_s8(acc[mi][2 * nj], af[mi], b0, b1);
          mma_s8(acc[mi][2 * nj + 1], af[mi], b2, b3);
        }
      }
    }
  }
  cp_async_wait<0>();

  // G[row][col..col+1] += the warp's sums (the m16n8 accumulator layout)
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int col = bn + wn + ni * 8 + t4 * 2;
      if (col >= n) continue;  // n is a multiple of 8: col + 1 < n too
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = bm + wm + mi * 16 + g + h * 8;
        if (row < n) {
          int2* p = reinterpret_cast<int2*>(G + static_cast<size_t>(row) * n + col);
          int2 v = *p;
          v.x += acc[mi][ni][2 * h];
          v.y += acc[mi][ni][2 * h + 1];
          *p = v;
        }
      }
    }
  }
}

// One 32 x 32 tile (a, b) of the gram, a <= b (every such tile lies in a
// computed 128 x 128 tile): converted to f32 in place and, for a < b,
// written transposed into tile (b, a). No block reads a tile that
// another block writes.
__global__ void ease_gram_finish_kernel(int* __restrict__ G, int n) {
  const int a = blockIdx.y, b = blockIdx.x;
  if (a > b) return;
  __shared__ int s[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int r0 = a * 32, c0 = b * 32;
  for (int j = ty; j < 32; j += 8) {
    const int r = r0 + j, c = c0 + tx;
    s[j][tx] = (r < n && c < n) ? G[static_cast<size_t>(r) * n + c] : 0;
  }
  __syncthreads();
  float* F = reinterpret_cast<float*>(G);
  for (int j = ty; j < 32; j += 8) {
    const int r = r0 + j, c = c0 + tx;
    if (r < n && c < n) F[static_cast<size_t>(r) * n + c] = __int2float_rn(s[j][tx]);
  }
  if (a == b) return;
  for (int j = ty; j < 32; j += 8) {
    const int r = c0 + j, c = r0 + tx;
    if (r < n && c < n) F[static_cast<size_t>(r) * n + c] = __int2float_rn(s[tx][j]);
  }
}

}  // namespace

// Zero the (rows, ld) int8 slab and write the chunk's n_pairs pairs into it.
extern "C" int mf_ease_gram_slab(const void* lu, const void* ii, const void* w,
                                 long long n_pairs, void* slab, long long slab_bytes, int ld,
                                 void* stream) {
  if (n_pairs < 0 || slab_bytes <= 0 || ld <= 0 || ld % kBK)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(slab, 0, static_cast<size_t>(slab_bytes), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_pairs == 0) return 0;
  const long long blocks = (n_pairs + 255) / 256;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  ease_gram_slab_kernel<<<static_cast<unsigned>(blocks), 256, 0, s>>>(
      static_cast<const int*>(lu), static_cast<const int*>(ii), static_cast<const float*>(w),
      n_pairs, static_cast<int8_t*>(slab), ld);
  return static_cast<int>(cudaGetLastError());
}

// G (n x n int32) += Dt Dt^T over the listed upper tiles, Dt the slab
// (ceil(n / 128) * 128 rows, ld = 128 k_tiles columns).
extern "C" int mf_ease_gram_tiles(const void* slab, int ld, int k_tiles, const void* tiles,
                                  int n_tiles, void* G, int n, void* stream) {
  if (n <= 0 || n % 8 || k_tiles <= 0 || ld != k_tiles * kBK || n_tiles <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ease_gram_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ease_gram_tile_kernel<<<n_tiles, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(slab), ld, k_tiles, static_cast<const int2*>(tiles),
      static_cast<int*>(G), n);
  return static_cast<int>(cudaGetLastError());
}

// The int32 gram (n x n, upper tiles summed) to the whole f32 gram, in place.
extern "C" int mf_ease_gram_finish(void* G, int n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int t = (n + 31) / 32;
  ease_gram_finish_kernel<<<dim3(t, t), dim3(32, 8), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(G), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mf_ease_gram_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
