// Full-catalog scoring with a fused kernel epilogue, for Hopper (sm_90a).
//
// Replaces the TPU kernel matrix_factorization_tpu/ops/pallas_scores.py
// `_score_kernel` (launched by `pallas_score_catalog`). For B user rows
// and I item rows of the bias-folded layout (ops/segment_sgd.py), width Kp:
//
//   dots[b, i] = sum_k pu[b, k] * q[i, k]
//   linear : out = mu + dots
//   sigmoid: out = a + c * sigmoid(mu + dots)
//   rbf    : out = a + c * exp(-gamma * max(|p|^2 + |q|^2 - 2 dots, 0))
//
// What bounds it on an H100 SXM at the serving shapes of MovieLens-25M
// KernelMF (I = 59,392 items, Kp = 256, f32 tables):
//   * B = 1 (`recommend`): memory. Reading Q is 60.8 MB, about 18 us at
//     3.35 TB/s; the arithmetic (30 MFLOP) is negligible.
//   * B = 256 (`recommend_batch`): operations. 2*B*I*Kp = 7.8 GFLOP on the
//     f32 CUDA cores (67 TFLOP/s) is about 116 us; the bytes (Q plus the
//     60.8 MB score block) take about 36 us.
//
// The sums. Every output is one f32 FMA chain acc = fmaf(p_k, q_k, acc),
// k = 0 .. Kp-1 in order from 0, on both paths and for both table types
// (bf16 is widened to f32 exactly on load), then the one epilogue below;
// the rbf norms are chains of the same kind. No tensor cores, no TF32. So a
// score does not depend on the batch it came in or the path that made it:
// the coalescer's answers equal direct ones to the bit.
//
// Two paths; `ops/cuda_scores.py::score_plan` picks one and its shape
// (B_s = 16, from the measurements in PERF.md). Both stage the tables
// through a ring of shared-memory stages filled by 16-byte `cp.async`
// copies, with one block barrier a stage: the copies of the next stages
// are in flight while this one is computed. A stage row is 128 bytes of k
// (32 f32 or 64 bf16 values) padded to 144 bytes, so that the 16-byte
// reads of eight neighbouring rows fall in eight different bank groups.
//   * Streaming (B <= B_s): memory-bound, so the design keeps bytes in
//     flight. A persistent grid of one 256-thread block per SM; each block
//     takes an even share of the catalog in tiles of 256 items. Its user
//     rows (BS = 1, 4 or 16 of them) are staged once, as f32; the item rows
//     stream through 2-4 stages of 36 KB (up to 108 KB in flight per SM).
//     Each thread owns one item of the tile and runs its BS chains, reading
//     its own row 4 values at a time and the user values as broadcasts.
//   * Tiled (B > B_s): operations-bound. A block computes a 64 x 128 tile
//     of users x items; each thread a 4 x 8 register tile on rows ty + 16 i
//     and columns tx + 16 j. k goes in groups of 4: the thread's 8 item
//     fragments (one 16-byte read each for f32, 8-byte for bf16) widened to
//     f32, then each user row's fragment against them. That keeps a thread
//     at 128 registers, so that two blocks share an SM and one block's
//     barrier waits and epilogue overlap the other's FMAs.
// The edges of B and I are masked (rows past the edge are zero-filled by
// the copies and not stored). Later work: wgmma on bf16 tables, TMA
// staging, and a per-tile top-k so that the (B, I) block is never written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kLinear = 0;
constexpr int kSigmoid = 1;
constexpr int kRbf = 2;

constexpr int kThreads = 256;
constexpr int kRowBytes = 128;               // k bytes of one stage row
constexpr int kRowStride = kRowBytes + 16;   // padded: no bank conflicts
constexpr int kSegs = kRowBytes / 16;        // 16-byte copies per stage row
constexpr int kStreamItems = kThreads;       // items per streaming tile
constexpr int kTileM = 64;                   // users per tiled block
constexpr int kTileN = 128;                  // items per tiled block
constexpr int kMaxStages = 4;
constexpr int kMaxSmem = 232448;             // a block's limit on sm_90

__host__ __device__ constexpr int stream_ring_offset(int bs, int kp) {
  return (bs * kp + (bs + 3) / 4 * 4) * 4;  // user rows, then their norms
}

__host__ __device__ constexpr int stream_smem(int bs, int kp, int stages) {
  return stream_ring_offset(bs, kp) + stages * kStreamItems * kRowStride;
}

__host__ __device__ constexpr int tile_smem(int stages) {
  return stages * (kTileM + kTileN) * kRowStride + (kTileM + kTileN) * 4;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: no read, the 16 bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most stages - 2 groups are pending: the stage about to be
// read has landed while the later ones may still be in flight.
__device__ __forceinline__ void cp_async_wait_ring(int stages) {
  if (stages >= 4)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (stages == 3)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <typename T>
struct Elems {
  static constexpr int kPerVec = 16 / sizeof(T);   // values in 16 bytes
  static constexpr int kChunk = kRowBytes / sizeof(T);  // k in a stage row
  static constexpr int kGroups = kChunk / 4;  // groups of 4 k in a stage row
};

// Four neighbouring k of a staged row, widened to f32 exactly: one 16-byte
// read for f32, one 8-byte read for bf16.
template <typename T>
__device__ __forceinline__ void frag4(const unsigned char* p, float (&f)[4]);

template <>
__device__ __forceinline__ void frag4<float>(const unsigned char* p,
                                             float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}

template <>
__device__ __forceinline__ void frag4<__nv_bfloat16>(const unsigned char* p,
                                                     float (&f)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  f[0] = __uint_as_float(v.x << 16);
  f[1] = __uint_as_float(v.x & 0xffff0000u);
  f[2] = __uint_as_float(v.y << 16);
  f[3] = __uint_as_float(v.y & 0xffff0000u);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int KERNEL>
__device__ __forceinline__ float epilogue(float dots, float mu, float pn,
                                          float qn, float gamma, float a,
                                          float c) {
  if (KERNEL == kLinear) return mu + dots;
  if (KERNEL == kSigmoid) return a + c * (1.f / (1.f + expf(-(mu + dots))));
  const float sq = fmaxf(pn + qn - 2.f * dots, 0.f);
  return a + c * expf(-gamma * sq);
}

// ---------------------------------------------------------------------------
// Streaming path: B <= BS users, one item per thread, persistent grid.
// ---------------------------------------------------------------------------

template <typename T, int KERNEL, int BS>
__global__ void __launch_bounds__(kThreads)
score_stream_kernel(const float* __restrict__ mu_ptr, const T* __restrict__ pu,
                    const T* __restrict__ q, float* __restrict__ out, int B,
                    int I, int Kp, int stages, float gamma, float a, float c) {
  constexpr int V = Elems<T>::kPerVec;
  constexpr int KC = Elems<T>::kChunk;
  constexpr int kStage = kStreamItems * kRowStride;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ps = reinterpret_cast<float*>(smem);  // [BS][Kp]
  float* pnorm = ps + BS * Kp;                 // [BS]
  unsigned char* ring = smem + stream_ring_offset(BS, Kp);

  const int tid = threadIdx.x;
  const int nk = Kp / KC;
  // the block's items: an even share of the catalog, in tiles of 256
  const int first = static_cast<int>(static_cast<long long>(I) * blockIdx.x / gridDim.x);
  const int last =
      static_cast<int>(static_cast<long long>(I) * (blockIdx.x + 1) / gridDim.x);
  const int total = (last - first + kStreamItems - 1) / kStreamItems * nk;

  auto fetch = [&](int f) {
    const int k0 = (f % nk) * KC;
    unsigned char* st = ring + (f % stages) * kStage;
#pragma unroll
    for (int e = tid; e < kStreamItems * kSegs; e += kThreads) {
      const int r = e / kSegs, s = e % kSegs;
      const int item = first + (f / nk) * kStreamItems + r;
      const bool ok = item < last;
      const T* src = ok ? q + static_cast<size_t>(item) * Kp + k0 + s * V : q;
      cp_async16(st + r * kRowStride + 16 * s, src, ok);
    }
  };

  // the first stages' copies go out before the user rows are staged
  for (int f = 0; f < stages - 1; ++f) {
    if (f < total) fetch(f);
    cp_async_commit();
  }
  for (int e = tid; e < BS * Kp; e += kThreads) {
    const int r = e / Kp;
    ps[e] = r < B ? to_f32(pu[static_cast<size_t>(r) * Kp + e % Kp]) : 0.f;
  }
  if (KERNEL == kRbf) {
    __syncthreads();
    if (tid < BS) {
      float n = 0.f;
      for (int k = 0; k < Kp; k += 4) {
        const float4 v = *reinterpret_cast<const float4*>(ps + tid * Kp + k);
        n = fmaf(v.x, v.x, n);
        n = fmaf(v.y, v.y, n);
        n = fmaf(v.z, v.z, n);
        n = fmaf(v.w, v.w, n);
      }
      pnorm[tid] = n;
    }
  }
  const float mu = (KERNEL == kRbf) ? 0.f : *mu_ptr;

  float acc[BS];
  float qn = 0.f;
  for (int f = 0; f < total; ++f) {
    cp_async_wait_ring(stages);
    __syncthreads();  // stage f landed for all; stage f - 1 is free again
    if (f + stages - 1 < total) fetch(f + stages - 1);
    cp_async_commit();
    const int kc = f % nk;
    if (kc == 0) {
#pragma unroll
      for (int b = 0; b < BS; ++b) acc[b] = 0.f;
      qn = 0.f;
    }
    const unsigned char* row = ring + (f % stages) * kStage + tid * kRowStride;
    const float* pk = ps + kc * KC;
#pragma unroll
    for (int g = 0; g < Elems<T>::kGroups; ++g) {
      float x[4];
      frag4<T>(row + g * 4 * sizeof(T), x);
      if (KERNEL == kRbf) {
#pragma unroll
        for (int t = 0; t < 4; ++t) qn = fmaf(x[t], x[t], qn);
      }
      // each user's chain takes these four k in order; the users' chains
      // are independent of one another
#pragma unroll
      for (int b = 0; b < BS; ++b) {
        const float4 p = *reinterpret_cast<const float4*>(pk + b * Kp + 4 * g);
        acc[b] = fmaf(p.x, x[0], acc[b]);
        acc[b] = fmaf(p.y, x[1], acc[b]);
        acc[b] = fmaf(p.z, x[2], acc[b]);
        acc[b] = fmaf(p.w, x[3], acc[b]);
      }
    }
    if (kc == nk - 1) {
      const int item = first + (f / nk) * kStreamItems + tid;
      if (item < last) {
#pragma unroll
        for (int b = 0; b < BS; ++b)
          if (b < B)
            out[static_cast<size_t>(b) * I + item] = epilogue<KERNEL>(
                acc[b], mu, KERNEL == kRbf ? pnorm[b] : 0.f, qn, gamma, a, c);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Tiled path: a 64 x 128 block tile, a 4 x 8 register tile a thread.
// ---------------------------------------------------------------------------

// bf16 rbf needs the registers of one block an SM; the others fit two
template <typename T, int KERNEL>
__host__ __device__ constexpr int tile_min_blocks() {
  return (sizeof(T) == 2 && KERNEL == kRbf) ? 1 : 2;
}

template <typename T, int KERNEL>
__global__ void __launch_bounds__(kThreads, (tile_min_blocks<T, KERNEL>()))
score_tile_kernel(const float* __restrict__ mu_ptr, const T* __restrict__ pu,
                  const T* __restrict__ q, float* __restrict__ out, int B,
                  int I, int Kp, int stages, float gamma, float a, float c) {
  constexpr int V = Elems<T>::kPerVec;
  constexpr int KC = Elems<T>::kChunk;
  constexpr int BM = kTileM;
  constexpr int BN = kTileN;
  constexpr int TM = BM / 16;
  constexpr int TN = BN / 16;
  static_assert(BM + BN <= kThreads, "one norm row per thread");
  constexpr int kStage = (BM + BN) * kRowStride;  // P rows, then Q rows
  extern __shared__ __align__(16) unsigned char smem[];
  float* norms = reinterpret_cast<float*>(smem + stages * kStage);

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int nk = Kp / KC;

  auto fetch = [&](int kc) {
    unsigned char* st = smem + (kc % stages) * kStage;
    const int k0 = kc * KC;
#pragma unroll
    for (int e = tid; e < (BM + BN) * kSegs; e += kThreads) {
      const int r = e / kSegs, s = e % kSegs;
      bool ok;
      const T* src;
      if (r < BM) {
        ok = row0 + r < B;
        src = pu + static_cast<size_t>(row0 + r) * Kp;
      } else {
        ok = col0 + r - BM < I;
        src = q + static_cast<size_t>(col0 + r - BM) * Kp;
      }
      cp_async16(st + r * kRowStride + 16 * s, ok ? src + k0 + s * V : q, ok);
    }
  };

  for (int f = 0; f < stages - 1; ++f) {
    if (f < nk) fetch(f);
    cp_async_commit();
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  float norm = 0.f;  // rbf: the norm of stage row tid (a P row, then Q rows)

  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait_ring(stages);
    __syncthreads();
    if (kc + stages - 1 < nk) fetch(kc + stages - 1);
    cp_async_commit();
    const unsigned char* st = smem + (kc % stages) * kStage;
    if (KERNEL == kRbf && tid < BM + BN) {
#pragma unroll
      for (int g = 0; g < Elems<T>::kGroups; ++g) {
        float x[4];
        frag4<T>(st + tid * kRowStride + g * 4 * sizeof(T), x);
#pragma unroll
        for (int t = 0; t < 4; ++t) norm = fmaf(x[t], x[t], norm);
      }
    }
    // k in groups of 4: the 8 item fragments of a group widened to f32
    // (32 registers), then each user row's fragment against them, so that
    // the block fits twice on an SM
#pragma unroll
    for (int g = 0; g < Elems<T>::kGroups; ++g) {
      float qf[TN][4];
#pragma unroll
      for (int j = 0; j < TN; ++j)
        frag4<T>(st + (BM + tx + 16 * j) * kRowStride + g * 4 * sizeof(T), qf[j]);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        float pf[4];
        frag4<T>(st + (ty + 16 * i) * kRowStride + g * 4 * sizeof(T), pf);
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(pf[t], qf[j][t], acc[i][j]);
      }
    }
  }

  if (KERNEL == kRbf) {
    if (tid < BM + BN) norms[tid] = norm;
    __syncthreads();
  }
  const float mu = (KERNEL == kRbf) ? 0.f : *mu_ptr;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= B) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col >= I) continue;
      out[static_cast<size_t>(r) * I + col] = epilogue<KERNEL>(
          acc[i][j], mu, KERNEL == kRbf ? norms[ty + 16 * i] : 0.f,
          KERNEL == kRbf ? norms[BM + tx + 16 * j] : 0.f, gamma, a, c);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

struct Args {
  const float* mu;
  const void* pu;
  const void* q;
  float* out;
  int B, I, Kp, stages;
  float gamma, a, c;
  dim3 grid;
  int smem;
  cudaStream_t stream;
};

// Raise the kernel's dynamic shared memory limit where the plan needs more
// than 48 KB, then launch it on the plan's grid.
template <typename T, typename Kernel>
int run(Kernel kernel, const Args& g) {
  if (g.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<g.grid, kThreads, g.smem, g.stream>>>(
      g.mu, static_cast<const T*>(g.pu), static_cast<const T*>(g.q), g.out,
      g.B, g.I, g.Kp, g.stages, g.gamma, g.a, g.c);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int KERNEL, int BS>
int launch_stream(const Args& g) {
  if (g.B > BS || g.smem != stream_smem(BS, g.Kp, g.stages) || g.grid.y != 1 ||
      static_cast<int>(g.grid.x) > g.I)
    return static_cast<int>(cudaErrorInvalidValue);
  return run<T>(score_stream_kernel<T, KERNEL, BS>, g);
}

template <typename T, int KERNEL>
int launch_tile(const Args& g) {
  if (g.smem != tile_smem(g.stages) ||
      static_cast<long long>(g.grid.x) * kTileN < g.I ||
      static_cast<long long>(g.grid.y) * kTileM < g.B)
    return static_cast<int>(cudaErrorInvalidValue);
  return run<T>(score_tile_kernel<T, KERNEL>, g);
}

template <typename T, int KERNEL>
int launch_path(int path, int tile, const Args& g) {
  if (path == 0) {
    switch (tile) {
      case 1: return launch_stream<T, KERNEL, 1>(g);
      case 4: return launch_stream<T, KERNEL, 4>(g);
      case 16: return launch_stream<T, KERNEL, 16>(g);
    }
  } else if (path == 1 && tile == kTileM) {
    return launch_tile<T, KERNEL>(g);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_kernel(int kernel, int path, int tile, const Args& g) {
  if (kernel == kLinear) return launch_path<T, kLinear>(path, tile, g);
  if (kernel == kSigmoid) return launch_path<T, kSigmoid>(path, tile, g);
  return launch_path<T, kRbf>(path, tile, g);
}

}  // namespace

// kernel: 0 linear, 1 sigmoid, 2 rbf. dtype: 0 float32, 1 bfloat16.
// mu is a device pointer to one float; pu (B, Kp), q (I, Kp) and
// out (B, I) are row-major, contiguous and 16-byte aligned, Kp a multiple
// of 128. The launch plan (ops/cuda_scores.py::score_plan): path 0
// streams with tile = BS users (1, 4 or 16), path 1 tiles with tile = 64
// users a block; stages (2-4) shared-memory stages; the grid; smem_bytes
// the dynamic shared memory, which must be what this file computes for the
// plan. Returns cudaGetLastError() after the launch (0 on success); an
// argument or plan it does not take returns cudaErrorInvalidValue without
// launching.
extern "C" int mf_score_catalog(const void* mu, const void* pu, const void* q,
                                void* out, int B, int I, int Kp, int kernel,
                                int dtype, float gamma, float a, float c,
                                int path, int tile, int stages, int grid_x,
                                int grid_y, int smem_bytes, void* stream) {
  if (kernel < kLinear || kernel > kRbf || dtype < 0 || dtype > 1 || B <= 0 ||
      I <= 0 || Kp <= 0 || Kp % kRowBytes || stages < 2 ||
      stages > kMaxStages || grid_x <= 0 || grid_y <= 0 || grid_y > 65535 ||
      smem_bytes <= 0 || smem_bytes > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args g{static_cast<const float*>(mu), pu, q, static_cast<float*>(out),
               B, I, Kp, stages, gamma, a, c,
               dim3(static_cast<unsigned>(grid_x), static_cast<unsigned>(grid_y)),
               smem_bytes, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return launch_kernel<float>(kernel, path, tile, g);
  return launch_kernel<__nv_bfloat16>(kernel, path, tile, g);
}

extern "C" const char* mf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
