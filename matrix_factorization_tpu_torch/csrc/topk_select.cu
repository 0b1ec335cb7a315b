// Exact top-k selection under the port's tie rule, for Hopper (sm_90a).
//
// Replaces no TPU kernel: on the TPU the top-k is `lax.top_k`, whose order
// among ties is the rule's. The port's rule (ops/scoring.py::stable_topk)
// orders (rows, n) f32 scores by score descending, then by position
// ascending; -0.0 counts as 0.0 and a NaN ranks first. `torch.topk` leaves
// the order among ties unstated, so the torch body (`_plain_select_topk`)
// reads each block again to find rows tied across the cut and syncs the
// host once a block to take them again. This pair of kernels needs neither.
//
// The key. A score f at position p forms one 64-bit key, in registers:
//   high word: the order-preserving integer of f (-0.0 as 0.0, every NaN
//              above +inf),
//   low word : 0xffffffff - p (the lower position ranks higher).
// Keys are unique within a row, so the k largest keys are exactly the
// rule's answer, whatever the row ties: no tie test, no second pass.
//
// What bounds it on an H100 SXM: memory. A block of 60 x 2,231,142 scores
// (ops/scoring.py's largest caller, retrieval/search.py::dense_topk) is
// 535 MB, read once: 0.16 ms at 3.35 TB/s. The comparisons are one per
// score; the candidates and the answers are a few KB a row.
//
// The design.
//   * topk_chunk_kernel: a grid of rows x chunks blocks of 256 threads
//     (ops/cuda_topk.py::select_plan picks the chunks from rows and n so
//     that the blocks fill the SMs' resident slots in one wave: a block
//     past them would run alone in a second). A block streams its chunk once
//     in rounds of 2,048 scores, two 16-byte loads a thread, with the loads
//     of the next round in flight while it works on one (`ld.global.cs`:
//     the scores are read once). It keeps a pool of up to
//     kCap keys in shared memory and a floor, the k-th largest key it has
//     kept (0 before it has k; every key of a score is above 0), and the
//     least score whose key could pass the floor. A score is compared with
//     that float first; only one that passes forms its key, and a key
//     above the floor is appended to the pool by one shared atomic a warp.
//     Almost every score after the first few thousand costs one float
//     compare. When one more round could overflow the pool,
//     the block finds the pool's k-th largest key by a radix select (8 bits
//     a pass from the top, a 256-bin shared histogram, until one key is
//     left in the chosen bin), keeps the k keys at or above it and raises
//     the floor to it: a few passes over the pool, where a sort of it
//     would be 78 barrier stages. At the end it writes its k largest keys
//     to the candidate buffer (0 past a short chunk).
//   * topk_merge_kernel: one block a row streams the chunks' candidates
//     through the same pool, then sorts the k survivors (bitonic, in
//     shared memory) and writes their positions and scores, in order. With
//     one chunk a row the chunk kernel does this itself and the merge is
//     not launched.
//   The answers' scores are read back from the scores at their positions,
//   so that they are the bits the torch body returns (-0.0 and NaN
//   payloads included). No float atomics; the kernels allocate nothing
//   (the wrapper gives the candidate buffer) and never sync the host.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

typedef unsigned long long Key;

constexpr int kThreads = 256;
constexpr int kDepth = 1;                         // rounds of loads in flight
constexpr int kVec = 2;                           // float4 loads a thread a round
constexpr int kRoundVecs = kThreads * kVec;       // float4s a block a round
constexpr int kPerRound = kRoundVecs * 4;         // scores a block a round
constexpr int kMergeVec = kPerRound / kThreads;   // candidate keys a thread a round
constexpr int kCap = 4096;                        // the pool's keys (32 KB)
constexpr int kMaxK = 1024;                       // the largest k
constexpr int kBins = 256;                        // radix-select digits
static_assert(kMaxK + kPerRound <= kCap, "a round could overflow the pool");
static_assert(kBins == kThreads, "one histogram bin a thread");

struct Pool {
  Key key[kCap];
  Key kept[kMaxK];  // a compaction's survivors, on their way to key[0, k)
  Key floor;
  float thr;        // every score whose key can pass the floor is >= thr or NaN
  Key kth;
  int count;
  int n_kept;
  int hist[kBins];
  int digit, want, left;
};

__device__ __forceinline__ uint32_t order_bits(float f) {
  const uint32_t b = __float_as_uint(f);
  if ((b & 0x7fffffffu) > 0x7f800000u) return 0xffffffffu;  // NaN first
  if (b == 0x80000000u) return 0x80000000u;                 // -0.0 as 0.0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ Key make_key(float f, long long pos) {
  return (static_cast<Key>(order_bits(f)) << 32) |
         (0xffffffffu - static_cast<uint32_t>(pos));
}

// The least f32 score whose key can exceed a key of high word `hi`: a key
// above the floor has an order-preserving integer of at least the floor's,
// so its score is not below this one (or is a NaN). A NaN threshold (the
// floor's score is a NaN) lets every score through; the key decides.
__device__ __forceinline__ float floor_threshold(Key floor) {
  const uint32_t hi = static_cast<uint32_t>(floor >> 32);
  if (hi >= 0x80000000u) return __uint_as_float(hi & 0x7fffffffu);
  if (hi < 0x007fffffu) return __uint_as_float(0xff800000u);  // -inf: every score
  return __uint_as_float(~hi);
}

// Appends the key of each lane that passes to buf at *count; returns, on
// every lane of a warp that appended, *count after its append (0
// otherwise).
__device__ __forceinline__ int append(Key* buf, int* count, bool pass, Key key) {
  const int lane = threadIdx.x & 31;
  const unsigned m = __ballot_sync(0xffffffffu, pass);
  if (m == 0) return 0;
  const int leader = __ffs(m) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(count, __popc(m));
  base = __shfl_sync(0xffffffffu, base, leader);
  if (pass) buf[base + __popc(m & ((1u << lane) - 1u))] = key;
  return base + __popc(m);
}

// One score against the floor's threshold (one float compare); a score
// that passes it forms its key, which is appended if it passes the floor.
// Returns what `append` returns.
__device__ __forceinline__ int consider(Pool& pool, bool ok, float f,
                                        long long pos, float thr) {
  const bool near = ok && !(f < thr);
  if (!__any_sync(0xffffffffu, near)) return 0;
  const Key key = near ? make_key(f, pos) : 0;
  return append(pool.key, &pool.count, near && key > pool.floor, key);
}

// Sorts the pool's first P keys (a power of two) in descending order.
__device__ void sort_desc(Key* a, int P) {
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < P / 2; i += kThreads) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const Key x = a[lo], y = a[hi];
        if ((x < y) == ((lo & size) == 0)) {
          a[lo] = y;
          a[hi] = x;
        }
      }
      __syncthreads();
    }
  }
}

// The k-th largest of the pool's c keys (c > k; keys unique), by radix
// select from the top byte down: each pass counts the keys under the
// prefix chosen so far by their next byte and follows the byte that holds
// the k-th, until that byte holds one key.
__device__ Key kth_largest(Pool& pool, int c, int k) {
  const int lane = threadIdx.x & 31;
  Key prefix = 0, mask = 0;
  int want = k;
  for (int shift = 56;; shift -= 8) {
    pool.hist[threadIdx.x] = 0;
    __syncthreads();
    for (int base = 0; base < c; base += kThreads) {
      const int i = base + threadIdx.x;
      const Key x = i < c ? pool.key[i] : 0;
      if (i < c && (x & mask) == prefix)
        atomicAdd(&pool.hist[static_cast<int>(x >> shift) & 0xff], 1);
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      // lane l holds bins 8l .. 8l+7; above: the keys in the higher lanes
      int h[8], sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += (h[j] = pool.hist[lane * 8 + j]);
      int incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_down_sync(0xffffffffu, incl, off);
        if (lane + off < 32) incl += v;
      }
      // the one lane whose bins hold the k-th: its highest bin that does
      int above = incl - sum, digit = 0, left = 0, before = 0;
#pragma unroll
      for (int j = 7; j >= 0; --j) {
        if (left == 0 && above + h[j] >= want) {
          digit = lane * 8 + j;
          left = h[j];
          before = above;
        }
        above += h[j];
      }
      if (incl - sum < want && want <= incl) {
        pool.digit = digit;
        pool.want = want - before;
        pool.left = left;
      }
    }
    __syncthreads();
    prefix |= static_cast<Key>(pool.digit) << shift;
    mask |= static_cast<Key>(0xff) << shift;
    want = pool.want;
    // the same on every thread; pool.digit, want and left are rewritten
    // only after the next pass's two barriers
    if (pool.left == 1) break;
  }
  for (int i = threadIdx.x; i < c; i += kThreads) {
    const Key x = pool.key[i];
    if ((x & mask) == prefix) pool.kth = x;
  }
  __syncthreads();
  return pool.kth;
}

// Every thread, after a barrier that follows every append: if the pool
// holds more than k keys, keeps its k largest (in no order) at its front
// and raises the floor to the k-th of them.
__device__ void compact(Pool& pool, int k) {
  const int c = pool.count;
  if (c <= k) return;
  const Key kth = kth_largest(pool, c, k);
  if (threadIdx.x == 0) pool.n_kept = 0;
  __syncthreads();
  for (int base = 0; base < c; base += kThreads) {
    const int i = base + threadIdx.x;
    const Key x = i < c ? pool.key[i] : 0;
    append(pool.kept, &pool.n_kept, x >= kth, x);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < k; i += kThreads) pool.key[i] = pool.kept[i];
  if (threadIdx.x == 0) {
    pool.count = k;
    pool.floor = kth;
    pool.thr = floor_threshold(kth);
  }
  __syncthreads();
}

// The pool's keys (at most k) in descending order, 0 after them.
__device__ void sort_pool(Pool& pool) {
  const int c = pool.count;
  int P = 1;
  while (P < c) P <<= 1;
  for (int i = c + threadIdx.x; i < P; i += kThreads) pool.key[i] = 0;
  __syncthreads();
  sort_desc(pool.key, P);
}

__device__ void write_answer(const Pool& pool, long long row, int k,
                             const float* __restrict__ s, long long n,
                             float* __restrict__ vals,
                             long long* __restrict__ idx) {
  for (int j = threadIdx.x; j < k; j += kThreads) {
    const long long pos = 0xffffffffu - static_cast<uint32_t>(pool.key[j]);
    idx[row * k + j] = pos;
    vals[row * k + j] = s[row * n + pos];
  }
}

__device__ __forceinline__ void load_round(float4 (&x)[kVec], const float4* v,
                                           long long nv, long long base) {
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const long long i = base + j * kThreads + threadIdx.x;
    if (i < nv) x[j] = __ldcs(v + i);
  }
}

// FINAL: one chunk a row; the block writes the row's answer.
template <bool FINAL>
__global__ void __launch_bounds__(kThreads)
topk_chunk_kernel(const float* __restrict__ s, long long n, int k, int chunks,
                  long long chunk_len, Key* __restrict__ cand,
                  float* __restrict__ vals, long long* __restrict__ idx) {
  __shared__ Pool pool;
  const long long row = blockIdx.x / chunks;
  const int c = blockIdx.x % chunks;
  const float* p = s + row * n;
  const long long lo = min(n, c * chunk_len);
  const long long hi = min(n, lo + chunk_len);
  // the 16-byte aligned body [a, b); the head [lo, a) and the tail [b, hi)
  // hold at most three scores each
  const long long mis = (reinterpret_cast<uintptr_t>(p + lo) >> 2) & 3;
  const long long a = min(hi, lo + ((4 - mis) & 3));
  const long long b = a + ((hi - a) & ~3LL);
  if (threadIdx.x == 0) {
    pool.count = 0;
    pool.floor = 0;
    pool.thr = __uint_as_float(0xff800000u);  // -inf
  }
  __syncthreads();
  {
    long long pos = -1;
    if (threadIdx.x < a - lo) {
      pos = lo + threadIdx.x;
    } else if (threadIdx.x >= 4 && threadIdx.x - 4 < hi - b) {
      pos = b + threadIdx.x - 4;
    }
    append(pool.key, &pool.count, pos >= 0, pos >= 0 ? make_key(p[pos], pos) : 0);
  }
  __syncthreads();

  const float4* v = reinterpret_cast<const float4*>(p + a);
  const long long nv = (b - a) >> 2;
  // a ring of kDepth + 1 rounds of loads; the loop is unrolled over it, so
  // that every index into the ring is known at compile time
  float4 ring[kDepth + 1][kVec];
#pragma unroll
  for (int d = 0; d < kDepth; ++d) load_round(ring[d], v, nv, d * kRoundVecs);
  for (long long base = 0; base < nv; base += (kDepth + 1) * kRoundVecs) {
#pragma unroll
    for (int u = 0; u <= kDepth; ++u) {
      const long long rb = base + u * kRoundVecs;
      if (rb < nv) {  // the same on every thread
        load_round(ring[(u + kDepth) % (kDepth + 1)], v, nv,
                   rb + kDepth * kRoundVecs);
        const float thr = pool.thr;
        int top = 0;
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const long long i = rb + j * kThreads + threadIdx.x;
          const bool ok = i < nv;
          const long long pos = a + 4 * i;
          const float4 x = ring[u][j];
          top = max(top, consider(pool, ok, x.x, pos, thr));
          top = max(top, consider(pool, ok, x.y, pos + 1, thr));
          top = max(top, consider(pool, ok, x.z, pos + 2, thr));
          top = max(top, consider(pool, ok, x.w, pos + 3, thr));
        }
        // the barrier ends the round's appends; the pool is cut to its k
        // largest keys if the next round could overflow it
        if (__syncthreads_or(top > kCap - kPerRound)) compact(pool, k);
      }
    }
  }
  compact(pool, k);
  if (FINAL) {
    sort_pool(pool);
    write_answer(pool, row, k, s, n, vals, idx);
  } else {
    Key* out = cand + (row * chunks + c) * k;
    for (int j = threadIdx.x; j < k; j += kThreads)
      out[j] = j < pool.count ? pool.key[j] : 0;
  }
}

// One block a row: the k largest of the row's chunks x k candidate keys.
__global__ void __launch_bounds__(kThreads)
topk_merge_kernel(const Key* __restrict__ cand, int m, int k,
                  const float* __restrict__ s, long long n,
                  float* __restrict__ vals, long long* __restrict__ idx) {
  __shared__ Pool pool;
  const long long row = blockIdx.x;
  const Key* keys = cand + row * m;
  if (threadIdx.x == 0) {
    pool.count = 0;
    pool.floor = 0;
    pool.thr = __uint_as_float(0xff800000u);  // -inf
  }
  __syncthreads();
  for (int base = 0; base < m; base += kPerRound) {
    const Key floor = pool.floor;
    int top = 0;
#pragma unroll
    for (int j = 0; j < kMergeVec; ++j) {
      const int i = base + j * kThreads + threadIdx.x;
      const Key key = i < m ? keys[i] : 0;
      top = max(top, append(pool.key, &pool.count, key > floor, key));
    }
    if (__syncthreads_or(top > kCap - kPerRound)) compact(pool, k);
  }
  compact(pool, k);
  sort_pool(pool);
  write_answer(pool, row, k, s, n, vals, idx);
}

}  // namespace

// s: (rows, n) f32 scores, row-major and contiguous; 0 < k <= min(n, 1024);
// the plan (ops/cuda_topk.py::select_plan): chunks a row of chunk_len
// scores (a multiple of 4), every chunk non-empty; cand: rows x chunks x k
// keys of scratch when chunks > 1 (unused otherwise); vals (rows, k) f32 and
// idx (rows, k) int64 receive the answer. Returns cudaGetLastError() after
// each launch (0 on success); an argument or plan it does not take returns
// cudaErrorInvalidValue without launching.
extern "C" int mf_topk_select(const void* s, long long rows, long long n, int k,
                              int chunks, long long chunk_len, void* cand,
                              void* vals, void* idx, void* stream) {
  if (s == nullptr || vals == nullptr || idx == nullptr || rows <= 0 || n <= 0 ||
      n > INT_MAX || k <= 0 || k > kMaxK || k > n || chunks <= 0 ||
      chunk_len <= 0 || chunk_len % 4 || chunks * chunk_len < n ||
      (chunks - 1) * chunk_len >= n || rows * chunks > INT_MAX ||
      static_cast<long long>(chunks) * k > INT_MAX ||
      (chunks > 1 && cand == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(s);
  float* vp = static_cast<float*>(vals);
  long long* ip = static_cast<long long*>(idx);
  const dim3 grid(static_cast<unsigned>(rows * chunks));
  if (chunks == 1) {
    topk_chunk_kernel<true><<<grid, kThreads, 0, st>>>(sp, n, k, 1, chunk_len,
                                                       nullptr, vp, ip);
    return static_cast<int>(cudaGetLastError());
  }
  Key* cp = static_cast<Key*>(cand);
  topk_chunk_kernel<false><<<grid, kThreads, 0, st>>>(sp, n, k, chunks,
                                                      chunk_len, cp, vp, ip);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_merge_kernel<<<static_cast<unsigned>(rows), kThreads, 0, st>>>(
      cp, chunks * k, k, sp, n, vp, ip);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks an SM holds of the chunk kernel (the plan's wave).
extern "C" int mf_topk_blocks_per_sm() {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, topk_chunk_kernel<false>, kThreads, 0) != cudaSuccess)
    return -1;
  return blocks;
}

extern "C" const char* mf_topk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
