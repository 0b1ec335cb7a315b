// Deterministic sorted-segment sum for Hopper (sm_90a):
//
//   out[ids_sorted[j], :] += vals[perm[j], :]   for j in [0, n)
//
// The JAX package has no Pallas kernel for this: its bias, count and
// profile reductions are `jax.ops.segment_sum` and `.at[].add`, which XLA
// lowers to a scatter (matrix_factorization_tpu/ops/als.py:75-84 and
// :133-145, models/content_based.py:73-75 and :111-117). On the GPU the
// library's scatters (`index_add_`, `scatter_add_`, `index_put_` with
// accumulate) add with float atomics in an order that changes from run to
// run, and the same seed must give the same bits, so the port sums here
// instead: one writer a segment, a fixed order, no atomics.
//
// vals (n, d) and out (rows, d) are row-major f32, any d >= 1; perm and
// ids_sorted (n,) int32, ids_sorted ascending (a stable sort of the ids,
// ops/segment_sum.py::sorted_order).
//
// What bounds it on an H100 SXM: bytes. It reads the ids and perm (8 B an
// entry), one row of vals an entry (4 d B) and each touched row of out, and
// writes that row: at MovieLens-1M's 1M ratings and d = 1, about 12 MB, or
// 3.6 us at 3.35 TB/s. It does one add an entry and column.
//
// Design. The stream is cut into chunks of kChunk consecutive entries,
// whatever the ids are, and one warp owns one chunk, so the launch is laid
// out without a look at the data (ops/segment_sum.py::segsum_plan; the
// entry point refuses another plan). Lane l owns column l of a block of 32
// columns. For each group of 32 entries the lanes load the ids and perm
// coalesced, then each lane issues the 32 gathers of its column before it
// adds any of them, so 32 loads a lane are in flight. The adds run in entry
// order from zero:
//  - a run of equal ids that lies inside the chunk is the only writer of
//    its row: out[id] += sum;
//  - a run that crosses a chunk boundary (at most two a chunk, and every
//    long run) leaves its piece in a scratch slot (2c when the piece begins
//    at the start of chunk c, 2c + 1 otherwise). `segsum_finish_kernel`,
//    launched behind it on the same stream, gives a warp to each chunk; the
//    warp whose chunk holds the START of a crossing run adds the run's
//    pieces from zero in chunk order and writes out[id] += that sum. A
//    segment of 200,000 entries is 782 independent warps and one walk over
//    782 floats a column.
// ops/segment_sum.py::segmented_segment_sum is the same summation in plain
// PyTorch; the CPU tests settle the boundary cases with it.
//
// What this layout leaves on the table: a lane owns a column, so at d < 32
// only d lanes of a warp gather and add, and at d = 1 (the bias, count and
// residual sums, nearly every call) one lane in 32 works while 31 idle.
// A d = 1 layout with lanes over entries and a fixed-order warp segmented
// reduction would keep the bits deterministic and use the whole warp.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 256;  // entries a warp owns
constexpr int kWarps = 8;    // warps a block
constexpr unsigned kFull = 0xffffffffu;

// Adds or parks the sum of one run of `id` in chunk c: its piece began at
// the chunk's start (`at_start`) and reached its end (`at_end`).
__device__ __forceinline__ void emit_run(float* __restrict__ out,
                                         float* __restrict__ scratch, int id,
                                         float acc, bool at_start, bool at_end,
                                         bool cross_in, bool cross_out,
                                         long long c, int d, int col,
                                         bool active) {
  if (!active) return;
  if ((at_start && cross_in) || (at_end && cross_out)) {
    scratch[(2 * c + (at_start ? 0 : 1)) * d + col] = acc;
  } else {
    float* dst = out + static_cast<long long>(id) * d + col;
    *dst = *dst + acc;
  }
}

__global__ void __launch_bounds__(kWarps * 32)
segsum_chunk_kernel(float* __restrict__ out, const float* __restrict__ vals,
                    const int* __restrict__ perm,
                    const int* __restrict__ ids, long long n, int d,
                    long long n_chunks, float* __restrict__ scratch) {
  const int lane = threadIdx.x & 31;
  const long long c =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (c >= n_chunks) return;
  const long long lo = c * kChunk;
  const long long hi = lo + kChunk < n ? lo + kChunk : n;
  const bool cross_in = lo > 0 && ids[lo - 1] == ids[lo];
  const bool cross_out = hi < n && ids[hi] == ids[hi - 1];

  for (int col0 = 0; col0 < d; col0 += 32) {
    const int col = col0 + lane;
    const bool active = col < d;
    float acc = 0.f;
    int run_id = ids[lo];
    long long run_start = lo;
    for (long long g = lo; g < hi; g += 32) {
      const long long j = g + lane;
      const int my_id = j < hi ? ids[j] : 0;
      const int my_p = j < hi ? perm[j] : 0;
      const int cnt = static_cast<int>(hi - g < 32 ? hi - g : 32);
      float x[32];
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        const int pt = __shfl_sync(kFull, my_p, t);
        x[t] = (t < cnt && active)
                   ? vals[static_cast<long long>(pt) * d + col]
                   : 0.f;
      }
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        const int id_t = __shfl_sync(kFull, my_id, t);
        if (t < cnt) {
          if (id_t != run_id) {  // the run before ends inside the chunk
            emit_run(out, scratch, run_id, acc, run_start == lo, false,
                     cross_in, cross_out, c, d, col, active);
            acc = 0.f;
            run_id = id_t;
            run_start = g + t;
          }
          acc += x[t];
        }
      }
    }
    emit_run(out, scratch, run_id, acc, run_start == lo, true, cross_in,
             cross_out, c, d, col, active);
  }
}

// One warp a chunk c < n_chunks - 1: when the run at the chunk's end goes on
// into chunk c + 1 and begins in chunk c, adds its pieces in chunk order.
__global__ void __launch_bounds__(kWarps * 32)
segsum_finish_kernel(float* __restrict__ out, const int* __restrict__ ids,
                     int d, long long n_chunks,
                     const float* __restrict__ scratch) {
  const int lane = threadIdx.x & 31;
  const long long c =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (c >= n_chunks - 1) return;
  const long long lo = c * kChunk;
  const long long hi = lo + kChunk;  // < n: chunk c + 1 exists
  const int id = ids[hi - 1];
  if (ids[hi] != id) return;                  // no run crosses the end
  if (c > 0 && ids[lo - 1] == id) return;     // it began in an earlier chunk
  const long long first = ids[lo] == id ? 2 * c : 2 * c + 1;
  // the chunks the run reaches into: c + 1 .. last, found 32 at a time
  long long last = c + 1;
  for (long long q0 = c + 2;; q0 += 32) {
    const long long q = q0 + lane;
    const bool on = q < n_chunks && ids[q * kChunk] == id;
    const unsigned stop = __ballot_sync(kFull, !on);
    if (stop) {
      last = q0 + __ffs(stop) - 2;
      break;
    }
    last = q0 + 31;
  }
  for (int col0 = 0; col0 < d; col0 += 32) {
    const int col = col0 + lane;
    if (col >= d) continue;
    float acc = 0.f;
    acc += scratch[first * d + col];
#pragma unroll 8
    for (long long q = c + 1; q <= last; ++q) acc += scratch[2 * q * d + col];
    float* dst = out + static_cast<long long>(id) * d + col;
    *dst = *dst + acc;
  }
}

}  // namespace

// out[ids_sorted[j], :] += vals[perm[j], :] for j in [0, n), in place, on
// `stream`. out (rows, d) and vals (n, d) f32 row-major, perm and ids_sorted
// (n,) int32 with ids_sorted ascending and every id a row of out. The plan
// comes from the caller (ops/segment_sum.py::segsum_plan): chunk must be
// kChunk, n_chunks = ceil(n / chunk), grid = ceil(n_chunks / kWarps),
// finish_grid = ceil((n_chunks - 1) / kWarps) (0: no finishing launch);
// scratch (2 * n_chunks, d) f32. Allocates nothing, returns
// cudaGetLastError() after its one or two launches; a shape or plan it does
// not take returns cudaErrorInvalidValue without launching.
extern "C" int mf_segment_sum(void* out, const void* vals, const void* perm,
                              const void* ids_sorted, long long n, int d,
                              void* scratch, int chunk, long long n_chunks,
                              long long grid, long long finish_grid,
                              void* stream) {
  if (n <= 0 || d <= 0 || chunk != kChunk ||
      n_chunks != (n + kChunk - 1) / kChunk ||
      grid != (n_chunks + kWarps - 1) / kWarps || grid > 0x7fffffffLL ||
      finish_grid != (n_chunks - 1 + kWarps - 1) / kWarps ||
      scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  const int* ids = static_cast<const int*>(ids_sorted);
  float* sc = static_cast<float*>(scratch);
  segsum_chunk_kernel<<<static_cast<unsigned>(grid), kWarps * 32, 0, s>>>(
      o, static_cast<const float*>(vals), static_cast<const int*>(perm), ids,
      n, d, n_chunks, sc);
  if (finish_grid > 0) {
    segsum_finish_kernel<<<static_cast<unsigned>(finish_grid), kWarps * 32,
                           0, s>>>(o, ids, d, n_chunks, sc);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mf_segment_sum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
