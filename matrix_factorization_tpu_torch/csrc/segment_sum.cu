// Deterministic sorted-segment sums for Hopper (sm_90a):
//
//   out[ids_sorted[j], :] += vals[perm[j], :]   for j in [0, n)
//
// Two entry points compute it, both with one writer a row, a fixed order
// and no float atomics, so the same inputs give the same bits:
//  - `mf_segment_sum`, any row width d: the bias, count and profile sums.
//    The JAX package has no Pallas kernel for these: they are
//    `jax.ops.segment_sum` and `.at[].add`, which XLA lowers to a scatter
//    (matrix_factorization_tpu/ops/als.py:75-84 and :133-145,
//    models/content_based.py:73-75 and :111-117).
//  - `mf_segment_apply`, rows of Kp floats (a multiple of 128): the SGD
//    step's secondary-side deltas added to their table, where XLA scatters
//    on the TPU (matrix_factorization_tpu/ops/segment_sgd.py:923,
//    `tile_sec_scatter`).
// On the GPU the library's scatters (`index_add_`, `scatter_add_`,
// `index_put_` with accumulate) add with float atomics in an order that
// changes from run to run, and the same seed must give the same bits.
//
// vals (n, d) and out (rows, d) are row-major f32; perm and ids_sorted (n,)
// int32, ids_sorted ascending (a stable sort of the ids,
// ops/segment_sum.py::sorted_order, or the pack's secondary argsort).
//
// What bounds both on an H100 SXM: bytes. They read the ids and perm (8 B
// an entry), one row of vals an entry (4 d B) and each touched row of out,
// and write that row: at MovieLens-1M's 1M ratings and d = 1 about 12 MB,
// 3.6 us at 3.35 TB/s; the apply at config 3 (2,097,152 entries, Kp 256)
// about 2.3 GB, 0.68 ms. One add an entry and column.
//
// One scheme for both. The stream is cut into chunks of consecutive
// entries, whatever the ids are, and one warp owns one chunk, so the
// launch is laid out without a look at the data (ops/segment_sum.py::
// segsum_plan, ops/cuda_sgd.py::apply_plan; the entry points refuse any
// other plan). Inside a chunk the adds run in a fixed order from zero:
//  - a run of equal ids that lies inside the chunk is the only writer of
//    its row: out[id] += sum;
//  - a run that crosses a chunk boundary (at most two a chunk, and every
//    long run) leaves its piece in a scratch slot (2c when the piece
//    begins at the start of chunk c, 2c + 1 otherwise). A finishing
//    launch behind it on the same stream gives a warp to each chunk; the
//    warp whose chunk holds the START of a crossing run adds the run's
//    pieces from zero in chunk order and writes out[id] += that sum. A
//    run of 200,000 entries is 782 independent warps and one walk over
//    782 pieces.
// Three layouts of a chunk's work on the warp's lanes:
//  - entries (the segment sum at d <= kEntriesMaxD, i.e. the bias, count
//    and residual sums): kChunk = 256 entries, lane l owns entries
//    [8l, 8l + 8) of the chunk. It loads their ids and perm as two 16-byte
//    vectors each (the warp's 1 KB of each is coalesced) and issues its 8
//    gathers of vals before it adds any. (1) Each lane adds each run-piece
//    of its 8 entries from zero in entry order. (2) The lane that holds a
//    run's first entry in the chunk adds from zero, in lane order, its own
//    last piece and the first piece of every later lane that begins with
//    the run, read by __shfl_sync in a fixed loop over the 32 lanes (no
//    tree). (3) A run that crosses the chunk goes to the scratch as above.
//    The run heads of different lanes write out independently, so their
//    read-modify-writes are in flight together.
//  - columns (the segment sum at wider d, e.g. the 18-column profiles):
//    lane l owns column l of a block of 32 columns. For each group of 32
//    entries the lanes load the ids and perm coalesced, then each lane
//    issues the 32 gathers of its column before it adds any of them. The
//    adds run in entry order.
//  - the apply's rows: kApplyChunk entries a chunk, lane l owns columns
//    [4l, 4l + 4) of each block of 128 as float4. The lanes load the
//    chunk's ids and perm once (one each a lane and group of 32) and find
//    the run starts by a ballot; the warp keeps kApplyRows rows in flight
//    and adds them in entry order, the order of the columns layout. The
//    longest walk is kApplyChunk rows, plus one finishing walk over a long
//    run's pieces.
// ops/segment_sum.py::segmented_segment_sum is each summation in plain
// PyTorch, bit for bit; the CPU tests settle the boundary cases with it and
// chip_smoke.py holds the kernels to it with torch.equal.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

// A probe build may override these to time another choice
// (tools/probe_kernels.py); ops/segment_sum.py and ops/cuda_sgd.py plan for
// the defaults.
#ifndef MF_ENTRIES_MAX_D
#define MF_ENTRIES_MAX_D 1
#endif
#ifndef MF_APPLY_CHUNK
#define MF_APPLY_CHUNK 32
#endif
#ifndef MF_APPLY_ROWS
#define MF_APPLY_ROWS 4
#endif

namespace {

constexpr int kChunk = 256;  // entries a warp owns in the segment sum
constexpr int kSlice = kChunk / 32;  // entries a lane owns (entries layout)
constexpr int kEntriesMaxD = MF_ENTRIES_MAX_D;  // widest d of that layout
constexpr int kApplyChunk = MF_APPLY_CHUNK;  // entries a warp owns (apply)
constexpr int kApplyGroups = kApplyChunk / 32;
constexpr int kApplyRows = MF_APPLY_ROWS;  // apply rows in flight a warp
constexpr int kMaxVec = 8;  // apply rows: Kp / 128 <= 8
constexpr int kWarps = 8;    // warps a block
constexpr unsigned kFull = 0xffffffffu;
static_assert(kSlice == 8, "two int4 loads of ids and of perm a lane");
static_assert(kApplyChunk % 32 == 0 && kApplyChunk >= 32 &&
                  kApplyChunk <= 256, "whole groups of 32 entries");
static_assert(32 % kApplyRows == 0, "the rows in flight tile a group");

// Where the piece of the run of `id` in chunk c goes: its scratch slot when
// the run crosses the chunk's start or end (2c when the piece begins at the
// chunk's start, 2c + 1 otherwise), else -1, the run's row of out.
__device__ __forceinline__ long long slot_of(int id, int first_id,
                                             int last_id, bool cross_in,
                                             bool cross_out, long long c) {
  if (id == first_id && cross_in) return 2 * c;
  if (id == last_id && cross_out) return id == first_id ? 2 * c : 2 * c + 1;
  return -1;
}

__device__ __forceinline__ void emit1(float* __restrict__ out,
                                      float* __restrict__ scratch,
                                      long long slot, int id, int d, int col,
                                      float acc) {
  if (slot >= 0) {
    scratch[slot * d + col] = acc;
  } else {
    float* dst = out + static_cast<long long>(id) * d + col;
    *dst = *dst + acc;
  }
}

// What a chunk [lo, hi) knows of the runs at its two ends.
struct Ends {
  int first_id, last_id;
  bool cross_in, cross_out;
};

__device__ __forceinline__ Ends chunk_ends(const int* __restrict__ ids,
                                           long long lo, long long hi,
                                           long long n) {
  Ends e;
  e.first_id = ids[lo];
  e.last_id = ids[hi - 1];
  e.cross_in = lo > 0 && ids[lo - 1] == e.first_id;
  e.cross_out = hi < n && ids[hi] == e.last_id;
  return e;
}

__global__ void __launch_bounds__(kWarps * 32)
segsum_entries_kernel(float* __restrict__ out, const float* __restrict__ vals,
                      const int* __restrict__ perm,
                      const int* __restrict__ ids, long long n, int d,
                      long long n_chunks, float* __restrict__ scratch,
                      bool vec) {
  const int lane = threadIdx.x & 31;
  const long long c =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (c >= n_chunks) return;
  const long long lo = c * kChunk;
  const long long hi = lo + kChunk < n ? lo + kChunk : n;
  const long long j0 = lo + kSlice * lane;
  const int cnt = static_cast<int>(
      hi - j0 >= kSlice ? kSlice : (hi > j0 ? hi - j0 : 0));
  const Ends ends = chunk_ends(ids, lo, hi, n);

  int e[kSlice], p[kSlice];
  if (vec && cnt == kSlice) {
    const int4* iv = reinterpret_cast<const int4*>(ids + j0);
    const int4* pv = reinterpret_cast<const int4*>(perm + j0);
    const int4 a = __ldg(iv), b = __ldg(iv + 1);
    const int4 q = __ldg(pv), r = __ldg(pv + 1);
    e[0] = a.x; e[1] = a.y; e[2] = a.z; e[3] = a.w;
    e[4] = b.x; e[5] = b.y; e[6] = b.z; e[7] = b.w;
    p[0] = q.x; p[1] = q.y; p[2] = q.z; p[3] = q.w;
    p[4] = r.x; p[5] = r.y; p[6] = r.z; p[7] = r.w;
  } else {
#pragma unroll
    for (int k = 0; k < kSlice; ++k) {
      e[k] = k < cnt ? ids[j0 + k] : -1;
      p[k] = k < cnt ? perm[j0 + k] : 0;
    }
  }
  // bit k: a run begins at entry k > 0 of the lane
  unsigned brk = 0;
#pragma unroll
  for (int k = 1; k < kSlice; ++k)
    if (k < cnt && e[k] != e[k - 1]) brk |= 1u << k;
  int my_last = e[0];
#pragma unroll
  for (int k = 1; k < kSlice; ++k)
    if (k < cnt) my_last = e[k];
  const int my_first = cnt > 0 ? e[0] : -1;  // ids are rows, never -1
  const int prev_last = __shfl_up_sync(kFull, my_last, 1);
  // the lane holds the first entry in the chunk of its first run, and of
  // its last run
  const bool first_head = cnt > 0 && (lane == 0 || prev_last != my_first);
  const bool last_head = cnt > 0 && (brk != 0 || first_head);
  // the later lanes whose first piece belongs to this lane's last run
  unsigned cont = 0;
#pragma unroll
  for (int t = 0; t < 32; ++t) {
    const int f = __shfl_sync(kFull, my_first, t);
    if (t > lane && f == my_last) cont |= 1u << t;
  }

  for (int col = 0; col < d; ++col) {
    float x[kSlice];
#pragma unroll
    for (int k = 0; k < kSlice; ++k)
      x[k] = k < cnt ? vals[static_cast<long long>(p[k]) * d + col] : 0.f;
    float acc = 0.f, p_first = 0.f;
    bool broken = false;
#pragma unroll
    for (int k = 0; k < kSlice; ++k) {
      if (k >= cnt) break;
      if (k > 0 && ((brk >> k) & 1u)) {  // the run of e[k - 1] ends here
        if (!broken) {
          p_first = acc;
          broken = true;
          if (first_head)
            emit1(out, scratch,
                  slot_of(e[k - 1], ends.first_id, ends.last_id,
                          ends.cross_in, ends.cross_out, c),
                  e[k - 1], d, col, acc);
        } else {  // a run wholly inside the lane
          emit1(out, scratch,
                slot_of(e[k - 1], ends.first_id, ends.last_id, ends.cross_in,
                        ends.cross_out, c),
                e[k - 1], d, col, acc);
        }
        acc = 0.f;
      }
      acc += x[k];
    }
    if (!broken) p_first = acc;
    float tot = 0.f;
    tot += acc;
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      const float v = __shfl_sync(kFull, p_first, t);
      if ((cont >> t) & 1u) tot += v;
    }
    if (last_head)
      emit1(out, scratch,
            slot_of(my_last, ends.first_id, ends.last_id, ends.cross_in,
                    ends.cross_out, c),
            my_last, d, col, tot);
  }
}

__global__ void __launch_bounds__(kWarps * 32)
segsum_columns_kernel(float* __restrict__ out, const float* __restrict__ vals,
                      const int* __restrict__ perm,
                      const int* __restrict__ ids, long long n, int d,
                      long long n_chunks, float* __restrict__ scratch) {
  const int lane = threadIdx.x & 31;
  const long long c =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (c >= n_chunks) return;
  const long long lo = c * kChunk;
  const long long hi = lo + kChunk < n ? lo + kChunk : n;
  const Ends ends = chunk_ends(ids, lo, hi, n);

  for (int col0 = 0; col0 < d; col0 += 32) {
    const int col = col0 + lane;
    const bool active = col < d;
    float acc = 0.f;
    int run_id = ends.first_id;
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
            if (active)
              emit1(out, scratch,
                    slot_of(run_id, ends.first_id, ends.last_id,
                            ends.cross_in, ends.cross_out, c),
                    run_id, d, col, acc);
            acc = 0.f;
            run_id = id_t;
          }
          acc += x[t];
        }
      }
    }
    if (active)
      emit1(out, scratch,
            slot_of(run_id, ends.first_id, ends.last_id, ends.cross_in,
                    ends.cross_out, c),
            run_id, d, col, acc);
  }
}

// For chunk c < n_chunks - 1 of `chunk` entries: whether a run crosses its
// end and begins in it; if so its id, the slot of its first piece and the
// last chunk it reaches (found 32 chunk starts at a time).
__device__ __forceinline__ bool crossing_run(const int* __restrict__ ids,
                                             long long c, int chunk,
                                             long long n_chunks, int lane,
                                             int* id, long long* first,
                                             long long* last) {
  const long long lo = c * chunk;
  const long long hi = lo + chunk;  // < n: chunk c + 1 exists
  *id = ids[hi - 1];
  if (ids[hi] != *id) return false;              // no run crosses the end
  if (c > 0 && ids[lo - 1] == *id) return false;  // it began earlier
  *first = ids[lo] == *id ? 2 * c : 2 * c + 1;
  *last = c + 1;
  for (long long q0 = c + 2;; q0 += 32) {
    const long long q = q0 + lane;
    const bool on = q < n_chunks && ids[q * chunk] == *id;
    const unsigned stop = __ballot_sync(kFull, !on);
    if (stop) {
      *last = q0 + __ffs(stop) - 2;
      return true;
    }
    *last = q0 + 31;
  }
}

// The segment sum's finishing launch: one warp a chunk, lanes over columns.
__global__ void __launch_bounds__(kWarps * 32)
segsum_finish_kernel(float* __restrict__ out, const int* __restrict__ ids,
                     int d, long long n_chunks,
                     const float* __restrict__ scratch) {
  const int lane = threadIdx.x & 31;
  const long long c =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (c >= n_chunks - 1) return;
  int id;
  long long first, last;
  if (!crossing_run(ids, c, kChunk, n_chunks, lane, &id, &first, &last))
    return;
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

__device__ __forceinline__ float4 ld4(const float* base, int idx) {
  return reinterpret_cast<const float4*>(base)[idx];
}

__device__ __forceinline__ void st4(float* base, int idx, float4 v) {
  reinterpret_cast<float4*>(base)[idx] = v;
}

__device__ __forceinline__ float4 add4(float4 p, float4 q) {
  return make_float4(p.x + q.x, p.y + q.y, p.z + q.z, p.w + q.w);
}

template <int NV>
__device__ __forceinline__ void emit_row(float* __restrict__ table,
                                         float* __restrict__ scratch,
                                         long long slot, int id, int lane,
                                         const float4 (&acc)[NV]) {
  constexpr int kp = NV * 128;
  float* dst = slot >= 0 ? scratch + static_cast<size_t>(slot) * kp
                         : table + static_cast<size_t>(id) * kp;
  if (slot >= 0) {
#pragma unroll
    for (int v = 0; v < NV; ++v) st4(dst, v * 32 + lane, acc[v]);
  } else {
#pragma unroll
    for (int v = 0; v < NV; ++v)
      st4(dst, v * 32 + lane, add4(ld4(dst, v * 32 + lane), acc[v]));
  }
}

template <int NV>
__global__ void __launch_bounds__(kWarps * 32)
apply_chunk_kernel(float* __restrict__ table, const float* __restrict__ rows,
                   const int* __restrict__ perm, const int* __restrict__ ids,
                   long long n, long long n_chunks,
                   float* __restrict__ scratch) {
  constexpr int kp = NV * 128;
  const int lane = threadIdx.x & 31;
  const long long c =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (c >= n_chunks) return;
  const long long lo = c * kApplyChunk;
  const long long hi = lo + kApplyChunk < n ? lo + kApplyChunk : n;
  const int cnt = static_cast<int>(hi - lo);
  const Ends ends = chunk_ends(ids, lo, hi, n);

  // lane l holds entry 32 g + l of the chunk; bit l of starts[g]: a run
  // begins there (the chunk's first entry counts when it begins a run)
  int my_id[kApplyGroups], my_p[kApplyGroups];
  unsigned starts[kApplyGroups];
  const int before = lo > 0 ? ids[lo - 1] : -1;
#pragma unroll
  for (int g = 0; g < kApplyGroups; ++g) {
    const int t = 32 * g + lane;
    my_id[g] = t < cnt ? ids[lo + t] : -1;
    my_p[g] = t < cnt ? perm[lo + t] : 0;
  }
#pragma unroll
  for (int g = 0; g < kApplyGroups; ++g) {
    const int up = __shfl_up_sync(kFull, my_id[g], 1);
    const int carry =
        g == 0 ? before : __shfl_sync(kFull, my_id[g > 0 ? g - 1 : 0], 31);
    const int prev = lane == 0 ? carry : up;
    starts[g] = __ballot_sync(kFull, 32 * g + lane < cnt && my_id[g] != prev);
  }

  float4 acc[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) acc[v] = make_float4(0.f, 0.f, 0.f, 0.f);
  int run_id = ends.first_id;
#pragma unroll
  for (int g = 0; g < kApplyGroups; ++g) {
#pragma unroll
    for (int t0 = 0; t0 < 32; t0 += kApplyRows) {
      const int base = 32 * g + t0;
      if (base >= cnt) break;  // the same on every lane
      float4 x[kApplyRows][NV];
#pragma unroll
      for (int u = 0; u < kApplyRows; ++u) {
        const int pu = __shfl_sync(kFull, my_p[g], t0 + u);
        const float* src = rows + static_cast<size_t>(pu) * kp;
#pragma unroll
        for (int v = 0; v < NV; ++v)
          x[u][v] = base + u < cnt ? ld4(src, v * 32 + lane)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kApplyRows; ++u) {
        const int t = base + u;
        const int id_t = __shfl_sync(kFull, my_id[g], t0 + u);
        if (t < cnt) {
          if (t > 0 && ((starts[g] >> (t0 + u)) & 1u)) {
            emit_row<NV>(table, scratch,
                         slot_of(run_id, ends.first_id, ends.last_id,
                                 ends.cross_in, ends.cross_out, c),
                         run_id, lane, acc);
#pragma unroll
            for (int v = 0; v < NV; ++v)
              acc[v] = make_float4(0.f, 0.f, 0.f, 0.f);
            run_id = id_t;
          }
#pragma unroll
          for (int v = 0; v < NV; ++v) acc[v] = add4(acc[v], x[u][v]);
        }
      }
    }
  }
  emit_row<NV>(table, scratch,
               slot_of(run_id, ends.first_id, ends.last_id, ends.cross_in,
                       ends.cross_out, c),
               run_id, lane, acc);
}

// The apply's finishing launch: one warp a chunk, lanes over float4
// columns; the pieces' addresses do not depend on the sum, so the loads of
// the unrolled pieces are in flight together.
template <int NV>
__global__ void __launch_bounds__(kWarps * 32)
apply_finish_kernel(float* __restrict__ table, const int* __restrict__ ids,
                    long long n_chunks, const float* __restrict__ scratch) {
  constexpr int kp = NV * 128;
  const int lane = threadIdx.x & 31;
  const long long c =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (c >= n_chunks - 1) return;
  int id;
  long long first, last;
  if (!crossing_run(ids, c, kApplyChunk, n_chunks, lane, &id, &first, &last))
    return;
  float4 acc[NV];
  const float* slot = scratch + static_cast<size_t>(first) * kp;
#pragma unroll
  for (int v = 0; v < NV; ++v)
    acc[v] = add4(make_float4(0.f, 0.f, 0.f, 0.f), ld4(slot, v * 32 + lane));
#pragma unroll 4
  for (long long q = c + 1; q <= last; ++q) {
    const float* piece = scratch + static_cast<size_t>(2 * q) * kp;
#pragma unroll
    for (int v = 0; v < NV; ++v)
      acc[v] = add4(acc[v], ld4(piece, v * 32 + lane));
  }
  emit_row<NV>(table, nullptr, -1, id, lane, acc);
}

template <int NV>
void launch_apply(float* table, const float* rows, const int* perm,
                  const int* ids, long long n, long long n_chunks,
                  long long grid, long long finish_grid, float* scratch,
                  cudaStream_t s) {
  apply_chunk_kernel<NV><<<static_cast<unsigned>(grid), kWarps * 32, 0, s>>>(
      table, rows, perm, ids, n, n_chunks, scratch);
  if (finish_grid > 0)
    apply_finish_kernel<NV>
        <<<static_cast<unsigned>(finish_grid), kWarps * 32, 0, s>>>(
            table, ids, n_chunks, scratch);
}

}  // namespace

// out[ids_sorted[j], :] += vals[perm[j], :] for j in [0, n), in place, on
// `stream`. out (rows, d) and vals (n, d) f32 row-major, perm and ids_sorted
// (n,) int32 with ids_sorted ascending and every id a row of out. The plan
// comes from the caller (ops/segment_sum.py::segsum_plan): layout 1
// (entries) for d <= kEntriesMaxD, else 0 (columns); chunk must be kChunk,
// n_chunks = ceil(n / chunk), grid = ceil(n_chunks / kWarps), finish_grid =
// ceil((n_chunks - 1) / kWarps) (0: no finishing launch); scratch
// (2 * n_chunks, d) f32. Allocates nothing, returns cudaGetLastError()
// after its one or two launches; a shape or plan it does not take returns
// cudaErrorInvalidValue without launching.
extern "C" int mf_segment_sum(void* out, const void* vals, const void* perm,
                              const void* ids_sorted, long long n, int d,
                              void* scratch, int layout, int chunk,
                              long long n_chunks, long long grid,
                              long long finish_grid, void* stream) {
  if (n <= 0 || d <= 0 || layout != (d <= kEntriesMaxD ? 1 : 0) ||
      chunk != kChunk || n_chunks != (n + kChunk - 1) / kChunk ||
      grid != (n_chunks + kWarps - 1) / kWarps || grid > 0x7fffffffLL ||
      finish_grid != (n_chunks - 1 + kWarps - 1) / kWarps ||
      scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  const float* v = static_cast<const float*>(vals);
  const int* p = static_cast<const int*>(perm);
  const int* ids = static_cast<const int*>(ids_sorted);
  float* sc = static_cast<float*>(scratch);
  if (layout == 1) {
    const bool vec = (reinterpret_cast<std::uintptr_t>(ids) |
                      reinterpret_cast<std::uintptr_t>(p)) % 16 == 0;
    segsum_entries_kernel<<<static_cast<unsigned>(grid), kWarps * 32, 0,
                            s>>>(o, v, p, ids, n, d, n_chunks, sc, vec);
  } else {
    segsum_columns_kernel<<<static_cast<unsigned>(grid), kWarps * 32, 0,
                            s>>>(o, v, p, ids, n, d, n_chunks, sc);
  }
  if (finish_grid > 0) {
    segsum_finish_kernel<<<static_cast<unsigned>(finish_grid), kWarps * 32,
                           0, s>>>(o, ids, d, n_chunks, sc);
  }
  return static_cast<int>(cudaGetLastError());
}

// table[ids_sorted[j], :] += rows[perm[j], :] for j in [0, n), in place, on
// `stream`: table (rows, kp) and rows (n, kp) f32 row-major, 16-byte
// aligned, kp a multiple of 128 and at most 1024; perm and ids_sorted (n,)
// int32, ids_sorted ascending. The plan comes from the caller
// (ops/cuda_sgd.py::apply_plan): chunk must be kApplyChunk, n_chunks =
// ceil(n / chunk), grid = ceil(n_chunks / kWarps), finish_grid =
// ceil((n_chunks - 1) / kWarps); scratch (2 * n_chunks, kp) f32. The same
// return convention as mf_segment_sum.
extern "C" int mf_segment_apply(void* table, const void* rows,
                                const void* perm, const void* ids_sorted,
                                long long n, int kp, void* scratch,
                                int chunk, long long n_chunks, long long grid,
                                long long finish_grid, void* stream) {
  if (n <= 0 || kp <= 0 || kp % 128 || kp / 128 > kMaxVec ||
      chunk != kApplyChunk || n_chunks != (n + kApplyChunk - 1) / kApplyChunk ||
      grid != (n_chunks + kWarps - 1) / kWarps || grid > 0x7fffffffLL ||
      finish_grid != (n_chunks - 1 + kWarps - 1) / kWarps ||
      scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* T = static_cast<float*>(table);
  const float* R = static_cast<const float*>(rows);
  const int* p = static_cast<const int*>(perm);
  const int* ids = static_cast<const int*>(ids_sorted);
  float* sc = static_cast<float*>(scratch);
  switch (kp / 128) {
    case 1: launch_apply<1>(T, R, p, ids, n, n_chunks, grid, finish_grid, sc, s); break;
    case 2: launch_apply<2>(T, R, p, ids, n, n_chunks, grid, finish_grid, sc, s); break;
    case 3: launch_apply<3>(T, R, p, ids, n, n_chunks, grid, finish_grid, sc, s); break;
    case 4: launch_apply<4>(T, R, p, ids, n, n_chunks, grid, finish_grid, sc, s); break;
    case 5: launch_apply<5>(T, R, p, ids, n, n_chunks, grid, finish_grid, sc, s); break;
    case 6: launch_apply<6>(T, R, p, ids, n, n_chunks, grid, finish_grid, sc, s); break;
    case 7: launch_apply<7>(T, R, p, ids, n, n_chunks, grid, finish_grid, sc, s); break;
    case 8: launch_apply<8>(T, R, p, ids, n, n_chunks, grid, finish_grid, sc, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mf_segment_sum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
