// One synchronous mini-batch SGD step of kernel matrix factorization for
// Hopper (sm_90a).
//
// `mf_sgd_step` replaces the TPU kernel
// matrix_factorization_tpu/ops/pallas_sgd.py:65 `_step_kernel` (launched by
// `fused_tile_step` from `segment_sgd.fused_tile_deltas`). The deltas it
// leaves for the secondary side (dq) are added to their table by
// `mf_segment_apply` (csrc/segment_sum.cu), which replaces the secondary
// scatter that XLA does on the TPU (`segment_sgd.tile_sec_scatter`).
//
// A batch holds n entries (prim_id, sec_id, r, w), stored sorted by the
// primary id (the pack's per-batch sort, or a stable sort on the card).
// Tables use the bias-folded layout of ops/segment_sgd.py, row width Kp, a
// multiple of 128. With x the pre-step primary row, y the secondary row and
// s = <x, y> (linear, sigmoid) or |x - y|^2 (rbf):
//
//   linear : pred = mu + s            dx = y            dy = x
//   sigmoid: pred = a + c sig(mu + s) dx = y b, dy = x b, b = sig (1 - sig)
//   rbf    : pred = a + c exp(-g s)   dx = -(x - y) b, dy = -dx, b = 2 g e
//   err = (pred - r) w
//   P[prim] += sum over the run of -lr ((err dx + reg w x) pmask)
//   dq[j]    = -lr ((err dy + reg w y) smask)
//
// The gradients leave c out (the reference's convention, PARITY.md #4), and
// are symmetric in the two sides, so the kernel never needs to know which
// side is the user: the masks carry that. Pads have w = 0 and give zero
// deltas.
//
// What bounds it on an H100 SXM: bytes; there are about 12 f32 operations
// an entry and column. Counting each input read once and each output
// written once, it reads the ids, r and w (16 B an entry), each distinct
// secondary row (Kp*4 B) and each run's primary row, and writes that row
// and dq (Kp*4 B an entry). At config 3 (MovieLens-25M shape, sigmoid, bs =
// 2,097,152, Kp = 256, ~1.4e5 user runs a batch) that is about 2.5 GB, 0.76
// ms at 3.35 TB/s; the apply reads dq again (2.3 GB, 0.68 ms). chip_smoke.py
// computes both from the batch it runs. dq is most of both: fusing the step
// and the apply would keep it out of device memory.
// That bound counts every distinct secondary row once; the step gathers a row
// an entry (2.1 GB of gathers beside the 2.1 GB dq stream at config 3), and
// the card's memory system gives that pattern less: on an H100 80GB HBM3 at
// 700 W a fill of dq alone takes 0.75 ms and one index_select of the rows
// into dq 1.33 ms, the step 1.42 ms (PERF.md).
//
// Design. The batch is cut into segments of kSegLen consecutive entries,
// whatever the ids are, and one warp owns one segment at a time (a
// persistent grid strides over the segments). The number of segments is
// known without a look at the data, so the caller lays the launch out and
// allocates the scratch ahead (ops/cuda_sgd.py::step_plan); the entry point
// refuses a plan this source was not compiled for.
//  - Metadata by lanes. Lane l loads the ids, r and w of entries l, l + 32,
//    ... of the segment in coalesced loads and compares its id with its
//    neighbours' (a shuffle, plus the one id before and after the segment):
//    that gives every entry a "piece begins" and a "piece ends" bit. The
//    lanes leave (sec_id, r, w, bits) of every entry in the warp's shared
//    memory; the entry loop reads one broadcast 16-byte word an entry. No
//    warp scans for run starts and no id load sits in the per-entry chain.
//  - Rows in flight. With every secondary id in hand the warp asks for the
//    rows of the next kStages - 1 entries before it computes the current
//    one: 16-byte cp.async.cg copies (L2 only) into a ring of kStages rows
//    in shared memory. A lane copies and later reads the same 16-byte
//    slots, so the ring needs no barrier, only cp.async.wait_group.
//  - A run inside one segment is handled whole: the pre-step row x in
//    registers, the deltas added in entry order, one write P[prim] = x +
//    acc. It is the only writer of that row and nothing else reads it.
//  - A run that crosses a segment boundary (at most two a segment, and
//    every long run) is summed in pieces: the warp writes its piece to a
//    scratch slot (slot 2s when the piece begins at the start of segment s,
//    2s + 1 otherwise) and leaves P alone. `step_finish_kernel`, launched
//    behind it on the same stream, gives one warp to each segment; the warp
//    whose segment holds the START of a crossing run adds that run's pieces
//    in segment order and writes P[prim] = x + sum. One writer a row, one
//    fixed order, no atomics; a crossing run's row is written by the second
//    launch alone, so every piece read the pre-step row. A run of 6,800
//    entries is 6,800 / kSegLen independent warps and one short sum.
//  - The two masks live in shared memory, not in a lane's registers. dq
//    leaves through streaming stores (st.global.cs) and the gathers carry
//    an L2 policy that keeps half of their lines ahead of everything else,
//    so that dq pushes fewer secondary rows out of L2.
// Every sum has a fixed order: the step is bitwise deterministic. Offsets
// are 64-bit (j * Kp reaches 5.4e8 at bs = 2M).
//
// The accumulator mode (`mf_sgd_step_acc`): the primary rows are read from
// prim_tbl, which stays as it is, and each run's summed delta is added to
// its row of a second table, prim_out (out[prim] += acc; a crossing run's
// pieces are added there by the second launch, in segment order). It is the
// `agg` output of the TPU kernel (pallas_sgd.py:167) that the data-parallel
// trainers of matrix_factorization_tpu/parallel/distributed.py add to the
// side they write: the window's item-delta table when the pack is
// item-primary, or either side's delta table in the 2D trainer, where both
// tables are read frozen for a window. One writer a row and the same fixed
// order as the in-place mode; without prim_out the kernel is the in-place
// step, bit for bit.
// Later work: fuse the step and the apply so that dq never reaches device
// memory; that kernel needs the fixed-segment split on both sides.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kLinear = 0;
constexpr int kSigmoid = 1;
constexpr int kRbf = 2;

constexpr int kWarps = 8;  // warps per 256-thread block
constexpr int kMaxVec = 8;  // Kp / 128 <= 8, i.e. Kp <= 1024
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may take

// The step's geometry; ops/cuda_sgd.py (SEG_LEN, STEP_STAGES) plans for the
// same values. A probe build may override them to time another choice.
#ifndef MF_SEG_LEN
#define MF_SEG_LEN 64
#endif
#ifndef MF_STAGES
#define MF_STAGES 6
#endif
constexpr int kSegLen = MF_SEG_LEN;  // consecutive entries one warp owns
constexpr int kStages = MF_STAGES;  // secondary rows a warp keeps in flight
static_assert(kSegLen % 32 == 0 && kSegLen >= 32, "whole warps of entries");
static_assert(kStages >= 1 && kStages <= 8, "cp.async.wait_group depth");

constexpr int kBegins = 1;  // entry bits: a piece of a run begins here
constexpr int kEnds = 2;  // ... and ends here

__device__ __forceinline__ float warp_sum(float v) {
  // butterfly: a + b == b + a in IEEE arithmetic, so every lane ends with
  // the same bits, in the same order on every run
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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

// The gathers' L2 policy: half of the secondary rows' lines are kept ahead
// of everything else (evict_last), so that the dq stream and the rest of a
// table larger than L2 push fewer of them out. MF_GATHER_KEEP is the
// fraction; a probe build may pass another.
#ifndef MF_GATHER_KEEP
#define MF_GATHER_KEEP 0.5
#endif
#define MF_STR2(x) #x
#define MF_STR(x) MF_STR2(x)
__device__ __forceinline__ unsigned long long gather_policy() {
  unsigned long long p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, " MF_STR(
                   MF_GATHER_KEEP) ";\n"
               : "=l"(p));
  return p;
}

// 16 bytes from device memory to shared memory, cached in L2 only
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           unsigned long long policy) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" ::"r"(
          dst),
      "l"(gmem), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared memory of a step block, in 16-byte words: the two masks (NV * 32
// words each), every warp's ring (kStages rows), every warp's entry words
// (kSegLen), then every warp's primary ids (kSegLen ints).
__host__ __device__ constexpr int step_smem_bytes(int nv) {
  return 16 * (2 * nv * 32 + kWarps * kStages * nv * 32 + kWarps * kSegLen) +
         4 * kWarps * kSegLen;
}

template <int KERNEL, int NV>
__global__ void __launch_bounds__(kWarps * 32)
sgd_step_kernel(const float* __restrict__ mu_ptr, float* __restrict__ prim_tbl,
                const float* __restrict__ sec_tbl,
                const int* __restrict__ prim_ids,
                const int* __restrict__ sec_ids, const float* __restrict__ r,
                const float* __restrict__ w, const float* __restrict__ pmask,
                const float* __restrict__ smask, float* __restrict__ dq,
                float* __restrict__ scratch, float* __restrict__ prim_out,
                long long n, long long n_segments, float gamma, float a,
                float c, float lr, float reg, int update_prim) {
  constexpr int kRow4 = NV * 32;  // 16-byte words a row
  constexpr int kp = NV * 128;
  constexpr unsigned kFull = 0xffffffffu;
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float4* pm = smem4;
  const float4* sm = smem4 + kRow4;
  float4* ring = smem4 + 2 * kRow4 + warp * (kStages * kRow4);
  int4* meta = reinterpret_cast<int4*>(smem4 + 2 * kRow4 +
                                       kWarps * kStages * kRow4) +
               warp * kSegLen;
  int* pids = reinterpret_cast<int*>(smem4 + 2 * kRow4 +
                                     kWarps * kStages * kRow4 +
                                     kWarps * kSegLen) +
              warp * kSegLen;
  for (int t = threadIdx.x; t < kRow4; t += kWarps * 32) {
    smem4[t] = ld4(pmask, t);
    smem4[kRow4 + t] = ld4(smask, t);
  }
  __syncthreads();

  const long long n_warps = static_cast<long long>(gridDim.x) * kWarps;
  const float mu = *mu_ptr;
  const float nlr = -lr;
  const unsigned long long policy = gather_policy();
  for (long long s = static_cast<long long>(blockIdx.x) * kWarps + warp;
       s < n_segments; s += n_warps) {
    const long long j0 = s * kSegLen;
    const int count =
        static_cast<int>(n - j0 < kSegLen ? n - j0 : kSegLen);
    // the ids around the segment (-1: none; ids are >= 0)
    const int before = j0 > 0 ? prim_ids[j0 - 1] : -1;
    const int after = j0 + count < n ? prim_ids[j0 + count] : -1;

    int id[kSegLen / 32];
#pragma unroll
    for (int m = 0; m < kSegLen / 32; ++m)
      id[m] = m * 32 + lane < count ? prim_ids[j0 + m * 32 + lane] : -1;
    __syncwarp();  // the last segment's entry words have all been read
#pragma unroll
    for (int m = 0; m < kSegLen / 32; ++m) {
      const int e = m * 32 + lane;
      const bool valid = e < count;
      const int sid = valid ? sec_ids[j0 + e] : 0;
      const float rj = valid ? r[j0 + e] : 0.f;
      const float wj = valid ? w[j0 + e] : 0.f;
      // the neighbours' ids: a shuffle, across chunks of 32 too
      int prev = __shfl_up_sync(kFull, id[m], 1);
      const int from_left =
          m == 0 ? before : __shfl_sync(kFull, id[m > 0 ? m - 1 : 0], 31);
      if (lane == 0) prev = from_left;
      int next = __shfl_down_sync(kFull, id[m], 1);
      const int from_right =
          m + 1 < kSegLen / 32
              ? __shfl_sync(kFull, id[m + 1 < kSegLen / 32 ? m + 1 : m], 0)
              : -1;
      if (lane == 31) next = from_right;
      // the segment's first entry always begins a piece and its last always
      // ends one; an entry past the batch has id -1 and ends the one before
      int bits = 0;
      if (valid && (e == 0 || id[m] != prev)) bits |= kBegins;
      if (valid && (e == count - 1 || id[m] != next)) bits |= kEnds;
      meta[e] = make_int4(sid, __float_as_int(rj), __float_as_int(wj), bits);
      pids[e] = id[m];
    }
    __syncwarp();
    const bool head_cross = before == pids[0];
    const bool tail_cross = after == pids[count - 1];

    // the ring: rows of entries 0 .. kStages - 2 first, then one row ahead
    // of every entry computed; one commit group an entry, empty or not
#pragma unroll
    for (int e = 0; e < kStages - 1; ++e) {
      if (e < count) {
        const float4* src = reinterpret_cast<const float4*>(
            sec_tbl + static_cast<size_t>(meta[e].x) * kp);
#pragma unroll
        for (int v = 0; v < NV; ++v)
          cp_async16(ring + e * kRow4 + v * 32 + lane, src + v * 32 + lane,
                     policy);
      }
      cp_async_commit();
    }

    float4 x[NV], acc[NV];
    float* xrow = nullptr;
    int piece_begin = 0;
    for (int e = 0; e < count; ++e) {
      const int ahead = e + kStages - 1;
      if (ahead < count) {
        const float4* src = reinterpret_cast<const float4*>(
            sec_tbl + static_cast<size_t>(meta[ahead].x) * kp);
        float4* dst = ring + (ahead % kStages) * kRow4;
#pragma unroll
        for (int v = 0; v < NV; ++v)
          cp_async16(dst + v * 32 + lane, src + v * 32 + lane, policy);
      }
      cp_async_commit();
      const int4 me = meta[e];
      if (me.w & kBegins) {
        xrow = prim_tbl + static_cast<size_t>(pids[e]) * kp;
        piece_begin = e;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          x[v] = ld4(xrow, v * 32 + lane);
          acc[v] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
      cp_async_wait<kStages - 1>();

      const float4* yrow = ring + (e % kStages) * kRow4;
      float4 y[NV];
      float part = 0.f;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        y[v] = yrow[v * 32 + lane];
        if (KERNEL == kRbf) {
          const float d0 = x[v].x - y[v].x, d1 = x[v].y - y[v].y;
          const float d2 = x[v].z - y[v].z, d3 = x[v].w - y[v].w;
          part += d0 * d0 + d1 * d1 + d2 * d2 + d3 * d3;
        } else {
          part += x[v].x * y[v].x + x[v].y * y[v].y + x[v].z * y[v].z +
                  x[v].w * y[v].w;
        }
      }
      const float s_ = warp_sum(part);

      float pred, base;
      if (KERNEL == kLinear) {
        pred = mu + s_;
        base = 1.f;
      } else if (KERNEL == kSigmoid) {
        const float sig = 1.f / (1.f + expf(-(mu + s_)));
        pred = a + c * sig;
        base = sig * (1.f - sig);
      } else {
        const float ex = expf(-gamma * s_);
        pred = a + c * ex;
        base = (2.f * gamma) * ex;
      }
      const float wj = __int_as_float(me.z);
      const float err = (pred - __int_as_float(me.y)) * wj;
      const float rw = reg * wj;
      float* dqrow =
          dq == nullptr ? nullptr : dq + static_cast<size_t>(j0 + e) * kp;

#define MF_COL(f)                                                          \
    {                                                                      \
      float dx, dy;                                                        \
      if (KERNEL == kRbf) {                                                \
        dx = -(x[v].f - y[v].f) * base;                                    \
        dy = -dx;                                                          \
      } else {                                                             \
        dx = y[v].f * base;                                                \
        dy = x[v].f * base;                                                \
      }                                                                    \
      acc[v].f += nlr * ((err * dx + rw * x[v].f) * pmv.f);                \
      out.f = nlr * ((err * dy + rw * y[v].f) * smv.f);                    \
    }
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const float4 pmv = pm[v * 32 + lane], smv = sm[v * 32 + lane];
        float4 out;
        MF_COL(x) MF_COL(y) MF_COL(z) MF_COL(w)
        if (dqrow != nullptr)
          __stcs(reinterpret_cast<float4*>(dqrow) + v * 32 + lane, out);
      }
#undef MF_COL

      if ((me.w & kEnds) && update_prim) {
        const bool crosses = (piece_begin == 0 && head_cross) ||
                             (e == count - 1 && tail_cross);
        if (crosses) {
          float* slot = scratch +
                        static_cast<size_t>(2 * s + (piece_begin != 0)) * kp;
#pragma unroll
          for (int v = 0; v < NV; ++v) st4(slot, v * 32 + lane, acc[v]);
        } else if (prim_out == nullptr) {
#pragma unroll
          for (int v = 0; v < NV; ++v)
            st4(xrow, v * 32 + lane, add4(x[v], acc[v]));
        } else {
          float* orow = prim_out + static_cast<size_t>(pids[e]) * kp;
#pragma unroll
          for (int v = 0; v < NV; ++v)
            st4(orow, v * 32 + lane, add4(ld4(orow, v * 32 + lane), acc[v]));
        }
      }
    }
  }
}

// The second launch of a step: one warp a segment. The warp whose segment
// holds the start of a run that reaches into the next segment adds the
// run's pieces in segment order (its own slot first, then the head slot of
// every later segment the run begins) to the pre-step row and writes it;
// in the accumulator mode (`out` is prim_out) it adds them to the run's row
// of prim_out instead.
template <int NV>
__global__ void __launch_bounds__(kWarps * 32)
step_finish_kernel(float* __restrict__ out, const int* __restrict__ prim_ids,
                   const float* __restrict__ scratch, long long n_segments) {
  constexpr int kp = NV * 128;
  constexpr unsigned kFull = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const long long s =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (s + 1 >= n_segments) return;  // nothing follows the last segment
  const long long j0 = s * kSegLen, j1 = j0 + kSegLen;  // j1 < n
  // independent loads: the ids around both ends of the segment
  const int id = prim_ids[j1 - 1];
  const int next = prim_ids[j1];
  const int before = j0 > 0 ? prim_ids[j0 - 1] : -1;
  const int first = prim_ids[j0];
  if (next != id || before == id) return;  // no crossing run starts here

  // the segments s + 1 .. t_end - 1 begin with the run: the ids at 32
  // segment starts looked up at a time (a long run is rare)
  long long t_end = s + 2;
  while (true) {
    const long long t = t_end + lane;
    const bool more = t < n_segments && prim_ids[t * kSegLen] == id;
    const unsigned hit = __ballot_sync(kFull, more);
    if (hit != kFull) {
      t_end += __ffs(~hit) - 1;  // the leading run of 1s
      break;
    }
    t_end += 32;
  }

  float4 acc[NV];
  const float* slot =
      scratch + static_cast<size_t>(2 * s + (first != id)) * kp;
#pragma unroll
  for (int v = 0; v < NV; ++v) acc[v] = ld4(slot, v * 32 + lane);
  // the pieces' addresses do not depend on the sum, so the loads of the
  // unrolled pieces are in flight together
#pragma unroll 4
  for (long long t = s + 1; t < t_end; ++t) {
    const float* piece = scratch + static_cast<size_t>(2 * t) * kp;
#pragma unroll
    for (int v = 0; v < NV; ++v)
      acc[v] = add4(acc[v], ld4(piece, v * 32 + lane));
  }
  float* xrow = out + static_cast<size_t>(id) * kp;
#pragma unroll
  for (int v = 0; v < NV; ++v)
    st4(xrow, v * 32 + lane, add4(ld4(xrow, v * 32 + lane), acc[v]));
}

template <int KERNEL, int NV>
int launch_step(const float* mu, float* prim, const float* sec, const int* pid,
                const int* sid, const float* r, const float* w,
                const float* pm, const float* sm, float* dq, float* scratch,
                float* prim_out, long long n, long long n_segments,
                float gamma, float a, float c, float lr, float reg,
                int update_prim, int grid, int smem_bytes,
                cudaStream_t stream) {
  if (smem_bytes != step_smem_bytes(NV) || smem_bytes > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = sgd_step_kernel<KERNEL, NV>;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kernel<<<grid, kWarps * 32, smem_bytes, stream>>>(
      mu, prim, sec, pid, sid, r, w, pm, sm, dq, scratch, prim_out, n,
      n_segments, gamma, a, c, lr, reg, update_prim);
  if (update_prim && n_segments > 1) {
    const long long blocks = (n_segments - 1 + kWarps - 1) / kWarps;
    step_finish_kernel<NV>
        <<<static_cast<unsigned int>(blocks), kWarps * 32, 0, stream>>>(
            prim_out == nullptr ? prim : prim_out, pid, scratch, n_segments);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int KERNEL, typename... Args>
int launch_step_for_width(int nv, Args... args) {
  switch (nv) {
    case 1: return launch_step<KERNEL, 1>(args...);
    case 2: return launch_step<KERNEL, 2>(args...);
    case 3: return launch_step<KERNEL, 3>(args...);
    case 4: return launch_step<KERNEL, 4>(args...);
    case 5: return launch_step<KERNEL, 5>(args...);
    case 6: return launch_step<KERNEL, 6>(args...);
    case 7: return launch_step<KERNEL, 7>(args...);
    case 8: return launch_step<KERNEL, 8>(args...);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int run_step(const void* mu, void* prim_tbl, const void* sec_tbl,
             const void* prim_ids, const void* sec_ids, const void* r,
             const void* w, const void* pmask, const void* smask, void* dq,
             void* prim_out, long long n, int kp, int kernel, float gamma,
             float a, float c, float lr, float reg, int update_prim,
             void* scratch, int seg_len, long long n_segments, int grid,
             int smem_bytes, int stages, void* stream) {
  if (kernel < kLinear || kernel > kRbf || n <= 0 || kp <= 0 || kp % 128 ||
      kp / 128 > kMaxVec)
    return static_cast<int>(cudaErrorInvalidValue);
  if (seg_len != kSegLen || stages != kStages ||
      n_segments != (n + kSegLen - 1) / kSegLen || grid < 1 ||
      grid > (n_segments + kWarps - 1) / kWarps ||
      (update_prim && scratch == nullptr) || prim_out == prim_tbl)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nv = kp / 128;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mu);
  float* P = static_cast<float*>(prim_tbl);
  const float* S = static_cast<const float*>(sec_tbl);
  const int* pid = static_cast<const int*>(prim_ids);
  const int* sid = static_cast<const int*>(sec_ids);
  const float* rr = static_cast<const float*>(r);
  const float* ww = static_cast<const float*>(w);
  const float* pm = static_cast<const float*>(pmask);
  const float* sm = static_cast<const float*>(smask);
  float* d = static_cast<float*>(dq);
  float* sc = static_cast<float*>(scratch);
  float* o = static_cast<float*>(prim_out);
  if (kernel == kLinear)
    return launch_step_for_width<kLinear>(
        nv, m, P, S, pid, sid, rr, ww, pm, sm, d, sc, o, n, n_segments, gamma,
        a, c, lr, reg, update_prim, grid, smem_bytes, s);
  if (kernel == kSigmoid)
    return launch_step_for_width<kSigmoid>(
        nv, m, P, S, pid, sid, rr, ww, pm, sm, d, sc, o, n, n_segments, gamma,
        a, c, lr, reg, update_prim, grid, smem_bytes, s);
  return launch_step_for_width<kRbf>(
      nv, m, P, S, pid, sid, rr, ww, pm, sm, d, sc, o, n, n_segments, gamma, a,
      c, lr, reg, update_prim, grid, smem_bytes, s);
}

}  // namespace

// kernel: 0 linear, 1 sigmoid, 2 rbf. mu is a device pointer to one float.
// prim_tbl and sec_tbl are (rows, kp) row-major f32 tables; prim_ids and
// sec_ids (n,) int32, sorted by prim_ids; r, w (n,) f32; pmask, smask (kp,)
// f32; dq (n, kp) f32, or null when the secondary side is frozen. Every
// pointer is 16-byte aligned and kp is a multiple of 128, at most 1024. The
// primary table is updated in place (skipped when update_prim is 0).
// The launch plan comes from the caller (ops/cuda_sgd.py::step_plan):
// seg_len and stages must be the values this source is compiled for,
// n_segments = ceil(n / seg_len), smem_bytes what the kernel lays out, grid
// at most one warp a segment; scratch (2 * n_segments, kp) f32 takes the
// partial sums of the runs that cross a segment boundary (it may be null
// when update_prim is 0). Runs on `stream` (two launches when update_prim is
// set), allocates nothing, and returns cudaGetLastError() after the
// launches; a shape, kernel or plan it does not take returns
// cudaErrorInvalidValue without launching.
extern "C" int mf_sgd_step(const void* mu, void* prim_tbl, const void* sec_tbl,
                           const void* prim_ids, const void* sec_ids,
                           const void* r, const void* w, const void* pmask,
                           const void* smask, void* dq, long long n, int kp,
                           int kernel, float gamma, float a, float c, float lr,
                           float reg, int update_prim, void* scratch,
                           int seg_len, long long n_segments, int grid,
                           int smem_bytes, int stages, void* stream) {
  return run_step(mu, prim_tbl, sec_tbl, prim_ids, sec_ids, r, w, pmask, smask,
                  dq, nullptr, n, kp, kernel, gamma, a, c, lr, reg,
                  update_prim, scratch, seg_len, n_segments, grid, smem_bytes,
                  stages, stream);
}

// `mf_sgd_step` in the accumulator mode: the same arguments, plus prim_out,
// a (rows, kp) f32 table other than prim_tbl. prim_tbl is only read; each
// run's summed primary delta is added to its row of prim_out (when
// update_prim is set).
extern "C" int mf_sgd_step_acc(const void* mu, const void* prim_tbl,
                               const void* sec_tbl, const void* prim_ids,
                               const void* sec_ids, const void* r,
                               const void* w, const void* pmask,
                               const void* smask, void* dq, long long n,
                               int kp, int kernel, float gamma, float a,
                               float c, float lr, float reg, int update_prim,
                               void* scratch, int seg_len,
                               long long n_segments, int grid, int smem_bytes,
                               int stages, void* prim_out, void* stream) {
  if (prim_out == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return run_step(mu, const_cast<void*>(prim_tbl), sec_tbl, prim_ids, sec_ids,
                  r, w, pmask, smask, dq, prim_out, n, kp, kernel, gamma, a, c,
                  lr, reg, update_prim, scratch, seg_len, n_segments, grid,
                  smem_bytes, stages, stream);
}

extern "C" const char* mf_sgd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
