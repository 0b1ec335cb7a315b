// One synchronous mini-batch SGD step of kernel matrix factorization, and
// the deterministic apply of its secondary-side deltas, for Hopper (sm_90a).
//
// `mf_sgd_step` replaces the TPU kernel
// matrix_factorization_tpu/ops/pallas_sgd.py:65 `_step_kernel` (launched by
// `fused_tile_step` from `segment_sgd.fused_tile_deltas`). `mf_segment_apply`
// replaces the secondary scatter that XLA does on the TPU
// (`segment_sgd.tile_sec_scatter`); on the GPU a float-atomic scatter
// (`index_add_`) sums in a different order on every run, and the same seed
// must give the same bits.
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
// written once, (a) reads the ids, r and w (16 B an entry), each distinct
// secondary row (Kp*4 B) and each run's primary row, and writes that row
// and dq (Kp*4 B an entry); (b) reads dq, perm and ids (Kp*4 + 8 B an entry)
// and reads and writes each touched secondary row. At config 3 (MovieLens-25M
// shape, sigmoid, bs = 2,097,152, Kp = 256, ~1.4e5 user runs and ~5.9e4 item
// runs a batch) that is about 2.5 GB for (a) and 2.3 GB for (b): 0.76 ms and
// 0.68 ms at 3.35 TB/s. chip_smoke.py computes both from the batch it runs.
// dq is most of both: fusing (a) and (b) would keep it out of device memory.
//
// Design. One warp owns one run of equal primary ids. The warps of a grid
// sized to fill the SMs stride over the entries and take each entry that
// starts a run (a run averages ~15 entries at config 3, so a warp launched
// per entry would mostly exit at once and leave the SMs idle). It holds the
// pre-step primary row in registers (Kp/32 floats a lane, as Kp/128
// float4s, so every row load is a coalesced 16-byte-per-lane load) and
// walks the run in entry order: it loads the secondary row, reduces the dot
// (or squared distance) across the warp with a butterfly (every lane ends
// with the same bits), adds the primary delta into a register accumulator
// and writes dq[j] from the pre-step row. At the run's end it writes
// P[prim] = x + acc: it is the only writer of that row and no other warp
// reads it, so the in-place update keeps the pre-step semantics without
// atomics. (b) is built the same way over `ids_sorted`, summing
// rows[perm[j]] in j order; the pack's argsort is stable, so a run sums in
// batch order. Every sum has a fixed order: the step is bitwise
// deterministic. Offsets are 64-bit (j * Kp reaches 5.4e8 at bs = 2M).
// Later work: split long runs over several warps, fuse (a) and (b) so that
// dq never reaches device memory.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kLinear = 0;
constexpr int kSigmoid = 1;
constexpr int kRbf = 2;

constexpr int kWarps = 8;  // warps per 256-thread block
constexpr int kBlocksPerSm = 8;  // grid cap: 64 warps an SM, the most it holds
constexpr int kMaxVec = 8;  // Kp / 128 <= 8, i.e. Kp <= 1024

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

template <int KERNEL, int NV>
__global__ void __launch_bounds__(kWarps * 32)
sgd_step_kernel(const float* __restrict__ mu_ptr, float* __restrict__ prim_tbl,
                const float* __restrict__ sec_tbl,
                const int* __restrict__ prim_ids,
                const int* __restrict__ sec_ids, const float* __restrict__ r,
                const float* __restrict__ w, const float* __restrict__ pmask,
                const float* __restrict__ smask, float* __restrict__ dq,
                long long n, int kp, float gamma, float a, float c, float lr,
                float reg, int update_prim) {
  const int lane = threadIdx.x & 31;
  const long long n_warps = static_cast<long long>(gridDim.x) * kWarps;
  const float mu = *mu_ptr;
  for (long long j0 =
           static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       j0 < n; j0 += n_warps) {
    const int row = prim_ids[j0];
    if (j0 > 0 && prim_ids[j0 - 1] == row) continue;  // not the start of a run

    float* xrow = prim_tbl + static_cast<size_t>(row) * kp;
    float4 x[NV], pm[NV], sm[NV], acc[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      x[v] = ld4(xrow, v * 32 + lane);
      pm[v] = ld4(pmask, v * 32 + lane);
      sm[v] = ld4(smask, v * 32 + lane);
      acc[v] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

    for (long long j = j0; j < n && prim_ids[j] == row; ++j) {
      const float* yrow = sec_tbl + static_cast<size_t>(sec_ids[j]) * kp;
      float4 y[NV];
      float part = 0.f;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        y[v] = ld4(yrow, v * 32 + lane);
        if (KERNEL == kRbf) {
          const float d0 = x[v].x - y[v].x, d1 = x[v].y - y[v].y;
          const float d2 = x[v].z - y[v].z, d3 = x[v].w - y[v].w;
          part += d0 * d0 + d1 * d1 + d2 * d2 + d3 * d3;
        } else {
          part += x[v].x * y[v].x + x[v].y * y[v].y + x[v].z * y[v].z +
                  x[v].w * y[v].w;
        }
      }
      const float s = warp_sum(part);

      float pred, base;
      if (KERNEL == kLinear) {
        pred = mu + s;
        base = 1.f;
      } else if (KERNEL == kSigmoid) {
        const float sig = 1.f / (1.f + expf(-(mu + s)));
        pred = a + c * sig;
        base = sig * (1.f - sig);
      } else {
        const float e = expf(-gamma * s);
        pred = a + c * e;
        base = (2.f * gamma) * e;
      }
      const float wj = w[j];
      const float err = (pred - r[j]) * wj;
      const float rw = reg * wj;
      float* dqrow = dq == nullptr ? nullptr : dq + static_cast<size_t>(j) * kp;

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
      acc[v].f += -lr * ((err * dx + rw * x[v].f) * pm[v].f);              \
      out.f = -lr * ((err * dy + rw * y[v].f) * sm[v].f);                  \
    }
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        float4 out;
        MF_COL(x) MF_COL(y) MF_COL(z) MF_COL(w)
        if (dqrow != nullptr) st4(dqrow, v * 32 + lane, out);
      }
#undef MF_COL
    }

    if (update_prim) {
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        st4(xrow, v * 32 + lane,
            make_float4(x[v].x + acc[v].x, x[v].y + acc[v].y, x[v].z + acc[v].z,
                        x[v].w + acc[v].w));
      }
    }
  }
}

template <int NV>
__global__ void __launch_bounds__(kWarps * 32)
segment_apply_kernel(float* __restrict__ table, const float* __restrict__ rows,
                     const int* __restrict__ perm,
                     const int* __restrict__ ids_sorted, long long n, int kp) {
  const int lane = threadIdx.x & 31;
  const long long n_warps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long j0 =
           static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       j0 < n; j0 += n_warps) {
    const int id = ids_sorted[j0];
    if (j0 > 0 && ids_sorted[j0 - 1] == id) continue;  // not the start of a run

    float4 acc[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) acc[v] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (long long j = j0; j < n && ids_sorted[j] == id; ++j) {
      const float* src = rows + static_cast<size_t>(perm[j]) * kp;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const float4 d = ld4(src, v * 32 + lane);
        acc[v].x += d.x;
        acc[v].y += d.y;
        acc[v].z += d.z;
        acc[v].w += d.w;
      }
    }
    float* dst = table + static_cast<size_t>(id) * kp;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const float4 t = ld4(dst, v * 32 + lane);
      st4(dst, v * 32 + lane,
          make_float4(t.x + acc[v].x, t.y + acc[v].y, t.z + acc[v].z,
                      t.w + acc[v].w));
    }
  }
}

// A grid that keeps every SM full and no larger: the warps stride over the
// entries, so one that exits early frees nothing for the others.
inline unsigned int blocks_for(long long n) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long need = (n + kWarps - 1) / kWarps;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  return static_cast<unsigned int>(need < cap ? need : cap);
}

template <int KERNEL, int NV>
void launch_step(const float* mu, float* prim, const float* sec,
                 const int* pid, const int* sid, const float* r,
                 const float* w, const float* pm, const float* sm, float* dq,
                 long long n, int kp, float gamma, float a, float c, float lr,
                 float reg, int update_prim, cudaStream_t stream) {
  sgd_step_kernel<KERNEL, NV><<<blocks_for(n), kWarps * 32, 0, stream>>>(
      mu, prim, sec, pid, sid, r, w, pm, sm, dq, n, kp, gamma, a, c, lr, reg,
      update_prim);
}

template <int KERNEL>
void launch_step_for_width(int nv, const float* mu, float* prim,
                           const float* sec, const int* pid, const int* sid,
                           const float* r, const float* w, const float* pm,
                           const float* sm, float* dq, long long n, int kp,
                           float gamma, float a, float c, float lr, float reg,
                           int update_prim, cudaStream_t s) {
#define MF_STEP(NV)                                                          \
  case NV:                                                                   \
    launch_step<KERNEL, NV>(mu, prim, sec, pid, sid, r, w, pm, sm, dq, n, kp, \
                            gamma, a, c, lr, reg, update_prim, s);           \
    break;
  switch (nv) {
    MF_STEP(1) MF_STEP(2) MF_STEP(3) MF_STEP(4)
    MF_STEP(5) MF_STEP(6) MF_STEP(7) MF_STEP(8)
  }
#undef MF_STEP
}

}  // namespace

// kernel: 0 linear, 1 sigmoid, 2 rbf. mu is a device pointer to one float.
// prim_tbl and sec_tbl are (rows, kp) row-major f32 tables; prim_ids and
// sec_ids (n,) int32, sorted by prim_ids; r, w (n,) f32; pmask, smask (kp,)
// f32; dq (n, kp) f32, or null when the secondary side is frozen. Every
// pointer is 16-byte aligned and kp is a multiple of 128, at most 1024. The
// primary table is updated in place (skipped when update_prim is 0). Runs on
// `stream`, allocates nothing, and returns cudaGetLastError() after the
// launch; a shape or kernel it does not take returns cudaErrorInvalidValue
// without launching.
extern "C" int mf_sgd_step(const void* mu, void* prim_tbl, const void* sec_tbl,
                           const void* prim_ids, const void* sec_ids,
                           const void* r, const void* w, const void* pmask,
                           const void* smask, void* dq, long long n, int kp,
                           int kernel, float gamma, float a, float c, float lr,
                           float reg, int update_prim, void* stream) {
  if (kernel < kLinear || kernel > kRbf || n <= 0 || kp <= 0 || kp % 128 ||
      kp / 128 > kMaxVec)
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
  if (kernel == kLinear)
    launch_step_for_width<kLinear>(nv, m, P, S, pid, sid, rr, ww, pm, sm, d, n,
                                   kp, gamma, a, c, lr, reg, update_prim, s);
  else if (kernel == kSigmoid)
    launch_step_for_width<kSigmoid>(nv, m, P, S, pid, sid, rr, ww, pm, sm, d,
                                    n, kp, gamma, a, c, lr, reg, update_prim,
                                    s);
  else
    launch_step_for_width<kRbf>(nv, m, P, S, pid, sid, rr, ww, pm, sm, d, n,
                                kp, gamma, a, c, lr, reg, update_prim, s);
  return static_cast<int>(cudaGetLastError());
}

// table[ids_sorted[j]] += rows[perm[j]] for j in [0, n), each run of equal
// ids summed in j order by one warp. table (rows, kp) and rows (n, kp) f32
// row-major; perm and ids_sorted (n,) int32, ids_sorted ascending. The same
// alignment and kp limits as mf_sgd_step; the same return convention.
extern "C" int mf_segment_apply(void* table, const void* rows,
                                const void* perm, const void* ids_sorted,
                                long long n, int kp, void* stream) {
  if (n <= 0 || kp <= 0 || kp % 128 || kp / 128 > kMaxVec)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* T = static_cast<float*>(table);
  const float* R = static_cast<const float*>(rows);
  const int* p = static_cast<const int*>(perm);
  const int* ids = static_cast<const int*>(ids_sorted);
#define MF_APPLY(NV)                                                     \
  case NV:                                                               \
    segment_apply_kernel<NV><<<blocks_for(n), kWarps * 32, 0, s>>>(      \
        T, R, p, ids, n, kp);                                            \
    break;
  switch (kp / 128) {
    MF_APPLY(1) MF_APPLY(2) MF_APPLY(3) MF_APPLY(4)
    MF_APPLY(5) MF_APPLY(6) MF_APPLY(7) MF_APPLY(8)
  }
#undef MF_APPLY
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mf_sgd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
