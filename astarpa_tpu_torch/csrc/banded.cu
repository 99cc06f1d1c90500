// Banded batched Myers edit distance: the sliding-window kernels of the
// batch runtime, one template over (schedule, emit).
//
//   K1 banded_cost     shared schedule, costs
//   K2 banded_ck       shared schedule, costs + window checkpoints
//   K3 banded_fill     shared schedule, costs + every column's window
//   K3 banded_fill_pp  per-pair schedules, costs + every column's window
//   K4 banded_cost_pp  per-pair schedules, costs
//   K4 banded_ck_pp    per-pair schedules, costs + window checkpoints
//
// On a path: banded_fill_pp (no caller yet; the wrapper banded_fill_pp
// runs it).  Timing only: the old K1, the old shared K3 and the old K4
// cost entry, whose launches the ring kernels of csrc/pinned.cu took
// (banded_ring_kernel, banded_ring_fill_kernel, banded_ring_pp_kernel);
// ops/banded_kernel.py's internal _launch runs them, as chip_smoke.py does
// to time them beside the rings.  The old K4 ck entry runs only for a
// Q-rounded checkpoint interval below SW with more than one checkpoint,
// which K4's checkpoint ring refuses, and the old K2 only for an interval
// below SW with more than one capture window or a band of more than 2048
// words, which K2's ring (banded_ring_ck_kernel) refuses (tests on the
// host before the launch, ops/banded_kernel.py::k4_kernel and k2_kernel;
// the runner's intervals are at least SW + 8 unless n_max clamps them to
// one checkpoint, and its K2 bands are below 64 words).
//
// They replace the TPU kernel astarpa_tpu/ops/pallas_banded.py::_banded_call
// (state machine _columns): K1 is _kernel_shared in EMIT_COST mode (entry
// banded_cost_tpu, schedule=None), K2 the same in EMIT_CK mode (banded_ck_tpu),
// K3 both kernels in EMIT_FILL mode (banded_fill_tpu, either schedule), K4 is
// _kernel_perpair in cost and ck mode (schedule=...).  The definitions they
// must match bit for bit are astarpa_tpu/ops/banded.py::banded_cost_block,
// banded_fill_block and banded_cost_block_pp and the checkpoint contract of
// banded_ck_tpu; their plain torch twins are in astarpa_tpu_torch/ops/banded.py.
//
// Design: one thread per pair.  The planes are pair-minor ((n_max, B) and
// (S, B) uint32), so a warp's loads of a0[i*B+p] and pb0[row*B+p] are
// coalesced.  Window word w is the profile word pb[lo+w] (per-pair: clamped
// at S-1, as the reference clamps its entering word), read straight from
// the planes.  The vp/vm window lives in a ring in wrapper-allocated scratch
// of shape (SW, B): word w sits at slot (top_slot+w) % SW, so a shift costs
// O(1) (absorb the top slot, reset it as the new bottom word) at any SW.
//
// Shared schedules never diverge within a warp.  Per-pair schedules are
// read only at columns that are multiples of Q (the reference reads
// sched[::Q]; the wrapper asserts the schedule is quantized), so the shift
// branch diverges at most once every Q columns.
//
// Checkpoints (kEmitCk): before the shift of column k*CB, the thread writes
// its top_val and the window planes un-rotated (ring slot (top_slot+w) % SW
// to row w).  A finished pair keeps sliding to n_max, as the reference does,
// so every checkpoint is defined; it runs no more columns.
//
// Fill (kEmitFill): after column i (its shift and, while i < n[p], its word
// steps), the thread writes the window un-rotated into row i of the
// (n_max, SW, B) planes.  A finished pair keeps sliding and writes its
// unchanged, shifted window, as the reference does past a pair's end.  B is
// minor, so a warp's stores of one word are one coalesced 128-byte line.
// K3 is bound by those stores (8*SW bytes a column a pair); one thread per
// pair issues them behind its own serial column chain, so it runs far from
// that bound, as K1 does from its own.
//
// What bounds it on an H100 (reckoned, not measured): about 20 integer
// operations and 6 memory operations (2 profile loads, 2 ring loads, 2 ring
// stores) per word step; each warp's loop is a chain of dependent L1/L2
// loads with nothing to hide their latency, since one block of 32 threads
// per 32 pairs puts one warp on an SM (at B=128, four warps on four SMs).
// Register-resident windows, more pairs per SM and a band split across a
// warp are the next steps.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kW = 32;
constexpr int kInf = 1 << 30;
constexpr int kThreads = 32;

enum Emit { kEmitCost, kEmitCk, kEmitFill };

// Row i of the fill planes: the window un-rotated from the ring.
__device__ __forceinline__ void store_window(
    uint32_t* __restrict__ vp_cols, uint32_t* __restrict__ vm_cols,
    const uint32_t* __restrict__ ring_vp, const uint32_t* __restrict__ ring_vm,
    int i, int top_slot, int SW, int B, int p) {
  int s = top_slot;
  for (int w = 0; w < SW; ++w) {
    const size_t o = ((size_t)i * SW + w) * B + p;
    vp_cols[o] = ring_vp[(size_t)s * B + p];
    vm_cols[o] = ring_vm[(size_t)s * B + p];
    s = s + 1 == SW ? 0 : s + 1;
  }
}

template <bool kPerPair, int kEmit>
__global__ void banded_kernel(
    const uint32_t* __restrict__ a0, const uint32_t* __restrict__ a1,
    const uint32_t* __restrict__ pb0, const uint32_t* __restrict__ pb1,
    const int32_t* __restrict__ n, const int32_t* __restrict__ m,
    const int32_t* __restrict__ shift_at, const uint8_t* __restrict__ sched,
    uint32_t* __restrict__ ring_vp, uint32_t* __restrict__ ring_vm,
    int32_t* __restrict__ out, uint32_t* __restrict__ ck_vp,
    uint32_t* __restrict__ ck_vm, int32_t* __restrict__ ck_tv,
    int n_max, int B, int S, int SW, int Q, int CB) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= B) return;
  const int np = n[p];
  const int mp = m[p];
  for (int w = 0; w < SW; ++w) {
    ring_vp[(size_t)w * B + p] = ~0u;
    ring_vm[(size_t)w * B + p] = 0u;
  }
  int top_val = 0, top_rows = 0, lo = 0, top_slot = 0;
  int result = mp;  // n == 0: cost m
  // Columns past n[p]-1 change nothing the result can observe (it is
  // captured at n[p]-1); only checkpoints and fill planes still see the
  // window slide.
  const int stop = np < n_max ? np : n_max;
  const int last = kEmit == kEmitCost ? stop : n_max;
  for (int i = 0; i < last; ++i) {
    if (kEmit == kEmitCk && i % CB == 0) {
      const size_t k = (size_t)(i / CB);
      ck_tv[k * B + p] = top_val;
      int s = top_slot;
      for (int w = 0; w < SW; ++w) {
        const size_t o = (k * SW + w) * B + p;
        ck_vp[o] = ring_vp[(size_t)s * B + p];
        ck_vm[o] = ring_vm[(size_t)s * B + p];
        s = s + 1 == SW ? 0 : s + 1;
      }
    }
    bool shift;
    if (kPerPair) {
      shift = i % Q == 0 && sched[(size_t)i * B + p] != 0;
    } else {
      shift = shift_at[i] != 0;
    }
    if (shift) {
      const size_t t = (size_t)top_slot * B + p;
      top_val += __popc(ring_vp[t]) - __popc(ring_vm[t]);
      top_rows += kW;
      ring_vp[t] = ~0u;  // the freed slot becomes the new bottom word
      ring_vm[t] = 0u;
      ++lo;
      top_slot = top_slot + 1 == SW ? 0 : top_slot + 1;
    }
    if (kEmit != kEmitCost && i >= stop) {
      if (kEmit == kEmitFill)
        store_window(ck_vp, ck_vm, ring_vp, ring_vm, i, top_slot, SW, B, p);
      continue;
    }
    const uint32_t ca0 = a0[(size_t)i * B + p];
    const uint32_t ca1 = a1[(size_t)i * B + p];
    uint32_t hp = 1u, hm = 0u;
    int slot = top_slot;
    for (int w = 0; w < SW; ++w) {
      int r = lo + w;
      if (kPerPair) r = r < S ? r : S - 1;
      const size_t row = (size_t)r * B + p;
      const size_t s = (size_t)slot * B + p;
      const uint32_t eq = (ca0 ^ pb0[row]) & (ca1 ^ pb1[row]);
      const uint32_t vp = ring_vp[s];
      const uint32_t vm = ring_vm[s];
      const uint32_t vx = eq | vm;
      const uint32_t eq2 = eq | hm;
      const uint32_t hx = (((eq2 & vp) + vp) ^ vp) | eq2;
      uint32_t hpo = vm | ~(hx | vp);
      uint32_t hmo = vp & hx;
      const uint32_t hp_next = hpo >> (kW - 1);
      const uint32_t hm_next = hmo >> (kW - 1);
      hpo = (hpo << 1) | hp;
      hmo = (hmo << 1) | hm;
      ring_vp[s] = hmo | ~(vx | hpo);
      ring_vm[s] = hpo & vx;
      hp = hp_next;
      hm = hm_next;
      slot = slot + 1 == SW ? 0 : slot + 1;
    }
    ++top_val;
    if (kEmit == kEmitFill)
      store_window(ck_vp, ck_vm, ring_vp, ring_vm, i, top_slot, SW, B, p);
    if (i == np - 1) {
      const int rows = mp - top_rows;  // may be negative: then res = top_val
      if (rows <= SW * kW) {
        int res = top_val;
        int s = top_slot;
        for (int w = 0; w < SW; ++w) {
          int full = rows - kW * w;
          full = full < 0 ? 0 : (full > kW ? kW : full);
          // full == 32 takes the all-ones branch: 1u << 32 is undefined.
          const uint32_t mask = full >= kW ? ~0u : (1u << full) - 1u;
          const size_t o = (size_t)s * B + p;
          res += __popc(ring_vp[o] & mask) - __popc(ring_vm[o] & mask);
          s = s + 1 == SW ? 0 : s + 1;
        }
        result = res;
      } else {
        result = kInf;
      }
    }
  }
  out[p] = result;
}

template <bool kPerPair, int kEmit>
int launch(const void* a0, const void* a1, const void* pb0, const void* pb1,
           const void* n, const void* m, const void* shift_at,
           const void* sched, void* ring_vp, void* ring_vm, void* out,
           void* ck_vp, void* ck_vm, void* ck_tv, int n_max, int B, int S,
           int SW, int Q, int CB, void* stream) {
  if (B > 0) {
    const int blocks = (B + kThreads - 1) / kThreads;
    banded_kernel<kPerPair, kEmit><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a0, (const uint32_t*)a1, (const uint32_t*)pb0,
        (const uint32_t*)pb1, (const int32_t*)n, (const int32_t*)m,
        (const int32_t*)shift_at, (const uint8_t*)sched, (uint32_t*)ring_vp,
        (uint32_t*)ring_vm, (int32_t*)out, (uint32_t*)ck_vp,
        (uint32_t*)ck_vm, (int32_t*)ck_tv, n_max, B, S, SW, Q, CB);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// C entries for ctypes.  All arrays are device pointers; ring_vp/ring_vm are
// (SW, B) scratch.  `schedule` is the shared (n_max,) int32 shift_at or the
// per-pair (n_max, B) uint8 one, read at multiples of Q.  The ck entries
// write (n_ck, SW, B) planes and (n_ck, B) top values, n_ck = ceil(n_max/CB);
// the fill entries (n_max, SW, B) planes.
// Each launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success).
extern "C" {

int astarpa_banded_cost(const void* a0, const void* a1, const void* pb0,
                        const void* pb1, const void* n, const void* m,
                        const void* schedule, void* ring_vp, void* ring_vm,
                        void* out, int n_max, int B, int S, int SW,
                        void* stream) {
  return launch<false, kEmitCost>(a0, a1, pb0, pb1, n, m, schedule, nullptr,
                              ring_vp, ring_vm, out, nullptr, nullptr, nullptr,
                              n_max, B, S, SW, 1, 1, stream);
}

int astarpa_banded_ck(const void* a0, const void* a1, const void* pb0,
                      const void* pb1, const void* n, const void* m,
                      const void* schedule, void* ring_vp, void* ring_vm,
                      void* out, void* ck_vp, void* ck_vm, void* ck_tv,
                      int n_max, int B, int S, int SW, int CB, void* stream) {
  return launch<false, kEmitCk>(a0, a1, pb0, pb1, n, m, schedule, nullptr,
                             ring_vp, ring_vm, out, ck_vp, ck_vm, ck_tv, n_max,
                             B, S, SW, 1, CB, stream);
}

int astarpa_banded_cost_pp(const void* a0, const void* a1, const void* pb0,
                           const void* pb1, const void* n, const void* m,
                           const void* schedule, void* ring_vp, void* ring_vm,
                           void* out, int n_max, int B, int S, int SW, int Q,
                           void* stream) {
  return launch<true, kEmitCost>(a0, a1, pb0, pb1, n, m, nullptr, schedule,
                             ring_vp, ring_vm, out, nullptr, nullptr, nullptr,
                             n_max, B, S, SW, Q, 1, stream);
}

int astarpa_banded_ck_pp(const void* a0, const void* a1, const void* pb0,
                         const void* pb1, const void* n, const void* m,
                         const void* schedule, void* ring_vp, void* ring_vm,
                         void* out, void* ck_vp, void* ck_vm, void* ck_tv,
                         int n_max, int B, int S, int SW, int Q, int CB,
                         void* stream) {
  return launch<true, kEmitCk>(a0, a1, pb0, pb1, n, m, nullptr, schedule,
                            ring_vp, ring_vm, out, ck_vp, ck_vm, ck_tv, n_max,
                            B, S, SW, Q, CB, stream);
}

int astarpa_banded_fill(const void* a0, const void* a1, const void* pb0,
                        const void* pb1, const void* n, const void* m,
                        const void* schedule, void* ring_vp, void* ring_vm,
                        void* out, void* vp_cols, void* vm_cols, int n_max,
                        int B, int S, int SW, void* stream) {
  return launch<false, kEmitFill>(a0, a1, pb0, pb1, n, m, schedule, nullptr,
                                  ring_vp, ring_vm, out, vp_cols, vm_cols,
                                  nullptr, n_max, B, S, SW, 1, 1, stream);
}

int astarpa_banded_fill_pp(const void* a0, const void* a1, const void* pb0,
                           const void* pb1, const void* n, const void* m,
                           const void* schedule, void* ring_vp, void* ring_vm,
                           void* out, void* vp_cols, void* vm_cols, int n_max,
                           int B, int S, int SW, int Q, void* stream) {
  return launch<true, kEmitFill>(a0, a1, pb0, pb1, n, m, nullptr, schedule,
                                 ring_vp, ring_vm, out, vp_cols, vm_cols,
                                 nullptr, n_max, B, S, SW, Q, 1, stream);
}

}  // extern "C"
