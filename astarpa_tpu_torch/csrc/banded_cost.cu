// Banded batched Myers edit distance with a shared sliding-window schedule
// (the cost kernel of the batch runtime's main path).
//
// Replaces the TPU kernel astarpa_tpu/ops/pallas_banded.py::_columns as
// driven by _kernel_shared in EMIT_COST mode (entry banded_cost_tpu with
// schedule=None).  The definition it must match bit for bit is
// astarpa_tpu/ops/banded.py::banded_cost_block; its plain torch twin is
// astarpa_tpu_torch/ops/banded.py::banded_cost_ref.
//
// Design: one thread per pair.  The planes are pair-minor ((n_max, B) and
// (S, B) uint32), so a warp's loads of a0[i*B+p] and pb0[(lo+w)*B+p] are
// coalesced.  The shift schedule is shared by the bucket, so the shift
// branch never diverges.  The window's profile words are read straight
// from pb0/pb1 at lo+w (the window is always pb[lo .. lo+SW)).  The vp/vm
// window lives in a ring in wrapper-allocated scratch of shape (SW, B):
// word w of the window sits at slot (lo+w) % SW, so a shift costs O(1)
// (absorb the top slot, reset it as the new bottom word) at any runtime SW.
//
// What bounds it on an H100 (reckoned, not measured): about 20 integer
// operations and 6 memory operations (2 profile loads, 2 ring loads, 2 ring
// stores) per word step, and 4096 pairs x 10^4 columns x 32 words ~ 1.3e9
// word steps per call at the headline shape.  The ring is 1 MB at SW=32,
// B=4096 and each block's slice stays in L1/L2, so the kernel is bound by
// load latency: one 32-thread block per 32 pairs puts one warp on each SM,
// with nothing to hide that latency.  Register-resident windows and more
// pairs per SM are the next steps.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kW = 32;
constexpr int kInf = 1 << 30;
constexpr int kThreads = 32;

__global__ void banded_cost_kernel(
    const uint32_t* __restrict__ a0, const uint32_t* __restrict__ a1,
    const uint32_t* __restrict__ pb0, const uint32_t* __restrict__ pb1,
    const int32_t* __restrict__ n, const int32_t* __restrict__ m,
    const int32_t* __restrict__ shift_at,
    uint32_t* __restrict__ ring_vp, uint32_t* __restrict__ ring_vm,
    int32_t* __restrict__ out, int n_max, int B, int SW) {
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
  // Columns past n[p]-1 change nothing this pair can still observe (its
  // result is captured at n[p]-1), so the thread stops there.
  const int last = np < n_max ? np : n_max;
  for (int i = 0; i < last; ++i) {
    if (shift_at[i]) {
      const size_t t = (size_t)top_slot * B + p;
      top_val += __popc(ring_vp[t]) - __popc(ring_vm[t]);
      top_rows += kW;
      ring_vp[t] = ~0u;  // the freed slot becomes the new bottom word
      ring_vm[t] = 0u;
      ++lo;
      top_slot = top_slot + 1 == SW ? 0 : top_slot + 1;
    }
    const uint32_t ca0 = a0[(size_t)i * B + p];
    const uint32_t ca1 = a1[(size_t)i * B + p];
    uint32_t hp = 1u, hm = 0u;
    int slot = top_slot;
    for (int w = 0; w < SW; ++w) {
      const size_t row = (size_t)(lo + w) * B + p;
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

}  // namespace

// C entry for ctypes.  All planes are device pointers; ring_vp/ring_vm are
// (SW, B) scratch.  Launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success).
extern "C" int astarpa_banded_cost(
    const void* a0, const void* a1, const void* pb0, const void* pb1,
    const void* n, const void* m, const void* shift_at, void* ring_vp,
    void* ring_vm, void* out, int n_max, int B, int SW, void* stream) {
  if (B > 0) {
    const int blocks = (B + kThreads - 1) / kThreads;
    banded_cost_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a0, (const uint32_t*)a1, (const uint32_t*)pb0,
        (const uint32_t*)pb1, (const int32_t*)n, (const int32_t*)m,
        (const int32_t*)shift_at, (uint32_t*)ring_vp, (uint32_t*)ring_vm,
        (int32_t*)out, n_max, B, SW);
  }
  return (int)cudaGetLastError();
}
