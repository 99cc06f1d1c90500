// K11 nw_right_edge: full-rectangle batched Myers edit distance, each pair's
// right-edge vertical differences (vp, vm) at its column n on all S words.
//
// Replaces the TPU kernel astarpa_tpu/ops/pallas_myers.py::nw_right_edge
// (kernel _nw_kernel).  The definition it must match bit for bit, pad rows
// included, is astarpa_tpu_torch/ops/myers.py::nw_right_edge_ref.
//
// The TPU kernel staggers words along the anti-diagonal (word w runs column
// t-w at step t) so that one (S, lanes) tile advances every word at once,
// with the h carry in a sublane shift register.  A thread has no such
// register file to sweep, and needs no stagger: here one thread owns one
// pair and walks its columns with the words inner, which yields the same
// planes.  The planes are pair-minor ((n_max, B) and (S, B) uint32), so a
// warp's loads of a0[i*B+p] and its stores of vp[w*B+p] are coalesced.
//
// Words are taken in stripes of kWords = 32 (1 kbp is exactly one stripe):
// the stripe's vp, vm and profile words live in registers (all indices
// compile-time), and the stripe walks the pair's n columns.  A taller pair
// runs its stripes one after another; stripe k hands the carry out of its
// bottom word at every column to stripe k+1 through a (n_max, B) byte plane
// (hp | hm << 1), read and rewritten in place by the same thread.  Words of
// a partial last stripe past S compute on zero profile words and are never
// stored: carries only flow down, so they cannot reach a real word.
//
// What bounds it on an H100: the integer pipe.  nvcc 12.9 compiles a word
// step to 14 int32 instructions (10 LOP3, 3 shifts, 1 add), 475 for the
// column loop's 32 words with its overhead (python -m
// astarpa_tpu_torch.ops.sass_count).  A column's words form one dependent
// chain through the h carry, so a warp alone is latency-bound; 128
// registers of state per thread leave ~12 warps per SM to hide that.
// The a-planes are read once per stripe (0.52 GB at 65 536 x 1 kbp, well
// under the operation bound's time), with the next column prefetched.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kW = 32;
constexpr int kWords = 32;
constexpr int kThreads = 64;

__global__ void __launch_bounds__(kThreads) nw_kernel(
    const uint32_t* __restrict__ a0, const uint32_t* __restrict__ a1,
    const uint32_t* __restrict__ pb0, const uint32_t* __restrict__ pb1,
    const int32_t* __restrict__ n, uint8_t* __restrict__ carry,
    uint32_t* __restrict__ vp_out, uint32_t* __restrict__ vm_out, int B,
    int S) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= B) return;
  const int np = n[p];
  for (int base = 0; base < S; base += kWords) {
    const bool above = base > 0;          // carries come from the stripe above
    const bool below = base + kWords < S;  // and go to the stripe below
    uint32_t vp[kWords], vm[kWords], p0[kWords], p1[kWords];
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      vp[w] = ~0u;
      vm[w] = 0u;
      const bool real = base + w < S;
      p0[w] = real ? pb0[(size_t)(base + w) * B + p] : 0u;
      p1[w] = real ? pb1[(size_t)(base + w) * B + p] : 0u;
    }
    uint32_t next0 = np > 0 ? a0[p] : 0u;
    uint32_t next1 = np > 0 ? a1[p] : 0u;
    for (int i = 0; i < np; ++i) {
      const uint32_t ca0 = next0, ca1 = next1;
      if (i + 1 < np) {
        next0 = a0[(size_t)(i + 1) * B + p];
        next1 = a1[(size_t)(i + 1) * B + p];
      }
      uint32_t hp = 1u, hm = 0u;  // +1 at the top row
      if (above) {
        const uint32_t c = carry[(size_t)i * B + p];
        hp = c & 1u;
        hm = c >> 1;
      }
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        const uint32_t eq = (ca0 ^ p0[w]) & (ca1 ^ p1[w]);
        const uint32_t vx = eq | vm[w];
        const uint32_t eq2 = eq | hm;
        const uint32_t hx = (((eq2 & vp[w]) + vp[w]) ^ vp[w]) | eq2;
        uint32_t hpo = vm[w] | ~(hx | vp[w]);
        uint32_t hmo = vp[w] & hx;
        const uint32_t hp_next = hpo >> (kW - 1);
        const uint32_t hm_next = hmo >> (kW - 1);
        hpo = (hpo << 1) | hp;
        hmo = (hmo << 1) | hm;
        vp[w] = hmo | ~(vx | hpo);
        vm[w] = hpo & vx;
        hp = hp_next;
        hm = hm_next;
      }
      if (below) carry[(size_t)i * B + p] = (uint8_t)(hp | (hm << 1));
    }
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      if (base + w < S) {
        vp_out[(size_t)(base + w) * B + p] = vp[w];
        vm_out[(size_t)(base + w) * B + p] = vm[w];
      }
    }
  }
}

}  // namespace

// C entry for ctypes.  All arrays are device pointers: a0/a1 (n_max, B),
// pb0/pb1 (S, B), n (B,) with 0 <= n[p] <= n_max, carry (n_max, B) bytes of
// scratch (unused, and may be null, when S <= 32), vp/vm (S, B) outputs.
// Launches on `stream` without synchronising and returns cudaGetLastError()
// (0 on success).
extern "C" int astarpa_nw_right_edge(const void* a0, const void* a1,
                                     const void* pb0, const void* pb1,
                                     const void* n, void* carry, void* vp,
                                     void* vm, int B, int S, void* stream) {
  if (B > 0) {
    const int blocks = (B + kThreads - 1) / kThreads;
    nw_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a0, (const uint32_t*)a1, (const uint32_t*)pb0,
        (const uint32_t*)pb1, (const int32_t*)n, (uint8_t*)carry,
        (uint32_t*)vp, (uint32_t*)vm, B, S);
  }
  return (int)cudaGetLastError();
}
