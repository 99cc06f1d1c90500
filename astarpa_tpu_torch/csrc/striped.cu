// Striped pinned-word big-band Myers edit distance, one template
// striped_kernel<kCk, kPP, kExact>: on the shared schedule kernels K5
// (costs), K6 (costs + 8-aligned-top checkpoints) and K8 (costs +
// checkpoints under the sliding kernel's contract), on per-pair schedules
// kernels K9 (costs) and K10 (costs + checkpoints under the per-pair sliding
// kernel's contract).  The instances: K5 <false, false, false>, K6 <true,
// false, false>, K8 <true, false, true>, K9 <false, true, false>, K10 <true,
// true, true>.  kExact, the third flag, picks the checkpoint rows: from the
// true window top (K8, K10) or from the 8-aligned one (K6).
//
// Which bands each instance serves: K6, K8, K9 and K10 take only bands of
// more live words than the resident rings of csrc/pinned.cu hold (4096:
// ring K6, ring K8, ring K9 and ring K10 take the shorter ones,
// ops/banded_kernel.py::ring_takes; config #5's pairs at full height, S =
// 15742, are such a band for K8), and K5 only bands of more than
// 16384 live words, which no configuration reaches: K7 and the wide ring
// there take the shorter ones (pinned_cost_takes).  Each ring computes the
// same function without the stripe ramps.
//
// They replace the TPU kernels astarpa_tpu/ops/striped.py::_striped_call (K5,
// entry striped_cost_tpu) and _striped_ck_call (K6, entry striped_ck_tpu),
// both running _striped_body, and astarpa_tpu/ops/pinned.py::_pinned_ck_call
// (K8, entry pinned_ck_tpu, running _pinned_body), _pinned_pp_call (K9, entry
// pinned_cost_pp_tpu) and _pinned_pp_ck_call (K10, entry pinned_ck_pp_tpu),
// both running _pinned_pp_body.  Their plain torch twins, and the plans whose
// per-word event steps this kernel reads, are in
// astarpa_tpu_torch/ops/striped.py and astarpa_tpu_torch/ops/pinned.py; the
// results must match them bit for bit.
//
// The DP: word w (absolute, 32 rows) runs column t - w at step t, taking the
// h carry and the column's char code that word w-1 produced at step t-1.
// Each word enters the band at ent_t[w] (its state restarts all-ones), is
// the band top at [top_t[w], abs_t[w]) (its input is the +1 carry and its
// char code is read from the code row), and leaves at abs_t[w], when its
// value joins the pair's top sum if its column is <= n-1.  At the pair's
// last column the banded words' values, masked to row m, are captured.
//
// Design: one block per pair; each thread holds kK consecutive words in
// registers (vp, vm, the two profile words, and the outputs the next word
// reads), so a thread's words are independent within a step.  The carry
// from word w-1 passes by warp shuffle between threads, through shared
// memory (double-buffered by step parity) between warps, with one barrier
// per step.  The band is cut into stripes of WS = blockDim.x * kK absolute
// words; the block runs stripe after stripe, each over the steps in which
// its words are in the band, and hands the bottom word's carry to the next
// stripe through a (B, T+1) byte plane in device memory (two planes
// alternate by stripe parity, as the TPU kernel's carA/carB).  So any band
// height runs, full height included.  A warp whose words are all outside
// the band in a step skips the step (the TPU kernel's dynamic group range).
// Profile words are loaded once per stripe.  The only per-step memory
// traffic is one byte of carry in and out per block and one code byte for
// the top word (pair-major codes, so consecutive steps hit one cache line).
//
// Checkpoints (kCk): word w of checkpoint k's true window [w0, w0+SW) is
// written at step k*CB - 1 + w into row w - (w0 & ~7) of (n_ck, SW+8, B)
// planes (K6), or row w - w0 of (n_ck, SW, B) planes (kExact: K8 with the
// bucket's window top, K10 with the pair's own); the thread holding w0
// writes top_val = the pair's absorbed sum so far + k*CB.  No word is
// absorbed at that step (absorb steps strictly rise by word), so the shared
// running sum is stable there.  Rows outside the true window are zero,
// checkpoint 0 is the all-ones state.  CB >= SW keeps the windows' steps
// apart; K8 also takes one window with CB < SW.  The TPU kernels stage the
// rows through 8-row VMEM tiles (so SW % 8 == 0 and B % 128 == 0 there);
// here each thread stores its own word's row, at any SW and B.
//
// Per-pair schedules (kPP): the event table and the stripe step ranges are
// per pair ((B, 4, nw_pad) and (B, n_stripes, 2), built on the card from the
// schedule), and each block runs its own pair's stripe count.  One block per
// pair keeps the state in registers and the carry in device memory, so the
// TPU kernel's cross-pair residency window and its VMEM ceiling have no
// counterpart here.
//
// What bounds it on an H100: integer throughput.  A word step takes at
// least 14 int32 instructions on sm_90 (the match word, the Myers step and
// the funnel-shifted carries), 64 lanes per SM per clock; memory traffic is
// the profile once per stripe and a few bytes per step.  The stripe ramps
// (words entering and leaving) keep part of a block's warps idle, the block
// waits at a barrier every step, and one block per pair fills at most B
// SMs.  On an H100 80GB HBM3 at 700 W (PERF.md): at config #5 (128 pairs of
// 500 kbp, SW=2048) a K5 rung runs at 4.2-4.4x that operation bound, K6's
// at 4.5x and K9's config #5 default round (SW=1152) at 7.1x, and K5 at
// SW=8192 (4 stripes of 4096 words) at 2.1-2.2x, where the ring kernels of
// csrc/pinned.cu now run them (K7 1.6x, the wide ring 1.4x); K8's
// full-height rung at config #4 (SW=3149) runs at 2.7x.  In cost mode K9 stops each pair's
// words at its own last column.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kW = 32;
constexpr int kInf = 1 << 30;
constexpr int kNever = 1 << 30;
constexpr int kK = 8;            // words per thread
constexpr int kMaxThreads = 512;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t pack_aux(uint32_t a0, uint32_t a1,
                                             uint32_t hp, uint32_t hm) {
  return (a0 & 1u) | (a1 & 2u) | (hp << 2) | (hm << 3);
}

template <bool kCk, bool kPP, bool kExact>
__global__ void __launch_bounds__(kMaxThreads) striped_kernel(
    const uint8_t* __restrict__ code, const uint32_t* __restrict__ pb0,
    const uint32_t* __restrict__ pb1, const int32_t* __restrict__ n,
    const int32_t* __restrict__ m, const int32_t* __restrict__ loend,
    const int32_t* __restrict__ ev, const int32_t* __restrict__ stripe_t,
    const int32_t* __restrict__ nsp, uint8_t* carry,
    int32_t* __restrict__ out, uint32_t* __restrict__ ck_vp,
    uint32_t* __restrict__ ck_vm, int32_t* __restrict__ ck_tv,
    const int32_t* __restrict__ ckw0, int n_max, int B, int S, int SW,
    int nw_pad, int n_stripes, int T, int CB, int n_ck) {
  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int NT = blockDim.x;
  const int WS = NT * kK;
  const int np = n[p];
  const int mp = m[p];
  const int le = loend[p];
  if (kPP) {
    ev += (size_t)p * 4 * nw_pad;
    stripe_t += (size_t)p * 2 * n_stripes;
  }
  const int my_stripes = kPP ? nsp[p] : n_stripes;
  const int32_t* ent_t = ev;
  const int32_t* top_t = ev + nw_pad;
  const int32_t* abs_t = ev + 2 * nw_pad;
  const int32_t* end_t = ev + 3 * nw_pad;
  const uint8_t* cp = code + (size_t)p * n_max;

  __shared__ uint32_t s_aux[2][kMaxThreads / 32];
  __shared__ int s_acc;  // the pair's alive absorbed values so far
  __shared__ int s_cap;

  if (tid == 0) {
    s_acc = 0;
    s_cap = 0;
  }
  const int SWP = kExact ? SW : SW + 8;  // plane rows
  if (kCk) {
    for (int i = tid; i < n_ck * SWP; i += NT) {
      const int k = i / SWP;
      const int row = i - k * SWP;
      const size_t o = ((size_t)k * SWP + row) * B + p;
      if (k == 0) {
        ck_vp[o] = ~0u;
        ck_vm[o] = 0u;
      } else {
        // K6's rows outside the true window stay zero; the DP writes the
        // others after the barrier below (all of K8's and K10's rows).
        const int off = kExact ? 0 : ckw0[k] & 7;
        if (kExact || row < off || row >= off + SW) {
          ck_vp[o] = 0u;
          ck_vm[o] = 0u;
        }
      }
    }
    if (tid == 0) ck_tv[p] = 0;
  }
  __syncthreads();

  int cap = 0;  // this thread's captured values
  for (int s = 0; s < my_stripes; ++s) {
    const int w0 = s * WS + tid * kK;  // this thread's first word
    const uint8_t* cin = carry + ((size_t)((s + 1) & 1) * B + p) * (T + 1);
    uint8_t* cout = carry + ((size_t)(s & 1) * B + p) * (T + 1);
    uint32_t vp[kK], vm[kK], p0[kK], p1[kK];
    // Outputs of each word's last step: the code masks of its column and
    // its h carries (0/1).  Word j reads word j-1's.
    uint32_t xa0[kK], xa1[kK], xhp[kK], xhm[kK];
#pragma unroll
    for (int j = 0; j < kK; ++j) {
      const int r = min(w0 + j, S - 1);
      p0[j] = pb0[(size_t)r * B + p];
      p1[j] = pb1[(size_t)r * B + p];
      vp[j] = ~0u;
      vm[j] = 0u;
      xa0[j] = xa1[j] = xhp[j] = xhm[j] = 0u;
    }
    int ent_j = 0, abs_j = 0;
    int ent_next = ent_t[w0];
    int abs_next = abs_t[w0];
    const int top_lo = top_t[w0];
    const int top_hi = abs_t[w0 + kK - 1];
    // The warp works while any of its words is in the band: entries and
    // ends rise with the word, so [first entry, last end).
    const int warp_t0 = __reduce_min_sync(kFull, ent_t[w0]);
    const int warp_t1 = __reduce_max_sync(kFull, end_t[w0 + kK - 1]);
    const int t0 = stripe_t[2 * s];
    const int t1 = stripe_t[2 * s + 1];
    int ckr = 0;  // (t + 1 - w0) mod CB: word ckr ends a checkpoint column
    if (kCk) ckr = ((t0 + 1 - w0) % CB + CB) % CB;
    uint32_t last_aux = 0;     // packed outputs of word kK-1, last step
    int cin_at = -1;           // step whose carry cin_val holds
    uint32_t cin_val = 0;
    for (int t = t0; t < t1; ++t) {
      if (t >= warp_t0 && t < warp_t1) {
        // Word 0's input: word w0-1's outputs from step t-1.
        uint32_t up = __shfl_up_sync(kFull, last_aux, 1);
        if (lane == 0) {
          if (warp > 0) {
            up = s_aux[(t - 1) & 1][warp - 1];
          } else if (s > 0) {
            if (cin_at != t) cin_val = cin[t];
            up = cin_val;
            cin_val = t + 1 <= T ? cin[t + 1] : 0u;  // prefetch
            cin_at = t + 1;
          } else {
            up = 0u;  // word 0 of the band is the top while it is in it
          }
        }
        uint32_t in_a0 = 0u - (up & 1u);
        uint32_t in_a1 = 0u - ((up >> 1) & 1u);
        uint32_t in_hp = (up >> 2) & 1u;
        uint32_t in_hm = (up >> 3) & 1u;
        if (t == ent_next) {
#pragma unroll
          for (int j = 0; j < kK; ++j) {
            if (j == ent_j) {
              vp[j] = ~0u;
              vm[j] = 0u;
            }
          }
          ++ent_j;
          ent_next = ent_j < kK ? ent_t[w0 + ent_j] : kNever;
        }
        const bool was_abs = t == abs_next;
        if (was_abs) {
          int val = 0;
#pragma unroll
          for (int j = 0; j < kK; ++j) {
            if (j == abs_j) val = __popc(vp[j]) - __popc(vm[j]);
          }
          if (t - (w0 + abs_j) <= np - 1) s_acc += val;
          ++abs_j;
          abs_next = abs_j < kK ? abs_t[w0 + abs_j] : kNever;
        }
        if (!was_abs && t >= top_lo && t < top_hi) {
          // Word abs_j is the top: +1 carry and its own column's code, set
          // as the outputs of the (absorbed) word above it.
          const int c = t - (w0 + abs_j);
          const uint32_t cc = c < n_max ? cp[c] : 0u;
          const uint32_t a0 = 0u - (cc & 1u);
          const uint32_t a1 = 0u - ((cc >> 1) & 1u);
          if (abs_j == 0) {
            in_a0 = a0;
            in_a1 = a1;
            in_hp = 1u;
            in_hm = 0u;
          }
#pragma unroll
          for (int j = 1; j < kK; ++j) {
            if (j == abs_j) {
              xa0[j - 1] = a0;
              xa1[j - 1] = a1;
              xhp[j - 1] = 1u;
              xhm[j - 1] = 0u;
            }
          }
        }
        // Words from the bottom up, so word j still sees word j-1's
        // outputs of step t-1.
#pragma unroll
        for (int j = kK - 1; j >= 0; --j) {
          const uint32_t a0 = j ? xa0[j - 1] : in_a0;
          const uint32_t a1 = j ? xa1[j - 1] : in_a1;
          const uint32_t hp = j ? xhp[j - 1] : in_hp;
          const uint32_t hm = j ? xhm[j - 1] : in_hm;
          const uint32_t eq = (a0 ^ p0[j]) & (a1 ^ p1[j]);
          const uint32_t v = vp[j];
          const uint32_t vx = eq | vm[j];
          const uint32_t eq2 = eq | hm;
          const uint32_t hx = (((eq2 & v) + v) ^ v) | eq2;
          uint32_t hpo = vm[j] | ~(hx | v);
          uint32_t hmo = v & hx;
          xhp[j] = hpo >> (kW - 1);
          xhm[j] = hmo >> (kW - 1);
          hpo = (hpo << 1) | hp;
          hmo = (hmo << 1) | hm;
          vp[j] = hmo | ~(vx | hpo);
          vm[j] = hpo & vx;
          xa0[j] = a0;
          xa1[j] = a1;
        }
        last_aux = pack_aux(xa0[kK - 1], xa1[kK - 1], xhp[kK - 1], xhm[kK - 1]);
        if (lane == 31) s_aux[t & 1][warp] = last_aux;
        if (tid == NT - 1 && s + 1 < my_stripes) cout[t + 1] = (uint8_t)last_aux;
        // Cost capture: word t+1-n finishes column n-1 now.
        const int wc = t + 1 - np;
        if (np > 0 && (unsigned)(wc - w0) < (unsigned)kK && wc >= le &&
            wc < le + SW) {
          int full = mp - wc * kW;
          full = full < 0 ? 0 : (full > kW ? kW : full);
          const uint32_t mask = full >= kW ? ~0u : (1u << full) - 1u;
#pragma unroll
          for (int j = 0; j < kK; ++j) {
            if (j == wc - w0) cap += __popc(vp[j] & mask) - __popc(vm[j] & mask);
          }
        }
        // Words ckr, ckr + CB, ... of this thread end a checkpoint column
        // (one at most once CB >= kK).
        for (int r = kCk ? ckr : kK; r < kK; r += CB) {
          const int w = w0 + r;
          const int k = (t + 1 - w) / CB;
          if (t + 1 - w > 0 && k < n_ck) {
            const int w0k = kPP ? ckw0[(size_t)k * B + p] : ckw0[k];
            if (w >= w0k && w < w0k + SW) {
              uint32_t xv = 0u, xm = 0u;
#pragma unroll
              for (int j = 0; j < kK; ++j) {
                if (j == r) {
                  xv = vp[j];
                  xm = vm[j];
                }
              }
              const int row = kExact ? w - w0k : w - (w0k & ~7);
              const size_t o = ((size_t)k * SWP + row) * B + p;
              ck_vp[o] = xv;
              ck_vm[o] = xm;
              if (w == w0k) ck_tv[(size_t)k * B + p] = s_acc + k * CB;
            }
          }
        }
      }
      if (kCk) ckr = ckr + 1 == CB ? 0 : ckr + 1;
      __syncthreads();
    }
  }
  if (cap) atomicAdd(&s_cap, cap);
  __syncthreads();
  if (tid == 0) {
    const bool covered = mp - le * kW <= SW * kW;
    out[p] = covered ? s_acc + s_cap + np : kInf;
  }
}

template <bool kCk, bool kPP, bool kExact>
int launch(const void* code, const void* pb0, const void* pb1, const void* n,
           const void* m, const void* loend, const void* ev,
           const void* stripe_t, const void* nsp, void* carry, void* out,
           void* ck_vp, void* ck_vm, void* ck_tv, const void* ckw0, int n_max,
           int B, int S, int SW, int nw_pad, int n_stripes, int T,
           int threads, int CB, int n_ck, void* stream) {
  if (threads < 32 || threads > kMaxThreads || threads % 32 ||
      nw_pad != n_stripes * threads * kK || (kCk && CB < 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (B > 0) {
    striped_kernel<kCk, kPP, kExact><<<B, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)code, (const uint32_t*)pb0, (const uint32_t*)pb1,
        (const int32_t*)n, (const int32_t*)m, (const int32_t*)loend,
        (const int32_t*)ev, (const int32_t*)stripe_t, (const int32_t*)nsp,
        (uint8_t*)carry, (int32_t*)out, (uint32_t*)ck_vp, (uint32_t*)ck_vm,
        (int32_t*)ck_tv, (const int32_t*)ckw0, n_max, B, S, SW, nw_pad,
        n_stripes, T, CB, n_ck);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// C entries for ctypes.  All arrays are device pointers: code (B, n_max)
// uint8 char codes (pair-major); pb0/pb1 (S, B); n, m, loend (B,) int32; ev
// (4, nw_pad) int32 per-word ent_t, top_t, abs_t and end_t (the step after
// the word's last useful step); stripe_t (n_stripes, 2) int32 step ranges;
// carry (2, B, T+1) uint8 scratch; out (B,) int32.  The shared ck entries
// also write ck_vp/ck_vm, (n_ck, SW+8, B) (striped_ck) or (n_ck, SW, B)
// (pinned_ck), and ck_tv (n_ck, B) from ckw0 (n_ck,) window tops.  The
// per-pair entries take ev (B, 4, nw_pad), stripe_t (B, n_stripes, 2) and
// nsp (B,) int32 stripe counts, and the ck one writes (n_ck, SW, B) planes
// from ckw0 (n_ck, B).  `threads` is the block size (a
// multiple of 32, <= 512); nw_pad = n_stripes * threads * 8.  Each launches
// on `stream` without synchronising and returns cudaGetLastError() (0 on
// success).
extern "C" {

int astarpa_striped_cost(const void* code, const void* pb0, const void* pb1,
                         const void* n, const void* m, const void* loend,
                         const void* ev, const void* stripe_t, void* carry,
                         void* out, int n_max, int B, int S, int SW,
                         int nw_pad, int n_stripes, int T, int threads,
                         void* stream) {
  return launch<false, false, false>(code, pb0, pb1, n, m, loend, ev,
                                     stripe_t, nullptr, carry, out, nullptr,
                                     nullptr, nullptr, nullptr, n_max, B, S,
                                     SW, nw_pad, n_stripes, T, threads, 1, 0,
                                     stream);
}

int astarpa_striped_ck(const void* code, const void* pb0, const void* pb1,
                       const void* n, const void* m, const void* loend,
                       const void* ev, const void* stripe_t, void* carry,
                       void* out, void* ck_vp, void* ck_vm, void* ck_tv,
                       const void* ckw0, int n_max, int B, int S, int SW,
                       int nw_pad, int n_stripes, int T, int threads, int CB,
                       int n_ck, void* stream) {
  return launch<true, false, false>(code, pb0, pb1, n, m, loend, ev,
                                    stripe_t, nullptr, carry, out, ck_vp,
                                    ck_vm, ck_tv, ckw0, n_max, B, S, SW,
                                    nw_pad, n_stripes, T, threads, CB, n_ck,
                                    stream);
}

int astarpa_pinned_ck(const void* code, const void* pb0, const void* pb1,
                      const void* n, const void* m, const void* loend,
                      const void* ev, const void* stripe_t, void* carry,
                      void* out, void* ck_vp, void* ck_vm, void* ck_tv,
                      const void* ckw0, int n_max, int B, int S, int SW,
                      int nw_pad, int n_stripes, int T, int threads, int CB,
                      int n_ck, void* stream) {
  return launch<true, false, true>(code, pb0, pb1, n, m, loend, ev, stripe_t,
                                   nullptr, carry, out, ck_vp, ck_vm, ck_tv,
                                   ckw0, n_max, B, S, SW, nw_pad, n_stripes, T,
                                   threads, CB, n_ck, stream);
}

int astarpa_pinned_cost_pp(const void* code, const void* pb0, const void* pb1,
                           const void* n, const void* m, const void* loend,
                           const void* ev, const void* stripe_t,
                           const void* nsp, void* carry, void* out, int n_max,
                           int B, int S, int SW, int nw_pad, int n_stripes,
                           int T, int threads, void* stream) {
  return launch<false, true, false>(code, pb0, pb1, n, m, loend, ev,
                                    stripe_t, nsp, carry, out, nullptr,
                                    nullptr, nullptr, nullptr, n_max, B, S,
                                    SW, nw_pad, n_stripes, T, threads, 1, 0,
                                    stream);
}

int astarpa_pinned_ck_pp(const void* code, const void* pb0, const void* pb1,
                         const void* n, const void* m, const void* loend,
                         const void* ev, const void* stripe_t,
                         const void* nsp, void* carry, void* out, void* ck_vp,
                         void* ck_vm, void* ck_tv, const void* ckw0,
                         int n_max, int B, int S, int SW, int nw_pad,
                         int n_stripes, int T, int threads, int CB, int n_ck,
                         void* stream) {
  return launch<true, true, true>(code, pb0, pb1, n, m, loend, ev, stripe_t,
                                  nsp, carry, out, ck_vp, ck_vm, ck_tv, ckw0,
                                  n_max, B, S, SW, nw_pad, n_stripes, T,
                                  threads, CB, n_ck, stream);
}

}  // extern "C"
