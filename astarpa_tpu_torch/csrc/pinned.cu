// Resident-ring pinned-word Myers edit distance: pinned_ring_kernel<kCk,
// kPP>, ring K6 (costs + 8-aligned-top checkpoints on the shared schedule,
// <true, false>) and ring K9 (costs on per-pair schedules, <false, true>);
// and one leaner step, ring_body<kS, kMode>, in eight kernels:
// ring_cost_kernel<kS>, costs on the shared schedule (K7, kS = 0, 8
// register slots a thread; the wide ring, kS = 8 or 24 further slots a
// thread in shared memory), ring_ck_pp_kernel, ring K10 (costs + K4's
// checkpoint rows on per-pair schedules), ring_ck_exact_kernel, ring K8
// (ring K10 on the shared schedule: costs + K2's checkpoint rows from the
// true window top), banded_ring_kernel, K1 (the shared schedule's costs
// under K1's result rule, small bands), banded_ring_pp_kernel and
// banded_ring_ck_pp_kernel, K4 (K1's rings on per-pair schedules: costs,
// and costs + K4's checkpoints), banded_ring_ck_kernel, K2 (K4's
// checkpoint ring on the shared schedule) and banded_ring_fill_kernel, K3
// (K1's rings storing every column's window).
//
// They replace the TPU kernels astarpa_tpu/ops/pinned.py::_pinned_shared_call
// (K7, entry pinned_cost_tpu, running _pinned_kernel / _pinned_body),
// astarpa_tpu/ops/striped.py::_striped_call (K5, entry striped_cost_tpu, on
// the bands the wide ring holds), astarpa_tpu/ops/striped.py::_striped_ck_call
// (K6, entry striped_ck_tpu, running _striped_body),
// astarpa_tpu/ops/pinned.py::_pinned_pp_call (K9, entry pinned_cost_pp_tpu,
// running _pinned_pp_body), _pinned_pp_ck_call (K10, entry
// pinned_ck_pp_tpu), _pinned_ck_call (K8, entry pinned_ck_tpu, on the
// bands the register ring holds) and
// astarpa_tpu/ops/pallas_banded.py::_banded_call in EMIT_COST mode on the
// shared schedule (K1, entry banded_cost_tpu), in EMIT_CK mode on the
// shared schedule (K2, banded_ck_tpu), in _kernel_perpair's cost and ck modes (K4, banded_cost_tpu and
// banded_ck_tpu with schedule=) and in EMIT_FILL mode on the shared
// schedule (K3, banded_fill_tpu).  K7's function is K5's (csrc/striped.cu, the
// reference holds pinned_cost_tpu == striped_cost_tpu), so its plain torch
// twin is astarpa_tpu_torch/ops/striped.py::pinned_cost_ref, the striped
// sweep; ring K6's is striped.py::striped_ck_ref, ring K9's
// astarpa_tpu_torch/ops/pinned.py::pinned_cost_pp_ref, ring K10's
// pinned.py::pinned_ck_pp_ref, ring K8's striped.py::pinned_ck_ref, K2's
// banded.py::banded_ck_ref, K1's ops/banded.py::banded_cost_ref (its
// staggered twin: striped.py::banded_cost_staggered_ref), K4's
// banded.py::banded_cost_pp_ref and banded_ck_pp_ref (staggered twins:
// pinned.py::banded_cost_pp_staggered_ref, banded_ck_pp_staggered_ref) and
// K3's banded.py::banded_fill_ref (striped.py::banded_fill_staggered_ref).  The results
// must match them bit for bit, and match the stripe kernels of
// csrc/striped.cu (striped_kernel<false>, <true>, <false, true>, <true,
// true, true> and <true, false, true>), which take the bands past the
// rings.  The per-word event steps come from the same host plans
// (ops/striped.py::plan_striped, ops/pinned.py::plan_pp).
//
// Which bands each serves (ops/banded_kernel.py): ring K6, ring K8, ring K9
// and ring K10 up to 4096 live words (ring_takes), K2's ring every
// interval its row cursor takes (CB >= SW, or one capture window) on bands
// of up to 2048 words (k2_kernel), K7 every shared cost rung of
// up to 4096 live words and the wide ring those of 4097 to 16384
// (pinned_cost_takes, ring_cost_layout: 16 slots a thread up to 8192, 32
// up to 16384), K1 every shared cost rung below 64 words (the runner's
// STRIPED_MIN_SW; any band up to 4096 live words when called directly).
//
// The DP is K5's: word w (absolute, 32 rows) runs column t - w at step t,
// taking the h carry and the column's char code that word w-1 produced at
// step t-1.  Word w enters the band at ent_t[w] (its state restarts
// all-ones), is the band top at [top_t[w], abs_t[w]) (its input is the +1
// carry and its own column's code), and is absorbed at abs_t[w], when its
// value joins the pair's top sum if its column is <= n-1.  At the pair's
// last column the banded words' values, masked to row m, are captured.
//
// Design: one block per pair; each thread holds kK = 8 consecutive slots in
// registers (vp, vm, the two profile words, and the outputs the next slot
// reads).  The block's RW = threads * 8 slots form a ring: slot j holds the
// word w = j (mod RW) that is next to finish.  A word is live from ent_t to
// end_t (the step after its absorb, or after its column n_lim - 1); both
// rise strictly with w, so the live words are a contiguous run, and the
// host sizes the ring to hold the longest run (ops/striped.py::ring_span,
// ops/pinned.py::ring_span_pp).
// When a slot's word is done the slot takes word w + RW at that word's
// entry: its state restarts and its profile words come from a register the
// thread prefetched at its previous entry.  The carry from the slot above
// passes by warp shuffle within a warp and through shared memory
// (double-buffered by step parity, one barrier a step) between warps; the
// ring's one new link is the wrap, slot RW-1 feeding slot 0.  A ring of one
// warp (ring K6 and ring K9 at 256 words) passes the wrap by shuffle too
// and needs no block barrier, only __syncwarp().  Each thread
// walks its own words in order (lap by lap) with three event pointers:
// next to enter, next to absorb (and its top range).  A top event of a word
// past its column n_lim - 1 is dropped: its slot may already hold the word
// RW below it.  The block sweeps steps 0 .. once and stops after its own
// pair's last capture (and, for ring K6, after the last checkpoint's last
// word); there is no stripe loop and no carry plane in device memory.  Any
// B, any SW.
//
// Checkpoints (ring K6, kCk): word w of checkpoint k's true window [w0k, w0k
// + SW), w0k = lo(k*CB - 1), ends column k*CB - 1 at step k*CB - 1 + w and
// is written there into row w - (w0k & ~7) of (n_ck, SW+8, B) planes; the
// thread holding w0k writes ck_tv = the pair's absorbed sum so far + k*CB.
// CB >= SW + 8 keeps the windows' steps apart, so one word of the block is
// taken a step, and every thread follows the same (k, word, slot) cursor.
// Rows outside the true window are zero, checkpoint 0 is the all-ones
// state.  The sweep runs to n_lim = n_max, where the rows are defined, and
// the ring is sized for that (ring_span(plan, n_max) never exceeds SW).
// Word w is live at its checkpoint step (it has entered: w > lo(k*CB - 1) -
// SW; it is not absorbed: w >= lo(k*CB - 1)), and word w + RW has not
// entered yet (the live run would exceed the ring).  No word is absorbed at
// the step the top word is taken (absorb steps rise strictly with the word,
// word w0k - 1 is absorbed by step k*CB - 2 + w0k, word w0k after step k*CB
// - 1 + w0k), and the barrier of the step before publishes every earlier
// absorb, so the shared running sum read there is stable and complete.
//
// Per-pair schedules (ring K9, kPP): each block offsets a (B, 3, nw_pad)
// table of ent/top/abs steps by its pair, and sweeps to its own pair's last
// capture with n_lim = max(n, 1); it needs no end_t row and no stripe
// ranges.
//
// The cost kernel (ring_cost_kernel) keeps the slots and the ring but not
// pinned_ring_kernel's step, which issued 202 instructions a thread-step
// for the 8 slots' 112 (ops/sass_count.py --ring): 144 word ALU (each carry
// shifted out and back in), 20 moves, 13 tests, 19 control.  Its step: the
// word step with funnel-shifted carry words (14 instructions), split
// between the ALU and FMA pipes (word_step_split, 12 and 2); the loop
// unrolled by 8 so that the char masks pass down the slots by register
// naming (A0/A1 hold slot 0's inputs of the last 8 steps; slot j reads the
// one of step t - j); one compare a step against the thread's next event
// (enter, absorb, capture, re-arm, memory mode) with the event work out of
// line; the link as four shuffles and, between warps, one 16-byte store and
// load.  The band top costs its thread a few instructions a step: its
// char codes enter slot 0 from memory (memory mode, from the step the
// thread's slot-0 word is the top), and its +1 carry comes from the slot
// above, which is armed (vp = 0, vm = ~0: its carry words' top bits stay 1
// and 0 for 32 steps whatever its inputs) when its word is absorbed.  Only
// when a word of the next lap has entered the top's thread (the ring almost
// full) does the top thread write the top slot's inputs each step.  No
// block barrier in a one-warp ring.  The wide ring's shared slots are laid
// out [slot][thread] (state and profile apart, 8 bytes a thread: a warp
// reads consecutive words); their char masks ride in two registers of bits
// (C0, C1) and their carries in two more (Php, Phm: each slot pops its input
// at the top and pushes its output at the bottom), and its register slots'
// profiles live in shared memory too; its dynamic shared memory (96 KB or
// 224 KB) is granted before each launch.
//
// What bounds it on an H100: integer dispatch.  A word step takes at least
// 14 int32 instructions on sm_90's ALU pipe alone (the match word, the
// Myers step and the funnel-shifted carries; ops/sass_count.py), 16 lanes
// a sub-partition, 64 an SM; IMAD runs on the FMA pipe's 16 lanes
// beside it, and ptxas already puts word_step's add there (13 and 1).  K5
// cuts the band into stripes of threads * 8 words and runs them
// one after another, each from its first word's entry to its last word's
// end: about (stripe + SW) / slope steps for SW / slope useful ones, so at
// config #5 (SW = 2048, 256 threads) it runs ~2 T block steps for T ~
// n_max + S and half its warps only skip and wait at the barrier.  The ring
// keeps every slot on a live word in the steady state (the live run is
// about SW words), so it runs the T steps once with all warps busy: it
// removes K5's stripe ramps.  What is left is the latency of a step: the
// hand-off of the carry, the barrier and the per-step event, top, capture
// and checkpoint tests.  On an H100 80GB HBM3 at 700 W (PERF.md) ring K6
// takes 2.57x its operation bound on config #5's align rung (the stripe K6
// 4.47x) and ring K9 4.4x on config #5 default's round (the stripe K9
// 7.1x).  Handing the carry from warp to warp by flags in shared memory
// instead of the barrier ran ring K9 1.18x slower on that round, so the
// barrier stays.  Memory traffic is each word's profile once (and the wide
// ring's shared slots, 24 bytes a slot-step), the event steps, one code
// byte a step for the top word, and ring K6's checkpoint rows, one 4-byte
// word of each plane a step.  On the same card the cost kernel's step
// runs 147 instructions a thread-step (K7 in pinned_ring_kernel ran
// 202): with word_step_split 103.1 of its word classes on the ALU pipe and
// 18.1 on the FMA pipe (111.1 and 10.1 with word_step).  K7 runs config
// #5's SW = 2048 rung in ~169-172 ms (1.55x its bound; ~174-175 ms with
// word_step, 248 ms in pinned_ring_kernel), ~327-330 ns a step
// (ops/ring_step.py: ~285 ns without the band top's inputs or any event
// code, ~210 ns also without the link and barrier; ~337, ~313 and ~218 ns
// with word_step), and the wide ring its SW = 8192 rung in ~585 ms (1.33x;
// ~611 ms with word_step, K5's stripes 933-940 ms).  The full split (10
// ALU-pipe and 5 FMA-pipe instructions a word step, the carry bits from
// IMAD.HI) ran no faster than word_step: an IMAD.HI takes more of a step
// than the SHF it replaces.
//
// Ring K10 (ring_ck_pp_kernel) is K7's step on per-pair event rows (each
// block offsets a (B, 3, nw_pad) table by its pair), swept to n_lim =
// n_max, where the checkpoint rows are defined (the ring is sized for
// that, ops/pinned.py::ring_span_pp at n_max).  Checkpoint k's true window
// is [w0k, w0k + SW), w0k = lo_p(k*CB - 1); word w of it ends column k*CB -
// 1 at step k*CB - 1 + w and is written into row w - w0k of (n_ck, SW, B)
// planes, read before the next step as a capture is.  Each thread walks
// its own words of the windows in order (ck_seek, ck_take), an event like
// any other, so the store stays out of the word loop.  CB >= SW keeps the
// windows' steps apart: window k's last word is taken at step k*CB - 2 +
// w0k + SW <= (k+1)*CB - 2 + w0(k+1) < (k+1)*CB - 1 + w0(k+1), window k+1's
// first (w0 rises with k), so one word of the block is taken a step and a
// thread's cursor meets the windows in time order.  A taken word is live
// (it entered before column k*CB - 1 and is absorbed after it, both at
// steps rising with the word), and word w + RW has not entered its slot
// before the read (the live run never exceeds the ring).  The top value
// ck_tv[k] = k*CB + the values absorbed from the words above w0k: the
// words are absorbed in order, all those above w0k before step k*CB - 1 +
// w0k and none below, so each thread adds its own absorbed sum to
// checkpoint k (an atomic) when it absorbs its first word at or below
// w0k, or at the end; no shared running sum and no barrier are needed,
// and a one-warp ring (config #4's SW = 192) keeps none.  On an H100 80GB
// HBM3 at 700 W ring K10 takes config #5 default's checkpoint round in
// ~194 ms (3.1x its bound; the stripe K10 ~463 ms) and config #4's in ~27
// ms (the stripe K10 ~90 ms).
//
// K1 (banded_ring_kernel) is K7's step on the shared schedule with K1's
// result rule (a pair with n == 0 costs m; row m above the window gives
// the absorbed sum plus n, below it INF).  Its bands are small (the
// runner sends it rungs below 64 words), so a ring is a few lanes of a
// warp: 8 slots a lane, the fewest lanes (a power of two) whose slots hold
// the live words and one more (a full ring keeps its top on the slow
// path, which measured slower than twice the slots), 32 / lanes pairs a
// one-warp block.  The link between lanes is a full-warp shuffle from the
// lane above in the pair's group; the rings of a warp share the schedule,
// so their events fall on the same steps but the capture at each pair's
// own last column, and they step to the warp's last capture.  Bands of 256
// live words or more take a block a pair, as K7.  On the same card it
// runs the 4096 x 10 kbp pack at SW = 32 in ~4-7 ms against the old
// one-thread-a-pair K1's 27 ms (its bound 1.1 ms).  A shared schedule
// shifted at column 0 (a diagonal steeper than a word a column from the
// start) absorbs word 0 at its entry: word 0 is never the top, so slot 0
// reads the column codes from step 0 for the band top below it.  K1's
// layout (K1, K2, K3, K4) and ring K8 start so.  Built into K7 and the
// wide ring, that start spilled 8 bytes in both wide rings (ptxas -v on the
// H100, PERF.md), so their builds leave it out and their wrapper
// (ops/banded_kernel.py::_launch_ring_cost) runs such a schedule on the
// band one word down: word 0 is absorbed at step 0, column 0, so words 1..
// at steps 1.. are words 0.. at steps 0.. of the band on rows 32.. (the
// same columns), and each pair with a column adds word 0's all-ones value,
// 32, back.  The runner's buckets reach such a schedule only when every a
// holds one character.
//
// K4 (banded_ring_pp_kernel, banded_ring_ck_pp_kernel) is K1's ring on
// each pair's own event rows, as ring K10 reads them, with K1's result rule
// (K9's staggered DP computes K4's function: each word's profile row is
// clamped at S - 1 as K4 clamps its entering word, and no word runs below
// the band bottom).  The rings of a warp no longer share event steps, so
// their event work diverges within the warp; it stays out of line, one
// compare a step.  Each pair's words stop after its own last column
// (n_lim = n), and the warp steps to its last pair's capture.  Checkpoints
// at or before the pair's end (k*CB <= n) take ring K10's cursor; K4's
// checkpoints past the end hold the window after column n - 1, slid down
// the schedule (no word steps a column >= n): a word of it below the
// capture window's bottom (loend + SW) has its state after column n - 1,
// which its capture writes into each such checkpoint's row, and a word
// entering later is all-ones, written at the start.  Their top values are
// n plus every value absorbed above the window top, past the end too: the
// threads' absorbed sums (as ring K10's), 32 for each word above the top
// that entered after the end (at the start), and each captured word's
// value above the top (an atomic at its capture).  So the ring sweeps no
// pair past its last capture and holds the live words of that sweep
// (ring_span_pp at each pair's n).  A schedule may shift at column 0.
//
// K3 (banded_ring_fill_kernel) is K1's ring storing, each step, each
// register slot's word state after its column c into row c, position
// word - lo(c) of the planes, while the word is in the window and c is
// below the pair's n: pair-major planes (B, n_max, SW), at offset word +
// R(c) from the pair's base (p * n_max * SW, in 64 bits), R(c) = c * SW -
// lo(c) from a table.  A slot's word and its last stored step are set at
// its entry.  Rows past a pair's end are its row n -
// 1 slid down the schedule (words entering later all-ones), copied after
// the sweep by the ring's threads.
//
// Ring K8 (ring_ck_exact_kernel) is ring K10 on the shared schedule's event
// rows and window tops (one (3, nw_pad) table and one (n_ck,) row of tops
// for every block): the same cursor, top values and sweep to n_lim =
// n_max, K5's costs, checkpoints under K2's rows from the true window top,
// n_ck = n_max / CB + 1.  Its ring is sized as ring K6's
// (ops/striped.py::ring_span at n_max).  CB >= SW keeps the windows'
// steps apart; a single capture window (n_ck <= 2) needs nothing of CB,
// as in a skewed bucket where n_max clamps CB below SW.  It replaces the
// stripe K8 (csrc/striped.cu) on every band the register ring holds: config
// #4's full height (SW = S = 3149, off the 8-grain, where ring K6 cannot
// go) runs one pass of 3149 live words in 416 threads.  There the windows
// cover SW of every CB columns' steps (77% at CB = 4096), and each step of
// a window sends one thread through the event code; ring K10's cursor
// alone took ~80 ms on that rung against K7's ~56 ms.  So ring K8 keeps
// the next event step but the cursor's (ev_rest, one register: 128, no
// spills) and a step whose only due event is a row take runs ck_take
// alone (~62 ms; PERF.md).
//
// K2 (banded_ring_ck_kernel) is K4's checkpoint ring on the shared
// schedule: K1's rings (several pairs a warp, each on the same event rows)
// writing K4's rows, which are K2's: checkpoint k is the window after
// column k*CB - 1, ceil(n_max / CB) of them; at or before a pair's end the
// row cursor writes them, past it each captured word's state and value
// and the all-ones words entering after the end (K2 slides a finished
// lane's frozen window, as K4 does).  Each pair stops after its own last
// capture, as K4's.  One capture window below SW (n_ck <= 2) is taken;
// several are refused (the old K2 in csrc/banded.cu takes them).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kW = 32;
constexpr int kInf = 1 << 30;
constexpr int kNever = 1 << 30;
constexpr int kK = 8;            // slots per thread
constexpr int kMaxThreads = 512;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t pack_aux(uint32_t a0, uint32_t a1,
                                             uint32_t hp, uint32_t hm) {
  return (a0 & 1u) | (a1 & 2u) | (hp << 2) | (hm << 3);
}

// The word a thread's sequence index q names: lap q / 8, slot q % 8.
__device__ __forceinline__ int next_word(int w, int q, int RW) {
  return (q & (kK - 1)) ? w + 1 : w + RW - (kK - 1);
}

template <bool kCk, bool kPP>
__global__ void __launch_bounds__(kMaxThreads) pinned_ring_kernel(
    const uint8_t* __restrict__ code, const uint32_t* __restrict__ pb0,
    const uint32_t* __restrict__ pb1, const int32_t* __restrict__ n,
    const int32_t* __restrict__ m, const int32_t* __restrict__ loend,
    const int32_t* __restrict__ ev, int32_t* __restrict__ out,
    uint32_t* __restrict__ ck_vp, uint32_t* __restrict__ ck_vm,
    int32_t* __restrict__ ck_tv, const int32_t* __restrict__ ckw0, int n_max,
    int B, int S, int SW, int nw_pad, int n_lim, int CB, int n_ck) {
  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int NT = blockDim.x;
  const int RW = NT * kK;
  const int last_warp = (NT >> 5) - 1;
  // A ring of one warp passes the wrap by shuffle and needs no barrier.
  const bool solo = (kCk || kPP) && NT == 32;
  const int np = n[p];
  const int mp = m[p];
  const int le = loend[p];
  if (kPP) {
    ev += (size_t)p * 3 * nw_pad;
    n_lim = max(np, 1);  // each pair's words stop after its own last column
  }
  const int32_t* ent_t = ev;
  const int32_t* top_t = ev + nw_pad;
  const int32_t* abs_t = ev + 2 * nw_pad;
  const uint8_t* cp = code + (size_t)p * n_max;

  __shared__ uint32_t s_aux[2][kMaxThreads / 32];
  __shared__ int s_acc;  // the pair's alive absorbed values so far
  __shared__ int s_cap;

  if (tid == 0) {
    s_acc = 0;
    s_cap = 0;
  }
  if (tid < kMaxThreads / 32) {
    s_aux[0][tid] = 0u;
    s_aux[1][tid] = 0u;
  }
  const int SWP = SW + 8;  // ring K6's plane rows
  if (kCk) {
    for (int i = tid; i < n_ck * SWP; i += NT) {
      const int k = i / SWP;
      const int row = i - k * SWP;
      const size_t o = ((size_t)k * SWP + row) * B + p;
      if (k == 0) {
        ck_vp[o] = ~0u;
        ck_vm[o] = 0u;
      } else {
        // Rows outside the true window stay zero; the DP writes the others.
        const int off = ckw0[k] & 7;
        if (row < off || row >= off + SW) {
          ck_vp[o] = 0u;
          ck_vm[o] = 0u;
        }
      }
    }
    if (tid == 0) ck_tv[p] = 0;
  }
  __syncthreads();

  // The pair's last useful step is its last capture, np - 1 + le + SW - 1.
  int t_end = np > 0 ? np + le + SW - 1 : 0;
  // Ring K6's checkpoint cursor, the same in every thread: checkpoint ck_k
  // takes word t + 1 - ck_k * CB at step t from ck_t0, its window's first
  // step, for SW steps; ck_slot is that word's slot, ck_top the window top.
  int ck_k = 1, ck_t0 = kNever, ck_top = 0, ck_slot = 0;
  if (kCk && n_ck > 1) {
    ck_top = ckw0[1];
    ck_t0 = CB - 1 + ck_top;
    ck_slot = ck_top % RW;
    t_end = max(t_end, (n_ck - 1) * CB - 1 + ckw0[n_ck - 1] + SW);
  }
  const int w0 = tid * kK;  // this thread's first slot (and lap-0 word)
  uint32_t vp[kK], vm[kK], p0[kK], p1[kK];
  // Outputs of each slot's last step: the code masks of its column and its
  // h carries (0/1).  Slot j reads slot j-1's.
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
  // Profile words of the thread's next word of a later lap (word w0 + RW
  // first), taken at its entry.
  uint32_t pn0, pn1;
  {
    const int r = min(w0 + RW, S - 1);
    pn0 = pb0[(size_t)r * B + p];
    pn1 = pb1[(size_t)r * B + p];
  }
  int e = 0, a = 0;          // sequence indices: next to enter, next to absorb
  int ent_w = w0, abs_w = w0;
  int ent_next = ent_t[ent_w];
  int abs_next = abs_t[abs_w];
  int top_next = top_t[abs_w];
  int wc_slot = ((1 - np) % RW + RW) % RW;  // slot of word t + 1 - np
  uint32_t last_aux = 0;  // packed outputs of slot kK-1, last step
  int cap = 0;            // this thread's captured values

  for (int t = 0; t < t_end; ++t) {
    // Slot 0's input: the outputs of the slot above (the previous thread's
    // last slot, or across the wrap) from step t-1.
    uint32_t up;
    if (solo) {
      up = __shfl_sync(kFull, last_aux, (lane + 31) & 31);
    } else {
      up = __shfl_up_sync(kFull, last_aux, 1);
      if (lane == 0) up = s_aux[(t - 1) & 1][warp > 0 ? warp - 1 : last_warp];
    }
    uint32_t in_a0 = 0u - (up & 1u);
    uint32_t in_a1 = 0u - ((up >> 1) & 1u);
    uint32_t in_hp = (up >> 2) & 1u;
    uint32_t in_hm = (up >> 3) & 1u;
    if (t == ent_next) {
      const int j = e & (kK - 1);
      const bool later_lap = e >= kK;
#pragma unroll
      for (int jj = 0; jj < kK; ++jj) {
        if (jj == j) {
          vp[jj] = ~0u;
          vm[jj] = 0u;
          if (later_lap) {
            p0[jj] = pn0;
            p1[jj] = pn1;
          }
        }
      }
      ++e;
      ent_w = next_word(ent_w, e, RW);
      ent_next = ent_t[ent_w];
      if (later_lap) {
        // Prefetch the profile of the thread's next word.
        const int r = min(ent_w, S - 1);
        pn0 = pb0[(size_t)r * B + p];
        pn1 = pb1[(size_t)r * B + p];
      }
    }
    if (t == abs_next) {
      const int j = a & (kK - 1);
      int val = 0;
#pragma unroll
      for (int jj = 0; jj < kK; ++jj) {
        if (jj == j) val = __popc(vp[jj]) - __popc(vm[jj]);
      }
      if (t - abs_w <= np - 1) s_acc += val;
      ++a;
      abs_w = next_word(abs_w, a, RW);
      abs_next = abs_t[abs_w];
      top_next = top_t[abs_w];
    }
    // The thread's next word to absorb is the band top at [top_t, abs_t)
    // (after an absorb the next top starts a step later).
    if (t >= top_next && t < abs_next && t - abs_w < n_lim) {
      const int j = a & (kK - 1);
      const uint32_t cc = cp[t - abs_w];
      const uint32_t a0 = 0u - (cc & 1u);
      const uint32_t a1 = 0u - ((cc >> 1) & 1u);
      if (j == 0) {
        in_a0 = a0;
        in_a1 = a1;
        in_hp = 1u;
        in_hm = 0u;
      }
#pragma unroll
      for (int jj = 1; jj < kK; ++jj) {
        if (jj == j) {
          xa0[jj - 1] = a0;
          xa1[jj - 1] = a1;
          xhp[jj - 1] = 1u;
          xhm[jj - 1] = 0u;
        }
      }
    }
    // Slots from the bottom up, so slot j still sees slot j-1's outputs of
    // step t-1.
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
    if (!solo && lane == 31) s_aux[t & 1][warp] = last_aux;
    // Cost capture: word t+1-n finishes column n-1 now, in slot wc_slot
    // (ring K6 also sweeps the columns of a pair with n == 0, which has
    // none to capture).
    const int wc = t + 1 - np;
    const int jc = wc_slot - w0;
    if ((unsigned)jc < (unsigned)kK && wc >= le && wc < le + SW &&
        (!kCk || np > 0)) {
      int full = mp - wc * kW;
      full = full < 0 ? 0 : (full > kW ? kW : full);
      const uint32_t mask = full >= kW ? ~0u : (1u << full) - 1u;
#pragma unroll
      for (int j = 0; j < kK; ++j) {
        if (j == jc) cap += __popc(vp[j] & mask) - __popc(vm[j] & mask);
      }
    }
    wc_slot = wc_slot + 1 == RW ? 0 : wc_slot + 1;
    if (kCk && t >= ck_t0) {
      // Word w ends checkpoint ck_k's column now, in slot ck_slot.
      const int w = t + 1 - ck_k * CB;
      const int jk = ck_slot - w0;
      if ((unsigned)jk < (unsigned)kK) {
        uint32_t xv = 0u, xm = 0u;
#pragma unroll
        for (int j = 0; j < kK; ++j) {
          if (j == jk) {
            xv = vp[j];
            xm = vm[j];
          }
        }
        const size_t o = ((size_t)ck_k * SWP + (w - (ck_top & ~7))) * B + p;
        ck_vp[o] = xv;
        ck_vm[o] = xm;
        if (w == ck_top) ck_tv[(size_t)ck_k * B + p] = s_acc + ck_k * CB;
      }
      ck_slot = ck_slot + 1 == RW ? 0 : ck_slot + 1;
      if (w + 1 == ck_top + SW) {  // the window's last word: next checkpoint
        ++ck_k;
        if (ck_k < n_ck) {
          ck_top = ckw0[ck_k];
          ck_t0 = ck_k * CB - 1 + ck_top;
          ck_slot = ck_top % RW;
        } else {
          ck_t0 = kNever;
        }
      }
    }
    if (solo) {
      __syncwarp();
    } else {
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

// One Myers word step of a slot: the char masks a0/a1 of its column, the
// profile words, and the carry words of the slot above from the step before
// (their top bits are the h carries).  Updates vp/vm and returns the slot's
// own carry words (hpo/hmo before the shift).  14 int32 instructions: the
// match word, the carry-in bit, eq | hm with its AND and add, four
// three-input logicals, the two vertical words and two funnel shifts.
__device__ __forceinline__ void word_step(uint32_t a0, uint32_t a1,
                                          uint32_t p0, uint32_t p1,
                                          uint32_t hp_up, uint32_t hm_up,
                                          uint32_t& vp, uint32_t& vm,
                                          uint32_t& hp_out, uint32_t& hm_out) {
  const uint32_t eq = (a0 ^ p0) & (a1 ^ p1);
  const uint32_t v = vp;
  const uint32_t vx = eq | vm;
  const uint32_t eq2 = eq | (hm_up >> (kW - 1));
  const uint32_t hx = (((eq2 & v) + v) ^ v) | eq2;
  const uint32_t hpo = vm | ~(hx | v);
  const uint32_t hmo = v & hx;
  const uint32_t hps = __funnelshift_l(hp_up, hpo, 1);  // hpo << 1 | carry
  const uint32_t hms = __funnelshift_l(hm_up, hmo, 1);
  vp = hms | ~(vx | hps);
  vm = hps & vx;
  hp_out = hpo;
  hm_out = hmo;
}

// word_step with part of its integer work on the FMA pipe: the same inputs
// and outputs, bit for bit.  On sm_90 LOP3, IADD3 and SHF run on the ALU
// pipe and IMAD in all its forms on the FMA pipe, 16 lanes a sub-partition
// each, so word_step's 14 instructions are the least on the ALU pipe alone
// (ptxas already runs its add as IMAD.IADD: 13 and 1).  Here the add is
// x * one + v and the h- word's funnel shift is hmo * two + cm, (x << 1) |
// c for c in {0, 1}, with cm, hm_up's top bit, shared with eq2: 12 ALU-pipe
// and 2 FMA-pipe instructions.  `one` and `two` hold 1 and 2 (kernel
// arguments: ptxas cannot fold the products back into IADD3 and SHF).  The
// h+ word keeps its funnel shift and cm its SHF: on the H100 the full split
// (both carry bits as hi(x * two), IMAD.HI, and both shifts as
// multiply-adds: 10 and 5) ran K7's step no faster than word_step, and
// this one ~3% faster (PERF.md).
__device__ __forceinline__ void word_step_split(uint32_t a0, uint32_t a1,
                                                uint32_t p0, uint32_t p1,
                                                uint32_t hp_up, uint32_t hm_up,
                                                uint32_t one, uint32_t two,
                                                uint32_t& vp, uint32_t& vm,
                                                uint32_t& hp_out, uint32_t& hm_out) {
  const uint32_t eq = (a0 ^ p0) & (a1 ^ p1);
  const uint32_t v = vp;
  const uint32_t vx = eq | vm;
  const uint32_t cm = hm_up >> (kW - 1);
  const uint32_t eq2 = eq | cm;
  const uint32_t hx = (((eq2 & v) * one + v) ^ v) | eq2;
  const uint32_t hpo = vm | ~(hx | v);
  const uint32_t hmo = v & hx;
  const uint32_t hps = __funnelshift_l(hp_up, hpo, 1);
  const uint32_t hms = hmo * two + cm;
  vp = hms | ~(vx | hps);
  vm = hps & vx;
  hp_out = hpo;
  hm_out = hmo;
}

// All-ones or zero: bit k of x.
__device__ __forceinline__ uint32_t bit_mask(uint32_t x, int k) {
  return (uint32_t)((int32_t)(x << (31 - k)) >> 31);
}

// What a ring_body instance computes (see the header): K7 and the wide
// ring (kRingCost: the shared schedule's costs, a ring a block), ring K10
// (kRingCkPP: per-pair schedules, a ring a block, checkpoints under K4's
// row contract) or, in rings of `ring` threads (a block, or `ring` lanes
// of a warp beside the rings of 32 / ring - 1 other pairs) under K1's
// result rule: K1 (kRingBanded: the shared schedule's costs), K4
// (kRingBandedPP: per-pair costs; kRingBandedCkPP: per-pair costs and
// checkpoints, K4's rows past a pair's end) and K3 (kRingFill: the shared
// schedule's costs and every column's window planes); ring K8 (kRingCk:
// ring K10 on the shared schedule, a ring a block) and ring K2
// (kRingBandedCk: K4's checkpoint ring on the shared schedule, K1's rings).
enum RingMode {
  kRingCost = 0,
  kRingCkPP = 1,
  kRingBanded = 2,
  kRingBandedPP = 3,
  kRingBandedCkPP = 4,
  kRingFill = 5,
  kRingCk = 6,
  kRingBandedCk = 7
};

// The ring's step and events; see the header.  A thread holds kT = 8 + kS
// consecutive slots: 8 in registers, then kS in shared memory, laid out
// [slot][thread] at a stride of kMaxThreads, state (vp, vm) and profile
// (p0, p1) apart, so a warp touches consecutive 8-byte words.  K7 and the
// wide ring run word_step_split (`one`, `two`: 1 and 2 from the kernel's
// arguments), the other modes word_step.
template <int kS, int kMode>
__device__ __forceinline__ void ring_body(
    const uint8_t* __restrict__ code, const uint32_t* __restrict__ pb0,
    const uint32_t* __restrict__ pb1, const int32_t* __restrict__ n,
    const int32_t* __restrict__ m, const int32_t* __restrict__ loend,
    const int32_t* __restrict__ ev, int32_t* __restrict__ out,
    uint32_t* __restrict__ ck_vp, uint32_t* __restrict__ ck_vm,
    int32_t* __restrict__ ck_tv, const int32_t* __restrict__ ckw0, int n_max,
    int B, int S, int SW, int nw_pad, int n_lim, int CB, int n_ck, int ring,
    uint32_t one = 1u, uint32_t two = 2u) {
  constexpr int kT = kK + kS;  // slots a thread, a power of two
  constexpr bool kSplit = kMode == kRingCost;
  // K4's checkpoint rows past a pair's end (K4, and K2 on the shared
  // schedule).
  constexpr bool kK4Ck = kMode == kRingBandedCkPP || kMode == kRingBandedCk;
  constexpr bool kCk = kMode == kRingCkPP || kMode == kRingCk || kK4Ck;
  constexpr bool kFill = kMode == kRingFill;
  // Each pair's own event rows and window tops (ring K10, K4).
  constexpr bool kPPev =
      kMode == kRingCkPP || kMode == kRingBandedPP || kMode == kRingBandedCkPP;
  // K1's layout and result rule (K1, K4, K3, K2).
  constexpr bool kK1 = kMode >= kRingBanded && kMode != kRingCk;
  const int NT = kK1 ? ring : blockDim.x;  // the ring's threads
  // K1's rings below a warp: 32 / NT pairs a warp (one-warp blocks).
  const bool sub = kK1 && NT < 32;
  const int pair = sub ? blockIdx.x * (32 / NT) + threadIdx.x / NT : blockIdx.x;
  const int p = kK1 ? min(pair, B - 1) : pair;  // a tail ring repeats pair B-1
  const bool own = !kK1 || pair < B;            // and writes nothing
  const int tid = sub ? threadIdx.x & (NT - 1) : threadIdx.x;
  // Lane and warp from tid where the ring is the block: taken from
  // threadIdx.x there, the wide ring's build spilled (8 bytes at 128
  // registers) and ran ~5% slower on config #5's SW = 8192 rung.
  const int lane = (kK1 ? (int)threadIdx.x : tid) & 31;
  const int warp = (kK1 ? (int)threadIdx.x : tid) >> 5;
  const int RW = NT * kT;
  const bool multi = NT > 32;  // a one-warp ring wraps by shuffle alone
  const int prev_warp = warp > 0 ? warp - 1 : (NT >> 5) - 1;
  const int src = sub ? (lane & ~(NT - 1)) | ((tid + NT - 1) & (NT - 1)) : (lane + 31) & 31;
  const int np = n[p];
  const int mp = m[p];
  const int le = loend[p];
  if constexpr (kPPev) ev += (size_t)p * 3 * nw_pad;  // the pair's own event rows
  // K4's words stop after the pair's own last column.
  if constexpr (kMode == kRingBandedPP || kK4Ck) n_lim = max(np, 1);
  // K4's checkpoints from k1 on (k*CB > n) lie past the pair's end: the
  // window after column n-1, slid down the schedule, whose words below fb
  // hold their state after column n-1 (written at their capture) and the
  // rest, entered after the end, all-ones.  The cursor takes the others.
  const int k1 = kK4Ck ? np / CB + 1 : n_ck;
  const int fb = np > 0 ? le + SW : 0;
  // Checkpoint k's window top, lo(k * CB - 1): each pair's (ring K10, K4)
  // or the shared schedule's (ring K8, K2).
  auto ck_top = [&](int k) { return kPPev ? ckw0[(size_t)k * B + p] : ckw0[k]; };
  const int32_t* ent_t = ev;
  const int32_t* top_t = ev + nw_pad;
  const int32_t* abs_t = ev + 2 * nw_pad;
  const uint8_t* cp = code + (size_t)p * n_max;

  extern __shared__ uint2 s_dyn[];
  uint2* s_v = s_dyn + tid;                     // s_v[k * kMaxThreads]
  uint2* s_p = s_dyn + kS * kMaxThreads + tid;  // s_p[k * kMaxThreads]
  // The wide ring keeps its register slots' profiles in shared memory too
  // (s_q[j * kMaxThreads]), which leaves it 16 registers for its shared
  // slots' bits at 512 threads.
  uint2* s_q = s_dyn + 2 * kS * kMaxThreads + tid;
  // The link between warps: carry words and char masks of a warp's last
  // slot, double-buffered by step parity.
  __shared__ uint4 s_link[2][kMaxThreads / 32];
  __shared__ int s_sum;
  if (threadIdx.x == 0) s_sum = 0;
  if (threadIdx.x < kMaxThreads / 32) {
    s_link[0][threadIdx.x] = make_uint4(0u, 0u, 0u, 0u);
    s_link[1][threadIdx.x] = make_uint4(0u, 0u, 0u, 0u);
  }
  if (kCk && own) {
    // Checkpoint 0 is the all-ones state.  Top values start at k * CB; the
    // threads add the values absorbed above each window top (tv_acc below).
    // Past a pair's end (K4, k >= k1) they start at n plus 32 for each word
    // above the window top that entered after the end, and each captured
    // word above it adds its value at its capture.
    for (int i = tid; i < SW; i += NT) {
      ck_vp[(size_t)i * B + p] = ~0u;
      ck_vm[(size_t)i * B + p] = 0u;
    }
    for (int k = tid; k < n_ck; k += NT) {
      ck_tv[(size_t)k * B + p] =
          k < k1 ? k * CB : np + kW * max(0, ck_top(k) - fb);
    }
    if constexpr (kK4Ck) {
      for (int i = tid; i < (n_ck - k1) * SW; i += NT) {
        const int k = k1 + i / SW;
        const int row = i - (i / SW) * SW;
        if (ck_top(k) + row >= fb) {
          const size_t o = ((size_t)k * SW + row) * B + p;
          ck_vp[o] = ~0u;
          ck_vm[o] = 0u;
        }
      }
    }
  }

  const int w0 = tid * kT;  // this thread's first slot (and lap-0 word)
  // Register slots: state, profile and carry words; A0/A1 hold the char
  // masks that entered slot 0 at the last 8 steps (slot j reads the one of
  // step t - j, at (t - j) & 7), so masks pass down the slots by register
  // naming in the 8-step unrolled loop, with no moves.
  uint32_t vp[kK], vm[kK], p0[kK], p1[kK], xhp[kK], xhm[kK], A0[kK], A1[kK];
#pragma unroll
  for (int j = 0; j < kK; ++j) {
    const int r = min(w0 + j, S - 1);
    if constexpr (kS > 0) {
      s_q[j * kMaxThreads] = make_uint2(pb0[(size_t)r * B + p], pb1[(size_t)r * B + p]);
    } else {
      p0[j] = pb0[(size_t)r * B + p];
      p1[j] = pb1[(size_t)r * B + p];
    }
    vp[j] = ~0u;
    vm[j] = 0u;
    xhp[j] = xhm[j] = A0[j] = A1[j] = 0u;
  }
  // Shared slots' char mask bits (C0, C1: bit k is shared slot k's) and
  // carry bits (Php, Phm: shared slot k's carry at bit 32 - kS + k, so the
  // last slot's is the top bit of the thread's link out; each step shifts
  // them up one, then each slot reads its input at the top and pushes its
  // output at the bottom).
  uint32_t C0 = 0u, C1 = 0u, Php = 0u, Phm = 0u;
#pragma unroll
  for (int k = 0; k < kS; ++k) {
    const int r = min(w0 + kK + k, S - 1);
    s_v[k * kMaxThreads] = make_uint2(~0u, 0u);
    s_p[k * kMaxThreads] = make_uint2(pb0[(size_t)r * B + p], pb1[(size_t)r * B + p]);
  }
  __syncthreads();
  // Profile words of the thread's next word of a later lap (word w0 + RW
  // first), taken at its entry.
  uint32_t pn0, pn1;
  {
    const int r = min(w0 + RW, S - 1);
    pn0 = pb0[(size_t)r * B + p];
    pn1 = pb1[(size_t)r * B + p];
  }
  // The thread's word of sequence index q is lap q / kT, slot q % kT.
  auto next_of = [&](int w, int q) {
    return (q & (kT - 1)) ? w + 1 : w + RW - (kT - 1);
  };
  // The thread's first word at or after word d: its sequence index q, w.
  auto seek = [&](int d, int& q, int& w) {
    const int dd = d - w0;
    const int lap = dd > 0 ? dd / RW : 0;
    const int r = dd > 0 ? dd - lap * RW : 0;
    q = r < kT ? lap * kT + r : (lap + 1) * kT;
    w = w0 + (q & (kT - 1)) + (q / kT) * RW;
  };
  int e = 0, a = 0;  // sequence indices: next to enter, next to absorb
  int ent_w = w0, abs_w = w0;
  int ent_next = ent_t[ent_w];
  int abs_next = abs_t[abs_w];
  int top_next = top_t[abs_w];
  // Capture: the thread's next word in [le, le + SW), word wc finishing
  // column np - 1 at step wc + np - 1 (taken before the next step).
  int cap_q, cap_w;
  seek(le, cap_q, cap_w);
  int cap_next = np > 0 && cap_w < le + SW ? cap_w + np - 1 : kNever;
  int acc = 0;  // this thread's absorbed and captured values
  // Ring K10's checkpoints.  Rows: the thread's next word ck_w of window
  // ck_k, [top, top + SW) with top = lo_p(ck_k * CB - 1) (ckw0), ends
  // column ck_k * CB - 1 at step ck_next = ck_k * CB - 1 + ck_w and is read
  // before the next step, as a capture.  Top values: the thread adds its
  // absorbed values so far (tv_acc) to checkpoint tv_k's when it absorbs
  // its first word at or below that window's top (absorbs rise with the
  // word, so every word above the top is absorbed before the top is taken
  // and none at or below it), and to the rest at the end.  The window tops
  // are read again where used (out of line), which keeps the step loop
  // within its registers.
  int ck_k = 1, ck_q = 0, ck_w = 0, ck_next = kNever, tv_k = 1, tv_acc = 0;
  // The windows the cursor takes (K4: those at or before the pair's end),
  // and the top values a thread adds to (none for a tail ring).
  const int n_cur = !own ? 1 : kK4Ck ? min(n_ck, k1) : n_ck;
  const int n_tv = own ? n_ck : 1;
  // From window ck_k on, the first window the thread holds a word of.
  auto ck_seek = [&]() {
    for (; ck_k < n_cur; ++ck_k) {
      const int top = ck_top(ck_k);
      seek(top, ck_q, ck_w);
      if (ck_w < top + SW) {
        ck_next = ck_k * CB - 1 + ck_w;
        return;
      }
    }
    ck_next = kNever;
  };
  if constexpr (kCk) ck_seek();
  // The band top.  Its input is the +1 carry and its own column's char
  // code.  The code: from the step the thread's slot-0 word is the top, the
  // thread is in memory mode (mm): slot 0's input masks are its own words'
  // column codes, read from code a step ahead (tc, at tptr), until its lap
  // is absorbed, its slot 0 takes a word of the next lap, or slot 0's column
  // reaches n_lim (mm_end); every slot below reads them from the history.
  // The carry: the top in slot 0 takes it in place of the link (top0);
  // the top in slot s >= 1 reads it from slot s - 1, whose word was just
  // absorbed: that slot is armed (vp = 0, vm = ~0), so its carry words have
  // top bits 1 and 0 whatever its inputs for the next 32 steps, and re-armed
  // every 31 steps while the same word stays the top (rearm).  When a word
  // of the thread's next lap enters while the top is still in the thread
  // (straddle: the ring is almost full), the top slot ts takes its inputs
  // directly each step (slow, steps before top_end with no other event).
  bool mm = false, top0 = false, slow = false;
  int mm_end = kNever, rearm = kNever, ev_next = 0, top_end = 0, ts = 0;
  // Ring K8: the next event step but the row cursor's (its fast path).
  int ev_rest = 0;
  uint32_t tc = 0u;
  const uint8_t* tptr = cp;
  if constexpr (kK1 || kMode == kRingCk) {
    if (w0 == 0 && abs_t[0] == 0) {
      // A schedule shifted at column 0: word 0 is absorbed at its entry and
      // is never the top, so slot 0 reads the column codes from step 0 for
      // the words below it (word 1 is the top from step 1, in slot 1).
      // Ring K10's schedules do not shift there; K7's and the wide ring's
      // builds leave this out (see the header).
      mm = true;
      tc = *tptr;
      mm_end = n_lim;
    }
  }

  // The values of slot j (before this step's compute).
  auto read_slot = [&](int j, uint32_t& xv, uint32_t& xm) {
    if (kS > 0 && j >= kK) {
      const uint2 v = s_v[(j - kK) * kMaxThreads];
      xv = v.x;
      xm = v.y;
      return;
    }
    xv = xm = 0u;
#pragma unroll
    for (int jj = 0; jj < kK; ++jj) {
      if (jj == j) {
        xv = vp[jj];
        xm = vm[jj];
      }
    }
  };
  // Slot j's state (and, for a word of a later lap, its profile).
  auto set_slot = [&](int j, uint32_t xv, uint32_t xm, bool profile) {
    if (kS > 0 && j >= kK) {
      s_v[(j - kK) * kMaxThreads] = make_uint2(xv, xm);
      if (profile) s_p[(j - kK) * kMaxThreads] = make_uint2(pn0, pn1);
      return;
    }
#pragma unroll
    for (int jj = 0; jj < kK; ++jj) {
      if (jj == j) {
        vp[jj] = xv;
        vm[jj] = xm;
        if (profile) {
          if constexpr (kS > 0) {
            s_q[jj * kMaxThreads] = make_uint2(pn0, pn1);
          } else {
            p0[jj] = pn0;
            p1[jj] = pn1;
          }
        }
      }
    }
  };
  // Ring K10: write the row of word ck_w and step the row cursor.
  auto ck_take = [&]() {
    uint32_t xv, xm;
    read_slot(ck_q & (kT - 1), xv, xm);
    const int top = ck_top(ck_k);
    const size_t o = ((size_t)ck_k * SW + (ck_w - top)) * B + p;
    ck_vp[o] = xv;
    ck_vm[o] = xm;
    ++ck_q;
    ck_w = next_of(ck_w, ck_q);
    if (ck_w < top + SW) {
      ck_next = ck_k * CB - 1 + ck_w;
    } else {
      ++ck_k;
      ck_seek();
    }
  };

  // The capture of word cap_w, its state after column np - 1 (K4's
  // checkpoints past the pair's end take it too: its row in each window
  // that holds it, its value in each top value above it).
  auto capture = [&]() {
    int full = mp - cap_w * kW;
    full = full < 0 ? 0 : (full > kW ? kW : full);
    const uint32_t mask = full >= kW ? ~0u : (1u << full) - 1u;
    uint32_t xv, xm;
    read_slot(cap_q & (kT - 1), xv, xm);
    acc += __popc(xv & mask) - __popc(xm & mask);
    if constexpr (kK4Ck) {
      if (own) {
        const int cv = __popc(xv) - __popc(xm);
        for (int k = k1; k < n_ck; ++k) {
          const int top = ck_top(k);
          if (cap_w < top) {
            atomicAdd(&ck_tv[(size_t)k * B + p], cv);
          } else {
            const size_t o = ((size_t)k * SW + (cap_w - top)) * B + p;
            ck_vp[o] = xv;
            ck_vm[o] = xm;
          }
        }
      }
    }
    ++cap_q;
    cap_w = next_of(cap_w, cap_q);
    cap_next = cap_w < le + SW ? cap_w + np - 1 : kNever;
  };
  // K3: the word each register slot holds and the step its stores stop
  // (its absorb, or its column reaching the pair's end); set at its entry.
  int fw[kK], fhi[kK];
  const int n_st = min(np, n_max);
  uint32_t* const f_vp = kFill ? ck_vp + (size_t)p * n_max * SW : nullptr;
  uint32_t* const f_vm = kFill ? ck_vm + (size_t)p * n_max * SW : nullptr;
#pragma unroll
  for (int j = 0; j < kK; ++j) fw[j] = fhi[j] = 0;

  int t_end = np > 0 ? np + le + SW - 1 : 0;
  if constexpr (kCk && !kK4Ck) {
    // Checkpoint rows are defined up to n_max: the last window's last word.
    if (n_ck > 1) t_end = max(t_end, (n_ck - 1) * CB - 1 + ck_top(n_ck - 1) + SW);
  }
  // The rings of a warp step together (a full-warp shuffle links them).
  if constexpr (kK1) t_end = __reduce_max_sync(kFull, t_end);
  int t = 0;
  for (; t < t_end; t += kK) {
#pragma unroll
    for (int u = 0; u < kK; ++u) {
      const int tt = t + u;
      // Slot 0's input: the outputs of the slot above (the previous
      // thread's last slot, or across the wrap) from step tt - 1.
      uint32_t in_hp, in_hm;
      {
        // The thread's last slot's outputs of step tt - 1: register slot
        // 7's masks entered slot 0 at step tt - 8.
        const uint32_t o_hp = kS > 0 ? Php : xhp[kK - 1];
        const uint32_t o_hm = kS > 0 ? Phm : xhm[kK - 1];
        const uint32_t o_a0 = kS > 0 ? bit_mask(C0, kS - 1) : A0[u];
        const uint32_t o_a1 = kS > 0 ? bit_mask(C1, kS - 1) : A1[u];
        if constexpr (kS > 0) {
          // Shared slot 0's masks this step entered slot 0 at step tt - 8.
          C0 = __funnelshift_l(A0[u], C0, 1);
          C1 = __funnelshift_l(A1[u], C1, 1);
          Php <<= 1;
          Phm <<= 1;
        }
        in_hp = __shfl_sync(kFull, o_hp, src);
        in_hm = __shfl_sync(kFull, o_hm, src);
        A0[u] = __shfl_sync(kFull, o_a0, src);
        A1[u] = __shfl_sync(kFull, o_a1, src);
        if (multi && lane == 0) {
          const uint4 l = s_link[(u + 1) & 1][prev_warp];
          in_hp = l.x;
          in_hm = l.y;
          A0[u] = l.z;
          A1[u] = l.w;
        }
      }
      if (tt >= ev_next) {
        if (kMode == kRingCk && tt - 1 == ck_next && tt < ev_rest) {
          // Ring K8: only the row cursor is due.  Its windows cover most
          // steps of a full-height rung (SW of every CB columns), so the
          // rest of the event code stays out of them.
          ck_take();
          ev_next = min(ev_rest, ck_next + 1);
        } else if (!(slow && tt < top_end)) {
          // A capture due at step tt - 1, after its compute.
          if (tt - 1 == cap_next) capture();
          if constexpr (kCk) {
            if (tt - 1 == ck_next) ck_take();
          }
          if (tt == ent_next) {
            const int j = e & (kT - 1);
            const bool later_lap = e >= kT;
            set_slot(j, ~0u, 0u, later_lap);
            if constexpr (kFill) {
              const int hi = own ? min(abs_t[ent_w], n_st + ent_w) : 0;
#pragma unroll
              for (int jj = 0; jj < kK; ++jj) {
                if (jj == j) {
                  fw[jj] = ent_w;
                  fhi[jj] = hi;
                }
              }
            }
            if (j == 0 && later_lap) mm = top0 = false;  // slot 0 reads the link
            ++e;
            ent_w = next_of(ent_w, e);
            ent_next = ent_t[ent_w];
            if (later_lap) {
              // Prefetch the profile of the thread's next word.
              const int r = min(ent_w, S - 1);
              pn0 = pb0[(size_t)r * B + p];
              pn1 = pb1[(size_t)r * B + p];
            }
          }
          // A word of the thread's next lap has entered.
          const bool straddle = e > (a & ~(kT - 1)) + kT;
          if (tt == abs_next) {
            const int j = a & (kT - 1);
            uint32_t xv, xm;
            read_slot(j, xv, xm);
            if (tt - abs_w <= np - 1) acc += __popc(xv) - __popc(xm);
            if constexpr (kCk) {
              for (; tv_k < n_tv && abs_w >= ck_top(tv_k); ++tv_k) {
                if (tv_acc) atomicAdd(&ck_tv[(size_t)tv_k * B + p], tv_acc);
              }
              if (tt - abs_w <= np - 1) tv_acc += __popc(xv) - __popc(xm);
            }
            ++a;
            abs_w = next_of(abs_w, a);
            abs_next = abs_t[abs_w];
            top_next = top_t[abs_w];
            if (j == 0) top0 = false;
            if (j == kT - 1) {
              mm = false;  // the lap is absorbed: the top is in the next thread
            } else if (!straddle) {
              set_slot(j, 0u, ~0u, false);  // the next top's carry
              rearm = abs_next > tt + 32 ? tt + 31 : kNever;
            }
          }
          if (tt == rearm) {
            rearm = kNever;
            if (!straddle && (a & (kT - 1)) != 0 && tt < abs_next) {
              set_slot((a - 1) & (kT - 1), 0u, ~0u, false);
              rearm = abs_next > tt + 32 ? tt + 31 : kNever;
            }
          }
          if (tt >= mm_end) {
            mm = top0 = false;
            mm_end = kNever;
          }
          // The thread's next word to absorb is the band top at [top_next,
          // abs_next) while its column is below n_lim (after an absorb the
          // next top starts a step later).
          const bool top = tt >= top_next && tt < abs_next && tt - abs_w < n_lim;
          const bool straddle_now = e > (a & ~(kT - 1)) + kT;
          if (top && (a & (kT - 1)) == 0 && !mm) {
            mm = top0 = true;
            tptr = cp + (tt - abs_w);
            tc = *tptr;
            mm_end = abs_w + n_lim;
          }
          slow = top && straddle_now;
          if (slow) {
            ts = a & (kT - 1);
            tptr = cp + (tt - abs_w);
            tc = *tptr;
            top_end = min(min(min(abs_next, ent_next), min(cap_next + 1, rearm)),
                          abs_w + n_lim);
            if constexpr (kCk) top_end = min(top_end, ck_next + 1);
            ev_next = tt;
            if constexpr (kMode == kRingCk) ev_rest = tt;
          } else {
            const int top_start = (straddle_now || (a & (kT - 1)) == 0) && top_next > tt &&
                                          top_next - abs_w < n_lim
                                      ? top_next
                                      : kNever;
            ev_next = min(min(min(ent_next, abs_next), min(top_start, cap_next + 1)),
                          min(rearm, mm_end));
            if constexpr (kMode == kRingCk) ev_rest = ev_next;
            if constexpr (kCk) ev_next = min(ev_next, ck_next + 1);
          }
        }
        if (slow) {
          // The top slot's input, directly: the +1 carry and its column's
          // masks.
          const uint32_t m0 = 0u - (tc & 1u);
          const uint32_t m1 = 0u - ((tc >> 1) & 1u);
          tc = *++tptr;  // next step's code (the buffer is padded)
          if (kS == 0 || ts < kK) {
            switch (ts) {  // the carry words and masks slot ts reads
#define RING_TOP_CASE(J)                  \
  case J:                                 \
    A0[(u - J) & (kK - 1)] = m0;          \
    A1[(u - J) & (kK - 1)] = m1;          \
    xhp[J - 1] = ~0u;                     \
    xhm[J - 1] = 0u;                      \
    break;
              RING_TOP_CASE(1)
              RING_TOP_CASE(2)
              RING_TOP_CASE(3)
              RING_TOP_CASE(4)
              RING_TOP_CASE(5)
              RING_TOP_CASE(6)
              RING_TOP_CASE(7)
#undef RING_TOP_CASE
              default:
                break;
            }
          } else if constexpr (kS > 0) {
            const int k = ts - kK;
            C0 = (C0 & ~(1u << k)) | ((m0 & 1u) << k);
            C1 = (C1 & ~(1u << k)) | ((m1 & 1u) << k);
            if (k == 0) {
              xhp[kK - 1] = ~0u;
              xhm[kK - 1] = 0u;
            } else {
              const int pos = 32 - kS + k;
              Php |= 1u << pos;
              Phm &= ~(1u << pos);
            }
          }
        }
      }
      if (mm) {
        // Memory mode: slot 0's input masks are its own column's.
        A0[u] = 0u - (tc & 1u);
        A1[u] = 0u - ((tc >> 1) & 1u);
        tc = *++tptr;  // next step's code (the buffer is padded)
        if (top0) {
          in_hp = ~0u;
          in_hm = 0u;
        }
      }
      // Slots from the bottom up, so slot j still sees slot j-1's carries of
      // step tt - 1: the shared slots, then the register slots.
#pragma unroll
      for (int k = kS - 1; k >= 0; --k) {
        const uint2 v = s_v[k * kMaxThreads];
        const uint2 pr = s_p[k * kMaxThreads];
        const uint32_t a0 = bit_mask(C0, k);
        const uint32_t a1 = bit_mask(C1, k);
        uint32_t x = v.x, y = v.y, ho, mo;
        if constexpr (kSplit) {
          word_step_split(a0, a1, pr.x, pr.y, k ? Php : xhp[kK - 1], k ? Phm : xhm[kK - 1],
                          one, two, x, y, ho, mo);
        } else {
          word_step(a0, a1, pr.x, pr.y, k ? Php : xhp[kK - 1], k ? Phm : xhm[kK - 1], x, y,
                    ho, mo);
        }
        s_v[k * kMaxThreads] = make_uint2(x, y);
        Php = __funnelshift_l(ho, Php, 1);  // push the carry at the bottom
        Phm = __funnelshift_l(mo, Phm, 1);
      }
      if constexpr (kS > 0) {
        Php <<= 32 - kS;  // the last slot's carry to the top
        Phm <<= 32 - kS;
      }
#pragma unroll
      for (int j = kK - 1; j >= 0; --j) {
        const uint2 pr = kS > 0 ? s_q[j * kMaxThreads] : make_uint2(p0[j], p1[j]);
        if constexpr (kSplit) {
          word_step_split(A0[(u - j) & (kK - 1)], A1[(u - j) & (kK - 1)], pr.x, pr.y,
                          j ? xhp[j - 1] : in_hp, j ? xhm[j - 1] : in_hm, one, two, vp[j],
                          vm[j], xhp[j], xhm[j]);
        } else {
          word_step(A0[(u - j) & (kK - 1)], A1[(u - j) & (kK - 1)], pr.x, pr.y,
                    j ? xhp[j - 1] : in_hp, j ? xhm[j - 1] : in_hm, vp[j], vm[j],
                    xhp[j], xhm[j]);
        }
      }
      if constexpr (kFill) {
        // Each slot's word stores its state after its column tt - fw into
        // row tt - fw, position fw - lo(tt - fw): at offset fw + R(tt - fw)
        // of the pair's planes, R(c) = c * SW - lo(c) (ckw0[n_max + c]).
#pragma unroll
        for (int j = 0; j < kK; ++j) {
          if (tt < fhi[j]) {
            const int o = fw[j] + ckw0[n_max + tt - fw[j]];
            f_vp[o] = vp[j];
            f_vm[o] = vm[j];
          }
        }
      }
      if (multi) {
        if (lane == 31) {
          s_link[u & 1][warp] =
              kS > 0 ? make_uint4(Php, Phm, bit_mask(C0, kS - 1), bit_mask(C1, kS - 1))
                     : make_uint4(xhp[kK - 1], xhm[kK - 1],
                                  A0[(u + 1) & (kK - 1)], A1[(u + 1) & (kK - 1)]);
        }
        __syncthreads();
      }
    }
  }
  // The capture of the last computed step, if due.
  if (t - 1 == cap_next) capture();
  if constexpr (kCk) {
    if (t - 1 == ck_next) ck_take();
    if (tv_acc) {
      for (; tv_k < n_tv; ++tv_k) atomicAdd(&ck_tv[(size_t)tv_k * B + p], tv_acc);
    }
  }
  if constexpr (kFill) {
    // Rows past the pair's end: row n_st - 1 slid down the schedule
    // (lo(c), ckw0[c]), the words entering after the end all-ones.
    __syncthreads();  // row n_st - 1 is written
    if (own) {
      for (int i = n_st * SW + tid; i < n_max * SW; i += NT) {
        const int c = i / SW;
        const int w = ckw0[c] + i - c * SW;
        uint32_t xv = ~0u, xm = 0u;
        if (np > 0 && w < le + SW) {
          const int o = (n_st - 1) * SW + w - le;
          xv = f_vp[o];
          xm = f_vm[o];
        }
        f_vp[i] = xv;
        f_vm[i] = xm;
      }
    }
  }
  if constexpr (kK1) {
    if (sub) {
      // The ring's lanes' sum; a tail ring writes nothing.
      for (int o = NT >> 1; o > 0; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
      if (pair < B && tid == 0) {
        out[p] = np == 0 ? mp : (mp - le * kW <= SW * kW ? acc + np : kInf);
      }
      return;
    }
  }
  if (acc) atomicAdd(&s_sum, acc);
  __syncthreads();
  if (tid == 0) {
    const bool covered = mp - le * kW <= SW * kW;
    // K1's rule: a pair with no column costs m.
    out[p] = kK1 && np == 0 ? mp : (covered ? s_sum + np : kInf);
  }
}

// K7 (kS = 0) and the wide ring (kS = 8 or 24 shared slots a thread);
// `one` and `two` are 1 and 2, word_step_split's multipliers.
template <int kS>
__global__ void __launch_bounds__(kMaxThreads) ring_cost_kernel(
    const uint8_t* __restrict__ code, const uint32_t* __restrict__ pb0,
    const uint32_t* __restrict__ pb1, const int32_t* __restrict__ n,
    const int32_t* __restrict__ m, const int32_t* __restrict__ loend,
    const int32_t* __restrict__ ev, int32_t* __restrict__ out, int n_max,
    int B, int S, int SW, int nw_pad, int n_lim, uint32_t one, uint32_t two) {
  ring_body<kS, kRingCost>(code, pb0, pb1, n, m, loend, ev, out, nullptr, nullptr,
                           nullptr, nullptr, n_max, B, S, SW, nw_pad, n_lim, 0, 0, 0,
                           one, two);
}

// Ring K10: per-pair schedules, checkpoints, the sweep to n_max.
__global__ void __launch_bounds__(kMaxThreads) ring_ck_pp_kernel(
    const uint8_t* __restrict__ code, const uint32_t* __restrict__ pb0,
    const uint32_t* __restrict__ pb1, const int32_t* __restrict__ n,
    const int32_t* __restrict__ m, const int32_t* __restrict__ loend,
    const int32_t* __restrict__ ev, int32_t* __restrict__ out,
    uint32_t* __restrict__ ck_vp, uint32_t* __restrict__ ck_vm,
    int32_t* __restrict__ ck_tv, const int32_t* __restrict__ ckw0, int n_max,
    int B, int S, int SW, int nw_pad, int CB, int n_ck) {
  ring_body<0, kRingCkPP>(code, pb0, pb1, n, m, loend, ev, out, ck_vp, ck_vm, ck_tv,
                          ckw0, n_max, B, S, SW, nw_pad, n_max, CB, n_ck, 0);
}

// K1: the shared schedule's costs under K1's rule, rings of `ring` threads.
__global__ void __launch_bounds__(kMaxThreads) banded_ring_kernel(
    const uint8_t* __restrict__ code, const uint32_t* __restrict__ pb0,
    const uint32_t* __restrict__ pb1, const int32_t* __restrict__ n,
    const int32_t* __restrict__ m, const int32_t* __restrict__ loend,
    const int32_t* __restrict__ ev, int32_t* __restrict__ out, int n_max,
    int B, int S, int SW, int nw_pad, int n_lim, int ring) {
  ring_body<0, kRingBanded>(code, pb0, pb1, n, m, loend, ev, out, nullptr, nullptr,
                            nullptr, nullptr, n_max, B, S, SW, nw_pad, n_lim, 0, 0, ring);
}

// The largest ring of K4's and K3's ring kernels: 256 threads, so that the
// fill's slot registers fit (a block ring above a warp needs bands of 256
// live words, which their paths never send).
constexpr int kMaxRingThreads = 256;

// K4: per-pair costs under K1's rule, rings of `ring` threads.
__global__ void __launch_bounds__(kMaxRingThreads, 1) banded_ring_pp_kernel(
    const uint8_t* __restrict__ code, const uint32_t* __restrict__ pb0,
    const uint32_t* __restrict__ pb1, const int32_t* __restrict__ n,
    const int32_t* __restrict__ m, const int32_t* __restrict__ loend,
    const int32_t* __restrict__ ev, int32_t* __restrict__ out, int n_max,
    int B, int S, int SW, int nw_pad, int ring) {
  ring_body<0, kRingBandedPP>(code, pb0, pb1, n, m, loend, ev, out, nullptr, nullptr,
                              nullptr, nullptr, n_max, B, S, SW, nw_pad, 1, 0, 0, ring);
}

// K4: per-pair costs and checkpoints (K4's rows), rings of `ring` threads.
__global__ void __launch_bounds__(kMaxRingThreads, 1) banded_ring_ck_pp_kernel(
    const uint8_t* __restrict__ code, const uint32_t* __restrict__ pb0,
    const uint32_t* __restrict__ pb1, const int32_t* __restrict__ n,
    const int32_t* __restrict__ m, const int32_t* __restrict__ loend,
    const int32_t* __restrict__ ev, int32_t* __restrict__ out,
    uint32_t* __restrict__ ck_vp, uint32_t* __restrict__ ck_vm,
    int32_t* __restrict__ ck_tv, const int32_t* __restrict__ ckw0, int n_max,
    int B, int S, int SW, int nw_pad, int CB, int n_ck, int ring) {
  ring_body<0, kRingBandedCkPP>(code, pb0, pb1, n, m, loend, ev, out, ck_vp, ck_vm,
                                ck_tv, ckw0, n_max, B, S, SW, nw_pad, 1, CB, n_ck, ring);
}

// K3: the shared schedule's costs and every column's window planes,
// pair-major (B, n_max, SW); tab holds lo(c) and R(c) = c * SW - lo(c).
__global__ void __launch_bounds__(kMaxRingThreads, 1) banded_ring_fill_kernel(
    const uint8_t* __restrict__ code, const uint32_t* __restrict__ pb0,
    const uint32_t* __restrict__ pb1, const int32_t* __restrict__ n,
    const int32_t* __restrict__ m, const int32_t* __restrict__ loend,
    const int32_t* __restrict__ ev, int32_t* __restrict__ out,
    uint32_t* __restrict__ vp_cols, uint32_t* __restrict__ vm_cols,
    const int32_t* __restrict__ tab, int n_max, int B, int S, int SW, int nw_pad,
    int n_lim, int ring) {
  ring_body<0, kRingFill>(code, pb0, pb1, n, m, loend, ev, out, vp_cols, vm_cols,
                          nullptr, tab, n_max, B, S, SW, nw_pad, n_lim, 0, 0, ring);
}

template <int kS>
int launch_cost(const void* code, const void* pb0, const void* pb1,
                const void* n, const void* m, const void* loend, const void* ev,
                void* out, int n_max, int B, int S, int SW, int nw_pad,
                int n_lim, int threads, void* stream) {
  constexpr int kT = kK + kS;
  if (threads < 32 || threads > kMaxThreads || threads % 32 ||
      nw_pad % (threads * kT) || n_lim < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t shm = (size_t)(kS > 0 ? 2 * kS + kK : 0) * kMaxThreads * sizeof(uint2);
  if (kS > 0) {
    const cudaError_t rc = cudaFuncSetAttribute(
        ring_cost_kernel<kS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shm);
    if (rc != cudaSuccess) return (int)rc;
  }
  if (B > 0) {
    ring_cost_kernel<kS><<<B, threads, shm, (cudaStream_t)stream>>>(
        (const uint8_t*)code, (const uint32_t*)pb0, (const uint32_t*)pb1,
        (const int32_t*)n, (const int32_t*)m, (const int32_t*)loend,
        (const int32_t*)ev, (int32_t*)out, n_max, B, S, SW, nw_pad, n_lim, 1u, 2u);
  }
  return (int)cudaGetLastError();
}

int launch_ring_ck_pp(const void* code, const void* pb0, const void* pb1,
                      const void* n, const void* m, const void* loend,
                      const void* ev, void* out, void* ck_vp, void* ck_vm,
                      void* ck_tv, const void* ckw0, int n_max, int B, int S,
                      int SW, int nw_pad, int threads, int CB, int n_ck,
                      void* stream) {
  if (threads < 32 || threads > kMaxThreads || threads % 32 ||
      nw_pad % (threads * kK) || n_max < 1 || CB < SW || n_ck < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (B > 0) {
    ring_ck_pp_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)code, (const uint32_t*)pb0, (const uint32_t*)pb1,
        (const int32_t*)n, (const int32_t*)m, (const int32_t*)loend,
        (const int32_t*)ev, (int32_t*)out, (uint32_t*)ck_vp, (uint32_t*)ck_vm,
        (int32_t*)ck_tv, (const int32_t*)ckw0, n_max, B, S, SW, nw_pad, CB, n_ck);
  }
  return (int)cudaGetLastError();
}

int launch_banded_ring(const void* code, const void* pb0, const void* pb1,
                       const void* n, const void* m, const void* loend,
                       const void* ev, void* out, int n_max, int B, int S,
                       int SW, int nw_pad, int n_lim, int ring, void* stream) {
  // A ring below a warp is a power of two of lanes, 32 / ring pairs a
  // one-warp block; a larger one is a block of whole warps, a pair a block.
  const bool sub = ring < 32;
  if (ring < 1 || ring > kMaxThreads || (sub ? (ring & (ring - 1)) != 0 : ring % 32 != 0) ||
      nw_pad % (ring * kK) || n_lim < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int per = sub ? 32 / ring : 1;
  if (B > 0) {
    banded_ring_kernel<<<(B + per - 1) / per, sub ? 32 : ring, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)code, (const uint32_t*)pb0, (const uint32_t*)pb1,
        (const int32_t*)n, (const int32_t*)m, (const int32_t*)loend,
        (const int32_t*)ev, (int32_t*)out, n_max, B, S, SW, nw_pad, n_lim, ring);
  }
  return (int)cudaGetLastError();
}

// A ring of `ring` threads: a power of two of lanes below a warp, 32 / ring
// pairs a one-warp block; or a block of whole warps up to `most`, a pair a
// block.  Returns the grid and block, or false.
bool ring_grid(int ring, int most, int nw_pad, int B, dim3& grid, dim3& block) {
  const bool sub = ring < 32;
  if (ring < 1 || ring > most || (sub ? (ring & (ring - 1)) != 0 : ring % 32 != 0) ||
      nw_pad % (ring * kK)) {
    return false;
  }
  const int per = sub ? 32 / ring : 1;
  grid = dim3((B + per - 1) / per);
  block = dim3(sub ? 32 : ring);
  return true;
}

int launch_banded_ring_pp(const void* code, const void* pb0, const void* pb1,
                          const void* n, const void* m, const void* loend,
                          const void* ev, void* out, int n_max, int B, int S,
                          int SW, int nw_pad, int ring, void* stream) {
  dim3 grid, block;
  if (!ring_grid(ring, kMaxRingThreads, nw_pad, B, grid, block) || n_max < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (B > 0) {
    banded_ring_pp_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)code, (const uint32_t*)pb0, (const uint32_t*)pb1,
        (const int32_t*)n, (const int32_t*)m, (const int32_t*)loend,
        (const int32_t*)ev, (int32_t*)out, n_max, B, S, SW, nw_pad, ring);
  }
  return (int)cudaGetLastError();
}

int launch_banded_ring_ck_pp(const void* code, const void* pb0, const void* pb1,
                             const void* n, const void* m, const void* loend,
                             const void* ev, void* out, void* ck_vp, void* ck_vm,
                             void* ck_tv, const void* ckw0, int n_max, int B, int S,
                             int SW, int nw_pad, int ring, int CB, int n_ck,
                             void* stream) {
  dim3 grid, block;
  if (!ring_grid(ring, kMaxRingThreads, nw_pad, B, grid, block) || n_max < 1 ||
      CB < 1 || n_ck < 1 || (CB < SW && n_ck > 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (B > 0) {
    banded_ring_ck_pp_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)code, (const uint32_t*)pb0, (const uint32_t*)pb1,
        (const int32_t*)n, (const int32_t*)m, (const int32_t*)loend,
        (const int32_t*)ev, (int32_t*)out, (uint32_t*)ck_vp, (uint32_t*)ck_vm,
        (int32_t*)ck_tv, (const int32_t*)ckw0, n_max, B, S, SW, nw_pad, CB, n_ck, ring);
  }
  return (int)cudaGetLastError();
}

int launch_banded_ring_fill(const void* code, const void* pb0, const void* pb1,
                            const void* n, const void* m, const void* loend,
                            const void* ev, void* out, void* vp_cols, void* vm_cols,
                            const void* tab, int n_max, int B, int S, int SW,
                            int nw_pad, int n_lim, int ring, void* stream) {
  dim3 grid, block;
  if (!ring_grid(ring, kMaxRingThreads, nw_pad, B, grid, block) || n_lim < 1 ||
      n_max < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (B > 0) {
    banded_ring_fill_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)code, (const uint32_t*)pb0, (const uint32_t*)pb1,
        (const int32_t*)n, (const int32_t*)m, (const int32_t*)loend,
        (const int32_t*)ev, (int32_t*)out, (uint32_t*)vp_cols, (uint32_t*)vm_cols,
        (const int32_t*)tab, n_max, B, S, SW, nw_pad, n_lim, ring);
  }
  return (int)cudaGetLastError();
}

// Ring K8: the shared schedule's costs and checkpoints under K2's rows
// (from the true window top), a ring a block, swept to n_max.
__global__ void __launch_bounds__(kMaxThreads) ring_ck_exact_kernel(
    const uint8_t* __restrict__ code, const uint32_t* __restrict__ pb0,
    const uint32_t* __restrict__ pb1, const int32_t* __restrict__ n,
    const int32_t* __restrict__ m, const int32_t* __restrict__ loend,
    const int32_t* __restrict__ ev, int32_t* __restrict__ out,
    uint32_t* __restrict__ ck_vp, uint32_t* __restrict__ ck_vm,
    int32_t* __restrict__ ck_tv, const int32_t* __restrict__ ckw0, int n_max,
    int B, int S, int SW, int nw_pad, int CB, int n_ck) {
  ring_body<0, kRingCk>(code, pb0, pb1, n, m, loend, ev, out, ck_vp, ck_vm, ck_tv,
                        ckw0, n_max, B, S, SW, nw_pad, n_max, CB, n_ck, 0);
}

// K2: the shared schedule's costs and checkpoints (K4's rows past a
// pair's end) under K1's rule, rings of `ring` threads.
__global__ void __launch_bounds__(kMaxRingThreads, 1) banded_ring_ck_kernel(
    const uint8_t* __restrict__ code, const uint32_t* __restrict__ pb0,
    const uint32_t* __restrict__ pb1, const int32_t* __restrict__ n,
    const int32_t* __restrict__ m, const int32_t* __restrict__ loend,
    const int32_t* __restrict__ ev, int32_t* __restrict__ out,
    uint32_t* __restrict__ ck_vp, uint32_t* __restrict__ ck_vm,
    int32_t* __restrict__ ck_tv, const int32_t* __restrict__ ckw0, int n_max,
    int B, int S, int SW, int nw_pad, int CB, int n_ck, int ring) {
  ring_body<0, kRingBandedCk>(code, pb0, pb1, n, m, loend, ev, out, ck_vp, ck_vm,
                              ck_tv, ckw0, n_max, B, S, SW, nw_pad, 1, CB, n_ck, ring);
}

// Ring K8's and K2's row cursors take windows of CB >= SW columns apart,
// or one window (checkpoint 1) whatever CB.
bool ck_interval_ok(int CB, int SW, int n_ck) {
  return CB >= 1 && n_ck >= 1 && (CB >= SW || n_ck <= 2);
}

int launch_ring_ck_exact(const void* code, const void* pb0, const void* pb1,
                         const void* n, const void* m, const void* loend,
                         const void* ev, void* out, void* ck_vp, void* ck_vm,
                         void* ck_tv, const void* ckw0, int n_max, int B, int S,
                         int SW, int nw_pad, int threads, int CB, int n_ck,
                         void* stream) {
  if (threads < 32 || threads > kMaxThreads || threads % 32 ||
      nw_pad % (threads * kK) || n_max < 1 || !ck_interval_ok(CB, SW, n_ck)) {
    return (int)cudaErrorInvalidValue;
  }
  if (B > 0) {
    ring_ck_exact_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)code, (const uint32_t*)pb0, (const uint32_t*)pb1,
        (const int32_t*)n, (const int32_t*)m, (const int32_t*)loend,
        (const int32_t*)ev, (int32_t*)out, (uint32_t*)ck_vp, (uint32_t*)ck_vm,
        (int32_t*)ck_tv, (const int32_t*)ckw0, n_max, B, S, SW, nw_pad, CB, n_ck);
  }
  return (int)cudaGetLastError();
}

int launch_banded_ring_ck(const void* code, const void* pb0, const void* pb1,
                          const void* n, const void* m, const void* loend,
                          const void* ev, void* out, void* ck_vp, void* ck_vm,
                          void* ck_tv, const void* ckw0, int n_max, int B, int S,
                          int SW, int nw_pad, int ring, int CB, int n_ck,
                          void* stream) {
  dim3 grid, block;
  if (!ring_grid(ring, kMaxRingThreads, nw_pad, B, grid, block) || n_max < 1 ||
      !ck_interval_ok(CB, SW, n_ck)) {
    return (int)cudaErrorInvalidValue;
  }
  if (B > 0) {
    banded_ring_ck_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)code, (const uint32_t*)pb0, (const uint32_t*)pb1,
        (const int32_t*)n, (const int32_t*)m, (const int32_t*)loend,
        (const int32_t*)ev, (int32_t*)out, (uint32_t*)ck_vp, (uint32_t*)ck_vm,
        (int32_t*)ck_tv, (const int32_t*)ckw0, n_max, B, S, SW, nw_pad, CB, n_ck, ring);
  }
  return (int)cudaGetLastError();
}

template <bool kCk, bool kPP>
int launch(const void* code, const void* pb0, const void* pb1, const void* n,
           const void* m, const void* loend, const void* ev, void* out,
           void* ck_vp, void* ck_vm, void* ck_tv, const void* ckw0, int n_max,
           int B, int S, int SW, int nw_pad, int n_lim, int threads, int CB,
           int n_ck, void* stream) {
  if (threads < 32 || threads > kMaxThreads || threads % 32 ||
      nw_pad % (threads * kK) || n_lim < 1 ||
      (kCk && (SW % 8 || CB < SW + 8 || n_ck < 1))) {
    return (int)cudaErrorInvalidValue;
  }
  if (B > 0) {
    pinned_ring_kernel<kCk, kPP><<<B, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)code, (const uint32_t*)pb0, (const uint32_t*)pb1,
        (const int32_t*)n, (const int32_t*)m, (const int32_t*)loend,
        (const int32_t*)ev, (int32_t*)out, (uint32_t*)ck_vp, (uint32_t*)ck_vm,
        (int32_t*)ck_tv, (const int32_t*)ckw0, n_max, B, S, SW, nw_pad, n_lim,
        CB, n_ck);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// C entries for ctypes.  All arrays are device pointers: code (B, n_max)
// uint8 char codes (pair-major); pb0/pb1 (S, B); n, m, loend (B,) int32; out
// (B,) int32.  The shared entries take ev (3, nw_pad) int32 per-word ent_t,
// top_t and abs_t, NEVER past the live words, nw_pad >= the live words + the
// ring; ring K6's also writes ck_vp/ck_vm (n_ck, SW+8, B) and ck_tv (n_ck, B)
// from ckw0 (n_ck,) window tops (SW % 8 == 0, CB >= SW + 8).  Ring K9's and
// ring K10's take ev (B, 3, nw_pad), each pair's rows so padded; ring K10's
// writes ck_vp/ck_vm (n_ck, SW, B) and ck_tv (n_ck, B) from ckw0 (n_ck, B)
// window tops (CB >= SW).  `threads` is the block size (a multiple of 32,
// <= 512): the ring holds threads * 8 words, which must cover
// ops/striped.py::ring_span(plan, n_lim) (n_lim = n_max for ring K6) or,
// for ring K9 and ring K10, every pair's ops/pinned.py::ring_span_pp (at
// n_max for ring K10).  K1's entry takes `ring`, the lanes a pair (a power
// of two below 32, or a warp multiple up to 512), whose ring must cover
// ring_span(plan, n_lim); K4's take `ring` too, on per-pair ev as ring
// K10's (banded_ring_ck_pp writing ring K10's outputs under K4's rows), and
// K3's writes vp_cols/vm_cols (B, n_max, SW) pair-major from tab (2 * n_max,)
// lo(c) then c * SW - lo(c) (n_max * SW < 2^31).  Ring K8's entry takes
// ring K10's arguments on shared ev (3, nw_pad) and ckw0 (n_ck,), writing
// (n_ck, SW, B) planes (CB >= SW, or n_ck <= 2); K2's takes K4's on the
// same shared tables, n_ck = ceil(n_max / CB).  The code buffer is padded
// past the last pair (ops/banded_kernel.py::CODE_PAD), as K7's.  Each launches on `stream`
// without synchronising and returns cudaGetLastError() (0 on success).
extern "C" {

int astarpa_pinned_cost(const void* code, const void* pb0, const void* pb1,
                        const void* n, const void* m, const void* loend,
                        const void* ev, void* out, int n_max, int B, int S,
                        int SW, int nw_pad, int n_lim, int threads,
                        void* stream) {
  return launch_cost<0>(code, pb0, pb1, n, m, loend, ev, out, n_max, B, S, SW,
                        nw_pad, n_lim, threads, stream);
}

int astarpa_ring_cost_wide(const void* code, const void* pb0, const void* pb1,
                           const void* n, const void* m, const void* loend,
                           const void* ev, void* out, int n_max, int B, int S,
                           int SW, int nw_pad, int n_lim, int threads,
                           int thread_words, void* stream) {
  if (thread_words == kK + 8) {
    return launch_cost<8>(code, pb0, pb1, n, m, loend, ev, out, n_max, B, S,
                          SW, nw_pad, n_lim, threads, stream);
  }
  if (thread_words == kK + 24) {
    return launch_cost<24>(code, pb0, pb1, n, m, loend, ev, out, n_max, B, S,
                           SW, nw_pad, n_lim, threads, stream);
  }
  return (int)cudaErrorInvalidValue;
}

int astarpa_ring_ck_pp(const void* code, const void* pb0, const void* pb1,
                       const void* n, const void* m, const void* loend,
                       const void* ev, void* out, void* ck_vp, void* ck_vm,
                       void* ck_tv, const void* ckw0, int n_max, int B, int S,
                       int SW, int nw_pad, int threads, int CB, int n_ck,
                       void* stream) {
  return launch_ring_ck_pp(code, pb0, pb1, n, m, loend, ev, out, ck_vp, ck_vm,
                           ck_tv, ckw0, n_max, B, S, SW, nw_pad, threads, CB,
                           n_ck, stream);
}

int astarpa_banded_ring(const void* code, const void* pb0, const void* pb1,
                        const void* n, const void* m, const void* loend,
                        const void* ev, void* out, int n_max, int B, int S,
                        int SW, int nw_pad, int n_lim, int ring, void* stream) {
  return launch_banded_ring(code, pb0, pb1, n, m, loend, ev, out, n_max, B, S,
                            SW, nw_pad, n_lim, ring, stream);
}

int astarpa_banded_ring_pp(const void* code, const void* pb0, const void* pb1,
                           const void* n, const void* m, const void* loend,
                           const void* ev, void* out, int n_max, int B, int S,
                           int SW, int nw_pad, int ring, void* stream) {
  return launch_banded_ring_pp(code, pb0, pb1, n, m, loend, ev, out, n_max, B, S, SW,
                               nw_pad, ring, stream);
}

int astarpa_banded_ring_ck_pp(const void* code, const void* pb0, const void* pb1,
                              const void* n, const void* m, const void* loend,
                              const void* ev, void* out, void* ck_vp, void* ck_vm,
                              void* ck_tv, const void* ckw0, int n_max, int B, int S,
                              int SW, int nw_pad, int ring, int CB, int n_ck,
                              void* stream) {
  return launch_banded_ring_ck_pp(code, pb0, pb1, n, m, loend, ev, out, ck_vp, ck_vm,
                                  ck_tv, ckw0, n_max, B, S, SW, nw_pad, ring, CB, n_ck,
                                  stream);
}

int astarpa_banded_ring_fill(const void* code, const void* pb0, const void* pb1,
                             const void* n, const void* m, const void* loend,
                             const void* ev, void* out, void* vp_cols, void* vm_cols,
                             const void* tab, int n_max, int B, int S, int SW,
                             int nw_pad, int n_lim, int ring, void* stream) {
  return launch_banded_ring_fill(code, pb0, pb1, n, m, loend, ev, out, vp_cols, vm_cols,
                                 tab, n_max, B, S, SW, nw_pad, n_lim, ring, stream);
}

int astarpa_ring_ck_exact(const void* code, const void* pb0, const void* pb1,
                          const void* n, const void* m, const void* loend,
                          const void* ev, void* out, void* ck_vp, void* ck_vm,
                          void* ck_tv, const void* ckw0, int n_max, int B, int S,
                          int SW, int nw_pad, int threads, int CB, int n_ck,
                          void* stream) {
  return launch_ring_ck_exact(code, pb0, pb1, n, m, loend, ev, out, ck_vp, ck_vm,
                              ck_tv, ckw0, n_max, B, S, SW, nw_pad, threads, CB,
                              n_ck, stream);
}

int astarpa_banded_ring_ck(const void* code, const void* pb0, const void* pb1,
                           const void* n, const void* m, const void* loend,
                           const void* ev, void* out, void* ck_vp, void* ck_vm,
                           void* ck_tv, const void* ckw0, int n_max, int B, int S,
                           int SW, int nw_pad, int ring, int CB, int n_ck,
                           void* stream) {
  return launch_banded_ring_ck(code, pb0, pb1, n, m, loend, ev, out, ck_vp, ck_vm,
                               ck_tv, ckw0, n_max, B, S, SW, nw_pad, ring, CB, n_ck,
                               stream);
}

int astarpa_ring_ck(const void* code, const void* pb0, const void* pb1,
                    const void* n, const void* m, const void* loend,
                    const void* ev, void* out, void* ck_vp, void* ck_vm,
                    void* ck_tv, const void* ckw0, int n_max, int B, int S,
                    int SW, int nw_pad, int n_lim, int threads, int CB,
                    int n_ck, void* stream) {
  return launch<true, false>(code, pb0, pb1, n, m, loend, ev, out, ck_vp,
                             ck_vm, ck_tv, ckw0, n_max, B, S, SW, nw_pad,
                             n_lim, threads, CB, n_ck, stream);
}

int astarpa_ring_cost_pp(const void* code, const void* pb0, const void* pb1,
                         const void* n, const void* m, const void* loend,
                         const void* ev, void* out, int n_max, int B, int S,
                         int SW, int nw_pad, int threads, void* stream) {
  return launch<false, true>(code, pb0, pb1, n, m, loend, ev, out, nullptr,
                             nullptr, nullptr, nullptr, n_max, B, S, SW,
                             nw_pad, 1, threads, 1, 0, stream);
}

}  // extern "C"
