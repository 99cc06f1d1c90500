"""Pinned-word big-band DP on per-pair schedules: the plan, ring K9's ring
capacity (:func:`ring_span_pp`) and the plain torch versions of kernels K9
(costs) and K10 (costs and checkpoints).

Counterpart of the per-pair half of ``astarpa_tpu/ops/pinned.py``
(``pinned_cost_pp_tpu``, ``pinned_ck_pp_tpu``).  It is the striped DP of
:mod:`.striped` with each pair's band on its own schedule: before column
``c`` pair p's band covers words ``[lo_p(c), lo_p(c) + SW)`` with ``lo_p``
the running sum of its (n_max,) 0/1 schedule column, and the per-word
enter, top and absorb steps of :func:`.striped.plan_striped` become
per-pair tables (:func:`plan_pp`).  Word w runs column ``t - w`` at step
t, as there; the profile row of a word past the last one is clamped to
``S - 1``, as the per-pair sliding kernel (K4) clamps its entering word.

Results are ``<=`` K4's on the same schedule (the reference's contract) and
``INF`` where the band misses row m at the pair's last column.  K10 writes
**K4's checkpoint contract** (:func:`.banded.banded_ck_pp_ref`), so the
runner's staging and the native ``trace_banded_ck`` read the planes as
they read K4's: ``CB`` from :func:`.banded.ck_col_block` (rounded to whole
quantum groups), ``n_ck = ceil(n_max / CB)``, checkpoint ``k >= 1`` the
state after column ``k*CB - 1`` in rows ``w - lo_p(k*CB - 1)`` of (n_ck, SW,
B) planes, top value the pair's absorbed sum plus ``k*CB``; checkpoint 0
the all-ones state.  Every row of every checkpoint is the DP's (the band
runs to n_max in ck mode), past a pair's end too, so the card comparison
covers every byte.  ``CB >= SW`` is required (the reference's
precondition), on both routes.

The plain versions step ``t`` in a Python loop vectorised over the union
of the pairs' live word ranges and the pairs, with per-pair masks; the CPU
runs them, the card compares its kernels (``csrc/striped.cu``, ring K9 in
``csrc/pinned.cu``) against them.
"""

from __future__ import annotations

import numpy as np
import torch

from .banded import INF, check_schedule, ck_col_block
from .bitpack import W
from .striped import NEVER
from .words import ONES, myers_word, popcount, prefix_mask, to_tensor


def check_pp_schedule(schedule, n_max: int, B: int, quantum: int,
                      column0: bool = False) -> np.ndarray:
    """:func:`.banded.check_schedule` (0/1, shape, shifts only at multiples
    of ``quantum``, so at most one shift per column) plus the pinned
    kernels' own condition: column 0 unshifted (every band starts at word
    0), unless ``column0`` (K4's ring, whose step starts the band top's
    codes at step 0 when word 0 leaves at once).  Returns the schedule as
    contiguous uint8."""
    sched = check_schedule(schedule, n_max, B, quantum)
    if not column0 and sched[:1].any():
        raise ValueError("pinned per-pair schedule: column 0 must be unshifted")
    return sched


def plan_pp(sched: np.ndarray, n, SW: int, device, pad_to: int = 1) -> dict:
    """The per-pair plan of one round, as torch tensors on ``device``
    (``sched`` a checked host (n_max, B) schedule, ``n`` the (B,) lengths):

    - ``lo`` (B, n_max) int32: pair p's band top during column c;
    - ``loend`` (B,) int32: ``lo_p(clip(n_p - 1, 0, n_max - 1))``;
    - ``nwl`` (B,) int64 host: words that ever enter pair p's band,
      ``lo_p(n_max - 1) + SW``;
    - ``ent_t``, ``top_t``, ``abs_t`` (B, nw) int32: pair p's per-word
      event steps (those of :func:`.striped.plan_striped` on ``lo_p``),
      ``NEVER`` for words ``>= nwl_p``; ``nw`` is ``max(nwl)`` rounded up
      to a multiple of ``pad_to``;
    - ``T``: steps ``0..T-1`` cover every pair's every word and column.
    """
    n_max, B = sched.shape
    nwl = sched.sum(axis=0, dtype=np.int64) + SW
    nw = -(-int(nwl.max(initial=SW)) // pad_to) * pad_to
    s = to_tensor(sched, device)
    lo = torch.cumsum(s.T, dim=1, dtype=torch.int32).contiguous()
    w = torch.arange(nw, dtype=torch.int32, device=device).expand(B, nw).contiguous()
    enterc = torch.searchsorted(lo, (w - SW + 1).clamp(min=0), out_int32=True)
    exitc = torch.searchsorted(lo, w + 1, out_int32=True)
    live = w < to_tensor(nwl, device)[:, None]
    ent_t = torch.where(live, enterc + w, NEVER)
    abs_t = torch.where(live & (exitc < n_max), exitc + w, NEVER)
    # Word w is the top from the step after word w-1's absorb.
    top_t = torch.cat([torch.zeros_like(abs_t[:, :1]),
                       (abs_t[:, :-1] + 1).clamp(max=NEVER)], 1)
    last = torch.as_tensor(np.clip(np.asarray(n, np.int64) - 1, 0, n_max - 1), device=device)
    loend = lo.gather(1, last[:, None])[:, 0]
    return dict(lo=lo, loend=loend, nwl=nwl, ent_t=ent_t, top_t=top_t,
                abs_t=abs_t, T=n_max + int(nwl.max(initial=SW)) - 1)


def ring_span_pp(plan: dict, n_lim, SW: int) -> torch.Tensor:
    """Most words live at once in each pair's cost sweep of ``plan`` (from
    :func:`plan_pp`) when pair p's words stop after its column ``n_lim[p]
    - 1``: (B,) int64 on the plan's device, the ring capacity ring K9 needs
    for each pair.  Per pair, :func:`.striped.ring_span` on ``lo_p``: word
    w is live at steps ``[ent_t[w], end_t[w])``, ``end_t`` the step after
    its absorb or its column ``n_lim[p] - 1``; only steps before the one
    after the pair's last capture, ``n_lim[p] - 1 + lo_p(n_lim[p] - 1) +
    SW``, count.  It never exceeds SW."""
    ent, ab, lo = plan["ent_t"].long(), plan["abs_t"].long(), plan["lo"]
    dev = ent.device
    n_lim = torch.as_tensor(n_lim, device=dev).long().clamp(1, lo.shape[1])
    w = torch.arange(ent.shape[1], device=dev)
    end = torch.minimum(torch.where(ab < NEVER, ab + 1, NEVER), n_lim[:, None] + w)
    t_stop = n_lim - 1 + lo.gather(1, (n_lim - 1)[:, None])[:, 0].long() + SW
    # Both ent_t and end_t rise strictly with w: the live words at an entry
    # step are the run from the first word not yet ended.
    span = w + 1 - torch.searchsorted(end, ent, right=True)
    return torch.where(ent < t_stop[:, None], span, 0).amax(1)


def ck_layout_pp(col_block: int, n_max: int, quantum: int, SW: int) -> tuple[int, int]:
    """``(CB, n_ck)`` of K10: K4's Q-rounded interval and checkpoint count.
    Raises when ``CB < SW``: the reference refuses it too, and clamping CB
    here would desync the trace, which reads the caller's CB."""
    CB = ck_col_block(col_block, n_max, quantum)
    if CB < SW:
        raise ValueError(f"pinned ck: col_block {CB} < band_words {SW}")
    return CB, -(-n_max // CB)


def ck_tops(lo: torch.Tensor, CB: int, n_ck: int) -> torch.Tensor:
    """(n_ck, B) int32 window tops of the checkpoints: ``lo_p(k*CB - 1)``,
    0 for checkpoint 0."""
    cols = torch.arange(1, n_ck, device=lo.device) * CB - 1
    return torch.cat([torch.zeros_like(lo[:, :1]), lo[:, cols]], 1).T.contiguous()


def _sweep_pp(a0, a1, pb0, pb1, n, m, schedule, band_words: int, quantum: int,
              col_block=None, freeze: bool = False):
    """The staggered loop the plain versions share; returns ``(costs,
    ck)`` with ``ck = (ck_vp, ck_vm, ck_tv)`` when ``col_block`` is set.

    ``freeze``: K4's contract past a pair's end instead of K10's.  A word
    steps no column ``>= n_p`` (its state stays the one after column ``n_p
    - 1``; a word entering later stays all-ones), so a checkpoint past the
    end holds the finished window, slid; its top value is ``min(k*CB,
    n_p)`` plus every value absorbed above its window top, past the end
    too (K4's ``top_val``).  Costs do not change.  It also takes a schedule
    shifted at column 0 (word 0 enters and leaves at step 0, as K4 absorbs
    its all-ones top word before column 0)."""
    n_max, B = a0.shape
    S = pb0.shape[0]
    SW = min(band_words, S)
    dev = a0.device
    sched = check_pp_schedule(schedule, n_max, B, quantum, column0=freeze)
    n_host = np.asarray(torch.as_tensor(n).cpu(), np.int64)
    m_host = np.asarray(torch.as_tensor(m).cpu(), np.int64)
    if col_block is not None:
        CB, n_ck = ck_layout_pp(col_block, n_max, quantum, SW)
    plan = plan_pp(sched, n_host, SW, dev)
    T, nw = plan["T"], plan["ent_t"].shape[1]
    n_t = torch.as_tensor(n_host, dtype=torch.int32, device=dev)
    m_t = torch.as_tensor(m_host, dtype=torch.int32, device=dev)
    loend = plan["loend"]
    # Word-major event tables with a NEVER row past the last word, so a
    # pair's cursor at nw still reads a step that never comes.
    never = torch.full((1, B), NEVER, dtype=torch.int32, device=dev)
    ent_T = torch.cat([plan["ent_t"].T, never])
    abs_T = torch.cat([plan["abs_t"].T, never])
    pair = torch.arange(B, device=dev)

    vp = torch.full((nw, B), ONES, dtype=torch.int32, device=dev)
    vm = torch.zeros((nw, B), dtype=torch.int32, device=dev)
    # Each word's h carries out of its last step (word w+1 reads them).
    hp_out = torch.zeros((nw, B), dtype=torch.int32, device=dev)
    hm_out = torch.zeros((nw, B), dtype=torch.int32, device=dev)
    acc = torch.zeros(B, dtype=torch.int32, device=dev)
    acc_all = torch.zeros(B, dtype=torch.int32, device=dev)  # past the end too
    cap = torch.zeros(B, dtype=torch.int32, device=dev)
    A = torch.zeros(B, dtype=torch.long, device=dev)  # next word to absorb
    E = torch.zeros(B, dtype=torch.long, device=dev)  # next word to enter
    one = torch.ones(1, B, dtype=torch.int32, device=dev)
    zero = torch.zeros(1, B, dtype=torch.int32, device=dev)
    w_all = torch.arange(nw, device=dev)

    # Cost capture: word t+1-n at step t, inside [loend, loend+SW).
    valid = n_host > 0
    loend_host = plan["loend"].cpu().numpy().astype(np.int64)
    cap_lo = int((n_host - 1 + loend_host)[valid].min()) if valid.any() else T
    cap_hi = int((n_host - 1 + loend_host + SW)[valid].max()) if valid.any() else 0

    ck = ck_at = None
    if col_block is not None:
        ckw0 = ck_tops(plan["lo"], CB, n_ck)
        ck = (torch.zeros((n_ck, SW, B), dtype=torch.int32, device=dev),
              torch.zeros((n_ck, SW, B), dtype=torch.int32, device=dev),
              torch.zeros((n_ck, B), dtype=torch.int32, device=dev))
        ck[0][0] = ONES
        # Step -> checkpoints: word w of window k is taken at k*CB - 1 + w.
        ck_at = {}
        lo_min = ckw0.min(1).values.cpu().numpy()
        lo_max = ckw0.max(1).values.cpu().numpy()
        for k in range(1, n_ck):
            for w in range(int(lo_min[k]), int(lo_max[k]) + SW):
                ck_at.setdefault(k * CB - 1 + w, []).append(k)

    for t in range(T):
        e_sel = ent_T[E, pair] == t
        if bool(e_sel.any()):
            rows = E.clamp(max=nw - 1)
            vp[rows, pair] = torch.where(e_sel, ONES, vp[rows, pair])
            vm[rows, pair] = torch.where(e_sel, 0, vm[rows, pair])
            E += e_sel
        a_sel = abs_T[A, pair] == t
        if bool(a_sel.any()):
            rows = A.clamp(max=nw - 1)
            alive = t - A <= n_t - 1
            val = popcount(vp[rows, pair]) - popcount(vm[rows, pair])
            acc += torch.where(a_sel & alive, val, 0)
            acc_all += torch.where(a_sel, val, 0)
            A += a_sel
        lo_w, hi_w = int(A.min()), int(E.max())
        if lo_w >= hi_w:
            continue
        ws = w_all[lo_w:hi_w]
        live = (ws[:, None] >= A[None, :]) & (ws[:, None] < E[None, :])
        if freeze:
            live &= (t - ws)[:, None] < n_t[None, :]
        cols = (t - ws).clamp(0, n_max - 1)
        prow = ws.clamp(max=S - 1)
        eq = (a0[cols] ^ pb0[prow]) & (a1[cols] ^ pb1[prow])
        # Word w takes word w-1's carry of step t-1; the top word (first
        # live one, where no absorb happened this step) takes the +1 carry.
        # A newly first word after an absorb takes the absorbed word's.
        if lo_w == 0:
            hp_in = torch.cat([one, hp_out[:hi_w - 1]])
            hm_in = torch.cat([zero, hm_out[:hi_w - 1]])
        else:
            hp_in, hm_in = hp_out[lo_w - 1:hi_w - 1], hm_out[lo_w - 1:hi_w - 1]
        top = (ws[:, None] == A[None, :]) & ~a_sel[None, :]
        hp_in = torch.where(top, 1, hp_in)
        hm_in = torch.where(top, 0, hm_in)
        got = myers_word(eq, vp[lo_w:hi_w], vm[lo_w:hi_w], hp_in, hm_in)
        for x, g in zip((vp, vm, hp_out, hm_out), got):
            x[lo_w:hi_w] = torch.where(live, g, x[lo_w:hi_w])
        if cap_lo <= t < cap_hi:
            wc = t + 1 - n_t
            sel = (n_t > 0) & (wc >= loend) & (wc < loend + SW)
            idx = wc.clamp(0, nw - 1).long()[None, :]
            mask = prefix_mask((m_t - wc * W).clamp(0, W))
            val = popcount(vp.gather(0, idx)[0] & mask) - popcount(vm.gather(0, idx)[0] & mask)
            cap += torch.where(sel, val, 0)
        if ck_at is not None and t in ck_at:
            for k in ck_at[t]:
                w = t + 1 - k * CB
                row = w - ckw0[k]
                ok = (row >= 0) & (row < SW)
                r, p = row[ok].long(), pair[ok]
                ck[0][k, r, p] = vp[w, p]
                ck[1][k, r, p] = vm[w, p]
                tv = acc_all + n_t.clamp(max=k * CB) if freeze else acc + k * CB
                ck[2][k] = torch.where(row == 0, tv, ck[2][k])
    covered = (m_t - loend * W) <= SW * W
    costs = torch.where(covered, acc + cap + n_t, INF)
    return costs, ck


def pinned_cost_pp_ref(a0, a1, pb0, pb1, n, m, schedule, band_words: int,
                       quantum: int = 1) -> torch.Tensor:
    """Banded edit distances on per-pair schedules at any band height: the
    plain version of kernel K9, bit-identical to the reference's
    ``pinned_cost_pp_tpu``.

    Args as :func:`.banded.banded_cost_pp_ref` (``schedule`` a host (n_max,
    B) 0/1 array shifting only at multiples of ``quantum``, column 0
    unshifted).  Returns (B,) int32 on the planes' device: ``<=`` K4's
    result, ``INF`` where the band misses row ``m`` at column ``n-1``; a
    pair with ``n == 0`` gives 0."""
    return _sweep_pp(a0, a1, pb0, pb1, n, m, schedule, band_words, quantum)[0]


def pinned_ck_pp_ref(a0, a1, pb0, pb1, n, m, schedule, band_words: int,
                     col_block: int, quantum: int = 1):
    """K9 plus checkpoints: the plain version of kernel K10, the
    reference's ``pinned_ck_pp_tpu`` on every checkpoint a trace reads.

    Returns ``(costs (B,), ck_vp (n_ck, SW, B), ck_vm, ck_tv (n_ck, B))``
    under K4's checkpoint contract (module docstring).  Raises when the
    Q-rounded interval is below ``SW = min(band_words, S)``."""
    costs, ck = _sweep_pp(a0, a1, pb0, pb1, n, m, schedule, band_words, quantum,
                          col_block)
    return (costs,) + ck


def k4_ring_takes(n_max: int, SW: int, col_block: int, quantum: int) -> bool:
    """Whether K4's checkpoint ring (``banded_ring_ck_pp_kernel`` in
    ``csrc/pinned.cu``, whose plain twin is
    :func:`banded_ck_pp_staggered_ref`) takes this interval: not a
    Q-rounded one below SW with more than one checkpoint, whose windows
    overlap (K4 allows it, ring K10's row cursor does not).  The domain
    ladder's intervals are at least SW + 8 unless n_max clamps them; the
    wrapper sends what the ring refuses to the old K4, a test on the host
    made before the launch.  K4's cost ring takes every schedule."""
    CB = ck_col_block(col_block, n_max, quantum)
    return CB >= SW or -(-n_max // CB) == 1


def banded_cost_pp_staggered_ref(a0, a1, pb0, pb1, n, m, schedule, band_words: int,
                                 quantum: int = 32) -> torch.Tensor:
    """K4's costs (:func:`.banded.banded_cost_pp_ref`) from the staggered
    sweep on the per-pair plan (:func:`plan_pp`): the plain twin of K4's
    ring kernel, bit for bit K4's plain version.  The staggered DP is K9's
    (``<=`` K4's in the reference, equal in the port: every word's profile
    row is clamped at ``S - 1`` as K4 clamps its entering word, and no word
    below the band bottom runs); K4's rule differs from K9's only at ``n
    == 0`` (cost ``m``, where K9 gives 0).  Row m above the window at
    column n-1 gives the absorbed sum plus n (K4's ``top_val``), below it
    ``INF``.  A schedule shifted at column 0 is taken, as K4 takes it
    (K9 and K10 refuse it)."""
    costs = _sweep_pp(a0, a1, pb0, pb1, n, m, schedule, band_words, quantum,
                      freeze=True)[0]
    return _k1_rule(costs, n, m)


def banded_ck_pp_staggered_ref(a0, a1, pb0, pb1, n, m, schedule, band_words: int,
                               col_block: int, quantum: int = 32):
    """K4's costs and checkpoints (:func:`.banded.banded_ck_pp_ref`) from
    the staggered sweep, the plain twin of K4's checkpoint ring: K10's rows
    (word w of checkpoint k taken at step ``k*CB - 1 + w``) with K4's
    contract past a pair's end (``freeze``: no word steps a column ``>=
    n_p``, the top value counts every absorbed word and ``min(k*CB,
    n_p)``).  Raises when the Q-rounded interval is below SW
    (:func:`ck_layout_pp`; :func:`k4_ring_takes`)."""
    costs, ck = _sweep_pp(a0, a1, pb0, pb1, n, m, schedule, band_words, quantum,
                          col_block, freeze=True)
    return (_k1_rule(costs, n, m),) + ck


def _k1_rule(costs: torch.Tensor, n, m) -> torch.Tensor:
    """K1's and K4's cost of a pair with no column: m (the staggered sweep
    gives 0)."""
    n_t = torch.as_tensor(np.asarray(torch.as_tensor(n).cpu(), np.int64), device=costs.device)
    m_t = torch.as_tensor(np.asarray(torch.as_tensor(m).cpu(), np.int64), device=costs.device)
    return torch.where(n_t == 0, m_t.to(torch.int32), costs)
