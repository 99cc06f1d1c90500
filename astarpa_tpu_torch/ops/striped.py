"""Striped pinned-word big-band DP: the host plan and the plain torch
versions of kernels K5 and K7 (costs), K6 and K8 (costs and checkpoints).

Counterpart of ``astarpa_tpu/ops/striped.py`` (``striped_cost_tpu``,
``striped_ck_tpu``) and of the shared-schedule half of
``astarpa_tpu/ops/pinned.py`` (``pinned_cost_tpu``, ``pinned_ck_tpu``).  Words are pinned to
absolute indices and staggered: at step ``t`` word ``w`` runs column ``t -
w``, taking the h carry that word ``w-1`` produced at step ``t-1`` (the
same column).  So every word of the band is independent within a step, and
the band has no height limit: ``band_words >= S`` is the exact full-height
DP.  The band follows the
shared bucket schedule of :func:`.banded.shift_at_array`: before column
``c`` it covers words ``[lo(c), lo(c) + SW)``, and its boundaries become
per-word events computed on the host (:func:`plan_striped`):

- enter: word ``w`` joins at the band bottom at step ``ent_t[w]`` and
  restarts from the all-ones column;
- absorb: word ``w`` leaves at the band top at step ``abs_t[w]``; its value
  joins the pair's running top sum when its column is ``<= n-1``;
- top: word ``w`` is the band top at steps ``[top_t[w], abs_t[w])`` and
  takes the +1 carry there (no word is the top at an absorb step);
- capture: at each pair's last column the banded words' values, masked to
  row ``m``, are added (word ``t + 1 - n`` at step ``t``).

The results equal the sliding kernel's (K1) wherever the window covers row
``m`` at column ``n-1``, and are ``INF`` elsewhere (the reference's
``covered`` rule).  K6 adds checkpoints under the 8-aligned-top row
contract of ``striped_ck_tpu``: checkpoint ``k >= 1`` is the state after
column ``k*CB - 1``, with plane rows covering words ``[w0 & ~7, (w0 & ~7)
+ SW + 8)`` for the true window top ``w0 = lo(k*CB - 1)``; checkpoint 0 is
the initial all-ones state.  Rows outside the true window ``[w0, w0+SW)``
are never read by a trace; both the plain version and the kernel write
zeros there (the reference leaves them undefined).  K8 takes the same
checkpoints under K2's row contract (:func:`.banded.banded_ck_ref`): SW
rows from the true window top, ``w - lo(k*CB - 1)``, so the trace reads
its planes as it reads K2's; it takes any SW (:func:`pinned_ck_layout`).
K7 computes K5's costs from a ring of resident words, sized by
:func:`ring_span`, and K1's ring kernel K1's costs the same way
(:func:`banded_cost_staggered_ref`).

The plain versions step ``t`` in a Python loop, vectorised over the live
words ``[next to absorb, next to enter)`` and the pairs; the CPU runs them,
the card compares its kernels (``csrc/striped.cu``, ``csrc/pinned.cu``)
against them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .banded import INF, shift_at_array
from .bitpack import W
from .words import ONES, myers_word, popcount, prefix_mask

#: Event time of an event that never happens.
NEVER = 1 << 30


@functools.lru_cache(maxsize=32)
def plan_striped(n_max: int, S: int, SW: int, diag: tuple | None = None) -> dict:
    """The host plan of one geometry (the reference's ``_plan_striped``,
    without the TPU's block-activity flags and stripe ownership windows):

    - ``lo`` (n_max,): band top word before column c (shifts included);
    - ``n_words_live``: words that ever enter the band (``lo[-1] + SW``);
    - ``ent_t``, ``top_t``, ``abs_t`` (n_words_live,) int32: the per-word
      event steps above (``NEVER`` for a word never absorbed);
    - ``T``: steps ``0..T-1`` cover every word's every column.

    The arrays are shared between calls and read-only."""
    SW = min(SW, S)
    shift = shift_at_array(n_max, S, SW, diag)
    lo = np.cumsum(shift).astype(np.int64)
    nwl = int(lo[-1]) + SW
    w = np.arange(nwl, dtype=np.int64)
    enterc = np.searchsorted(lo, np.maximum(w - SW + 1, 0), side="left")
    exitc = np.searchsorted(lo, w + 1, side="left")
    ent_t = (enterc + w).astype(np.int32)
    abs_t = np.where(exitc < n_max, exitc + w, NEVER).astype(np.int32)
    # Word w is the top from the step after word w-1's absorb.
    top_t = np.concatenate([[0], np.minimum(abs_t[:-1].astype(np.int64) + 1,
                                            NEVER)]).astype(np.int32)
    for x in (lo, ent_t, top_t, abs_t):
        x.setflags(write=False)
    return dict(lo=lo, n_words_live=nwl, ent_t=ent_t, top_t=top_t,
                abs_t=abs_t, T=n_max + nwl - 1)


def loend_of(lo: np.ndarray, n) -> np.ndarray:
    """Band top at each pair's last column, ``lo[clip(n-1, 0, n_max-1)]``."""
    n = np.asarray(n, np.int64)
    return lo[np.clip(n - 1, 0, len(lo) - 1)].astype(np.int32)


def ck_tops(lo: np.ndarray, CB: int, n_ck: int) -> np.ndarray:
    """(n_ck,) int32 true window tops ``lo[k*CB - 1]``, 0 for checkpoint 0."""
    ckw0 = np.zeros(n_ck, np.int32)
    ckw0[1:] = lo[np.arange(1, n_ck) * CB - 1]
    return ckw0


def ck_layout(n_max: int, SW: int, col_block: int, lo: np.ndarray):
    """Checkpoint geometry of K6: ``(CB, n_ck, ckw0)`` with ``CB =
    min(col_block, n_max)``, ``n_ck = n_max // CB + 1`` and ``ckw0[k]`` the
    true window top of checkpoint k (``ckw0[0] = 0``).

    Raises unless ``SW % 8 == 0`` and ``col_block >= SW + 8``: the
    reference clamps a smaller CB up without a word (``striped_ck_tpu``),
    the port refuses it."""
    if SW % 8:
        raise ValueError(f"striped ck: band_words must be a multiple of 8, got {SW}")
    if col_block < SW + 8:
        raise ValueError(f"striped ck: col_block {col_block} < band_words + 8 = {SW + 8}")
    CB = min(col_block, max(n_max, 1))
    n_ck = n_max // CB + 1
    return CB, n_ck, ck_tops(lo, CB, n_ck)


def pinned_ck_fits(n_max: int, SW: int, CB: int) -> bool:
    """K8's interval contract for ``CB <= n_max``: ``CB >= SW``, or a single
    capture window (``n_max // CB + 1 <= 2``).  Word w of checkpoint k is
    taken at step ``k*CB - 1 + w``, so windows of SW words overlap below
    ``CB = SW``.  The reference clamps CB up to SW (``pinned_ck_tpu``); the
    port refuses it, since the trace reads the caller's CB.  Its other
    clamp, ``CB = n_max`` in a bucket shorter than the band (a skewed one at
    full height), gives one window and fits."""
    return CB >= SW or n_max // CB + 1 <= 2


def pinned_ck_layout(n_max: int, SW: int, col_block: int, lo: np.ndarray):
    """Checkpoint geometry of K8: ``(CB, n_ck, ckw0)`` as :func:`ck_layout`
    (``CB = min(col_block, n_max)``, ``n_ck = n_max // CB + 1``), for any SW.
    Raises unless :func:`pinned_ck_fits`."""
    CB = min(col_block, max(n_max, 1))
    if CB < 1:
        raise ValueError(f"pinned ck: col_block must be >= 1, got {col_block}")
    n_ck = n_max // CB + 1
    if not pinned_ck_fits(n_max, SW, CB):
        raise ValueError(f"pinned ck: col_block {CB} < band_words {SW} with "
                         f"{n_ck - 1} capture windows")
    return CB, n_ck, ck_tops(lo, CB, n_ck)


def _sweep(a0, a1, pb0, pb1, n, m, band_words: int, diag, col_block=None,
           exact_top: bool = False, fill: bool = False):
    """The staggered loop the plain versions share; returns ``(costs,
    ck)`` with ``ck = (ck_vp, ck_vm, ck_tv)`` when ``col_block`` is set:
    K6's 8-aligned-top rows, or K8's rows from the true top when
    ``exact_top``; with ``fill``, ``ck = (vp_cols, vm_cols)``, K3's (n_max,
    SW, B) planes: word w's state after column c (at step c + w) in row c,
    position ``w - lo(c)``, and no word steps a column ``>= n_p``, so a
    finished pair's rows hold its last window, slid, and words entering
    after its end stay all-ones (K3's contract past a pair's end)."""
    n_max, B = a0.shape
    S = pb0.shape[0]
    SW = min(band_words, S)
    plan = plan_striped(n_max, S, SW, diag)
    nwl, T = plan["n_words_live"], plan["T"]
    ent_t, abs_t = plan["ent_t"], plan["abs_t"]
    dev = a0.device
    n_host = np.asarray(torch.as_tensor(n).cpu(), np.int64)
    m_host = np.asarray(torch.as_tensor(m).cpu(), np.int64)
    loend_host = loend_of(plan["lo"], n_host)
    n_t = torch.as_tensor(n_host, dtype=torch.int32, device=dev)
    m_t = torch.as_tensor(m_host, dtype=torch.int32, device=dev)
    loend = torch.as_tensor(loend_host, dtype=torch.int32, device=dev)

    vp = torch.full((nwl, B), ONES, dtype=torch.int32, device=dev)
    vm = torch.zeros((nwl, B), dtype=torch.int32, device=dev)
    # Each word's h carries out of its last step (word w+1 reads them).
    hp_out = torch.zeros((nwl, B), dtype=torch.int32, device=dev)
    hm_out = torch.zeros((nwl, B), dtype=torch.int32, device=dev)
    acc = torch.zeros(B, dtype=torch.int32, device=dev)
    cap = torch.zeros(B, dtype=torch.int32, device=dev)
    one = torch.ones(1, B, dtype=torch.int32, device=dev)
    zero = torch.zeros(1, B, dtype=torch.int32, device=dev)
    w_all = torch.arange(nwl, device=dev)

    # Cost capture: word t+1-n at step t, inside [loend, loend+SW).
    valid = n_host > 0
    cap_lo = int((n_host - 1 + loend_host)[valid].min()) if valid.any() else T
    cap_hi = int((n_host - 1 + loend_host + SW)[valid].max()) if valid.any() else 0

    ck = ck_at = None
    if fill:
        ck = (torch.empty((n_max, SW, B), dtype=torch.int32, device=dev),
              torch.empty((n_max, SW, B), dtype=torch.int32, device=dev))
        lo_t = torch.tensor(plan["lo"], device=dev)
    if col_block is not None:
        layout = pinned_ck_layout if exact_top else ck_layout
        CB, n_ck, ckw0 = layout(n_max, SW, col_block, plan["lo"])
        SWP = SW if exact_top else SW + 8
        ck = (torch.zeros((n_ck, SWP, B), dtype=torch.int32, device=dev),
              torch.zeros((n_ck, SWP, B), dtype=torch.int32, device=dev),
              torch.zeros((n_ck, B), dtype=torch.int32, device=dev))
        ck[0][0] = ONES
        # Step -> checkpoint: word w of window k is taken at k*CB - 1 + w.
        # CB >= SW keeps the windows' steps apart (or there is one window).
        ck_at = {}
        for k in range(1, n_ck):
            for w in range(int(ckw0[k]), int(ckw0[k]) + SW):
                ck_at[k * CB - 1 + w] = k

    A = E = 0  # next word to absorb, next word to enter
    for t in range(T):
        if E < nwl and ent_t[E] == t:
            vp[E], vm[E] = ONES, 0
            E += 1
        was_abs = A < nwl and abs_t[A] == t
        if was_abs:
            alive = t - A <= n_t - 1
            acc += torch.where(alive, popcount(vp[A]) - popcount(vm[A]), 0)
            A += 1
        if A >= E:
            continue
        ws = w_all[A:E]
        cols = (t - ws).clamp(max=n_max - 1)
        eq = (a0[cols] ^ pb0[ws]) & (a1[cols] ^ pb1[ws])
        if was_abs:  # the new first word takes the absorbed word's carry
            hp_in, hm_in = hp_out[A - 1:E - 1], hm_out[A - 1:E - 1]
        else:  # the first live word is the top: +1 carry
            hp_in = torch.cat([one, hp_out[A:E - 1]])
            hm_in = torch.cat([zero, hm_out[A:E - 1]])
        got = myers_word(eq, vp[A:E], vm[A:E], hp_in, hm_in)
        if fill:
            keep = (t - ws)[:, None] < n_t[None, :]  # no column past the pair's end
            got = [torch.where(keep, g, x[A:E]) for g, x in zip(got, (vp, vm, hp_out, hm_out))]
        vp[A:E], vm[A:E], hp_out[A:E], hm_out[A:E] = got
        if fill:
            c = t - ws
            ok = c < n_max
            c, w = c[ok], ws[ok]
            pos = w - lo_t[c]
            ck[0][c, pos], ck[1][c, pos] = vp[w], vm[w]
        if cap_lo <= t < cap_hi:
            wc = t + 1 - n_t
            sel = (n_t > 0) & (wc >= loend) & (wc < loend + SW)
            idx = wc.clamp(0, nwl - 1).long()[None, :]
            mask = prefix_mask((m_t - wc * W).clamp(0, W))
            got = popcount(vp.gather(0, idx)[0] & mask) - popcount(vm.gather(0, idx)[0] & mask)
            cap += torch.where(sel, got, 0)
        if ck_at is not None and t in ck_at:
            k = ck_at[t]
            w = t + 1 - k * CB
            row = w - (int(ckw0[k]) if exact_top else int(ckw0[k]) & ~7)
            ck[0][k, row], ck[1][k, row] = vp[w], vm[w]
            if w == ckw0[k]:
                ck[2][k] = acc + k * CB
    covered = (m_t - loend * W) <= SW * W
    costs = torch.where(covered, acc + cap + n_t, INF)
    return costs, ck


def striped_cost_ref(a0, a1, pb0, pb1, n, m, band_words: int,
                     diag: tuple | None = None) -> torch.Tensor:
    """Banded (or, at ``band_words >= S``, exact full-height) edit
    distances of one bucket on the shared schedule: the plain version of
    kernel K5, bit-identical to the reference's ``striped_cost_tpu``.

    Args as :func:`.banded.banded_cost_ref`.  Returns (B,) int32 on the
    planes' device: ``INF`` where the window does not cover row ``m`` at
    column ``n-1``; a pair with ``n == 0`` gives 0 (the reference's rule,
    where K1 gives ``m``)."""
    return _sweep(a0, a1, pb0, pb1, n, m, band_words, diag)[0]


def pinned_cost_ref(a0, a1, pb0, pb1, n, m, band_words: int,
                    diag: tuple | None = None) -> torch.Tensor:
    """The plain version of kernel K7, the reference's ``pinned_cost_tpu``:
    K5's function (the reference holds the two equal), so the same staggered
    sweep.  K7 differs from K5 only in where the card keeps the live words
    (a ring of resident slots instead of stripes), which the results do not
    show.  Args and results as :func:`striped_cost_ref`."""
    return _sweep(a0, a1, pb0, pb1, n, m, band_words, diag)[0]


def banded_cost_staggered_ref(a0, a1, pb0, pb1, n, m, band_words: int,
                              diag: tuple | None = None) -> torch.Tensor:
    """K1's costs from the staggered sweep (word w at column ``t - w``, as
    K5's), under K1's result rule: the plain twin of the layout K1's ring
    kernel computes in (``banded_ring_kernel`` in ``csrc/pinned.cu``), bit
    for bit :func:`.banded.banded_cost_ref`.  K5's rule is K1's but at
    ``n == 0`` (0 there, ``m`` for K1): row m above the window at column
    n-1 gives the absorbed sum plus n in both (K1's ``top_val``), below it
    ``INF``.  Args and results as :func:`.banded.banded_cost_ref`."""
    costs = _sweep(a0, a1, pb0, pb1, n, m, band_words, diag)[0]
    n_t = torch.as_tensor(np.asarray(torch.as_tensor(n).cpu(), np.int64), device=costs.device)
    m_t = torch.as_tensor(np.asarray(torch.as_tensor(m).cpu(), np.int64), device=costs.device)
    return torch.where(n_t == 0, m_t.to(torch.int32), costs)


def banded_fill_staggered_ref(a0, a1, pb0, pb1, n, m, band_words: int,
                              diag: tuple | None = None):
    """K3's costs and planes (:func:`.banded.banded_fill_ref`) from the
    staggered sweep: the plain twin of K3's ring kernel
    (``banded_ring_fill_kernel`` in ``csrc/pinned.cu``), bit for bit K3's
    plain version.  Row i, position W - lo(i), is word W's state after
    column i, stored at step i + W; a word steps no column ``>= n_p``, so
    past a pair's end each row is its last window slid down the schedule,
    words entering after the end all-ones, as K3 writes them (the kernel
    copies those rows from row ``n_p - 1`` instead).  Costs under K1's rule
    (:func:`banded_cost_staggered_ref`).  Returns ``(costs, vp_cols,
    vm_cols)``, planes (n_max, SW, B)."""
    costs, cols = _sweep(a0, a1, pb0, pb1, n, m, band_words, diag, fill=True)
    n_t = torch.as_tensor(np.asarray(torch.as_tensor(n).cpu(), np.int64), device=costs.device)
    m_t = torch.as_tensor(np.asarray(torch.as_tensor(m).cpu(), np.int64), device=costs.device)
    return (torch.where(n_t == 0, m_t.to(torch.int32), costs),) + cols


def ring_span(plan: dict, n_lim: int) -> int:
    """Most words live at once in a sweep of ``plan`` whose words stop
    after column ``n_lim - 1``: the ring capacity K7 needs (``n_lim`` the
    longest pair's columns), and ring K6 (``n_lim = n_max``: checkpoint
    rows are defined up to the last column).

    Word w is live at steps ``[ent_t[w], end_t[w])``, ``end_t`` the step
    after its last useful one (its absorb, or its column ``n_lim - 1``).
    Both rise strictly with w, so the live words at step t are the run
    ``[ended(t), entered(t))``; its length peaks at an entry step, and it
    never exceeds SW, whatever ``n_lim``: word w runs column ``t - w``; a
    live word has entered (``w < lo(t - w) + SW``) and is at most the band
    top or, absorbed at step t, the word ``lo(t - w) - 1`` above it at a
    column that shifts; every live word below it runs a column to the left,
    where the band top is at most that word.  Only the steps a pair
    can need count: those before ``n_lim - 1 + lo(n_lim - 1) + SW``, the
    step after the last capture (and after the last checkpoint word)."""
    ent = plan["ent_t"].astype(np.int64)
    nwl = len(ent)
    w = np.arange(nwl, dtype=np.int64)
    ab = plan["abs_t"].astype(np.int64)
    end = np.minimum(np.where(ab < NEVER, ab + 1, NEVER), n_lim + w)
    lo = plan["lo"]
    sw = nwl - int(lo[-1])
    t_stop = n_lim - 1 + int(lo[min(n_lim, len(lo)) - 1]) + sw
    run = ent < t_stop
    span = w[run] + 1 - np.searchsorted(end, ent[run], side="right")
    return int(span.max(initial=0))


def striped_ck_ref(a0, a1, pb0, pb1, n, m, band_words: int, col_block: int,
                   diag: tuple | None = None):
    """K5 plus checkpoints: the plain version of kernel K6, the reference's
    ``striped_ck_tpu`` on every readable row.

    Returns ``(costs (B,), ck_vp (n_ck, SW+8, B), ck_vm, ck_tv (n_ck, B))``
    under the 8-aligned-top contract above, ``CB = min(col_block, n_max)``
    and ``n_ck = n_max // CB + 1``.  Raises unless ``SW % 8 == 0`` and
    ``col_block >= SW + 8`` (``SW = min(band_words, S)``)."""
    costs, ck = _sweep(a0, a1, pb0, pb1, n, m, band_words, diag, col_block)
    return (costs,) + ck


def pinned_ck_ref(a0, a1, pb0, pb1, n, m, band_words: int, col_block: int,
                  diag: tuple | None = None):
    """K5 plus checkpoints under K2's contract: the plain version of kernel
    K8, the reference's ``pinned_ck_tpu`` (without its ``B % 128`` and
    ``SW % 8`` grain).

    Returns ``(costs (B,), ck_vp (n_ck, SW, B), ck_vm, ck_tv (n_ck, B))``:
    checkpoint ``k >= 1`` is the window state after column ``k*CB - 1`` in
    rows ``w - lo(k*CB - 1)`` and the top value there, checkpoint 0 the
    all-ones init; ``CB = min(col_block, n_max)``, ``n_ck = n_max // CB +
    1``.  Every row is the DP's (the band runs to n_max), past a pair's
    end too, where K2 freezes the lane: the two agree on the checkpoints a
    trace reads (``k*CB <= n``).  Costs are K5's.  Raises as
    :func:`pinned_ck_layout`."""
    costs, ck = _sweep(a0, a1, pb0, pb1, n, m, band_words, diag, col_block,
                       exact_top=True)
    return (costs,) + ck
