"""Routing of the checkpoint rings on what the CPU can check: the host tests
that pick ring K8 (``ring_ck_exact_kernel``) or the stripe K8 for
``pinned_ck`` and K2's ring (``banded_ring_ck_kernel``) or the old K2 for
``banded_ck`` before any launch, the wrappers following them on the card's
route (launches recorded, not run), and ``BatchAligner`` labelling each ck
rung by the kernel that ran.  The rings' results are held bit for bit
against the plain versions through the CPU emulation
(``test_torch_ring_emulated.py``) and on the card (``test_torch_cuda.py``)."""

import pytest
import torch

from astarpa_tpu_torch import BatchAligner, generate, native, oracle
from astarpa_tpu_torch.ops import banded_kernel as bk
from astarpa_tpu_torch.ops.pack import pack_batch_staggered
from astarpa_tpu_torch.parallel import runner

torch.set_num_threads(1)

needs_native = pytest.mark.skipif(not native.available(), reason="native toolchain unavailable")


@pytest.mark.parametrize("n_max,sw,cb,want", [
    (1000, 28, 4096, "banded_ring_ck"),   # the runner's interval: CB >= SW + 8
    (1000, 28, 28, "banded_ring_ck"),     # CB = SW
    (1000, 28, 27, "banded_ck"),          # below SW, 38 checkpoints
    (40, 94, 4096, "banded_ring_ck"),     # a skewed bucket: CB = n_max, one checkpoint
    (60, 33, 30, "banded_ring_ck"),       # below SW, one capture window
    (1024, 3149, 768, "banded_ck"),       # past the ring's 2048 words
    (1024, 2048, 4096, "banded_ring_ck"),
])
def test_k2_kernel_picks_the_ring_by_interval_and_band(n_max, sw, cb, want):
    """K2's ring takes CB >= SW or at most one capture window, on bands of
    up to ``RING_K4_MAX_WORDS`` words; the old K2 takes the rest."""
    assert bk.k2_kernel(n_max, sw, cb) == want


def _args(count=6, n=200, m=260):
    pairs = [generate.uniform_seeded(n - 13 * s, 0.1, 90 + s) for s in range(count)]
    pairs[0] = (pairs[0][0], generate.uniform_seeded(m, 0.1, 89)[0])
    return pack_batch_staggered(pairs, 1, device="cpu")[0]


def _record(monkeypatch):
    """The card's route with its launch functions recorded, not run."""
    calls = []
    monkeypatch.setattr(bk, "_plain", lambda a0: False)
    for name in ("_launch", "_launch_banded_ring_ck", "_launch_striped",
                 "_launch_ring_ck_exact"):
        monkeypatch.setattr(bk, name, lambda *a, _n=name, **kw: calls.append(_n) or _n)
    return calls


def test_banded_ck_sends_a_refused_interval_to_the_old_k2(monkeypatch):
    """On the card ``banded_ck`` launches K2's ring for an interval its row
    cursor takes and the old K2 (``_launch("banded_ck", ...)``) for one
    below SW with several capture windows, decided before the launch."""
    args = _args()
    n_max = args[0].shape[0]
    calls = _record(monkeypatch)
    assert bk.banded_ck(*args, 4, 64) == "_launch_banded_ring_ck"
    assert bk.banded_ck(*args, 4, n_max) == "_launch_banded_ring_ck"
    assert bk.k2_kernel(n_max, 4, 3) == "banded_ck"
    assert bk.banded_ck(*args, 4, 3) == "_launch"
    assert calls == ["_launch_banded_ring_ck", "_launch_banded_ring_ck", "_launch"]


def test_pinned_ck_routes_between_ring_and_stripes(monkeypatch):
    """On the card ``pinned_ck`` launches ring K8 where the ring holds the
    band (``ring_takes``) and the stripe K8 past it; ``stripe_words`` and
    ``ring_words`` pick one, both at once raise on both routes."""
    args = _args()
    calls = _record(monkeypatch)
    assert bk.pinned_ck(*args, 9, 64) == "_launch_ring_ck_exact"
    assert bk.pinned_ck(*args, 9, 64, None, 256) == "_launch_striped"
    assert bk.pinned_ck(*args, 9, 64, None, None, 256) == "_launch_ring_ck_exact"
    assert bk.pinned_ck_kernel(9) == "ring_ck_exact"
    monkeypatch.setattr(bk, "RING_MAX_WORDS", 8)
    assert bk.pinned_ck_kernel(9) == "pinned_ck"
    assert bk.pinned_ck(*args, 9, 64) == "_launch_striped"
    assert calls == ["_launch_ring_ck_exact", "_launch_striped", "_launch_ring_ck_exact",
                     "_launch_striped"]
    monkeypatch.setattr(bk, "_plain", lambda a0: True)
    with pytest.raises(ValueError, match="at most one"):
        bk.pinned_ck(*args, 9, 64, None, 256, 256)


@needs_native
@pytest.mark.parametrize("ring_max,label", [(None, "cuda-ring-ck-exact"), (8, "cuda-pinned-ck")])
def test_runner_labels_ck_rungs_by_the_ring_that_ran(monkeypatch, ring_max, label):
    """``direct_dt=False`` from an 8-word band with one doubling, the
    routing constant at 16 words: the 8-word rung runs K2, labelled as
    K2's ring on the card, and the full-height rung off the 8-grain (S =
    19) runs K8, labelled as ring K8 where the ring holds it and as the
    stripe K8 past it (the ring patched small); costs and CIGARs equal
    the oracle's."""
    monkeypatch.setattr(runner, "route", lambda device, kernel="banded_cost":
                        bk._LABELS[kernel])
    monkeypatch.setattr(runner, "STRIPED_MIN_SW", 16)
    if ring_max is not None:
        monkeypatch.setattr(bk, "RING_MAX_WORDS", ring_max)
    a, _ = generate.uniform_seeded(600, 0.0, 9)
    pairs = [(a, a[::-1])] + [generate.uniform_seeded(560 + 7 * s, [0.05, 0.2][s % 2], 600 + s)
                              for s in range(4)]
    seen = []  # (SW, label) of each rung, as the rung's start sets it
    orig = runner.BatchAligner._rung_start

    def rung_start(self, pairs, lad, stats, *a, **kw):
        rung = orig(self, pairs, lad, stats, *a, **kw)
        seen.append((rung["sw"], stats.kernel))
        return rung

    monkeypatch.setattr(runner.BatchAligner, "_rung_start", rung_start)
    res, stats = BatchAligner(band_words=8, max_band_doublings=1, domain_mode="off",
                              direct_dt=False, device="cpu").align_with_stats(pairs)
    S = -(-max(len(b) for _, b in pairs) // 32)
    assert S >= 16 and S % 8
    assert seen == [(8, "cuda-banded-ring-ck"), (S, label)]
    assert stats.kernel == label
    for (x, y), (c, cig) in zip(pairs, res):
        assert cig.verify(x, y) == c == oracle.levenshtein(x, y)
