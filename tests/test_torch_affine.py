"""The port's affine cost models, affine NW (``base.NwAffine``) and
diagonal transition (``base.DiagonalTransition``) against the reference's
(``astarpa_tpu.affine``/``astarpa_tpu.base``), on the same seeded pairs
under ``tests/test_affine.py``'s cost models: equal costs, equal affine
CIGARs, each verified under its model, and each cost against the
independent Gotoh oracle or the unit-cost oracle.  Every comparison is
exact."""

import pytest

from astarpa_tpu import affine as jaffine
from astarpa_tpu import base as jbase
from astarpa_tpu_torch import generate, oracle
from astarpa_tpu_torch.affine import AffineCost, State
from astarpa_tpu_torch.base import DiagonalTransition, NwAffine
from test_affine import _pairs, gotoh

# name -> (the port's model, the reference's model, Gotoh's (sub, open,
# extend) or None for unit costs)
MODELS = {
    "unit": (AffineCost.unit(), jaffine.AffineCost.unit(), None),
    "affine-1-1-1": (AffineCost.affine_model(1, 1, 1), jaffine.AffineCost.affine_model(1, 1, 1),
                     (1, 1, 1)),
    "affine-2-3-1": (AffineCost.affine_model(2, 3, 1), jaffine.AffineCost.affine_model(2, 3, 1),
                     (2, 3, 1)),
    "affine-1-4-2": (AffineCost.affine_model(1, 4, 2), jaffine.AffineCost.affine_model(1, 4, 2),
                     (1, 4, 2)),
    "double-affine": (AffineCost.double_affine(1, 2, 2, 8, 1),
                      jaffine.AffineCost.double_affine(1, 2, 2, 8, 1), None),
    "asym-2-3-1": (AffineCost.affine_asymmetric(2, 3, 1, 3, 1),
                   jaffine.AffineCost.affine_asymmetric(2, 3, 1, 3, 1), (2, 3, 1)),
}


def _check(name, got, want, cm, a, b):
    (cost, cig), (jcost, jcig) = got, want
    assert cost == jcost
    assert cig.to_string() == jcig.to_string()
    assert cig.verify(cm, a, b) == cost
    g = MODELS[name][2]
    if name == "unit":
        assert cost == oracle.levenshtein(a, b)
    elif name == "double-affine":
        assert cost <= min(gotoh(a, b, 1, 2, 2), gotoh(a, b, 1, 8, 1))
    else:
        assert cost == gotoh(a, b, *g)


@pytest.mark.parametrize("band", [False, True])
@pytest.mark.parametrize("name", ["unit", "affine-1-1-1", "affine-2-3-1", "affine-1-4-2",
                                  "double-affine"])
def test_nw_affine_agrees(name, band):
    cm, jcm, _ = MODELS[name]
    nw, jnw = NwAffine(cm, band_doubling=band), jbase.NwAffine(jcm, band_doubling=band)
    for a, b in _pairs(11) + [(b"", b"ACG"), (b"ACG", b"")]:
        _check(name, nw.align(a, b), jnw.align(a, b), cm, a, b)
        assert nw.cost(a, b) == jnw.cost(a, b)


@pytest.mark.parametrize("name", ["unit", "affine-1-1-1", "asym-2-3-1"])
def test_dt_agrees(name):
    cm, jcm, _ = MODELS[name]
    dt, jdt = DiagonalTransition(cm), jbase.DiagonalTransition(jcm)
    for a, b in _pairs(51) + [(b"", b"ACG"), (b"ACG", b""), (b"A", b"A"), (b"", b"")]:
        _check(name, dt.align(a, b), jdt.align(a, b), cm, a, b)
        assert dt.cost(a, b) == jdt.cost(a, b)


@pytest.mark.parametrize("n,e", [(200, 0.1), (500, 0.15), (800, 0.05), (60, 0.5)])
def test_dt_divide_and_conquer_agrees(n, e):
    a, b = generate.uniform_seeded(n, e, n)
    cm = AffineCost.unit()
    got = DiagonalTransition(dc=True).align(a, b)
    _check("unit", got, jbase.DiagonalTransition(dc=True).align(a, b), cm, a, b)
    # The divide-and-conquer path costs what the stored-front one does.
    assert got[0] == DiagonalTransition(dc=False).align(a, b)[0]


def test_cost_model_queries_agree():
    for cm, jcm, _ in MODELS.values():
        assert cm.n_layers == jcm.n_layers
        for q in ("min_ins_extend", "max_ins_extend", "min_del_extend", "max_del_extend",
                  "min_ins_open_extend", "max_ins_open_extend", "min_del_open_extend",
                  "max_del_open_extend"):
            assert getattr(cm, q) == getattr(jcm, q), q
        for s, t in (((0, 0), (0, 5)), ((0, 0), (5, 5)), ((0, 0), (5, 0)), ((0, 0), (3, 7)),
                     ((2, 9), (4, 1))):
            assert cm.gap_cost(s, t) == jcm.gap_cost(s, t)
            assert cm.extend_cost(s, t) == jcm.extend_cost(s, t)
    cm = AffineCost.affine_model(1, 2, 1)
    assert cm.gap_cost((0, 0), (0, 5)) == 2 + 5
    assert cm.extend_cost((0, 0), (5, 0)) == 5
    assert State(1, 2).pos() == (1, 2)
