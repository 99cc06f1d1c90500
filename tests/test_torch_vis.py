"""The port's visualizer (``astarpa_tpu_torch.vis``) and figure suite
(``python -m astarpa_tpu_torch.figures``) against the reference's
(``astarpa_tpu.vis``, ``scripts/figures.py``): the same runs write the
same PNG bytes and the same HTML, and every figure family writes the same
file names with the same bytes.  The port's block aligner runs on
``device="cpu"``."""

import contextlib
import dataclasses
import importlib.util
import io
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from astarpa_tpu.aligners.astarpa2 import AstarPa2Params as JAstarPa2Params
from astarpa_tpu.astar import AstarPa as JAstarPa
from astarpa_tpu.heuristic import csh as jcsh
from astarpa_tpu.heuristic import matches as jmatches
from astarpa_tpu.heuristic import prune as jprune
from astarpa_tpu.vis import VisConfig as JVisConfig
from astarpa_tpu.vis import When as JWhen
from astarpa_tpu.vis.canvas import png_bytes as jpng_bytes
from astarpa_tpu.vis.html import export_html as jexport_html
from astarpa_tpu_torch import figures, generate, oracle
from astarpa_tpu_torch.aligners.astarpa2 import AstarPa2Params
from astarpa_tpu_torch.astar import AstarPa
from astarpa_tpu_torch.heuristic.csh import GCSH
from astarpa_tpu_torch.heuristic.matches import MatchConfig
from astarpa_tpu_torch.heuristic.prune import Prune, Pruning
from astarpa_tpu_torch.vis import NoVis, VisConfig, When
from astarpa_tpu_torch.vis.canvas import png_bytes
from astarpa_tpu_torch.vis.html import export_html

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _files(d: Path) -> dict:
    return {str(p.relative_to(d)): p.read_bytes() for p in sorted(d.rglob("*")) if p.is_file()}


def _same_files(got: Path, want: Path) -> int:
    g, w = _files(got), _files(want)
    assert sorted(g) == sorted(w)
    for name in w:
        assert g[name] == w[name], name
    return len(w)


def test_png_bytes_agree():
    rng = np.random.default_rng(4)
    for h, w in ((4, 6), (1, 1), (17, 33)):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        data = png_bytes(img)
        assert data == jpng_bytes(img)
        assert data[:8] == b"\x89PNG\r\n\x1a\n"
        assert struct.unpack(">II", data[16:24]) == (w, h)
        at = data.index(b"IDAT")
        n = struct.unpack(">I", data[at - 4:at])[0]
        assert len(zlib.decompress(data[at + 4:at + 4 + n])) == h * (1 + w * 3)


@pytest.mark.parametrize("draw,dt,panels", [("LAYERS", False, False), ("LAST", False, True),
                                            ("LAST", True, True)])
def test_astar_frames_and_html_agree(tmp_path, draw, dt, panels):
    a, b = generate.uniform_seeded(120, 0.1, 5)
    out = {}
    for tag, astar, vcfg, when, h in (
            ("port", AstarPa, VisConfig, When,
             GCSH(MatchConfig(k=8, r=1), Pruning(Prune.START))),
            ("ref", JAstarPa, JVisConfig, JWhen,
             jcsh.GCSH(jmatches.MatchConfig(k=8, r=1), jprune.Pruning(jprune.Prune.START)))):
        d = tmp_path / tag
        v = vcfg(draw=getattr(when, draw), save=str(d), cell_size=1, draw_contours=panels,
                 draw_dt=panels, draw_f=panels)
        (cost, cigar), st = astar(dt=dt, h=h, v=v).align_with_stats(a, b)
        out[tag] = (cost, cigar.to_string(), st.expanded)
        (export_html if tag == "port" else jexport_html)(d, tmp_path / f"{tag}.html", title="t")
    assert out["port"] == out["ref"] and out["port"][0] == oracle.levenshtein(a, b)
    assert _same_files(tmp_path / "port", tmp_path / "ref") >= 1
    html = (tmp_path / "port.html").read_text()
    assert "data:image/png;base64," in html
    assert html == (tmp_path / "ref.html").read_text()


@pytest.mark.parametrize("preset,draw", [("simple", "LAST"), ("simple", "LAYERS"),
                                         ("full", "LAYERS")])
def test_astarpa2_frames_agree(tmp_path, preset, draw):
    a, b = generate.uniform_seeded(200, 0.08, 6)
    got = dataclasses.replace(getattr(AstarPa2Params, preset)(), device="cpu").make_aligner(True)
    want = getattr(JAstarPa2Params, preset)().make_aligner(True)
    got.v = VisConfig(draw=getattr(When, draw), save=str(tmp_path / "port"), cell_size=1)
    want.v = JVisConfig(draw=getattr(JWhen, draw), save=str(tmp_path / "ref"), cell_size=1)
    (c, cig), (jc, jcig) = got.align(a, b), want.align(a, b)
    assert c == jc == oracle.levenshtein(a, b) and cig.to_string() == jcig.to_string()
    assert _same_files(tmp_path / "port", tmp_path / "ref") >= 1
    if draw == "LAST":
        assert list((tmp_path / "port").glob("*last.png"))


def test_novis_absorbs_everything():
    v = NoVis().build(b"A", b"C")
    v.expand((0, 0), 0, 0)
    v.whatever_hook(1, 2, 3)
    v.new_layer()


def test_visualizer_panels_render(tmp_path):
    """The contour, DT-space and f-profile panels make the image taller
    than the grid, and the same image as the reference's."""
    a, b = generate.uniform_seeded(150, 0.12, 8)
    imgs = []
    for vcfg, when in ((VisConfig, When), (JVisConfig, JWhen)):
        v = vcfg(draw=when.LAST, save=str(tmp_path), cell_size=1, draw_contours=True,
                 draw_dt=True, draw_f=True)
        inst = v.build(a, b)
        inst.dt_states = [(0, 0), (3, 2)]
        inst.f_profile = {0: 5, 3: 9}
        imgs.append(inst.render())
        assert imgs[-1].shape[0] > (len(b) // inst.d + 2)
    assert np.array_equal(*imgs)


def _reference_figures():
    spec = importlib.util.spec_from_file_location("figures", ROOT / "scripts" / "figures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("fig", sorted(figures.FIGURES))
def test_figure_suite_agrees(tmp_path, fig):
    """Each family in --small mode: the port's module on ``--device cpu``
    writes the reference script's file names with the same bytes."""
    ref = _reference_figures()
    assert sorted(ref.FIGURES) == sorted(figures.FIGURES)
    with contextlib.redirect_stdout(io.StringIO()) as got_out:
        assert figures.main(["--small", "--out", str(tmp_path / "port"), "--fig", fig,
                             "--device", "cpu"]) == 0
    with contextlib.redirect_stdout(io.StringIO()) as want_out:
        assert ref.main(["--small", "--out", str(tmp_path / "ref"), "--fig", fig]) == 0
    assert _same_files(tmp_path / "port", tmp_path / "ref") >= 1
    assert got_out.getvalue().replace("/port", "/ref") == want_out.getvalue()
