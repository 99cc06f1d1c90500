"""Figure suite: regenerates the reference's example-figure families.

The reference ships ~29 example binaries that render the paper / README
figures and videos (`pa-bin/examples/astarpa-figures/{intro,layers,
comparison,limitations,no-matches}.rs`, `astarpa2-figures/{intro,layers,
comparison,doubling,trace,...}.rs`, `domains.rs`, `local-doubling.rs`,
`path-tracing.rs`, `readme-videos.rs`).  Each binary is a visualizer
Config + a handful of aligner runs on small inputs; this module is the
equivalent here — one figure function per family, rendering headless PNG
frames + a self-contained interactive HTML page per animation (the
stand-in for the reference's SDL window and GIF/video exports).

The port's counterpart of ``scripts/figures.py``: the same figures, names
and files, from the port's :mod:`.astar`, :mod:`.aligners.astarpa2` and
:mod:`.vis`.  ``--device`` is passed to every ``AstarPa2Params`` it builds:
where the block aligner's torch block DP runs when the native one does not
(the card by default, or ``cpu``).

Usage:
    python -m astarpa_tpu_torch.figures [--out figures/] [--fig all|intro|
        layers|comparison|limitations|no-matches|domains|doubling|
        local-doubling|trace|readme] [--small] [--device cuda|cpu]

`--small` shrinks every input (used by the test-suite smoke test).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

from . import generate
from .aligners.astarpa2 import AstarPa2Params, Domain
from .aligners.band import DoublingType
from .astar import AstarPa
from .heuristic.csh import CSH, GCSH
from .heuristic.distances import GapCost, NoCost
from .heuristic.matches import MatchConfig
from .heuristic.prune import Prune, Pruning
from .heuristic.sh import SH
from .vis import VisConfig, When
from .vis.html import export_html


def _astar_frame(out: Path, name: str, a: bytes, b: bytes, h, *,
                 dt: bool = True, draw=When.LAST, cell_size: int = 2,
                 downscaler: int = 1, contours: bool = False,
                 panels: bool = False) -> int:
    """Run one A* alignment under the visualizer; return its cost."""
    d = out / name
    v = VisConfig(draw=draw, save=str(d), cell_size=cell_size,
                  downscaler=downscaler, draw_contours=contours,
                  draw_dt=panels, draw_f=panels)
    (cost, _), _ = AstarPa(dt=dt, h=h, v=v).align_with_stats(a, b)
    frames = len(list(d.glob("*.png")))
    if draw != When.LAST:
        export_html(d, d / f"{name}.html", title=f"{name} cost={cost}")
    print(f"  {name}: cost={cost}, {frames} frame(s) -> {d}")
    return cost


def _astarpa2_frame(out: Path, name: str, a: bytes, b: bytes, params, device, *,
                    draw=When.LAST, cell_size: int = 2) -> int:
    d = out / name
    aligner = dataclasses.replace(params, device=device).make_aligner(True)
    aligner.v = VisConfig(draw=draw, save=str(d), cell_size=cell_size)
    cost, cigar = aligner.align(a, b)
    assert cigar is None or cigar.verify(a, b) == cost
    if draw != When.LAST:
        export_html(d, d / f"{name}.html", title=f"{name} cost={cost}")
    print(f"  {name}: cost={cost} -> {d}")
    return cost


def _gcsh(k: int = 8, r: int = 1, prune=Prune.START) -> GCSH:
    return GCSH(MatchConfig(k=k, r=r), Pruning(prune))


# --- figure families --------------------------------------------------------


def fig_intro(out: Path, small: bool, device) -> None:
    """Paper figure 1 (`astarpa-figures/intro.rs`): the same pair expanded
    under Dijkstra, gap-cost, and GCSH A* — the motivating band contrast."""
    n = 120 if small else 500
    a, b = generate.uniform_seeded(n, 0.20, 31415)
    _astar_frame(out, "intro-dijkstra", a, b, NoCost(), dt=False)
    _astar_frame(out, "intro-gapcost", a, b, GapCost(), dt=False)
    _astar_frame(out, "intro-gcsh", a, b, _gcsh(), dt=True)


def fig_layers(out: Path, small: bool, device) -> None:
    """Contour layers over the matches (`astarpa-figures/layers.rs`,
    `readme-layers.rs`): SH / CSH / GCSH on one small pair with the
    contour panel on."""
    n = 48 if small else 64
    a, b = generate.uniform_seeded(n, 0.15, 2)
    for name, h in [
        ("layers-sh", SH(MatchConfig(k=6, r=1), Pruning(Prune.NONE))),
        ("layers-csh", CSH(MatchConfig(k=6, r=1), Pruning(Prune.NONE))),
        ("layers-gcsh", GCSH(MatchConfig(k=6, r=1), Pruning(Prune.NONE))),
    ]:
        _astar_frame(out, name, a, b, h, dt=False, cell_size=8,
                     contours=True)


def fig_comparison(out: Path, small: bool, device) -> None:
    """Heuristic x pruning grid (`astarpa-figures/comparison.rs`): SH, CSH,
    GCSH each with pruning off and on, low and high divergence."""
    n = 100 if small else 200
    for e, tag in [(0.08, "e08"), (0.20, "e20")]:
        a, b = generate.uniform_seeded(n, e, 1)
        for hname, mk in [("sh", SH), ("csh", CSH), ("gcsh", GCSH)]:
            for prune, ptag in [(Prune.NONE, "noprune"), (Prune.START, "prune")]:
                h = mk(MatchConfig(k=8, r=1), Pruning(prune))
                _astar_frame(out, f"cmp-{hname}-{ptag}-{tag}", a, b, h,
                             dt=False)


def fig_limitations(out: Path, small: bool, device) -> None:
    """Failure modes (`astarpa-figures/limitations.rs`): high divergence
    (heuristic saturates), long indels (noisy-insert), and repeats."""
    s = 1 if small else 4
    a, b = generate.uniform_seeded(50 * s, 0.60, 2)
    _astar_frame(out, "limit-high-error", a, b, _gcsh(k=6), dt=True)
    a, b = generate.generate_model(60 * s, 0.10,
                                   generate.ErrorModel.NOISY_INSERT, seed=5)
    _astar_frame(out, "limit-long-insert", a, b, _gcsh(k=6), dt=True)
    a, b = generate.generate_model(60 * s, 0.08,
                                   generate.ErrorModel.SYMMETRIC_REPEAT, seed=3)
    _astar_frame(out, "limit-repeats", a, b, _gcsh(k=6), dt=True)


def fig_no_matches(out: Path, small: bool, device) -> None:
    """Unrelated sequences (`astarpa-figures/no-matches.rs`): with no
    k-mer matches GCSH degrades to the gap cost and expands everything."""
    n = 50
    a, _ = generate.uniform_seeded(n, 0.0, 10)
    b, _ = generate.uniform_seeded(n, 0.0, 11)
    _astar_frame(out, "no-matches", a, b, _gcsh(k=8), dt=False, cell_size=8)


def fig_domains(out: Path, small: bool, device) -> None:
    """Block-DP domains (`domains.rs`): the same pair filled under the
    full / gap-start / gap-gap / A* domains of the block aligner."""
    n = 200 if small else 1000
    a, b = generate.uniform_seeded(n, 0.20, 31415)
    for dom in (Domain.FULL, Domain.GAP_START, Domain.GAP_GAP, Domain.ASTAR):
        p = dataclasses.replace(AstarPa2Params.simple(), domain=dom)
        _astarpa2_frame(out, f"domain-{dom.name.lower().replace('_', '-')}",
                        a, b, p, device, cell_size=1 if n > 400 else 2)


def fig_doubling(out: Path, small: bool, device) -> None:
    """Band doubling attempts (`astarpa2-figures/doubling.rs`): one frame
    per f_max attempt of the simple preset."""
    n = 150 if small else 500
    a, b = generate.uniform_seeded(n, 0.15, 7)
    _astarpa2_frame(out, "doubling", a, b, AstarPa2Params.simple(), device,
                    draw=When.LAYERS)


def fig_local_doubling(out: Path, small: bool, device) -> None:
    """Local doubling (`local-doubling.rs`): per-block f_max growth — the
    repo's *sound* variant of the reference's broken/#[ignore]d mode."""
    n = 100 if small else 200
    a, b = generate.uniform_seeded(n, 0.08, 1)
    # Local doubling requires the A* domain + pruning (the full preset).
    p = dataclasses.replace(AstarPa2Params.full(),
                            doubling=DoublingType.local_doubling())
    _astarpa2_frame(out, "local-doubling", a, b, p, device, draw=When.LAYERS)


def fig_trace(out: Path, small: bool, device) -> None:
    """Traceback overlay (`astarpa2-figures/trace.rs`, `path-tracing.rs`):
    the final path over the filled blocks (full preset, DT-trace)."""
    n = 150 if small else 500
    a, b = generate.uniform_seeded(n, 0.10, 4)
    _astarpa2_frame(out, "trace-full", a, b, AstarPa2Params.full(), device)
    # The A* DT-space panel is the path-tracing companion figure.
    _astar_frame(out, "trace-dt-panel", a, b, _gcsh(), dt=True, panels=True)


def fig_readme(out: Path, small: bool, device) -> None:
    """README/video animations (`readme-videos.rs`, `slides-videos.rs`):
    per-layer GCSH A* frames exported as an interactive HTML animation —
    the headless stand-in for the reference's GIFs."""
    n = 120 if small else 500
    a, b = generate.uniform_seeded(n, 0.15, 31415)
    _astar_frame(out, "readme-astarpa", a, b, _gcsh(), dt=True,
                 draw=When.LAYERS)
    _astarpa2_frame(out, "readme-astarpa2", a, b, AstarPa2Params.full(), device,
                    draw=When.LAYERS)


FIGURES = {
    "intro": fig_intro,
    "layers": fig_layers,
    "comparison": fig_comparison,
    "limitations": fig_limitations,
    "no-matches": fig_no_matches,
    "domains": fig_domains,
    "doubling": fig_doubling,
    "local-doubling": fig_local_doubling,
    "trace": fig_trace,
    "readme": fig_readme,
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="figures")
    p.add_argument("--fig", default="all", choices=["all", *FIGURES])
    p.add_argument("--small", action="store_true",
                   help="tiny inputs (smoke-test mode)")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu: where the block aligner's "
                        "torch block DP runs")
    args = p.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    names = list(FIGURES) if args.fig == "all" else [args.fig]
    for name in names:
        print(f"[{name}]")
        FIGURES[name](out, args.small, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
