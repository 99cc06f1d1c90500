"""Every module of the JAX package (and the two user-facing scripts that
drive it) has its counterpart in the port, found on disk without importing
either package: at the same relative path, or under the short map below."""

from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "astarpa_tpu", ROOT / "astarpa_tpu_torch"

#: Reference path (relative to the repository) -> the port's module
#: (relative to ``astarpa_tpu_torch/``), each with why it moved.
MOVED = {
    # The Pallas kernels' wrappers live beside their CUDA launches.
    "astarpa_tpu/ops/pallas_banded.py": ("ops/banded_kernel.py",
                                         "K1-K4's wrapper launches csrc/ kernels"),
    "astarpa_tpu/ops/pallas_myers.py": ("ops/nw_kernel.py", "K11's wrapper launches csrc/nw.cu"),
    # The loader is one module; the C++ sources stay shared in native/.
    "astarpa_tpu/native/__init__.py": ("native.py", "the loader alone, sources in native/"),
    # Scripts become modules of the package (python -m astarpa_tpu_torch.X).
    "scripts/fuzz.py": ("fuzz.py", "python -m astarpa_tpu_torch.fuzz"),
    "scripts/figures.py": ("figures.py", "python -m astarpa_tpu_torch.figures"),
}


def _reference_modules():
    mods = sorted(str(p.relative_to(ROOT)) for p in REF.rglob("*.py"))
    return mods + ["scripts/fuzz.py", "scripts/figures.py"]


@pytest.mark.parametrize("ref", _reference_modules())
def test_module_has_a_counterpart(ref):
    assert (ROOT / ref).is_file()
    target = MOVED[ref][0] if ref in MOVED else str(Path(ref).relative_to("astarpa_tpu"))
    assert (PORT / target).is_file(), f"{ref} has no counterpart {target} in the port"


def test_map_names_only_real_files():
    """The map stays short and names only files that exist on both sides,
    and the port has no module the reference lacks other than its own
    kernels, device, packing, build and tracing code."""
    refs = set(_reference_modules())
    for ref, (target, reason) in MOVED.items():
        assert ref in refs and reason and (PORT / target).is_file()
    mapped = {str(Path(r).relative_to("astarpa_tpu")) for r in refs if r.startswith("astarpa_tpu/")}
    mapped |= {t for t, _ in MOVED.values()}
    extra = sorted(str(p.relative_to(PORT)) for p in PORT.rglob("*.py")
                   if str(p.relative_to(PORT)) not in mapped)
    port_only = {"device.py", "ops/_build.py", "ops/pack.py", "ops/words.py", "ops/ring_step.py",
                 "ops/sass_count.py", "parallel/dryrun.py", "utils/spans.py"}
    assert set(extra) <= port_only, sorted(set(extra) - port_only)
