"""Shared test-oracle harness (re-design of the `pa-test` crate).

The port's own copy of ``astarpa_tpu/testing.py`` (the code kept
identical), on the port's :mod:`.generate` and :mod:`.oracle`.
`pa-test/src/lib.rs:65-137` semantics: run an aligner against a
trivially-correct Levenshtein oracle on (a) hardcoded tricky pairs and (b) a
random subsample of an (n, e, error-model) grid; the cost must match exactly
and the CIGAR must verify against unit costs.  An aligner is any object
with ``.align(a, b)`` returning ``(cost, Cigar)`` or a cost.

The reference deliberately uses a fresh random seed per CI run
("coverage-over-time", `pa-test/src/lib.rs:22`); pass ``fixed_seed`` for
reproducibility (the default here, so CI stays deterministic — use
``fixed_seed=None`` for reference-style fuzzing coverage).
"""

from __future__ import annotations

import random

from . import generate, oracle

#: Hardcoded tricky pairs (`pa-test/src/lib.rs:7-20` spirit).
TRICKY_PAIRS: list[tuple[bytes, bytes]] = [
    (b"", b""),
    (b"A", b""),
    (b"", b"A"),
    (b"A", b"A"),
    (b"A", b"C"),
    (b"AC", b"CA"),
    (b"ACGT" * 8, b"ACGT" * 8),
    (b"AAAA" * 4, b"TTTT" * 4),
    (b"ACGTACGTAC", b"ACGTTACGTA"),
    (b"AGCCGCGACGTTTAAGGCAG", b"AGCCGCGACGTTTAAGGCAG"[::-1]),
]


def check_aligner_on_input(aligner, a: bytes, b: bytes) -> None:
    """Cost parity + CIGAR verification for one pair
    (`pa-test/src/lib.rs:74-98`)."""
    res = aligner.align(a, b)
    cost, cigar = res if isinstance(res, tuple) else (res, None)
    expected = oracle.levenshtein(a, b)
    assert cost == expected, (
        f"cost {cost} != oracle {expected} for a={a!r} b={b!r}"
    )
    if cigar is not None:
        assert cigar.verify(a, b) == cost


def check_aligner_up_to(
    aligner, max_n: int = 300, samples: int = 40, fixed_seed: int | None = 1234
) -> None:
    """Random subsample of the n x e x error-model grid
    (`pa-test/src/lib.rs:24-63`)."""
    rng = random.Random(fixed_seed)
    for a, b in TRICKY_PAIRS:
        check_aligner_on_input(aligner, a, b)
    models = list(generate.ErrorModel)
    for _ in range(samples):
        n = rng.randrange(1, max_n)
        e = rng.choice([0.0, 0.05, 0.1, 0.2, 0.5, 1.0])
        model = rng.choice(models)
        a, b = generate.generate_model(n, e, model, rng.randrange(1 << 30))
        check_aligner_on_input(aligner, a, b)


def check_aligner(aligner, fixed_seed: int | None = 1234) -> None:
    """The full default harness (`pa-test::test_aligner`)."""
    check_aligner_up_to(aligner, fixed_seed=fixed_seed)
