"""Random sequence-pair generators.

The port's own copy of ``astarpa_tpu/generate.py`` (numpy only): the same
seeds give the same bytes.

Re-implementation of the external `pa-generate` crate's API surface (used by
the reference at `pa-test/src/lib.rs:4,43-48` and `pa-bin/src/lib.rs:64`):
``uniform_fixed(n, e)``, ``generate_model(n, e, model, seed)``, and the four
error models ``Uniform / NoisyInsert / NoisyDelete / SymmetricRepeat``.

The exact mutation procedure of `pa-generate` (ChaCha8-seeded) is not part of
this repo's reference checkout (git-only dependency), so the *statistical*
shape is reproduced here (same parameters, deterministic per seed) rather
than its bit-exact streams; all correctness tests compare against our own
oracle on the generated pairs, exactly like the reference compares against
`triple_accel` (`pa-test/src/lib.rs:74`).

Two deterministic backends: ``rng="numpy"`` (default, NumPy PCG64) and
``rng="chacha8"`` — the reference's RNG family (`rand_chacha::ChaCha8Rng`
with `rand_core`'s seed_from_u64 expansion, see `chacha.py`), making
corpora reproducible cross-platform from (seed, stream) with no NumPy
bit-generator dependence.

Reproducibility note: round 5 fixed the chacha8 backend's Lemire rejection
threshold (it was dead code, leaving a ~n/2^32 modulo bias), which changes
chacha8-generated corpora for non-power-of-two bounds versus rounds <= 4.
"""

from __future__ import annotations

import enum

import numpy as np

ALPHABET = np.frombuffer(b"ACGT", dtype=np.uint8)


class ErrorModel(enum.Enum):
    UNIFORM = "uniform"
    NOISY_INSERT = "noisy-insert"
    NOISY_DELETE = "noisy-delete"
    SYMMETRIC_REPEAT = "symmetric-repeat"


def random_seq(n: int, rng: np.random.Generator) -> bytes:
    return ALPHABET[rng.integers(0, 4, size=n)].tobytes()


def _mutate_uniform(seq: bytearray, num_errors: int, rng: np.random.Generator) -> None:
    """Apply `num_errors` point mutations, each uniformly sub/ins/del."""
    for _ in range(num_errors):
        kind = rng.integers(0, 3)
        if kind == 0 and len(seq) > 0:  # substitution
            pos = int(rng.integers(0, len(seq)))
            seq[pos] = int(ALPHABET[rng.integers(0, 4)])
        elif kind == 1:  # insertion
            pos = int(rng.integers(0, len(seq) + 1))
            seq.insert(pos, int(ALPHABET[rng.integers(0, 4)]))
        elif len(seq) > 0:  # deletion
            pos = int(rng.integers(0, len(seq)))
            del seq[pos]


def _mutate_indel_runs(
    seq: bytearray, num_errors: int, rng: np.random.Generator, insert: bool
) -> None:
    """Spend the error budget on short runs of insertions (or deletions)."""
    budget = num_errors
    while budget > 0:
        run = int(min(budget, rng.integers(1, 11)))
        if insert:
            pos = int(rng.integers(0, len(seq) + 1))
            ins = ALPHABET[rng.integers(0, 4, size=run)].tobytes()
            seq[pos:pos] = ins
        else:
            if len(seq) <= run:
                break
            pos = int(rng.integers(0, len(seq) - run))
            del seq[pos : pos + run]
        budget -= run


def _make_rng(seed: int, rng: str, stream: int = 0):
    if rng == "numpy":
        # One shared PCG64 stream; `stream` folds into the seed sequence.
        return np.random.default_rng((seed, stream) if stream else seed)
    if rng == "chacha8":
        from .chacha import ChaCha8Rng

        return ChaCha8Rng.seed_from_u64(seed, stream=stream)
    raise ValueError(f"unknown rng backend {rng!r}")


def generate_model(
    n: int, e: float, model: ErrorModel = ErrorModel.UNIFORM, seed: int = 31415,
    rng: str = "numpy",
) -> tuple[bytes, bytes]:
    """Generate a pair ``(a, b)`` where ``b`` is ``a`` mutated at rate ``e``."""
    return _generate_with(n, e, model, _make_rng(seed, rng))


def _generate_with(n: int, e: float, model: ErrorModel, rng) -> tuple[bytes, bytes]:
    num_errors = int(np.ceil(e * n))

    if model == ErrorModel.SYMMETRIC_REPEAT:
        # Both sequences are built from repeats of a common short core, then
        # mutated independently at rate e/2 each.
        core_len = max(1, n // 10)
        core = random_seq(core_len, rng)
        base = (core * (n // core_len + 1))[:n]
        a = bytearray(base)
        b = bytearray(base)
        _mutate_uniform(a, (num_errors + 1) // 2, rng)
        _mutate_uniform(b, (num_errors + 1) // 2, rng)
        return bytes(a), bytes(b)

    a = random_seq(n, rng)
    b = bytearray(a)
    if model == ErrorModel.UNIFORM:
        _mutate_uniform(b, num_errors, rng)
    elif model == ErrorModel.NOISY_INSERT:
        # Half the budget as uniform noise, half as insert runs.
        _mutate_uniform(b, num_errors // 2, rng)
        _mutate_indel_runs(b, num_errors - num_errors // 2, rng, insert=True)
    elif model == ErrorModel.NOISY_DELETE:
        _mutate_uniform(b, num_errors // 2, rng)
        _mutate_indel_runs(b, num_errors - num_errors // 2, rng, insert=False)
    else:
        raise ValueError(model)
    return a, bytes(b)


def uniform_fixed(n: int, e: float, seed: int = 31415) -> tuple[bytes, bytes]:
    """Uniform error model with a fixed default seed (pa-generate parity)."""
    return generate_model(n, e, ErrorModel.UNIFORM, seed)


def uniform_seeded(n: int, e: float, seed: int) -> tuple[bytes, bytes]:
    return generate_model(n, e, ErrorModel.UNIFORM, seed)


def generate_batch(
    count: int,
    n: int,
    e: float,
    model: ErrorModel = ErrorModel.UNIFORM,
    seed: int = 31415,
    rng: str = "numpy",
    workers: int = 1,
) -> list[tuple[bytes, bytes]]:
    """Generate `count` independent pairs (seeded deterministically).

    ``workers > 1`` (port addition) spreads the numpy backend's pairs over
    that many spawned processes: the same per-pair seeds, the same bytes."""
    if rng == "chacha8":
        # ChaCha-native batch seeding: pair i draws from stream i+1 of the
        # same key (streams are independent by construction).
        from .chacha import ChaCha8Rng

        out = []
        for i in range(count):
            r = ChaCha8Rng.seed_from_u64(seed, stream=i + 1)
            out.append(_generate_with(n, e, model, r))
        return out
    jobs = _model_jobs(count, n, e, model, seed)
    if workers > 1 and count > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(min(workers, count), mp_context=ctx) as ex:
            return list(ex.map(_model_job, jobs, chunksize=max(1, count // (4 * workers))))
    return [_model_job(job) for job in jobs]


def _model_jobs(count: int, n: int, e: float, model: ErrorModel, seed: int) -> list[tuple]:
    """The numpy backend's per-pair arguments of :func:`_model_job`: each
    pair seeded from its own child of ``SeedSequence(seed)``."""
    ss = np.random.SeedSequence(seed)
    return [(n, e, model, int(child.generate_state(1)[0])) for child in ss.spawn(count)]


def _model_job(job) -> tuple[bytes, bytes]:
    return generate_model(*job)
