"""Core alignment types: positions, costs, CIGARs.

The port's own copy of ``astarpa_tpu/types.py`` (no framework code; kept
identical in behaviour, so the port imports nothing of the JAX package).
A re-design of the reference's core type layer (the external `pa-types`
crate, `astarpa/src/lib.rs:46`, `pa-affine-types/src/cigar.rs:265-334`).
Semantics:

- ``Pos(i, j)``: ``i`` indexes into ``a`` (columns), ``j`` into ``b`` (rows).
- Unit cost model: match 0; substitution / insertion / deletion 1.
- CIGAR ops: ``=`` match, ``X`` substitution, ``I`` insertion (consumes a
  char of ``b``, i.e. a vertical step ``j+1``), ``D`` deletion (consumes a
  char of ``a``, i.e. a horizontal step ``i+1``).  This matches the
  reference's `AffineCigar::verify` (cigar.rs:265-334) where `Ins` advances
  ``pos.1`` and `Del` advances ``pos.0``.

Everything here is host-side plain Python/NumPy; device code uses packed
arrays produced by :mod:`astarpa_tpu_torch.ops.bitpack`.
"""

from __future__ import annotations

import enum
import re
from dataclasses import dataclass, field
from typing import Iterable, NamedTuple

import numpy as np

# Index/cost scalar types (kept as aliases for documentation purposes).
I = int
Cost = int

#: The DNA alphabet understood by the aligners.
ALPHABET = b"ACGT"

#: 2-bit encoding used throughout: (c >> 1) & 3 => A=0, C=1, T=2, G=3.
#: Same packing as the reference q-gram machinery
#: (`pa-heuristic/src/matches/qgrams.rs:29-31`).
def char_to_bits(c: int) -> int:
    return (c >> 1) & 3


def seq_to_codes(seq: bytes | np.ndarray) -> np.ndarray:
    """Encode an ASCII ``ACGT`` sequence to 2-bit codes (uint8 array)."""
    arr = np.frombuffer(bytes(seq), dtype=np.uint8) if isinstance(seq, (bytes, bytearray)) else np.asarray(seq, dtype=np.uint8)
    return (arr >> 1) & 3


_CODE_TO_CHAR = np.frombuffer(b"ACTG", dtype=np.uint8)  # index by (c>>1)&3


def codes_to_seq(codes: np.ndarray) -> bytes:
    """Decode 2-bit codes back to an ASCII ``ACGT`` byte string."""
    return _CODE_TO_CHAR[np.asarray(codes, dtype=np.uint8)].tobytes()


class Pos(NamedTuple):
    """A position in the edit graph; ``i`` along ``a``, ``j`` along ``b``."""

    i: int
    j: int

    def __add__(self, other):  # type: ignore[override]
        return Pos(self.i + other[0], self.j + other[1])

    def __sub__(self, other):
        return Pos(self.i - other[0], self.j - other[1])

    @staticmethod
    def target(a: bytes, b: bytes) -> "Pos":
        return Pos(len(a), len(b))

    def lex_leq(self, other: "Pos") -> bool:
        """Lexicographic (i, j) <=, the reference's ``LexPos`` order."""
        return (self.i, self.j) <= (other.i, other.j)

    def dominates_leq(self, other: "Pos") -> bool:
        """Partial order: self <= other component-wise."""
        return self.i <= other.i and self.j <= other.j


class CigarOp(enum.IntEnum):
    """Edit operations, ordered for deterministic tie-breaking."""

    MATCH = 0  # '='
    SUB = 1  # 'X'
    INS = 2  # 'I' (consumes b; vertical step)
    DEL = 3  # 'D' (consumes a; horizontal step)

    @property
    def char(self) -> str:
        return "=XID"[int(self)]

    @staticmethod
    def from_char(c: str) -> "CigarOp":
        return {"=": CigarOp.MATCH, "X": CigarOp.SUB, "I": CigarOp.INS, "D": CigarOp.DEL, "M": CigarOp.MATCH}[c]

    @property
    def cost(self) -> int:
        return 0 if self == CigarOp.MATCH else 1


@dataclass
class CigarElem:
    op: CigarOp
    cnt: int


_CIGAR_RE = re.compile(r"(\d*)([=XIDM])")
_OP_FROM_CHAR = {
    "=": CigarOp.MATCH, "X": CigarOp.SUB, "I": CigarOp.INS,
    "D": CigarOp.DEL, "M": CigarOp.MATCH,
}


@dataclass(eq=False)
class Cigar:
    """A run-length encoded list of edit operations.

    Mirrors the reference's CIGAR contract: adjacent equal ops are merged on
    push (`pa-affine-types/src/cigar.rs:126-160`), `verify` re-checks every
    op against the sequences and returns the unit cost
    (`cigar.rs:265-334`).
    """

    ops: list[CigarElem] = field(default_factory=list)

    def __eq__(self, other) -> bool:
        # Tolerant of the lazy string-backed subclass on either side.
        if not isinstance(other, Cigar):
            return NotImplemented
        return self.ops == other.ops

    def push(self, op: CigarOp, cnt: int = 1) -> None:
        if cnt == 0:
            return
        assert cnt > 0
        if self.ops and self.ops[-1].op == op:
            self.ops[-1].cnt += cnt
        else:
            self.ops.append(CigarElem(op, cnt))

    def push_elem(self, elem: CigarElem) -> None:
        self.push(elem.op, elem.cnt)

    def extend(self, elems: Iterable[CigarElem]) -> None:
        for e in elems:
            self.push_elem(e)

    def reverse(self) -> None:
        self.ops.reverse()

    def to_string(self) -> str:
        return "".join(f"{e.cnt}{e.op.char}" for e in self.ops)

    __str__ = to_string

    @staticmethod
    def from_string(s: str) -> "Cigar":
        cigar = Cigar()
        ops = cigar.ops
        from_char = _OP_FROM_CHAR
        consumed = 0
        for cnt, ch in _CIGAR_RE.findall(s):
            consumed += len(cnt) + 1
            op = from_char[ch]
            c = int(cnt) if cnt else 1
            if ops and ops[-1].op == op:
                ops[-1].cnt += c
            else:
                ops.append(CigarElem(op, c))
        if consumed != len(s):
            raise ValueError(f"invalid CIGAR string: {s!r}")
        return cigar

    def cost(self) -> int:
        return sum(e.cnt for e in self.ops if e.op != CigarOp.MATCH)

    @staticmethod
    def from_string_lazy(s: str) -> "Cigar":
        """A Cigar backed by its RLE string, parsed only on op-level access.

        The native/device traceback paths return already-merged RLE strings;
        the common consumers (CSV writers, `to_string`) never need the
        per-element list, so production batches skip building hundreds of
        thousands of Python objects."""
        return _LazyCigar(s)

    def to_path(self) -> list[Pos]:
        """Expand to the list of visited positions, starting at (0, 0)."""
        pos = Pos(0, 0)
        path = [pos]
        for e in self.ops:
            for _ in range(e.cnt):
                if e.op in (CigarOp.MATCH, CigarOp.SUB):
                    pos = Pos(pos.i + 1, pos.j + 1)
                elif e.op == CigarOp.INS:
                    pos = Pos(pos.i, pos.j + 1)
                else:
                    pos = Pos(pos.i + 1, pos.j)
                path.append(pos)
        return path

    @staticmethod
    def from_path(a: bytes, b: bytes, path: list[Pos]) -> "Cigar":
        cigar = Cigar()
        for p, q in zip(path, path[1:]):
            di, dj = q.i - p.i, q.j - p.j
            if (di, dj) == (1, 1):
                cigar.push(CigarOp.MATCH if a[p.i] == b[p.j] else CigarOp.SUB)
            elif (di, dj) == (0, 1):
                cigar.push(CigarOp.INS)
            elif (di, dj) == (1, 0):
                cigar.push(CigarOp.DEL)
            else:
                raise ValueError(f"Non-adjacent path step {p} -> {q}")
        return cigar

    def verify(self, a: bytes, b: bytes) -> int:
        """Check ops against the sequences; return the unit cost.

        Raises ``AssertionError`` if the CIGAR does not describe a valid
        global alignment of ``a`` and ``b``.
        """
        i = j = 0
        cost = 0
        for e in self.ops:
            if e.op == CigarOp.MATCH:
                assert a[i : i + e.cnt] == b[j : j + e.cnt], (
                    f"Match op at ({i},{j})x{e.cnt} does not match: "
                    f"{a[i:i + e.cnt]!r} vs {b[j:j + e.cnt]!r}"
                )
                i += e.cnt
                j += e.cnt
            elif e.op == CigarOp.SUB:
                for _ in range(e.cnt):
                    assert i < len(a) and j < len(b) and a[i] != b[j], (
                        f"Sub op at ({i},{j}) on equal chars"
                    )
                    i += 1
                    j += 1
                cost += e.cnt
            elif e.op == CigarOp.INS:
                j += e.cnt
                cost += e.cnt
            else:  # DEL
                i += e.cnt
                cost += e.cnt
        assert i == len(a) and j == len(b), f"CIGAR ends at ({i},{j}), target ({len(a)},{len(b)})"
        return cost


class _LazyCigar(Cigar):
    """String-backed Cigar (see :meth:`Cigar.from_string_lazy`)."""

    def __init__(self, s: str):
        self._s = s
        self._ops = None

    @property
    def ops(self) -> list[CigarElem]:
        if self._ops is None:
            self._ops = Cigar.from_string(self._s).ops
        return self._ops

    @ops.setter
    def ops(self, value) -> None:
        self._ops = value

    def to_string(self) -> str:
        if self._ops is None:
            return self._s
        return Cigar.to_string(self)

    __str__ = to_string
