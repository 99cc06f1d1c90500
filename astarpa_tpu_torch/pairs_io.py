"""Sequence-pair file IO (mirror of `pa-bin/src/lib.rs:69-131`).

Formats:
- ``.seq``: alternating lines ``>A-seq`` / ``<B-seq`` (prefixes stripped).
- ``.txt``: alternating raw lines.
- ``.fa/.fasta/.fna``: consecutive FASTA records paired up.
"""

from __future__ import annotations

import os
from typing import Iterator


def read_pairs(path: str) -> Iterator[tuple[bytes, bytes]]:
    ext = os.path.splitext(path)[1].lower()
    if ext in (".seq", ".txt"):
        with open(path, "rb") as f:
            lines = [l.rstrip(b"\r\n") for l in f if l.strip()]
        for i in range(0, len(lines) - 1, 2):
            a, b = lines[i], lines[i + 1]
            if ext == ".seq":
                assert a[:1] == b">", f"line {i}: expected '>' prefix"
                assert b[:1] == b"<", f"line {i + 1}: expected '<' prefix"
                a, b = a[1:], b[1:]
            yield a, b
    elif ext in (".fa", ".fasta", ".fna"):
        records = list(_read_fasta(path))
        for i in range(0, len(records) - 1, 2):
            yield records[i], records[i + 1]
    else:
        raise ValueError(f"Unknown file extension {ext!r}; use .seq/.txt/.fa/.fasta/.fna")


def _read_fasta(path: str) -> Iterator[bytes]:
    seq: list[bytes] = []
    with open(path, "rb") as f:
        for line in f:
            line = line.strip()
            if line.startswith(b">"):
                if seq:
                    yield b"".join(seq)
                    seq = []
            elif line:
                seq.append(line)
    if seq:
        yield b"".join(seq)


def write_pairs_seq(path: str, pairs: list[tuple[bytes, bytes]]) -> None:
    with open(path, "wb") as f:
        for a, b in pairs:
            f.write(b">" + a + b"\n<" + b + b"\n")


# --- format converters (mirror of `pa-bin/examples/txt_to_seq.rs` and
# `nanosim_to_seq.rs`) ------------------------------------------------------


def txt_to_seq(src: str, dst: str) -> int:
    """Alternating raw lines -> .seq with >/< prefixes; returns #pairs."""
    with open(src, "rb") as f:
        lines = [l.rstrip(b"\r\n") for l in f if l.strip()]
    pairs = [(lines[i], lines[i + 1]) for i in range(0, len(lines) - 1, 2)]
    write_pairs_seq(dst, pairs)
    return len(pairs)


def nanosim_to_seq(ref_path: str, reads_path: str, dst: str) -> int:
    """Pair NanoSim-style simulated reads with their reference slices.

    NanoSim read headers encode the origin as
    ``>{chrom}_{ref_pos}_[aligned|unaligned]_..._{head}_{mid}_{tail}``; the
    reference slice [ref_pos, ref_pos+mid) of ``chrom`` is paired with the
    read's middle section (head/tail soft-clips stripped).
    """
    refs: dict[bytes, bytes] = {}
    name = None
    seqs: list[bytes] = []
    with open(ref_path, "rb") as f:
        for line in f:
            line = line.strip()
            if line.startswith(b">"):
                if name is not None:
                    refs[name] = b"".join(seqs)
                name = line[1:].split()[0]
                seqs = []
            elif line:
                seqs.append(line)
    if name is not None:
        refs[name] = b"".join(seqs)

    pairs = []
    header = None
    read: list[bytes] = []

    def flush():
        if header is None:
            return
        fields = header.split(b"_")
        try:
            chrom = fields[0]
            ref_pos = int(fields[1])
            head, mid, tail = int(fields[-3]), int(fields[-2]), int(fields[-1])
        except (ValueError, IndexError):
            return
        ref = refs.get(chrom)
        if ref is None:
            return
        r = b"".join(read)
        pairs.append((ref[ref_pos : ref_pos + mid], r[head : len(r) - tail]))

    with open(reads_path, "rb") as f:
        for line in f:
            line = line.strip()
            if line.startswith(b">"):
                flush()
                header = line[1:]
                read = []
            elif line:
                read.append(line)
    flush()
    write_pairs_seq(dst, pairs)
    return len(pairs)
