"""Count the instructions of a K11 word step in the compiled SASS.

    python -m astarpa_tpu_torch.ops.sass_count [--kernel nw_kernel] [--words 32]

Builds the kernel library (:func:`._build.build`), disassembles it with
``cuobjdump -sass`` and finds every loop (a branch back to a label) of the
kernel whose mangled name holds ``--kernel``.  It prints one JSON line per
loop: its instructions by opcode, split into integer ALU, memory, control
and uniform-datapath classes.  K11's largest innermost loop is its column
loop with the stripe's ``kWords`` = 32 word steps unrolled, so its ALU
instructions over ``--words`` are what one word step runs there, the
loop's own overhead included.  The last line is that summary.  Needs the CUDA
toolkit's ``cuobjdump``; no GPU.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
from collections import Counter
from pathlib import Path

from . import _build

MEMORY = {"LDG", "STG", "LD", "ST", "LDS", "STS", "LDL", "STL", "LDC", "ATOM", "ATOMG",
          "ATOMS", "RED", "LDGSTS", "LDGDEPBAR", "DEPBAR", "CCTL", "MEMBAR", "ERRBAR"}
CONTROL = {"BRA", "BRX", "JMP", "JMX", "EXIT", "RET", "CALL", "BSSY", "BSYNC", "WARPSYNC",
           "BAR", "NOP", "YIELD", "BPT", "NANOSLEEP", "BREAK", "KILL"}

_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_INSN = re.compile(r"/\*([0-9a-f]+)\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
# A branch names its target by label (`(.L_x_3)) or by address (0x1f0).
_TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\b")


def klass(opcode: str) -> str:
    base = opcode.split(".")[0]
    if base in MEMORY:
        return "memory"
    if base in CONTROL:
        return "control"
    if base.startswith("U") or base == "S2UR":
        return "uniform"
    return "alu"


def functions(sass: str) -> dict[str, list[str]]:
    """Mangled name -> its SASS lines."""
    out, cur = {}, None
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = out.setdefault(m.group(1), [])
        elif cur is not None:
            cur.append(line)
    return out


def loops(lines: list[str]) -> list[tuple[list[str], bool]]:
    """(opcodes of each loop body, from its first instruction to the branch
    back to it, whether no other loop lies inside it)."""
    ops, at, labels, branches = [], {}, {}, []
    for line in lines:
        m = _LABEL.match(line)
        if m:
            labels[m.group(1)] = len(ops)
            continue
        m = _INSN.search(line)
        if not m:
            continue
        at[int(m.group(1), 16)] = len(ops)
        ops.append(m.group(2))
        t = _TARGET.search(m.group(3))
        if m.group(2).startswith("BRA") and t:
            branches.append((len(ops), t.group(1) or int(t.group(2), 16)))
    spans = []
    for end, target in branches:
        start = labels.get(target) if isinstance(target, str) else at.get(target)
        if start is not None and start < end:
            spans.append((start, end))
    return [(ops[a:b], not any(a <= c and d <= b and (c, d) != (a, b) for c, d in spans))
            for a, b in spans]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", default="nw_kernel")
    ap.add_argument("--words", type=int, default=32, help="word steps in one pass of the largest loop")
    ap.add_argument("--dump", help="also write the matching functions' SASS to this file")
    args = ap.parse_args()
    lib = _build.build()
    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    bodies = []
    matching = {name: lines for name, lines in functions(sass).items() if args.kernel in name}
    if args.dump:
        Path(args.dump).write_text("".join(f"{name}\n" + "\n".join(lines) + "\n"
                                           for name, lines in matching.items()))
    for name, lines in matching.items():
        for body, innermost in loops(lines):
            classes = Counter(klass(op) for op in body)
            print(json.dumps({"function": name, "instructions": len(body),
                              "innermost": innermost, **classes,
                              "opcodes": Counter(body).most_common()}), flush=True)
            if innermost:
                bodies.append(classes)
    if not bodies:
        raise SystemExit(f"no loop found in a function matching {args.kernel!r}")
    top = max(bodies, key=lambda c: sum(c.values()))
    print(json.dumps({"kernel": args.kernel, "largest_innermost_loop": dict(top),
                      "words": args.words,
                      "alu_per_word_step": top["alu"] / args.words}), flush=True)


if __name__ == "__main__":
    main()
