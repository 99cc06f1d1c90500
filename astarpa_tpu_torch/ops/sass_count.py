"""Count the instructions of a K11 word step, or of a ring kernel's step, in
the compiled SASS.

    python -m astarpa_tpu_torch.ops.sass_count [--kernel nw_kernel] [--words 32]
    python -m astarpa_tpu_torch.ops.sass_count --kernel pinned_ring_kernel --ring [--steps 1]
    python -m astarpa_tpu_torch.ops.sass_count --kernel ring_ck_pp_kernel --ring

Builds the kernel library (:func:`._build.build`), disassembles it with
``cuobjdump -sass`` and finds every loop (a branch back to a label) of the
kernel whose mangled name holds ``--kernel``.  It prints one JSON line per
loop: its instructions by opcode, split into integer ALU, memory, control
and uniform-datapath classes.  K11's largest innermost loop is its column
loop with the stripe's ``kWords`` = 32 word steps unrolled, so its ALU
instructions over ``--words`` are what one word step runs there, the
loop's own overhead included.  The last line is that summary.

With ``--ring`` it splits the step loop of each matching ring kernel
(``pinned_ring_kernel``, and the kernels of ``ring_body``:
``ring_cost_kernel``, ring K10's ``ring_ck_pp_kernel``, K1's
``banded_ring_kernel``, K4's ``banded_ring_pp_kernel`` and
``banded_ring_ck_pp_kernel``, K3's ``banded_ring_fill_kernel``, ring K8's
``ring_ck_exact_kernel`` and K2's ``banded_ring_ck_kernel``;
:func:`step_split`): the largest loop closed by a
conditional branch, whose body runs ``--steps`` steps (1 for
``pinned_ring_kernel``, 8 for ``ring_body``'s, unrolled by 8).  It prints one JSON line per kernel instance with
the instructions per thread-step by class (the word step's integer work by
pipe: ``alu``, the ALU pipe's ``LOP3``, ``IADD3``, ``SHF``, ``LEA``, and
``fma``, the FMA pipe's ``IMAD`` and ``IMUL`` forms; then moves, hand-off,
event/top/capture tests, memory, control, uniform), both over the whole
loop body and on the path that skips every block a forward conditional
branch jumps over (a step with no event), and on that path the ``alu`` and
``fma`` instructions a word step and the two beyond ``OPS_PER_WORD_STEP``
(14) per slot of a thread (``--slots``, read from the instance's name when
it holds it).  Needs the CUDA toolkit's ``cuobjdump``; no GPU.
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

#: Classes of :func:`step_class`, in print order.
STEP_CLASSES = ("alu", "fma", "moves", "handoff", "tests", "memory", "control", "uniform",
                "other")
#: The kernels of ``csrc/pinned.cu``'s ``ring_body``, whose step loop is
#: unrolled by 8.
RING_BODY = ("ring_cost_kernel", "ring_ck_pp_kernel", "banded_ring_kernel",
             "banded_ring_pp_kernel", "banded_ring_ck_pp_kernel", "banded_ring_fill_kernel",
             "ring_ck_exact_kernel", "banded_ring_ck_kernel")
#: Least int32 instructions of one Myers word step on sm_90's ALU pipe alone
#: (``chip_smoke.py``); ``csrc/pinned.cu``'s ``word_step_split`` runs 12 of
#: them there and 2 on the FMA pipe.
OPS_PER_WORD_STEP = 14
_HANDOFF = {"SHFL", "LDS", "STS", "BAR", "WARPSYNC", "LDSM"}
_MOVES = {"MOV", "MOV32I", "SEL", "FSEL", "PRMT"}
_TESTS = {"ISETP", "PLOP3", "P2R", "R2P", "VOTE", "VOTEU", "POPC", "FLO", "ICMP", "IABS", "IMNMX",
          "VIMNMX", "BMSK", "SGXT", "CSET", "CSETP", "FSETP"}
_ALU = {"LOP3", "LOP", "SHF", "IADD3", "IADD", "LEA", "SHL", "SHR"}
_FMA = {"IMAD", "IMUL"}

_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_INSN = re.compile(r"/\*([0-9a-f]+)\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
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
        ops.append(m.group(3))
        t = _TARGET.search(m.group(4))
        if m.group(3).startswith("BRA") and t:
            branches.append((len(ops), t.group(1) or int(t.group(2), 16)))
    spans = []
    for end, target in branches:
        start = labels.get(target) if isinstance(target, str) else at.get(target)
        if start is not None and start < end:
            spans.append((start, end))
    return [(ops[a:b], not any(a <= c and d <= b and (c, d) != (a, b) for c, d in spans))
            for a, b in spans]


def step_class(opcode: str) -> str:
    """Class of an instruction in a ring kernel's step (:data:`STEP_CLASSES`):
    the integer work a word step is made of, by pipe (``alu``: logic, adds,
    shifts; ``fma``: every ``IMAD``/``IMUL`` form, ``.HI``, ``.WIDE``,
    ``.SHL``, ``.IADD``), moves and selects, the hand-off of the carry
    (shuffles, shared memory, barriers), the tests and counts of the
    events, top and capture, memory, control and uniform-datapath
    instructions.  ``IMAD.MOV`` is a move."""
    base = opcode.split(".")[0]
    if base in _HANDOFF:
        return "handoff"
    if base in _MOVES or opcode.startswith("IMAD.MOV"):
        return "moves"
    if base in _TESTS:
        return "tests"
    if base in MEMORY:
        return "memory"
    if base in CONTROL or base == "BRX":
        return "control"
    if base.startswith("U") or base == "S2UR":
        return "uniform"
    if base in _FMA:
        return "fma"
    return "alu" if base in _ALU else "other"


def _parse(lines: list[str]):
    """(opcodes, whether each is predicated, {index: branch target index})."""
    ops, pred, at, labels, raw = [], [], {}, {}, []
    for line in lines:
        m = _LABEL.match(line)
        if m:
            labels[m.group(1)] = len(ops)
            continue
        m = _INSN.search(line)
        if not m:
            continue
        at[int(m.group(1), 16)] = len(ops)
        t = _TARGET.search(m.group(4))
        if m.group(3).startswith("BRA") and t:
            raw.append((len(ops), t.group(1) or int(t.group(2), 16)))
        ops.append(m.group(3))
        pred.append(bool(m.group(2)))
    targets = {}
    for i, tg in raw:
        j = labels.get(tg) if isinstance(tg, str) else at.get(tg)
        if j is not None:
            targets[i] = j
    return ops, pred, targets


def step_split(lines: list[str], steps: int = 1, slots: int = 8) -> dict:
    """Instructions per thread-step of a ring kernel's step loop, by
    :func:`step_class`: the largest loop closed by a conditional branch back
    (the step loop; a return from an out-of-line block is unconditional),
    over its whole body (``body``) and on the path that skips every block a
    forward conditional branch inside the loop jumps over (``no_event``: a
    step whose tests all fail, when the compiler places the rare blocks
    there or out of line).  On that path ``alu_per_word_step`` and
    ``fma_per_word_step`` are its ``alu`` and ``fma`` instructions over
    ``slots``, and ``int_beyond_word_steps`` the two together over
    ``OPS_PER_WORD_STEP * slots``."""
    ops, pred, targets = _parse(lines)
    spans = [(j, i + 1) for i, j in targets.items() if j <= i and pred[i]]
    if not spans:
        raise ValueError("no loop closed by a conditional branch")
    a, b = max(spans, key=lambda s: s[1] - s[0])
    skipped = set()
    for i in range(a, b - 1):
        j = targets.get(i)
        if pred[i] and j is not None and i < j <= b:
            skipped.update(range(i + 1, j))
    body = Counter(step_class(op) for op in ops[a:b])
    path = Counter(step_class(ops[i]) for i in range(a, b) if i not in skipped)

    def per_step(c):
        return {k: c[k] / steps for k in STEP_CLASSES if c[k]}

    no_event = per_step(path)
    alu, fma = no_event.get("alu", 0.0), no_event.get("fma", 0.0)
    return {"instructions": b - a, "steps": steps, "slots": slots,
            "body_per_step": per_step(body), "body_total_per_step": (b - a) / steps,
            "no_event_per_step": no_event,
            "no_event_total_per_step": sum(no_event.values()),
            "alu_per_word_step": alu / slots, "fma_per_word_step": fma / slots,
            "int_beyond_word_steps": alu + fma - OPS_PER_WORD_STEP * slots,
            "opcodes": Counter(ops[i] for i in range(a, b) if i not in skipped).most_common()}


def _slots(name: str, default: int) -> int:
    """A thread's slots from a ring kernel instance's mangled name: 8 plus
    ``ring_cost_kernel``'s first template argument (shared slots), else
    ``default``."""
    m = re.search(r"ring_cost_kernel(?:Li|ILi)(\d+)E", name)
    return 8 + int(m.group(1)) if m else default


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", default="nw_kernel")
    ap.add_argument("--words", type=int, default=32, help="word steps in one pass of the largest loop")
    ap.add_argument("--dump", help="also write the matching functions' SASS to this file")
    ap.add_argument("--ring", action="store_true", help="split a ring kernel's step loop")
    ap.add_argument("--steps", type=int, default=None,
                    help="steps in one pass of the step loop (default: 8 for ring_body's "
                    "kernels, else 1)")
    ap.add_argument("--slots", type=int, default=8, help="slots a thread, if the name does not say")
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
    if args.ring:
        if not matching:
            raise SystemExit(f"no function matches {args.kernel!r}")
        for name, lines in matching.items():
            steps = args.steps or (8 if any(k in name for k in RING_BODY) else 1)
            print(json.dumps({"function": name, **step_split(lines, steps,
                                                             _slots(name, args.slots))}), flush=True)
        return
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
