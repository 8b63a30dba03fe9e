"""What the noise passes' bounds count in the built library: one threefry2x32
block's SASS instructions by pipe (:func:`threefry_sass`, over
:func:`sass_text`), and the draws a noised leaf needs (:func:`draws`).

``chip_smoke.py``'s build phase sets its integer bound from
:func:`threefry_sass` of the kept library; ``design_study --only noise``
counts each counter_noise variant's block the same way.
"""
from __future__ import annotations

import re
import subprocess
from pathlib import Path

# SASS opcodes the ALU pipe issues (64 integer results an SM a clock on
# Hopper, as the FMA pipe's IMAD: the CUDA C++ Programming Guide's
# arithmetic throughput table), and one SASS line's opcode
SASS_ALU = ("IADD3", "LOP3", "SHF", "PRMT", "LEA", "ISETP", "SEL", "IABS",
            "IMNMX", "VIMNMX", "FLO", "POPC", "BMSK", "SGXT", "PLOP3")
SASS_OP = re.compile(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                     r"([A-Z][A-Z0-9]*(?:\.[A-Z0-9_]+)*)")


def draws(hi, lo) -> int:
    """The draws a noised leaf's function needs: its distinct node keys (a
    key in both ``hi`` and ``lo`` is the same draw on both sides)."""
    return len(set(hi) | set(lo))


def sass_text(lib: str) -> str:
    """``cuobjdump -sass`` of a built library (the toolkit's cuobjdump,
    else Triton's copy)."""
    from repro_torch.kernels import build
    tool = Path(build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        import importlib.util
        spec = importlib.util.find_spec("triton")
        tool = (Path(spec.origin).parent / "backends" / "nvidia" / "bin"
                / "cuobjdump") if spec else tool
    return subprocess.run([str(tool), "-sass", lib], capture_output=True,
                          text=True, timeout=300, check=True).stdout


def threefry_sass(out: str) -> dict:
    """The instructions of one threefry2x32 block, counted in the SASS of
    ``threefry_bits_kernel`` (``dp_threefry_bits``: one block a thread,
    straight-line code): those after its last load and before its first
    store but the stores' address arithmetic (LEA), by opcode and by the
    pipe that issues them (SASS_ALU, IMAD on the FMA pipe, the rest).
    ``draw_ops``, the bound's integer operations a draw: the busier of the
    two integer pipes, or half the instructions where issue (two a clock
    for one integer result a lane) binds."""
    ops, inside = [], False
    for ln in out.splitlines():
        if "Function :" in ln:
            inside = "threefry_bits_kernel" in ln
        elif inside:
            m = SASS_OP.match(ln)
            if m:
                ops.append(m.group(1))
    loads = [i for i, op in enumerate(ops) if op.startswith("LDG")]
    stores = [i for i, op in enumerate(ops) if op.startswith("STG")]
    if not loads or not stores or stores[0] < loads[-1]:
        raise AssertionError(f"threefry_bits_kernel's SASS has no load-"
                             f"compute-store shape: {ops}")
    region = [op.split(".")[0] for op in ops[loads[-1] + 1:stores[0]]
              if not op.startswith("LEA")]
    by_op = {op: region.count(op) for op in sorted(set(region))}
    alu = sum(n for op, n in by_op.items() if op in SASS_ALU)
    fma = by_op.get("IMAD", 0)
    if not by_op.get("SHF", 0) and not by_op.get("PRMT", 0):
        raise AssertionError(f"no rotation in threefry_bits_kernel's "
                             f"SASS: {by_op}")
    return {"by_opcode": by_op, "alu": alu, "fma_imad": fma,
            "other": len(region) - alu - fma, "instructions": len(region),
            "draw_ops": max(alu, fma, len(region) / 2)}
