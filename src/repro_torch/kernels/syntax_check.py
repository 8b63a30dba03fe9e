"""Syntax-check the CUDA sources with the host compiler, without nvcc.

    python -m repro_torch.kernels.syntax_check            # every csrc/*.cu
    python -m repro_torch.kernels.syntax_check a.cu ...   # some of them

Each ``.cu`` under ``csrc/`` is parsed by ``g++ -fsyntax-only`` against the
stub headers in ``stubs/`` (``cuda.h``, ``cuda_runtime.h``, ``cuda_bf16.h``:
declarations only, the tensor-map types and driver enums included), with the
``<<<...>>>`` launch configurations of it and of the ``.cuh`` headers beside
it stripped. That catches C++ errors (names, types, template arguments,
argument counts) before a build on the card; it says nothing of PTX, of
inline assembly or of what nvcc accepts beyond C++.
"""
from __future__ import annotations

import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

from repro_torch.kernels.build import CSRC

STUBS = Path(__file__).resolve().parent / "stubs"
_LAUNCH = re.compile(r"<<<.*?>>>", re.S)


def check(cu: Path) -> tuple[bool, str]:
    """-> (parsed cleanly, the compiler's output) for one ``.cu`` file."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the syntax check needs a host "
                           "C++ compiler")
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / (cu.stem + ".cpp")
        src.write_text(_LAUNCH.sub("", cu.read_text()))
        # the headers launch kernels too; a source outside csrc/ (designs/)
        # includes csrc's
        for h in [*CSRC.glob("*.cuh"), *cu.parent.glob("*.cuh")]:
            (Path(tmp) / h.name).write_text(_LAUNCH.sub("", h.read_text()))
        proc = subprocess.run(
            [gxx, "-std=c++17", "-fsyntax-only", "-Wno-unknown-pragmas",
             "-I", str(STUBS), "-I", tmp, str(src)],
            capture_output=True, text=True)
    return proc.returncode == 0, proc.stdout + proc.stderr


def main(argv=None) -> int:
    paths = [Path(a) for a in (argv or [])] or sorted(CSRC.glob("*.cu"))
    bad = 0
    for cu in paths:
        ok, out = check(cu)
        print(f"{'ok  ' if ok else 'FAIL'} {cu.name}")
        if out.strip():
            print(out)
        bad += not ok
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
