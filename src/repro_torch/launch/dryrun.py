"""The dry-run grid: plan every (architecture x input shape) cell for one
rank of the production meshes, on the meta device (counterpart of the JAX
package's ``repro/launch/dryrun.py``, which lowers and compiles on fake
host devices).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b \
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multipod] \
        [--force]

No card and no JAX: each cell runs the port's own step once on the meta
device (``launch.steps.plan_cell``, ``CellPlan.plan``), rank 0 of (16, 16)
or (2, 16, 16). One JSON a cell lands in
``experiments/dryrun_torch/<mesh>/<arch>__<shape>[__scope_<s>].json``
(``--force`` replans a cell that has one): the reference's keys where they
mean the same (arch, shape, mesh, dp_mode, status, reason / error, memory,
cost, collectives, note, kind), ``plan_s`` (the planning seconds) and
``kernels`` (launches a step, by wrapper and by C entry). A cell whose
step reaches a piece the port lacks is recorded as ``unported`` with the
exception's words; only an ``error`` makes the exit code 1.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import plan_cell, skip_reason

OUT_ROOT = os.path.join(os.path.dirname(__file__),
                        "../../../experiments/dryrun_torch")


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str,
             force: bool = False, dp_mode: str = "bk",
             clipping_scope: str = "") -> dict:
    """Plan one cell (or read its record) -> the record, also written to
    ``out_dir``. ``dp_mode`` is recorded as the reference records it (the
    train cells plan bk-mixopt, as its planner does)."""
    os.makedirs(out_dir, exist_ok=True)
    scope_tag = f"__scope_{clipping_scope}" if clipping_scope else ""
    out_path = os.path.join(out_dir, f"{arch}__{shape}{scope_tag}.json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)
    rec = {"arch": arch, "shape": shape,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "dp_mode": dp_mode, "status": "ok"}
    if clipping_scope:
        rec["clipping_scope"] = clipping_scope
    reason = skip_reason(get_config(arch), SHAPES[shape])
    if reason:
        rec.update(status="skip", reason=reason)
    else:
        try:
            mesh = make_production_mesh(multi_pod=multi_pod, plan=True)
            t0 = time.perf_counter()
            plan = plan_cell(arch, shape, mesh,
                             clipping_scope=clipping_scope)
            rec.update(plan.plan())
            rec["plan_s"] = round(time.perf_counter() - t0, 2)
            rec["note"] = plan.note
            rec["kind"] = plan.kind
        except NotImplementedError as e:
            rec.update(status="unported", error=f"{type(e).__name__}: {e}")
        except Exception as e:  # a failing cell is a bug to fix: keep it
            rec.update(status="error", error=f"{type(e).__name__}: {e}",
                       trace=traceback.format_exc()[-4000:])
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def summary(rec: dict) -> str:
    """The one line a cell prints (the reference's, ``plan`` in place of
    lower / compile)."""
    arch, shape, tag = rec["arch"], rec["shape"], rec["status"]
    if tag == "ok":
        mb = rec["memory"]
        return (f"[{tag}] {arch:22s} {shape:12s} "
                f"args={mb['argument_bytes'] / 2**30:.2f}GiB "
                f"temp={mb['temp_bytes'] / 2**30:.2f}GiB "
                f"peak={mb['peak_bytes'] / 2**30:.2f}GiB "
                f"flops/dev={rec['cost']['flops']:.3g} "
                f"coll={rec['collectives']['total'] / 2**20:.1f}MiB "
                f"(plan {rec.get('plan_s')}s)")
    if tag == "skip":
        return f"[skip] {arch:22s} {shape:12s} {rec['reason'][:80]}"
    if tag == "unported":
        return f"[unpt] {arch:22s} {shape:12s} {rec['error'][:160]}"
    return f"[ERR ] {arch:22s} {shape:12s} {rec['error'][:160]}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=list_archs())
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--dp-mode", default="bk")
    ap.add_argument("--clipping-scope", default="",
                    choices=["", "flat", "group", "layer"],
                    help="re-scope trainable groups before planning (layer "
                         "plans the streamed one-pass backward; results land "
                         "in <arch>__<shape>__scope_<s>.json)")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("pass --arch+--shape or --all")

    mesh_tag = "multipod_2x16x16" if args.multipod else "singlepod_16x16"
    out_dir = os.path.normpath(os.path.join(OUT_ROOT, mesh_tag))
    cells = ([(args.arch, args.shape)] if args.arch and args.shape else
             [(a, s) for a in list_archs() for s in sorted(SHAPES)])
    counts = {"ok": 0, "skip": 0, "unported": 0, "error": 0}
    t0 = time.perf_counter()
    for arch, shape in cells:
        rec = run_cell(arch, shape, args.multipod, out_dir, args.force,
                       args.dp_mode, clipping_scope=args.clipping_scope)
        counts[rec["status"]] += 1
        print(summary(rec), flush=True)
    print(f"done: {counts['ok']} ok, {counts['skip']} skip, "
          f"{counts['unported']} unported, {counts['error']} error "
          f"({time.perf_counter() - t0:.1f}s)")
    return 1 if counts["error"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
