"""Build and load the CUDA kernel library (sm_90a, plain C interface).

The sources under ``csrc/`` are compiled with nvcc, one process per ``.cu``
file, all started together, then linked into one shared library under
``build/repro_torch/`` at the root of the checkout. The library's file name
carries a hash of the sources, so an edit rebuilds it and an unchanged tree
reuses it. Nothing is built at import: the first kernel launch calls
:func:`load`, and ``chip_smoke.py`` calls :func:`build` to time the build.
The library links against the CUDA runtime alone: the tensor-core kernels
take the driver's ``cuTensorMapEncodeTiled`` through
``cudaGetDriverEntryPoint`` (``csrc/hopper.cuh``), so no ``-lcuda``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from repro_torch.kernels import meta

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = "arch=compute_90a,code=sm_90a"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_I64, _U64 = ctypes.c_longlong, ctypes.c_ulonglong
# C entry -> argument types; every entry returns an int (a cudaError_t)
SIGNATURES = {
    "dp_ghost_norm_nparts": [_I],
    "dp_ghost_norm": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "dp_ghost_norm_wgmma_split": [_I] * 5,
    "dp_ghost_norm_wgmma_nparts": [_I] * 5,
    "dp_ghost_norm_wgmma": [_P] * 4 + [_I] * 5 + [_P],
    "dp_clipped_grad_split": [_I] * 5,
    "dp_clipped_grad": [_P] * 5 + [_I] * 7 + [_P],
    "dp_clipped_grad_wgmma": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "dp_emb_norm_nparts": [_I],
    "dp_emb_norm": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "dp_emb_grad_smem_bytes": [_I],
    "dp_emb_grad_scratch_ints": [_I],
    "dp_emb_grad": [_P] * 5 + [_I] * 6 + [_P],
    "dp_grad_norm_direct_nparts": [_I, _I],
    "dp_grad_norm_direct": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "dp_grad_norm_direct_wgmma_nparts": [_I],
    "dp_grad_norm_direct_wgmma": [_P] * 4 + [_I] * 5 + [_P],
    "dp_moe_ghost_norm": [_P, _P, _P, _P, _P] + [_I] * 7 + [_P],
    "dp_moe_ghost_norm_wgmma_nparts": [_I],
    "dp_moe_ghost_norm_wgmma": [_P] * 5 + [_I] * 6 + [_P],
    "dp_moe_direct_norm_nparts": [_I, _I],
    "dp_moe_direct_norm": [_P, _P, _P, _P, _P] + [_I] * 7 + [_P],
    "dp_moe_direct_norm_wgmma_nparts": [_I],
    "dp_moe_direct_norm_wgmma": [_P] * 6 + [_I] * 6 + [_P],
    "dp_moe_clipped_grad": [_P, _P, _P, _P, _P] + [_I] * 7 + [_P],
    "dp_moe_clipped_grad_wgmma": [_P] * 6 + [_I] * 6 + [_P],
    "dp_fused_clip_plan": [_I] * 7 + [_P],
    "dp_fused_clip_nparts": [_I] * 7,
    "dp_fused_clip_scratch_bytes": [_I] * 7,
    "dp_fused_clip_grad": [_P] * 7 + [_I] * 8 + [_F, _F, _P],
    "dp_flash_attention": [_P] * 4 + [_I] * 8 + [_P],
    "dp_flash_attention_wgmma": [_P] * 4 + [_I] * 7 + [_P],
    "dp_wkv6": [_P] * 5 + [_I, _P] + [_I] * 5 + [_P],
    "dp_wkv6_chunked_nparts": [_I, _I],
    "dp_wkv6_chunked": [_P] * 5 + [_I] + [_P] * 2 + [_I] * 5 + [_P],
    "dp_wkv6_backward_nparts": [_I],
    "dp_wkv6_backward": [_P] * 5 + [_I] + [_P] * 8 + [_I] * 5 + [_P],
    "dp_counter_noise": [_P] * 4 + [_I] + [_U64] * 2 + [_I64, _F, _F, _I,
                                                       _P],
    "dp_counter_noise_block": [_P] * 4 + [_I, _P, _U64, _I64, _F, _F, _I,
                                          _P],
    "dp_noise_update": [_P] * 6 + [_I] * 2 + [_U64] * 2 + [_I64] + [_I] * 3
                       + [_P] * 3,
    "dp_noise_update_block": [_P] * 6 + [_I, _P, _U64, _I64] + [_I] * 3
                             + [_P] * 3,
    "dp_threefry_bits": [_P, _P, _I64, _P],
    "dp_ndtri_f32": [_P, _P, _I64, _P],
}


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(ARCH.encode())
    for f in sum(_sources(), []):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           "/usr/local/cuda/bin): the CUDA kernels are built "
                           "on the machine with the card")
    return found


def build() -> dict:
    """Compile the library if this source hash has none yet.
    -> {'path', 'seconds', 'cached', 'ptxas'} (ptxas: the resource report)."""
    path = BUILD_DIR / f"libdpkernels-{source_hash()}.so"
    log = path.with_suffix(".ptxas.txt")
    if path.exists():
        return {"path": str(path), "seconds": 0.0, "cached": True,
                "ptxas": log.read_text() if log.exists() else ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, (cus, _) = _nvcc(), _sources()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (cu.stem + ".o") for cu in cus]
        procs = [subprocess.Popen(
            [nvcc, "-gencode", ARCH, "-std=c++17", "-O3", "-Xptxas=-v",
             "-Xcompiler", "-fPIC", "-c", str(cu), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for cu, obj in zip(cus, objs)]
        reports = []
        for cu, proc in zip(cus, procs):
            out, _ = proc.communicate()
            reports.append(f"== {cu.name}\n{out}")
            if proc.returncode:
                for other in procs:
                    other.kill()
                raise RuntimeError(f"nvcc failed on {cu.name}:\n{out}")
        tmp_lib = Path(tmp) / path.name
        link = subprocess.run(
            [nvcc, "-gencode", ARCH, "-shared", "-o", str(tmp_lib),
             *map(str, objs)], capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}"
                               f"{link.stderr}")
        log.write_text("".join(reports))
        os.replace(tmp_lib, path)
    return {"path": str(path), "seconds": time.perf_counter() - t0,
            "cached": False, "ptxas": log.read_text()}


@functools.cache
def load() -> ctypes.CDLL:
    """The built library with its C signatures declared (built on first
    use)."""
    lib = ctypes.CDLL(build()["path"])
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry."""
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def planning(t) -> bool:
    """Whether ``t`` is a meta tensor of a plan (``kernels.meta.recording``
    active): the only meta tensors a wrapper takes."""
    return t.is_meta and meta.planning()


def lib_for(t) -> ctypes.CDLL:
    """The library a launch on ``t``'s device goes to: the built one, or
    for a plan's meta tensors the planner's stand-in (``kernels.meta.LIB``:
    the C entries' size rules, launches that record)."""
    return meta.LIB if planning(t) else load()


def counted(lib) -> int:
    """1 where ``lib`` launches kernels (a wrapper's ``launches`` count the
    card's launches), 0 for the planner's stand-in. (An identity test: an
    attribute looked up on a ``ctypes.CDLL`` is a symbol lookup, and this
    runs at every launch.)"""
    return 0 if lib is meta.LIB else 1


def check_inputs(name: str, floats, ints=(), f32=()) -> bool:
    """Validate a kernel's operands before their pointers go to C: all on
    one CUDA device (or all on the meta device while a plan records,
    ``kernels.meta.recording``) and contiguous; ``floats`` (the records) share one
    dtype, float32 or bfloat16; ``ints`` are int32; ``f32`` (clip factors,
    slot masks) are float32 whatever the records are. -> True when the
    floats are bfloat16. (Plain loops over cheap tensor attributes: this
    runs before every launch, and a sub-millisecond kernel's time on the
    card includes it.)"""
    index, meta = floats[0].get_device(), planning(floats[0])
    for t in (*floats, *ints, *f32):
        if not (t.is_cuda or meta and t.is_meta) or t.get_device() != index:
            raise ValueError(f"{name}: operands must share one CUDA device, "
                             f"got {t.device} and {floats[0].device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    dt = floats[0].dtype
    bad = dt is not torch.float32 and dt is not torch.bfloat16
    for t in floats:
        bad = bad or t.dtype is not dt
    if bad:
        raise ValueError(f"{name}: records must be one of float32/bfloat16, "
                         f"got {[t.dtype for t in floats]}")
    for t in ints:
        if t.dtype is not torch.int32:
            raise ValueError(f"{name}: ids must be int32")
    for t in f32:
        if t.dtype is not torch.float32:
            raise ValueError(f"{name}: clip factors and masks must be "
                             "float32")
    return dt is torch.bfloat16


def stream_ptr(t) -> int:
    """The current CUDA stream of ``t``'s device, as an int for ctypes (the
    raw handle, without building a ``torch.cuda.Stream`` object); 0 on the
    meta device."""
    if t.is_meta:
        return 0
    return torch._C._cuda_getCurrentRawStream(t.get_device())
