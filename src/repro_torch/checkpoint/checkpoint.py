"""Process-sliced, crash-atomic checkpoints, format 2 (counterpart of
``repro/checkpoint/checkpoint.py``; each package reads what the other
writes, except that the JAX package cannot restore a bfloat16 leaf):

    step_0000000042/
        shards.00000.npz    # process 0's slices
        [shards.00001.npz]  # further processes of a multi-process save
        manifest.json       # written last: global shapes, the slice index

Every leaf is stored as its unique slices, each an npz member keyed
``path@offset`` (the offset's indices joined by ``x``), with the leaf's
global shape and dtype name and each slice's CRC32 in the manifest. The
bytes are the JAX package's: the same member keys, ``.npy`` headers,
manifest fields and CRC values. A bfloat16 leaf is its raw 2-byte words
under the ``.npy`` descr ``<V2`` (what numpy writes for ml_dtypes'
bfloat16) and the manifest dtype ``"bfloat16"``; :func:`restore` reads a
member by its manifest dtype, so no ml_dtypes is needed. (The JAX package's
``restore`` cannot assign that ``<V2`` member into a bfloat16 array and
raises: it restores no bf16 model.)

Crash atomicity: the payload goes into ``<final>.tmp``, each file fsync'd,
the manifest last (fsync'd, then the directory), then the staging directory
is renamed into place. A crash before the rename leaves only ``.tmp``,
which :func:`steps` never lists; a torn final directory fails ``_valid``
(file sizes and member sets against the manifest) and :func:`latest_step`
falls back to the step before. The fault sites ``ckpt_mid_write`` and
``ckpt_pre_commit`` (``runtime.fault_injection``) kill the writer at those
points. :func:`write_shard_file` (one process's file) and :func:`commit`
(the manifest over every process's file) are separately callable, with
``process_index`` and ``process_count``.

A multi-process save (:func:`save` with ``process_count`` > 1 and a gloo
``group``): each process snapshots the unique blocks it holds at their
global offsets (``shard_snapshot(..., layout=)``; a replicated block is
written by one process only), process 0 stages the directory, every process
writes its own file (``ckpt_mid_write`` fires on each), the manifest
fragments are gathered to process 0, which commits (``ckpt_pre_commit``),
and every process waits for the commit. :func:`restore` reads, at any
world size, the slices that overlap the blocks it asks for (``blocks=``).

Snapshots: the port's optimizers update params and state in place, so
:func:`shard_snapshot` copies every tensor to the host before the caller's
next step (into reused, pinned buffers for a device tensor) and the writer
reads only those copies. No second copy of the state is made on the device.

Checksums: zipfile computes each member's CRC32 as it writes it; the
manifest's CRC32, of the slice's bytes alone, follows from the member's
and its ``.npy`` header's by ``crc32_combine`` (zlib's), so a save passes
over the bytes once. A restore reads each stored member's bytes straight
from the file into the leaf's host tensor and checks their CRC32 against
the manifest's.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import struct
import zipfile
import zlib
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.runtime.fault_injection import maybe_fault
from repro_torch.utils.tree import flatten, unflatten

MANIFEST = "manifest.json"
FORMAT_VERSION = 2
# the .npy descr numpy writes for an ml_dtypes bfloat16 array
BF16_DESCR = "<V2"
# manifest dtype name -> torch dtype
DTYPES = {name: getattr(torch, name) for name in (
    "float64", "float32", "float16", "bfloat16", "int64", "int32", "int16",
    "int8", "uint8", "uint16", "uint32", "uint64", "bool")}
# bytes a read hands zipfile at a time (the host holds one such chunk
# beside the leaf it fills)
READ_CHUNK = 64 << 20
_NPY_MAGIC = b"\x93NUMPY"
# a zip member's local header: signature, 22 bytes, name and extra lengths
_ZIP_LOCAL = struct.Struct("<4s22xHH")


def _ckpt_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:010d}")


def _shard_file(process_index: int) -> str:
    return f"shards.{process_index:05d}.npz"


# ------------------------------------------------------------- checksums
_CRC_POLY = 0xEDB88320      # CRC-32, reflected


def _multmodp(a: int, b: int) -> int:
    """a(x) b(x) modulo the CRC-32 polynomial, bits reflected (zlib's
    ``multmodp``)."""
    m, p = 1 << 31, 0
    while True:
        if a & m:
            p ^= b
            if a & (m - 1) == 0:
                return p
        m >>= 1
        b = (b >> 1) ^ _CRC_POLY if b & 1 else b >> 1


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """The CRC32 of ``A + B`` from ``crc32(A)``, ``crc32(B)`` and ``len(B)``
    (zlib's ``crc32_combine``): crc1 times x^(8 len2), plus crc2."""
    shift, sq = 1 << 31, 1 << 23        # x^0; x^8 (one byte)
    n = len2
    while n:
        if n & 1:
            shift = _multmodp(sq, shift)
        n >>= 1
        sq = _multmodp(sq, sq)
    return _multmodp(shift, crc1) ^ crc2


def _crc_of_tail(whole: int, head: int, tail_len: int) -> int:
    """crc32(B) from crc32(A + B), crc32(A) and len(B)."""
    return whole ^ crc32_combine(head, 0, tail_len)


# ----------------------------------------------------------------- bytes
def _torch_dtype(dtype) -> torch.dtype:
    """A manifest dtype name, numpy dtype or torch dtype -> torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype) if isinstance(dtype, str) else str(np.dtype(dtype))
    if name not in DTYPES:
        raise IOError(f"checkpoint dtype {name!r} has no torch dtype")
    return DTYPES[name]


def _descr(name: str) -> str:
    return BF16_DESCR if name == "bfloat16" else np.dtype(name).str


def _raw(data) -> memoryview:
    """The C-order bytes of a host tensor or array, as one flat view."""
    if isinstance(data, torch.Tensor):
        flat = data.detach().contiguous().reshape(-1).view(torch.uint8)
        return memoryview(flat.numpy())
    return memoryview(np.ascontiguousarray(data).reshape(-1).view(np.uint8))


# ------------------------------------------------------------- snapshot
@dataclass
class ShardSlice:
    """One slice of one leaf; ``data`` is a host tensor or numpy array."""
    path: str
    offset: tuple                # global start index per dim
    shape: tuple                 # slice shape
    global_shape: tuple
    dtype: str                   # manifest dtype name
    data: object

    def key(self) -> str:
        return f"{self.path}@{'x'.join(map(str, self.offset))}"


def shard_snapshot(state, buffers: Optional[dict] = None,
                   layout: Optional[dict] = None) -> list:
    """-> list[ShardSlice]: one slice a leaf, backed by host copies complete
    when this returns. Without a ``layout`` each leaf is a whole leaf at
    offset 0 (one process); with one, ``layout[path]`` = (offsets, global
    shape) places the leaf, the process's block, in the whole leaf, and a
    path the layout lacks is not written by this process (a replica another
    one writes).

    A tensor is copied into ``buffers[path]`` where a dict is given (the
    buffers are allocated on first use and reused by every later snapshot
    of the same shapes; pinned for a device tensor), else into a fresh host
    tensor. The copy must be made before the caller's next step: the
    optimizers update params and state in place. Other leaves (ints, numpy
    arrays) are taken as numpy arrays."""
    slices, devices = [], set()
    for path, leaf in flatten(state).items():
        if layout is not None and path not in layout:
            continue
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach()
            host = buffers.get(path) if buffers is not None else None
            if host is None or host.shape != leaf.shape or \
                    host.dtype != leaf.dtype:
                host = torch.empty(leaf.shape, dtype=leaf.dtype,
                                   pin_memory=leaf.is_cuda)
                if buffers is not None:
                    buffers[path] = host
            host.copy_(leaf, non_blocking=leaf.is_cuda)
            if leaf.is_cuda:
                devices.add(leaf.device)
            data, name = host, str(leaf.dtype).removeprefix("torch.")
        else:
            data = np.asarray(leaf)
            name = str(data.dtype)
        shape = tuple(data.shape)
        offset, whole = (layout[path] if layout is not None
                         else ((0,) * len(shape), shape))
        slices.append(ShardSlice(path, tuple(offset), shape, tuple(whole),
                                 name, data))
    for dev in devices:
        torch.cuda.synchronize(dev)
    return slices


# ------------------------------------------------------------------ save
def _fsync_write(fp: str, write_fn) -> int:
    with open(fp, "wb") as f:
        write_fn(f)
        f.flush()
        os.fsync(f.fileno())
    return os.path.getsize(fp)


def _fsync_dir(d: str) -> None:
    fd = os.open(d, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_member(zf: zipfile.ZipFile, s: ShardSlice) -> int:
    """Slice ``s`` as the member ``key.npy`` (the header numpy writes, then
    the bytes) -> the CRC32 of the bytes."""
    raw = _raw(s.data)
    head = io.BytesIO()
    np.lib.format.write_array_header_1_0(
        head, {"descr": _descr(s.dtype), "fortran_order": False,
               "shape": _stored_shape(s.data)})
    head = head.getvalue()
    name = s.key() + ".npy"
    with zf.open(name, "w", force_zip64=True) as f:
        f.write(head)
        f.write(raw)
    return _crc_of_tail(zf.getinfo(name).CRC, zlib.crc32(head), raw.nbytes)


def _stored_shape(data) -> tuple:
    """A slice's shape as the file stores it: a scalar as one element, as
    the JAX package's writer (``np.ascontiguousarray``) stores it."""
    return tuple(data.shape) or (1,)


def write_shard_file(tmp: str, process_index: int, slices: list):
    """Write one process's payload file into the staging dir.
    -> (fname, file_info, arrays_meta): the manifest fragments this process
    contributes; :func:`commit` unions every process's."""
    fname = _shard_file(process_index)
    entries, arrays_meta = {}, {}

    def write(f):
        with zipfile.ZipFile(f, "w", compression=zipfile.ZIP_STORED,
                             allowZip64=True) as zf:
            for s in slices:
                entries[s.key()] = {
                    "path": s.path, "offset": list(s.offset),
                    "shape": list(_stored_shape(s.data)),
                    "crc": _write_member(zf, s)}
                arrays_meta[s.path] = {"shape": list(s.global_shape),
                                       "dtype": s.dtype}

    nbytes = _fsync_write(os.path.join(tmp, fname), write)
    maybe_fault("ckpt_mid_write")   # payload on disk, manifest not
    return fname, {"bytes": nbytes, "entries": entries}, arrays_meta


def commit(root: str, step: int, tmp: str, files: dict, arrays: dict,
           meta: Optional[dict] = None, keep: int = 3,
           process_count: int = 1) -> str:
    """Write the manifest over the staged payload files and rename the
    staging dir into place. ``files`` / ``arrays`` are the unions of every
    process's :func:`write_shard_file` fragments."""
    manifest = {
        "format": FORMAT_VERSION, "step": step, "meta": meta or {},
        "process_count": process_count,
        "arrays": arrays, "files": files,
    }
    _fsync_write(os.path.join(tmp, MANIFEST),
                 lambda f: f.write(json.dumps(manifest).encode()))
    _fsync_dir(tmp)

    maybe_fault("ckpt_pre_commit")  # everything written, not renamed

    final = _ckpt_dir(root, step)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _fsync_dir(root)
    _gc(root, keep)
    return final


def stage_dir(root: str, step: int, fresh: bool = True) -> str:
    """Create (or reuse) the staging dir a save writes into before commit."""
    os.makedirs(root, exist_ok=True)
    tmp = _ckpt_dir(root, step) + ".tmp"
    if fresh and os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    return tmp


def save(root: str, step: int, state, keep: int = 3,
         meta: Optional[dict] = None, process_index: int = 0,
         process_count: int = 1, group=None) -> str:
    """Persist a tree (or a :func:`shard_snapshot` list) atomically ->
    the committed checkpoint's path. ``meta`` is a json-able dict stored in
    the manifest (``run_state.pack_meta``: the noise mechanism's state, the
    privacy ledger, the pipeline's config, the run's fingerprint). With
    ``process_count`` > 1 every process of the gloo ``group`` calls it with
    its own slices, and process 0 commits the manifest over every file."""
    slices = state if isinstance(state, list) else shard_snapshot(state)
    if process_count <= 1:
        tmp = stage_dir(root, step, fresh=(process_index == 0))
        fname, finfo, arrays = write_shard_file(tmp, process_index, slices)
        return commit(root, step, tmp, {fname: finfo}, arrays, meta, keep,
                      process_count)
    import torch.distributed as dist
    if process_index == 0:
        tmp = stage_dir(root, step, fresh=True)
    dist.barrier(group=group)            # the staging dir exists, emptied
    if process_index != 0:
        tmp = stage_dir(root, step, fresh=False)
    fragment = write_shard_file(tmp, process_index, slices)
    fragments = [None] * process_count
    dist.all_gather_object(fragments, fragment, group=group)
    final = _ckpt_dir(root, step)
    if process_index == 0:
        files, arrays = {}, {}
        for fname, finfo, arr in fragments:
            files[fname] = finfo
            arrays.update(arr)
        final = commit(root, step, tmp, files, arrays, meta, keep,
                       process_count)
    dist.barrier(group=group)            # committed
    return final


def nbytes(path: str) -> int:
    """The bytes of a committed checkpoint directory's files."""
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


# ------------------------------------------------------------- discovery
def steps(root: str):
    if not os.path.isdir(root):
        return []
    out = []
    for d in os.listdir(root):
        if d.startswith("step_") and not d.endswith(".tmp"):
            try:
                out.append(int(d[5:]))
            except ValueError:
                pass
    return sorted(out)


def _manifest(root: str, step: int) -> dict:
    with open(os.path.join(_ckpt_dir(root, step), MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT_VERSION:
        raise IOError(
            f"checkpoint format {manifest.get('format')!r} at step {step}; "
            f"this build reads format {FORMAT_VERSION}")
    return manifest


def _member_keys(names) -> set:
    return {n[:-4] if n.endswith(".npy") else n for n in names}


def _valid(root: str, step: int) -> bool:
    """Structural check: the manifest parses, every payload file exists at
    its recorded size, and its members are the manifest's slice keys.
    (Checksums are checked by :func:`restore`.)"""
    d = _ckpt_dir(root, step)
    try:
        manifest = _manifest(root, step)
        files = manifest["files"]
        if not files:
            return False
        for fname, info in files.items():
            fp = os.path.join(d, fname)
            if not os.path.isfile(fp) or os.path.getsize(fp) != info["bytes"]:
                return False
            with zipfile.ZipFile(fp) as z:
                if _member_keys(z.namelist()) != set(info["entries"]):
                    return False
        return True
    except (OSError, ValueError, KeyError, TypeError, AttributeError,
            zipfile.BadZipFile):
        return False


def latest_step(root: str):
    """The newest checkpoint that passes ``_valid`` (torn writes skipped)."""
    for s in reversed(steps(root)):
        if _valid(root, s):
            return s
    return None


# --------------------------------------------------------------- restore
def _covered(shape: tuple, boxes: list) -> bool:
    """Whether the (offset, shape) boxes, each inside ``shape``, cover every
    element of it: a grid over the boxes' edges in each dim, each cell
    marked by the boxes that hold it (no per-element mask)."""
    edges = [sorted({0, n, *(off[dim] for off, _ in boxes),
                     *(off[dim] + size[dim] for off, size in boxes)})
             for dim, n in enumerate(shape)]
    grid = np.zeros([len(e) - 1 for e in edges], dtype=bool)
    for off, size in boxes:
        grid[tuple(slice(e.index(o), e.index(o + k))
                   for e, o, k in zip(edges, off, size))] = True
    return bool(grid.all())


def _read_member(f, info: zipfile.ZipInfo, key: str, name: str,
                 shape: tuple, dst: torch.Tensor) -> int:
    """Read slice ``key``, the stored member ``info`` of the open npz file
    ``f``, straight into the host tensor ``dst`` (whose dtype the
    manifest's ``name`` gives) -> the CRC32 of its bytes."""
    if info.compress_type != zipfile.ZIP_STORED:
        raise IOError(f"member {key} is compressed; a checkpoint stores "
                      "its members")
    f.seek(info.header_offset)
    sig, n_name, n_extra = _ZIP_LOCAL.unpack(f.read(_ZIP_LOCAL.size))
    if sig != b"PK\x03\x04":
        raise IOError(f"member {key} has no zip local header")
    f.seek(info.header_offset + _ZIP_LOCAL.size + n_name + n_extra)
    pre = f.read(8)                               # magic, version
    if pre[:6] != _NPY_MAGIC or pre[6] not in (1, 2):
        raise IOError(f"member {key} is not a .npy of version 1 or 2")
    size = f.read(2 if pre[6] == 1 else 4)
    head = pre + size + f.read(int.from_bytes(size, "little"))
    read_header = (np.lib.format.read_array_header_1_0 if pre[6] == 1
                   else np.lib.format.read_array_header_2_0)
    got_shape, fortran, got_dtype = read_header(io.BytesIO(head[8:]))
    raw = _raw(dst)
    if tuple(got_shape) != shape or fortran or \
            got_dtype != np.dtype(_descr(name)) or \
            len(head) + raw.nbytes != info.file_size:
        raise IOError(f"member {key} holds {got_dtype} {tuple(got_shape)} "
                      f"(fortran order {fortran}, {info.file_size} bytes); "
                      f"the manifest says {name} {shape}")
    crc, pos = 0, 0
    while pos < raw.nbytes:
        got = f.readinto(raw[pos:pos + READ_CHUNK])
        if not got:
            raise IOError(f"member {key} ends after {pos} of {raw.nbytes} "
                          "bytes")
        crc = zlib.crc32(raw[pos:pos + got], crc)
        pos += got
    return crc


def restore(root: str, step=None, template=None, device="cuda",
            blocks: Optional[dict] = None):
    """Load a checkpoint -> (state, step, meta), every leaf a tensor on
    ``device``.

    Each leaf is assembled from its slices, whatever processes wrote them:
    each slice's CRC32 is checked against the manifest, slices at the same
    offset (replicas) must agree, and the slices must cover the leaf (a
    missing process file or a dropped slice raises instead of restoring
    zeros). A leaf is read into host memory, moved to ``device`` and
    dropped from the host before the next is read.

    ``blocks`` ({path: (offsets, shape)}) asks for a block of a leaf in
    place of the whole (a rank of a mesh): only the slices that overlap it
    are read, each into its part of the block.

    ``template`` (a tree of tensors or arrays) names keys that must exist
    and the dtypes they take; checkpoint keys outside it keep their own
    dtypes."""
    step = latest_step(root) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no valid checkpoint under {root}")
    d = _ckpt_dir(root, step)
    manifest = _manifest(root, step)
    arrays = manifest["arrays"]
    tflat = flatten(template) if template is not None else {}
    missing = set(tflat) - set(arrays)
    if missing:
        raise IOError(f"checkpoint at step {step} lacks template keys "
                      f"{sorted(missing)}")

    # every leaf's slices across the process files, and their coverage
    parts = {path: [] for path in arrays}
    for fname, finfo in manifest["files"].items():
        for key, e in finfo["entries"].items():
            if e["path"] not in parts:
                raise IOError(f"slice {key} of {fname} belongs to no array "
                              f"of the manifest (step {step})")
            shape = tuple(arrays[e["path"]]["shape"])
            off, n = tuple(e["offset"]), tuple(e["shape"])
            box = () if shape == () and n == (1,) else n   # a stored scalar
            if not len(off) == len(box) == len(shape) or any(
                    o < 0 or k < 0 or o + k > m
                    for o, k, m in zip(off, box, shape)):
                raise IOError(f"slice {key} of {fname} at {list(off)} "
                              f"{list(n)} lies outside its array "
                              f"{list(shape)} (step {step})")
            parts[e["path"]].append((fname, key, off, box, e))
    holes = [path for path, info in arrays.items()
             if not _covered(tuple(info["shape"]),
                             [(off, box) for _, _, off, box, _ in parts[path]])]
    if holes:
        raise IOError(
            f"incomplete shard coverage at step {step} for {sorted(holes)} "
            "(missing process file or dropped slice)")

    dev = torch.device(device)
    state = {}
    members, files = {}, {}
    with contextlib.ExitStack() as stack:
        for fname in manifest["files"]:
            fp = os.path.join(d, fname)
            with zipfile.ZipFile(fp) as z:
                members[fname] = {i.filename: i for i in z.infolist()}
            files[fname] = stack.enter_context(open(fp, "rb"))
        for path, info in arrays.items():
            shape, name = tuple(info["shape"]), info["dtype"]
            want_off, want = (blocks[path] if blocks and path in blocks
                              else ((0,) * len(shape), shape))
            want_off, want = tuple(want_off), tuple(want)
            leaf = torch.empty(want, dtype=_torch_dtype(name))
            crcs = {}
            for fname, key, off, box, e in parts[path]:
                cut = _overlap(off, box, want_off, want)
                if cut is None:
                    continue
                whole = box == want and off == want_off
                dst = leaf if whole else torch.empty(box, dtype=leaf.dtype)
                info = members[fname].get(key + ".npy")
                if info is None:
                    raise IOError(f"{fname} at step {step} has no member "
                                  f"{key}")
                crc = _read_member(files[fname], info, key, name,
                                   tuple(e["shape"]), dst)
                if crc != e["crc"]:
                    raise IOError(f"checksum mismatch for {key} in {fname} "
                                  f"at step {step}")
                if crcs.setdefault(off, crc) != crc:
                    raise IOError(
                        f"replicated slice disagreement for {path} at "
                        f"offset {off} (step {step})")
                if not whole:
                    leaf[cut[1]] = dst[cut[0]]
            dtype = (_torch_dtype(tflat[path].dtype) if path in tflat
                     else leaf.dtype)
            state[path] = leaf.to(device=dev, dtype=dtype)
            del leaf
    return unflatten(state), manifest["step"], manifest.get("meta", {})


def _overlap(off, box, want_off, want):
    """-> (index into the slice, index into the block) of the part of the
    slice at ``off`` of shape ``box`` inside the block at ``want_off`` of
    shape ``want``; None where they do not overlap."""
    src, dst = [], []
    for o, k, w, n in zip(off, box, want_off, want):
        lo, hi = max(o, w), min(o + k, w + n)
        if lo >= hi:
            return None
        src.append(slice(lo - o, hi - o))
        dst.append(slice(lo - w, hi - w))
    return tuple(src), tuple(dst)


def _gc(root: str, keep: int):
    all_steps = steps(root)
    for s in all_steps[:-keep] if keep > 0 else []:
        shutil.rmtree(_ckpt_dir(root, s), ignore_errors=True)
