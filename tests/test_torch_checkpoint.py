"""The port's format-2 checkpoints (``repro_torch.checkpoint.checkpoint``)
against the JAX package's (``repro.checkpoint.checkpoint``).

- The sliced-format cases of tests/test_elastic_restart.py (multi-process
  save, coverage, CRC and replica refusals, template subset) and the
  checkpoint cases of tests/test_substrate.py (round trip, keep-k, a
  corrupt payload skipped), on the port.
- Each package reads the other's files: the reference's ``restore`` and
  ``latest_step`` read a directory the port wrote (f32 params, SGD and
  AdamW state, step, rng), and the port reads one the reference wrote,
  bf16 leaves included.
- A bf16 leaf's npz member bytes and the manifest equal the reference
  writer's, and the port restores them bitwise; the reference's own
  ``restore`` raises on that directory (it cannot cast its ``<V2`` member
  into bfloat16), a finding stated as a test.
- A save/restore round trip of all five optimizers' state, then one more
  step from both, bitwise.
- The CRC arithmetic (``crc32_combine``) against zlib, and coverage by
  slice boxes."""
import json
import os
import zipfile
import zlib

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as rckpt
from repro.configs.registry import build as jbuild
from repro.configs.registry import smoke_config as jsmoke
from repro.optim.optimizers import make_optimizer as jmake_optimizer
from repro.utils.tree import flatten as jflatten
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.registry import build, smoke_config
from repro_torch.core.noise import prng_key
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.utils.tree import flatten, unflatten

OPTIMIZERS = ("sgd", "adamw", "lamb", "adafactor", "ftrl")


def _bytes(x) -> bytes:
    """A leaf's raw bytes (a torch tensor on any device, or an array)."""
    if isinstance(x, torch.Tensor):
        return ckpt._raw(x.detach().cpu()).tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _assert_same(got: dict, want: dict):
    """Flat trees with the same keys, shapes and bytes."""
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(np.shape(want[k])), k
        assert _bytes(got[k]) == _bytes(want[k]), k


# ----------------------------------------------------- the sliced format
def _two_host_slices():
    a = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    top = ckpt.ShardSlice("params/w", (0, 0), (2, 6), (4, 6), "float32",
                          a[:2].clone())
    bot = ckpt.ShardSlice("params/w", (2, 0), (2, 6), (4, 6), "float32",
                          a[2:].clone())
    step = ckpt.ShardSlice("step", (), (), (), "int64",
                           np.asarray(3, np.int64))
    return a, top, bot, step


def test_multi_process_sliced_save_roundtrip(tmp_path):
    """Two processes write disjoint slice files; commit unions them;
    restore reassembles the global array exactly, in either package."""
    a, top, bot, step = _two_host_slices()
    tmp = ckpt.stage_dir(str(tmp_path), 3)
    f0, i0, m0 = ckpt.write_shard_file(tmp, 0, [top, step])
    f1, i1, m1 = ckpt.write_shard_file(tmp, 1, [bot])
    ckpt.commit(str(tmp_path), 3, tmp, {f0: i0, f1: i1}, {**m0, **m1},
                meta={"k": 1}, process_count=2)
    state, got_step, meta = ckpt.restore(str(tmp_path), device="cpu")
    assert got_step == 3 and meta == {"k": 1}
    assert torch.equal(state["params"]["w"], a)
    assert int(state["step"]) == 3 and state["step"].dtype == torch.int64
    ref, ref_step, ref_meta = rckpt.restore(str(tmp_path))
    assert ref_step == 3 and ref_meta == {"k": 1}
    np.testing.assert_array_equal(ref["params"]["w"], a.numpy())


def test_restore_rejects_incomplete_coverage(tmp_path):
    """A manifest whose slices do not cover an array (a lost process file)
    raises, never restores zeros."""
    a, top, bot, step = _two_host_slices()
    tmp = ckpt.stage_dir(str(tmp_path), 1)
    f0, i0, m0 = ckpt.write_shard_file(tmp, 0, [top, step])
    _, _, m1 = ckpt.write_shard_file(tmp, 1, [bot])
    ckpt.commit(str(tmp_path), 1, tmp, {f0: i0}, {**m0, **m1})
    with pytest.raises(IOError, match="coverage"):
        ckpt.restore(str(tmp_path), step=1, device="cpu")
    with pytest.raises(IOError, match="coverage"):
        rckpt.restore(str(tmp_path), step=1)


def test_restore_rejects_crc_mismatch(tmp_path):
    a, top, bot, step = _two_host_slices()
    ckpt.save(str(tmp_path), 2, [top, bot, step])
    mpath = os.path.join(str(tmp_path), "step_0000000002", ckpt.MANIFEST)
    with open(mpath) as f:
        manifest = json.load(f)
    fname = next(iter(manifest["files"]))
    key = next(iter(manifest["files"][fname]["entries"]))
    manifest["files"][fname]["entries"][key]["crc"] ^= 0xFF
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(IOError, match="checksum"):
        ckpt.restore(str(tmp_path), step=2, device="cpu")
    with pytest.raises(IOError, match="checksum"):
        rckpt.restore(str(tmp_path), step=2)


def test_restore_rejects_a_corrupt_payload_byte(tmp_path):
    """A flipped byte inside a slice (the file's size unchanged, so
    ``latest_step`` still lists it) fails the checksum in both packages."""
    ckpt.save(str(tmp_path), 1, {"w": torch.arange(64.0)})
    fp = os.path.join(str(tmp_path), "step_0000000001", "shards.00000.npz")
    with zipfile.ZipFile(fp) as z:
        info = z.getinfo("w@0.npy")
    blob = bytearray(open(fp, "rb").read())
    blob[info.header_offset + 200] ^= 0x01     # inside the .npy's data
    open(fp, "wb").write(bytes(blob))
    assert ckpt.latest_step(str(tmp_path)) == 1
    with pytest.raises(IOError, match="checksum"):
        ckpt.restore(str(tmp_path), device="cpu")
    with pytest.raises(zipfile.BadZipFile, match="CRC"):
        rckpt.restore(str(tmp_path))


def test_restore_refuses_a_compressed_member(tmp_path):
    """The port reads a member's bytes straight from the file, so it must
    be stored: a payload rewritten compressed (same members) is refused."""
    path = ckpt.save(str(tmp_path), 1, {"w": torch.zeros(256)})
    fp = os.path.join(path, "shards.00000.npz")
    with zipfile.ZipFile(fp) as z:
        members = {n: z.read(n) for n in z.namelist()}
    with zipfile.ZipFile(fp, "w", compression=zipfile.ZIP_DEFLATED) as z:
        for n, data in members.items():
            z.writestr(n, data)
    with pytest.raises(IOError, match="compressed"):
        ckpt.restore(str(tmp_path), step=1, device="cpu")


def test_restore_rejects_replica_disagreement(tmp_path):
    """Two processes claiming the same offset with different bytes is a
    corrupted replicated leaf: restore refuses to pick one."""
    a, top, bot, step = _two_host_slices()
    top2 = ckpt.ShardSlice("params/w", (0, 0), (2, 6), (4, 6), "float32",
                           a[:2] + 1.0)
    tmp = ckpt.stage_dir(str(tmp_path), 4)
    f0, i0, m0 = ckpt.write_shard_file(tmp, 0, [top, bot, step])
    f1, i1, m1 = ckpt.write_shard_file(tmp, 1, [top2])
    ckpt.commit(str(tmp_path), 4, tmp, {f0: i0, f1: i1}, {**m0, **m1},
                process_count=2)
    with pytest.raises(IOError, match="disagreement"):
        ckpt.restore(str(tmp_path), step=4, device="cpu")
    with pytest.raises(IOError, match="disagreement"):
        rckpt.restore(str(tmp_path), step=4)


def test_agreeing_replicas_and_a_2x2_grid_restore(tmp_path):
    """Four slices of a 2 x 2 grid (rows and columns split), one of them
    written again by a second process (a replica that agrees): the leaf
    comes back whole, in either package."""
    a = torch.arange(48, dtype=torch.float32).reshape(6, 8)
    parts = [ckpt.ShardSlice("w", (r, c), (3, 4), (6, 8), "float32",
                             a[r:r + 3, c:c + 4].clone())
             for r in (0, 3) for c in (0, 4)]
    tmp = ckpt.stage_dir(str(tmp_path), 0)
    f0, i0, m0 = ckpt.write_shard_file(tmp, 0, parts[:3])
    f1, i1, m1 = ckpt.write_shard_file(tmp, 1, parts[2:])
    ckpt.commit(str(tmp_path), 0, tmp, {f0: i0, f1: i1}, {**m0, **m1},
                process_count=2)
    state, _, _ = ckpt.restore(str(tmp_path), device="cpu")
    assert torch.equal(state["w"], a)
    ref, _, _ = rckpt.restore(str(tmp_path))
    np.testing.assert_array_equal(ref["w"], a.numpy())


def test_restore_rejects_a_slice_outside_its_array(tmp_path):
    a, top, bot, step = _two_host_slices()
    out = ckpt.ShardSlice("params/w", (3, 0), (2, 6), (4, 6), "float32",
                          a[2:].clone())
    ckpt.save(str(tmp_path), 6, [top, bot, out])
    with pytest.raises(IOError, match="outside"):
        ckpt.restore(str(tmp_path), device="cpu")


@pytest.mark.parametrize("shape,boxes,want", [
    ((4, 6), [((0, 0), (2, 6)), ((2, 0), (2, 6))], True),
    ((4, 6), [((0, 0), (2, 6))], False),
    ((4, 6), [((0, 0), (4, 3)), ((0, 2), (4, 4))], True),     # overlapping
    ((4, 6), [((0, 0), (3, 6)), ((2, 0), (1, 6))], False),
    ((2, 2, 2), [((i, j, k), (1, 1, 1)) for i in (0, 1) for j in (0, 1)
                 for k in (0, 1)][:-1], False),
    ((), [((), ())], True),
    ((), [], False),
    ((0, 3), [], True),
])
def test_coverage_by_slice_boxes(shape, boxes, want):
    """The box grid says what an element mask of the leaf would say."""
    mask = np.zeros(shape, dtype=bool)
    for off, size in boxes:
        mask[tuple(slice(o, o + k) for o, k in zip(off, size)) or ...] = True
    assert ckpt._covered(shape, boxes) == bool(mask.all()) == want


def test_template_subset_and_missing_key(tmp_path):
    """Template keys must exist in the checkpoint (missing: an error);
    checkpoint keys outside the template pass through with their own
    dtype."""
    ckpt.save(str(tmp_path), 5, {"a": torch.ones(3),
                                 "extra": torch.zeros(2)})
    state, _, _ = ckpt.restore(
        str(tmp_path), template={"a": torch.zeros(3, dtype=torch.float64)},
        device="cpu")
    assert state["a"].dtype == torch.float64       # the template's dtype
    assert state["extra"].dtype == torch.float32   # passes through
    state, _, _ = ckpt.restore(str(tmp_path),
                               template={"a": np.zeros(3, np.float16)},
                               device="cpu")
    assert state["a"].dtype == torch.float16
    with pytest.raises(IOError, match="lacks template keys"):
        ckpt.restore(str(tmp_path), template={"missing": torch.zeros(1)},
                     device="cpu")


# ------------------------------------------- discovery and atomic commits
def test_checkpoint_roundtrip_keep_k_and_latest(tmp_path):
    params = {"l0": {"w": torch.randn(5, 3)}, "b": torch.randn(3)}
    for s in [1, 2, 3, 4, 5]:
        ckpt.save(str(tmp_path), s, {"params": params,
                                     "step": np.asarray(s)}, keep=2)
    assert ckpt.steps(str(tmp_path)) == [4, 5]
    assert ckpt.latest_step(str(tmp_path)) == 5
    restored, step, meta = ckpt.restore(str(tmp_path), device="cpu")
    assert step == 5 and meta == {} and int(restored["step"]) == 5
    _assert_same(flatten(restored["params"]), flatten(params))


def test_checkpoint_corrupt_payload_falls_back(tmp_path):
    params = {"w": torch.randn(4, 4)}
    ckpt.save(str(tmp_path), 1, {"params": params})
    ckpt.save(str(tmp_path), 2, {"params": params})
    bad = os.path.join(str(tmp_path), "step_0000000002", "shards.00000.npz")
    with open(bad, "wb") as f:
        f.write(b"garbage")
    assert ckpt.latest_step(str(tmp_path)) == 1
    assert rckpt.latest_step(str(tmp_path)) == 1


def test_torn_and_staged_directories_are_never_listed(tmp_path):
    """A staging dir is never a step; a final dir whose manifest is missing,
    of another format, or whose member set differs is skipped."""
    root = str(tmp_path)
    ckpt.save(root, 1, {"w": torch.ones(2)})
    os.makedirs(os.path.join(root, "step_0000000009.tmp"))
    assert ckpt.steps(root) == [1]
    for step, damage in ((2, "manifest"), (3, "format"), (4, "members")):
        path = ckpt.save(root, step, {"w": torch.ones(2), "v": torch.ones(3)},
                         keep=10)
        mpath = os.path.join(path, ckpt.MANIFEST)
        if damage == "manifest":
            os.remove(mpath)
        else:
            manifest = json.load(open(mpath))
            if damage == "format":
                manifest["format"] = 1
            else:
                entries = manifest["files"]["shards.00000.npz"]["entries"]
                entries.pop("v@0")
            json.dump(manifest, open(mpath, "w"))
    assert ckpt.steps(root) == [1, 2, 3, 4]
    assert ckpt.latest_step(root) == 1 == rckpt.latest_step(root)
    with pytest.raises(IOError, match="format"):
        ckpt.restore(root, step=3, device="cpu")


def test_pre_commit_staging_dir_is_replaced(tmp_path):
    """A save at a step whose staging dir a crash left behind clears it and
    commits cleanly."""
    root = str(tmp_path)
    stale = ckpt.stage_dir(root, 0)
    open(os.path.join(stale, "shards.00000.npz"), "wb").write(b"torn")
    assert ckpt.latest_step(root) is None
    ckpt.save(root, 0, {"w": torch.ones(2, 2)})
    assert ckpt.latest_step(root) == 0
    assert os.listdir(root) == ["step_0000000000"]


def test_reads_in_chunks(tmp_path, monkeypatch):
    """A slice larger than a read chunk is read in pieces, bitwise."""
    monkeypatch.setattr(ckpt, "READ_CHUNK", 1000)
    w = torch.randn(37, 101)
    ckpt.save(str(tmp_path), 0, {"w": w, "b": torch.randn(10).bfloat16()})
    state, _, _ = ckpt.restore(str(tmp_path), device="cpu")
    assert torch.equal(state["w"], w)


@pytest.mark.parametrize("n", [0, 1, 3, 255, 4096, 1 << 20])
def test_crc32_combine_is_zlibs(n):
    r = np.random.default_rng(n)
    head, tail = (r.integers(0, 256, k, dtype=np.uint8).tobytes()
                  for k in (128, n))
    whole = zlib.crc32(head + tail)
    assert ckpt.crc32_combine(zlib.crc32(head), zlib.crc32(tail), n) == whole
    assert ckpt._crc_of_tail(whole, zlib.crc32(head), n) == zlib.crc32(tail)


def test_crc_over_the_buffer_equals_the_copy():
    for t in (torch.randn(7, 3), torch.randn(5).bfloat16(),
              torch.tensor(3, dtype=torch.int64),
              torch.tensor([True, False])):
        assert zlib.crc32(ckpt._raw(t)) == zlib.crc32(
            t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())


# ----------------------------------------------- the two packages' files
def _port_state(opt_name: str):
    """A smoke qwen2 (f32) with ``opt_name``'s state filled with random
    values, the step and the base key, as the train driver saves them."""
    model = build(smoke_config("qwen2-1.5b").with_(param_dtype="float32"))
    params = model.init(0, "cpu")
    opt = make_optimizer(opt_name, lambda s: 1e-3)
    state = opt.init(params)
    gen = torch.Generator().manual_seed(1)
    for v in flatten(state).values():
        v.copy_(torch.randn(v.shape, generator=gen))
    return {"params": params, "opt": state, "step": np.asarray(3),
            "rng": np.asarray(prng_key(1), np.uint32)}


@pytest.mark.parametrize("opt_name", ["sgd", "adamw"])
def test_reference_reads_the_ports_checkpoint(tmp_path, opt_name):
    """The JAX package's latest_step and restore (with the template its
    train driver passes) read what the port wrote: equal arrays, step and
    meta."""
    state = _port_state(opt_name)
    meta = {"run_state_version": 1, "ledger": {"recorded_to": 4}}
    ckpt.save(str(tmp_path), 3, state, meta=meta)
    assert rckpt.latest_step(str(tmp_path)) == 3
    jcfg = jsmoke("qwen2-1.5b").with_(dtype="float32", param_dtype="float32")
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    jopt = jmake_optimizer(opt_name, lambda s: 1e-3)
    template = {"params": jparams, "opt": jopt.init(jparams),
                "step": np.asarray(0), "rng": jax.random.PRNGKey(1)}
    got, step, got_meta = rckpt.restore(str(tmp_path), template=template)
    assert step == 3 and got_meta == meta
    _assert_same(flatten(state), jflatten(got))
    assert np.asarray(got["rng"]).tolist() == list(prng_key(1)) == \
        np.asarray(jax.random.PRNGKey(1)).tolist()


def _reference_state(param_dtype: str):
    jcfg = jsmoke("qwen2-1.5b").with_(dtype=param_dtype,
                                      param_dtype=param_dtype)
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    jopt = jmake_optimizer("adamw", lambda s: 1e-3)
    r = np.random.default_rng(2)
    jstate = jax.tree_util.tree_map(
        lambda v: r.standard_normal(v.shape).astype(np.float32),
        jopt.init(jparams))
    return {"params": jparams, "opt": jstate, "step": np.asarray(5),
            "rng": jax.random.PRNGKey(1)}


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_port_reads_the_references_checkpoint(tmp_path, param_dtype):
    """The port restores what the JAX package wrote, onto the template of
    its own model and optimizer, bitwise: bf16 leaves by the manifest's
    dtype (no ml_dtypes)."""
    jstate = _reference_state(param_dtype)
    rckpt.save(str(tmp_path), 5, jstate, meta={"k": [1, 2]})
    assert ckpt.latest_step(str(tmp_path)) == 5
    model = build(smoke_config("qwen2-1.5b").with_(param_dtype=param_dtype))
    params = model.init(0, "cpu")
    template = {"params": params,
                "opt": make_optimizer("adamw", lambda s: 1e-3).init(params),
                "step": np.asarray(0),
                "rng": np.asarray(prng_key(0), np.uint32)}
    got, step, meta = ckpt.restore(str(tmp_path), template=template,
                                   device="cpu")
    assert step == 5 and meta == {"k": [1, 2]}
    flat = flatten(got)
    want = {k: np.asarray(v) for k, v in jflatten(jstate).items()}
    _assert_same(flat, want)
    for k, t in flatten(template).items():
        want_dtype = t.dtype if isinstance(t, torch.Tensor) else \
            ckpt.DTYPES[str(t.dtype)]
        assert flat[k].dtype == want_dtype, k
    assert (flat["params/embed/w"].dtype == torch.bfloat16) == \
        (param_dtype == "bfloat16")


def test_bf16_members_and_manifest_equal_the_reference_writers(tmp_path):
    """For bf16 leaves (and f32, int64 and uint32 ones beside them), the
    port's npz members (the .npy header with descr '<V2', then the raw
    words) and its manifest equal the JAX package's for the same values;
    the port restores them bitwise."""
    r = np.random.default_rng(3)
    w = r.standard_normal((5, 7)).astype(ml_dtypes.bfloat16)
    b = r.standard_normal((7,)).astype(ml_dtypes.bfloat16)
    m = r.standard_normal((5, 7)).astype(np.float32)
    ref = {"params": {"w": w, "b": b}, "opt": {"m": m},
           "step": np.asarray(9), "rng": np.asarray([3, 4], np.uint32)}
    port = {"params": {"w": torch.from_numpy(w.view(np.int16)).view(
                           torch.bfloat16),
                       "b": torch.from_numpy(b.view(np.int16)).view(
                           torch.bfloat16)},
            "opt": {"m": torch.from_numpy(m)},
            "step": np.asarray(9), "rng": np.asarray([3, 4], np.uint32)}
    meta = {"ledger": {"recorded_to": 10}}
    pdir = ckpt.save(str(tmp_path / "port"), 9, port, meta=meta)
    rdir = rckpt.save(str(tmp_path / "ref"), 9, ref, meta=meta)
    manifests = [json.load(open(os.path.join(d, ckpt.MANIFEST)))
                 for d in (pdir, rdir)]
    assert manifests[0] == manifests[1]
    assert manifests[0]["arrays"]["params/w"]["dtype"] == "bfloat16"
    with zipfile.ZipFile(os.path.join(pdir, "shards.00000.npz")) as zp, \
            zipfile.ZipFile(os.path.join(rdir, "shards.00000.npz")) as zr:
        assert zp.namelist() == zr.namelist()
        for name in zr.namelist():
            assert zp.read(name) == zr.read(name), name
        assert b"'descr': '<V2'" in zp.read("params/w@0x0.npy")
    for d in (pdir, rdir):
        got, _, _ = ckpt.restore(os.path.dirname(d), device="cpu")
        assert got["params"]["w"].dtype == torch.bfloat16
        _assert_same(flatten(got), flatten(port))


def test_reference_restore_raises_on_bf16_and_the_ports_does_not(tmp_path):
    """A finding about the JAX package: its ``restore`` raises on a bf16
    leaf, its own checkpoint's or the port's (it assigns the ``<V2``
    member into an ml_dtypes bfloat16 array: "No cast function
    available"), so it cannot resume a bf16 model such as qwen2-1.5b at
    full width. The port restores both directories."""
    jstate = _reference_state("bfloat16")
    rckpt.save(str(tmp_path / "ref"), 5, jstate)
    model = build(smoke_config("qwen2-1.5b").with_(param_dtype="bfloat16"))
    ckpt.save(str(tmp_path / "port"), 5, {"params": model.init(0, "cpu")})
    for d in ("ref", "port"):
        with pytest.raises(ValueError, match="No cast function"):
            rckpt.restore(str(tmp_path / d))
        got, step, _ = ckpt.restore(str(tmp_path / d), device="cpu")
        assert step == 5
        assert got["params"]["embed"]["w"].dtype == torch.bfloat16


# ------------------------------------------- the five optimizers' state
def _opt_inputs():
    r = np.random.default_rng(4)
    params = {"a": {"w": torch.from_numpy(
                  r.standard_normal((8, 6)).astype(np.float32))},
              "blocks": {"w": torch.from_numpy(
                  r.standard_normal((2, 6, 4)).astype(np.float32)
              ).bfloat16()},
              "b": torch.from_numpy(r.standard_normal(6).astype(np.float32))}
    grads = [unflatten({k: torch.from_numpy(
        r.standard_normal(tuple(v.shape)).astype(np.float32)).to(v.dtype)
        for k, v in flatten(params).items()}) for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("opt_name", OPTIMIZERS)
def test_optimizer_state_roundtrip(tmp_path, opt_name):
    """Two steps, save, restore onto a fresh init's template (bitwise,
    the template's dtypes), then a third step from the original and from
    the restored state: bitwise equal (FTRL restarts at step 2)."""
    kw = {"momentum": 0.9, "restart_every": 2} if opt_name == "ftrl" else {}
    opt = make_optimizer(opt_name, lambda s: 1e-2, **kw)
    params, grads = _opt_inputs()
    state = opt.init(params)
    for step in range(2):
        params, state = opt.update(grads[step], state, params, step)
    ckpt.save(str(tmp_path), 1, {"params": params, "opt": state,
                                 "step": np.asarray(1)})
    fresh, _ = _opt_inputs()
    template = {"params": fresh, "opt": opt.init(fresh),
                "step": np.asarray(0)}
    got, step, _ = ckpt.restore(str(tmp_path), template=template, device="cpu")
    assert step == 1 and int(got["step"]) == 1
    want = flatten({"params": params, "opt": state})
    _assert_same(flatten({"params": got["params"], "opt": got["opt"]}), want)
    for k, t in flatten({"params": fresh, "opt": opt.init(fresh)}).items():
        assert flatten(got)[k].dtype == t.dtype, k
    params, state = opt.update(grads[2], state, params, 2)
    rparams, rstate = opt.update(grads[2], got["opt"], got["params"], 2)
    _assert_same(flatten({"p": rparams, "s": rstate}),
                 flatten({"p": params, "s": state}))
