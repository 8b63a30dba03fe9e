"""The dry-run grid of the port (``launch.steps.plan_cell``,
``launch.dryrun``) against the JAX package's (``repro.launch.steps``,
``repro.launch.dryrun``), on the CPU, at smoke configs.

- ``SHAPES``, ``TRAIN_MICROBATCH``, ``TRAIN_OPTIMIZER``, ``SUBQUADRATIC``,
  ``skip_reason`` for every (arch x shape) and ``batch_spec`` (shapes and
  dtypes, every family) equal the reference's.
- For the six family representatives of ``tests/test_dryrun_small.py``:
  the planned train cell's state at rest on a rank of the planning meshes
  (2, 2) and (2, 2, 2) holds, byte for byte, the reference's per-device
  shards of its params and optimizer state (``repro.launch.sharding.
  state_pspecs`` + ``sanitize`` on a ``jax.sharding.AbstractMesh`` of the
  same shape: no devices, no compile); its batch is the global batch,
  which every rank of the port holds (the reference shards it), so
  ``argument_bytes`` is those shards plus the global batch's bytes.
- Each of the fourteen kernel wrappers on meta tensors: the shapes and
  dtypes of its plain version's outputs on the CPU, one launch recorded
  (and none counted in the wrapper's own count).
- long_500k skips full attention; llama3-405b's train_4k is recorded as
  ``unported`` (Adafactor over a sharded leaf, ROADMAP B7b).
- The CLI writes a record with the reference's keys.

(The planned collective bytes against the sharded step's: in
``tests/test_torch_mesh.py``'s world of 4.)
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import SHAPES as JSHAPES
from repro.data.synthetic import batch_spec as jbatch_spec
from repro.launch import sharding as jsh
from repro.launch import steps as jsteps
from repro.utils.tree import flatten as jflatten
from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.data.synthetic import batch_spec
from repro_torch.kernels import meta
from repro_torch.launch import dryrun
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_plan_mesh

FAMILY_REPS = ["qwen3-14b", "deepseek-moe-16b", "rwkv6-3b", "hymba-1.5b",
               "whisper-small", "internvl2-26b"]
SMALL_TRAIN = ShapeConfig("train_4k", 16, 8, "train")
MESHES = {(2, 2): ("data", "model"), (2, 2, 2): ("pod", "data", "model")}


def test_grid_tables_equal_the_reference():
    assert {k: (v.name, v.seq_len, v.global_batch, v.kind)
            for k, v in SHAPES.items()} == \
        {k: (v.name, v.seq_len, v.global_batch, v.kind)
         for k, v in JSHAPES.items()}
    assert steps.TRAIN_MICROBATCH == jsteps.TRAIN_MICROBATCH
    assert steps.TRAIN_OPTIMIZER == jsteps.TRAIN_OPTIMIZER
    assert steps.SUBQUADRATIC == jsteps.SUBQUADRATIC
    assert registry.list_archs() == jreg.list_archs()
    for arch in registry.list_archs():
        for name in SHAPES:
            assert steps.skip_reason(registry.get_config(arch),
                                     SHAPES[name]) == \
                jsteps.skip_reason(jreg.get_config(arch), JSHAPES[name])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILY_REPS)
def test_batch_spec_equals_the_reference(arch, dtype):
    got = batch_spec(registry.smoke_config(arch), 4, 24, dtype)
    want = jbatch_spec(jreg.smoke_config(arch), 4, 24, dtype)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert v.device.type == "meta"
        assert tuple(v.shape) == tuple(want[k].shape), k
        assert str(v.dtype).replace("torch.", "") == str(want[k].dtype), k


def _smoke(monkeypatch, arch):
    """plan_cell's config -> the arch's smoke config (as
    tests/test_dryrun_small.py shrinks the reference's)."""
    small = registry.smoke_config(arch).with_(name=arch, remat=False,
                                              attn_chunk=0)
    monkeypatch.setattr(registry, "get_config", lambda n: small)
    return small


def _reference_shard_bytes(arch, shape, axes) -> tuple:
    """-> (state bytes on one device, global batch bytes): the reference's
    per-device shards of its train state (params + AdamW m, v) at its
    smoke config, by its own specs on an abstract mesh."""
    from jax.sharding import AbstractMesh
    mesh = AbstractMesh(shape, axes)
    cfg = jreg.smoke_config(arch).with_(name=arch, remat=False, attn_chunk=0)
    model = jreg.build(cfg)
    params = jax.eval_shape(model.init, jax.ShapeDtypeStruct((2,),
                                                             jax.numpy.uint32))
    opt_name = jsteps.TRAIN_OPTIMIZER.get(arch, "adamw")
    from repro.optim.optimizers import make_optimizer
    opt = make_optimizer(opt_name, lambda s: 1e-4)
    ostate = jax.eval_shape(opt.init, params)
    specs = jsh.state_pspecs(opt_name, params, mesh)
    total = 0
    for tree, spec_tree in ((params, specs.params),
                            (ostate, specs.opt_state)):
        leaves, fs = jflatten(tree), jflatten(spec_tree)
        for path, leaf in leaves.items():
            spec = jsh.sanitize(fs[path], leaf.shape, mesh)
            shard = [dim // jsh._axis_size(mesh, a)
                     for dim, a in zip(leaf.shape, tuple(spec)
                                       + (None,) * len(leaf.shape))]
            total += int(np.prod(shard)) * leaf.dtype.itemsize
    batch = jbatch_spec(cfg, SMALL_TRAIN.global_batch, SMALL_TRAIN.seq_len,
                        "float32")
    bbytes = sum(int(np.prod(v.shape)) * v.dtype.itemsize
                 for v in batch.values())
    return total, bbytes


@pytest.mark.parametrize("shape", list(MESHES), ids=lambda s: "x".join(
    map(str, s)))
@pytest.mark.parametrize("arch", FAMILY_REPS)
def test_argument_bytes_are_the_reference_shards(monkeypatch, arch, shape):
    _smoke(monkeypatch, arch)
    axes = MESHES[shape]
    want_state, want_batch = _reference_shard_bytes(arch, shape, axes)
    last = 1
    for s in shape:
        last *= s
    for rank in (0, last - 1):
        mesh = make_plan_mesh(shape, rank=rank)
        plan = steps.plan_cell(arch, SMALL_TRAIN, mesh, microbatch=4)
        state, batch = plan.args
        got_state = sum(steps._storages(state).values())
        got_batch = sum(steps._storages(batch).values())
        assert got_state == want_state, (rank, got_state, want_state)
        assert got_batch == want_batch
    rec = plan.plan()
    assert rec["memory"]["argument_bytes"] == want_state + want_batch
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"]
    assert rec["collectives"]["total"] > 0
    assert rec["cost"]["flops"] > 0 and rec["kernels"]["launches"]


def _wrapper_cases():
    from repro_torch.kernels.clipped_grad import clipped_grad
    from repro_torch.kernels.counter_noise import counter_noise
    from repro_torch.kernels.emb_grad import emb_clipped_grad
    from repro_torch.kernels.emb_norm import emb_ghost_norm
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.fused_clip import fused_clip_grad
    from repro_torch.kernels.ghost_norm import ghost_norm
    from repro_torch.kernels.grad_norm_direct import grad_norm_direct
    from repro_torch.kernels.moe_ghost import (moe_clipped_grad,
                                               moe_direct_norm,
                                               moe_ghost_norm)
    from repro_torch.kernels.noise_update import AdamW, noise_update
    from repro_torch.kernels.wkv6 import chunk_states, wkv6, wkv6_backward
    rng = np.random.default_rng(0)

    def R(*s, dt=torch.float32):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                                ).to(dt)

    L, B, T, d, p, E, C = 2, 3, 16, 24, 40, 4, 5
    bf = torch.bfloat16
    a, ds, c = R(L, B, T, d, dt=bf), R(L, B, T, p, dt=bf), R(B)
    ids = torch.from_numpy(rng.integers(0, 50, (B, T)).astype(np.int32))
    ma, md = R(L, B, E, C, d, dt=bf), R(L, B, E, C, p, dt=bf)
    mm = torch.ones(L, B, E, C)
    r, k, v = (R(2, 70, 2, 16) for _ in range(3))
    w, u = torch.sigmoid(R(2, 70, 2, 16)), R(2, 16)
    hp = AdamW(lr=1e-3, b1=0.9, b2=0.99, eps=1e-8, bc1=0.1, bc2=0.01)

    def update(g, p_, m, v_):
        noise_update(g, p_, m, v_, hp)
        return p_, m, v_

    return {
        "ghost_norm": (ghost_norm, (a, ds)),
        "clipped_grad": (clipped_grad, (a, c, ds)),
        "grad_norm_direct": (grad_norm_direct, (a, ds)),
        "emb_ghost_norm": (emb_ghost_norm, (ids, R(B, T, d))),
        "emb_clipped_grad": (emb_clipped_grad, (ids, c, R(B, T, d), 50)),
        "moe_ghost_norm": (moe_ghost_norm, (ma, mm, md)),
        "moe_direct_norm": (moe_direct_norm, (ma, mm, md)),
        "moe_clipped_grad": (moe_clipped_grad, (ma, mm, c, md)),
        "fused_clip_grad": (fused_clip_grad, (a, ds, torch.ones(B),
                                              "automatic", 1.0, 0.01)),
        "flash_attention": (flash_attention, (R(2, 16, 4, 64, dt=bf),
                                              R(2, 16, 2, 64, dt=bf),
                                              R(2, 16, 2, 64, dt=bf))),
        "wkv6": (wkv6, (r, k, v, w, u)),
        "wkv6_backward": (wkv6_backward, (R(2, 70, 2, 16), r, k, v, w, u,
                                          chunk_states(k, v, w))),
        "counter_noise": (counter_noise, (R(33, 7), [(1, 2)], [], 1.0, 4.0)),
        "noise_update": (update, (R(10, 3), R(10, 3), torch.zeros(10, 3),
                                  torch.zeros(10, 3))),
    }


WRAPPERS = ("ghost_norm", "clipped_grad", "grad_norm_direct",
            "emb_ghost_norm", "emb_clipped_grad", "moe_ghost_norm",
            "moe_direct_norm", "moe_clipped_grad", "fused_clip_grad",
            "flash_attention", "wkv6", "wkv6_backward", "counter_noise",
            "noise_update")


def _structs(out):
    if isinstance(out, (tuple, list)):
        return [_structs(x) for x in out]
    return (tuple(out.shape), out.dtype)


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_meta_outputs_are_the_plain_versions(name):
    fn, args = _wrapper_cases()[name]
    want = fn(*args)
    to_meta = [torch.empty(x.shape, dtype=x.dtype, device="meta")
               if isinstance(x, torch.Tensor) else x for x in args]
    counts = {n: getattr(f, "launches") for n, f in
              ((n, _wrapper_cases()[n][0]) for n in WRAPPERS)
              if hasattr(f, "launches")}
    with meta.recording() as rec:
        got = fn(*to_meta)
    assert _structs(got) == _structs(want)
    assert all(t.device.type == "meta" for t in
               (got if isinstance(got, (tuple, list)) else [got]))
    assert dict(rec.launches) == {name: 1}
    assert rec.flops > 0
    for n, f in ((n, _wrapper_cases()[n][0]) for n in WRAPPERS):
        if n in counts:
            assert f.launches == counts[n], n


def test_meta_sizes_follow_the_c_rules():
    lib = meta.LIB
    # ghost_norm: the lower triangle of 64-row tiles (ghost_norm.cu)
    assert lib.dp_ghost_norm_nparts(4096) == 64 * 65 // 2
    # clipped_grad's SIMT split: 2 SMs' worth of CTAs, rows >= 512 a part
    assert lib.dp_clipped_grad_split(1, 2, 4096, 128, 128) == 16
    assert lib.dp_clipped_grad_split(28, 8, 512, 1536, 1536) == 1
    # the wgmma ghost norm's p split minimises rounds x k-steps
    assert lib.dp_ghost_norm_wgmma_split(1, 8, 512, 1536, 151936) >= 1
    assert lib.dp_wkv6_chunked_nparts(4096, 64) == 64
    assert lib.dp_wkv6_chunked_nparts(4096, 128) == 128
    # fused_clip_grad's plans as the card gave them (one H100 SXM)
    assert meta.fused_plan(4, 8, 512, 256, 256, True)["grid"] == 64
    assert meta.fused_plan(1, 2, 64, 64, 64, True)["nb"] == 2
    # the SIMT walk at tile 64 holds one CTA a SM (its shared memory)
    assert meta.fused_plan(28, 8, 512, 1536, 1536, False) == dict(
        tile=64, nb=8, split=1, grid=132, walk=1)


def test_long_500k_skips_and_llama3_train_is_unported(tmp_path):
    mesh = make_plan_mesh((16, 16))
    with pytest.raises(LookupError, match="full-attention"):
        steps.plan_cell("qwen2-1.5b", "long_500k", mesh)
    rec = dryrun.run_cell("llama3-405b", "train_4k", False, str(tmp_path),
                          force=True)
    assert rec["status"] == "unported"
    assert "adafactor" in rec["error"] and "ROADMAP B7b" in rec["error"]
    skip = dryrun.run_cell("qwen3-14b", "long_500k", True, str(tmp_path))
    assert skip["status"] == "skip" and skip["mesh"] == "2x16x16"


def test_cli_writes_a_record(monkeypatch, tmp_path, capsys):
    _smoke(monkeypatch, "qwen2-1.5b")
    monkeypatch.setattr(dryrun, "OUT_ROOT", str(tmp_path))
    assert dryrun.main(["--arch", "qwen2-1.5b", "--shape",
                        "decode_32k"]) == 0
    out = capsys.readouterr().out
    assert "[ok] qwen2-1.5b" in out and "done: 1 ok" in out
    rec = json.loads((tmp_path / "singlepod_16x16" /
                      "qwen2-1.5b__decode_32k.json").read_text())
    for key in ("arch", "shape", "mesh", "dp_mode", "status", "memory",
                "cost", "collectives", "note", "kind", "plan_s", "kernels"):
        assert key in rec, key
    assert rec["status"] == "ok" and rec["kind"] == "decode"
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "peak_bytes"}
    assert rec["collectives"]["total"] == 0    # whole params a rank
    assert "ROADMAP B7b" in rec["note"]


@pytest.mark.parametrize("arch,shape", [
    ("qwen2-1.5b", SMALL_TRAIN),
    ("hymba-1.5b", ShapeConfig("long_500k", 64, 1, "decode")),
    ("whisper-small", ShapeConfig("decode_32k", 32, 4, "decode")),
    ("internvl2-26b", ShapeConfig("prefill_32k", 16, 2, "prefill"))])
def test_the_planned_fn_runs_on_real_tensors(monkeypatch, arch, shape):
    """The plan's step is the step: its operands built on the CPU hold the
    planned argument_bytes, and ``fn`` runs on them."""
    _smoke(monkeypatch, arch)
    plan = steps.plan_cell(arch, shape, make_plan_mesh((1, 1)),
                           microbatch=4)
    planned = plan.plan()
    args = plan.make_args("cpu", 0)
    assert sum(steps._storages(args).values()) == \
        planned["memory"]["argument_bytes"]
    out = plan.fn(*args)
    loss_or_logits = out[1] if plan.kind == "train" else \
        out[0] if plan.kind == "decode" else out
    assert bool(torch.isfinite(loss_or_logits).all())
