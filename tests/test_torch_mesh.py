"""DP training over a mesh of processes on the CPU (gloo): spawned worlds of
4 and 2 processes, each running several checks in one spawn, against the
one-process runs and the JAX package's pieces.

- ``--mesh 2,2`` against world 1 (qwen2-1.5b smoke, f32, 3 AdamW steps):
  sigma 0 with the whole batch and with microbatch 4, and sigma 1: params
  within tests/test_sharded_step.py:80's rtol 1e-3, atol 1e-5, losses
  within 1e-4; ``--mesh 1,4`` and ``1,2`` (the model axis: storage only)
  bitwise world 1; a (pod, data, model) mesh (2,1,2) trains to world 1's
  params within the same tolerance.
- ``--mesh 2,2`` from the reference's initial params against the JAX
  package's no-mesh step composed by hand (``bk_clipped_sum``, then
  ``noise_leaf_fn``, then AdamW's ``update_leaves``) at the port's f32
  tolerance.
- Every rank's whole params (its replicated leaves its own) hash alike.
- B=6 on a 4-way data axis: padded to 8, the mask sums to 6, the padded
  batch shards where 6 does not, per-sample norms of shape (6,) within
  rtol 1e-4 of world 1, grads within the parity tolerance.
- A ``--mesh 2,2`` save (``--ckpt-every 1``): four process files, slices at
  nonzero offsets; restored in one process with the same params digest; a
  one-process resume continues the ledger.
- ``compressed_allreduce_mean``: the same bits on every rank, within one
  quantum of the true mean, unbiased over 200 draws.
- bf16 params on ``(2, 1)``: the clipped sums are the f32 partials summed,
  then rounded to bf16 once, as world 1 rounds its f32 sum.
- The dry-run's train cell (``launch.steps.plan_cell``) stepped on the
  (2, 2) world moves, on a rank, the collective bytes its plan on a
  planning mesh counts for that rank.
- A mesh whose size is not the world's raises, naming both; the backend is
  gloo wherever a host's ranks outnumber its cards.
"""
import json
import math
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.checkpoint.run_state import params_digest
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import build, smoke_config
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import (free_port, init_distributed,
                                     make_test_mesh)
from repro_torch.utils.tree import flatten, unflatten

B, T, STEPS = 8, 16, 3
PARITY = dict(rtol=1e-3, atol=1e-5)      # tests/test_sharded_step.py:80
F32_TOL = dict(rtol=1e-3, atol=1e-4)     # tests/test_kernel_parity.py:15
CFG = smoke_config("qwen2-1.5b").with_(param_dtype="float32")
RUNS = {"sigma0": ("--sigma", "0"),
        "sigma0_mb4": ("--sigma", "0", "--microbatch", "4"),
        "sigma1": ("--sigma", "1.0")}
ORACLE = dict(steps=2, lr=1e-2, sigma=0.7)


def _quiet(*a, **k):
    pass


def _run(*extra, mesh=None, steps=STEPS):
    """train() of the CLI's config (qwen2-1.5b smoke, f32, on the CPU) ->
    whole params, losses and the summary."""
    kwargs, _ = ttrain.cli_args(
        ["--smoke", "--device", "cpu", "--batch", str(B), "--seq", str(T),
         "--steps", str(steps), "--log-every", "100", *extra])
    summary = {}
    params, losses = ttrain.train(**kwargs, log=_quiet, summary_out=summary,
                                  mesh=mesh)
    return {"params": {k: v.clone() for k, v in flatten(params).items()},
            "losses": losses, "summary": summary}


def _oracle_run(flat0, mesh=None):
    """train() from the reference's initial params ``flat0`` (numpy), a
    constant lr, the registered policy at ORACLE's sigma."""
    from repro_torch.convert import params_from_jax
    model = build(CFG)
    model.init = lambda seed, dev: params_from_jax(flat0, dev)
    ttrain.build = lambda cfg: model
    tc = TrainConfig(global_batch=B, seq_len=T, steps=ORACLE["steps"],
                     lr=ORACLE["lr"], lr_schedule="constant",
                     optimizer="adamw")
    dp = ttrain.resolve_dp("qwen2-1.5b", "auto", "bk-mixopt", "automatic",
                           ORACLE["sigma"], log=_quiet)
    params, losses = ttrain.train(CFG, tc, dp, device="cpu", log=_quiet,
                                  mesh=mesh)
    return {"params": {k: v.clone() for k, v in flatten(params).items()},
            "losses": losses}


def _padded(out):
    """B=6 on a (4, 1) mesh: pad_batch and the private grad with the mesh
    against world 1 (sigma 0)."""
    from repro_torch.core.bk import (DPConfig, batch_shard, bk_private_grad,
                                     pad_batch)
    from repro_torch.data.pipeline import Pipeline, PipelineConfig
    mesh = make_test_mesh((4, 1))
    model = build(CFG)
    params = model.init(0, "cpu")
    batch = Pipeline(CFG, PipelineConfig(6, T, seed=0), "cpu").batch(0)
    _, mask, Bp = pad_batch(batch, mesh, 6)
    out["pad"] = {"B_pad": Bp, "mask": mask.clone(),
                  "shards": (batch_shard(mesh, 8) is not None,
                             batch_shard(mesh, 6) is not None)}
    dp = DPConfig(mode="bk-mixopt", sigma=0.0)
    for name, m in (("one", None), ("mesh", mesh)):
        g, aux = bk_private_grad(model.apply, params, batch, (0, 7), dp,
                                 mesh=m)
        out["pad"][name] = ({k: v.clone() for k, v in flatten(g).items()},
                            aux["per_sample_norms"].clone(),
                            float(aux["loss"]))


def _bf16_sums(out):
    """bf16 qwen2-1.5b smoke: bk_clipped_sum on (2, 1) and on world 1,
    the same params and batch."""
    from repro_torch.core.bk import DPConfig, bk_clipped_sum
    from repro_torch.data.pipeline import Pipeline, PipelineConfig
    cfg = smoke_config("qwen2-1.5b")
    model = build(cfg)
    params = model.init(0, "cpu")
    batch = Pipeline(cfg, PipelineConfig(B, T, seed=0), "cpu").batch(0)
    dp = DPConfig(mode="bk-mixopt", sigma=0.0)
    out["bf16"] = {name: {k: v.clone() for k, v in bk_clipped_sum(
        model.apply, params, batch, dp, mesh=m)[0].items()}
        for name, m in (("one", None), ("mesh", make_test_mesh((2, 1))))}


def _compression(out, rank, world):
    from repro_torch.runtime.compression import (
        compressed_allreduce_mean, compressed_tree_allreduce_mean)
    xs = [torch.randn(1000, generator=torch.Generator().manual_seed(r))
          for r in range(world)]
    gen = torch.Generator().manual_seed(100 + rank)
    got = compressed_allreduce_mean(xs[rank], gen)
    draws = torch.stack([compressed_allreduce_mean(xs[rank], gen)
                         for _ in range(200)]).mean(0)
    tree = compressed_tree_allreduce_mean({"a": {"b": xs[rank][:10]},
                                           "c": xs[rank][10:30]}, gen)
    seen = [None] * world
    dist.all_gather_object(seen, got.numpy().tobytes())
    out["compression"] = {"xs": xs, "got": got, "draws": draws,
                          "same_bits": len(set(seen)) == 1,
                          "tree": {k: v.shape for k, v in
                                   flatten(tree).items()}}


def _collectives(out, rank):
    """One step of the dry-run's train cell (``launch.steps.plan_cell``,
    qwen2-1.5b smoke, B=8, T=16, microbatch 4) on the (2, 2) world, its
    collectives' bytes counted as ``launch.mesh.PlanMesh`` counts them
    (the result's bytes a rank), beside the cell's plan on a planning mesh
    seen from the same rank."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_plan_mesh
    from repro_torch.launch.steps import plan_cell
    small = smoke_config("qwen2-1.5b")
    get_config, registry.get_config = registry.get_config, lambda n: small
    try:
        shape = ShapeConfig("train_4k", T, B, "train")
        mesh = make_test_mesh((2, 2))
        moved = {"all_reduce": 0, "all_gather": 0}
        all_reduce, all_gather = mesh.all_reduce, mesh.all_gather

        def count_reduce(t, axes):
            if mesh.axis_size(axes) > 1:
                moved["all_reduce"] += t.numel() * t.element_size()
            return all_reduce(t, axes)

        def count_gather(t, axes):
            n = mesh.axis_size(axes)
            if n > 1:
                moved["all_gather"] += n * t.numel() * t.element_size()
            return all_gather(t, axes)

        mesh.all_reduce, mesh.all_gather = count_reduce, count_gather
        cell = plan_cell("qwen2-1.5b", shape, mesh, microbatch=4)
        _, loss = cell.fn(*cell.make_args("cpu", 0))
        planned = plan_cell("qwen2-1.5b", shape,
                            make_plan_mesh((2, 2), rank=rank),
                            microbatch=4).plan()["collectives"]
    finally:
        registry.get_config = get_config
    out["collectives"] = {"moved": moved, "loss": float(loss),
                          "planned": {k: planned[k] for k in moved}}


def _world4(rank, port, tmp, flat0):
    torch.set_num_threads(1)
    init_distributed(rank, 4, f"tcp://localhost:{port}", "cpu")
    out = {}
    for name, extra in RUNS.items():
        out[name, None] = _run(*extra)          # world 1, on each rank
        out[name, (2, 2)] = _run(*extra, mesh=(2, 2))
    out["sigma1", (1, 4)] = _run(*RUNS["sigma1"], mesh=(1, 4))
    out["sigma1", (2, 1, 2)] = _run(*RUNS["sigma1"], mesh=(2, 1, 2))
    digests = [None] * 4
    dist.all_gather_object(digests, params_digest(
        unflatten(out["sigma1", (2, 2)]["params"])))
    out["digests"] = digests
    out["ckpt"] = _run("--sigma", "1.0", "--ckpt-dir",
                       os.path.join(tmp, "ck"), "--ckpt-every", "1",
                       mesh=(2, 2), steps=4)
    out["oracle"] = _oracle_run(flat0, mesh=(2, 2))
    _padded(out)
    _compression(out, rank, 4)
    _collectives(out, rank)
    if rank == 0:
        torch.save(out, os.path.join(tmp, "world4.pt"))
    dist.destroy_process_group()


def _world2(rank, port, tmp):
    torch.set_num_threads(1)
    init_distributed(rank, 2, f"tcp://localhost:{port}", "cpu")
    out = {"one": _run(*RUNS["sigma1"]),
           "model": _run(*RUNS["sigma1"], mesh=(1, 2))}
    _bf16_sums(out)
    if rank == 0:
        torch.save(out, os.path.join(tmp, "world2.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def jax_init():
    import jax

    from repro.configs.registry import build as jbuild
    from repro.configs.registry import smoke_config as jsmoke
    from repro.utils.tree import flatten as jflatten
    jcfg = jsmoke("qwen2-1.5b").with_(dtype="float32", param_dtype="float32")
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jcfg, jm, jp, {k: np.asarray(v) for k, v in jflatten(jp).items()}


@pytest.fixture(scope="module")
def world4(tmp_path_factory, jax_init):
    tmp = str(tmp_path_factory.mktemp("world4"))
    mp.spawn(_world4, args=(free_port(), tmp, jax_init[3]), nprocs=4,
             join=True)
    return tmp, torch.load(os.path.join(tmp, "world4.pt"),
                           weights_only=False)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("world2"))
    mp.spawn(_world2, args=(free_port(), tmp), nprocs=2, join=True)
    return torch.load(os.path.join(tmp, "world2.pt"), weights_only=False)


def _assert_params(got, want, **tol):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=k,
                                   **tol)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_mesh_2x2_matches_world_1(world4, run):
    out = world4[1]
    one, two = out[run, None], out[run, (2, 2)]
    _assert_params(two["params"], one["params"], **PARITY)
    assert np.abs(np.subtract(two["losses"], one["losses"])).max() < 1e-4
    assert two["summary"]["epsilon"] == one["summary"]["epsilon"]


def test_model_axis_is_bitwise_world_1(world4, world2):
    """Storage sharded over 'model', compute not: --mesh 1,4 and 1,2 end
    with world 1's params bitwise (sigma 1: the noise too)."""
    for one, got in ((world4[1]["sigma1", None], world4[1]["sigma1", (1, 4)]),
                     (world2["one"], world2["model"])):
        assert got["summary"]["params_sha256"] == \
            one["summary"]["params_sha256"]
        for k, v in one["params"].items():
            assert torch.equal(got["params"][k], v), k
        assert got["losses"] == one["losses"]


def test_bf16_sums_round_once_as_world_1(world2):
    """Each rank's bf16 weighted grads are f32 partials: summed over the
    data axis in f32 and rounded to bf16 once, they equal world 1's (its
    f32 sum rounded once) except where the two f32 sums, which differ only
    by f32 reassociation, straddle a bf16 rounding boundary: 99% of
    elements or more are equal (partials rounded to bf16 before a bf16 sum
    leave about 68% equal here), and every gap is within one bf16 ulp of
    the leaf's largest element (2^-7 of its magnitude)."""
    one, mesh = world2["bf16"]["one"], world2["bf16"]["mesh"]
    assert sorted(one) == sorted(mesh)
    n = same = 0
    for k, a in one.items():
        b = mesh[k]
        assert a.dtype == b.dtype == torch.bfloat16, k
        a, b = a.float(), b.float()
        top = max(float(a.abs().max()), float(b.abs().max()))
        assert float((a - b).abs().max()) <= top * 2.0 ** -7, k
        n += a.numel()
        same += int((a == b).sum())
    assert same >= 0.99 * n, (same, n)


def test_pod_mesh_trains(world4):
    out = world4[1]
    one, pod = out["sigma1", None], out["sigma1", (2, 1, 2)]
    _assert_params(pod["params"], one["params"], **PARITY)
    assert all(math.isfinite(x) for x in pod["losses"])


def test_every_rank_holds_the_same_params(world4):
    """The whole params each rank returns (its own replicated leaves, the
    gathered sharded ones) hash alike on all four ranks."""
    digests = world4[1]["digests"]
    assert len(set(digests)) == 1
    assert digests[0] == world4[1]["sigma1", (2, 2)]["summary"][
        "params_sha256"]


def test_mesh_2x2_matches_the_reference_step(world4, jax_init):
    """The (2, 2) run from the reference's initial params against the JAX
    package's no-mesh pieces: bk_clipped_sum, then noise_leaf_fn (the same
    counter-based noise), then AdamW's update_leaves."""
    import jax
    import jax.numpy as jnp

    from repro.configs.registry import get_policy as jget_policy
    from repro.core.bk import bk_clipped_sum as jbk_clipped_sum
    from repro.core.policy import noise_leaf_fn as jnoise_leaf_fn
    from repro.core.policy import resolve_policy as jresolve_policy
    from repro.data.pipeline import Pipeline as JPipeline
    from repro.data.pipeline import PipelineConfig as JPipelineConfig
    from repro.optim.optimizers import make_optimizer as jmake_optimizer
    from repro.utils.tree import flatten as jflatten
    jcfg, jm, jp, _ = jax_init
    jpol = jget_policy("qwen2-1.5b", mode="bk-mixopt", sigma=ORACLE["sigma"],
                       use_kernels=False)
    jres = jresolve_policy(jpol, jflatten(jp))
    jopt = jmake_optimizer("adamw", lambda s: ORACLE["lr"])
    jstate = jopt.init(jp)
    pipe = JPipeline(jcfg, JPipelineConfig(B, T, seed=0))
    base = jax.random.PRNGKey(1)
    sums_fn = jax.jit(lambda p, b: jbk_clipped_sum(jm.apply, p, b, jpol))

    @jax.jit
    def update(p, st, sums, step):
        leaf = jnoise_leaf_fn(jpol, jres, jax.random.fold_in(base, step),
                              float(B), step=step)
        return jopt.update_leaves(lambda path, x: leaf(path, sums[path]),
                                  st, p, step)

    losses = []
    for step in range(ORACLE["steps"]):
        sums, aux = sums_fn(jp, pipe.batch(step))
        losses.append(float(aux["loss"]))
        jp, jstate = update(jp, jstate, sums, jnp.int32(step))
    got = world4[1]["oracle"]
    np.testing.assert_allclose(got["losses"], losses, **F32_TOL)
    for k, v in jflatten(jp).items():
        np.testing.assert_allclose(got["params"][k].numpy(), np.asarray(v),
                                   err_msg=k, **F32_TOL)


def test_padded_batch_on_a_4_way_data_axis(world4):
    pad = world4[1]["pad"]
    assert pad["B_pad"] == 8 and tuple(pad["mask"].shape) == (8,)
    assert float(pad["mask"].sum()) == 6.0
    assert pad["shards"] == (True, False)
    (g1, n1, l1), (g4, n4, l4) = pad["one"], pad["mesh"]
    assert tuple(n4.shape) == (6,)
    np.testing.assert_allclose(n4.numpy(), n1.numpy(), rtol=1e-4, atol=1e-6)
    assert abs(l4 - l1) < 1e-4
    _assert_params(g4, g1, **PARITY)


def test_mesh_checkpoint_restores_in_one_process(world4, tmp_path):
    """A (2, 2) save holds four process files and slices at nonzero
    offsets; one process restores the same params digest, and resumes the
    run at its next step, continuing the ledger."""
    tmp, out = world4
    root = os.path.join(tmp, "ck")
    saved = out["ckpt"]["summary"]
    assert ckpt.latest_step(root) == 3
    with open(os.path.join(root, "step_0000000003", ckpt.MANIFEST)) as f:
        manifest = json.load(f)
    assert manifest["process_count"] == 4
    assert sorted(manifest["files"]) == [f"shards.{i:05d}.npz"
                                         for i in range(4)]
    entries = [e for fi in manifest["files"].values()
               for e in fi["entries"].values()]
    assert any(any(o > 0 for o in e["offset"]) for e in entries)
    state, step, meta = ckpt.restore(root, device="cpu")
    assert step == 3
    assert params_digest(state["params"]) == saved["params_sha256"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        resumed = _run("--sigma", "1.0", "--ckpt-dir", root, steps=6)
    finally:
        torch.set_num_threads(threads)
    s = resumed["summary"]
    assert (s["resumed_from"], s["steps_done"]) == (4, 6)
    assert s["epsilon"] > saved["epsilon"]


def test_planned_collectives_equal_the_sharded_step(world4):
    got = world4[1]["collectives"]
    assert got["moved"]["all_reduce"] > 0 and got["moved"]["all_gather"] > 0
    assert got["planned"] == got["moved"]
    assert math.isfinite(got["loss"])


def test_compressed_allreduce_mean(world4):
    c = world4[1]["compression"]
    xs, got = c["xs"], c["got"]
    true = torch.stack(xs).double().mean(0)
    quantum = max(float(x.abs().max()) / 127.0 for x in xs)
    assert c["same_bits"]
    assert float((got.double() - true).abs().max()) <= quantum
    assert float((c["draws"].double() - true).abs().max()) <= 0.15 * quantum
    assert c["tree"] == {"a/b": (10,), "c": (20,)}


@pytest.mark.parametrize("device,local_world,cards,want", [
    ("cpu", 1, 0, "gloo"), ("cpu", 4, 4, "gloo"), ("cuda", 1, 1, "nccl"),
    ("cuda", 4, 4, "nccl"), ("cuda", 2, 1, "gloo")])
def test_backend_follows_the_ranks_and_cards(device, local_world, cards,
                                             want):
    from repro_torch.launch.mesh import pick_backend
    assert pick_backend(device, local_world, cards) == want


def test_a_mesh_not_the_worlds_size_raises():
    with pytest.raises(ValueError, match="--mesh 2,2 has 4 places; the "
                                         "world has 1 processes"):
        _run("--sigma", "0", mesh=(2, 2), steps=1)
    assert not dist.is_initialized()
    kwargs, _ = ttrain.cli_args(["--smoke", "--device", "cpu", "--mesh",
                                 "2,1,2"])
    assert kwargs["mesh"] == (2, 1, 2)
    from repro_torch.launch.mesh import make_train_mesh
    with pytest.raises(ValueError, match="needs 2 processes; the world "
                                         "has 1"):
        make_train_mesh(2, 1)
