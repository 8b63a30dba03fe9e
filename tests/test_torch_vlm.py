"""The port's vlm family (internvl2-26b: the transformer with a tapped
patch projector and a patch prefix) against the JAX package at smoke size
(2 layers, d 32, 4 heads x 8, 4 patches of width 16), f32: the registry
(ten archs, as the reference's), ``make_batch`` bitwise (patches and
tokens), the params through ``convert``, per-sample losses, the taps and
records, bk-mixopt's norms and clipped sums (the projector's bias on the
psp route) against the reference's, the port's opacus and BK modes
against the reference's opacus, ``prefill`` with patches and the dense
decode, a vlm ``Pipeline`` batch with its Poisson mask, the train CLI, and
``--mesh 2,1`` under gloo against one process."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.configs.registry import build as jbuild
from repro.configs.registry import get_config as jget
from repro.configs.registry import list_archs as jlist_archs
from repro.configs.registry import smoke_config as jsmoke
from repro.core.bk import DPConfig as JDPConfig
from repro.core.bk import bk_clipped_sum as jbk_clipped_sum
from repro.core.bk import tap_act_structs as jtap_act_structs
from repro.core.engine import make_grad_fn as jmake_grad_fn
from repro.core.tape import Tape as JTape
from repro.data.pipeline import Pipeline as JPipeline
from repro.data.pipeline import PipelineConfig as JPipelineConfig
from repro.data.synthetic import make_batch as jmake_batch
from repro.utils.tree import flatten as jflatten
from repro_torch.configs.registry import (build, cut_depth, get_config,
                                          list_archs, smoke_config)
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core.bk import (DPConfig, bk_clipped_sum, plan_report,
                                 tap_act_structs)
from repro_torch.core.engine import make_grad_fn
from repro_torch.core.noise import prng_key
from repro_torch.core.tape import Tape
from repro_torch.data.pipeline import Pipeline, PipelineConfig
from repro_torch.data.synthetic import make_batch
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import free_port, init_distributed
from repro_torch.models.transformer import TransformerLM
from repro_torch.utils.tree import flatten

ARCH, B, T = "internvl2-26b", 3, 16
TOL = dict(rtol=1e-3, atol=1e-4)           # tests/test_kernel_parity.py:15
PARITY = dict(rtol=1e-3, atol=1e-5)        # tests/test_sharded_step.py:80


class Ref:
    """The reference's smoke model (f32), params, a batch and its jitted
    entry points, built once for the module."""

    def __init__(self):
        self.cfg = jsmoke(ARCH).with_(dtype="float32", param_dtype="float32")
        self.model = jbuild(self.cfg)
        self.params = self.model.init(jax.random.PRNGKey(0))
        self.batch = jmake_batch(self.cfg, B, T, seed=0, step=0)
        m = self.model
        self.apply = jax.jit(lambda p, b: m.apply(p, b, JTape(None)))
        self.prefill = jax.jit(m.prefill)
        self.decode = jax.jit(m.decode_step)
        self.bk = jax.jit(lambda p, b: jbk_clipped_sum(
            m.apply, p, b, JDPConfig(mode="bk-mixopt", use_kernels=False)))

    def port(self):
        """The port's model, the reference's params and batch."""
        tm = build(smoke_config(ARCH).with_(param_dtype="float32"))
        flat = {k: np.asarray(v) for k, v in jflatten(self.params).items()}
        batch = {k: torch.from_numpy(np.array(v))
                 for k, v in self.batch.items()}
        return tm, params_from_jax(flat, "cpu"), batch


@pytest.fixture(scope="module")
def ref():
    return Ref()


def test_registry_builds_internvl2_with_the_reference_fields():
    """internvl2-26b builds a TransformerLM; its fields and its smoke
    reduction (4 patches of width 16) are the reference's; the port lists
    the reference's ten archs."""
    assert list_archs() == jlist_archs() and len(list_archs()) == 10
    assert isinstance(build(get_config(ARCH)), TransformerLM)
    fields = ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "head_dim", "d_ff", "vocab", "patch_tokens", "vit_dim",
              "rope_theta", "norm", "act", "param_dtype", "remat",
              "attn_chunk")
    for j, t in ((jget(ARCH), get_config(ARCH)),
                 (jsmoke(ARCH), smoke_config(ARCH))):
        for f in fields:
            assert getattr(t, f) == getattr(j, f), f
    assert (smoke_config(ARCH).patch_tokens, smoke_config(ARCH).vit_dim) \
        == (4, 16)
    cut = cut_depth(get_config(ARCH), 6)
    assert (cut.n_layers, cut.d_model, cut.patch_tokens) == (6, 6144, 1024)


@pytest.mark.parametrize("seed,step,T_", [(0, 0, 16), (1, 3, 32),
                                          (7, 11, 9), (2, 1, 512)])
def test_make_batch_matches_jax_bitwise(seed, step, T_):
    """Patches (B, patch_tokens, vit_dim) f32 from the first key, tokens
    (B, T) from the second (the reference walks its inputs sorted), both
    bitwise; the tokens are not a dense batch's at the same seed."""
    want = jmake_batch(jsmoke(ARCH), B, T_, seed, step)
    got = make_batch(smoke_config(ARCH), B, T_, seed, step, "cpu")
    assert sorted(got) == ["patches", "tokens"]
    assert got["patches"].dtype == torch.float32
    assert got["tokens"].dtype == torch.int32
    assert tuple(got["patches"].shape) == (B, 4, 16)
    for k in ("patches", "tokens"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    dense = make_batch(smoke_config("qwen2-1.5b"), B, T_, seed, step, "cpu")
    assert not torch.equal(dense["tokens"], got["tokens"])


def test_patches_bitwise_at_full_width():
    """internvl2's full patch shape (1024 x 3200) for one sample."""
    want = jmake_batch(jget(ARCH).with_(n_layers=1), 1, 4, 5, 2)
    got = make_batch(get_config(ARCH), 1, 4, 5, 2, "cpu")
    np.testing.assert_array_equal(got["patches"].numpy(),
                                  np.asarray(want["patches"]))


def test_params_round_trip_the_reference_keys(ref):
    """The port's init has the reference's flat keys, shapes and dtypes
    (``projector/w`` (vit_dim, d), ``projector/b`` (d,)); the reference's
    params go to the port and come back bitwise."""
    want = {k: (np.asarray(v).shape, str(np.asarray(v).dtype))
            for k, v in jflatten(ref.params).items()}
    tm, tp, _ = ref.port()
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in flatten(tm.init(0, "cpu")).items()}
    assert got == want
    assert want["projector/w"][0] == (16, 32)
    assert want["projector/b"][0] == (32,)
    back = params_to_numpy(tp)
    for k, v in jflatten(ref.params).items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)


def test_losses_taps_and_records_match_jax(ref):
    """Per-sample losses; the taps and records of ``tap_act_structs``: the
    projector's record is the patches (B, Np, vit_dim), and the head's
    covers every position, the patches' too (T + Np), as the reference's."""
    tm, tp, batch = ref.port()
    want = np.asarray(ref.apply(ref.params, ref.batch))
    got = tm.apply(tp, batch, Tape.null())
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    jtaps, jacts = jtap_act_structs(ref.model.apply, ref.params, ref.batch)
    taps, acts = tap_act_structs(tm.apply, tp, batch)
    norm = lambda d: {k: (tuple(v.shape), str(v.dtype)) for k, v in d.items()}
    tnorm = lambda d: {k: (tuple(s), str(dt).replace("torch.", ""))
                       for k, (s, dt) in d.items()}
    assert tnorm(taps) == norm(jtaps) and tnorm(acts) == norm(jacts)
    assert tnorm(acts)["projector#mm"][0] == (B, 4, 16)
    assert tnorm(acts)["head#mm"][0] == (B, 4 + T, 32)


def test_bk_clipped_sum_matches_jax(ref):
    """bk-mixopt's loss, per-sample norms and clipped sums (projector/w
    through its tap, projector/b on the psp route) against the
    reference's."""
    tm, tp, batch = ref.port()
    want, waux = ref.bk(ref.params, ref.batch)
    got, aux = bk_clipped_sum(tm.apply, tp, batch, DPConfig(mode="bk-mixopt"))
    for k in ("loss", "per_sample_norms"):
        np.testing.assert_allclose(aux[k].numpy(), np.asarray(waux[k]),
                                   err_msg=k, **TOL)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), err_msg=k,
                                   **TOL)
    assert float(got["projector/b"].abs().max()) > 0
    rep = plan_report(tm.apply, tp, batch, DPConfig(mode="bk-mixopt"))
    assert "projector#mm" in rep and "projector/b" not in rep


@pytest.fixture(scope="module")
def jopacus(ref):
    """The reference's opacus grads and per-sample norms, sigma 0."""
    grads, aux = jax.jit(lambda p, b: jmake_grad_fn(
        ref.model.apply, JDPConfig(mode="opacus", use_kernels=False))(
            p, b, jax.random.PRNGKey(3)))(ref.params, ref.batch)
    return ({k: np.asarray(v) for k, v in jflatten(grads).items()},
            np.asarray(aux["per_sample_norms"]))


@pytest.mark.parametrize("mode", ["opacus", "bk-mixopt", "bk",
                                  "bk-mixghost"])
def test_grads_match_the_references_opacus(ref, jopacus, mode):
    """The port's opacus (vmap(grad) over the patches and tokens) and each
    BK mode: per-sample norms and grads against the reference's opacus at
    f32 TOL, sigma 0."""
    tm, tp, batch = ref.port()
    got, aux = make_grad_fn(tm.apply, DPConfig(mode=mode))(tp, batch,
                                                           prng_key(3))
    want, want_norms = jopacus
    np.testing.assert_allclose(aux["per_sample_norms"].numpy(), want_norms,
                               **TOL)
    got = flatten(got)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w, err_msg=k, **TOL)


def test_projector_bias_takes_a_per_sample_row(ref):
    """On the psp route the bias arrives as (B, d): each sample's patch rows
    shifted by its own row (``L.align``), the same losses as a shared
    bias where the rows agree."""
    tm, tp, batch = ref.port()
    b = tp["projector"]["b"]
    per = dict(tp, projector=dict(tp["projector"],
                                  b=b.expand(B, *b.shape).clone()))
    np.testing.assert_allclose(tm.apply(per, batch, Tape.null()).numpy(),
                               tm.apply(tp, batch, Tape.null()).numpy(),
                               rtol=1e-6, atol=1e-6)
    per["projector"]["b"][1] += 1.0
    moved = tm.apply(per, batch, Tape.null())
    same = tm.apply(tp, batch, Tape.null())
    assert float((moved[1] - same[1]).abs()) > 1e-4
    torch.testing.assert_close(moved[[0, 2]], same[[0, 2]])


def test_prefill_with_patches_and_decode_match_jax(ref):
    """The prefill's last logits with patches (the trunk over Np + T
    positions) and without; then the dense decode chain (no patches, as the
    reference's ``generate``) step by step."""
    tm, tp, batch = ref.port()
    toks, patches = ref.batch["tokens"], ref.batch["patches"]
    want = np.asarray(ref.prefill(ref.params, toks, patches))
    got = tm.prefill(tp, batch["tokens"], batch["patches"])
    assert tuple(got.shape) == (B, 64)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        tm.prefill(tp, batch["tokens"]).numpy(),
        np.asarray(ref.prefill(ref.params, toks)), **TOL)
    assert not np.allclose(want, np.asarray(ref.prefill(ref.params, toks)))
    jc, tc = ref.model.init_cache(B, 8), tm.init_cache(B, 8, device="cpu")
    for i in range(8):
        j, jc = ref.decode(ref.params, jc, toks[:, i],
                           jnp.asarray(i, jnp.int32))
        t, tc = tm.decode_step(tp, tc, batch["tokens"][:, i], i)
        np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                   err_msg=f"step {i}", **TOL)


def test_pipeline_spec_and_poisson_mask_match_jax():
    """The spec grows the patches; the Poisson mask covers the tokens only
    (B, T), bitwise the reference's, as are the patches and tokens."""
    jp = JPipeline(jsmoke(ARCH), JPipelineConfig(4, 12, seed=3,
                                                 poisson_q=0.5))
    tp = Pipeline(smoke_config(ARCH), PipelineConfig(4, 12, seed=3,
                                                     poisson_q=0.5), "cpu")
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in jp.spec().items()}
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in tp.spec().items()}
    assert got == want
    assert got["patches"] == ((4, 4, 16), "float32")
    for step in (0, 1, 2):
        jb, tb = jp.batch(step), tp.batch(step)
        assert sorted(tb) == sorted(jb) == ["mask", "patches", "tokens"]
        assert tuple(tb["mask"].shape) == (4, 12)
        for k in jb:
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]),
                                          err_msg=f"{k} step {step}")


def _run(*extra, mesh=None):
    kwargs, _ = ttrain.cli_args(
        ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "4",
         "--seq", "12", "--steps", "2", "--sigma", "1.0", "--log-every",
         "100", *extra])
    summary = {}
    params, losses = ttrain.train(**kwargs, log=lambda m: None,
                                  summary_out=summary, mesh=mesh)
    return ({k: v.clone() for k, v in flatten(params).items()}, losses,
            summary)


def test_train_cli_runs_the_vlm_path():
    """``--arch internvl2-26b --smoke --device cpu``: the pipeline's patches
    through the BK step, finite losses near ln(64), the projector moved."""
    params, losses, summary = _run()
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert abs(losses[0] - np.log(64)) < 0.5
    assert summary["steps_done"] == 2 and summary["epsilon"] > 0
    init = flatten(build(smoke_config(ARCH).with_(
        param_dtype="float32")).init(0, "cpu"))
    assert not torch.equal(params["projector/w"], init["projector/w"])


def _world2(rank, port, tmp):
    torch.set_num_threads(1)
    init_distributed(rank, 2, f"tcp://localhost:{port}", "cpu")
    out = {"mesh": _run(mesh=(2, 1))}
    if rank == 0:
        out["one"] = _run()
        torch.save(out, os.path.join(tmp, "world2.pt"))
    dist.destroy_process_group()


def test_mesh_2x1_matches_one_process(tmp_path):
    """``--mesh 2,1`` (two gloo processes, two samples each, one
    all-reduce a weighted grad) trains the vlm to the one-process run's
    params within tests/test_sharded_step.py:80's tolerance, its losses
    within 1e-4."""
    mp.spawn(_world2, args=(free_port(), str(tmp_path)), nprocs=2,
             join=True)
    out = torch.load(os.path.join(tmp_path, "world2.pt"), weights_only=False)
    (gp, gl, gs), (wp, wl, ws) = out["mesh"], out["one"]
    assert gs["mesh"]["backend"] == "gloo"
    np.testing.assert_allclose(gl, wl, rtol=0, atol=1e-4)
    assert sorted(gp) == sorted(wp)
    for k, w in wp.items():
        np.testing.assert_allclose(gp[k].numpy(), w.numpy(), err_msg=k,
                                   **PARITY)
