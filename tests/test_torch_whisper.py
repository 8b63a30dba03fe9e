"""The port's encoder-decoder family (whisper-small) against the JAX package
at smoke size (2 encoder + 2 decoder layers, d 32, 4 heads x 8, decoder_len
16, frame_dim 24): the same params (converted key by key) and numpy inputs
-> the same per-sample losses (f32 and bf16), BK norms, clipped sums and
plan under bk-mixopt (the reference without its Pallas kernels), prefill
logits, cross caches and decode logits; the batch (tokens and frames
bitwise); the port's opacus against its bk-mixopt; the CLIs. One
module-scoped fixture holds the reference's model, params and jitted
functions."""
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import build as jbuild
from repro.configs.registry import get_config as jget
from repro.configs.registry import smoke_config as jsmoke
from repro.core.bk import DPConfig as JDPConfig
from repro.core.bk import bk_clipped_sum as jbk_clipped_sum
from repro.core.bk import tap_act_structs as jtap_act_structs
from repro.core.tape import Tape as JTape
from repro.data.pipeline import Pipeline as JPipeline
from repro.data.pipeline import PipelineConfig as JPipelineConfig
from repro.data.synthetic import make_batch as jmake_batch
from repro.launch.serve import generate as jgenerate
from repro.models import whisper as jwhisper
from repro.utils.tree import flatten as jflatten
from repro_torch.configs.registry import build, get_config, smoke_config
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core.bk import (DPConfig, bk_clipped_sum, plan_report,
                                 tap_act_structs)
from repro_torch.core.engine import make_grad_fn
from repro_torch.core.noise import prng_key
from repro_torch.core.tape import Tape
from repro_torch.data.pipeline import Pipeline, PipelineConfig
from repro_torch.data.synthetic import make_batch
from repro_torch.launch import serve
from repro_torch.launch import train as ttrain
from repro_torch.models import whisper as twhisper
from repro_torch.models.whisper import WhisperLM
from repro_torch.utils.tree import flatten

ARCH, B, TF = "whisper-small", 3, 48
TOL = dict(rtol=1e-3, atol=1e-4)           # tests/test_kernel_parity.py:15
TOL_BF16 = dict(rtol=5e-2, atol=2e-2)      # tests/test_kernel_parity.py:18
OPACUS_NORM_TOL = dict(rtol=2e-4, atol=1e-5)   # tests/test_arch_smoke.py:97
OPACUS_TOL = dict(rtol=2e-3, atol=2e-5)        # tests/test_arch_smoke.py:100


class Ref:
    """The reference's smoke model in f32 and bf16, its params and its
    jitted entry points, built once for the module."""

    def __init__(self):
        self.cfg = {dt: jsmoke(ARCH).with_(dtype=dt, param_dtype=dt)
                    for dt in ("float32", "bfloat16")}
        self.model = {dt: jbuild(c) for dt, c in self.cfg.items()}
        self.params = {dt: m.init(jax.random.PRNGKey(0))
                       for dt, m in self.model.items()}
        m = self.model["float32"]
        self.apply = {dt: jax.jit(lambda p, b, m=m: m.apply(p, b, JTape(None)))
                      for dt, m in self.model.items()}
        self.prefill = jax.jit(m.prefill)
        self.prefill_cross = jax.jit(m.prefill_cross)
        self.decode = jax.jit(m.decode_step)
        self._bk = {}

    def bk(self, mode):
        if mode not in self._bk:
            m = self.model["float32"]
            self._bk[mode] = jax.jit(lambda p, b: jbk_clipped_sum(
                m.apply, p, b, JDPConfig(mode=mode, use_kernels=False)))
        return self._bk[mode]

    def port(self, dt="float32"):
        """The port's model and a fresh copy of the reference's params."""
        tm = build(smoke_config(ARCH).with_(param_dtype=dt))
        flat = {k: np.asarray(v) for k, v in jflatten(self.params[dt]).items()}
        return tm, params_from_jax(flat, "cpu")


@pytest.fixture(scope="module")
def ref():
    return Ref()


def _inputs(Tf=TF, Td=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Tf, 24)).astype(np.float32),
            rng.integers(0, 64, (B, Td)).astype(np.int32))


def _batches(Tf=TF, seed=0):
    frames, toks = _inputs(Tf, seed=seed)
    return ({"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks)},
            {"frames": torch.from_numpy(frames),
             "tokens": torch.from_numpy(toks)})


def test_registry_builds_whisper_with_the_reference_fields():
    assert isinstance(build(get_config(ARCH)), WhisperLM)
    fields = ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "head_dim", "d_ff", "vocab", "encoder_layers", "decoder_len",
              "frame_dim", "norm", "act", "param_dtype", "attn_chunk",
              "qkv_bias")
    j, t = jget(ARCH), get_config(ARCH)
    for f in fields:
        assert getattr(t, f) == getattr(j, f), f
    js, ts = jsmoke(ARCH), smoke_config(ARCH)
    for f in fields:
        assert getattr(ts, f) == getattr(js, f), f
    assert (ts.encoder_layers, ts.decoder_len, ts.frame_dim,
            ts.n_kv_heads) == (2, 16, 24, 4)


def test_params_round_trip_the_reference_keys(ref):
    """The port's init has the reference's flat keys, shapes and dtypes (f32
    and bf16); the reference's params go to the port and come back
    bitwise."""
    for dt in ("float32", "bfloat16"):
        want = {k: (np.asarray(v).shape, str(np.asarray(v).dtype))
                for k, v in jflatten(ref.params[dt]).items()}
        tm = build(smoke_config(ARCH).with_(param_dtype=dt))
        got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
               for k, v in flatten(tm.init(0, "cpu")).items()}
        assert got == want, dt
    assert {"frontend/w", "frontend/b", "pos/e", "enc_blocks/ln1/g",
            "dec_blocks/xattn/kv/w", "dec_blocks/lnx/b",
            "enc_norm/g"} <= set(want)
    _, tp = ref.port()
    back = params_to_numpy(tp)
    want = {k: np.asarray(v) for k, v in jflatten(ref.params["float32"]
                                                  ).items()}
    assert sorted(back) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


@pytest.mark.parametrize("Tf,seed,step", [(48, 0, 0), (1500, 1, 5)])
def test_make_batch_matches_jax(Tf, seed, step):
    """Frames (B, Tf, frame_dim) and tokens (B, decoder_len), bitwise: the
    tokens from the second key (the reference walks its inputs sorted), the
    frames by XLA's erfinv over its CPU log1p."""
    want = jmake_batch(jsmoke(ARCH), 2, Tf, seed, step)
    got = make_batch(smoke_config(ARCH), 2, Tf, seed, step, "cpu")
    assert sorted(got) == ["frames", "tokens"]
    assert got["frames"].dtype == torch.float32
    assert got["tokens"].dtype == torch.int32
    assert tuple(got["tokens"].shape) == (2, 16)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    assert tuple(got["frames"].shape) == (2, Tf, 24)
    np.testing.assert_array_equal(got["frames"].numpy(),
                                  np.asarray(want["frames"]))


def test_pipeline_spec_and_poisson_mask_match_jax():
    """The spec's encdec shapes; the Poisson mask broadcast over the
    decoder's tokens, bitwise."""
    jp = JPipeline(jsmoke(ARCH), JPipelineConfig(4, 40, seed=3,
                                                 poisson_q=0.5))
    tp = Pipeline(smoke_config(ARCH), PipelineConfig(4, 40, seed=3,
                                                     poisson_q=0.5), "cpu")
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in jp.spec().items()}
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in tp.spec().items()}
    assert got == want
    for step in (0, 1, 2):
        jb, tb = jp.batch(step), tp.batch(step)
        np.testing.assert_array_equal(tb["mask"].numpy(),
                                      np.asarray(jb["mask"]))
        assert tuple(tb["mask"].shape) == (4, 16)
        np.testing.assert_array_equal(tb["tokens"].numpy(),
                                      np.asarray(jb["tokens"]))


def test_sinusoid_and_encode_match_jax(ref):
    for T, d in ((48, 32), (1500, 768), (7, 6)):
        np.testing.assert_allclose(twhisper._sinusoid(T, d).numpy(),
                                   np.asarray(jwhisper._sinusoid(T, d)),
                                   **TOL)
    jm = ref.model["float32"]
    tm, tp = ref.port()
    frames, _ = _inputs()
    want = np.asarray(jax.jit(lambda p, f: jm.encode(p, JTape(None), f))(
        ref.params["float32"], frames))
    got = tm.encode(tp, Tape.null(), torch.from_numpy(frames))
    assert tuple(got.shape) == (B, TF, 32)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_apply_losses_match_jax(ref, dt):
    tm, tp = ref.port(dt)
    jb, tb = _batches()
    want = np.asarray(ref.apply[dt](ref.params[dt], jb), np.float32)
    got = tm.apply(tp, tb, Tape.null())
    assert got.shape == (B,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want,
                               **(TOL if dt == "float32" else TOL_BF16))


def test_masked_losses_match_jax(ref):
    tm, tp = ref.port()
    jb, tb = _batches()
    mask = np.ones((B, 16), np.float32)
    mask[1, 9:] = 0.0
    want = np.asarray(ref.apply["float32"](ref.params["float32"],
                                           dict(jb, mask=jnp.asarray(mask))))
    got = tm.apply(tp, dict(tb, mask=torch.from_numpy(mask)), Tape.null())
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_taps_and_records_match_the_reference(ref):
    """Every tap key, output and record of the reference, letter for
    letter: ``dec_blocks/xattn/kv`` at the layer's root, recorded at T = Tf
    (the encoder's output, once a layer) while the group's other taps have
    T = Td."""
    tm, tp = ref.port()
    jb, tb = _batches()
    jtaps, jacts = jtap_act_structs(ref.model["float32"].apply,
                                    ref.params["float32"], jb)
    taps, acts = tap_act_structs(tm.apply, tp, tb)
    norm = lambda d: {k: (tuple(v.shape), str(v.dtype)) for k, v in d.items()}
    tnorm = lambda d: {k: (tuple(s), str(t).replace("torch.", ""))
                       for k, (s, t) in d.items()}
    assert tnorm(taps) == norm(jtaps)
    assert tnorm(acts) == norm(jacts)
    assert set(taps) == (
        {"frontend#mm", "embed#emb", "head#mm"}
        | {f"enc_blocks/{o}#mm.s" for o in ("attn/qkv", "attn/o", "mlp/up",
                                            "mlp/down")}
        | {f"dec_blocks/{o}#mm.s" for o in ("attn/qkv", "attn/o", "xattn/q",
                                            "xattn/kv", "xattn/o", "mlp/up",
                                            "mlp/down")})
    assert tuple(acts["dec_blocks/xattn/kv#mm.s"][0]) == (2, B, TF, 32)
    assert tuple(acts["dec_blocks/xattn/q#mm.s"][0]) == (2, B, 16, 32)
    tape = Tape(active=lambda k: True)
    with torch.no_grad():
        tm.apply(tp, tb, tape)
    kv = tape.acts["dec_blocks/xattn/kv#mm.s"]
    torch.testing.assert_close(kv[0], kv[1], rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["bk", "bk-mixopt"])
def test_bk_clipped_sum_matches_jax(ref, mode):
    """Per-sample norms, losses and clipped sums of the port's
    ``bk_clipped_sum(..., mesh=None)`` against the reference's at Tf = 48:
    under bk-mixopt every encoder tap and ``xattn/kv`` take the direct norm
    (2 Tf^2 = 4608 > pd, at most 32 x 96 = 3072) and bk-mixopt caches them,
    the decoder's taps (Td = 16) and the head the ghost norm."""
    tm, tp = ref.port()
    jb, tb = _batches()
    want, waux = ref.bk(mode)(ref.params["float32"], jb)
    got, aux = bk_clipped_sum(tm.apply, tp, tb, DPConfig(mode=mode),
                              mesh=None)
    np.testing.assert_allclose(aux["per_sample_norms"].numpy(),
                               np.asarray(waux["per_sample_norms"]), **TOL)
    np.testing.assert_allclose(aux["loss"].numpy(), np.asarray(waux["loss"]),
                               **TOL)
    want = {k: np.asarray(v) for k, v in want.items()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), want[k], err_msg=k, **TOL)
    report = plan_report(tm.apply, tp, tb, DPConfig(mode=mode))
    norms = {k: r["norm"].method for k, r in report.items()}
    if mode == "bk":
        assert set(norms.values()) == {"ghost"}
        return
    direct = {k for k, m in norms.items() if m == "direct"}
    assert direct == {"frontend#mm", "dec_blocks/xattn/kv#mm.s"} | {
        f"enc_blocks/{o}#mm.s" for o in ("attn/qkv", "attn/o", "mlp/up",
                                         "mlp/down")}
    assert all(report[k]["grad"] == "cache" for k in direct)
    assert report["head#mm"]["grad"] == "clipped_grad"
    assert report["embed#emb"]["grad"] == "emb_clipped_grad"


def test_opacus_matches_bk_mixopt(ref):
    """The port's opacus (vmap(grad) through encoder and decoder) against
    its bk-mixopt."""
    tm, tp = ref.port()
    _, tb = _batches()
    want, wa = make_grad_fn(tm.apply, DPConfig(mode="opacus"))(
        tp, tb, prng_key(3))
    got, ga = make_grad_fn(tm.apply, DPConfig(mode="bk-mixopt"))(
        tp, tb, prng_key(3))
    np.testing.assert_allclose(ga["per_sample_norms"].numpy(),
                               wa["per_sample_norms"].numpy(),
                               **OPACUS_NORM_TOL)
    want = flatten(want)
    for k, g in sorted(flatten(got).items()):
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), err_msg=k,
                                   **OPACUS_TOL)


@pytest.mark.parametrize("Tf,Td", [(48, 16), (37, 9)])
def test_prefill_matches_jax(ref, Tf, Td):
    """The prefill's last-position logits (attention by the flash kernel's
    plain version on the CPU: bidirectional encoder and cross-attention,
    causal self-attention), Td < decoder_len too."""
    tm, tp = ref.port()
    frames, toks = _inputs(Tf, Td)
    want = np.asarray(ref.prefill(ref.params["float32"], frames, toks))
    got = tm.prefill(tp, torch.from_numpy(frames), torch.from_numpy(toks))
    assert got.shape == (B, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_prefill_cross_and_decode_match_jax(ref):
    """``init_cache`` (structure), ``prefill_cross`` (the cross caches) and
    every decode step's logits and caches, teacher-forced from empty self
    caches over all 16 positions; the last step's logits also equal the
    prefill's."""
    jm = ref.model["float32"]
    tm, tp = ref.port()
    frames, toks = _inputs()
    jc = jm.init_cache(B, 16, Tf=TF)
    tc = tm.init_cache(B, 16, Tf=TF, device="cpu")
    shapes = lambda c: {k: tuple(v.shape) for k, v in c.items()}
    assert shapes(tc) == shapes(jc)
    jc = ref.prefill_cross(ref.params["float32"], frames, jc)
    tc = tm.prefill_cross(tp, torch.from_numpy(frames), tc)
    for k in ("xk", "xv"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   err_msg=k, **TOL)
    for i in range(16):
        j, jc = ref.decode(ref.params["float32"], jc, jnp.asarray(toks[:, i]),
                           jnp.asarray(i, jnp.int32))
        t, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, i]), i)
        np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                   err_msg=f"step {i}", **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   err_msg=k, **TOL)
    pre = tm.prefill(tp, torch.from_numpy(frames), torch.from_numpy(toks))
    np.testing.assert_allclose(t.numpy(), pre.numpy(), **TOL)
    with pytest.raises(ValueError, match="decoder_len"):
        tm.decode_step(tp, tc, torch.from_numpy(toks[:, 0]), 16)


def test_generate_decodes_against_zero_cross_caches_as_jax(ref):
    """``generate`` fills no cross cache (the reference's: ``init_cache(B,
    S)`` gives Tf = S of zeros): the same tokens, and the port's logits of
    every step against the reference's decode chain."""
    jm = ref.model["float32"]
    tm, tp = ref.port()
    _, toks = _inputs(Td=5)
    want = np.asarray(jgenerate(jm, ref.params["float32"], jnp.asarray(toks),
                                4))
    got, logits = serve.generate(tm, tp, torch.from_numpy(toks), 4,
                                 return_logits=True)
    np.testing.assert_array_equal(got.numpy(), want)
    jc = jm.init_cache(B, 9)
    assert tuple(jc["xk"].shape) == (2, B, 9, 4, 8)
    for i in range(9):
        j, jc = ref.decode(ref.params["float32"], jc,
                           jnp.asarray(want[:, i]), jnp.asarray(i, jnp.int32))
        np.testing.assert_allclose(logits[:, i].numpy(), np.asarray(j),
                                   err_msg=f"step {i}", **TOL)


def test_bf16_prefill_cross_keeps_the_model_dtype(ref):
    """bf16: the caches in the model dtype, the cross caches each layer's
    ``xattn/kv`` projection of the bf16 encoder's output (its attention by
    flash_attention, as the prefill's), bitwise."""
    tm, tp = ref.port("bfloat16")
    frames = torch.from_numpy(_inputs()[0])
    c = tm.init_cache(B, 8, Tf=TF, device="cpu")
    assert {v.dtype for v in c.values()} == {torch.bfloat16}
    c = tm.prefill_cross(tp, frames, c)
    enc = tm.encode(tp, Tape.null(), frames, attend=twhisper._flash)
    for l in range(2):
        kv = enc @ tp["dec_blocks"]["xattn"]["kv"]["w"][l]
        for k, want in zip(("xk", "xv"), torch.chunk(kv, 2, dim=-1)):
            assert c[k].dtype == torch.bfloat16
            assert tuple(c[k].shape) == (2, B, TF, 4, 8)
            assert torch.equal(c[k][l], want.reshape(B, TF, 4, 8)), (k, l)


def test_train_cli_takes_a_noised_step(tmp_path):
    """``--arch whisper-small --smoke --device cpu``, --seq as frames: two
    noised AdamW steps (a flat DPConfig: no registered policy); every param
    moves, the frontend's bias and the decoder's positions too."""
    out = tmp_path / "s.json"
    params, losses = ttrain.main([
        "--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
        "--batch", "2", "--seq", "48", "--sigma", "1.0", "--out", str(out)])
    summary = json.loads(out.read_text())
    assert summary["steps_done"] == 2 and summary["epsilon"] > 0
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    init = flatten(build(smoke_config(ARCH).with_(
        param_dtype="float32")).init(0, "cpu"))
    still = [k for k, v in flatten(params).items() if torch.equal(v, init[k])]
    assert not still, still


@pytest.mark.parametrize("frames", [0, 48])
def test_serve_cli_generates(frames):
    """Without frames against zero cross caches (the reference's
    ``generate``); with them ``prefill_cross`` first."""
    out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "5", "--gen", "4",
                      "--frames", str(frames)])
    assert tuple(out.shape) == (2, 9)


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_full_width_plan_is_chip_smokes(monkeypatch):
    """whisper-small at full width and depth, B=8, Tf=1500 (meta tensors,
    no compute): the kernels ``plan_report`` routes a step to are the launch
    counts chip_smoke's ``train_whisper`` asserts on the card (the encoder's
    taps and xattn/kv direct past the mixopt cache, the frontend cached,
    the decoder's and the head ghost); the head's record is unaligned (p =
    51865: the SIMT routes), every other tap aligned."""
    from repro_torch.configs.registry import cut_depth
    from repro_torch.kernels import clipped_grad as cg
    from repro_torch.kernels import ghost_norm as gn
    from repro_torch.models import layers as tl
    cs = _chip_smoke()
    meta = lambda gen, shape, dtype, *a: torch.empty(tuple(shape),
                                                     dtype=dtype,
                                                     device="meta")
    for fn in ("normal_init", "zeros_init", "ones_init"):
        monkeypatch.setattr(tl, fn, meta)
    run = cs.RUNS["train_whisper"]
    cfg = cut_depth(get_config(run["arch"]), run["layers"])
    model = build(cfg)
    params = model.init(0, "cpu")
    batch = {"frames": torch.empty(run["batch"], run["seq"], 768,
                                   device="meta"),
             "tokens": torch.empty(run["batch"], 448, dtype=torch.int32,
                                   device="meta")}
    report = plan_report(model.apply, params, batch,
                         DPConfig(mode="bk-mixopt", sigma=1.0))
    counts = dict.fromkeys(run["per_step"], 0)
    for key, plans in report.items():
        kind = key.split("#")[1].split(".")[0]
        if plans["grad"] != "cache":
            counts[cs.NORM_KERNEL[kind, plans["norm"].method]] += 1
        if plans["grad"] in counts:
            counts[plans["grad"]] += 1
    assert counts == run["per_step"]
    assert report["frontend#mm"]["grad"] == "cache"
    taps, _ = tap_act_structs(model.apply, params, batch)
    simt = {k for k, (shape, _) in taps.items()
            if "#mm" in k and gn.route(torch.bfloat16, 768,
                                       shape[-1]) == "simt"}
    assert simt == {"head#mm"}
    assert cg.route(torch.bfloat16, 768, 51865) == "simt"
    assert run["simt"] == {"ghost_norm": 1, "clipped_grad": 1}


def test_serve_cli_refuses_frames_for_a_decoder_only_arch():
    with pytest.raises(SystemExit):
        serve.main(["--smoke", "--device", "cpu", "--frames", "8"])
