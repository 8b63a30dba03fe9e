"""The port's dense transformer against the JAX package's at smoke size:
same params (converted key by key), same numpy batch -> same per-sample
losses, and the same tap / record keys and shapes as
``repro.core.bk.tap_act_structs``. Also: the port imports neither JAX nor
the JAX package."""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import build as jbuild
from repro.configs.registry import smoke_config as jsmoke
from repro.core.bk import tap_act_structs as jtap_act_structs
from repro.core.tape import Tape as JTape
from repro.utils.tree import flatten as jflatten
from repro_torch.configs.registry import build, smoke_config
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core.bk import tap_act_structs
from repro_torch.core.tape import Tape

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-3, atol=1e-4)        # tests/test_kernel_parity.py:15


def _models(seed=0):
    jcfg = jsmoke("qwen2-1.5b").with_(dtype="float32", param_dtype="float32")
    tcfg = smoke_config("qwen2-1.5b").with_(param_dtype="float32")
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    flat = {k: np.asarray(v) for k, v in jflatten(jp).items()}
    return jm, jp, build(tcfg), params_from_jax(flat, "cpu"), tcfg


def _tokens(B, T, vocab=64, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, T)
                                                ).astype(np.int32)


@pytest.mark.parametrize("arch", [
    "qwen2-1.5b", "qwen2.5-3b", "qwen3-14b", "llama3-405b",
    "deepseek-moe-16b", "moonshot-v1-16b-a3b", "rwkv6-3b", "hymba-1.5b",
    "whisper-small", "internvl2-26b"])
def test_configs_match_the_jax_registry(arch):
    """Every arch the port registers, field for field the JAX package's
    (its smoke reduction too); the port registers no other."""
    from repro.configs.registry import get_config as jget
    from repro_torch.configs.registry import get_config, list_archs
    assert arch in list_archs() and len(list_archs()) == 10
    j, t = jget(arch), get_config(arch)
    fields = ("name", "family", "n_layers", "d_model", "n_heads",
              "n_kv_heads", "head_dim", "d_ff", "vocab", "qkv_bias",
              "qk_norm", "norm", "act", "rope_theta", "param_dtype",
              "attn_chunk", "remat", "n_experts", "top_k", "n_shared",
              "moe_d_ff", "first_k_dense", "capacity_factor", "renorm_topk",
              "ssm_state", "ssm_heads", "ssm_chunk", "window",
              "full_attn_layers", "meta_tokens", "encoder_layers",
              "decoder_len", "frame_dim", "patch_tokens", "vit_dim")
    for f in fields:
        assert getattr(t, f) == getattr(j, f), f
    js, ts = jsmoke(arch), smoke_config(arch)
    for f in fields:
        assert getattr(ts, f) == getattr(js, f), f


def test_init_keys_shapes_dtypes_match_jax():
    jm, jp, tm, _, tcfg = _models()
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in jflatten(jp).items()}
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in params_to_numpy(tm.init(0, "cpu")).items()}
    assert got == want


@pytest.mark.parametrize("T", [16, 33])
def test_per_sample_losses_match_jax(T):
    jm, jp, tm, tp, _ = _models()
    toks = _tokens(3, T)
    want = np.asarray(jax.jit(lambda p, b: jm.apply(p, b, JTape.null()))(
        jp, {"tokens": jnp.asarray(toks)}))
    got = tm.apply(tp, {"tokens": torch.from_numpy(toks)}, Tape.null())
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_masked_losses_match_jax():
    jm, jp, tm, tp, _ = _models()
    toks = _tokens(2, 16)
    mask = np.ones((2, 16), np.float32)
    mask[1, 9:] = 0.0
    want = np.asarray(jm.apply(jp, {"tokens": jnp.asarray(toks),
                                    "mask": jnp.asarray(mask)}, JTape.null()))
    got = tm.apply(tp, {"tokens": torch.from_numpy(toks),
                        "mask": torch.from_numpy(mask)}, Tape.null())
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("T", [16, 33])
def test_tap_and_record_structure_matches_jax(T):
    jm, jp, tm, tp, _ = _models()
    toks = _tokens(3, T)
    jtaps, jacts = jtap_act_structs(jm.apply, jp, {"tokens": jnp.asarray(toks)})
    taps, acts = tap_act_structs(tm.apply, tp, {"tokens": torch.from_numpy(toks)})
    norm = lambda d: {k: (tuple(v.shape), str(v.dtype)) for k, v in d.items()}
    tnorm = lambda d: {k: (tuple(s), str(dt).replace("torch.", ""))
                       for k, (s, dt) in d.items()}
    assert tnorm(taps) == norm(jtaps)
    assert tnorm(acts) == norm(jacts)


def test_stacked_records_hold_each_layers_input():
    """Layer l's record sits at [l] of the stacked (L,B,T,d) record: the
    down projection's input is silu(gate) * up of the same layer's up tap
    (its output from its own record and weight). Each layer's target is
    the up output's autograd edge, with its shape and dtype."""
    from repro_torch.core.tape import Target
    _, _, tm, tp, _ = _models()
    tape = Tape(active=lambda key: True)
    tm.apply(tp, {"tokens": torch.from_numpy(_tokens(2, 16))}, tape)
    down_in = tape.acts["blocks/mlp/down#mm.s"]
    up_in = tape.acts["blocks/mlp/up#mm.s"]
    ups = tape.outs["blocks/mlp/up#mm.s"]
    assert down_in.shape == (2, 2, 16, 48) and len(ups) == 2
    for l, t in enumerate(ups):
        assert isinstance(t, Target) and t.edge.node is not None
        assert (tuple(t.shape), t.dtype) == ((2, 16, 96), torch.float32)
        s = up_in[l] @ tp["blocks"]["mlp"]["up"]["w"][l]
        g, u = torch.chunk(s, 2, dim=-1)
        torch.testing.assert_close(down_in[l],
                                   torch.nn.functional.silu(g) * u)
    assert tape.acts["embed#emb"].dtype == torch.int32


def test_port_imports_no_jax_and_no_reference_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "assert 'repro_torch.models.whisper' in mods, mods\n"
        "assert 'repro_torch.configs.internvl2_26b' in mods, mods\n"
        "for m in mods: importlib.import_module(m)\n"
        "sys.path.insert(0, sys.argv[1]); import chip_smoke\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'repro' or k.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20
