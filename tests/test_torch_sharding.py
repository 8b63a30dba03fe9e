"""The port's rules table, rank blocks and shard-local draws on the CPU,
against the JAX package's ``repro/launch/sharding.py`` and
``repro/core/noise.py`` (no processes: a mesh is a stand-in object, which is
all the reference's ``sanitize`` reads).

- ``param_pspecs`` and ``opt_state_pspecs`` equal the reference's leaf for
  leaf: every leaf of the qwen2-1.5b, deepseek-moe-16b and rwkv6-3b smoke
  configs and of their full configs' shapes, on meshes (1,1), (2,2), (4,2)
  and (2,2,2), for every optimizer.
- ``local_block`` tiles each leaf: the ranks' blocks cover it, each element
  once a replica, and one rank of each block's replicas writes it.
- Shard-local draws: each rank's block equals the reference's
  ``counter_normal(offsets=, full_shape=)`` within the port's normal
  tolerance (8 ulp) and the port's whole-tensor draw sliced, bitwise, by
  ``sharded_normal``, by the block route's plain version
  (``core.noise.block_normal``) and through ``counter_noise``; the wide
  counter of tests/test_sharded_step.py:187 too.
- The block route's geometry, and the two block entries' ctypes calls
  against ``build.SIGNATURES`` through a fake library.
- ``noise_update``'s plain version on each rank's block is bitwise the
  whole leaf's update, sliced (AdamW, SGD, FTRL).
"""
import ctypes
import functools
import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import build as jbuild
from repro.configs.registry import get_config as jget_config
from repro.configs.registry import smoke_config as jsmoke
from repro.core import noise as jn
from repro.launch import sharding as jsh
from repro.utils.tree import flatten as jflatten
from repro_torch.configs.registry import build as tbuild
from repro_torch.configs.registry import smoke_config as tsmoke
from repro_torch.core import noise
from repro_torch.kernels import build
from repro_torch.kernels import counter_noise as cn
from repro_torch.kernels import noise_update as nu
from repro_torch.launch import sharding as sh
from repro_torch.utils.tree import flatten, unflatten

ARCHS = ("qwen2-1.5b", "deepseek-moe-16b", "rwkv6-3b")
MESHES = ((1, 1), (2, 2), (4, 2), (2, 2, 2))
OPTIMIZERS = ("sgd", "adamw", "lamb", "adafactor", "ftrl")
ULP = 8                                    # the normals' bound (ndtri)


def _mesh(shape, coords=None):
    names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    coords = coords or (0,) * len(shape)
    return types.SimpleNamespace(shape=dict(zip(names, shape)),
                                 axis_names=names,
                                 coords=dict(zip(names, coords)))


def _ranks(shape):
    return [_mesh(shape, c) for c in itertools.product(*map(range, shape))]


def _ulp(a, b) -> np.ndarray:
    def ordered(x):
        i = np.ascontiguousarray(x, np.float32).view(np.int32).astype(
            np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


_SHAPES = {}


def _jax_shapes(arch, size):
    """{path: shape} of the JAX model's params (eval_shape: no memory)."""
    if (arch, size) not in _SHAPES:
        cfg = jsmoke(arch) if size == "smoke" else jget_config(arch)
        tree = jax.eval_shape(jbuild(cfg).init, jax.random.PRNGKey(0))
        _SHAPES[arch, size] = {k: tuple(v.shape)
                               for k, v in jflatten(tree).items()}
    return _SHAPES[arch, size]


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_param_paths_are_the_references(arch):
    """The port's smoke models hold the reference's param paths and shapes,
    so the rules table sees the same leaves in both packages."""
    params = tbuild(tsmoke(arch)).init(0, "cpu")
    assert {k: tuple(v.shape) for k, v in flatten(params).items()} == \
        _jax_shapes(arch, "smoke")


@pytest.mark.parametrize("size", ("smoke", "full"))
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_param_and_opt_state_specs_are_the_references(arch, size, mesh):
    shapes = _jax_shapes(arch, size)
    jparams = unflatten({k: jax.ShapeDtypeStruct(s, jnp.float32)
                         for k, s in shapes.items()})
    tparams = unflatten({k: torch.empty(s, device="meta")
                         for k, s in shapes.items()})
    m = _mesh(mesh)
    want = jsh.param_pspecs(jparams, m)
    got = sh.param_pspecs(tparams, m)
    fw, fg = jflatten(want), flatten(got)
    assert sorted(fw) == sorted(fg)
    for k in fw:
        assert fg[k] == tuple(fw[k]), k
    assert sh.flat_param_pspecs(tparams, m) == fg
    for opt in OPTIMIZERS:
        ow = jflatten(jsh.opt_state_pspecs(opt, jparams, want))
        og = flatten(sh.opt_state_pspecs(opt, tparams, got))
        assert sorted(ow) == sorted(og), opt
        for k in ow:
            assert og[k] == tuple(ow[k]), (opt, k)


def test_unsharded_specs_and_the_fallback_are_the_references():
    for path, ndim in (("blocks/attn/qkv/w", 3), ("x/w", 2), ("x/w", 4),
                       ("ln/scale", 1), ("embed/w", 2), ("pos/e", 3),
                       ("router/w", 1)):
        assert sh.spec_for(path, ndim) == tuple(jsh.spec_for(path, ndim))
    m = _mesh((2, 2))
    assert sh.sanitize(("data", "model"), (3, 4), m) == \
        tuple(jsh.sanitize(jax.sharding.PartitionSpec("data", "model"),
                           (3, 4), m))


@pytest.mark.parametrize("mesh", MESHES[1:], ids=lambda m: "x".join(map(str, m)))
def test_local_blocks_tile_every_leaf(mesh):
    """Over every rank, each leaf's blocks cover it, each element as many
    times as the block has replicas, and exactly one rank of each block's
    replicas is its writer."""
    shapes = _jax_shapes("qwen2-1.5b", "smoke")
    shapes["odd/w"] = (5, 7)                  # does not divide: whole
    specs = sh.flat_param_pspecs(
        unflatten({k: torch.empty(s, device="meta")
                   for k, s in shapes.items()}), _mesh(mesh))
    for path, shape in shapes.items():
        count = torch.zeros(shape, dtype=torch.int64)
        writers = {}
        for m in _ranks(mesh):
            local, offs = sh.local_block(shape, specs[path], m)
            count[tuple(slice(o, o + n) for o, n in zip(offs, local))] += 1
            if sh.holds_unique(specs[path], shape, m):
                assert offs not in writers, path
                writers[offs] = m.coords
        blocks = {sh.local_block(shape, specs[path], m)[1]
                  for m in _ranks(mesh)}
        reps = int(np.prod(mesh)) // len(blocks)
        assert (count == reps).all(), path
        assert set(writers) == blocks, path


def test_batch_and_state_specs():
    m = _mesh((2, 1, 2))
    bs = sh.batch_pspecs({"tokens": torch.empty(8, 16, device="meta"),
                          "odd": torch.empty(3, device="meta")}, m)
    assert bs == {"tokens": (("pod", "data"), None), "odd": (None,)}
    params = {"blocks": {"mlp": {"up": {"w": torch.empty(
        2, 8, 12, device="meta")}}}}
    st = sh.state_pspecs("adamw", params, m)
    assert flatten(st.params) == {"blocks/mlp/up/w": (None, "data", "model")}
    assert flatten(st.opt_state)["v/blocks/mlp/up/w"] == \
        (None, "data", "model")
    assert (st.step, st.rng) == ((), ())


# ------------------------------------------------------------ shard draws
LEAVES = {"blocks/attn/qkv/w": (2, 64, 192), "blocks/attn/o/w": (2, 64, 64),
          "blocks/mlp/up/w": (2, 64, 128), "embed/w": (96, 64),
          "head/w": (64, 96), "experts/up/w": (2, 4, 64, 32),
          "ln/scale": (64,)}


@functools.lru_cache(maxsize=None)
def _ref_block(local, full):
    """The reference's counter_normal of a block of ``local`` in ``full``,
    jitted once a shape with the offsets traced (each rank reuses it)."""
    return jax.jit(lambda key, offs: jn.counter_normal(
        key, local, jnp.float32, offsets=[offs[d] for d in range(len(local))],
        full_shape=full))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_shard_local_draws_are_blocks_of_the_whole_draw(mesh):
    """Every rank's block of every leaf: the port's whole draw sliced,
    bitwise (sharded_normal, the block route's plain version and
    counter_noise on the CPU); the reference's counter_normal at the
    block's offsets within 8 ulp."""
    jkey = jax.random.fold_in(jax.random.PRNGKey(4), 7)
    key = tuple(int(v) for v in np.asarray(jkey))
    specs = sh.flat_param_pspecs(
        unflatten({k: torch.empty(s, device="meta")
                   for k, s in LEAVES.items()}), _mesh(mesh))
    for path, full in LEAVES.items():
        whole = noise.counter_normal(key, full)
        for m in _ranks(mesh):
            local, offs = sh.local_block(full, specs[path], m)
            want = whole[tuple(slice(o, o + n)
                               for o, n in zip(offs, local))]
            got = noise.sharded_normal(key, full, mesh=m, spec=specs[path])
            assert torch.equal(got, want), (path, m.coords)
            geo = noise.geometry(local, offs, full)
            if not geo.contiguous:
                assert torch.equal(noise.block_normal(key, geo).view(local),
                                   want)
            drawn = cn.counter_noise(torch.zeros(local), [key], [], 1.0, 1.0,
                                     offs, full)
            assert torch.equal(drawn, want), (path, m.coords)
            if m.shape == {a: 1 for a in m.axis_names}:
                continue        # the whole leaf: tests/test_torch_noise.py
            ref = np.asarray(_ref_block(local, full)(
                jkey, jnp.asarray(offs, jnp.uint32)))
            fin = np.isfinite(ref)
            assert int(_ulp(got.numpy()[fin], ref[fin]).max(
                initial=0)) <= ULP


def test_wide_counter_blocks():
    """tests/test_sharded_step.py:187's wide counter: a (2^20, 2^16) tensor
    (2^36 elements, the leading index on counter word 1); its blocks by
    the block route equal counter_normal's bitwise and the reference's
    within 8 ulp; distinct leading rows differ; a dim past 2^32 raises."""
    jkey = jax.random.PRNGKey(5)
    key = tuple(int(v) for v in np.asarray(jkey))
    full = (1 << 20, 1 << 16)
    for shape, offs in (((2, 4), (12345, 67)), ((1, 8), (1 << 19, 0)),
                        ((3, 5), ((1 << 20) - 3, (1 << 16) - 5))):
        geo = noise.geometry(shape, offs, full)
        assert geo.trail == 1 << 16
        got = (noise.linear_normal(key, geo.start, 8, geo.trail)
               if geo.contiguous else noise.block_normal(key, geo)
               ).view(shape)
        assert torch.equal(got, noise.counter_normal(
            key, shape, offsets=offs, full_shape=full))
        ref = np.asarray(jn.counter_normal(jkey, shape, offsets=offs,
                                           full_shape=full))
        assert int(_ulp(got.numpy(), ref).max()) <= ULP
    a = noise.block_normal(key, noise.geometry((2, 4), (12345, 67), full))
    assert not torch.equal(a[:4], a[4:])
    with pytest.raises(ValueError, match="2\\^64|2\\^32"):
        noise.geometry((4,), (0,), (1 << 33,))


def test_geometry_of_windows_and_blocks():
    g = noise.geometry
    assert g((3, 4)) == noise.Geometry(0, 12)
    assert g((1, 4), (2, 0), (3, 4)) == noise.Geometry(8, 12)
    assert g((2, 4), (1, 0), (3, 4)).contiguous
    # a column block: rows of 2 at stride 4
    assert g((3, 2), (0, 2), (3, 4)) == noise.Geometry(2, 12, (1, 1, 3, 2),
                                                       (0, 0, 4))
    # whole trailing dims merge into the row; a leading dim of 1 drops
    assert g((1, 2, 3, 5), (1, 2, 0, 0), (2, 4, 3, 5)) == noise.Geometry(
        90, 120)
    assert g((2, 2, 3, 5), (0, 2, 0, 0), (2, 4, 3, 5)).dims == \
        (1, 1, 2, 30)
    # the last dim split to one element: rows of 1
    assert g((2, 1), (0, 3), (2, 4)) == noise.Geometry(3, 8, (1, 1, 2, 1),
                                                       (0, 0, 4))
    with pytest.raises(ValueError, match="4 dims"):
        g((2, 2, 2, 2, 2), (0, 0, 0, 0, 0), (3, 3, 3, 3, 3))
    with pytest.raises(ValueError, match="outside"):
        g((2, 2), (2, 0), (3, 2))


# ------------------------------------------------------- the block entries
class _FakeLib:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("dp_"):
            raise AttributeError(name)

        def call(*args):
            geo = list((ctypes.c_ulonglong * 8).from_address(args[5])) \
                if name == "dp_counter_noise_block" else \
                list((ctypes.c_ulonglong * 8).from_address(args[7])) \
                if name == "dp_noise_update_block" else None
            self.calls.append((name, args, geo))
            return 0
        return call


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(build, "check_inputs",
                        lambda name, floats, ints=(), f32=():
                        floats[0].dtype == torch.bfloat16)
    return lib


def test_block_entries_take_their_signatures(fake_lib):
    """A block that is no window reaches the block entries, with the
    arguments build.SIGNATURES declares: the geometry as 8 words (start,
    the strides of dims 0..2, the 4 dims), the trail, the count; a window
    of a whole leaf keeps the window's entries."""
    full, local, offs = (4, 6, 10), (4, 3, 5), (0, 3, 5)
    geo = noise.geometry(local, offs, full)
    g = torch.empty(local, dtype=torch.bfloat16, device="meta")
    n0 = cn.counter_noise.launches
    cn.counter_noise(g, [(1, 2)], [], 0.5, 8.0, offs, full)
    assert cn.counter_noise.launches == n0 + 1
    (name, args, words), = fake_lib.calls
    assert name == "dp_counter_noise_block"
    assert len(args) == len(build.SIGNATURES[name])
    assert words == [geo.start, *geo.strides, *geo.dims]
    assert words == [35, 0, 60, 10, 1, 4, 3, 5]
    assert (args[4], args[6], args[7], args[10]) == (1, 240, 60, 1)
    fake_lib.calls.clear()
    rec = noise.NoisedLeaf(g, ((1, 2),), ((3, 4),), 0.5, 8.0, geo.start,
                           geo.trail, geo.dims, geo.strides)
    p = torch.empty(local, dtype=torch.bfloat16, device="meta")
    m, v = (torch.empty(local, device="meta") for _ in range(2))
    n0 = nu.noise_update.launches
    nu.noise_update(rec, p, m, v, nu.AdamW(1e-3, 0.9, 0.99, 1e-8, 0.1, 0.01))
    assert nu.noise_update.launches == n0 + 1
    (name, args, words), = fake_lib.calls
    assert name == "dp_noise_update_block"
    assert len(args) == len(build.SIGNATURES[name])
    assert words == [35, 0, 60, 10, 1, 4, 3, 5]
    assert (args[6], args[8], args[9], args[10], args[11], args[12]) == \
        (2, 240, 60, 1, 1, 1)
    fake_lib.calls.clear()
    cn.counter_noise(torch.empty(2, 6, 10, device="meta"), [(1, 2)], [], 1.0,
                     1.0, (2, 0, 0), full)
    assert fake_lib.calls[0][0] == "dp_counter_noise"
    assert fake_lib.calls[0][1][5:7] == (120, 240)


@pytest.mark.parametrize("opt", ("adamw", "sgd", "ftrl"))
def test_plain_update_of_each_block_is_the_whole_update(opt):
    """noise_update's plain version over each rank's block of a leaf (its
    noise at the block's counters): bitwise the update of the whole leaf,
    sliced, for p and every state tensor, at the tree's keys (hi 2, lo 1)
    and at one key."""
    full, spec, mesh = (3, 8, 12), (None, "data", "model"), (2, 2)
    gen = torch.Generator().manual_seed(3)
    g = torch.randn(full, generator=gen)
    p0 = torch.randn(full, generator=gen)
    hp = {"adamw": nu.AdamW(1e-2, 0.9, 0.99, 1e-8, 0.19, 0.0199, 0.1),
          "sgd": nu.SGD(1e-2, 0.9, 0.01),
          "ftrl": nu.FTRL(1e-2, 0.9, False)}[opt]
    for hi, lo in ((((1, 2), (3, 4)), ((5, 6),)), (((7, 8),), ())):
        def state(shape):
            return [torch.full(shape, 0.5), torch.full(shape, 0.25),
                    torch.full(shape, 0.125)]

        p, (m, v, t0) = p0.clone(), state(full)
        geo = noise.geometry(full)
        nu.noise_update(noise.NoisedLeaf(g, hi, lo, 0.7, 4.0, geo.start,
                                         geo.trail), p, m, v, hp, t0)
        for rank in _ranks(mesh):
            local, offs = sh.local_block(full, spec, rank)
            cut = tuple(slice(o, o + n) for o, n in zip(offs, local))
            geo = noise.geometry(local, offs, full)
            pb, (mb, vb, tb) = p0[cut].clone(), state(local)
            nu.noise_update(noise.NoisedLeaf(
                g[cut].contiguous(), hi, lo, 0.7, 4.0, geo.start, geo.trail,
                geo.dims, geo.strides), pb, mb, vb, hp, tb)
            assert torch.equal(pb, p[cut]), (opt, rank.coords)
            assert torch.equal(mb, m[cut]) and torch.equal(vb, v[cut])
            assert torch.equal(tb, t0[cut])
