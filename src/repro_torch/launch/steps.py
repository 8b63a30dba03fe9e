"""The train step: ``TrainState`` + ``make_train_step``, on one device or
over a mesh of processes.

``step_fn(state, batch) -> (state, loss)`` runs BK over the logical batch
(microbatched when asked), then the noise-add and the optimizer update in
ONE pass over the leaves (``noise_leaf_fn(..., out="deferred")`` inside
``update_leaves``), so no second full-size gradient tree is live; on the
card each leaf's noise and update are one ``noise_update`` launch. The
baseline modes (nonprivate, opacus, ghostclip, ...) take their private
gradient tree (``accumulated_private_grad``), then ``Optimizer.update``
(one ``noise_update`` launch a leaf, without noise). The profiler ranges
``bk_phases_1_3`` (``core.bk``) and ``phase4_update`` attribute a step's
device time. Step s draws under ``fold_in(state.rng, s)``, as the JAX
package's step does, so its noise is the reference's and a resumed run
replays the same draws.

Over a mesh (``launch.mesh.Mesh``; ``make_train_step(..., mesh=,
opt_name=)``): at rest each rank holds only its block of every param and
optimizer-state leaf, by ``launch.sharding.state_pspecs`` (``shard_tree``
cuts whole leaves). A step gathers the whole params (FSDP-style, one
all-gather a sharded leaf), runs BK on the rank's rows of the global batch
(``core.bk``: one all-reduce a weighted grad over the batch axes), keeps
its block of each all-reduced sum, draws that block's noise shard-local and
updates its blocks of p and the state in one ``noise_update`` launch a leaf
(the kernel's block route). Replicated leaves get the same sum and the same
noise on every rank, so they stay bitwise equal. The 'model' axis shards
storage only: the ranks of one model group compute the same rows with the
same gathered weights, and tensor-parallel matmuls are not ported (ROADMAP
B7b). The baseline modes compute the whole batch on every rank. SGD, AdamW
and DP-FTRL update blocks; LAMB's trust ratio and Adafactor's factored
moments need whole-leaf reductions and refuse a sharded leaf.

The dry-run grid (counterpart of the JAX package's ``plan_cell``): a
:class:`CellPlan` is one (arch x shape) cell for one rank of a mesh,
``fn(*args)`` the step the port runs there. :func:`plan_cell` builds it on
the meta device, over a ``launch.mesh.PlanMesh`` (no world, no card), and
:meth:`CellPlan.plan` runs it once there: the kernels' wrappers take the
card's routes and allocations against ``kernels.meta``, the mesh's
collectives count their bytes, and a dispatch mode counts live storage
(the caching allocator's 512-byte blocks) and aten's flops. The same
``fn`` runs on real tensors (:meth:`CellPlan.make_args`), which is how the
plan is held against the card.
"""
from __future__ import annotations

import math
import weakref
from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES
from repro_torch.core.bk import BK_MODES, DPConfig
from repro_torch.core.noise import fold_in, prng_key, tape_seed
from repro_torch.core.policy import (as_policy, noise_leaf_fn, resolve_policy,
                                     with_scope)
from repro_torch.data.synthetic import batch_spec, make_batch
from repro_torch.launch import sharding as sh
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.optim.accumulate import (accumulated_clipped_sum,
                                          accumulated_private_grad)
from repro_torch.utils.tree import flatten

# optimizers whose update is elementwise in p and the state, so a rank can
# step its blocks alone
BLOCKWISE = ("sgd", "adamw", "ftrl")


@dataclass
class TrainState:
    """Everything a step consumes and produces. ``rng`` is the base key, a
    (k0, k1) pair (``core.noise.prng_key``); each step folds its own index
    in. Over a mesh, params and opt_state hold the rank's blocks."""
    params: dict
    opt_state: dict
    step: int
    rng: tuple


def make_train_step(apply_fn, params_like, opt, dp, microbatch: int = 0,
                    mesh=None, opt_name: str = ""):
    """-> step_fn(state, batch) -> (new_state, loss tensor). With ``mesh``
    the state holds blocks (``opt_name`` names the optimizer, whose state
    the rules table shards) and ``batch`` is the global batch; on a mesh of
    one rank the step is the one-device step, op for op."""
    policy = as_policy(dp)
    res = resolve_policy(policy, flatten(params_like))
    if mesh is None:
        gather, pspecs = (lambda params: params), None
    else:
        pspecs = sh.flat_param_pspecs(params_like, mesh)
        shapes = {p: tuple(v.shape) for p, v in flatten(params_like).items()}
        sharded = [p for p, s in pspecs.items()
                   if mesh.axis_size(sh.spec_axes(s)) > 1]
        if opt_name not in BLOCKWISE and sharded:
            raise NotImplementedError(
                f"{opt_name or 'this optimizer'} over a mesh that shards "
                f"{sharded[0]}: its update reduces over whole leaves; "
                f"sharded steps take {BLOCKWISE} (ROADMAP B7b)")

        def gather(params):
            return sh.gather_tree(params, pspecs, shapes, mesh)

    def step_fn(state: TrainState, batch):
        rng = fold_in(state.rng, state.step)
        params = gather(state.params)
        if policy.mode not in BK_MODES:
            grads, aux = accumulated_private_grad(
                apply_fn, params, batch, rng, policy, microbatch,
                state.step, mesh, pspecs)
            del params
            with torch.profiler.record_function("phase4_update"):
                new_p, opt_state = opt.update(grads, state.opt_state,
                                              state.params, state.step)
            return TrainState(new_p, opt_state, state.step + 1,
                              state.rng), aux["loss"]
        sums, aux, B = accumulated_clipped_sum(
            apply_fn, params, batch, policy, microbatch, tape_seed(rng),
            mesh)
        del params
        leaf = noise_leaf_fn(policy, res, rng, float(B), state.step,
                             out="deferred", mesh=mesh, pspecs=pspecs)
        # each clipped sum is dropped as soon as its leaf is updated (its
        # noise is drawn inside the update's pass)
        with torch.profiler.record_function("phase4_update"):
            new_p, opt_state = opt.update_leaves(
                lambda path, p: leaf(path, sums.pop(path)),
                state.opt_state, state.params, state.step)
        return TrainState(new_p, opt_state, state.step + 1,
                          state.rng), aux["loss"]

    return step_fn


# ------------------------------------------------------------ the dry-run grid
# physical (micro) batch of train_4k, the JAX package's (sized there so the
# per-device book-keeping fits a v5e's HBM)
TRAIN_MICROBATCH = {
    # >= data-axis size (16) so the microbatch stays shardable over 'data'
    "llama3-405b": 16, "internvl2-26b": 16, "qwen3-14b": 16,
    "deepseek-moe-16b": 16, "moonshot-v1-16b-a3b": 16,
    "qwen2-1.5b": 32, "qwen2.5-3b": 32, "whisper-small": 32,
    "rwkv6-3b": 16, "hymba-1.5b": 16,
}
TRAIN_OPTIMIZER = {"llama3-405b": "adafactor"}
SUBQUADRATIC = ("ssm", "hybrid")
ALLOC_BLOCK = 512      # the CUDA caching allocator's block granularity


def skip_reason(cfg, shape) -> Optional[str]:
    """Why a cell is not planned (the JAX package's words), or None."""
    if shape.name == "long_500k" and cfg.family not in SUBQUADRATIC:
        return ("full-attention arch: 524k dense-KV decode is quadratic-cost/"
                "unbounded-KV by construction; run only for SSM/hybrid "
                "(DESIGN.md \u00a74)")
    return None


def _blocks(nbytes: int) -> int:
    return -(-int(nbytes) // ALLOC_BLOCK) * ALLOC_BLOCK


def _storages(tree) -> dict:
    """{storage key: bytes} of the tensors in a tree (a TrainState, dicts,
    lists, tuples), each storage once."""
    out = {}

    def walk(x):
        if isinstance(x, TrainState):
            walk((x.params, x.opt_state))
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            out[st._cdata] = st.nbytes()
    walk(tree)
    return out


class LiveBytes(TorchDispatchMode):
    """Counts the storage that ops create while it is on: each new storage
    at its size rounded up to the allocator's block, until it is freed;
    ``peak`` the most live at once. Storages in ``known`` (the arguments at
    rest) are not counted."""

    def __init__(self, known=()):
        super().__init__()
        self.known, self.sizes = set(known), {}
        self.live = self.peak = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                key = st._cdata
                if key in self.known or key in self.sizes:
                    continue
                n = _blocks(st.nbytes())
                self.sizes[key] = n
                self.live += n
                self.peak = max(self.peak, self.live)
                weakref.finalize(st, self._free, key)
        return out

    def _free(self, key):
        self.live -= self.sizes.pop(key, 0)


@dataclass
class CellPlan:
    """One cell for one rank: ``fn(*args)`` is the step the port runs
    there, ``args`` its operands at rest on the meta device (a decode
    cell's last is its position, an int); ``make_args(device, seed)``
    builds them for real (random init from ``seed``, the same
    structure)."""
    arch: str
    shape: str
    kind: str
    fn: Callable
    args: tuple
    make_args: Callable
    mesh: object
    note: str = ""

    def plan(self) -> dict:
        """Run ``fn`` once on the meta device -> {'memory', 'cost',
        'collectives', 'kernels'}. memory: ``argument_bytes`` (the operands
        at rest, exact), ``output_bytes`` (what the step's outputs hold
        that the operands did not), ``temp_bytes`` (the most the step held
        besides its operands, in allocator blocks) and ``peak_bytes`` (the
        operands in blocks plus that). cost: flops, aten's count (torch's
        FlopCounterMode) plus the kernels' own (``kernels.meta``).
        collectives: bytes a rank a step, by kind. kernels: launches a
        step, by wrapper and by C entry (the route)."""
        from torch.utils.flop_counter import FlopCounterMode

        from repro_torch.kernels import meta
        args_at_rest = _storages(self.args)
        self.mesh.traffic = {}
        live = LiveBytes(args_at_rest)
        flop_mode = FlopCounterMode(display=False)
        with meta.recording() as rec, flop_mode, live:
            out = self.fn(*self.args)
            outs = _storages(out)
            del out
        out_bytes = sum(_blocks(n) for k, n in outs.items()
                        if k not in args_at_rest)
        arg_blocks = sum(_blocks(n) for n in args_at_rest.values())
        coll = {k: v for k, v in sorted(self.mesh.traffic.items())}
        coll.setdefault("all_gather", 0)
        coll.setdefault("all_reduce", 0)
        coll["total"] = coll["all_gather"] + coll["all_reduce"]
        aten = int(flop_mode.get_total_flops())
        return {
            "memory": {"argument_bytes": sum(args_at_rest.values()),
                       "output_bytes": out_bytes,
                       "temp_bytes": live.peak,
                       "peak_bytes": arg_blocks + live.peak},
            "cost": {"flops": aten + rec.flops, "aten_flops": aten,
                     "kernel_flops": rec.flops},
            "collectives": coll,
            "kernels": {"launches": dict(sorted(rec.launches.items())),
                        "entries": dict(sorted(rec.entries.items()))},
        }


def plan_cell(arch: str, shape, mesh, dp=None,
              microbatch: Optional[int] = None,
              cfg_patch: Optional[dict] = None,
              optimizer: Optional[str] = None,
              clipping_scope: str = "") -> CellPlan:
    """The cell (``arch`` x ``shape``, a ``configs.base.SHAPES`` name or a
    ``ShapeConfig``) for the rank ``mesh`` is seen from (a
    ``launch.mesh.PlanMesh``), as the port runs it today.

    train: the arch's registered policy under bk-mixopt, else the flat
    DPConfig (``dp`` overrides), re-scoped by ``clipping_scope``;
    ``TRAIN_MICROBATCH`` and ``TRAIN_OPTIMIZER`` (``microbatch``,
    ``optimizer`` override); the port's :func:`make_train_step` over the
    mesh, the state at rest in blocks by ``sharding.state_pspecs``, a step
    gathering whole params (``sharding.gather_tree``) and taking the
    global batch, whose rank rows BK computes. prefill / decode: the rank's
    rows of the global batch over pod x data (sanitized as
    ``sharding.batch_pspecs`` does), whole params and whole caches
    (``init_cache(B, S)``, whisper's with Tf = S), what ``launch.serve``
    runs in each process. A piece the port lacks raises
    ``NotImplementedError`` naming it; a skipped cell ``LookupError``."""
    cfg = registry.get_config(arch)
    if cfg_patch:
        cfg = cfg.with_(**cfg_patch)
    shp = SHAPES[shape] if isinstance(shape, str) else shape
    reason = skip_reason(cfg, shp)
    if reason:
        raise LookupError(reason)
    model = registry.build(cfg)
    params_like = model.init(0, "meta")
    B, T = shp.global_batch, shp.seq_len

    if shp.kind == "train":
        policy_tag = ""
        if dp is None and registry.has_policy(arch):
            dp = registry.get_policy(arch, mode="bk-mixopt", sigma=1.0)
            policy_tag = f" policy={arch}({len(dp.groups)}g)"
        dp = dp or DPConfig(mode="bk-mixopt", clipping="automatic", sigma=1.0)
        if clipping_scope:
            dp = with_scope(dp, clipping_scope)
            policy_tag += f" scope={clipping_scope}"
        mb = microbatch or TRAIN_MICROBATCH.get(arch, 16)
        opt_name = optimizer or TRAIN_OPTIMIZER.get(arch, "adamw")
        opt = make_optimizer(opt_name, lambda step: 1e-4)
        step_fn = make_train_step(model.apply, params_like, opt, dp, mb,
                                  mesh, opt_name)
        specs = sh.state_pspecs(opt_name, params_like, mesh)

        def make_args(device, seed=0):
            if torch.device(device).type == "meta":
                params, batch = params_like, batch_spec(cfg, B, T)
            else:
                params = model.init(seed, device)
                batch = make_batch(cfg, B, T, seed, device=device)
            params = sh.shard_tree(params, specs.params, mesh)
            return (TrainState(params, opt.init(params), 0,
                               prng_key(seed + 1)), batch)

        return CellPlan(arch, shp.name, "train", step_fn, make_args("meta"),
                        make_args, mesh,
                        note=f"dp={as_policy(dp).mode} micro={mb} "
                             f"opt={opt_name}{policy_tag}")

    # serving: the rank's rows of the global batch, whole params and caches
    ba = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
    shards = math.prod(mesh.shape[a] for a in ba)
    rows = B // shards if B % shards == 0 else B
    note = (f"rows={rows} of {B}; whole params and caches a rank (the "
            "model axis is idle in serving until ROADMAP B7b's sharded "
            "caches and tensor-parallel compute)")

    def init_params(device, seed):
        return (params_like if torch.device(device).type == "meta"
                else model.init(seed, device))

    if shp.kind == "prefill":
        def make_args(device, seed=0):
            if torch.device(device).type == "meta":
                batch = batch_spec(cfg, rows, T)
            else:
                batch = make_batch(cfg, rows, T, seed, device=device)
            return (init_params(device, seed), batch)

        def prefill(params, batch):
            with torch.no_grad():
                if cfg.family == "encdec":
                    return model.prefill(params, batch["frames"],
                                         batch["tokens"])
                if cfg.family == "vlm":
                    return model.prefill(params, batch["tokens"],
                                         batch["patches"])
                return model.prefill(params, batch["tokens"])

        return CellPlan(arch, shp.name, "prefill", prefill, make_args("meta"),
                        make_args, mesh, note=note)

    # whisper's decoder positions stop at decoder_len (decode_step raises
    # past it); every other family decodes at the cache's last position
    pos = (cfg.decoder_len if cfg.family == "encdec" else T) - 1

    def make_args(device, seed=0):
        kw = {"Tf": T} if cfg.family == "encdec" else {}
        cache = model.init_cache(rows, T, device=device, **kw)
        if torch.device(device).type == "meta":
            tokens = torch.empty(rows, dtype=torch.int32, device="meta")
        else:
            gen = torch.Generator(device=device)
            gen.manual_seed(seed + 1)
            tokens = torch.randint(0, cfg.vocab, (rows,), generator=gen,
                                   device=device, dtype=torch.int32)
        return (init_params(device, seed), cache, tokens, pos)

    def serve_step(params, cache, tokens, pos):
        with torch.no_grad():
            return model.decode_step(params, cache, tokens, pos)

    return CellPlan(arch, shp.name, "decode", serve_step, make_args("meta"),
                    make_args, mesh, note=note + f"; pos={pos}")
