"""DP training driver: data pipeline -> BK clipped sum -> noise +
optimizer, with the privacy ledger, one step at a time.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --steps 3 --batch 8 --seq 512 --sigma 1.0
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
        --steps 4 --epsilon 3 --out summary.json
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
        --optimizer ftrl --restart-every 2 --tree-completion --epsilon 3 \
        --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch deepseek-moe-16b --smoke --device cpu --steps 2
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
        --steps 2 --clipping-scope layer --tape recompute
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
        --steps 2 --mode ghostclip      # or nonprivate, opacus, ...
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch whisper-small --smoke --device cpu --steps 2 --seq 48

``--seq`` is the length of a sample: its tokens, or for whisper
(``encdec``) its audio frames (the decoder reads ``decoder_len`` tokens).

``--epsilon`` calibrates sigma to the (epsilon, delta=1e-5) budget of the
run over ``--dataset-size`` samples (``core.accounting.budget_for``: the
subsampled-Gaussian accountant, or the tree accountant whenever tree noise
runs). ``--optimizer ftrl`` trains with momentum DP-FTRL: the policy's noise
is switched to binary-tree aggregation (depth sized to the run's horizon),
``--restart-every N`` restarts both the optimizer anchor and the noise tree
every N steps, ``--tree-completion`` applies the honest-restart variance
correction at each boundary. Every step is recorded in a
``PrivacyLedger``; the run ends with the epsilon spent, and ``--out`` writes
a JSON summary (steps, the step it resumed from, epsilon, the params'
sha256, the ledger). Losses stay on the device and are drained every
``--log-every`` steps.

Checkpoint and restart: ``--ckpt-dir D --ckpt-every N`` saves a format-2
checkpoint (``checkpoint.checkpoint``: params, optimizer state, the step,
the base key, and the run state of ``checkpoint.run_state`` in its
manifest) every N steps, keeping the newest ``--keep-checkpoints``. The
copy to the host blocks the step; the write runs on a thread. The same
command run again after a SIGKILL, a SIGTERM or a torn write resumes from
the newest valid checkpoint and ends bitwise where the run that never
stopped ends (``params_sha256``), with the same epsilon; a SIGTERM (or a
stalled step) saves the current step and exits 0. ``REPRO_FAULT``
(``runtime.fault_injection``) injects such faults:

    PYTHONPATH=src python -m repro_torch.launch.train --steps 8 \
        --ckpt-dir ck --ckpt-every 2 --out s.json
    REPRO_FAULT=step@5 PYTHONPATH=src python -m repro_torch.launch.train \
        --steps 8 --ckpt-dir ck --ckpt-every 2 --out s.json   # killed
    PYTHONPATH=src python -m repro_torch.launch.train --steps 8 \
        --ckpt-dir ck --ckpt-every 2 --out s.json   # resumes

Runs on the CUDA card by default; ``--device cpu`` runs the same engine with
the kernels' plain PyTorch versions (tests, small configs). Without a card
the default raises instead of falling back to the CPU. ``--autotune
auto|on|off`` (the reference's choices; auto: on the card) is a stated
no-op: the port's kernels take their tiles and grids from the card's
occupancy at launch, so there is nothing to measure, and the driver logs
:data:`AUTOTUNE_NOTE` (0 cells tuned) where the reference would tune.

A mesh of processes: ``--mesh D,M`` (or ``P,D,M``) lays the world out as
(data, model) (or (pod, data, model)) and runs the sharded step
(``launch.steps``: each rank holds its blocks of the params and the
optimizer state, takes its rows of the global batch, one all-reduce a
weighted grad, shard-local noise). Rank, world and local rank come from
the ``torchrun`` environment, or from ``train(..., mesh=, rank=, world=,
init_method=)`` in processes the caller starts:

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh 2,2 \
        --steps 3 --batch 8 --seq 512
    torchrun --nproc-per-node 2 -m repro_torch.launch.train --smoke \
        --device cpu --mesh 2,1 --steps 2

The result is the one-process run's: within float tolerance where the data
axis splits the batch, bitwise where it does not (``--mesh 1,M``), and the
noise is bitwise the one-process noise at every mesh shape. The 'model'
axis shards storage, not compute. NCCL cannot put two ranks on one card:
where a host's ranks outnumber its cards they take gloo. Every rank builds the same
global batch from the seed, records the same ledger and reaches the same
epsilon; rank 0 logs and writes ``--out``. Checkpoints hold each rank's
blocks at their offsets and restore at any world size.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.run_state import (check_resume,
                                              config_fingerprint, pack_meta,
                                              params_digest)
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import (build, cut_depth, get_config,
                                          get_policy, has_policy, list_archs,
                                          list_policies, smoke_config)
from repro_torch.core.accounting import PrivacyLedger, budget_for
from repro_torch.core.bk import DPConfig
from repro_torch.core.engine import ALL_MODES
from repro_torch.core.noise import next_pow2, prng_key
from repro_torch.core.policy import as_policy, with_scope
from repro_torch.core.tape import TAPE_POLICIES
from repro_torch.data.pipeline import Pipeline, PipelineConfig
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import init_distributed, make_mesh, rank_device
from repro_torch.launch.steps import TrainState, make_train_step
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.optim.schedules import make_schedule
from repro_torch.runtime.fault_injection import maybe_fault
from repro_torch.runtime.fault_tolerance import (CheckpointManager,
                                                 Heartbeat, PreemptionGuard)
from repro_torch.utils.tree import flatten, unflatten

OPTIMIZERS = ("sgd", "adamw", "lamb", "adafactor", "ftrl")
AUTOTUNE_NOTE = ("autotune: 0 kernel cells tuned: the port's kernels take "
                 "their tiles and grids from the card's occupancy at launch "
                 "(kernels/csrc), with no block sizes to measure")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; 'cuda' without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port runs on the card by "
            "default; pass --device cpu (device='cpu') to run the plain "
            "PyTorch versions on the CPU")
    return dev


def resolve_dp(arch: str, policy_name: str, mode: str, clipping: str,
               sigma: float, log=print):
    """--policy/--mode/--clipping/--sigma -> DPConfig or PrivacyPolicy."""
    if policy_name == "auto":
        policy_name = arch if has_policy(arch) else ""
    if not policy_name:
        return DPConfig(mode=mode, clipping=clipping, sigma=sigma)
    dp = get_policy(policy_name, mode=mode, sigma=sigma)
    if clipping != "automatic":
        log(f"note: --clipping {clipping} is IGNORED — the policy preset "
            f"{policy_name!r} defines clipping per group (pass --policy '' "
            "for a flat DPConfig)")
    log(f"policy preset {policy_name!r}: "
        + ", ".join(f"{g.name}({g.scope}{'' if g.trainable else ',frozen'}"
                    f" R={g.R})" for g in dp.groups))
    return dp


def train_policy(dp, tc: TrainConfig):
    """``dp`` with the TrainConfig's overrides, as :func:`train` runs it:
    ``tc.tape`` / ``tc.tape_chunks`` replace the tape residency when set,
    and ``tc.clipping_scope`` re-scopes every trainable group
    (``with_scope``; 'layer' makes each param path its own clip unit, and
    the BK backward streams)."""
    if tc.tape or tc.tape_chunks:
        dp = dataclasses.replace(
            dp, **({"tape_policy": tc.tape} if tc.tape else {}),
            **({"tape_chunks": tc.tape_chunks} if tc.tape_chunks else {}))
    return with_scope(dp, tc.clipping_scope) if tc.clipping_scope else dp


def calibrate(dp, tc: TrainConfig, dataset_size: int,
              target_epsilon: float, delta: float, log=print):
    """``dp`` with sigma calibrated to (target_epsilon, delta) over the run
    (``budget_for``), when a budget is asked and the policy sets no sigma.
    Tree releases (DP-FTRL, or any policy with noise='tree') get no
    subsampling amplification: they take the tree accountant."""
    policy = as_policy(dp)
    if not (target_epsilon > 0 and dataset_size > 0 and policy.sigma == 0.0):
        return dp
    tree_release = tc.optimizer == "ftrl" or policy.noise == "tree"
    mechanism = "tree" if tree_release else "sgm"
    budget = budget_for(target_epsilon, delta, tc.global_batch,
                        dataset_size, tc.steps * tc.global_batch
                        / dataset_size, mechanism=mechanism,
                        restart_every=(tc.restart_every
                                       or policy.noise_restart_every))
    log(f"calibrated sigma={budget.sigma:.3f} for eps={budget.epsilon:.2f} "
        f"({mechanism} accountant)")
    if any(g.sigma_scale != 1.0 for g in policy.groups):
        log("WARNING: sigma was calibrated with the FLAT single-sigma "
            "accountant, but this policy sets per-group sigma_scale — the "
            "true joint-bound epsilon differs (larger when any scale < 1). "
            "Re-check with compute_epsilon(resolved.noise_multipliers(), "
            "...).")
    return dataclasses.replace(dp, sigma=budget.sigma)


def ftrl_policy(dp, tc: TrainConfig, log=print):
    """-> (policy, FTRL restart period): the DP-FTRL knobs validated, and
    under ``--optimizer ftrl`` the policy switched to tree noise with depth
    sized to the horizon (a policy that configures tree noise keeps its
    knobs; the optimizer anchor and the noise tree must restart
    together)."""
    if tc.optimizer != "ftrl" and (tc.restart_every or tc.tree_completion
                                   or tc.ftrl_momentum):
        raise ValueError(
            "--restart-every/--tree-completion/--ftrl-momentum are DP-FTRL "
            f"knobs; pass --optimizer ftrl (got {tc.optimizer!r})")
    if tc.tree_completion and tc.restart_every <= 0:
        raise ValueError("--tree-completion corrects the noise at epoch "
                         "boundaries; pass --restart-every N (> 0) with it")
    if tc.optimizer == "ftrl" and tc.lr_schedule != "constant":
        log(f"WARNING: FTRL rescales the WHOLE gradient prefix by the "
            f"current lr — a decaying schedule ({tc.lr_schedule!r}) drags "
            "the iterate back toward its anchor and undoes most of "
            "training. Use lr_schedule='constant' (the CLI driver forces "
            "it for --optimizer ftrl).")
    pol = as_policy(dp)
    if tc.optimizer != "ftrl" or pol.mode == "nonprivate":
        return dp, tc.restart_every
    pol_tree = pol.noise == "tree"
    if pol_tree and pol.noise_restart_every and tc.restart_every and \
            pol.noise_restart_every != tc.restart_every:
        raise ValueError(
            f"policy sets noise_restart_every={pol.noise_restart_every} "
            f"but --restart-every={tc.restart_every}: the FTRL anchor "
            "and the noise tree must restart together")
    restart = tc.restart_every or \
        (pol.noise_restart_every if pol_tree else 0)
    completion = tc.tree_completion or \
        (pol.noise_completion if pol_tree else False)
    horizon = restart if restart > 0 else tc.steps
    depth = (pol.noise_depth if pol_tree and pol.noise_depth
             else max(next_pow2(horizon).bit_length(), 1))
    pol = dataclasses.replace(pol, noise="tree", noise_depth=depth,
                              noise_restart_every=restart,
                              noise_completion=completion)
    log(f"DP-FTRL: tree noise depth={pol.noise_depth} "
        f"restart_every={restart or 'never'} completion={completion}")
    return pol, restart


def _meta_tree(tree) -> dict:
    """A tree's tensors as meta tensors (shapes and dtypes, no memory)."""
    return {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in flatten(tree).items()}


def _mesh_layout(mesh, opt_name, params_like, opt_like, rank: int):
    """-> (layout, blocks) of a rank's checkpoint: {path: (offsets, global
    shape)} of the blocks it writes (the first replica of each), and
    {path: (offsets, local shape)} of the blocks it reads back."""
    specs = sh.state_pspecs(opt_name, unflatten(params_like), mesh)
    layout, blocks = {}, {}
    for prefix, like, sp in (("params", params_like, specs.params),
                             ("opt", flatten(opt_like), specs.opt_state)):
        fs = flatten(sp)
        for path, v in like.items():
            local, offsets = sh.local_block(v.shape, fs[path], mesh)
            key = f"{prefix}/{path}"
            if sh.holds_unique(fs[path], v.shape, mesh):
                layout[key] = (offsets, tuple(v.shape))
            blocks[key] = (offsets, local)
    if rank == 0:
        for key, shape in (("step", ()), ("rng", (2,))):
            layout[key] = ((0,) * len(shape), shape)
    return layout, blocks


def train(model_cfg, tc: TrainConfig, dp, device="cuda", log=print,
          on_step=None, dataset_size: int = 0, target_epsilon: float = 0.0,
          delta: float = 1e-5, summary_out=None, mesh=None, rank=None,
          world=None, init_method=None, digest: bool = True):
    """Run ``tc.steps`` DP steps from a random init (seed ``tc.seed``)
    under ``train_policy(dp, tc)``, sigma calibrated to ``target_epsilon``
    when asked (:func:`calibrate`), DP-FTRL's tree noise under
    ``tc.optimizer == 'ftrl'`` (:func:`ftrl_policy`). Every step is
    recorded in a ``PrivacyLedger``. Losses are drained every
    ``tc.log_every`` steps; ``on_step(step, loss, seconds)``, when given, is
    called after every step, which then drains its loss: the seconds cover
    the step up to its loss on the host (and the blocking part of a save
    at that step). ``summary_out`` (a dict) receives the run's summary,
    with the params' sha256 unless ``digest`` is off (it hashes every
    param's bytes on the host: seconds for a model of tens of GB).

    With ``tc.checkpoint_dir`` set, the run first resumes from the newest
    valid checkpoint there (params, optimizer state, the base key, the
    ledger; the run state checked by ``run_state.check_resume``) at its
    step + 1, saves every ``tc.checkpoint_every`` steps (the host copy
    blocks, the write runs on a thread), and on SIGTERM or a stalled step
    saves the current step and returns; the summary then also has
    ``checkpoints`` (each save's bytes, blocking and writer seconds, the
    restore's seconds).

    ``mesh`` ((data, model) or (pod, data, model) sizes) runs the sharded
    step over the world of processes (``launch.mesh``): ``rank``, ``world``
    and ``init_method`` join it where the caller started the
    processes (else the ``torchrun`` environment). Its product must be the
    world's size. -> (params, losses): the whole params on every rank."""
    dev = resolve_device(device)
    grid, own_group = None, False
    if mesh is not None:
        own_group = not dist.is_initialized()
        rank, world, local = init_distributed(rank, world, init_method, dev)
    try:
        if mesh is not None:
            if math.prod(mesh) != world:
                raise ValueError(f"--mesh {','.join(map(str, mesh))} has "
                                 f"{math.prod(mesh)} places; the world has "
                                 f"{world} processes")
            dev = rank_device(dev, local)
            grid = make_mesh(tuple(mesh), device=dev)
            if grid.rank != 0:
                log = _quiet
            log(f"mesh {grid.shape} over {grid.size} devices")
        return _train(model_cfg, tc, dp, dev, log, on_step, dataset_size,
                      target_epsilon, delta, summary_out, grid, digest)
    finally:
        if own_group:
            dist.destroy_process_group()


def _quiet(*args, **kwargs):
    """A non-zero rank's log: rank 0 speaks for the mesh."""


def _train(model_cfg, tc, dp, dev, log, on_step, dataset_size,
           target_epsilon, delta, summary_out, grid, digest=True):
    """:func:`train` on ``dev``, over the mesh ``grid`` when given."""
    if tc.autotune not in ("auto", "on", "off"):
        raise ValueError(f"autotune must be auto, on or off, got "
                         f"{tc.autotune!r}")
    if tc.autotune == "on" or (tc.autotune == "auto" and dev.type == "cuda"):
        log(AUTOTUNE_NOTE)
    dp = train_policy(dp, tc)
    dp = calibrate(dp, tc, dataset_size, target_epsilon, delta, log)
    dp, ftrl_restart = ftrl_policy(dp, tc, log)
    # check the tree horizon up front for every optimizer, as the reference
    # does (the mechanism's own per-step guard would fire mid-run)
    policy = as_policy(dp)
    if policy.noise == "tree" and policy.noise_depth and \
            not policy.noise_restart_every and \
            tc.steps > (1 << policy.noise_depth) - 1:
        raise ValueError(
            f"noise_depth={policy.noise_depth} covers only "
            f"{(1 << policy.noise_depth) - 1} steps but the run has "
            f"{tc.steps}; raise noise_depth or set restarts")
    # mechanism config errors before the init; the instance also carries
    # the noise state a checkpoint persists
    mech = policy.mechanism()

    model = build(model_cfg)
    opt_kw = ({"momentum": tc.ftrl_momentum, "restart_every": ftrl_restart}
              if tc.optimizer == "ftrl" else {})
    opt = make_optimizer(tc.optimizer,
                         make_schedule(tc.lr_schedule, tc.lr, tc.warmup,
                                       tc.steps),
                         weight_decay=tc.weight_decay, **opt_kw)
    pipe = Pipeline(model_cfg, PipelineConfig(tc.global_batch, tc.seq_len,
                                              seed=tc.seed), device=dev)

    # the privacy ledger: every executed absolute step accounted once
    mech_kind = "tree" if policy.noise == "tree" else "sgm"
    ledger_restart = ftrl_restart or policy.noise_restart_every
    ledger_kw = dict(
        sigma=float(policy.sigma),
        sample_rate=(tc.global_batch / dataset_size if dataset_size > 0
                     else 1.0),
        mechanism=mech_kind, restart_every=ledger_restart,
        participations=(max(1, math.ceil(tc.steps * tc.global_batch
                                         / dataset_size))
                        if dataset_size > 0 else 1))
    ledger = PrivacyLedger()
    fingerprint = config_fingerprint(tc, policy, ftrl_restart)

    guard = PreemptionGuard()

    def on_stall(report):
        # a hung step cannot be checkpointed from here, but if the loop
        # ever returns it saves before it exits instead of running on
        log(report.describe() + "; requesting graceful stop + checkpoint")
        guard.request_stop()

    hb = Heartbeat(timeout_s=600.0, on_stall=on_stall, device=dev)
    mgr = (CheckpointManager(tc.checkpoint_dir, every=tc.checkpoint_every,
                             keep=tc.keep_checkpoints)
           if tc.checkpoint_dir else None)
    try:
        params = model.init(tc.seed, dev)
        params_like, blocks = _meta_tree(params), None
        if grid is not None:
            # every rank builds the same whole init from the seed and keeps
            # its blocks of it
            specs = sh.state_pspecs(tc.optimizer, params, grid)
            params = sh.shard_tree(params, specs.params, grid)
        opt_state = opt.init(params)
        if grid is not None and mgr is not None:
            mgr.layout, blocks = _mesh_layout(
                grid, tc.optimizer, params_like,
                opt.init(unflatten(params_like)), grid.rank)
            mgr.process_index, mgr.process_count = grid.rank, grid.size
            mgr.group = grid.io
        rng, start = prng_key(tc.seed + 1), 0
        if mgr is not None:
            state0, step0, meta0 = mgr.resume(
                template={"params": params, "opt": opt_state,
                          "step": np.asarray(0),
                          "rng": np.asarray(rng, np.uint32)}, device=dev,
                blocks=blocks)
            if state0 is not None:
                # raises on privacy-critical drift; the ledger resumes as
                # it was saved
                ledger = check_resume(meta0, mech, pipe, fingerprint, log=log)
                params, opt_state = state0["params"], state0["opt"]
                # the checkpointed base key: each step folds its absolute
                # index in, so the resumed run replays the same noise
                rng = tuple(int(k) for k in state0["rng"].tolist())
                start = step0 + 1
                log(f"resumed from step {step0} (ledger covers "
                    f"{ledger.recorded_to} steps; restore "
                    f"{mgr.restore_seconds:.3f}s)")
            del state0
        state = TrainState(params, opt_state, start, rng)
        step_fn = make_train_step(model.apply, unflatten(params_like), opt,
                                  dp, tc.microbatch, grid, tc.optimizer)
        del params, opt_state

        def snapshot(s: TrainState, step: int) -> dict:
            return {"params": s.params, "opt": s.opt_state,
                    "step": np.asarray(step),
                    "rng": np.asarray(s.rng, np.uint32)}

        losses, pending = [], []
        log_every = 1 if on_step is not None else max(1, tc.log_every)
        t_flush = time.perf_counter()

        def flush(step: int):
            nonlocal t_flush
            n = len(pending)
            losses.extend(torch.stack(pending).float().tolist())  # waits
            pending.clear()
            dt = (time.perf_counter() - t_flush) / n
            t_flush = time.perf_counter()
            log(f"step {step:5d} loss {losses[-1]:.4f} ({dt:.3f}s/step "
                f"over last {n})")

        for step in range(start, tc.steps):
            maybe_fault("step", step)     # crash / preemption injection
            batch = pipe.batch(step)
            t0 = time.perf_counter()
            state, loss = step_fn(state, batch)
            pending.append(loss.detach())
            hb.beat(step)
            # a resumed run's replayed steps are no-ops (idempotent)
            ledger.record_to(step + 1, **ledger_kw)
            stop = guard.should_stop()
            if grid is not None:         # every rank stops at one step
                stop = grid.any(stop)
            if mgr is not None:
                # the snapshot copies before the next step updates in place
                meta = pack_meta(mech, ledger, pipe, fingerprint)
                saved = mgr.maybe_save(step, snapshot(state, step), meta=meta)
                if stop and not saved:
                    saved = mgr.maybe_save(step, snapshot(state, step),
                                           force=True, meta=meta)
                if saved:
                    log(f"checkpoint step {step}: copied to the host in "
                        f"{mgr.saves[-1]['snapshot_seconds']:.3f}s")
            if stop or (step + 1) % log_every == 0 or step == tc.steps - 1:
                flush(step)
            if on_step is not None:
                on_step(step, losses[-1], time.perf_counter() - t0)
            if stop:
                log(f"preempted at step {step}"
                    + ("; checkpoint saved" if mgr is not None else ""))
                break
        if mgr is not None:
            mgr.wait()
            for rec in mgr.saves:
                log(f"checkpoint step {rec['step']}: {rec['bytes']} bytes "
                    f"written in {rec['writer_seconds']:.3f}s")
    finally:
        hb.close()
        guard.close()
        if mgr is not None:
            mgr.close()

    params = state.params
    if grid is not None:                  # the whole params, on every rank
        params = sh.gather_tree(
            params, sh.flat_param_pspecs(unflatten(params_like), grid),
            {p: tuple(v.shape) for p, v in params_like.items()}, grid)
    epsilon = None
    if policy.mode != "nonprivate" and ledger.recorded_to > 0:
        epsilon = ledger.epsilon(delta)
        log(f"privacy spent: eps={epsilon:.4g} (delta={delta:g}) over "
            f"{ledger.recorded_to} accounted steps "
            f"[{mech_kind}{' restarts' if ledger_restart else ''}]")
    if summary_out is not None:
        summary_out.update({
            "steps_done": ledger.recorded_to,
            "resumed_from": start,
            "epsilon": epsilon,
            "delta": delta,
            "ledger": ledger.to_json(),
        })
        if digest:
            summary_out["params_sha256"] = params_digest(params)
        if grid is not None:
            summary_out["mesh"] = {"shape": dict(grid.shape),
                                   "backend": dist.get_backend()}
        if mgr is not None:
            summary_out["checkpoints"] = {
                "saves": mgr.saves, "restore_seconds": mgr.restore_seconds}
    return params, losses


def cli_args(argv=None):
    """The command line -> (``train``'s keyword arguments, the ``--out``
    path). ``main`` runs ``train(**kwargs)``; a caller that runs the same
    command line in its own process (``chip_smoke.py``) builds the same
    configuration here."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config, float32")
    ap.add_argument("--layers", type=int, default=0,
                    help="the arch at full width cut to this many layers "
                         "(0: all; configs.registry.cut_depth)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw", choices=OPTIMIZERS,
                    help="ftrl: DP-FTRL (tree-aggregation noise, prefix-sum "
                         "iterate, constant lr)")
    ap.add_argument("--ftrl-momentum", type=float, default=0.0,
                    help="DP-FTRL momentum over noisy gradient prefixes")
    ap.add_argument("--restart-every", type=int, default=0,
                    help="DP-FTRL epoch restart period in steps (0 = never); "
                         "restarts the optimizer anchor AND the noise tree")
    ap.add_argument("--tree-completion", action="store_true",
                    help="Honaker completion: advance each epoch's tree to "
                         "the next power of two before restarting")
    ap.add_argument("--mode", default="bk-mixopt", choices=ALL_MODES,
                    help="a BK mode, or a baseline the paper compares "
                         "against (core.engine)")
    ap.add_argument("--clipping", default="automatic")
    ap.add_argument("--sigma", type=float, default=0.0)
    ap.add_argument("--epsilon", type=float, default=0.0,
                    help="target epsilon (delta 1e-5): calibrates sigma "
                         "when --sigma is 0")
    ap.add_argument("--dataset-size", type=int, default=50000,
                    help="samples the run's epochs cover (the sample rate "
                         "is batch / dataset size)")
    ap.add_argument("--policy", default="auto",
                    help="PrivacyPolicy preset name; 'auto' = the arch's "
                         f"registered preset (known: {list_policies()}), "
                         "'' = flat DPConfig")
    ap.add_argument("--autotune", choices=["auto", "on", "off"],
                    default="auto",
                    help="the reference's measured kernel-block autotune "
                         "(auto = on the card): logs that 0 cells are "
                         "tuned, the port's kernels size their launches "
                         "from the card's occupancy")
    ap.add_argument("--tape", default="", choices=("",) + TAPE_POLICIES,
                    help="tape residency of the book-kept tap state between "
                         "BK phases 2-3: hold native, compressed (bf16, "
                         "int8), re-derive in phase 3 (recompute), or let "
                         "the planner pick per tap (auto); '' keeps the "
                         "policy's")
    ap.add_argument("--tape-chunks", type=int, default=0,
                    help="phase-3 re-derivation chunks of the recompute "
                         "taps of one clip unit (0 keeps the policy's)")
    ap.add_argument("--clipping-scope", default="",
                    choices=["", "flat", "group", "layer"],
                    help="re-scope every trainable group's clipping norm: "
                         "flat (one pool), group (per policy group), layer "
                         "(each param path its own clip unit, streamed); "
                         "'' keeps the policy's scopes")
    ap.add_argument("--log-every", type=int, default=10,
                    help="loss log + device->host flush period in steps")
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint directory: resume from its newest "
                         "valid checkpoint, save into it (every "
                         "--ckpt-every steps, and on SIGTERM)")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="checkpoint period in steps (0 = only on SIGTERM "
                         "or a stall)")
    ap.add_argument("--keep-checkpoints", type=int, default=3,
                    help="the newest checkpoints kept in --ckpt-dir")
    ap.add_argument("--out", default="",
                    help="write a json run summary (steps done, the step "
                         "it resumed from, epsilon, params sha256, ledger)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--mesh", default="",
                    help="data,model (or pod,data,model) axis sizes of a "
                         "mesh over the world of processes (torchrun); "
                         "'' runs on one device")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    mesh = None
    if args.mesh:
        try:
            mesh = tuple(int(x) for x in args.mesh.split(","))
        except ValueError:
            ap.error(f"--mesh wants 'data,model' ints, got {args.mesh!r}")
        if len(mesh) not in (2, 3) or min(mesh) < 1:
            ap.error(f"--mesh wants 2 or 3 positive sizes, got {args.mesh!r}")

    mc = cut_depth(smoke_config(args.arch) if args.smoke
                   else get_config(args.arch), args.layers)
    if args.smoke:
        mc = mc.with_(param_dtype="float32")
    tc = TrainConfig(global_batch=args.batch, microbatch=args.microbatch,
                     seq_len=args.seq, steps=args.steps, lr=args.lr,
                     optimizer=args.optimizer,
                     # FTRL rescales the whole prefix by lr_t: a decay
                     # would pull the iterate back toward the anchor
                     lr_schedule=("constant" if args.optimizer == "ftrl"
                                  else TrainConfig.lr_schedule),
                     ftrl_momentum=args.ftrl_momentum,
                     restart_every=args.restart_every,
                     tree_completion=args.tree_completion, seed=args.seed,
                     log_every=args.log_every, tape=args.tape,
                     tape_chunks=args.tape_chunks,
                     clipping_scope=args.clipping_scope,
                     autotune=args.autotune,
                     checkpoint_dir=args.ckpt_dir,
                     checkpoint_every=args.ckpt_every,
                     keep_checkpoints=args.keep_checkpoints)
    dp = resolve_dp(args.arch, args.policy, args.mode, args.clipping,
                    args.sigma)
    extra = {"mesh": mesh} if mesh else {}
    return dict(model_cfg=mc, tc=tc, dp=dp, device=args.device,
                dataset_size=args.dataset_size,
                target_epsilon=args.epsilon, **extra), args.out


def main(argv=None):
    kwargs, out_path = cli_args(argv)
    summary = {} if out_path else None
    out = train(**kwargs, summary_out=summary)
    # on a mesh rank 0 writes the summary (every rank holds the same)
    if out_path and int(os.environ.get("RANK", 0)) == 0:
        with open(out_path, "w") as f:
            json.dump(summary, f, indent=2)
        print(f"summary written to {out_path}")
    return out


if __name__ == "__main__":
    main()
