"""PrivacyPolicy: the per-parameter-group DP API.

A policy is an ordered list of :class:`ParamGroup` rules matched against the
flattened param paths (first match wins). Each group carries its own
clipping fn + threshold R, a norm *scope*, an optional ghost-vs-direct
override for ``kernels.dispatch``, a noise scale, and a trainable flag:

  scope='flat'   the group joins the shared flat pool: ONE per-sample norm
                 over every flat-scope param, one clip factor (all flat
                 groups must agree on clipping/R/gamma/sigma_scale).
  scope='group'  the group is its own clipping unit: its own per-sample norm
                 and its own C_i^(g) = clip(||g_i^(g)||; R_g).
  scope='layer'  EVERY trainable param path the group matches becomes its
                 own clipping unit, named ``<group>:<path>`` (per-layer
                 clipping). Each unit's norm closes over a single tap's
                 cotangent, so the BK engine STREAMS it: norm, clip factor
                 and weighted grad are emitted at the tap and nothing is
                 held between phases 2 and 3 (``core.bk``). A stacked path
                 (``blocks/attn/qkv/w``) is one unit over all its layers.
  tape           per-group residency override for the group's tap records
                 ('' = the policy's ``tape_policy``; ``core.tape``).
  sigma_scale    heterogeneous per-group noise: the noise std on the
                 group's coordinates is sigma * sigma_scale * S, S the
                 composed sensitivity below (1.0: the flat scheme).
  trainable=False
                 the group's params are constants: no taps, no norm, no
                 weighted grad, no noise; grads come back as zeros.

The L2 sensitivity of one sample's clipped contribution composes as
sqrt(sum_u R_u^2) over the non-empty trainable units
(``accounting.compose_sensitivity``); the noise mechanism
(``PrivacyPolicy.noise``: 'gaussian' or 'tree', ``core.noise``) scales each
group's leaves by sigma * sigma_scale_g times that.

A bare :class:`repro_torch.core.bk.DPConfig` lowers to a single-group flat
policy via :func:`as_policy`.
"""
from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.core.accounting import compose_sensitivity
from repro_torch.core.clipping import get_clip_fn
from repro_torch.core.tape import TAPE_POLICIES

SCOPES = ("flat", "group", "layer")
METHODS = ("", "ghost", "direct")
TAPES = ("",) + TAPE_POLICIES


@dataclass(frozen=True)
class ParamGroup:
    """One ordered matching rule over flattened param paths."""
    name: str
    match: str                       # path prefix, or regex (fullmatch)
    clipping: str = "automatic"      # clipping fn name (core.clipping)
    R: float = 1.0                   # per-group clipping threshold R_g
    scope: str = "flat"              # 'flat' | 'group' | 'layer' (norm scope)
    gamma: float = 0.01              # automatic-clipping stability constant
    trainable: bool = True           # False = frozen (no taps / grads / noise)
    method: str = ""                 # '' | 'ghost' | 'direct' dispatch override
    sigma_scale: float = 1.0         # noise std multiplier vs the flat scheme
    tape: str = ""                   # tape residency override ('' = the
                                     # policy default; core.tape)

    def __post_init__(self):
        if self.scope not in SCOPES:
            raise ValueError(f"group {self.name!r}: scope must be one of "
                             f"{SCOPES}, got {self.scope!r}")
        if self.method not in METHODS:
            raise ValueError(f"group {self.name!r}: method must be one of "
                             f"{METHODS}, got {self.method!r}")
        if self.tape not in TAPES:
            raise ValueError(f"group {self.name!r}: tape must be one of "
                             f"{TAPES}, got {self.tape!r}")
        if self.sigma_scale <= 0.0:
            raise ValueError(f"group {self.name!r}: sigma_scale must be > 0 "
                             f"(got {self.sigma_scale}); use trainable=False "
                             "to exempt params from noise")

    def matches(self, path: str) -> bool:
        if path == self.match or path.startswith(self.match + "/"):
            return True
        try:
            return re.fullmatch(self.match, path) is not None
        except re.error:
            return False


@dataclass(frozen=True)
class PrivacyPolicy:
    """Ordered ParamGroup rules + the engine-level knobs."""
    groups: tuple                    # tuple[ParamGroup, ...], first match wins
    mode: str = "bk"                 # 'bk' | 'bk-mixghost' | 'bk-mixopt'
    sigma: float = 0.0               # noise multiplier (0 = clipping only)
    noise: str = "gaussian"          # noise mechanism name (core.noise)
    noise_seed: int = 0              # node-noise seed of the tree mechanism
    noise_depth: int = 0             # tree depth (0 = the mechanism default)
    noise_restart_every: int = 0     # tree epoch restarts, in steps (0 = off)
    noise_completion: bool = False   # honest-restart (Honaker) completion
    use_kernels: bool = True         # CUDA kernels (plain torch if False)
    tape_policy: str = "native"      # default tape residency of every tap
                                     # (core.tape.TAPE_POLICIES; 'auto' lets
                                     # kernels.dispatch.tape_plan pick)
    tape_chunks: int = 1             # phase-3 re-derivation chunks of the
                                     # 'recompute' taps of one unit

    def __post_init__(self):
        if not self.groups:
            raise ValueError("policy needs at least one ParamGroup")
        if self.tape_policy not in TAPE_POLICIES:
            raise ValueError(f"tape_policy must be one of {TAPE_POLICIES}, "
                             f"got {self.tape_policy!r}")
        if self.tape_chunks < 1:
            raise ValueError(f"tape_chunks must be >= 1 "
                             f"(got {self.tape_chunks})")
        names = [g.name for g in self.groups]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate group names: {names}")
        if (self.noise_restart_every or self.noise_completion) \
                and self.noise != "tree":
            # per-step independent noise has no tree to restart or complete
            raise ValueError(
                "noise_restart_every/noise_completion require noise='tree' "
                f"(got noise={self.noise!r})")
        if self.noise_completion and self.noise_restart_every <= 0:
            raise ValueError(
                "noise_completion corrects the noise at epoch boundaries — "
                "set noise_restart_every > 0 (the optimizer's restart "
                "period) alongside it")

    def mechanism(self):
        from repro_torch.core.noise import get_mechanism
        return get_mechanism(self.noise, seed=self.noise_seed,
                             depth=self.noise_depth,
                             restart_every=self.noise_restart_every,
                             completion=self.noise_completion)


def as_policy(cfg) -> PrivacyPolicy:
    """DPConfig -> equivalent single-group flat policy; policies pass through."""
    if isinstance(cfg, PrivacyPolicy):
        return cfg
    return PrivacyPolicy(
        groups=(ParamGroup("all", ".*", clipping=cfg.clipping, R=cfg.R,
                           scope="flat", gamma=cfg.gamma),),
        mode=cfg.mode, sigma=cfg.sigma, use_kernels=cfg.use_kernels,
        tape_policy=cfg.tape_policy, tape_chunks=cfg.tape_chunks)


def with_scope(cfg, scope: str) -> PrivacyPolicy:
    """Re-scope a DPConfig / PrivacyPolicy: every TRAINABLE group's norm
    scope becomes ``scope`` (frozen groups have no norm and are untouched);
    each group keeps its clipping, R, gamma and sigma_scale. '' returns the policy as
    it is. The ``--clipping-scope`` CLI flag routes here."""
    policy = as_policy(cfg)
    if not scope:
        return policy
    if scope not in SCOPES:
        raise ValueError(f"clipping scope must be one of {SCOPES}, "
                         f"got {scope!r}")
    groups = tuple(dataclasses.replace(g, scope=scope) if g.trainable else g
                   for g in policy.groups)
    return dataclasses.replace(policy, groups=groups)


# ------------------------------------------------------------------ resolution
@dataclass(frozen=True)
class ClipUnit:
    """One clipping unit: a per-sample norm accumulator + clip factor C_i."""
    name: str
    clipping: str
    R: float
    gamma: float
    paths: tuple                     # member param paths (sorted)
    sigma_scale: float = 1.0         # noise std multiplier vs the flat scheme

    def clip_fn(self) -> Callable:
        kw = {"gamma": self.gamma} if self.clipping == "automatic" else {}
        return get_clip_fn(self.clipping, self.R, **kw)


@dataclass(frozen=True)
class ResolvedPolicy:
    """A policy bound to a concrete set of param paths."""
    policy: PrivacyPolicy
    units: tuple                     # tuple[ClipUnit, ...]
    unit_of: dict                    # path -> unit index (trainable paths only)
    group_of: dict                   # path -> ParamGroup (every path)
    frozen: frozenset                # paths of non-trainable groups
    sensitivity: float               # sqrt(sum_u R_u^2) over non-empty units

    def method_for(self, path: str) -> str:
        return self.group_of[path].method

    @property
    def heterogeneous(self) -> bool:
        return any(u.sigma_scale != 1.0 for u in self.units)

    def noise_scales(self) -> dict:
        """Per-trainable-path noise std multiplier on sigma: sigma_scale_u
        times the composed sensitivity (all 1.0: sigma * S everywhere)."""
        return {p: self.units[u].sigma_scale * self.sensitivity
                for p, u in self.unit_of.items()}

    def noise_multipliers(self) -> list:
        """Per-unit Gaussian noise multipliers relative to each unit's own
        sensitivity R_u: what privacy accounting composes."""
        sigma = self.policy.sigma
        return [sigma * u.sigma_scale * self.sensitivity / u.R
                for u in self.units]


def resolve_policy(policy: PrivacyPolicy, param_paths) -> ResolvedPolicy:
    """Bind a policy to the flattened param paths. The ordered groups must
    form a true partition: unmatched paths raise."""
    param_paths = sorted(param_paths)
    group_of, members = {}, {g.name: [] for g in policy.groups}
    unmatched = []
    for path in param_paths:
        for g in policy.groups:
            if g.matches(path):
                group_of[path] = g
                members[g.name].append(path)
                break
        else:
            unmatched.append(path)
    if unmatched:
        raise ValueError(
            "params matched no policy group (add a catch-all rule such as "
            f"ParamGroup('rest', '.*')): {unmatched}")
    flat_groups = [g for g in policy.groups
                   if g.trainable and g.scope == "flat" and members[g.name]]
    for g in flat_groups[1:]:
        ref = flat_groups[0]
        if (g.clipping, g.R, g.gamma, g.sigma_scale) != \
                (ref.clipping, ref.R, ref.gamma, ref.sigma_scale):
            raise ValueError(
                "flat-scope groups share ONE norm pool and so must agree on "
                f"(clipping, R, gamma, sigma_scale): {ref.name!r} vs "
                f"{g.name!r}")

    units, unit_of = [], {}
    if flat_groups:
        ref = flat_groups[0]
        paths = sorted(p for g in flat_groups for p in members[g.name])
        name = ref.name if len(flat_groups) == 1 else "flat"
        units.append(ClipUnit(name, ref.clipping, ref.R, ref.gamma,
                              tuple(paths), ref.sigma_scale))
        for p in paths:
            unit_of[p] = 0
    for g in policy.groups:
        if not (g.trainable and members[g.name]):
            continue
        if g.scope == "group":
            units.append(ClipUnit(g.name, g.clipping, g.R, g.gamma,
                                  tuple(members[g.name]), g.sigma_scale))
            for p in members[g.name]:
                unit_of[p] = len(units) - 1
        elif g.scope == "layer":
            # one single-path unit per member; the name carries the path so
            # group_norms stay addressable per layer
            for p in members[g.name]:
                units.append(ClipUnit(f"{g.name}:{p}", g.clipping, g.R,
                                      g.gamma, (p,), g.sigma_scale))
                unit_of[p] = len(units) - 1

    frozen = frozenset(p for p in param_paths if not group_of[p].trainable)
    return ResolvedPolicy(policy=policy, units=tuple(units), unit_of=unit_of,
                          group_of=group_of, frozen=frozen,
                          sensitivity=compose_sensitivity(
                              [u.R for u in units]))


def unit_clip_factors(res: ResolvedPolicy, sq):
    """Per-unit per-sample sq norms -> ([norms_u], [C_u]) — phase 2's tail."""
    norms = [torch.sqrt(s) for s in sq]
    C = [unit.clip_fn()(n).to(torch.float32)
         for unit, n in zip(res.units, norms)]
    return norms, C


def norm_aux(res: ResolvedPolicy, losses, sq, unit_norms, unit_C) -> dict:
    """The aux dict: ``per_sample_norms`` is the total norm across units;
    single-unit policies also keep ``clip_factors``."""
    aux = {"loss": losses.mean(),
           "per_sample_norms": (unit_norms[0] if len(res.units) == 1
                                else torch.sqrt(sum(sq))),
           "group_norms": {u.name: n for u, n in zip(res.units, unit_norms)},
           "group_clip_factors": {u.name: c
                                  for u, c in zip(res.units, unit_C)}}
    if len(res.units) == 1:
        aux["clip_factors"] = unit_C[0]
    return aux


def finalize_noise(policy: PrivacyPolicy, res: ResolvedPolicy,
                   flat_sums: dict, rng, denom: float, step=None) -> dict:
    """Phase 4 over a whole flat dict of clipped sums, for the modes that
    hold every leaf at once (the baselines): :func:`noise_leaf_fn` leaf for
    leaf, so every mode draws the same noise for the same (rng, step,
    path). Frozen leaves pass through."""
    leaf = noise_leaf_fn(policy, res, rng, denom, step)
    return {p: leaf(p, g) for p, g in flat_sums.items()}


def noise_leaf_fn(policy: PrivacyPolicy, res: ResolvedPolicy, rng,
                  denom: float, step=None, out: str = "new"):
    """Per-leaf phase 4: -> fn(path, g_sum) -> private grad leaf.

    The policy's noise mechanism (``core.noise``) under the key ``rng``
    (a (k0, k1) pair) at ``step``, each leaf scaled by its unit's
    sigma_scale * composed sensitivity (a homogeneous policy passes the bare
    composed sensitivity). On a CUDA leaf the draw and the add are one
    ``counter_noise`` launch; ``out="inplace"`` lets it write over the sum
    (the caller drops it). ``out="deferred"`` returns a noised leaf as a
    ``core.noise.NoisedLeaf`` instead: ``Optimizer.update_leaves`` draws it
    inside its one pass over the leaf (``kernels.noise_update``), so only
    one leaf's update is live at a time and no noised copy is written.
    Frozen leaves pass through."""
    from repro_torch.core.noise import _scale_for
    mech = policy.mechanism()
    scales = res.noise_scales() if res.heterogeneous else res.sensitivity

    def leaf(path: str, g):
        if path in res.frozen:
            return g
        return mech.add_leaf(path, g.contiguous(), rng, policy.sigma,
                             _scale_for(scales, path), denom, step=step,
                             out=out)

    return leaf
