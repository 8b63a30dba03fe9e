"""Privacy accounting: RDP of the Sampled Gaussian Mechanism (Mironov et al.
2019) + conversion to (eps, delta)-DP, sigma calibration, the tree-aggregation
(DP-FTRL) accountant and the restart-safe spent-budget ledger (counterpart
of ``repro/core/accounting.py``, function for function).

Pure numpy/scipy on the host (it runs at config time, not in the training
step). The training loop derives ``sigma`` from (target_epsilon, delta,
sample_rate, steps), the paper's Section 1.3 pipeline: accounting is
independent of the clipping threshold R. A ledger's JSON (``to_json``) reads
back in either package.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
from scipy.special import gammaln

DEFAULT_ORDERS = tuple([1.25, 1.5, 1.75, 2.0, 2.5, 3.0, 4.0, 5.0, 6.0, 8.0]
                       + list(range(10, 64))
                       + [72, 96, 128, 256, 512])


def _log_binom(n: int, k: np.ndarray) -> np.ndarray:
    return gammaln(n + 1) - gammaln(k + 1) - gammaln(n - k + 1)


def _log_a_int(q: float, sigma: float, alpha: int) -> float:
    """log A(alpha) for integer alpha >= 2 (Mironov et al. 2019, Sec 3.3)."""
    k = np.arange(alpha + 1, dtype=np.float64)
    terms = (_log_binom(alpha, k)
             + k * math.log(q)
             + (alpha - k) * math.log1p(-q)
             + (k * k - k) / (2.0 * sigma * sigma))
    m = terms.max()
    return float(m + np.log(np.sum(np.exp(terms - m))))


def _log_a_frac(q: float, sigma: float, alpha: float) -> float:
    """Fractional alpha via quadrature of
    A(alpha) = E_{z~N(0,s^2)} [((1-q) + q e^{(2z-1)/(2s^2)})^alpha]."""
    from scipy.integrate import quad

    s2 = sigma * sigma

    def integrand(z):
        logratio = np.logaddexp(math.log1p(-q),
                                math.log(q) + (2.0 * z - 1.0) / (2.0 * s2))
        log_f = (alpha * logratio - z * z / (2.0 * s2)
                 - 0.5 * math.log(2.0 * math.pi * s2))
        return np.exp(log_f)

    val, _ = quad(integrand, -np.inf, np.inf, limit=200)
    return float(np.log(val))


def rdp_sgm(q: float, sigma: float, alpha: float) -> float:
    """RDP epsilon of one SGM step at order alpha."""
    if q == 0.0:
        return 0.0
    if sigma == 0.0:
        return float("inf")
    if q == 1.0:
        return alpha / (2.0 * sigma * sigma)
    if float(alpha).is_integer():
        log_a = _log_a_int(q, sigma, int(alpha))
    else:
        log_a = _log_a_frac(q, sigma, alpha)
    return log_a / (alpha - 1.0)


def rdp_to_eps(rdp: np.ndarray, orders: np.ndarray, delta: float) -> float:
    """Improved RDP->(eps,delta) conversion (Balle et al. 2020, as in Opacus)."""
    orders = np.asarray(orders, dtype=np.float64)
    rdp = np.asarray(rdp, dtype=np.float64)
    eps = (rdp
           - (math.log(delta) + np.log(orders)) / (orders - 1.0)
           + np.log1p(-1.0 / orders))
    eps = np.where(np.isnan(eps), np.inf, eps)
    return float(max(0.0, np.min(eps)))


def compose_sensitivity(Rs) -> float:
    """L2 sensitivity of one sample's clipped contribution under group-wise
    clipping: each clipping unit bounds its slice of the per-sample gradient
    by R_u on disjoint coordinates, so the vector norm composes as
    sqrt(sum_u R_u^2) (He et al. 2022). A single flat unit recovers R."""
    return math.sqrt(sum(float(R) ** 2 for R in Rs))


def effective_sigma(sigmas) -> float:
    """Joint noise multiplier of heterogeneous per-group Gaussians
    (He et al. 2022 §4): group g's coordinates carry noise sigma_g * R_g
    with per-group sensitivity R_g on disjoint coordinate blocks, so the
    mean shift between neighbouring outputs reduces (along its own
    direction) to ONE Gaussian with multiplier
    (sum_g sigma_g^-2)^(-1/2). Uniform sigmas over k groups give
    sigma/sqrt(k) — per-group noise at the group's own sensitivity is
    strictly weaker than flat noise at the composed sensitivity, which is
    exactly why the joint accounting (not the flat bound) must be used."""
    sigmas = [float(s) for s in sigmas]
    if not sigmas:
        raise ValueError(
            "no noise multipliers to compose — the policy resolved to zero "
            "trainable clip units (all groups frozen?); there is no "
            "mechanism to account for")
    if any(s <= 0.0 for s in sigmas):
        return 0.0
    return sum(s ** -2 for s in sigmas) ** -0.5


def rdp_sgm_heterogeneous(q: float, sigmas, alpha: float) -> float:
    """RDP of ONE subsampled step releasing k per-group Gaussians on
    disjoint coordinate blocks with multipliers sigma_g (each relative to
    its own group's sensitivity).

    The per-group Gaussian RDP curves compose at the BASE-mechanism level:
    independent noise on disjoint blocks adds Renyi divergences,
    sum_g alpha/(2 sigma_g^2) = alpha/(2 effective_sigma^2), i.e. the block
    release is Renyi-identical to one Gaussian at ``effective_sigma``. The
    subsampling event is SHARED by every group (one batch draw), so the
    standard SGM curve then applies to that single equivalent Gaussian.
    (Composing k separately-subsampled per-group SGM curves instead would
    count the amplification k times and UNDER-report epsilon — invalid for
    the shared-batch mechanism this engine runs.)
    """
    return rdp_sgm(q, effective_sigma(sigmas), alpha)


@dataclass(frozen=True)
class PrivacyBudget:
    epsilon: float
    delta: float
    sigma: float
    sample_rate: float
    steps: int
    mechanism: str = "sgm"       # 'sgm' (subsampled Gaussian) | 'tree'


# ------------------------------------------------------------ spent-budget ledger
@dataclass(frozen=True)
class LedgerEntry:
    """One contiguous run segment accounted at fixed mechanism parameters."""
    steps: int
    sigma: float
    sample_rate: float
    mechanism: str = "sgm"       # 'sgm' | 'tree'
    restart_every: int = 0       # tree only
    participations: int = 1      # tree only

    def same_release(self, other: "LedgerEntry") -> bool:
        return (self.sigma, self.sample_rate, self.mechanism,
                self.restart_every) == \
               (other.sigma, other.sample_rate, other.mechanism,
                other.restart_every)


class PrivacyLedger:
    """Restart-safe spent-budget ledger.

    The ledger records which ABSOLUTE training steps have been accounted
    (``recorded_to`` = steps [0, recorded_to) are covered) together with the
    mechanism parameters in force over each contiguous segment. It is
    persisted inside every checkpoint (``checkpoint.run_state``) and resumed
    verbatim, so a mid-run restart reports epsilon for the WHOLE run, never
    "as if the run had just begun".

    ``record_to(step_end, ...)`` is idempotent over replayed steps: a crash
    after step k ran but before a checkpoint recorded it means the resumed
    run re-executes step k — but because every noise draw in this engine is
    a pure function of (seed, step) (counter-based Gaussian draws, fixed
    tree-node seeds), the re-executed step releases BITWISE the same
    randomness as the lost one. The adversary's view is identical to the
    uninterrupted run's, so counting each absolute step exactly once is the
    exact accounting, with neither leakage (no fresh noise reuse against a
    second query) nor double-counting (no budget charged twice for one
    release). Re-recording an already-covered range is therefore a no-op.

    Composition: 'sgm' segments compose additively in RDP (heterogeneous
    sigma across segments is honest composition). Contiguous 'tree'
    segments with identical (sigma, restart_every) are MERGED before
    accounting — they are one continued tree release whose node count grows
    with the total horizon (splitting them would re-count the shared
    near-root nodes); parameter changes start a new release, composed
    additively (an upper bound).
    """

    VERSION = 1

    def __init__(self, entries=(), recorded_to: int = 0):
        self.entries = [e if isinstance(e, LedgerEntry) else LedgerEntry(**e)
                        for e in entries]
        self.recorded_to = int(recorded_to)
        if sum(e.steps for e in self.entries) != self.recorded_to:
            raise ValueError(
                f"ledger entries cover {sum(e.steps for e in self.entries)} "
                f"steps but recorded_to={self.recorded_to}")

    def record_to(self, step_end: int, sigma: float, sample_rate: float,
                  mechanism: str = "sgm", restart_every: int = 0,
                  participations: int = 1) -> int:
        """Account steps [recorded_to, step_end); returns how many were new.
        ``step_end <= recorded_to`` (a replay after restart) is a no-op."""
        if mechanism not in ("sgm", "tree"):
            raise ValueError(f"unknown ledger mechanism {mechanism!r}")
        delta = int(step_end) - self.recorded_to
        if delta <= 0:
            return 0
        entry = LedgerEntry(delta, float(sigma), float(sample_rate),
                            mechanism, int(restart_every),
                            int(participations))
        if self.entries and self.entries[-1].same_release(entry):
            last = self.entries[-1]
            self.entries[-1] = LedgerEntry(
                last.steps + delta, last.sigma, last.sample_rate,
                last.mechanism, last.restart_every,
                max(last.participations, entry.participations))
        else:
            self.entries.append(entry)
        self.recorded_to = int(step_end)
        return delta

    def epsilon(self, delta: float, orders=DEFAULT_ORDERS) -> float:
        """(eps, delta) spent over every recorded step, composing segment
        RDP curves at shared orders and converting once."""
        if not self.entries:
            return 0.0
        orders = np.asarray(orders, dtype=np.float64)
        rdp = np.zeros_like(orders)
        for e in self._merged():
            if e.sigma <= 0.0:
                return float("inf")
            if e.mechanism == "tree":
                m = tree_node_count(e.steps, e.restart_every,
                                    e.participations)
                rdp = rdp + orders * m / (2.0 * e.sigma * e.sigma)
            else:
                rdp = rdp + np.array(
                    [e.steps * rdp_sgm(e.sample_rate, e.sigma, a)
                     for a in orders])
        return rdp_to_eps(rdp, orders, delta)

    def _merged(self):
        """Entries with contiguous same-release tree segments fused (the
        constructor/record_to already fuse; kept for from_json of hand-built
        histories)."""
        out = []
        for e in self.entries:
            if out and e.mechanism == "tree" and out[-1].same_release(e):
                last = out[-1]
                out[-1] = LedgerEntry(last.steps + e.steps, last.sigma,
                                      last.sample_rate, last.mechanism,
                                      last.restart_every,
                                      max(last.participations,
                                          e.participations))
            else:
                out.append(e)
        return out

    def to_json(self) -> dict:
        return {"version": self.VERSION, "recorded_to": self.recorded_to,
                "entries": [vars(e) for e in self.entries]}

    @classmethod
    def from_json(cls, data) -> "PrivacyLedger":
        if data is None:
            return cls()
        if int(data.get("version", 0)) != cls.VERSION:
            raise ValueError(
                f"unknown ledger version {data.get('version')!r} "
                f"(this build reads version {cls.VERSION})")
        return cls(entries=data.get("entries", ()),
                   recorded_to=data.get("recorded_to", 0))


# ------------------------------------------------- tree-aggregation accountant
def tree_node_count(steps: int, restart_every: int = 0,
                    participations: int = 1) -> int:
    """Max number of released tree nodes one sample's contributions touch.

    DP-FTRL (Kairouz et al. 2021) releases every binary-tree node sum, each
    perturbed with N(0, (sigma*S)^2). Each of a sample's ``participations``
    (its TOTAL appearances across the whole run — the number of data passes)
    lands in one leaf, whose root path touches at most the tree height
    h = floor(log2(next_pow2(E))) + 1 nodes, so the L2 sensitivity of the
    node-vector release is sqrt(m) * S with

        m <= participations * h_per_tree

    regardless of how the appearances distribute over restart epochs (paths
    in distinct trees are disjoint; multiple paths in one tree only overlap
    near the root, so the product is an upper bound either way). Restarts
    only shrink h — from the full-run tree's height to the epoch tree's —
    which is why restart-per-pass is the canonical multi-epoch setup.
    Honaker completion adds no nodes: the completed nodes are already
    counted by the full-tree height."""
    from repro_torch.core.noise import next_pow2
    if steps <= 0:
        return 0
    horizon = restart_every if restart_every and restart_every > 0 else steps
    height = int(math.log2(next_pow2(horizon))) + 1
    return height * max(1, participations)


def compute_epsilon_tree(sigma: float, steps: int, delta: float,
                         restart_every: int = 0, participations: int = 1,
                         orders=DEFAULT_ORDERS) -> float:
    """(eps, delta) of the DP-FTRL tree-aggregation release.

    The full release (all node sums, each at noise sigma*S) is ONE Gaussian
    mechanism over a vector with L2 sensitivity sqrt(m)*S where m =
    ``tree_node_count`` — Gaussian RDP alpha*m/(2 sigma^2), converted with
    the same Balle et al. machinery as the SGM curve. No sampling assumption
    and no amplification: the bound holds for arbitrary (adversarial) data
    order, which is DP-FTRL's point."""
    if sigma <= 0.0:
        return float("inf")
    m = tree_node_count(steps, restart_every, participations)
    if m == 0:
        return 0.0
    orders = np.asarray(orders, dtype=np.float64)
    rdp = orders * m / (2.0 * sigma * sigma)
    return rdp_to_eps(rdp, orders, delta)


def calibrate_sigma_tree(target_epsilon: float, steps: int, delta: float,
                         restart_every: int = 0, participations: int = 1,
                         orders=DEFAULT_ORDERS, tol: float = 1e-3) -> float:
    """Smallest sigma achieving eps <= target under tree aggregation."""
    lo, hi = 0.1, 1.0
    eps = lambda s: compute_epsilon_tree(s, steps, delta, restart_every,
                                         participations, orders)
    while eps(hi) > target_epsilon:
        hi *= 2.0
        if hi > 1e6:
            raise ValueError("cannot reach target epsilon")
    while eps(lo) < target_epsilon:
        lo /= 2.0
        if lo < 1e-6:
            return lo
    while hi - lo > tol:
        mid = 0.5 * (lo + hi)
        if eps(mid) > target_epsilon:
            lo = mid
        else:
            hi = mid
    return hi


def compute_epsilon(sigma, sample_rate: float, steps: int,
                    delta: float, orders=DEFAULT_ORDERS) -> float:
    """(eps, delta) after ``steps`` SGM compositions.

    ``sigma`` is either one noise multiplier (the flat scheme) or a sequence
    of per-group multipliers — ``ResolvedPolicy.noise_multipliers()`` — in
    which case the heterogeneous joint bound is composed. With every
    sigma_scale at 1.0 the multiplier list is sigma * S/R_u per unit and the
    joint bound reproduces the flat single-sigma bound exactly."""
    if np.ndim(sigma) > 0:
        rdp = np.array([steps * rdp_sgm_heterogeneous(sample_rate, sigma, a)
                        for a in orders])
    else:
        rdp = np.array([steps * rdp_sgm(sample_rate, float(sigma), a)
                        for a in orders])
    return rdp_to_eps(rdp, np.array(orders), delta)


def calibrate_sigma(target_epsilon: float, sample_rate: float, steps: int,
                    delta: float, orders=DEFAULT_ORDERS,
                    tol: float = 1e-3) -> float:
    """Smallest sigma achieving eps <= target, via bisection."""
    lo, hi = 0.1, 1.0
    while compute_epsilon(hi, sample_rate, steps, delta, orders) > target_epsilon:
        hi *= 2.0
        if hi > 1e4:
            raise ValueError("cannot reach target epsilon")
    while compute_epsilon(lo, sample_rate, steps, delta, orders) < target_epsilon:
        lo /= 2.0
        if lo < 1e-6:
            return lo
    while hi - lo > tol:
        mid = 0.5 * (lo + hi)
        if compute_epsilon(mid, sample_rate, steps, delta, orders) > target_epsilon:
            lo = mid
        else:
            hi = mid
    return hi


def budget_for(target_epsilon: float, delta: float, batch_size: int,
               dataset_size: int, epochs: float, mechanism: str = "sgm",
               restart_every: int = 0) -> PrivacyBudget:
    """The PrivacyEngine entry point, mirroring the paper's Sec. 4 API.

    ``mechanism='sgm'`` (default) calibrates against the subsampled-Gaussian
    curve — DP-SGD with Poisson-style sampling. ``mechanism='tree'``
    calibrates against the tree-aggregation release (DP-FTRL: no sampling
    assumption, no amplification) with the FTRL restart period; the sample's
    participation count is the number of data passes (>= 1)."""
    q = batch_size / dataset_size
    steps = int(math.ceil(epochs * dataset_size / batch_size))
    if mechanism == "tree":
        participations = max(1, int(math.ceil(epochs)))
        sigma = calibrate_sigma_tree(target_epsilon, steps, delta,
                                     restart_every, participations)
        eps = compute_epsilon_tree(sigma, steps, delta, restart_every,
                                   participations)
    elif mechanism == "sgm":
        sigma = calibrate_sigma(target_epsilon, q, steps, delta)
        eps = compute_epsilon(sigma, q, steps, delta)
    else:
        raise ValueError(f"unknown accounting mechanism {mechanism!r}; "
                         "options: 'sgm', 'tree'")
    return PrivacyBudget(eps, delta, sigma, q, steps, mechanism)
