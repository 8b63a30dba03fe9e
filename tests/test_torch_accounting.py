"""The port's accountant (``repro_torch.core.accounting``) against the JAX
package's ``repro.core.accounting``, function by function, on a small grid
of (q, sigma, alpha, steps, delta, restarts, participations): both are the
same numpy/scipy on the host, so every result must be equal (==). The
ledger's assertions of tests/test_accounting.py on the port, and a ledger's
JSON read back in the other package, both ways."""
import json

import numpy as np
import pytest

from repro.core import accounting as ja
from repro_torch.core import accounting as ta

QS = (0.004, 0.01, 0.1, 0.5, 1.0, 0.0)
SIGMAS = (0.0, 0.7, 1.0, 2.0)
ALPHAS = (1.25, 2.5, 4.0, 16.0, 72.0)
DELTAS = (1e-5, 1e-6)


def test_orders_are_the_reference_orders():
    assert ta.DEFAULT_ORDERS == ja.DEFAULT_ORDERS


@pytest.mark.parametrize("q", [q for q in QS if 0.0 < q < 1.0])
@pytest.mark.parametrize("sigma", [s for s in SIGMAS if s > 0.0])
def test_log_a_int_and_frac(q, sigma):
    for alpha in (2, 4, 16):
        assert ta._log_a_int(q, sigma, alpha) == ja._log_a_int(q, sigma,
                                                               alpha)
    for alpha in (1.25, 2.5):
        assert ta._log_a_frac(q, sigma, alpha) == ja._log_a_frac(q, sigma,
                                                                 alpha)


@pytest.mark.parametrize("q", QS)
@pytest.mark.parametrize("sigma", SIGMAS)
def test_rdp_sgm(q, sigma):
    for alpha in ALPHAS:
        assert ta.rdp_sgm(q, sigma, alpha) == ja.rdp_sgm(q, sigma, alpha)


@pytest.mark.parametrize("delta", DELTAS)
def test_rdp_to_eps(delta):
    orders = np.asarray(ja.DEFAULT_ORDERS)
    for sigma, q, steps in ((1.0, 0.01, 100), (0.7, 0.1, 10), (2.0, 1.0, 1)):
        rdp = steps * np.array([ja.rdp_sgm(q, sigma, a) for a in orders])
        assert ta.rdp_to_eps(rdp, orders, delta) == \
            ja.rdp_to_eps(rdp, orders, delta)
    nan = np.full(len(orders), np.nan)
    assert ta.rdp_to_eps(nan, orders, delta) == \
        ja.rdp_to_eps(nan, orders, delta) == float("inf")


def test_sensitivity_and_heterogeneous_sigma():
    for rs in ([1.0], [0.5, 1.0, 2.0], [3.0, 4.0]):
        assert ta.compose_sensitivity(rs) == ja.compose_sensitivity(rs)
    for sigmas in ([1.0], [1.0, 1.0, 1.0, 1.0], [0.5, 2.0], [1.0, 0.0]):
        assert ta.effective_sigma(sigmas) == ja.effective_sigma(sigmas)
        for alpha in (2.5, 8.0):
            assert ta.rdp_sgm_heterogeneous(0.01, sigmas, alpha) == \
                ja.rdp_sgm_heterogeneous(0.01, sigmas, alpha)
    for mod in (ta, ja):
        with pytest.raises(ValueError, match="zero"):
            mod.effective_sigma([])


@pytest.mark.parametrize("steps", [0, 1, 5, 8, 100])
@pytest.mark.parametrize("restart_every", [0, 2, 16])
@pytest.mark.parametrize("participations", [1, 3])
def test_tree_node_count_and_epsilon(steps, restart_every, participations):
    assert ta.tree_node_count(steps, restart_every, participations) == \
        ja.tree_node_count(steps, restart_every, participations)
    for sigma in SIGMAS:
        for delta in DELTAS:
            args = (sigma, steps, delta, restart_every, participations)
            assert ta.compute_epsilon_tree(*args) == \
                ja.compute_epsilon_tree(*args)


@pytest.mark.parametrize("sigma", [0.7, 2.0, [1.0, 0.5], [1.0, 1.0, 1.0]])
@pytest.mark.parametrize("q,steps", [(0.01, 100), (0.1, 10), (1.0, 1)])
def test_compute_epsilon(sigma, q, steps):
    assert ta.compute_epsilon(sigma, q, steps, 1e-5) == \
        ja.compute_epsilon(sigma, q, steps, 1e-5)


def test_calibration_and_budget():
    """The two bisections and budget_for (both mechanisms, the unknown one
    refused), few calibrations: each is ~50 accountant evaluations."""
    assert ta.calibrate_sigma(3.0, 0.01, 200, 1e-5) == \
        ja.calibrate_sigma(3.0, 0.01, 200, 1e-5)
    assert ta.calibrate_sigma_tree(3.0, 64, 1e-5, 16, 2) == \
        ja.calibrate_sigma_tree(3.0, 64, 1e-5, 16, 2)
    for mech, restart in (("sgm", 0), ("tree", 2)):
        got = ta.budget_for(3.0, 1e-5, 8, 50000, 4 * 8 / 50000,
                            mechanism=mech, restart_every=restart)
        want = ja.budget_for(3.0, 1e-5, 8, 50000, 4 * 8 / 50000,
                             mechanism=mech, restart_every=restart)
        assert type(got).__name__ == type(want).__name__ == "PrivacyBudget"
        assert vars(got) == vars(want)
    with pytest.raises(ValueError, match="mechanism"):
        ta.budget_for(3.0, 1e-5, 64, 50000, 1.0, mechanism="nope")


# ------------------------------------------------------------------ ledger
def _history(mod):
    led = mod.PrivacyLedger()
    led.record_to(10, sigma=1.0, sample_rate=0.1)
    led.record_to(30, sigma=0.5, sample_rate=0.1)
    led.record_to(70, sigma=2.0, sample_rate=1.0, mechanism="tree",
                  restart_every=16, participations=2)
    led.record_to(94, sigma=2.0, sample_rate=1.0, mechanism="tree",
                  restart_every=16, participations=3)
    return led


def test_ledger_matches_reference():
    got, want = _history(ta), _history(ja)
    assert got.recorded_to == want.recorded_to == 94
    assert [vars(e) for e in got.entries] == [vars(e) for e in want.entries]
    assert got.epsilon(1e-5) == want.epsilon(1e-5)
    assert [vars(e) for e in got._merged()] == \
        [vars(e) for e in want._merged()]


def test_ledger_replay_is_idempotent():
    led = ta.PrivacyLedger()
    led.record_to(100, sigma=1.0, sample_rate=0.01)
    eps = led.epsilon(1e-5)
    assert led.record_to(80, sigma=1.0, sample_rate=0.01) == 0
    assert led.record_to(100, sigma=1.0, sample_rate=0.01) == 0
    assert led.epsilon(1e-5) == eps
    assert led.record_to(120, sigma=1.0, sample_rate=0.01) == 20
    assert led.epsilon(1e-5) > eps
    with pytest.raises(ValueError, match="mechanism"):
        led.record_to(130, sigma=1.0, sample_rate=0.01, mechanism="nope")


def test_ledger_tree_segments_merge_as_one_release():
    kw = dict(sample_rate=1.0, mechanism="tree", restart_every=16)
    whole = ta.PrivacyLedger()
    whole.record_to(64, sigma=2.0, **kw)
    split = ta.PrivacyLedger()
    split.record_to(40, sigma=2.0, **kw)
    split.record_to(64, sigma=2.0, **kw)
    assert split.epsilon(1e-5) == whole.epsilon(1e-5)
    # hand-built split histories merge in _merged
    built = ta.PrivacyLedger(entries=[dict(steps=40, sigma=2.0, **kw),
                                      dict(steps=24, sigma=2.0, **kw)],
                             recorded_to=64)
    assert len(built.entries) == 2 and len(built._merged()) == 1
    assert built.epsilon(1e-5) == whole.epsilon(1e-5)
    hetero = ta.PrivacyLedger()
    hetero.record_to(40, sigma=2.0, **kw)
    hetero.record_to(64, sigma=1.0, **kw)
    assert hetero.epsilon(1e-5) > whole.epsilon(1e-5)
    assert len(hetero.entries) == 2


def test_ledger_version_gate_and_coverage():
    led = _history(ta)
    back = ta.PrivacyLedger.from_json(json.loads(json.dumps(led.to_json())))
    assert back.recorded_to == 94 and back.entries == led.entries
    assert ta.PrivacyLedger.from_json(None).recorded_to == 0
    with pytest.raises(ValueError, match="version"):
        ta.PrivacyLedger.from_json({"version": 99})
    with pytest.raises(ValueError, match="cover"):
        ta.PrivacyLedger(entries=[{"steps": 5, "sigma": 1.0,
                                   "sample_rate": 0.1}], recorded_to=9)


def test_ledger_zero_sigma_is_infinite():
    led = ta.PrivacyLedger()
    assert led.epsilon(1e-5) == 0.0
    led.record_to(5, sigma=0.0, sample_rate=0.1)
    assert led.epsilon(1e-5) == float("inf")


@pytest.mark.parametrize("src,dst", [(ta, ja), (ja, ta)])
def test_ledger_json_reads_back_in_the_other_package(src, dst):
    """What one package's ``to_json`` writes (through a JSON file's text),
    the other's ``from_json`` reads: the same entries, the same epsilon."""
    led = _history(src)
    text = json.dumps(led.to_json())
    back = dst.PrivacyLedger.from_json(json.loads(text))
    assert back.recorded_to == led.recorded_to
    assert [vars(e) for e in back.entries] == [vars(e) for e in led.entries]
    assert back.epsilon(1e-5) == led.epsilon(1e-5)
    assert json.dumps(back.to_json()) == text
