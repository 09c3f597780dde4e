"""The control plane (blades_tpu_torch/control) against the JAX package's
(blades_tpu/control), and under the port's driver.

The same row streams, fed through each package's watchdog and controller,
give identical event lists and identical journals (``ControlAction``
dicts, exact: the policy is pure host arithmetic).  A CPU async MLP
trial with forensics, the resident ledger and control, preempted after
two cycles and resumed from its checkpoint, writes the rows and ends on
the parameters of a straight run, bit for bit.
"""

import json

import numpy as np
import pytest
import torch

from blades_tpu.control import Controller as JaxController
from blades_tpu.control import ControlPolicy as JaxPolicy
from blades_tpu.control import rederive_action as jax_rederive
from blades_tpu.obs.watchdog import Watchdog as JaxWatchdog
from blades_tpu_torch.control import Controller, ControlPolicy, rederive_action
from blades_tpu_torch.obs.watchdog import Watchdog

N_CLIENTS = 40


def _rows(seed, rounds=40):
    """A controlled run's row stream: async ingest sensors that stall and
    run away, detection that collapses, reputations that sag, and the
    cohort each row diagnosed."""
    rng = np.random.default_rng(seed)
    for r in range(1, rounds + 1):
        ids = rng.choice(N_CLIENTS, size=8, replace=False)
        flagged = ids[rng.random(8) < 0.4]
        yield {
            "training_iteration": r, "tick": 5 * r,
            "train_loss": float(rng.normal()) if r != 23 else float("nan"),
            "agg_norm": float(rng.gamma(2.0)),
            "update_norm_mean": float(rng.gamma(2.0)
                                      * (30.0 if r % 13 == 0 else 1.0)),
            "staleness_max": int(rng.integers(0, 90)),
            "cycle_ticks": int(rng.integers(2, 6) * (9 if r % 7 == 0 else 1)),
            "updates_per_sec": float(rng.gamma(5.0)
                                     / (20.0 if r % 11 == 0 else 1.0)),
            "byz_fpr": float(rng.random()),
            "reputation_p50": float(1.0 / (1 + (r % 9 == 0) * 5)),
            "flagged_churn": int(rng.integers(0, 3) * (6 if r % 10 == 0
                                                       else 1)),
            "ledger_top_suspects": [int(c) for c in
                                    rng.choice(N_CLIENTS, 5, replace=False)],
            "timers": {"training_step": {"total_s": 0.1 * r * (
                1 + (r == 30) * 9), "mean_s": 0.1, "count": r}},
        }, ids, flagged


POLICIES = [
    {},
    {"cooldown_rounds": 2, "quarantine_rounds": 3, "quarantine_max": 3},
    {"rules": {"ingest_stall": "off", "round_time_regression": "buffer",
               "staleness_runaway": "window"}, "min_window": 2},
]


def _drive(controller_cls, watchdog_cls, policy, rows, engine=True):
    vals = dict(agg_every=8, buffer_capacity=16, weight_cutoff=4,
                window=8) if engine else {}
    ctl = controller_cls(policy, num_clients=N_CLIENTS, **vals)
    wd = watchdog_cls()
    events, journal = [], []
    for row, ids, flagged in rows:
        ev = [e.as_dict() for e in wd.observe(row)]
        events.append(ev)
        acts = ctl.step(round_idx=row["training_iteration"],
                        tick=row["tick"], events=ev,
                        suspects=row["ledger_top_suspects"],
                        participants=ids, flagged=flagged)
        journal.append([a.as_dict() for a in acts])
    return events, journal, ctl


@pytest.mark.parametrize("engine", [True, False], ids=["async", "sync"])
@pytest.mark.parametrize("pi", range(len(POLICIES)))
@pytest.mark.parametrize("seed", [0, 1])
def test_same_rows_same_events_and_journal(seed, pi, engine):
    spec = POLICIES[pi]
    rows = list(_rows(seed))
    jev, jj, jc = _drive(JaxController, JaxWatchdog,
                         JaxPolicy.from_config(spec), rows, engine)
    tev, tj, tc = _drive(Controller, Watchdog,
                         ControlPolicy.from_config(spec), rows, engine)
    assert tev == jev
    assert tj == jj
    assert any(tj) and any(tev)
    assert tc.state() == jc.state()
    assert tc.summary() == jc.summary()
    # Every journaled action re-derives from its own record in both.
    policy = ControlPolicy.from_config(spec)
    for row, acts in zip(rows, tj):
        for act in acts:
            kw = dict(suspects=row[0]["ledger_top_suspects"],
                      num_clients=N_CLIENTS)
            assert rederive_action(policy, act, **kw) == act
            assert jax_rederive(JaxPolicy.from_config(spec), act,
                                **kw) == act


def test_state_round_trips_mid_stream():
    """Checkpoint the watchdog and controller half way (through JSON, as
    a checkpoint holds them), restore into fresh ones: the rest of the
    journal is the straight run's."""
    policy = ControlPolicy.from_config(POLICIES[1])
    rows = list(_rows(3))
    _, straight, _ = _drive(Controller, Watchdog, policy, rows)
    ctl = Controller(policy, num_clients=N_CLIENTS, agg_every=8,
                     buffer_capacity=16, weight_cutoff=4, window=8)
    wd = Watchdog()
    got = []
    for i, (row, ids, flagged) in enumerate(rows):
        if i == 20:
            saved = json.loads(json.dumps({"w": wd.state(),
                                           "c": ctl.state()}))
            ctl = Controller(policy, num_clients=N_CLIENTS)
            ctl.restore(saved["c"])
            wd = Watchdog()
            wd.restore_state(saved["w"])
        ev = [e.as_dict() for e in wd.observe(row)]
        got.append([a.as_dict() for a in ctl.step(
            round_idx=row["training_iteration"], tick=row["tick"],
            events=ev, suspects=row["ledger_top_suspects"],
            participants=ids, flagged=flagged)])
    assert got == straight


@pytest.mark.parametrize("spec", [
    {"bogus": 1}, {"rules": {"fpr_collapse": "explode"}},
    {"cooldown_rounds": 0}, {"agg_every_factor": 1},
    {"max_quarantine_fraction": 0.0}, {"min_window": 0},
])
def test_bad_policies_raise_like_jax(spec):
    with pytest.raises(ValueError) as jexc:
        JaxPolicy.from_config(spec)
    with pytest.raises(ValueError) as texc:
        ControlPolicy.from_config(spec)
    assert str(texc.value) == str(jexc.value)


# ---------------------------------------------------------------------------
# the driver: config pairs and kill-and-resume
# ---------------------------------------------------------------------------

MLP = {"dataset_config": {"type": "mnist", "num_clients": 12, "train_bs": 8},
       "global_model": "mlp", "evaluation_interval": 2,
       "num_malicious_clients": 2, "adversary_config": {"type": "ALIE"},
       "server_config": {"lr": 1.0, "aggregator": {"type": "Trimmedmean"}}}
ASYNC = {**MLP, "execution": "async",
         "async_config": {"rate": 0.5, "agg_every": 6,
                          "buffer_capacity": 12},
         "forensics": True, "ledger": True,
         "control_config": {"cooldown_rounds": 1, "quarantine_rounds": 2,
                            "rules": {"fpr_collapse": "quarantine"}}}


@pytest.mark.parametrize("override", [
    {"control_config": {"enabled": True}, "rounds_per_dispatch": 2},
    {"control_config": {"enabled": True}, "execution": "streamed"},
    {"control_config": {"enabled": True}},
    {**{k: ASYNC[k] for k in ("execution", "async_config",
                              "control_config")}, "forensics": True},
    {**{k: ASYNC[k] for k in ("execution", "async_config",
                              "control_config", "forensics", "ledger")},
     "control_config": {"max_quarantine_fraction": 0.9}},
    {**{k: ASYNC[k] for k in ("execution", "async_config")},
     "state_store": "host", "control_config": {"quarantine_rounds": 0}},
    {"forensics": True, "execution": "streamed"},
    {"ledger_dir": "/nonexistent"},
    {"ledger": "ram"},
    {"watchdog_rules": [{"name": "a", "kind": "spike", "field": "nope"}]},
    {"forensics": True, "codec_config": {"type": "quant", "bits": 8},
     "agg_domain": "wire"},
], ids=["dispatch", "streamed", "sync-quarantine", "no-ledger",
        "fraction", "ooc-moves", "forensics-streamed", "ledger-dir",
        "ledger-name", "rule-field", "wire"])
def test_refused_pairs_raise_the_jax_error(override):
    from blades_tpu.algorithms import FedavgConfig as JaxConfig
    from blades_tpu_torch.algorithms.config import FedavgConfig

    cfg = {**MLP, **override}
    with pytest.raises(ValueError) as jexc:
        JaxConfig().update_from_dict(cfg).validate()
    with pytest.raises(ValueError) as texc:
        FedavgConfig().update_from_dict(cfg).validate()
    want = str(jexc.value).replace("×", "x")
    assert str(texc.value).replace("×", "x") == want


def _result_rows(tdir):
    drop = ("timers", "updates_per_sec")
    return [{k: v for k, v in json.loads(line).items() if k not in drop}
            for line in (tdir / "result.json").read_text().splitlines()]


def test_async_control_kill_and_resume_equals_straight(tmp_path):
    from blades_tpu_torch.tune import run_experiments
    from blades_tpu_torch.tune.sweep import verify_result_rounds

    exp = {"ctl": {"run": "FEDAVG", "stop": {"training_iteration": 4},
                   "config": ASYNC}}
    kw = dict(device="cpu", verbose=0, checkpoint_freq=1)
    straight = run_experiments(exp, storage_path=str(tmp_path / "a"), **kw)
    killed = run_experiments(exp, storage_path=str(tmp_path / "b"),
                             preempt_after=2, max_failures=1, **kw)
    ta, tb = (tmp_path / r / "ctl" / "ctl_00000" for r in ("a", "b"))
    assert verify_result_rounds(tb / "result.json") == [1, 2, 3, 4]
    rows_a, rows_b = _result_rows(ta), _result_rows(tb)
    assert rows_a == rows_b
    assert sum(len(r["control_actions"]) for r in rows_a) > 0
    # The driver watchdog's event count covers the rows since the last
    # restore (its rolling windows ride the checkpoint, its event log
    # does not, as in the JAX package); the rows carry every event.
    ctl_a, ctl_b = ({k: v for k, v in s[0]["control"].items()
                     if k != "watchdog_events"} for s in (straight, killed))
    assert ctl_a == ctl_b
    assert straight[0]["ledger"] == killed[0]["ledger"]
    pa = torch.load(ta / "ckpt_000004" / "algorithm_state.pkl",
                    weights_only=False)["state"].server.params
    pb = torch.load(tb / "ckpt_000004" / "algorithm_state.pkl",
                    weights_only=False)["state"].server.params
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    # The preemption dumped the flight recorder (a later watchdog event
    # may dump over it); both packages' validators read the dump.
    from blades_tpu.obs.flightrec import validate_flightrec as jax_valid
    from blades_tpu_torch.obs.flightrec import validate_flightrec

    assert killed[0]["flightrec"]["dumps"] > straight[0].get(
        "flightrec", {}).get("dumps", 0)
    for valid in (validate_flightrec, jax_valid):
        num, errors = valid(tb / "flightrec.json")
        assert num >= 1 and errors == []
    assert (tb / "ckpt_000004" / "ledger" / "manifest.json").exists()
