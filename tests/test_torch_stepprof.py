"""The port's step anatomy against the JAX package's, and its brackets
in the port's training loops.

The same recorded steps, drawn from a numpy seed (phase durations, walls,
batch counts, sampled device times), go into a private
``stepprof.StepProfiler`` of each package: ``shares`` (p50 and total
bases), ``overlap``, ``step_stats`` and ``totals`` must agree to 1e-12
(the same float arithmetic; rtol stated for the summation order), and
``classify`` and ``report`` must give the same verdict labels and the same
report JSON (shares rounded to 4 places) for every share vector. The port
writes its own remediation hints (they name the port's levers), so hints
are not compared.

On the port alone: ``Module.fit`` records one step a batch with the
taxonomy's phases (``h2d``, ``dispatch``, ``opt_update``, ``data_wait``,
``device_compute``) and shares that sum to 1 (1e-9); a Gluon ``Trainer``
brackets each ``step`` with its ``ImplicitStepper`` (``opt_update`` in
it, the user's forward and backward in ``other``); ``_step_scan`` stages
its batches as ``h2d``; with ``MXNET_STEPPROF=1`` the Speedometer line
carries the phase summary.
"""
import io
import json
import logging

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt

PHASES = mxt.stepprof.PHASES


def _recorded(pkg, seed):
    rng = np.random.RandomState(seed)
    prof = pkg.stepprof.StepProfiler(window=64)
    for i in range(40):
        phases = {p: float(rng.exponential(0.01)) for p in PHASES
                  if rng.rand() < 0.8}
        wall = sum(phases.values()) + float(rng.exponential(0.002))
        synced = i % 5 == 0
        batches = int(rng.randint(1, 3))
        prof.record_step(phases, wall, synced=synced, batches=batches)
        if synced:
            prof.note_device_sample(float(rng.exponential(0.02)),
                                    batches=batches)
    return prof


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_shares_overlap_and_stats_match(seed):
    pj, pt = _recorded(mx, seed), _recorded(mxt, seed)
    for basis in ("p50", "total"):
        sj, st = pj.shares(basis), pt.shares(basis)
        assert sj.keys() == st.keys()
        for k in sj:
            assert st[k] == pytest.approx(sj[k], rel=1e-12, abs=1e-15)
        assert sum(st.values()) == pytest.approx(1.0, abs=1e-9)
    for a, b in ((pj.overlap(), pt.overlap()),
                 (pj.step_stats(), pt.step_stats()),
                 (pj.totals(), pt.totals())):
        assert a.keys() == b.keys()
        for k in a:
            if a[k] is None:
                assert b[k] is None
            else:
                assert b[k] == pytest.approx(a[k], rel=1e-12, abs=1e-15)


SHARE_VECTORS = [
    {"data_wait": 0.6, "dispatch": 0.2, "device_compute": 0.2},
    {"dispatch": 0.5, "other": 0.2, "device_compute": 0.3},
    {"sync": 0.7, "device_compute": 0.3},
    {"device_compute": 0.6, "opt_update": 0.3, "h2d": 0.1},
    {"data_wait": 0.25, "dispatch": 0.25, "sync": 0.25,
     "device_compute": 0.25},
    {},
]


@pytest.mark.parametrize("shares", SHARE_VECTORS)
def test_classify_verdicts_match(shares):
    for extras in ({}, {"retraces": 3}, {"fused": False},
                   {"donated": False},
                   {"comm": {"comm_fraction": 0.5,
                             "dominant_kind": "all-reduce"}}):
        vj, _ = mx.stepprof.classify(shares, **extras)
        vt, hint = mxt.stepprof.classify(shares, **extras)
        assert vj == vt
        assert hint


@pytest.mark.parametrize("seed", [0, 1])
def test_report_of_a_snapshot_matches(seed, tmp_path):
    lines = []
    for pkg in (mx, mxt):
        doc = _recorded(pkg, seed).snapshot()
        path = tmp_path / ("%s.json" % pkg.__name__)
        path.write_text(json.dumps(doc))
        out = io.StringIO()
        rc = pkg.stepprof.report(str(path), out=out, json_only=True)
        assert rc == 0
        rec = json.loads(out.getvalue().strip().splitlines()[-1])
        rec.pop("source")
        lines.append(rec)
    assert lines[0] == lines[1]
    assert set(lines[1]) == {"metric", "verdict", "shares"}


def _mlp_module(ctx):
    data = mxt.sym.Variable("data")
    net = mxt.sym.FullyConnected(data, num_hidden=8, name="fc1")
    net = mxt.sym.Activation(net, act_type="relu")
    net = mxt.sym.FullyConnected(net, num_hidden=3, name="fc2")
    net = mxt.sym.SoftmaxOutput(net, name="softmax")
    return mxt.mod.Module(net, context=ctx)


def _iter(n=48, batch=8, seed=0):
    rng = np.random.RandomState(seed)
    return mxt.io.NDArrayIter(rng.rand(n, 5).astype(np.float32),
                              rng.randint(0, 3, n).astype(np.float32),
                              batch_size=batch)


def test_fit_records_one_step_a_batch():
    mxt.stepprof.reset()
    mod = _mlp_module(mxt.cpu())
    mod.fit(_iter(), num_epoch=2, optimizer="sgd")
    stats = mxt.stepprof.profiler.step_stats()
    assert stats["steps"] == 12
    totals = mxt.stepprof.totals()
    for phase in ("h2d", "dispatch", "opt_update", "data_wait",
                  "device_compute", "other"):
        assert totals.get(phase, 0.0) > 0, phase
    assert sum(mxt.stepprof.shares().values()) == pytest.approx(1.0,
                                                                abs=1e-9)
    assert mxt.stepprof.verdict()[0] in ("dispatch-bound", "compute-bound",
                                         "input-bound")
    # batches_per_dispatch: one step a group, staged as h2d
    mxt.stepprof.reset()
    it = _iter(n=48, batch=8)
    mod.fit(it, num_epoch=1, optimizer="sgd", batches_per_dispatch=3,
            force_init=True)
    stats = mxt.stepprof.profiler.step_stats()
    assert stats["steps"] == 2 and stats["batches"] == 6


def test_trainer_implicit_steps():
    mxt.stepprof.reset()
    net = mxt.gluon.nn.Dense(3, in_units=5)
    net.initialize(ctx=mxt.cpu())
    trainer = mxt.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1})
    loss_fn = mxt.gluon.loss.L2Loss()
    x = mxt.nd.ones((4, 5), ctx=mxt.cpu())
    y = mxt.nd.zeros((4, 3), ctx=mxt.cpu())
    for _ in range(4):
        with mxt.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(4)
    stats = mxt.stepprof.profiler.step_stats()
    assert stats["steps"] == 4
    totals = mxt.stepprof.totals()
    assert totals["opt_update"] > 0 and totals["other"] > 0
    assert sum(mxt.stepprof.shares().values()) == pytest.approx(1.0,
                                                                abs=1e-9)


def test_speedometer_phase_summary(monkeypatch, caplog):
    monkeypatch.setitem(mxt.stepprof._cfg, "enabled", True)
    monkeypatch.setitem(mxt.stepprof._cfg, "sync_every", 0)
    mod = _mlp_module(mxt.cpu())
    with caplog.at_level(logging.INFO):
        mod.fit(_iter(n=64), num_epoch=1, optimizer="sgd",
                batch_end_callback=mxt.callback.Speedometer(8, 2))
    lines = [r.getMessage() for r in caplog.records
             if "Speed:" in r.getMessage()]
    assert lines and all("disp" in ln and "goodput" in ln for ln in lines)
