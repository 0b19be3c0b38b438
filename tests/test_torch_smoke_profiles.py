"""``chip_smoke.py``'s profile processes, rehearsed on the CPU (no JAX).

Phase 24c's profiles (a training step of the Gluon LSTM LM and one
replay of its hybridized call) run in a process of their own,
``python3 chip_smoke.py --lstm-profile`` (ROADMAP C.14): late in the
whole script's process the tracer lost K1's kernels in a replay. Here
``lstm_profile_main`` runs at toy widths on ``cpu()`` with the profilers
stubbed (there is no card): it prints one JSON line with the fields
phase 24c reads, the hybridized call counted one K1 call a layer by the
wrapper's counter only on the card (0 here).
"""
import json

import numpy as np
import pytest

import chip_smoke
import mxnet_tpu_torch as mxt


@pytest.fixture
def toy(monkeypatch):
    for name, value in (("VOCAB", 40), ("EMBED", 8), ("HIDDEN", 8),
                        ("SEQ", 5), ("TRAIN_BATCH", 3)):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(mxt, "gpu", lambda i=0: mxt.cpu())
    calls = []

    def device_profile(fn, attempts=1, complete=None):
        calls.append("device")
        fn()
        return 1.0, {}

    def call_profile(fn):
        calls.append("call")
        fn()
        return {"wall_ms": 1.0, "device_busy_ms": None,
                "runtime_calls": {}}
    monkeypatch.setattr(chip_smoke, "device_profile", device_profile)
    monkeypatch.setattr(chip_smoke, "call_profile", call_profile)
    yield calls
    mxt.compiled.reset()       # the toy net's programs leave no counts


def test_lstm_profile_main_prints_phase_24c_fields(toy, capsys):
    assert chip_smoke.lstm_profile_main() == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(row) == ["k1_counted_profiled_replay",
                           "k1_kernels_in_a_replay", "replay", "train"]
    assert sorted(row["train"]) == ["device_busy_ms", "device_idle_share",
                                    "k2", "k3", "profiled_step_wall_ms"]
    assert row["replay"]["runtime_calls"] == {}
    assert row["k1_counted_profiled_replay"] == 0     # the CPU: no kernel
    assert toy == ["device", "call", "device"]
    assert np.isfinite(row["train"]["profiled_step_wall_ms"])

