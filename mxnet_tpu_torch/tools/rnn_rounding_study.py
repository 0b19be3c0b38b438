"""How far f32 runs of 2 bucketed steps of the 2x650 word LM lie from the
same steps in f64, from trained weights, on a machine with a CUDA card.

    python3 mxnet_tpu_torch/tools/rnn_rounding_study.py [--states 6] \
        [--seed 0]

It trains the bucketed LM as ``chip_smoke.py`` phase 24a does (Python's
``random`` and numpy's global generator seeded with ``--seed``, which
order the iterator's batches), then, for each of ``--states`` trained
states (one more epoch on the card between two), runs phase 24b's
trained-weight case (``chip_smoke.trained_witness``): the same 2 steps
over the two shortest buckets on gpu(0), on cpu() in f32, on gpu(0) with
K2, K3 and U1 in their plain versions, on cpu() in f64, and the control
(the card with its last step dropped). It prints one JSON line a state
with each parameter's readings, then over the states the largest ratios
of the distances to the f64 run (the card over its plain path, the
plain path over the CPU, the card over the CPU; each distance at least
``FLOOR``), the largest card distance, the smallest margin of the
control over the card (``chip_smoke.RNN_CONTROL`` bounds it), and the
number of states in which the CPU's f32 run lies outside phase 8's
limits of the f64 run.
"""
import argparse
import json
import os
import random
import sys

import numpy as np
import torch

# distances to the f64 run under this are f32's rounding of the result
FLOOR = 1e-7
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--states", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rnn_rounding_study: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    counters = {k: getattr(mx.ops, k) for k in (
        "fused_lstm", "fused_lstm_train", "lstm_bwd_recurrence",
        "multi_tensor_update")}
    random.seed(args.seed)
    np.random.seed(args.seed)
    mod, it, _ = cs.phase_rnn_lm(mx, counters,
                                 np.random.RandomState(cs.SEED + 24))
    it.reset()
    picked = {}
    for batch in it:
        if batch.bucket_key in cs.RNN_BUCKETS[:2]:
            picked.setdefault(batch.bucket_key, batch)
        if len(picked) == 2:
            break
    batches = [picked[k] for k in sorted(picked)]
    worst = {"card_vs_plain": 0.0, "plain_vs_cpu": 0.0, "card_vs_cpu": 0.0,
             "control_margin": float("inf"), "card_vs_f64_rel": 0.0,
             "states_cpu_outside_phase8_limits_of_f64": 0}
    for state in range(args.states):
        trained = {n: a.asnumpy() for n, a in mod.get_params()[0].items()}
        _, witness = cs.trained_witness(mx, counters, trained, batches)
        print(json.dumps({"state": state, "params": witness}), flush=True)
        for w in witness.values():
            card, plain, cpu = (max(w[k + "_vs_f64_rel"], FLOOR)
                                for k in ("card", "plain_card", "cpu"))
            for key, r in (("card_vs_plain", card / plain),
                           ("plain_vs_cpu", plain / cpu),
                           ("card_vs_cpu", card / cpu),
                           ("card_vs_f64_rel", w["card_vs_f64_rel"])):
                worst[key] = max(worst[key], r)
            worst["control_margin"] = min(
                worst["control_margin"],
                w["control_vs_f64_rel"] / max(w["card_vs_f64_rel"], 1e-30))
        worst["states_cpu_outside_phase8_limits_of_f64"] += not all(
            w["cpu_within_phase8_limits_of_f64"] for w in witness.values())
        it.reset()
        for batch in it:
            mod.forward_backward(batch)
            mod.update()
    print(json.dumps({"states": args.states, "seed": args.seed,
                      "worst": worst, "control_limit": cs.RNN_CONTROL}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
