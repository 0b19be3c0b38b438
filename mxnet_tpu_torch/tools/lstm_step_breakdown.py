"""Where a step of the persistent LSTM kernel goes, on a machine with nvcc
and a CUDA card.

    python3 mxnet_tpu_torch/tools/lstm_step_breakdown.py [--batches 1,8,32,64]

Builds ``csrc/fused_lstm.cu`` (K1) against variants of
``csrc/lstm_persistent.cuh``, each with one edit:

- ``as built``: the header unchanged;
- ``8 warps``: 8 warps a block instead of 16;
- ``staging not overlapped``: each warp waits for every row group's copy
  before its first item, not only for its own group's;
- ``no product loop``: the k loop of the gate product removed;
- ``no staging``: no copy of h_{t-1} into shared memory (nor its waits);
- ``no grid barrier``: the grid-wide barrier between steps replaced by a
  block barrier.

It times the recurrence kernel alone (``x @ Wx + b`` precomputed) at
T=35, I=H=650 and each batch, with CUDA events over 50 calls after 3,
and prints one JSON line per variant and batch: µs a step and the largest
difference of hseq from the build as built (0 for the variants that keep
the function; the others compute something else and are timings only).
The variants compile in parallel into a temporary directory.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(ROOT))

from mxnet_tpu_torch.ops import _build, lstm_kernel  # noqa: E402

T, H = 35, 650


def _edit(text, old, new):
    if old not in text:
        raise SystemExit("the header no longer has %r" % old)
    return text.replace(old, new)


def variants(text):
    wait = "if (t > 0) mbar_wait(bar0 + 8 * rg, (phases >> rg) & 1u);"
    copy = "} else if (tid == 0) {  // one bulk copy per 8-row group"
    loop = "for (int c = lane; c < nchunk; c += kLanes) {"
    sync = "if (t + 1 < T) cooperative_groups::this_grid().sync();"
    return {
        "as built": text,
        "8 warps": _edit(text, "constexpr int kPWarps = 16;",
                         "constexpr int kPWarps = 8;"),
        "staging not overlapped": _edit(
            text, wait, "if (t > 0) for (int q = 0; q < groups; ++q) "
            "mbar_wait(bar0 + 8 * q, (phases >> q) & 1u);"),
        "no product loop": _edit(text, loop,
                                 "for (int c = lane; c < 0; c += kLanes) {"),
        "no staging": _edit(_edit(text, copy, copy.replace("tid == 0",
                                                           "false")),
                            wait, "if (false) mbar_wait(bar0, 0);"),
        "no grid barrier": _edit(text, sync,
                                 "if (t + 1 < T) __syncthreads();"),
    }


def build(tmp):
    header = (_build.CSRC / "lstm_persistent.cuh").read_text()
    source = (_build.CSRC / "fused_lstm.cu").read_text()
    procs = {}
    for n, (name, text) in enumerate(variants(header).items()):
        d = Path(tmp) / str(n)
        d.mkdir()
        (d / "lstm_persistent.cuh").write_text(text)
        (d / "fused_lstm.cu").write_text(source)
        procs[name] = (d, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / "fused_lstm.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit("nvcc failed for %s:\n%s" % (name, log))
        lib = ctypes.CDLL(str(d / "lib.so"))
        lib.fused_lstm_forward.argtypes = lstm_kernel._FORWARD_ARGS
        lib.fused_lstm_forward.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batches", default="1,8,32,64")
    batches = [int(b) for b in parser.parse_args().batches.split(",")]
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp)
        for b in batches:
            plan = lstm_kernel.lstm_plan(b, H, dev)
            gen = torch.Generator().manual_seed(0)

            def draw(*shape, scale=1.0):
                return ((torch.rand(*shape, generator=gen) - 0.5) * scale
                        ).to(dev)
            xp, wh = draw(T, b, 4 * H), draw(H, 4 * H, scale=0.08)
            h0, c0 = draw(b, H), draw(b, H)
            hseq = torch.empty(T, b, H, device=dev)
            c = torch.empty(b, H, device=dev)
            hx = torch.empty(2, b, -(-H // 4) * 4, device=dev)
            ref = None
            for name, lib in libs.items():
                def call():
                    err = lib.fused_lstm_forward(
                        xp.data_ptr(), wh.data_ptr(), h0.data_ptr(),
                        c0.data_ptr(), hseq.data_ptr(), c.data_ptr(), None,
                        hx.data_ptr(), T, b, H, 1, plan.grid, plan.units,
                        plan.rows, plan.smem,
                        torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise SystemExit("%s: launch error %d" % (name, err))
                for _ in range(3):
                    call()
                torch.cuda.synchronize()
                if ref is None:
                    ref = hseq.clone()
                diff = float((hseq - ref).abs().max())
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(50):
                    call()
                end.record()
                torch.cuda.synchronize()
                ms = start.elapsed_time(end) / 50
                print(json.dumps({"B": b, "variant": name, "ms": ms,
                                  "us_per_step": ms * 1e3 / T,
                                  "max_diff_vs_as_built": diff}))


if __name__ == "__main__":
    main()
