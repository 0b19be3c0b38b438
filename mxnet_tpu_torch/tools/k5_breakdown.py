"""Where a call of K5's wgmma route goes, on a machine with nvcc and a CUDA
card.

    python3 mxnet_tpu_torch/tools/k5_breakdown.py [--batch 128] \
        [--parent FILE]

Builds ``csrc/conv1x1_s2_dgrad.cu`` against variants of
``csrc/dgrad_wgmma.cuh``, each with one edit:

- ``as built``: the header unchanged;
- ``no zero stores``: the zero writers store nothing;
- ``no epilogue stores``: nothing of dx is stored, neither the zeros nor
  the consumers' values (the values are still staged in shared memory);
- ``loads only``: no wgmma and no stores: the TMA ring alone, each stage
  waited for and released;
- ``plain stores``: dx stored without the streaming (evict-first) hint;
- ``zeros unpaced``: the zero writers store each tile's zeros as soon as
  they can, not once the consumers have started that tile.

It times each at the six stride-2 1x1 sites of a ResNet-50 v1 step (NHWC,
bf16, batch ``--batch``), with the plan ``_k5_route`` picks, and the
build as built also with the other tile width (BN = 128 or 256), beside
cuDNN's dgrad of the same conv and ``dx.zero_()`` (dx's bytes written
once: the card's rate for a write-only stream). With ``--parent FILE``,
an earlier ``conv1x1_s2_dgrad.cu`` whose C entry takes ``(dy, w2, dx, M,
K, C, Ho, Wo, dtype, stream)`` (the WMMA kernel before the wgmma route,
e.g. from a ``git archive`` of that commit), it also builds that file as
it is and with one edit, ``parent, column tiles adjacent``: its grid's
two axes swapped, so that the column tiles of one 128-row tile of dy
launch side by side instead of a grid row apart. Where dy is larger than
the L2 and the second runs faster, the first read dy from HBM once per
column tile.

Times are CUDA events over 20 calls after 3, queued while the card
sleeps. It prints one JSON line per site and variant: ms, the bound
(bytes at 3.35 TB/s or operations at 989 TFLOP/s, the larger), the share
of dx a call leaves unwritten, and the largest difference of what it
wrote from the build as built (0 for the variants that keep the function;
the others compute something else and are timings only), and last the
card's name and power limit. The variants compile in parallel into a
temporary directory.
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

from mxnet_tpu_torch.ops import _build, conv_kernel  # noqa: E402

HEADER, SOURCE = "dgrad_wgmma.cuh", "conv1x1_s2_dgrad.cu"
PEAK_BYTES_PER_S, PEAK_BF16_FLOPS = 3.35e12, 989e12


def _edit(text, old, new):
    if old not in text:
        raise SystemExit("the source no longer has %r" % old)
    return text.replace(old, new)


def variants(text):
    zeros = "store16(dx + row.p + off + c0 + c, zero);"
    values = "if (m0 + r < M && c0 + c < C)"
    wgmma = "wgmma_tn(acc, sdesc(a + ks * 32, 16, 1024),"
    store = "__stcs(reinterpret_cast<uint4*>(p), v);"
    pace = "while (*progress < n) __nanosleep(128);"
    no_zeros = _edit(text, zeros, "if (M < 0) " + zeros)
    no_stores = _edit(no_zeros, values, "if (M < 0)")
    return {"as built": text, "no zero stores": no_zeros,
            "no epilogue stores": no_stores,
            "loads only": _edit(no_stores, wgmma, "if (M < 0) " + wgmma),
            "plain stores": _edit(text, store,
                                  "*reinterpret_cast<uint4*>(p) = v;"),
            "zeros unpaced": _edit(text, pace, "")}


def parent_variants(text):
    rows = ("const int m0 = blockIdx.x * kBM;\n"
            "  const int c0 = blockIdx.y * kBN;")
    grid = "const dim3 grid((M + kBM - 1) / kBM, (C + kBN - 1) / kBN);"
    swapped = _edit(_edit(text, rows, "const int m0 = blockIdx.y * kBM;\n"
                          "  const int c0 = blockIdx.x * kBN;"),
                    grid, "const dim3 grid((C + kBN - 1) / kBN, "
                    "(M + kBM - 1) / kBM);")
    return {"parent": text, "parent, column tiles adjacent": swapped}


def build(tmp, parent):
    """{variant: (loaded library, True for the parent's C interface)},
    every nvcc started at once."""
    sources = {name: (text, False) for name, text in
               variants((_build.CSRC / HEADER).read_text()).items()}
    if parent is not None:
        sources.update({name: (text, True) for name, text in
                        parent_variants(Path(parent).read_text()).items()})
    procs = {}
    for n, (name, (text, old)) in enumerate(sources.items()):
        d = Path(tmp) / str(n)
        d.mkdir()
        if old:
            (d / SOURCE).write_text(text)
        else:
            for other in _build.CSRC.glob("*.cuh"):
                (d / other.name).write_text(other.read_text())
            (d / HEADER).write_text(text)
            (d / SOURCE).write_text((_build.CSRC / SOURCE).read_text())
        procs[name] = (d, old, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / SOURCE)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (d, old, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit("nvcc failed for %s:\n%s" % (name, log))
        lib = ctypes.CDLL(str(d / "lib.so"))
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.conv1x1_s2_dgrad.argtypes = ([vp] * 3 + [i] * (6 if old else 10)
                                         + [vp])
        lib.conv1x1_s2_dgrad.restype = i
        libs[name] = (lib, old)
    return libs


def sites(batch):
    """(N, Ho, Wo, K, C) of the six stride-2 1x1 convs: stages 2-4, body
    conv1 (K = C / 2) and downsample (K = 2C)."""
    return [(batch, ho, ho, k, c) for ho, c in ((28, 256), (14, 512),
                                                (7, 1024))
            for k in (c // 2, 2 * c)]


def bound_ms(n, ho, wo, k, c):
    m = n * ho * wo
    t_bytes = 2 * (m * k + k * c + 4 * m * c) / PEAK_BYTES_PER_S * 1e3
    t_ops = 2 * m * k * c / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, reps=20):
    """Mean device time of ``fn``: the card sleeps (about 25 ms) while the
    host queues the calls, so the host's time per call is not measured."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--parent", help="an earlier csrc/conv1x1_s2_dgrad.cu "
                    "to time beside (its C interface before the plans)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k5_breakdown needs a CUDA device")
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp, args.parent)
        for shape in sites(args.batch):
            n, ho, wo, k, c = shape
            gen = torch.Generator(device=dev)
            gen.manual_seed(k + c)
            dy = torch.randn((n, ho, wo, k), generator=gen,
                             device=dev).bfloat16()
            w2 = (torch.randn((k, c), generator=gen, device=dev)
                  / k ** 0.5).bfloat16()
            dx = torch.empty((n, 2 * ho, 2 * wo, c), dtype=dy.dtype,
                             device=dev)
            plan = conv_kernel._k5_route(*shape, torch.bfloat16, sms)
            other = conv_kernel._wgmma_plan(plan.row_tiles, c,
                                            384 - plan.bn, sms)

            def call(lib, old, p=plan):
                if old:
                    err = lib.conv1x1_s2_dgrad(
                        dy.data_ptr(), w2.data_ptr(), dx.data_ptr(),
                        n * ho * wo, k, c, ho, wo, 1, stream)
                else:
                    err = lib.conv1x1_s2_dgrad(
                        dy.data_ptr(), w2.data_ptr(), dx.data_ptr(),
                        n * ho * wo, k, c, wo, 1, 2, p.bn, p.stages,
                        p.grid, p.smem, stream)
                if err:
                    raise SystemExit("%s: launch error %d" % (shape, err))
            call(*libs["as built"])
            ref = dx.clone()
            want = conv_kernel.conv1x1_s2_dgrad_plain(dy, w2, 2 * ho, 2 * wo)
            bound, by = bound_ms(*shape)
            runs = [(name, lib, old, plan) for name, (lib, old)
                    in libs.items()]
            runs.insert(1, ("as built, BN=%d" % other.bn,
                            libs["as built"][0], False, other))
            for name, lib, old, p in runs:
                dx.fill_(float("nan"))
                call(lib, old, p)
                unwritten = torch.isnan(dx)
                diff = (dx.float() - ref.float()).abs()
                row = {"shape": list(shape), "variant": name,
                       "ms": time_ms(lambda: call(lib, old, p)),
                       "bound_ms": bound, "bound_by": by,
                       "unwritten_share": unwritten.float().mean().item(),
                       "max_diff_vs_as_built": (
                           diff[~unwritten].max().item()
                           if (~unwritten).any() else None)}
                row["share_of_bound"] = bound / row["ms"]
                if not old:
                    row.update(bn=p.bn, grid=p.grid, stages=p.stages)
                if name == "as built":
                    row["max_abs_err_vs_plain"] = (
                        ref.float() - want.float()).abs().max().item()
                print(json.dumps(row), flush=True)
            print(json.dumps({"shape": list(shape), "variant": "dx.zero_()",
                              "ms": time_ms(dx.zero_), "bound_ms": bound,
                              "bound_by": by}), flush=True)
            w4 = w2.reshape(k, 1, 1, c).permute(0, 3, 1, 2)
            dyc = dy.permute(0, 3, 1, 2)
            print(json.dumps({"shape": list(shape), "variant": "cuDNN dgrad",
                              "ms": time_ms(
                                  lambda: torch.nn.grad.conv2d_input(
                                      (n, c, 2 * ho, 2 * wo), w4, dyc,
                                      stride=2)),
                              "bound_ms": bound, "bound_by": by}),
                  flush=True)
            del dy, w2, dx, ref, want
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
