"""Where a step of the persistent LSTM kernels goes, on a machine with nvcc
and a CUDA card.

    python3 mxnet_tpu_torch/tools/lstm_step_breakdown.py \
        [--batches 1,8,32,64] [--kernels k1,k3]

K1: builds ``csrc/fused_lstm.cu`` against variants of
``csrc/lstm_persistent.cuh``, each with one edit:

- ``as built``: the header unchanged;
- ``8 warps``: 8 warps a block instead of 16;
- ``staging not overlapped``: each warp waits for every row group's copy
  before its first item, not only for its own group's;
- ``no product loop``: the k loop of the gate product removed;
- ``no staging``: no copy of h_{t-1} into shared memory (nor its waits);
- ``no grid barrier``: the grid-wide barrier between steps replaced by a
  block barrier.

K3: builds ``csrc/fused_lstm_train.cu`` against variants of
``csrc/lstm_bwd_persistent.cuh``, each with one edit:

- ``as built``: the header unchanged;
- ``no product loop``: the loop over the block's own dgates columns of the
  partial product removed (the partials are still stored, as zeros);
- ``no partial stores``: the product computed and staged in shared
  memory, but not stored to the exchange buffer;
- ``no slab copy``: no copy of the writers' partials into shared
  memory; the writer sums read a stale slab;
- ``no writer sum``: the sum over the writers of the staged slab removed;
- ``no grid barrier``: the grid-wide barrier between steps replaced by a
  block barrier.

With ``--timeline`` it also builds K3 with ``clock64()`` stamps at the
phases of a step and prints, for each batch, the cycles from the start of
step 10 to each phase's end in blocks 0 and 77 (copies issued, slab
landed, writer sums, elementwise part, product, stores, barrier).

It times each recurrence kernel alone (K1: ``x @ Wx + b`` precomputed; K3:
the persistent route's one launch) at T=35, I=H=650 and each batch, with
CUDA events over 50 calls after 3, and prints one JSON line per kernel,
variant and batch: µs a step and the largest difference of the outputs
(K1: hseq; K3: dgates and dh0) from the build as built (0 for the
variants that keep the function; the others compute something else and
are timings only). The variants compile in parallel into a temporary
directory.
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


def k1_variants(text):
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


def k3_variants(text):
    copy = "asm volatile(\"cp.async.cg.shared.global [%0], [%1], 16;\\n\""
    loop = "for (int k0 = 0; k0 < K; k0 += 4) {  // columns k0 .. k0+3, in order"
    store = "reinterpret_cast<float4*>(x_out + o * oslab"
    writers = "for (int p = part; p < W; p += kSumParts) sum += src[p * tslab];"
    sync = "if (t >= 0) cooperative_groups::this_grid().sync();"
    return {
        "as built": text,
        "no product loop": _edit(text, loop,
                                 "for (int k0 = 0; k0 < 0; k0 += 4) {"),
        "no partial stores": _edit(text, store,
                                   "if (T < 0) " + store),
        "no slab copy": _edit(text, copy, "if (T < 0) " + copy),
        "no writer sum": _edit(text, writers, ""),
        "no grid barrier": _edit(text, sync, "if (t >= 0) __syncthreads();"),
    }


# the phases of a K3 step: (name, anchor in the header, stamp before it)
K3_PHASES = [
    ("step start", "const int t = T - 1 - s;  // t = -1: the pass that "
     "reduces dh0", False),
    ("copies issued", "      // the inputs of this thread's first "
     "elementwise item", True),
    ("slab landed", "__syncthreads();  // the slab has landed", False),
    ("sums done", "__syncthreads();  // the partial sums are whole; the "
     "slab is read", False),
    ("elementwise done", "__syncthreads();  // dg_s is whole", False),
    ("product done", "      // 5. The staged partials to xbuf", True),
    ("stores done", "__syncthreads();  // the next tile's copies overwrite "
     "slab_s", False),
    ("before barrier", "    if (t >= 0) cooperative_groups::this_grid()"
     ".sync();", True),
]
STAMP = ("if ((blockIdx.x == 0 || blockIdx.x == 77) && threadIdx.x == 0 && "
         "s == 10) k3_stamps[blockIdx.x ? 1 : 0][%d] = clock64();")


def k3_timeline(text):
    """The header with a clock64() stamp after each phase of a step (the
    barrier's end is the next step's start: stamp 0 of step 11 is not
    taken, so the last stamp follows the barrier)."""
    text = _edit(text, "namespace {\n", "namespace {\n__device__ long long "
                 "k3_stamps[2][16];\n")
    for n, (_, anchor, before) in enumerate(K3_PHASES):
        stamp = STAMP % n
        text = _edit(text, anchor, stamp + "\n" + anchor if before
                     else anchor + "\n" + stamp)
    sync = "    if (t >= 0) cooperative_groups::this_grid().sync();"
    return _edit(text, sync, sync + "\n" + STAMP % len(K3_PHASES))


def run_timeline(tmp, batches, dev):
    header, source, _, entry, argtypes = KERNELS["k3"]
    d = Path(tmp) / "timeline"
    d.mkdir()
    for other in _build.CSRC.glob("*.cuh"):
        (d / other.name).write_text(other.read_text())
    (d / header).write_text(k3_timeline((_build.CSRC / header).read_text()))
    (d / source).write_text((_build.CSRC / source).read_text() + """
extern "C" int k3_stamps_get(long long* out) {
  return cudaMemcpyFromSymbol(out, k3_stamps, sizeof(k3_stamps));
}
""")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(d / "lib.so"), str(d / source)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit("nvcc failed for the timeline:\n" + proc.stdout
                         + proc.stderr)
    lib = ctypes.CDLL(str(d / "lib.so"))
    getattr(lib, entry).argtypes = argtypes
    names = [n for n, _, _ in K3_PHASES] + ["after barrier"]
    for b in batches:
        call, reset, _ = k3_case(b, dev)
        reset()
        if call(lib):
            raise SystemExit("timeline: launch error")
        torch.cuda.synchronize()
        out = (ctypes.c_longlong * 32)()
        if lib.k3_stamps_get(out):
            raise SystemExit("timeline: no stamps")
        for n, block in enumerate((0, 77)):
            v = out[16 * n:16 * n + len(names)]
            print(json.dumps({"kernel": "k3", "B": b, "block": block,
                              "step": 10, "cycles": {
                                  name: v[i] - v[0]
                                  for i, name in enumerate(names)}}),
                  flush=True)


KERNELS = {
    # name: (header, source, variants, entry, argtypes)
    "k1": ("lstm_persistent.cuh", "fused_lstm.cu", k1_variants,
           "fused_lstm_forward", lstm_kernel._FORWARD_ARGS),
    "k3": ("lstm_bwd_persistent.cuh", "fused_lstm_train.cu", k3_variants,
           "fused_lstm_backward", lstm_kernel._BACKWARD_ARGS),
}


def build(tmp, kernels):
    """{kernel: {variant: loaded library}}, every nvcc started at once."""
    procs = {}
    for kernel in kernels:
        header, source, variants, _, _ = KERNELS[kernel]
        text = (_build.CSRC / header).read_text()
        for n, (name, edited) in enumerate(variants(text).items()):
            d = Path(tmp) / kernel / str(n)
            d.mkdir(parents=True)
            for other in _build.CSRC.glob("*.cuh"):   # the includes
                (d / other.name).write_text(other.read_text())
            (d / header).write_text(edited)
            (d / source).write_text((_build.CSRC / source).read_text())
            procs[kernel, name] = (d, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
                 str(d / source)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    libs = {kernel: {} for kernel in kernels}
    for (kernel, name), (d, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit("nvcc failed for %s %s:\n%s" % (kernel, name,
                                                             log))
        _, _, _, entry, argtypes = KERNELS[kernel]
        lib = ctypes.CDLL(str(d / "lib.so"))
        getattr(lib, entry).argtypes = argtypes
        getattr(lib, entry).restype = ctypes.c_int
        libs[kernel][name] = lib
    return libs


def _draw(gen, dev, *shape, scale=1.0, low=-0.5):
    return ((torch.rand(*shape, generator=gen) + low) * scale).to(dev)


def k1_case(b, dev):
    """(call(lib), reset, outputs) of K1's persistent route at batch b."""
    plan = lstm_kernel.lstm_plan(b, H, dev)
    gen = torch.Generator().manual_seed(0)
    xp, wh = _draw(gen, dev, T, b, 4 * H), _draw(gen, dev, H, 4 * H,
                                                 scale=0.08)
    h0, c0 = _draw(gen, dev, b, H), _draw(gen, dev, b, H)
    hseq = torch.empty(T, b, H, device=dev)
    c = torch.empty(b, H, device=dev)
    hx = torch.empty(2, b, -(-H // 4) * 4, device=dev)

    def call(lib):
        return lib.fused_lstm_forward(
            xp.data_ptr(), wh.data_ptr(), h0.data_ptr(), c0.data_ptr(),
            hseq.data_ptr(), c.data_ptr(), None, hx.data_ptr(), T, b, H, 1,
            plan.grid, plan.units, plan.rows, plan.smem,
            torch.cuda.current_stream().cuda_stream)
    return call, lambda: None, [hseq]


def k3_case(b, dev):
    """(call(lib), reset, outputs) of K3's persistent route at batch b;
    ``reset`` restores dc_n, which the kernel turns into dc0 in place."""
    plan = lstm_kernel.lstm_bwd_plan(b, H, dev)
    if plan.route != "persistent":
        raise SystemExit("K3 at B=%d takes the %s route" % (b, plan.route))
    gen = torch.Generator().manual_seed(0)
    dhseq, dhn, dcn = (_draw(gen, dev, *s) for s in ((T, b, H), (b, H),
                                                      (b, H)))
    gates = _draw(gen, dev, T, b, 4 * H, low=0.0)      # activated: (0, 1)
    cseq, c0 = _draw(gen, dev, T, b, H), _draw(gen, dev, b, H)
    wh = _draw(gen, dev, H, 4 * H, scale=0.08)
    dc = dcn.clone()
    dgates = torch.empty(T, b, 4 * H, device=dev)
    dh0 = torch.empty(b, H, device=dev)
    xbuf = torch.empty(2, plan.grid, -(-b // 8) * plan.grid * 8 * plan.units,
                       device=dev)

    def call(lib):
        return lib.fused_lstm_backward(
            dhseq.data_ptr(), dhn.data_ptr(), gates.data_ptr(),
            cseq.data_ptr(), c0.data_ptr(), wh.data_ptr(), dc.data_ptr(),
            dgates.data_ptr(), dh0.data_ptr(), xbuf.data_ptr(), T, b, H,
            *wh.stride(), 1, plan.grid, plan.units, plan.rows, plan.smem,
            torch.cuda.current_stream().cuda_stream)
    return call, lambda: dc.copy_(dcn), [dgates, dh0]


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batches", default="1,8,32,64")
    parser.add_argument("--kernels", default="k1,k3")
    parser.add_argument("--timeline", action="store_true")
    args = parser.parse_args()
    batches = [int(b) for b in args.batches.split(",")]
    kernels = args.kernels.split(",")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    cases = {"k1": k1_case, "k3": k3_case}
    with tempfile.TemporaryDirectory() as tmp:
        if args.timeline:
            run_timeline(tmp, batches, dev)
        libs = build(tmp, kernels)
        for kernel in kernels:
            for b in batches:
                call_with, reset, outs = cases[kernel](b, dev)
                ref = None
                for name, lib in libs[kernel].items():
                    def call():
                        err = call_with(lib)
                        if err:
                            raise SystemExit("%s %s: launch error %d"
                                             % (kernel, name, err))
                    reset()
                    call()
                    torch.cuda.synchronize()
                    if ref is None:
                        ref = [o.clone() for o in outs]
                    diff = max(float((o - r).abs().max())
                               for o, r in zip(outs, ref))
                    for _ in range(2):
                        call()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(50):
                        call()
                    end.record()
                    torch.cuda.synchronize()
                    ms = start.elapsed_time(end) / 50
                    print(json.dumps({"kernel": kernel, "B": b,
                                      "variant": name, "ms": ms,
                                      "us_per_step": ms * 1e3 / T,
                                      "max_diff_vs_as_built": diff}),
                          flush=True)


if __name__ == "__main__":
    main()
