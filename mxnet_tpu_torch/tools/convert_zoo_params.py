#!/usr/bin/env python
"""Convert a reference MXNet Gluon model-zoo ``.params`` file for the
port's model zoo (counterpart of `tools/convert_zoo_params.py`, with the
same arguments).

Nothing is downloaded: conversion starts from a file the user has. It

* reads the reference ``.params`` container (`ndarray/utils.py` reads
  it byte for byte);
* drops ``arg:``/``aux:`` key tags (files of ``Module.save_checkpoint``
  carry them; Gluon ``save_params`` files do not);
* maps the names onto the target net's ``collect_params()`` names: as
  they are, with the leading Gluon prefix (``resnetv10_``) stripped from
  both sides, or with the target's own prefix;
* with ``--layout NHWC`` transposes every 4-D convolution weight OIHW ->
  OHWI for a channel-last net;
* writes ``<out-dir>/<model>.params`` with the net's prefix stripped, so
  that ``vision.<model>(pretrained=True, root=<out-dir>)`` finds it
  (`gluon/model_zoo/model_store.py`).

``--verify`` loads the written file through ``pretrained=True`` and runs
a fixed input, printing the first outputs and a checksum: run it here and
on the reference's side to check the conversion. The net is built and run
on ``--device`` (``gpu``, the default, or ``cpu``).

Usage::

    python -m mxnet_tpu_torch.tools.convert_zoo_params \\
        resnet50_v1-0000.params --model resnet50_v1 \\
        --out-dir ~/.mxnet/models [--layout NHWC] [--verify]
"""
from __future__ import annotations

import argparse
import os
import re

import numpy as np

_PREFIX_RE = re.compile(r"^[a-z0-9]+\d+_")


def load_reference_params(path):
    """``{name: NDArray}`` with ``arg:``/``aux:`` tags dropped."""
    import mxnet_tpu_torch as mx
    raw = mx.nd.load(path, ctx=mx.cpu())
    if not isinstance(raw, dict):
        raise SystemExit("%s holds a list, not a name->array dict: not a "
                         "zoo params file" % path)
    return {(k.split(":", 1)[1] if k.startswith(("arg:", "aux:")) else k): v
            for k, v in raw.items()}


def match_names(params, target_names):
    """Map loaded names onto the target net's parameter names: the same
    name, else the same name without its leading Gluon prefix. Returns
    (mapped, missing, unused)."""
    mapped, used = {}, set()
    by_bare = {}
    for k in params:
        by_bare.setdefault(_PREFIX_RE.sub("", k), k)
    for tname in target_names:
        if tname in params:
            mapped[tname] = params[tname]
            used.add(tname)
            continue
        src = by_bare.get(_PREFIX_RE.sub("", tname))
        if src is not None:
            mapped[tname] = params[src]
            used.add(src)
    missing = [t for t in target_names if t not in mapped]
    unused = [k for k in params if k not in used]
    return mapped, missing, unused


def to_nhwc(mapped):
    """OIHW -> OHWI for every 4-D convolution weight."""
    import mxnet_tpu_torch as mx
    out = {}
    for k, v in mapped.items():
        if k.endswith("_weight") and len(v.shape) == 4:
            v = mx.nd.NDArray(v.data.permute(0, 2, 3, 1).contiguous(),
                              v.context)
        out[k] = v
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("params", help="reference zoo .params file")
    ap.add_argument("--model", required=True,
                    help="zoo model name, e.g. resnet50_v1")
    ap.add_argument("--out-dir", default=os.path.expanduser(
        os.path.join("~", ".mxnet", "models")))
    ap.add_argument("--layout", choices=["NCHW", "NHWC"], default="NCHW")
    ap.add_argument("--classes", type=int, default=1000)
    ap.add_argument("--verify", action="store_true",
                    help="load via pretrained=True and print an output "
                         "checksum on a fixed input")
    ap.add_argument("--device", choices=["gpu", "cpu"], default="gpu",
                    help="where the net is built and run")
    args = ap.parse_args(argv)

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision

    ctx = mx.gpu(0) if args.device == "gpu" else mx.cpu()
    kwargs = {"classes": args.classes}
    if args.layout != "NCHW":
        kwargs["layout"] = args.layout
    net = vision.get_model(args.model, **kwargs)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    side = 299 if args.model == "inceptionv3" else 224
    shape = ((1, 3, side, side) if args.layout == "NCHW"
             else (1, side, side, 3))
    net(mx.nd.zeros(shape, ctx=ctx))         # materialise the shapes
    target_names = list(net.collect_params().keys())

    mapped, missing, unused = match_names(
        load_reference_params(args.params), target_names)
    if args.layout == "NHWC":
        mapped = to_nhwc(mapped)
    print("matched %d/%d target params (%d source arrays unused)"
          % (len(mapped), len(target_names), len(unused)))
    if missing:
        raise SystemExit("unmatched target params (first 10): %s"
                         % missing[:10])

    os.makedirs(args.out_dir, exist_ok=True)
    out_path = os.path.join(args.out_dir, "%s.params" % args.model)
    # the zoo's convention: saved without the net's prefix, which
    # load_parameters puts back (the legacy save_params form)
    prefix = net.prefix
    mx.nd.save(out_path, {(k[len(prefix):] if k.startswith(prefix) else k):
                          v for k, v in mapped.items()})
    print("wrote", out_path)

    if args.verify:
        net2 = vision.get_model(args.model, pretrained=True,
                                root=args.out_dir, ctx=ctx, **kwargs)
        x = mx.nd.array(np.linspace(-1, 1, int(np.prod(shape)),
                                    dtype=np.float32).reshape(shape),
                        ctx=ctx)
        y = net2(x).asnumpy()
        print("verify: output[0,:5] =", np.round(y[0, :5], 5),
              "checksum %.6f" % float(np.abs(y).sum()))


if __name__ == "__main__":
    main()
