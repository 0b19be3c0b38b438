"""Run an example written for the JAX package on the port, with one import
changed.

    python -m mxnet_tpu_torch.tools.run_example EXAMPLE [--device gpu|cpu] [ARGS...]

It reads ``EXAMPLE``, rewrites its ``import mxnet_tpu as mx`` and
``from mxnet_tpu[.x] import ...`` lines to import ``mxnet_tpu_torch``
instead, refuses a file that names ``mxnet_tpu`` anywhere else, and runs
the rest as it is, as ``__main__`` with ``ARGS`` for its command line,
inside ``with mx.gpu(0):`` (the default) or ``with mx.cpu():``. The
scope places the script's arrays and parameters that name no context:
``nd.array`` and a ctx-less ``initialize`` take the scope's context. An
example that names its context (``mx.tpu()``, ``ctx=mx.cpu()``) keeps
it; ``tpu(0)`` is ``cuda:0`` in the port. After the run it fails if the
process has imported ``jax`` or ``mxnet_tpu``.
"""
from __future__ import annotations

import re
import sys

__all__ = ["rewrite", "run_example", "main"]

_IMPORT = re.compile(r"^(\s*)(import mxnet_tpu as mx\b"
                     r"|from mxnet_tpu((?:\.\w+)*) import )")
_MENTION = re.compile(r"\bmxnet_tpu\b")
_FORBIDDEN = ("jax", "mxnet_tpu")


def rewrite(source, path="<example>"):
    """``source`` with its ``mxnet_tpu`` import lines pointed at
    ``mxnet_tpu_torch``; raises ``ValueError`` where any other line names
    ``mxnet_tpu``."""
    lines = []
    for no, line in enumerate(source.splitlines(keepends=True), 1):
        if _IMPORT.match(line):
            line = line.replace("mxnet_tpu", "mxnet_tpu_torch", 1)
        if _MENTION.search(line):
            raise ValueError("%s:%d names mxnet_tpu outside an import the "
                             "port can take: %s" % (path, no, line.strip()))
        lines.append(line)
    return "".join(lines)


def run_example(path, argv=(), device="gpu"):
    """Run the example at ``path`` on the port with ``argv`` as its
    arguments, inside ``with mx.gpu(0):`` or ``with mx.cpu():``
    (``device`` "gpu", the default, or "cpu"). Returns the script's
    globals."""
    import mxnet_tpu_torch as mx

    if device not in ("cpu", "gpu"):
        raise ValueError("device must be 'cpu' or 'gpu', got %r" % (device,))
    ctx = mx.gpu(0) if device == "gpu" else mx.cpu()
    ctx.torch_device()       # raises here where the card is missing
    with open(path) as f:
        code = compile(rewrite(f.read(), path), path, "exec")
    scope = {"__name__": "__main__", "__file__": path}
    saved = sys.argv
    sys.argv = [path] + [str(a) for a in argv]
    try:
        with ctx:
            exec(code, scope)
    finally:
        sys.argv = saved
    loaded = [m for m in _FORBIDDEN if m in sys.modules]
    if loaded:
        raise RuntimeError("running %s on the port imported %s"
                           % (path, ", ".join(loaded)))
    return scope


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0].startswith("-"):
        print("usage: python -m mxnet_tpu_torch.tools.run_example EXAMPLE "
              "[--device gpu|cpu] [ARGS...]", file=sys.stderr)
        return 2
    path, rest = argv[0], argv[1:]
    device = "gpu"
    if rest[:1] == ["--device"] and len(rest) > 1:
        device, rest = rest[1], rest[2:]
    run_example(path, rest, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
