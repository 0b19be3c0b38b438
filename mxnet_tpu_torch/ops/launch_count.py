"""Launch counts of the hand kernels' wrappers.

Each wrapper calls ``count(wrapper, route)`` where it launches its kernel,
so ``wrapper.launches`` (and ``wrapper.launches_by_route``, where the
wrapper has routes) is the number of kernels it ran. A launch inside a
CUDA-graph capture only records the kernel into the graph, and runs at
each replay: ``count`` then adds it to the list of the capture that
``recording`` opened on this thread, and ``replayed`` adds that list to
the counts at each replay (`compiled.py`). A launch captured outside
``recording`` counts nothing, since no replay of it can be seen.

``flops`` is the launch's model FLOPs, the analytic count of the work
its kernel does (a ``ctypes`` launch is invisible to
``torch.utils.flop_counter``): it is added to every FLOP count that
``counting_flops`` has open (`xla_stats.count_flops`), and nowhere else.
The counts are the process's, not a thread's: a backward launches its
kernels on autograd's device thread. A plain version on the CPU adds nothing here: the FLOP
counter sees its own ops.
"""
from __future__ import annotations

import contextlib
import threading

import torch

_lock = threading.Lock()
_tls = threading.local()
_flop_counts = []       # the open FLOP counts, one-element lists


def count(wrapper, route=None, flops=0):
    """One launch of ``wrapper``'s kernel (by ``route``) on a CUDA
    stream: counted now, or at each replay of the graph being
    captured; its ``flops`` go to the open FLOP counts."""
    if flops and _flop_counts:
        with _lock:
            for acc in _flop_counts:
                acc[0] += flops
    if torch.cuda.is_current_stream_capturing():
        held = getattr(_tls, "held", None)
        if held is not None:
            held.append((wrapper, route))
        return
    replayed([(wrapper, route)])


@contextlib.contextmanager
def recording():
    """The list of the launches counted on this thread inside the block
    while its stream is capturing."""
    saved = getattr(_tls, "held", None)
    _tls.held = held = []
    try:
        yield held
    finally:
        _tls.held = saved


@contextlib.contextmanager
def counting_flops():
    """A one-element list that sums the ``flops`` of the launches counted
    while the block runs, on any thread."""
    acc = [0]
    with _lock:
        _flop_counts.append(acc)
    try:
        yield acc
    finally:
        with _lock:
            _flop_counts[:] = [a for a in _flop_counts if a is not acc]


def replayed(launches):
    """Count ``launches``, ``(wrapper, route)`` pairs, once each."""
    with _lock:
        for wrapper, route in launches:
            wrapper.launches += 1
            if route is not None:
                wrapper.launches_by_route[route] += 1
