"""Launch counts of the hand kernels' wrappers.

Each wrapper calls ``count(wrapper, route)`` where it launches its kernel,
so ``wrapper.launches`` (and ``wrapper.launches_by_route``, where the
wrapper has routes) is the number of kernels it ran. A launch inside a
CUDA-graph capture only records the kernel into the graph, and runs at
each replay: ``count`` then adds it to the list of the capture that
``recording`` opened on this thread, and ``replayed`` adds that list to
the counts at each replay (`compiled.py`). A launch captured outside
``recording`` counts nothing, since no replay of it can be seen.
"""
from __future__ import annotations

import contextlib
import threading

import torch

_lock = threading.Lock()
_tls = threading.local()


def count(wrapper, route=None):
    """One launch of ``wrapper``'s kernel (by ``route``) on a CUDA
    stream: counted now, or at each replay of the graph being
    captured."""
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


def replayed(launches):
    """Count ``launches``, ``(wrapper, route)`` pairs, once each."""
    with _lock:
        for wrapper, route in launches:
            wrapper.launches += 1
            if route is not None:
                wrapper.launches_by_route[route] += 1
