"""Monitor: tensor statistics during execution.

Counterpart of `mxnet_tpu/monitor.py` (reference
`python/mxnet/monitor.py`: install on an executor's monitor callback,
tic/toc, stat_func). The executor calls the callback on every node's
output of a forward while a monitor is installed
(``Executor.set_monitor_callback``); ``Module.install_monitor`` and
``fit(..., monitor=)`` install it. Pass :func:`nan_count` as the
``stat_func`` and every tensor with non-finite entries bumps
``run_anomalies_total{kind="nonfinite_tensor"}`` (and dumps the flight
recorder) when `toc` reads it; with the default ``asum_stat`` a
non-finite mean is routed the same way.
"""
from __future__ import annotations

import logging
import math
import re

import numpy as np
import torch

from . import telemetry
from .ndarray.ndarray import NDArray

__all__ = ["Monitor", "nan_count"]


def nan_count(x):
    """Stat func counting the non-finite (NaN/Inf) entries of a tensor,
    the reference Monitor's NaN-hunting sweep as a number. Returns a
    1-element NDArray on ``x``'s context so `Monitor.toc` renders it like
    any stat; the count is taken where ``x`` lies."""
    t = x.data
    bad = (~torch.isfinite(t)).sum().to(torch.float32).reshape(1)
    return NDArray(bad, x.context)


class Monitor:
    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        if stat_func is None:
            def asum_stat(x):
                return x.abs().mean()
            stat_func = asum_stat
        self.stat_func = stat_func
        self.interval = interval
        self.activated = False
        self.queue = []
        self.step = 0
        self.exes = []
        self.re_prog = re.compile(pattern)
        self.sort = sort

        def stat_helper(name, array):
            if not self.activated or not self.re_prog.match(name):
                return
            telemetry.counter("monitor_stats_total",
                              help="tensor stats captured by "
                                   "monitor.Monitor").inc()
            self.queue.append((self.step, name, self.stat_func(array)))
        self.stat_helper = stat_helper

    def install(self, exe):
        """Attach to an executor. Idempotent per executor: repeated
        ``fit`` calls re-install the same monitor, and without the
        dedupe every round appended the executor again — `tic` then
        re-synced (and `toc` re-read) each executor once per duplicate."""
        exe.set_monitor_callback(self.stat_helper)
        if not any(e is exe for e in self.exes):
            self.exes.append(exe)

    def tic(self):
        if self.step % self.interval == 0:
            for exe in self.exes:
                for array in exe.arg_arrays:
                    array.wait_to_read()
            self.queue = []
            self.activated = True
        self.step += 1

    def _flag_nonfinite(self, name, value):
        """Route a monitor-observed unhealthy tensor into the run-
        anatomy sentinels: with :func:`nan_count` any nonzero count is
        a hit; with value stats a non-finite result is (a finite mean
        of a NaN-carrying tensor cannot exist, so the routes agree)."""
        try:
            f = float(value)
        except (TypeError, ValueError):
            return
        bad = f > 0 if self.stat_func is nan_count \
            else not math.isfinite(f)
        if bad:
            from . import runprof
            runprof.note_anomaly(
                "nonfinite_tensor",
                detail="monitor stat %s at batch %d" % (name, self.step),
                value=f)

    def toc(self):
        if not self.activated:
            return []
        self.activated = False
        res = []
        if self.sort:
            self.queue.sort(key=lambda x: x[1])
        try:
            for n, k, v_list in self.queue:
                if isinstance(v_list, NDArray):
                    v_list = [v_list]
                s = ""
                for v in v_list:
                    if v.size == 1:
                        val = v.asscalar()
                        s += str(val) + "\t"
                        self._flag_nonfinite(k, val)
                    else:
                        a = v.asnumpy()
                        s += str(a) + "\t"
                        if not np.isfinite(a).all():
                            self._flag_nonfinite(k, float("nan"))
                res.append((n, k, s))
        finally:
            # also on a sentinel halt mid-loop: stale entries must not
            # be re-flagged (and re-raised) by the next toc
            self.queue = []
        return res

    def toc_print(self):
        res = self.toc()
        for n, k, v in res:
            logging.info("Batch: {:7d} {:30s} {:s}".format(n, k, v))
