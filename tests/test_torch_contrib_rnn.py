"""``gluon.contrib.rnn`` of the port against the JAX package's, on the
CPU.

Every conv cell (RNN, LSTM and GRU over 1-D, 2-D and 3-D maps) and
``LSTMPCell`` is built in both packages under one prefix, the JAX cell's
Xavier weights are carried into the port's by name
(``params_to_numpy`` then ``set_block_params``), and both unroll 3 steps
of one input under ``record()``: the outputs and final states are held
to rtol 1e-5 (atol 1e-6), and the input gradient and every parameter
gradient of ``sum(out * r + out ** 2)`` (``r`` fixed draws) to rtol 1e-4
(atol 1e-6 times the largest magnitude): f32 on both sides, summed in
other orders. ``VariationalDropoutCell`` equals its base cell at
``p = 0`` in both packages; at ``p > 0`` each package draws its own
masks, so both are held to the cell's contract: one mask a sequence,
reused at every step, its values 0 or ``1/(1-p)`` and its keep rate
within 4 sigma of ``1 - p``, a new mask after ``reset()``. The JAX side
runs with ``MXNET_XLA_STATS=0``.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt

RTOL, ATOL, GRAD_RTOL = 1e-5, 1e-6, 1e-4
T, B = 3, 2
CPU = mxt.cpu()


@pytest.fixture(autouse=True)
def _no_xla_stats(monkeypatch):
    monkeypatch.setenv("MXNET_XLA_STATS", "0")


def _conv_case(kind, dims):
    spatial = {1: (7,), 2: (5, 6), 3: (3, 4, 5)}[dims]
    name = "Conv%dD%sCell" % (dims, kind)
    kw = {"input_shape": (2,) + spatial, "hidden_channels": 3,
          "i2h_kernel": 3, "h2h_kernel": 3, "i2h_pad": 1}
    if dims == 1:
        kw["i2h_dilate"] = 1
        kw["h2h_dilate"] = 2
    return name, kw, (B, T, 2) + spatial


CASES = {"%s%dd" % (kind.lower(), dims): _conv_case(kind, dims)
         for kind in ("RNN", "LSTM", "GRU") for dims in (1, 2, 3)}
CASES["lstmp"] = ("LSTMPCell", {"hidden_size": 6, "projection_size": 4},
                  (B, T, 5))


def _make(pkg, case):
    name, kw, _ = CASES[case]
    return getattr(pkg.gluon.contrib.rnn, name)(prefix="c_%s_" % case, **kw)


def _loss(pkg, outs):
    total = None
    for k, out in enumerate(outs):
        r = np.random.RandomState(k + 1).randn(*out.shape).astype(np.float32)
        term = (out * pkg.nd.array(r, ctx=pkg.cpu()) + out * out).sum()
        total = term if total is None else total + term
    return total


def _run(pkg, cell, x):
    a = pkg.nd.array(x, ctx=pkg.cpu())
    a.attach_grad()
    with pkg.autograd.record():
        out, states = cell.unroll(T, a, layout="NTC", merge_outputs=True)
        outs = [out] + list(states)
        loss = _loss(pkg, outs)
    loss.backward()
    grads = {n: p.grad().asnumpy()
             for n, p in sorted(cell.collect_params().items())}
    return [o.asnumpy() for o in outs], a.grad.asnumpy(), grads


def _close_grad(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=ATOL * scale,
                               err_msg=what)


@pytest.mark.parametrize("case", sorted(CASES))
def test_cell_matches_jax(case):
    x = np.random.RandomState(0).randn(*CASES[case][2]).astype(np.float32)
    with mx.cpu():
        mx.random.seed(0)
        jcell = _make(mx, case)
        jcell.initialize(mx.init.Xavier())
        want = _run(mx, jcell, x)
    tcell = _make(mxt, case)
    tcell.initialize(mxt.init.Xavier(), ctx=CPU)
    mxt.set_block_params(tcell, mxt.params_to_numpy(
        {n: p.data() for n, p in jcell.collect_params().items()}))
    got = _run(mxt, tcell, x)
    assert len(got[0]) == len(want[0])
    for g, w in zip(got[0], want[0]):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    _close_grad(got[1], want[1], "input")
    assert sorted(got[2]) == sorted(want[2])
    for n in want[2]:
        _close_grad(got[2][n], want[2][n], n)


def test_state_info_matches_jax():
    for case in sorted(CASES):
        with mx.cpu():
            want = _make(mx, case).state_info(4)
        assert _make(mxt, case).state_info(4) == want, case


def _vardrop(pkg, p, prefix):
    base = pkg.gluon.rnn.LSTMCell(4, prefix=prefix + "base_")
    return pkg.gluon.contrib.rnn.VariationalDropoutCell(
        base, drop_inputs=p, drop_states=p, drop_outputs=p)


def test_variational_dropout_at_zero_is_the_base_cell():
    x = np.random.RandomState(1).randn(B, T, 5).astype(np.float32)
    outs = {}
    for pkg in (mx, mxt):
        with (mx.cpu() if pkg is mx else CPU):
            cell = _vardrop(pkg, 0.0, "vd_")
            cell.initialize(pkg.init.One(), ctx=pkg.cpu())
            a = pkg.nd.array(x, ctx=pkg.cpu())
            with pkg.autograd.record():
                out, _ = cell.unroll(T, a, layout="NTC", merge_outputs=True)
            plain = pkg.gluon.rnn.LSTMCell(4, prefix="vd_plain_")
            plain.initialize(pkg.init.One(), ctx=pkg.cpu())
            base_out, _ = plain.unroll(T, a, layout="NTC",
                                       merge_outputs=True)
            np.testing.assert_allclose(out.asnumpy(), base_out.asnumpy(),
                                       rtol=RTOL, atol=ATOL)
            outs[pkg] = out.asnumpy()
    np.testing.assert_allclose(outs[mxt], outs[mx], rtol=RTOL, atol=ATOL)


def _echo_cell(pkg, width):
    """A cell whose output is its input: a dropped input shows its mask."""
    class Echo(pkg.gluon.rnn.HybridRecurrentCell):
        def state_info(self, batch_size=0):
            return [{"shape": (batch_size, width), "__layout__": "NC"}]

        def hybrid_forward(self, F, inputs, states):
            return inputs, states
    return Echo(prefix="echo_")


@pytest.mark.parametrize("pkg_name", ["jax", "port"])
def test_variational_dropout_draws_one_mask_a_sequence(pkg_name):
    pkg = mx if pkg_name == "jax" else mxt
    p, width, steps = 0.3, 4096, 4
    with (mx.cpu() if pkg is mx else CPU):
        cell = pkg.gluon.contrib.rnn.VariationalDropoutCell(
            _echo_cell(pkg, width), drop_inputs=p)
        ones = pkg.nd.ones((2, steps, width), ctx=pkg.cpu())
        masks = []
        for _ in range(2):
            cell.reset()
            with pkg.autograd.record():
                out, _ = cell.unroll(steps, ones, layout="NTC",
                                     merge_outputs=True)
            masks.append(out.asnumpy())
    for m in masks:
        for t in range(1, steps):
            np.testing.assert_array_equal(m[:, t], m[:, 0])
        assert np.all((m == 0) | np.isclose(m, 1 / (1 - p), rtol=1e-6))
        n = m[:, 0].size
        kept = float((m[:, 0] != 0).mean())
        assert abs(kept - (1 - p)) <= 4 * np.sqrt(p * (1 - p) / n), kept
    assert not np.array_equal(masks[0], masks[1])


@pytest.mark.parametrize("case", ["lstm2d", "lstmp"])
def test_unroll_begins_on_the_inputs_context(case):
    """A cell unrolled without ``begin_state`` makes its zero states on
    the inputs' context, not the current one (ROADMAP C.19: a list of
    steps has no ``ctx``, and the states went to the current context,
    the CPU, beside inputs on the card). ``cpu(1)`` stands for another
    device here."""
    cell = _make(mxt, case)
    cell.initialize(mxt.init.Xavier(), ctx=CPU)
    x = mxt.nd.array(np.zeros(CASES[case][2], np.float32), ctx=CPU)
    with mxt.cpu(1):
        _, states = cell.unroll(T, x, layout="NTC", merge_outputs=True)
    assert [s.context for s in states] == [CPU] * len(states)
