"""The port's fused LSTM layer against the JAX package's.

On the CPU the port's ``fused_lstm`` runs its plain version; the JAX
package's runs its Pallas kernel in interpret mode, as `test_pallas.py`
does. Both get the same inputs, made with numpy from a seed. The
tolerance is the one `test_pallas.py` holds the Pallas kernel to (1e-5).
`test_torch_cuda.py` holds the CUDA kernel against the plain version on
the card. The route that K1 and K2 take (``_lstm_route``) and the build
cache's names are computed here, with no card.
"""
import shutil

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu.ops.pallas_kernels import (_lstm_scan_ref,
                                          fused_lstm as jax_fused_lstm)
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import _build, lstm_kernel
from mxnet_tpu_torch.ops.lstm_kernel import fused_lstm, fused_lstm_plain

TOL = 1e-5
# (T, B, I, H): a plain case, B=1, and H/B off every tile size
SHAPES = [(5, 4, 6, 8), (4, 1, 5, 13), (3, 3, 7, 13), (6, 2, 16, 16)]


def _inputs(t, b, i, h, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(t, b, i).astype(np.float32),
            rng.randn(b, h).astype(np.float32),
            rng.randn(b, h).astype(np.float32),
            (rng.randn(i, 4 * h) * 0.1).astype(np.float32),
            (rng.randn(h, 4 * h) * 0.1).astype(np.float32),
            (rng.randn(4 * h) * 0.1).astype(np.float32)]


def _torch(arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


def _close(got, want, tol=TOL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", SHAPES)
def test_matches_pallas_kernel(shape):
    arrays = _inputs(*shape)
    want = jax_fused_lstm(*[jnp.asarray(a) for a in arrays])
    got = fused_lstm(*_torch(arrays))
    _close(got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_matches_scan_reference(shape):
    arrays = _inputs(*shape, seed=1)
    want = _lstm_scan_ref(*[jnp.asarray(a) for a in arrays])
    got = fused_lstm_plain(*_torch(arrays))
    _close(got, want)


def test_output_dtype_follows_x():
    arrays = _torch(_inputs(3, 2, 4, 5))
    arrays[0] = arrays[0].double()
    hseq, hn, cn = fused_lstm(*arrays)
    assert hseq.dtype == hn.dtype == cn.dtype == torch.float64
    assert hseq.shape == (3, 2, 5) and hn.shape == cn.shape == (2, 5)
    np.testing.assert_array_equal(hseq[-1].numpy(), hn.numpy())


def test_cpu_path_launches_no_kernel():
    before = fused_lstm.launches
    fused_lstm(*_torch(_inputs(2, 2, 3, 4)))
    assert fused_lstm.launches == before


def test_non_cpu_tensor_never_takes_the_plain_version():
    # meta tensors (shape inference) have no kernel: the wrapper raises
    meta = [torch.empty(a.shape, device="meta")
            for a in _inputs(2, 2, 3, 4)]
    with pytest.raises(MXNetError, match="no kernel"):
        fused_lstm(*meta)


@pytest.mark.parametrize("bad", ["h0", "wx", "wh", "b", "x"])
def test_shape_checks(bad):
    x, h0, c0, wx, wh, b = _torch(_inputs(2, 3, 4, 5))
    args = {"x": x, "h0": h0, "c0": c0, "wx": wx, "wh": wh, "b": b}
    args[bad] = args[bad][..., :-1] if bad != "x" else x[0]
    with pytest.raises(MXNetError):
        lstm_kernel._check(args["x"], args["h0"], args["c0"], args["wx"],
                           args["wh"], args["b"])


# an H100 SXM: 132 SMs, 232,448 bytes of shared memory a block may opt in to
SMS, SMEM = 132, 232448


@pytest.mark.parametrize("batch", [1, 8, 32, 64])
def test_route_is_persistent_at_h650(batch):
    plan = lstm_kernel._lstm_route(batch, 650, SMS, SMEM)
    assert plan.route == "persistent"
    assert plan.grid <= SMS and plan.smem <= SMEM
    assert plan.rows == batch            # all of h in one tile


@pytest.mark.parametrize("batch,hid", [(4, 1536), (32, 1300), (1, 4096)])
def test_route_takes_steps_where_wh_cannot_fit(batch, hid):
    plan = lstm_kernel._lstm_route(batch, hid, SMS, SMEM)
    assert plan.route == "step"
    assert plan.grid == -(-hid // 32) * -(-batch // 8)


@pytest.mark.parametrize("batch,hid", [(1, 650), (32, 650), (64, 650),
                                       (100, 650), (1000, 650), (4, 13),
                                       (100, 13),
                                       (3, 8), (8, 131), (8, 133),
                                       (32, 1100), (4, 1300)])
def test_route_plan_covers_every_unit_once(batch, hid):
    plan = lstm_kernel._lstm_route(batch, hid, SMS, SMEM)
    assert plan.route == "persistent" and plan.grid <= SMS
    owned = [j for p in range(plan.grid)
             for j in range(p * plan.units, min(hid, (p + 1) * plan.units))]
    assert owned == list(range(hid))                 # each unit once
    assert (plan.grid - 1) * plan.units < hid        # no block without one
    # row tiles of 8-row items cover the batch; Wh's slice and one tile of
    # h (rows padded to a multiple of 4) fit the block
    assert plan.rows == batch <= 64 or (plan.rows < batch
                                        and plan.rows % 8 == 0
                                        and plan.rows <= 64)
    hp = -(-hid // 4) * 4
    assert plan.smem == 4 * hp * (4 * plan.units + plan.rows) <= SMEM


# K3 (lstm_bwd_recurrence): its own route function, the same two routes
@pytest.mark.parametrize("batch", [1, 8, 32, 64])
def test_bwd_route_is_persistent_at_h650(batch):
    plan = lstm_kernel._lstm_bwd_route(batch, 650, SMS, SMEM)
    assert plan == lstm_kernel.LSTMPlan("persistent", 130, 5, batch,
                                        plan.smem)
    assert plan.smem <= SMEM


@pytest.mark.parametrize("batch,hid", [(4, 1536), (32, 1300), (1, 4096),
                                       (64, 1200)])
def test_bwd_route_takes_steps_where_wh_cannot_fit(batch, hid):
    plan = lstm_kernel._lstm_bwd_route(batch, hid, SMS, SMEM)
    assert plan.route == "step"
    assert plan.grid == -(-hid // 32) * -(-batch // 8)


def _bwd_smem(grid, units, rows):
    """csrc/lstm_bwd_persistent.cuh::lstm_bwd_smem: the Wh slice, the
    tile's slab of partials (4 floats of padding a writer), and each 8-row
    group's dgates (4 floats of padding) and the four partial sums of its
    carries."""
    groups, slot = -(-rows // 8), 8 * units
    wh_stride = 4 * units * units + (0 if units % 2 else 4)
    return 4 * (grid * wh_stride + grid * (groups * slot + 4)
                + groups * (4 * slot + 4 + 4 * slot))


@pytest.mark.parametrize("batch,hid", [(1, 650), (32, 650), (64, 650),
                                       (65, 650), (100, 650), (1000, 650),
                                       (4, 13), (100, 13), (3, 8), (8, 131),
                                       (8, 133), (32, 1100), (4, 1180)])
def test_bwd_route_plan_covers_every_unit_once(batch, hid):
    plan = lstm_kernel._lstm_bwd_route(batch, hid, SMS, SMEM)
    assert plan.route == "persistent" and plan.grid <= SMS
    assert 1 <= plan.units <= lstm_kernel._BWD_MAX_UNITS
    owned = [j for p in range(plan.grid)
             for j in range(p * plan.units, min(hid, (p + 1) * plan.units))]
    assert owned == list(range(hid))                 # each unit once
    assert (plan.grid - 1) * plan.units < hid        # no block without one
    # the slab, the dgates and the Wh slice fit the plan's shared memory
    assert plan.smem == _bwd_smem(plan.grid, plan.units, plan.rows) <= SMEM
    # all rows in one tile, or row tiles of whole 8-row groups
    assert plan.rows == batch or (plan.rows < batch and plan.rows % 8 == 0)


@pytest.mark.parametrize("batch,rows", [(65, 64), (100, 64), (1000, 64)])
def test_bwd_route_walks_large_batches_in_row_tiles(batch, rows):
    plan = lstm_kernel._lstm_bwd_route(batch, 650, SMS, SMEM)
    assert plan.route == "persistent" and plan.rows == rows
    # one more group would not fit
    assert _bwd_smem(plan.grid, plan.units, rows + 8) > SMEM


def test_bwd_route_tiles_when_the_slice_leaves_room_for_few_groups():
    # H = 1100: 9 units a block, 123 blocks; the Wh slice takes 159 KB and
    # one 8-row group of 36 KB fits beside it
    plan = lstm_kernel._lstm_bwd_route(32, 1100, SMS, SMEM)
    assert plan == lstm_kernel.LSTMPlan("persistent", 123, 9, 8,
                                        _bwd_smem(123, 9, 8))


def test_build_name_follows_headers(tmp_path, monkeypatch):
    for src in _build.CSRC.iterdir():
        if src.suffix in (".cu", ".cuh"):
            shutil.copy(src, tmp_path / src.name)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {n: _build._target(n)[1].name for n in _build.SOURCES}
    assert before == {n: _build._target(n)[1].name for n in _build.SOURCES}
    header = tmp_path / "lstm_persistent.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build._target(n)[1].name for n in _build.SOURCES}
    assert all(after[n] != before[n] for n in _build.SOURCES)
