"""The port's detection slice against the JAX package's, op by op.

Every op of `mxnet_tpu/ops/contrib_ops.py` and every ported op of
`mxnet_tpu/ops/detection.py` has cases in the one table of the slice,
`mxnet_tpu_torch/tools/detection_sweep.py` (the examples' shapes, with
ties, both box formats, ``force_suppress``, ``nms_topk``,
``background_id`` != 0, empty labels, hard-negative mining, samples
outside the image): each case's numpy inputs go to the JAX op's
``fcompute`` and to the port's on the CPU. Forward outputs are held at
f32 rtol 1e-5, atol 1e-6 (``exact`` cases, and index outputs, by value:
the JAX package runs with x64, so its indices are wider), and the
gradients of the inputs the case names against ``jax.vjp`` of the JAX
op under the same cotangents at rtol 1e-4, atol 1e-5. The JAX package
computes ``_affine_grid`` in f64 (``jnp.linspace`` under x64) and the port
in f32; the difference stays inside these tolerances.

The port's plain greedy NMS is held against the JAX function itself at N
up to 512, with ties and classes. ``ProposalTarget``'s random path cannot
draw the JAX package's numbers: where its quotas do not bind it must
give the same rows as a multiset, where they bind it must keep its
invariants, and the same ``mx.random.seed`` must give the same rows; its
``ohem=True`` path is a case of the table, held exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu
from mxnet_tpu.ops import contrib_ops as jax_contrib
from mxnet_tpu.ops import detection as jax_detection
from mxnet_tpu.ops.registry import _OPS as JAX_OPS
from mxnet_tpu.ops.registry import get_op as jax_get_op
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.ops import contrib_ops, detection
from mxnet_tpu_torch.ops.registry import _OPS, get_op
from mxnet_tpu_torch.tools import detection_sweep as sweep
from torch_parity import jax_ops_of

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5

#: the ops of detection.py that wait for later PRs (ROADMAP A.11)
NOT_PORTED = {"ProposalMaskTarget", "PostDetection", "Correlation",
              "Correlation1D", "LSoftmax", "weighted_l1", "WeightedL1",
              "MultiLogistic", "multi_logistic", "_contrib_BallQuery",
              "BallQuery", "_contrib_FarthestPointSampling",
              "FarthestPointSampling", "_contrib_ThreeNN", "ThreeNN",
              "_contrib_SigmoidCrossEntropy", "SigmoidCrossEntropy", "Crop"}


#: ops whose gradient splits over ties between interpolated or pooled
#: values: the JAX op runs eagerly, as ``nd`` calls it; compiled, XLA
#: contracts its products and rounds them otherwise, which moves the ties
EAGER = {"ROIPooling", "_contrib_ROIAlign_v2"}


def _jax_run(case):
    params = dict(case.params, _is_train=False,
                  _rng_key=jax.random.PRNGKey(0))
    fn = jax_get_op(case.name).fcompute
    jit = (lambda f: f) if case.name in EAGER else jax.jit
    ins = [jnp.asarray(a) for a in case.arrays]
    if not case.grad:
        return [np.asarray(o) for o in
                jit(lambda *xs: tuple(fn(params, *xs)))(*ins)], []

    def f(*diff):
        full = list(ins)
        for i, d in zip(case.grad, diff):
            full[i] = d
        return tuple(fn(params, *full))

    outs, vjp = jax.vjp(jit(f), *[ins[i] for i in case.grad])
    return [np.asarray(o) for o in outs], outs, vjp


def _values(a):
    a = np.asarray(a)
    return a.astype(np.float64) if not np.issubdtype(a.dtype, np.floating) \
        else a


@pytest.mark.parametrize("case", [pytest.param(c, id="%s-%d" % (c.name, i))
                                  for i, c in enumerate(sweep.CASES)])
def test_op(case):
    got, grads = sweep.run_case(case, mxt.cpu())
    res = _jax_run(case)
    want = res[0]
    assert len(got) == len(want), case
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape), case
        if case.family == "exact" or not np.issubdtype(w.dtype, np.floating):
            np.testing.assert_array_equal(_values(g.numpy()), _values(w),
                                          str(case))
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL,
                                       err_msg=str(case))
    if case.grad:
        _, outs, vjp = res
        cots = []
        for k, (o, g) in enumerate(zip(outs, got)):
            cot = sweep._cotangent(case, k, g.shape)
            diff = np.issubdtype(np.asarray(o).dtype, np.floating) and \
                k in _float_heads(case)
            cots.append(jnp.asarray(cot.numpy() if diff else
                                    np.zeros(o.shape, np.asarray(o).dtype)))
        want_g = vjp(tuple(cots))
        assert len(grads) == len(want_g)
        for g, w in zip(grads, want_g):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=str(case))


def _float_heads(case):
    """The outputs of the port's op that carry a gradient."""
    ins = [torch.from_numpy(np.ascontiguousarray(a)) for a in case.arrays]
    for i in case.grad:
        ins[i].requires_grad_(True)
    with torch.enable_grad():
        outs = get_op(case.name).fcompute(
            dict(case.params, _ctx=mxt.cpu(), _is_train=False), *ins)
    return {k for k, o in enumerate(outs) if o.requires_grad}


def test_every_contrib_op_is_ported():
    jax_ops = jax_ops_of("contrib_ops.py")
    assert jax_ops <= set(_OPS)
    for name in jax_ops:     # the same aliases reach the same op
        assert (JAX_OPS[name].name == _OPS[name].name), name
    # flash attention's cases are tests/test_torch_attention.py's
    covered = {get_op(c.name).name for c in sweep.CASES}
    assert {JAX_OPS[n].name for n in jax_ops} - covered == \
        {"_contrib_flash_attention"}


def test_unported_detection_ops_are_the_roadmap_list():
    jax_ops = jax_ops_of("detection.py")
    assert jax_ops - set(_OPS) == NOT_PORTED
    covered = {get_op(c.name).name for c in sweep.CASES}
    assert {JAX_OPS[n].name for n in jax_ops - NOT_PORTED} <= covered


# ---------------------------------------------------------------------------
# greedy NMS: the port's plain version against the JAX function
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 7, 63, 64, 65, 200, 512])
@pytest.mark.parametrize("force", [False, True])
def test_greedy_nms_keep_matches_jax(n, force):
    boxes, scores, valid, cls = sweep.nms_inputs(2, n, seed=n)
    for topk, thresh in ((-1, 0.7), (1, 0.5), (max(1, n // 3), 0.3),
                         (n + 5, 0.5)):
        got = contrib_ops.greedy_nms_keep(
            torch.from_numpy(boxes), torch.from_numpy(scores),
            torch.from_numpy(valid), torch.from_numpy(cls), thresh, topk,
            force)
        want = jax.jit(jax.vmap(lambda b, s, v, c: jax_contrib.greedy_nms_keep(
            b, s, v, c, thresh, topk, force)))(
                jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid),
                jnp.asarray(cls))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_greedy_nms_keep_identical_boxes():
    boxes, scores, valid, cls = sweep.nms_inputs(1, 40, 0, identical=True)
    got = contrib_ops.greedy_nms_keep(
        torch.from_numpy(boxes), torch.from_numpy(scores),
        torch.from_numpy(valid), None, 0.5, -1, True)
    want = jax_contrib.greedy_nms_keep(
        jnp.asarray(boxes[0]), jnp.asarray(scores[0]), jnp.asarray(valid[0]),
        None, 0.5, -1, True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
    assert got.sum() == 1


def test_greedy_nms_on_meta_tensors_gives_the_shape():
    boxes = torch.zeros((1, 3, 4), device="meta")
    assert mxt.ops.greedy_nms(boxes, torch.ones((1, 3), dtype=torch.bool,
                                                device="meta"),
                              None, 0.5).device.type == "meta"


# ---------------------------------------------------------------------------
# ProposalTarget's random path
# ---------------------------------------------------------------------------
PT = {"num_classes": 3, "fg_fraction": 0.5, "fg_thresh": 0.5,
      "bg_thresh_hi": 0.5, "bg_thresh_lo": 0.0}


def _pt_inputs(seed, rois_per_image, n_rois):
    rng = np.random.RandomState(seed)
    gt = np.full((2, 2, 5), -1.0, np.float32)
    gt[:, 0] = [[10, 10, 40, 40, 1], [20, 5, 50, 30, 2]]
    gt[1, 1] = [5, 30, 25, 60, 1]
    rois = np.zeros((2, n_rois, 5), np.float32)
    rois[1, :, 0] = 1
    for b in range(2):
        g = gt[b, 0, :4]
        jitter = rng.uniform(-12, 12, (n_rois, 4))
        rois[b, :, 1:] = np.clip(g + jitter, 0, 63)
        rois[b, :, 3:] = np.maximum(rois[b, :, 3:], rois[b, :, 1:3] + 2)
    params = dict(PT, batch_images=2, batch_rois=2 * rois_per_image)
    return rois, gt, params


def _rows(outs, b, per):
    rois, label, target, weight = (np.asarray(o) for o in outs)
    sl = slice(b * per, (b + 1) * per)
    rows = np.concatenate([rois[sl], label[sl, None], target[sl],
                           weight[sl]], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


def test_proposal_target_free_quotas_match_jax_as_multisets():
    """7 rois + one valid gt box an image, 16 rois an image: every fg
    and every bg candidate is taken (bg_thresh_lo 0 leaves no padding
    pool), each twice or every row as often, so the rows are the JAX
    package's rows whatever the draws."""
    rois, gt, params = _pt_inputs(0, 16, 7)
    gt[1, 1] = -1.0     # 8 candidates in both images
    outs = get_op("ProposalTarget").fcompute(
        dict(params, _generator=torch.Generator().manual_seed(5)),
        torch.from_numpy(rois), torch.from_numpy(gt))
    want = jax.jit(lambda r, g: jax_get_op("ProposalTarget").fcompute(
        dict(params, _rng_key=jax.random.PRNGKey(1)), r, g))(
            jnp.asarray(rois), jnp.asarray(gt))
    for b in range(2):
        np.testing.assert_allclose(_rows(outs, b, 16), _rows(want, b, 16),
                                   rtol=RTOL, atol=ATOL)


def test_proposal_target_bound_quotas_keep_the_invariants():
    rois, gt, params = _pt_inputs(1, 8, 40)
    outs = get_op("ProposalTarget").fcompute(
        dict(params, _generator=torch.Generator().manual_seed(0)),
        torch.from_numpy(rois), torch.from_numpy(gt))
    out_rois, label, target, weight = (o.numpy() for o in outs)
    mean, std, _ = detection._pt_params(params)
    for b in range(2):
        sl = slice(b * 8, (b + 1) * 8)
        cand = np.concatenate([rois[b, :, 1:], gt[b, :, :4][gt[b, :, 4]
                                                             != -1]])
        valid = gt[b, :, 4] != -1
        iou = np.asarray(jax_detection._bbox_overlap_plus1(
            jnp.asarray(cand), jnp.asarray(gt[b, valid, :4])))
        n_fg = int((iou.max(1) >= 0.5).sum())
        assert (label[sl] > 0).sum() == min(n_fg, 4)
        for r, lab, t, w in zip(out_rois[sl], label[sl], target[sl],
                                weight[sl]):
            assert r[0] == b
            cols = np.zeros(12, bool)
            if lab > 0:
                cols[int(lab) * 4:int(lab) * 4 + 4] = True
            assert not w[~cols].any() and not t[~cols].any()
            assert (w[cols] == 1).all()
            if lab > 0:
                ov = np.asarray(jax_detection._bbox_overlap_plus1(
                    jnp.asarray(r[None, 1:]), jnp.asarray(gt[b, valid, :4])))
                g = gt[b, valid][ov[0].argmax()]
                assert g[4] == lab
                want = np.asarray(jax_detection._bbox_transform_norm(
                    jnp.asarray(r[None, 1:]), jnp.asarray(g[None, :4]),
                    jnp.asarray(mean), jnp.asarray(std)))[0]
                np.testing.assert_allclose(t[cols], want, rtol=RTOL,
                                           atol=ATOL)


def test_proposal_target_same_seed_same_rows():
    rois, gt, params = _pt_inputs(2, 8, 40)
    ctx = mxt.cpu()

    def draw(seed):
        mxt.random.seed(seed)
        outs = mxt.nd.ProposalTarget(mxt.nd.array(rois, ctx=ctx),
                                     mxt.nd.array(gt, ctx=ctx), **params)
        return [o.asnumpy() for o in outs]

    a, b, c = draw(3), draw(3), draw(4)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert any(not np.array_equal(x, y) for x, y in zip(a, c))


# ---------------------------------------------------------------------------
# ties and edges the table's cases rely on, spelled out
# ---------------------------------------------------------------------------
def test_roi_pooling_splits_the_gradient_over_ties():
    data = torch.ones((1, 1, 4, 4), requires_grad=True)
    rois = torch.tensor([[0.0, 0.0, 0.0, 3.0, 3.0]])
    out = get_op("ROIPooling").fcompute(
        {"pooled_size": (1, 1), "spatial_scale": 1.0}, data, rois)[0]
    out.sum().backward()
    np.testing.assert_allclose(data.grad.numpy(), np.full((1, 1, 4, 4),
                                                          1 / 16.0))


def test_bilinear_sampler_reads_zero_outside():
    data = torch.ones((1, 1, 3, 3))
    grid = torch.tensor([[[[-3.0, 0.0]], [[0.0, 0.0]]]])     # x -3: outside
    out = get_op("BilinearSampler").fcompute({}, data, grid)[0]
    np.testing.assert_array_equal(out.numpy().ravel(), [0.0, 1.0])


def test_ops_reach_nd_and_sym_contrib():
    for name in ("MultiBoxPrior", "MultiBoxTarget", "MultiBoxDetection",
                 "Proposal", "MultiProposal", "box_nms", "box_iou",
                 "bipartite_matching", "DeformableConvolution",
                 "PSROIPooling", "DeformablePSROIPooling", "ROIAlign_v2",
                 "fft", "ifft", "count_sketch", "quadratic"):
        assert hasattr(mxt.nd.contrib, name), name
        assert hasattr(mxt.sym.contrib, name), name
    for name in ("ROIPooling", "ProposalTarget", "BilinearSampler",
                 "GridGenerator", "SpatialTransformer", "Custom"):
        assert hasattr(mxt.nd, name) and hasattr(mxt.sym, name), name


def test_symbol_shape_inference_through_detection_ops():
    data = mxt.sym.Variable("data")
    anchors = mxt.sym.contrib.MultiBoxPrior(data, sizes=(0.3, 0.5),
                                            ratios=(1.0, 2.0, 0.5))
    _, out_shapes, _ = anchors.infer_shape(data=(2, 8, 6, 5))
    assert out_shapes == [(1, 6 * 5 * 4, 4)]
