"""The port's sparse arrays, sparse ops and lazy row-sparse updates against
the JAX package's.

Every test of `tests/test_sparse.py` runs as a parity case: the same
numpy inputs go through ``mxnet_tpu`` and ``mxnet_tpu_torch`` on the CPU,
and what the JAX test reads is compared (f32, rtol 1e-6; the dot
products, summed in another order, 1e-5 as the JAX tests hold them). The
port's structural promises are held beside them: a compact array is never
made dense where the JAX test says so (its ``_materialize`` calls
counted: 0), and an in-place write drops the compact form. The eight ops
of the JAX ``compat_ops.py`` sparse block run under every name and alias
through ``nd`` (rtol 1e-6). The lazy updates (``sgd``, ``sgd_mom``,
``adam``, ``adagrad``; clipping off and on; wd 0 and 1e-4; f32 weights, and
bf16 for the two SGD formulas) run three pushes through each package's
optimizer (weights and states rtol 1e-6, atol 1e-7, bf16 weights one bf16
step; the rows no push names exactly as they were). A sparse-embedding
loop (the example's, at 2,000 x 8) runs 5 steps through both packages'
kvstores (weights after each step, rtol 1e-5).
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt
from mxnet_tpu.ndarray import sparse as jsp
from mxnet_tpu_torch.ndarray import sparse as tsp

TOL = {"rtol": 1e-6, "atol": 1e-7}
DOT_TOL = {"rtol": 1e-5, "atol": 1e-6}
DENSE = np.array([[0, 1, 0], [2, 0, 3], [0, 0, 0], [4, 0, 0]], "f")
PKGS = ((mx, jsp), (mxt, tsp))


@pytest.fixture
def densified(monkeypatch):
    """Counts of the port's dense views made from a compact payload."""
    counts = {"csr": 0, "row_sparse": 0}
    for cls in (tsp.CSRNDArray, tsp.RowSparseNDArray):
        orig = cls._materialize

        def counted(self, *a, _orig=orig, **kw):
            counts[self.stype] += 1
            return _orig(self, *a, **kw)
        monkeypatch.setattr(cls, "_materialize", counted)
    return counts


def _both(case):
    """``case(mx, sparse)`` in each package: (JAX's readings, the
    port's)."""
    return [case(pkg, sp) for pkg, sp in PKGS]


def _same(want, got, tol=TOL):
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64),
                                   err_msg=k, **tol)


# -- tests/test_sparse.py, each as a parity case ----------------------------
def _csr_creation_and_fields(pkg, sp):
    csr = sp.csr_matrix(DENSE)
    return {"stype": [csr.stype == "csr"], "dense": csr.todense().asnumpy(),
            "indptr": csr.indptr.asnumpy(), "indices": csr.indices.asnumpy(),
            "data": csr.data.asnumpy()}


def _row_sparse_creation_and_retain(pkg, sp):
    rs = sp.row_sparse_array(DENSE)
    kept = rs.retain(pkg.nd.array(np.array([1], "f")))
    return {"stype": [rs.stype == "row_sparse"],
            "indices": rs.indices.asnumpy(), "dense": rs.todense().asnumpy(),
            "kept": kept.todense().asnumpy()}


def _cast_storage_roundtrip(pkg, sp):
    out = {}
    for stype in ("csr", "row_sparse"):
        s = sp.cast_storage(pkg.nd.array(DENSE), stype)
        out[stype] = [s.stype == stype]
        out[stype + "_back"] = sp.cast_storage(s, "default").asnumpy()
    return out


def _rhs(seed, rows=3):
    return np.random.RandomState(seed).rand(rows, 5).astype("f")


def _sparse_dot(pkg, sp):
    return {"out": sp.dot(sp.csr_matrix(DENSE),
                          pkg.nd.array(_rhs(0))).asnumpy()}


def _sparse_zeros_and_tostype(pkg, sp):
    z = sp.zeros("row_sparse", (3, 4))
    dn = pkg.nd.array(DENSE)
    return {"z": z.todense().asnumpy(), "stype": [z.stype == "row_sparse"],
            "csr": [dn.tostype("csr").stype == "csr"],
            "default": dn.tostype("default").asnumpy()}


def _kvstore_rowsparse_push_and_pull(pkg, sp):
    kv = pkg.kv.create("local")
    kv.init("emb", pkg.nd.zeros((4, 3)))
    kv.push("emb", sp.row_sparse_array(DENSE))
    out = pkg.nd.zeros((4, 3))
    kv.pull("emb", out=out)
    pulled = out.asnumpy()
    kv.row_sparse_pull("emb", out=out,
                       row_ids=pkg.nd.array(np.array([1, 3], "f")))
    return {"pulled": pulled, "rows": out.asnumpy()}


def _embedding_grad_touches_only_used_rows(pkg, sp):
    w = pkg.nd.array(np.random.RandomState(1).rand(10, 4).astype("f"))
    w.attach_grad()
    idx = pkg.nd.array(np.array([2.0, 5.0, 2.0], "f"))
    with pkg.autograd.record():
        loss = pkg.nd.Embedding(idx, w, input_dim=10, output_dim=4).sum()
    loss.backward()
    return {"grad": w.grad.asnumpy()}


def _sparse_sgd_semantics(pkg, sp):
    w = pkg.nd.ones((3, 2))
    g = pkg.nd.array(np.array([[1, 1], [0, 0], [1, 1]], "f"))
    h = pkg.nd.zeros((3, 2))
    new_w = pkg.nd.sparse_adagrad_update(w, g, h, lr=0.5)
    return {"w": new_w.asnumpy(), "h": h.asnumpy()}


BIG_IDX = np.array([3, 77, 1000, 5000, 99999, 500000, 700000, 999999])


def _compact_storage_never_densifies(pkg, sp):
    rs = sp.row_sparse_array((np.ones((8, 64), "f"), BIG_IDX),
                             shape=(1_000_000, 64))
    kept = rs.retain(pkg.nd.array(np.array([77.0, 500000.0], "f")))
    z = sp.zeros("row_sparse", (1_000_000, 64))
    return {"nnz": [rs.nnz, kept.nnz, z.nnz], "compact": [
        rs.has_compact(), rs._dense is None, kept._dense is None,
        z._dense is None], "kept": kept.data.asnumpy(),
        "kept_rows": kept.indices.asnumpy()}


def _sparse_dot_stays_compact(pkg, sp):
    csr = sp.csr_matrix(DENSE)
    out = sp.dot(csr, pkg.nd.array(_rhs(0))).asnumpy()
    return {"out": out, "compact": [csr.has_compact(), csr._dense is None]}


UPDATE_IDX = np.array([0, 5, 100, 1000, 65536, 99999, 500000, 999999])
UNTOUCHED = [1, 4, 99, 12345, 999998]


def _sparse_sgd_update_cost_scales_with_nnz(pkg, sp):
    w = pkg.nd.ones((1_000_000, 4))
    g = sp.row_sparse_array((np.full((8, 4), 2.0, "f"), UPDATE_IDX),
                            shape=(1_000_000, 4))
    opt = pkg.optimizer.SGD(learning_rate=0.5, momentum=0.9,
                            rescale_grad=1.0)
    state = opt.create_state(0, w)
    opt.update(0, w, g, state)
    out, st = w.asnumpy(), state.asnumpy()
    return {"w_rows": out[UPDATE_IDX], "w_untouched": out[UNTOUCHED],
            "m_rows": st[UPDATE_IDX], "m_untouched": st[UNTOUCHED],
            "w_sum": [out.sum()], "m_sum": [st.sum()]}


def _sparse_adam_matches_dense_on_live_rows(pkg, sp):
    rng = np.random.RandomState(0)
    wv = rng.rand(50, 3).astype("f")
    gv = np.zeros((50, 3), "f")
    live = np.array([2, 7, 31])
    gv[live] = rng.rand(3, 3)
    wd_ = pkg.nd.array(wv)
    opt_d = pkg.optimizer.Adam(learning_rate=0.1, rescale_grad=1.0,
                               lazy_update=False)
    opt_d.update(0, wd_, pkg.nd.array(gv), opt_d.create_state(0, wd_))
    ws = pkg.nd.array(wv)
    opt_s = pkg.optimizer.Adam(learning_rate=0.1, rescale_grad=1.0)
    opt_s.update(0, ws, sp.row_sparse_array((gv[live], live), shape=(50, 3)),
                 opt_s.create_state(0, ws))
    return {"dense": wd_.asnumpy(), "lazy": ws.asnumpy()}


def _rowsparse_pull_moves_compact_payload(pkg, sp):
    kv = pkg.kv.create("local")
    big = np.zeros((10000, 16), "f")
    big[7], big[42], big[9999] = 1.0, 2.0, 3.0
    kv.init("emb", pkg.nd.array(big))
    out = sp.zeros("row_sparse", (10000, 16))
    kv.row_sparse_pull("emb", out=out,
                       row_ids=pkg.nd.array(np.array([7, 9999], "f")))
    return {"compact": [out.has_compact(), out.nnz == 2,
                        out._dense is None],
            "data": out.data.asnumpy(), "indices": out.indices.asnumpy()}


def _push_merges_compact_rowsparse(pkg, sp):
    kv = pkg.kv.create("local")
    kv.init("w", pkg.nd.zeros((100, 2)))
    a = sp.row_sparse_array((np.ones((2, 2), "f"), np.array([1, 50])),
                            shape=(100, 2))
    b = sp.row_sparse_array((np.ones((2, 2), "f"), np.array([50, 99])),
                            shape=(100, 2))
    kv.push("w", [a, b])
    out = pkg.nd.zeros((100, 2))
    kv.pull("w", out=out)
    return {"out": out.asnumpy()}


def _cast_storage_rs_csr_compact(pkg, sp):
    csr = sp.cast_storage(sp.row_sparse_array(DENSE), "csr")
    back = sp.cast_storage(csr, "row_sparse")
    return {"indptr": csr.indptr.asnumpy(), "indices": csr.indices.asnumpy(),
            "data": csr.data.asnumpy(), "back": back.indices.asnumpy(),
            "dense": back.todense().asnumpy()}


def _dense_mutation_invalidates_compact(pkg, sp):
    rs = sp.row_sparse_array(DENSE)
    rs[:] = np.ones_like(DENSE)
    return {"dense": rs.todense().asnumpy(), "nnz": [rs.nnz],
            "indices": rs.indices.asnumpy()}


def _cast_storage_rs_csr_unsorted_indices(pkg, sp):
    rs = sp.row_sparse_array((np.array([[1, 1], [2, 2]], "f"),
                              np.array([3, 0])), shape=(5, 2))
    csr = sp.cast_storage(rs, "csr")
    return {"csr": csr.todense().asnumpy(), "rs": rs.todense().asnumpy()}


def _dot_grad(pkg, sp, seed, rows, transpose_a, square):
    rhs = pkg.nd.array(_rhs(seed, rows))
    rhs.attach_grad()
    with pkg.autograd.record():
        out = sp.dot(sp.csr_matrix(DENSE), rhs, transpose_a=transpose_a)
        loss = (out * out).sum() if square else out.sum()
    loss.backward()
    return out.asnumpy(), rhs.grad.asnumpy()


def _sparse_dot_differentiable_under_record(pkg, sp):
    out, grad = _dot_grad(pkg, sp, 0, 3, False, False)
    return {"out": out, "grad": grad}


def _sparse_dot_under_record_never_densifies(pkg, sp):
    out, grad = _dot_grad(pkg, sp, 1, 3, False, False)
    out_t, grad_t = _dot_grad(pkg, sp, 2, 4, True, True)
    return {"out": out, "grad": grad, "out_t": out_t, "grad_t": grad_t}


JAX_CASES = {
    "csr_creation_and_fields": (_csr_creation_and_fields, TOL),
    "row_sparse_creation_and_retain": (_row_sparse_creation_and_retain, TOL),
    "cast_storage_roundtrip": (_cast_storage_roundtrip, TOL),
    "sparse_dot": (_sparse_dot, DOT_TOL),
    "sparse_zeros_and_tostype": (_sparse_zeros_and_tostype, TOL),
    "kvstore_rowsparse_push_and_pull": (_kvstore_rowsparse_push_and_pull,
                                        TOL),
    "embedding_grad_touches_only_used_rows": (
        _embedding_grad_touches_only_used_rows, TOL),
    "sparse_sgd_semantics": (_sparse_sgd_semantics, TOL),
    "compact_storage_never_densifies": (_compact_storage_never_densifies,
                                        TOL),
    "sparse_dot_stays_compact": (_sparse_dot_stays_compact, DOT_TOL),
    "sparse_sgd_update_cost_scales_with_nnz": (
        _sparse_sgd_update_cost_scales_with_nnz, TOL),
    "sparse_adam_matches_dense_on_live_rows": (
        _sparse_adam_matches_dense_on_live_rows, TOL),
    "rowsparse_pull_moves_compact_payload": (
        _rowsparse_pull_moves_compact_payload, TOL),
    "push_merges_compact_rowsparse": (_push_merges_compact_rowsparse, TOL),
    "cast_storage_rs_csr_compact": (_cast_storage_rs_csr_compact, TOL),
    "dense_mutation_invalidates_compact": (
        _dense_mutation_invalidates_compact, TOL),
    "cast_storage_rs_csr_unsorted_indices": (
        _cast_storage_rs_csr_unsorted_indices, TOL),
    "sparse_dot_differentiable_under_record": (
        _sparse_dot_differentiable_under_record, DOT_TOL),
    "sparse_dot_under_record_never_densifies": (
        _sparse_dot_under_record_never_densifies, DOT_TOL),
}


def test_every_jax_sparse_test_is_a_case():
    src = (Path(__file__).parent / "test_sparse.py").read_text()
    names = {line[len("def test_"):line.index("(")]
             for line in src.splitlines() if line.startswith("def test_")}
    assert names == set(JAX_CASES)


@pytest.mark.parametrize("name", sorted(JAX_CASES))
def test_jax_sparse_case(name):
    case, tol = JAX_CASES[name]
    want, got = _both(case)
    _same(want, got, tol)


# -- the port's compact economics --------------------------------------------
def test_compact_storage_never_densifies(densified):
    _compact_storage_never_densifies(mxt, tsp)
    z = tsp.zeros("row_sparse", (1_000_000, 64))
    assert z.nnz == 0 and z.data.shape == (0, 64)
    assert densified == {"csr": 0, "row_sparse": 0}


def test_sparse_dot_under_record_never_densifies(densified):
    _sparse_dot_under_record_never_densifies(mxt, tsp)
    _sparse_dot_stays_compact(mxt, tsp)
    assert densified == {"csr": 0, "row_sparse": 0}


def test_push_merges_compact_rowsparse(densified):
    """A compact push is merged by add_rows and written into the store
    without a dense view, with and without an updater; so is a
    row_sparse_pull into a row-sparse or dense ``out``."""
    _push_merges_compact_rowsparse(mxt, tsp)
    _rowsparse_pull_moves_compact_payload(mxt, tsp)
    kv = mxt.kv.create("local")
    kv.init(0, mxt.nd.zeros((100, 2)))
    kv.set_optimizer(mxt.optimizer.Adam(learning_rate=0.1))
    kv.push(0, [tsp.row_sparse_array((np.ones((2, 2), "f"), np.array(r)),
                                     shape=(100, 2))
                for r in ([1, 50], [50, 99])])
    out = mxt.nd.zeros((100, 2))
    kv.row_sparse_pull(0, out=out, row_ids=mxt.nd.array([99.0, 1.0]))
    assert densified == {"csr": 0, "row_sparse": 0}
    got = out.asnumpy()
    assert (got[[1, 99]] < 0).all() and not got[[0, 50]].any()


def test_lazy_update_touches_only_pushed_rows():
    """The row-sparse gradient takes the lazy update: only its rows of the
    weight and states move (the rest bit-identical), and the optimizer's
    dense path is not run."""
    w0 = np.random.RandomState(3).randn(1000, 4).astype("f")
    w = mxt.nd.array(w0)
    opt = mxt.optimizer.Adam(learning_rate=0.1, wd=1e-4)
    mean, var = opt.create_state(0, w)
    g = tsp.row_sparse_array((np.ones((3, 4), "f"), np.array([5, 17, 900])),
                             shape=(1000, 4))
    opt.update(0, w, g, (mean, var))
    got = w.asnumpy()
    rest = np.setdiff1d(np.arange(1000), [5, 17, 900])
    np.testing.assert_array_equal(got[rest], w0[rest])
    assert not mean.asnumpy()[rest].any() and not var.asnumpy()[rest].any()
    assert (got[[5, 17, 900]] != w0[[5, 17, 900]]).all()


def test_in_place_writes_drop_the_compact_form():
    """``x[:] =``, ``x +=`` and an op's ``out=x`` write the dense view and
    drop the payload, which is then recomputed from the writes."""
    for write in (lambda x: x.__setitem__(slice(None), 2 * DENSE),
                  lambda x: x.__iadd__(mxt.nd.array(DENSE)),
                  lambda x: mxt.nd.broadcast_mul(mxt.nd.array(DENSE),
                                                 mxt.nd.array(2 * np.ones(
                                                     (4, 3), "f")), out=x)):
        rs = tsp.row_sparse_array(DENSE)
        assert rs.has_compact()
        write(rs)
        assert not rs.has_compact()
        np.testing.assert_array_equal(rs.asnumpy(), 2 * DENSE)
        np.testing.assert_array_equal(rs.indices.asnumpy(), [0, 1, 3])
        np.testing.assert_array_equal(rs.data.asnumpy(), 2 * DENSE[[0, 1, 3]])


def test_payload_reads_as_numpy_and_keeps_its_context():
    """``np.asarray`` on a payload array is a host copy (the example's
    ``np.asarray(out._ensure_aux()["values"])``); copies and moves keep
    the storage type."""
    rs = tsp.row_sparse_array(DENSE, ctx=mxt.cpu())
    vals = rs._ensure_aux()["values"]
    np.testing.assert_array_equal(np.asarray(vals), DENSE[[0, 1, 3]])
    assert np.asarray(vals, np.float64).dtype == np.float64
    assert isinstance(vals.tensor, torch.Tensor)
    for copy in (rs.copy(), rs.copyto(mxt.cpu()), rs.as_in_context(mxt.cpu())):
        assert copy.stype == "row_sparse" and copy.has_compact()
        np.testing.assert_array_equal(copy.asnumpy(), DENSE)
    into = tsp.zeros("row_sparse", (4, 3))
    rs.copyto(into)
    np.testing.assert_array_equal(into.indices.asnumpy(), [0, 1, 3])
    csr = tsp.zeros("csr", (4, 3))
    rs.copyto(csr)
    np.testing.assert_array_equal(csr.asnumpy(), DENSE)


def test_sparse_names_are_the_jax_packages():
    assert set(tsp.__all__) == set(jsp.__all__)
    for name in tsp.__all__:
        assert hasattr(tsp, name) and hasattr(mxt.nd.sparse, name)
    assert mxt.nd.sparse is tsp


def test_no_port_file_cites_a13():
    """Sparse storage, the kvstore and the lazy updates are ported: no
    message or docstring of the port still says they wait for A.13."""
    root = Path(mxt.__file__).parent
    hits = [str(p.relative_to(root)) for p in root.rglob("*.py")
            if "A.13" in p.read_text()]
    assert hits == []


def test_embedding_sparse_grad_gives_the_dense_gradient():
    """``nn.Embedding(sparse_grad=True)`` is accepted and its weight's
    gradient is the dense one the JAX layer gives."""
    x = np.array([[1, 3], [3, 0]], "f")
    grads = []
    for pkg in (mx, mxt):
        emb = pkg.gluon.nn.Embedding(5, 3, sparse_grad=True)
        with pkg.cpu():
            emb.initialize(pkg.init.Constant(0.5))
        with pkg.autograd.record():
            loss = (emb(pkg.nd.array(x)) * 2).sum()
        loss.backward()
        grads.append(emb.weight.grad().asnumpy())
    np.testing.assert_array_equal(grads[1], grads[0])
    assert grads[1].shape == (5, 3) and not grads[1][[2, 4]].any()


# -- the eight ops of the sparse block, under every name ---------------------
def _op_inputs():
    rng = np.random.RandomState(5)
    x = rng.randn(6, 4).astype("f")
    x[[1, 4]] = 0
    x[0, 2] = 0
    g = rng.randn(6, 4).astype("f")
    g[[2, 3]] = 0
    return x, g, np.abs(rng.randn(6, 4)).astype("f") + 0.5


OPS = [
    ("cast_storage", lambda nd, x, g, p: [nd.cast_storage(
        nd.array(x), stype="row_sparse")]),
    ("_sparse_retain", lambda nd, x, g, p: [nd._sparse_retain(
        nd.array(x), nd.array(np.array([0, 3, 5], "f")))]),
    ("sparse_retain", lambda nd, x, g, p: [nd.sparse_retain(
        nd.array(x), nd.array(np.array([2.0], "f")))]),
    ("_square_sum", lambda nd, x, g, p: [
        nd._square_sum(nd.array(x)), nd._square_sum(nd.array(x), axis=1),
        nd._square_sum(nd.array(x), axis=0, keepdims=True),
        nd._square_sum(nd.array(x), axis=(0, 1), keepdims=True)]),
    ("_scatter_elemwise_div", lambda nd, x, g, p: [
        nd._scatter_elemwise_div(nd.array(x), nd.array(p))]),
    ("_scatter_minus_scalar", lambda nd, x, g, p: [
        nd._scatter_minus_scalar(nd.array(x), scalar=0.75)]),
    ("_sparse_adagrad_update", lambda nd, x, g, p: _adagrad_op(
        nd, "_sparse_adagrad_update", x, g, p,
        {"lr": 0.3, "wd": 0.01, "rescale_grad": 0.5, "epsilon": 1e-6})),
    ("sparse_adagrad_update", lambda nd, x, g, p: _adagrad_op(
        nd, "sparse_adagrad_update", x, g, p,
        {"lr": 0.1, "clip_gradient": 0.4})),
    ("_contrib_SparseEmbedding", lambda nd, x, g, p: [
        nd._contrib_SparseEmbedding(nd.array(np.array([[0, 5], [2, 2]], "f")),
                                    nd.array(x), input_dim=6, output_dim=4),
        nd.contrib.SparseEmbedding(nd.array(np.array([4.0], "f")),
                                   nd.array(x), input_dim=6, output_dim=4)]),
    ("SparseEmbedding", lambda nd, x, g, p: [nd.SparseEmbedding(
        nd.array(np.array([1, 3, 3], "f")), nd.array(x), input_dim=6,
        output_dim=4)]),
    ("_identity_with_attr_like_rhs", lambda nd, x, g, p: [
        nd._identity_with_attr_like_rhs(nd.array(x), nd.array(g))]),
]


def _adagrad_op(nd, name, x, g, p, kw):
    hist = nd.array(p)
    out = getattr(nd, name)(nd.array(x), nd.array(g), hist, **kw)
    return [out, hist]


@pytest.mark.parametrize("name,call", OPS, ids=[o[0] for o in OPS])
def test_sparse_block_op_matches_jax(name, call):
    inputs = _op_inputs()
    want = [o.asnumpy() for o in call(mx.nd, *inputs)]
    got = [o.asnumpy() for o in call(mxt.nd, *inputs)]
    assert len(want) == len(got)
    for k, (a, b) in enumerate(zip(want, got)):
        assert a.shape == b.shape, (k, a.shape, b.shape)
        np.testing.assert_allclose(b, a, err_msg=str(k), **TOL)


def test_every_op_of_the_sparse_block_is_ported():
    from mxnet_tpu.ops.registry import get_op as jax_get_op
    from mxnet_tpu_torch.ops.registry import get_op
    names = {n for n, _ in OPS}
    assert len({jax_get_op(n) for n in names}) == 8
    for n in names:
        assert get_op(n).mutate_aux == jax_get_op(n).mutate_aux, n


# -- the lazy row-sparse updates ---------------------------------------------
ROWS, COLS = 40, 6
PUSH_ROWS = [np.array([0, 3, 7, 8, 20, 39]), np.array([3, 5, 7, 11, 21, 30]),
             np.array([1, 3, 8, 20, 22, 39])]
LAZY = [("sgd", {"momentum": 0.0}), ("sgd_mom", {"momentum": 0.9}),
        ("adam", {"beta1": 0.8, "beta2": 0.99}), ("adagrad", {"eps": 1e-6})]


def _lazy_opt(pkg, kind, hyper, clip, wd):
    name = "sgd" if kind.startswith("sgd") else kind
    kw = dict(hyper, learning_rate=0.05, rescale_grad=0.5, wd=wd)
    if clip:
        kw["clip_gradient"] = clip
    return pkg.optimizer.create(name, **kw)


def _lazy_pushes(pkg, sp, kind, hyper, clip, wd, dtype):
    rng = np.random.RandomState(11)
    w0 = rng.randn(ROWS, COLS).astype("f")
    w = pkg.nd.array(w0, dtype=dtype)
    opt = _lazy_opt(pkg, kind, hyper, clip, wd)
    state = opt.create_state(0, w)
    for rows in PUSH_ROWS:
        vals = (rng.randn(len(rows), COLS) * 3).astype("f")
        opt.update(0, w, sp.row_sparse_array((vals, rows),
                                             shape=(ROWS, COLS)), state)
    states = [] if state is None else \
        list(state) if isinstance(state, tuple) else [state]
    return ([w.astype("float32").asnumpy()] +
            [s.asnumpy() for s in states]), w0


@pytest.mark.parametrize("wd", [0.0, 1e-4])
@pytest.mark.parametrize("clip", [None, 0.5])
@pytest.mark.parametrize("kind,hyper", LAZY, ids=[k for k, _ in LAZY])
def test_lazy_update_matches_jax(kind, hyper, clip, wd):
    (want, w0), (got, _) = [_lazy_pushes(pkg, sp, kind, hyper, clip, wd,
                                         "float32") for pkg, sp in PKGS]
    assert len(want) == len(got) == 1 + {"sgd": 0, "sgd_mom": 1, "adam": 2,
                                         "adagrad": 1}[kind]
    for k, (a, b) in enumerate(zip(want, got)):
        np.testing.assert_allclose(b, a, err_msg=str(k), **TOL)
    rest = np.setdiff1d(np.arange(ROWS), np.concatenate(PUSH_ROWS))
    np.testing.assert_array_equal(got[0][rest], w0[rest])
    for s in got[1:]:
        assert not s[rest].any()


@pytest.mark.parametrize("kind,hyper", LAZY[:2], ids=["sgd", "sgd_mom"])
def test_lazy_update_bf16_weights_match_jax(kind, hyper):
    """bf16 weights, f32 states: the weights one bf16 step apart at
    most, the states to f32 rounding of the same steps."""
    (want, _), (got, _) = [_lazy_pushes(pkg, sp, kind, hyper, 0.5, 1e-4,
                                        "bfloat16") for pkg, sp in PKGS]
    np.testing.assert_allclose(got[0], want[0], rtol=2.0 ** -7, atol=1e-6)
    for a, b in zip(want[1:], got[1:]):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


def test_lazy_update_false_takes_the_dense_path():
    """``lazy_update=False`` updates every row from the dense view of the
    row-sparse gradient, as the JAX package does."""
    def run(pkg, sp):
        w = pkg.nd.array(np.ones((6, 2), "f"))
        opt = pkg.optimizer.SGD(learning_rate=0.1, momentum=0.9, wd=0.1,
                                lazy_update=False)
        st = opt.create_state(0, w)
        opt.update(0, w, sp.row_sparse_array(
            (np.ones((1, 2), "f"), np.array([2])), shape=(6, 2)), st)
        return {"w": w.asnumpy(), "m": st.asnumpy()}
    want, got = _both(run)
    _same(want, got)
    assert (got["w"] < 1).all()      # weight decay moved every row


def test_sparse_row_update_plain_and_its_wrapper():
    """On CPU tensors the wrapper runs the plain version (no launch); nnz 0
    changes nothing; an unknown formula and another device raise."""
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.ops.sparse_update import (sparse_row_update,
                                                   sparse_row_update_plain)
    w = torch.ones(5, 3)
    m = torch.zeros(5, 3)
    vals, idx = torch.full((2, 3), 2.0), torch.tensor([4, 1])
    before = sparse_row_update.launches
    sparse_row_update("sgd_mom", w, vals, idx, (m,), lr=0.5, momentum=0.9)
    assert sparse_row_update.launches == before
    np.testing.assert_array_equal(w.numpy()[[1, 4]], 0.0)
    np.testing.assert_array_equal(w.numpy()[[0, 2, 3]], 1.0)
    np.testing.assert_array_equal(m.numpy()[[1, 4]], 2.0)
    ref = w.clone()
    sparse_row_update_plain("sgd", w, vals[:0], idx[:0], (), lr=0.5)
    assert torch.equal(w, ref)
    with pytest.raises(MXNetError, match="unknown formula"):
        sparse_row_update("rmsprop", w, vals, idx, (), lr=0.1)
    with pytest.raises(MXNetError, match="no kernel for device meta"):
        sparse_row_update("sgd", w.to("meta"), vals.to("meta"),
                          idx.to("meta"), (), lr=0.1)


# -- the sparse-embedding loop of examples/sparse/sparse_embedding -----------
EMB_ROWS, EMB_DIM, EMB_BATCH, EMB_STEPS = 2000, 8, 16, 5


def _embedding_loop(pkg, sp):
    rng = np.random.RandomState(0)
    hot = rng.choice(EMB_ROWS, 60, replace=False)
    kv = pkg.kv.create("local")
    kv.init("emb", pkg.nd.array(rng.randn(EMB_ROWS, EMB_DIM)
                                .astype("f") * 0.05))
    opt = pkg.optimizer.Adam(learning_rate=0.05, rescale_grad=1.0)
    kv._set_updater(pkg.optimizer.get_updater(opt))
    out_buf = sp.zeros("row_sparse", (EMB_ROWS, EMB_DIM))
    full = pkg.nd.zeros((EMB_ROWS, EMB_DIM))
    weights = []
    for _ in range(EMB_STEPS):
        a, b, n = (hot[rng.randint(0, len(hot), EMB_BATCH)]
                   for _ in range(3))
        rows = np.unique(np.concatenate([a, b, n]))
        remap = {r: i for i, r in enumerate(rows)}
        kv.row_sparse_pull("emb", out=out_buf,
                           row_ids=pkg.nd.array(rows.astype("f")))
        W = pkg.nd.array(np.asarray(out_buf._ensure_aux()["values"]))
        W.attach_grad()
        ia, ib, inn = (pkg.nd.array(np.array([remap[r] for r in s], "f"))
                       for s in (a, b, n))
        with pkg.autograd.record():
            ea, eb, en = (pkg.nd.take(W, i) for i in (ia, ib, inn))
            pos = pkg.nd.sum(ea * eb, axis=1)
            neg = pkg.nd.sum(ea * en, axis=1)
            loss = pkg.nd.relu(1.0 - pos + neg).mean()
        loss.backward()
        kv.push("emb", sp.row_sparse_array(
            (W.grad.asnumpy(), rows.astype(np.int64)),
            shape=(EMB_ROWS, EMB_DIM)))
        kv.pull("emb", out=full)
        weights.append(full.asnumpy())
    return weights


def test_sparse_embedding_loop_matches_jax():
    want, got = _both(_embedding_loop)
    for step, (a, b) in enumerate(zip(want, got)):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-7,
                                   err_msg="step %d" % step)
