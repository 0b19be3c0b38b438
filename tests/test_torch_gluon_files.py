"""Gluon parameter files, hooks, ``export`` and ``SymbolBlock`` of the
port against the JAX package's, on the CPU (ROADMAP A.3 and C.17).

A small net (Conv2D -> BatchNorm -> relu -> Dense, the same prefix in
both packages) is built in each package from the JAX net's seeded
weights. Files cross both ways: what one package writes with
``save_parameters``, ``save_params`` (the legacy form, which
``load_parameters`` also reads) or ``export`` the other loads, in f32 and
bf16 (type flag 12, the JAX package's extension of the format): the
loaded parameters are the saved ones bit for bit, and the port's file
equals the JAX package's byte for byte. ``SymbolBlock.imports`` over either package's export
gives the exporting net's forward (rtol 1e-5, atol 1e-6: the executor's
graph against the eager Gluon ops, f32), and the exported graphs are the
same JSON once loaded, node for node. ``allow_missing``,
``ignore_extra``, the ``ParameterDict`` methods (``save``/``load`` with
``strip_prefix``/``restore_prefix``, ``get_constant``, ``reset_ctx``)
and ``Parameter.list_data``/``list_ctx``/``reset_ctx`` behave as the JAX
ones. Hooks fire in both packages alike, on a hybridized call too, and
``summary`` prints the same table. ``pretrained=True`` loads a file the
JAX package wrote under ``root`` into a small zoo net (``resnet18_v1`` at
32x32) and gives the JAX net's logits (rtol 1e-4, atol 1e-5: 18 layers of
f32 convolutions summed in other orders), and raises where there is no
file, as the JAX one does. The JAX side runs with ``MXNET_XLA_STATS=0``.
"""
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt
from mxnet_tpu.gluon.model_zoo import model_store as jstore
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu_torch.gluon.model_zoo import model_store as tstore
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision

CPU = mxt.cpu()
RTOL, ATOL = 1e-5, 1e-6
ZOO_RTOL, ZOO_ATOL = 1e-4, 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_xla_stats(monkeypatch):
    monkeypatch.setenv("MXNET_XLA_STATS", "0")


def _build(pkg, prefix="files_"):
    net = pkg.gluon.nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(pkg.gluon.nn.Conv2D(4, 3, padding=1),
                pkg.gluon.nn.BatchNorm(),
                pkg.gluon.nn.Activation("relu"),
                pkg.gluon.nn.Dense(5))
    return net


def _x(seed=0, shape=(2, 3, 6, 6)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _pair(prefix="files_"):
    """(JAX net, port net): the JAX net Xavier-initialised with moving
    statistics made non-trivial, its values carried into the port's."""
    x = _x()
    with mx.cpu():
        mx.random.seed(0)
        jnet = _build(mx, prefix)
        jnet.initialize(mx.init.Xavier())
        jnet(mx.nd.array(x))
        rs = np.random.RandomState(1)
        for name, p in jnet.collect_params().items():
            if name.endswith(("running_mean", "running_var", "gamma",
                              "beta")):
                p.set_data(mx.nd.array(
                    np.abs(rs.randn(*p.shape)).astype(np.float32) + 0.5))
    tnet = _build(mxt, prefix)
    tnet.initialize(mxt.init.Xavier(), ctx=CPU)
    tnet(mxt.nd.array(x, ctx=CPU))
    mxt.set_block_params(tnet, {n: v for n, (_, v) in
                                _values(jnet).items()})
    return jnet, tnet


def _dtype_name(arr):
    """An NDArray's dtype by name in either package (the port's asnumpy
    widens bf16 to f32)."""
    data = getattr(arr, "data", None)
    if hasattr(data, "dtype") and str(data.dtype).startswith("torch."):
        return str(data.dtype)[len("torch."):]
    return str(np.dtype(arr.dtype))


def _values(net):
    """{name: (dtype name, values as f32)}."""
    return {n: (_dtype_name(p.data()),
                np.asarray(p.data().asnumpy(), np.float32))
            for n, p in net.collect_params().items()}


def _same_values(got, want):
    assert sorted(got) == sorted(want)
    for n in want:
        assert got[n][0] == want[n][0], n
        np.testing.assert_array_equal(got[n][1], want[n][1], err_msg=n)


def _forward(pkg, net, x):
    if pkg is mx:
        with mx.cpu():
            return net(mx.nd.array(x)).asnumpy()
    return net(mxt.nd.array(x, ctx=CPU)).asnumpy()


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _cast(pkg, net, dtype):
    if dtype != "float32":
        net.cast(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("how", ["parameters", "params"])
def test_files_cross_both_ways(tmp_path, how, dtype):
    jnet, tnet = _pair()
    _cast(mx, jnet, dtype)
    _cast(mxt, tnet, dtype)
    save, load = ("save_parameters", "load_parameters") \
        if how == "parameters" else ("save_params", "load_params")
    jpath, tpath = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    getattr(jnet, save)(jpath)
    getattr(tnet, save)(tpath)
    assert _bytes(tpath) == _bytes(jpath)
    # JAX file -> fresh port net, port file -> fresh JAX net
    tnew = _build(mxt)
    _cast(mxt, tnew, dtype)
    getattr(tnew, load)(jpath, ctx=CPU)
    with mx.cpu():
        jnew = _build(mx)
        _cast(mx, jnew, dtype)
        getattr(jnew, load)(tpath, ctx=mx.cpu())
    _same_values(_values(tnew), _values(jnet))
    _same_values(_values(jnew), _values(tnet))
    assert all(p.data().context == CPU
               for p in tnew.collect_params().values())
    if dtype == "float32":
        x = _x(2)
        np.testing.assert_allclose(_forward(mxt, tnew, x),
                                   _forward(mx, jnet, x), rtol=RTOL,
                                   atol=ATOL)


def test_load_parameters_reads_the_legacy_form_and_keys(tmp_path):
    jnet, tnet = _pair()
    legacy = str(tmp_path / "legacy.params")
    jnet.save_params(legacy)
    keys = sorted(mx.nd.load(legacy))
    assert keys == sorted(mxt.nd.load(legacy, ctx=CPU))
    assert all("." not in k for k in keys)
    tnew = _build(mxt)
    tnew.load_parameters(legacy, ctx=CPU)     # no "." in any key
    _same_values(_values(tnew), _values(jnet))
    structural = str(tmp_path / "structural.params")
    tnet.save_parameters(structural)
    assert sorted(mxt.nd.load(structural, ctx=CPU)) == \
        sorted(mx.nd.load(structural)) == \
        sorted(jnet._collect_params_with_prefix())
    assert sorted(tnet._collect_params_with_prefix()) == \
        sorted(jnet._collect_params_with_prefix())


def test_missing_and_extra_parameters(tmp_path):
    jnet, tnet = _pair()
    path = str(tmp_path / "net.params")
    tnet.save_parameters(path)
    bigger = mxt.gluon.nn.HybridSequential(prefix="files_")
    with bigger.name_scope():
        bigger.add(*_build(mxt)._children.values())
        bigger.add(mxt.gluon.nn.Dense(3))
    with pytest.raises(mxt.MXNetError, match="missing"):
        bigger.load_parameters(path, ctx=CPU)
    bigger.load_parameters(path, ctx=CPU, allow_missing=True)
    assert bigger[4].weight._data is None       # left as it was
    smaller = mxt.gluon.nn.HybridSequential(prefix="files_")
    with smaller.name_scope():
        smaller.add(mxt.gluon.nn.Conv2D(4, 3, padding=1))
    with pytest.raises(ValueError, match="not present"):
        smaller.load_parameters(path, ctx=CPU)
    smaller.load_parameters(path, ctx=CPU, ignore_extra=True)
    np.testing.assert_array_equal(smaller[0].weight.data().asnumpy(),
                                  tnet[0].weight.data().asnumpy())
    # the JAX package refuses alike
    with mx.cpu():
        jbig = _build(mx)
        jbig.add(mx.gluon.nn.Dense(3))
        with pytest.raises(AssertionError, match="missing"):
            jbig.load_parameters(path)


def test_load_into_an_initialised_net_copies_in_place(tmp_path):
    jnet, tnet = _pair()
    path = str(tmp_path / "net.params")
    jnet.save_parameters(path)
    other = _build(mxt)
    other.initialize(mxt.init.Zero(), ctx=CPU)
    other(mxt.nd.array(_x(), ctx=CPU))
    before = {n: p.data().data for n, p in other.collect_params().items()}
    other.hybridize()
    other(mxt.nd.array(_x(), ctx=CPU))
    other.load_parameters(path)
    for n, p in other.collect_params().items():
        assert p.data().data is before[n]       # the same tensor
    _same_values(_values(other), _values(jnet))
    np.testing.assert_allclose(_forward(mxt, other, _x(3)),
                               _forward(mx, jnet, _x(3)), rtol=RTOL,
                               atol=ATOL)


def _graph(path):
    """An exported graph's nodes as (op, name, attrs, inputs), the op
    nodes' auto-numbered names dropped."""
    nodes = json.load(open(path))["nodes"]
    return [(n["op"], n["name"] if n["op"] == "null" else None,
             n.get("attrs", {}), n["inputs"]) for n in nodes], \
        json.load(open(path))["heads"]


@pytest.mark.parametrize("exporter", ["jax", "port"])
def test_export_and_symbol_block_imports(tmp_path, exporter):
    jnet, tnet = _pair()
    jpath, tpath = str(tmp_path / "j"), str(tmp_path / "t")
    jnet.export(jpath)
    tnet.export(tpath)
    # the same graph, the same keys, dtypes and values
    assert _graph(tpath + "-symbol.json") == _graph(jpath + "-symbol.json")
    tfile = mxt.nd.load(tpath + "-0000.params", ctx=CPU)
    jfile = mx.nd.load(jpath + "-0000.params")
    assert sorted(tfile) == sorted(jfile)
    assert all(k.startswith("arg:") for k in tfile)
    _same_values({k: (_dtype_name(v), v.asnumpy()) for k, v in
                  tfile.items()},
                 {k: (_dtype_name(v), v.asnumpy()) for k, v in
                  jfile.items()})
    assert _bytes(tpath + "-0000.params") == _bytes(jpath + "-0000.params")
    path = jpath if exporter == "jax" else tpath
    x = _x(4)
    want = _forward(mx, jnet, x)
    tblock = mxt.gluon.SymbolBlock.imports(path + "-symbol.json", "data",
                                           path + "-0000.params", ctx=CPU)
    np.testing.assert_allclose(_forward(mxt, tblock, x), want, rtol=RTOL,
                               atol=ATOL)
    with mx.cpu():
        jblock = mx.gluon.SymbolBlock.imports(path + "-symbol.json", "data",
                                              path + "-0000.params")
        np.testing.assert_allclose(_forward(mx, jblock, x), want,
                                   rtol=RTOL, atol=ATOL)
    # names are the symbol's own; aux states take no gradient
    assert sorted(tblock.collect_params()) == \
        sorted(jblock.collect_params())
    for name, p in tblock.collect_params().items():
        assert p.grad_req == jblock.collect_params()[name].grad_req


def test_symbol_block_binds_once_a_signature_and_reads_current_values():
    jnet, tnet = _pair()
    data = mxt.sym.var("data")
    sblock = mxt.gluon.SymbolBlock(tnet(data), data,
                                   params=tnet.collect_params())
    assert all(sblock.collect_params()[n] is p
               for n, p in tnet.collect_params().items())
    mxt.compiled.reset()
    x = _x(5)
    for _ in range(3):
        np.testing.assert_allclose(_forward(mxt, sblock, x),
                                   _forward(mxt, tnet, x), rtol=RTOL,
                                   atol=ATOL)
    _forward(mxt, sblock, _x(6, (4, 3, 6, 6)))
    assert len(sblock._executors) == 2
    counts = mxt.compiled.compile_counts()
    assert counts["compiles"] == 2, counts
    # a new value is seen by the next call: one signature still
    w = tnet[3].weight
    w.set_data(w.data().asnumpy() * 2.0)
    np.testing.assert_allclose(_forward(mxt, sblock, x),
                               _forward(mxt, tnet, x), rtol=RTOL, atol=ATOL)
    assert len(sblock._executors) == 2
    with mxt.autograd.record():
        out = sblock(mxt.nd.array(x, ctx=CPU))
    assert out.shape == (2, 5)


def _hook_trace(pkg, hybridize):
    """What pre- and post-hooks see on each call of a net, and after a
    detach."""
    seen = []
    with (mx.cpu() if pkg is mx else CPU):
        net = _build(pkg, "hooks_")
        net.initialize(pkg.init.One(), ctx=pkg.cpu())
        x = pkg.nd.array(_x(7), ctx=pkg.cpu())
        if hybridize:
            net(x)
            net.hybridize()
        pre = net.register_forward_pre_hook(
            lambda b, args: seen.append(("pre", b.name, len(args),
                                         args[0].shape)))
        post = net.register_forward_hook(
            lambda b, args, out: seen.append(
                ("post", b.name, out.shape,
                 float(np.round(out.asnumpy().sum(), 3)))))
        net(x)
        pre.detach()
        net(x)
        post.detach()
        net(x)
        applied = []
        net.apply(lambda b: applied.append(type(b).__name__))
    return seen, applied


@pytest.mark.parametrize("hybridize", [False, True])
def test_hooks_and_apply_match(hybridize):
    got = _hook_trace(mxt, hybridize)
    want = _hook_trace(mx, hybridize)
    assert got == want
    assert len(got[0]) == 3


def _sequential(pkg):
    """A (non-hybrid) Sequential, whose forward calls each child."""
    net = pkg.gluon.nn.Sequential(prefix="seq_")
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(6, activation="relu"),
                pkg.gluon.nn.Dense(3))
    net.initialize(pkg.init.One(), ctx=pkg.cpu())
    return net


@pytest.mark.parametrize("kind", ["hybrid_sequential", "sequential"])
def test_summary_prints_the_same_table(capsys, kind):
    """The JAX table, line for line. A HybridSequential calls its children
    through ``_forward_impl`` in both packages, so only its own row shows;
    a Sequential calls them, so every layer has its row."""
    x = _x(8)
    if kind == "sequential":
        x = x.reshape(2, -1)
        with mx.cpu():
            jnet = _sequential(mx)
        tnet = _sequential(mxt)
    else:
        jnet, tnet = _pair("summary_")
    with mx.cpu():
        jnet.summary(mx.nd.array(x))
    want = capsys.readouterr().out
    tnet.summary(mxt.nd.array(x, ctx=CPU))
    got = capsys.readouterr().out
    assert got == want
    assert "Total params: " in got
    if kind == "sequential":
        assert "Dense-1" in got and "Total params: 675" in got
    # no hook stays behind
    assert not any(b._forward_hooks for b in [tnet] + list(
        tnet._children.values()))


def test_parameter_dict_save_load_and_prefixes(tmp_path):
    jnet, tnet = _pair("pd_")
    tpath, jpath = str(tmp_path / "t.params"), str(tmp_path / "j.params")
    tnet.collect_params().save(tpath, strip_prefix="pd_")
    jnet.collect_params().save(jpath, strip_prefix="pd_")
    assert _bytes(tpath) == _bytes(jpath)
    with pytest.raises(ValueError, match="Prefix"):
        tnet.collect_params().save(tpath, strip_prefix="nope_")
    fresh = _build(mxt, "pd_")
    fresh.collect_params().load(jpath, ctx=CPU, restore_prefix="pd_")
    _same_values(_values(fresh), _values(jnet))
    with pytest.raises(mxt.MXNetError, match="restore_prefix"):
        fresh.collect_params().load(jpath, ctx=CPU, restore_prefix="x_")
    # arg:/aux: tags are dropped on load, as export writes them
    tagged = str(tmp_path / "tagged.params")
    mxt.nd.save(tagged, {"arg:" + k: v.data() for k, v in
                         tnet.collect_params().items()})
    again = _build(mxt, "pd_")
    again.collect_params().load(tagged, ctx=CPU)
    _same_values(_values(again), _values(tnet))


def test_parameter_dict_get_constant_and_reset_ctx():
    for pkg in (mx, mxt):
        pd = pkg.gluon.ParameterDict("c_")
        const = pd.get_constant("k", [[1.0, 2.0]])
        assert const.name == "c_k" and const.grad_req == "null"
        assert pd.get_constant("k") is const
        with pytest.raises(KeyError):
            pd.get_constant("absent")
    pd = mxt.gluon.ParameterDict("r_")
    p = pd.get("w_weight", shape=(2, 3))
    pd.initialize(mxt.init.One(), ctx=CPU)
    assert p.list_ctx() == [CPU]
    assert [d.shape for d in p.list_data()] == [(2, 3)]
    pd.reset_ctx(CPU)
    assert p.list_ctx() == [CPU] and p.grad().shape == (2, 3)
    np.testing.assert_array_equal(p.data().asnumpy(), np.ones((2, 3)))
    deferred = mxt.gluon.Parameter("d", shape=(0, 2),
                                   allow_deferred_init=True)
    deferred.initialize(ctx=CPU)
    assert deferred.list_ctx() == [CPU]
    with pytest.raises(mxt.MXNetError, match="CUDA device"):
        deferred.reset_ctx(mxt.gpu(0))


def test_infer_shape_is_the_jax_no_op():
    for pkg in (mx, mxt):
        net = _build(pkg, "infer_")
        assert net.infer_shape(pkg.nd.zeros((1, 3, 6, 6),
                                            ctx=pkg.cpu())) is None
        assert net[0].weight.shape == (4, 0, 3, 3)


def test_pretrained_from_a_jax_written_file(tmp_path):
    x = _x(9, (2, 3, 32, 32))
    with mx.cpu():
        mx.random.seed(3)
        jnet = jvision.resnet18_v1(classes=10, prefix="pre_")
        jnet.initialize(mx.init.Xavier())
        jnet.hybridize()
        want = jnet(mx.nd.array(x)).asnumpy()
        jnet.save_parameters(str(tmp_path / "resnet18_v1.params"))
    tnet = tvision.get_model("resnet18_v1", pretrained=True,
                             root=str(tmp_path), ctx=CPU, classes=10,
                             prefix="pre_")
    _same_values(_values(tnet), _values(jnet))
    np.testing.assert_allclose(_forward(mxt, tnet, x), want, rtol=ZOO_RTOL,
                               atol=ZOO_ATOL)
    # the store's search: root, then $MXNET_TPU_MODEL_DIR, raising where
    # neither has the file, in both packages
    assert tstore.get_model_file("resnet18_v1", root=str(tmp_path)) == \
        jstore.get_model_file("resnet18_v1", root=str(tmp_path))
    empty = str(tmp_path / "empty")
    for store in (tstore, jstore):
        with pytest.raises(Exception, match="resnet18_v1"):
            store.get_model_file("resnet18_v1", root=empty)


def test_model_dir_environment_and_purge(tmp_path, monkeypatch):
    other = tmp_path / "other"
    other.mkdir()
    (other / "alexnet-0000.params").write_bytes(b"")
    monkeypatch.setenv("MXNET_TPU_MODEL_DIR", str(other))
    root = str(tmp_path / "root")
    assert tstore.get_model_file("alexnet", root=root) == \
        jstore.get_model_file("alexnet", root=root) == \
        str(other / "alexnet-0000.params")
    tstore.purge(str(other))
    assert not os.listdir(other)


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_convert_zoo_params",
        os.path.join(ROOT, "tools", "convert_zoo_params.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_convert_zoo_params_matches_the_jax_tool(tmp_path):
    from mxnet_tpu_torch.tools import convert_zoo_params as tool
    jtool = _jax_tool()
    rs = np.random.RandomState(0)
    src = {"arg:resnetv10_conv0_weight": rs.randn(8, 3, 3, 3),
           "aux:resnetv10_batchnorm0_running_mean": rs.randn(8),
           "arg:resnetv10_dense0_bias": rs.randn(4),
           "arg:unused_thing": rs.randn(2)}
    path = str(tmp_path / "ref.params")
    mx.nd.save(path, {k: mx.nd.array(v.astype(np.float32))
                      for k, v in src.items()})
    targets = ["r_conv0_weight", "r_batchnorm0_running_mean",
               "r_dense0_bias", "r_dense0_weight"]
    got = tool.match_names(tool.load_reference_params(path), targets)
    want = jtool.match_names(jtool.load_reference_params(path), targets)
    assert sorted(got[0]) == sorted(want[0]) and got[1:] == want[1:]
    got_nhwc = tool.to_nhwc(got[0])
    want_nhwc = jtool.to_nhwc(want[0])
    for k in want_nhwc:
        np.testing.assert_array_equal(got_nhwc[k].asnumpy(),
                                      want_nhwc[k].asnumpy())


def test_convert_zoo_params_end_to_end(tmp_path):
    """A reference-style file (``arg:`` tags, another Gluon prefix) of a
    small net through the port's tool, verified by ``pretrained=True``."""
    net = tvision.get_model("squeezenet1.1", classes=10,
                            prefix="squeezenet0_")
    net.initialize(mxt.init.Xavier(), ctx=CPU)
    net(mxt.nd.zeros((1, 3, 224, 224), ctx=CPU))
    ref = str(tmp_path / "ref.params")
    mxt.nd.save(ref, {"arg:" + n.replace("squeezenet0_", "squeezenet1_"):
                      p.data() for n, p in net.collect_params().items()})
    out = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.convert_zoo_params",
         ref, "--model", "squeezenet1.1", "--classes", "10", "--out-dir",
         str(tmp_path / "models"), "--device", "cpu", "--verify"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "matched 52/52" in out.stdout and "checksum" in out.stdout
    loaded = tvision.get_model("squeezenet1.1", pretrained=True, ctx=CPU,
                               root=str(tmp_path / "models"), classes=10)
    for (n, p), q in zip(net.collect_params().items(),
                         loaded.collect_params().values()):
        np.testing.assert_array_equal(p.data().asnumpy(),
                                      q.data().asnumpy(), err_msg=n)


def test_exported_pair_through_predictor_and_module(tmp_path):
    """``export`` writes the moving statistics as ``arg:``. The JAX
    ``Predictor`` strips the tag and fills the auxiliary states by name,
    and so does the port's (before, it dropped them: ROADMAP C.18); the
    JAX ``Module.set_params`` refuses the pair (the moving statistics
    are missing from ``aux_params``), and the port's refuses alike."""
    jnet, tnet = _pair()
    path = str(tmp_path / "e")
    jnet.export(path)
    x = _x(10)
    want = _forward(mx, jnet, x)
    sym_json = open(path + "-symbol.json").read()
    blob = _bytes(path + "-0000.params")
    tpred = mxt.Predictor(sym_json, blob, ctx=CPU,
                          input_shapes={"data": x.shape})
    tpred.forward(data=x)
    np.testing.assert_allclose(tpred.get_output(0), want, rtol=RTOL,
                               atol=ATOL)
    from mxnet_tpu.predict import Predictor as JPredictor
    jpred = JPredictor(sym_json, blob, ctx=mx.cpu(),
                       input_shapes={"data": x.shape})
    jpred.forward(data=x)
    np.testing.assert_allclose(tpred.get_output(0), jpred.get_output(0),
                               rtol=RTOL, atol=ATOL)
    for pkg in (mx, mxt):
        sym, arg, aux = pkg.model.load_checkpoint(path, 0)
        assert aux == {} and any("running_var" in k for k in arg)
        mod = pkg.mod.Module(sym, data_names=["data"], label_names=None,
                             context=pkg.cpu())
        mod.bind(data_shapes=[("data", x.shape)], for_training=False)
        with pytest.raises(RuntimeError, match="running_mean"):
            mod.set_params(arg, aux)
