"""``contrib.text``, ``gluon.contrib.data`` and ``contrib.autograd`` of
the port against the JAX package's, on the CPU.

Token counts, vocabularies (``most_freq_count``, ``min_freq``, reserved
tokens, lookups both ways) and token embeddings read from local files
the test writes (``CustomEmbedding`` with its own unknown vector or
``init_unknown_vec``, over a vocabulary, ``CompositeEmbedding``,
``update_token_vectors``, ``GloVe``/``FastText`` under an
``embedding_root``, which raise without the file in both packages) are
equal in both packages, vectors bit for bit (both parse the same text to
f32). ``IntervalSampler`` yields the same order; ``WikiText2`` and
``WikiText103`` over a token file in the WikiText format give the same
vocabulary and windows. ``contrib.autograd``'s ``grad_and_loss``,
``grad``, the train and test sections, ``mark_variables`` and
``backward`` give the JAX package's values (rtol 1e-6) and agree with the
port's own tape. The JAX side runs with ``MXNET_XLA_STATS=0``.
"""
from collections import Counter

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt

CPU = mxt.cpu()
TEXT = ("the cat sat on the mat\nthe dog sat\n\na cat and a dog\n"
        "The Cat\n")
WIKI = (" = Valkyria Chronicles = \n\n Senjō no Valkyria is a game . \n"
        " the game began in 2011 , and the game is a <unk> . \n\n"
        " = = Gameplay = = \n the player is a squad . \n")


@pytest.fixture(autouse=True)
def _no_xla_stats(monkeypatch):
    monkeypatch.setenv("MXNET_XLA_STATS", "0")


def _both(fn):
    """``fn(pkg)`` in each package: (port's, JAX's)."""
    with mx.cpu():
        want = fn(mx)
    return fn(mxt), want


@pytest.mark.parametrize("kw", [{}, {"to_lower": True},
                                {"token_delim": "a", "seq_delim": " "}])
def test_count_tokens(kw):
    got, want = _both(lambda pkg: pkg.contrib.text.utils
                      .count_tokens_from_str(TEXT, **kw))
    assert got == want
    base = Counter({"x": 3})
    got = mxt.contrib.text.utils.count_tokens_from_str(
        TEXT, counter_to_update=Counter(base))
    want = mx.contrib.text.utils.count_tokens_from_str(
        TEXT, counter_to_update=Counter(base))
    assert got == want and got["x"] == 3


@pytest.mark.parametrize("kw", [
    {}, {"most_freq_count": 3}, {"min_freq": 2},
    {"reserved_tokens": ["<pad>", "<bos>"]},
    {"unknown_token": "<oov>", "reserved_tokens": ["<pad>"],
     "most_freq_count": 4, "min_freq": 1}])
def test_vocabulary(kw):
    def build(pkg):
        counter = pkg.contrib.text.utils.count_tokens_from_str(TEXT)
        v = pkg.contrib.text.Vocabulary(counter, **kw)
        return (len(v), v.idx_to_token, v.token_to_idx, v.unknown_token,
                v.reserved_tokens, v.to_indices(["cat", "zebra", "the"]),
                v.to_indices("dog"), v.to_tokens([0, 1]), v.to_tokens(1))
    got, want = _both(build)
    assert got == want
    for pkg in (mx, mxt):
        with pytest.raises(ValueError):
            pkg.contrib.text.Vocabulary(Counter(TEXT.split())).to_tokens(99)


def _vec_file(tmp_path, with_unk=True):
    lines = ["cat 0.5 1.5 -2", "dog 1 2 3", "mat -1 0.25 4",
             "cat 9 9 9"]          # a duplicate: the first one wins
    if with_unk:
        lines.insert(1, "<unk> 0.1 0.2 0.3")
    path = tmp_path / ("vec_unk.txt" if with_unk else "vec.txt")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _embedding_view(e):
    return (e.idx_to_token, e.token_to_idx, e.vec_len,
            e.idx_to_vec.asnumpy().tolist(),
            e.get_vecs_by_tokens(["dog", "zebra", "Cat"]).asnumpy().tolist(),
            e.get_vecs_by_tokens(["Cat"], lower_case_backup=True)
            .asnumpy().tolist(), "cat" in e)


@pytest.mark.parametrize("with_unk", [False, True])
def test_custom_embedding(tmp_path, with_unk):
    path = _vec_file(tmp_path, with_unk)
    got, want = _both(lambda pkg: _embedding_view(
        pkg.contrib.text.embedding.CustomEmbedding(
            path, init_unknown_vec=pkg.nd.ones)))
    assert got == want


def test_embedding_over_a_vocabulary_and_composite(tmp_path):
    path = _vec_file(tmp_path)

    def build(pkg):
        text = pkg.contrib.text
        vocab = text.Vocabulary(text.utils.count_tokens_from_str(TEXT),
                                reserved_tokens=["<pad>"])
        e = text.embedding.CustomEmbedding(path, vocabulary=vocab)
        c = text.embedding.CompositeEmbedding(vocab, [e, e])
        c.update_token_vectors(["cat", "dog"], pkg.nd.array(
            np.arange(12, dtype=np.float32).reshape(2, 6)))
        c.update_token_vectors("sat", pkg.nd.ones((6,)))
        with pytest.raises(ValueError):
            c.update_token_vectors("zebra", pkg.nd.ones((6,)))
        return _embedding_view(e) + _embedding_view(c)
    got, want = _both(build)
    assert got == want


def test_glove_and_fasttext_from_an_embedding_root(tmp_path):
    root = tmp_path / "embeddings"
    (root / "glove").mkdir(parents=True)
    (root / "fasttext").mkdir()
    (root / "glove" / "glove.6B.50d.txt").write_text(
        "cat 1 2\ndog 3 4\n")
    (root / "fasttext" / "wiki.simple.vec").write_text(
        "2 2\ncat 5 6\ndog 7 8\n")     # fastText's header line is skipped

    def build(pkg):
        emb = pkg.contrib.text.embedding
        g = emb.create("glove", pretrained_file_name="glove.6B.50d.txt",
                       embedding_root=str(root))
        f = emb.FastText("wiki.simple.vec", embedding_root=str(root))
        names = emb.get_pretrained_file_names("glove")
        with pytest.raises(IOError):
            emb.GloVe("glove.6B.100d.txt", embedding_root=str(root))
        return (_embedding_view(g), _embedding_view(f), names,
                sorted(emb.get_pretrained_file_names()))
    got, want = _both(build)
    assert got == want


@pytest.mark.parametrize("length,interval,rollover",
                         [(10, 3, True), (10, 3, False), (7, 7, True),
                          (12, 4, False)])
def test_interval_sampler(length, interval, rollover):
    got, want = _both(lambda pkg: (lambda s: (list(s), len(s)))(
        pkg.gluon.contrib.data.IntervalSampler(length, interval,
                                               rollover)))
    assert got == want


@pytest.mark.parametrize("cls", ["WikiText2", "WikiText103"])
@pytest.mark.parametrize("segment,seq_len", [("train", 5), ("valid", 3)])
def test_wikitext(tmp_path, cls, segment, seq_len):
    (tmp_path / ("wiki.%s.tokens" % segment)).write_text(WIKI)

    def build(pkg):
        ds = getattr(pkg.gluon.contrib.data, cls)(
            root=str(tmp_path), segment=segment, seq_len=seq_len)
        return (ds.vocabulary.idx_to_token, len(ds),
                [(d.asnumpy().tolist(), lb.asnumpy().tolist())
                 for d, lb in (ds[i] for i in range(len(ds)))])
    got, want = _both(build)
    assert got == want
    assert got[1] > 0
    ds = getattr(mxt.gluon.contrib.data, cls)(root=str(tmp_path),
                                              segment=segment,
                                              seq_len=seq_len)
    assert ds[0][0].context == CPU and ds[0][0].dtype == np.int32
    with pytest.raises(IOError):
        getattr(mxt.gluon.contrib.data, cls)(root=str(tmp_path / "none"))


def _contrib_autograd(pkg):
    ag = pkg.contrib.autograd
    x = pkg.nd.array([1.0, -2.0, 3.0], ctx=pkg.cpu())
    y = pkg.nd.array([0.5, 0.25, 2.0], ctx=pkg.cpu())

    def f(a, b):
        return (a * a * b + pkg.nd.sin(a)).sum()
    grads, loss = ag.grad_and_loss(f)(x, y)
    only_x = ag.grad(f, argnum=0)(x, y)
    both = ag.grad(f, argnum=[0, 1])(x, y)
    z = pkg.nd.array([2.0, 3.0], ctx=pkg.cpu())
    gz = pkg.nd.zeros((2,), ctx=pkg.cpu())
    ag.mark_variables([z], [gz])
    with ag.train_section():
        out = z * z * 3.0
        with ag.test_section():
            pass
    ag.backward([out])
    prev = ag.set_is_training(False)
    return ([g.asnumpy().tolist() for g in grads], float(loss.asscalar()),
            [g.asnumpy().tolist() for g in only_x],
            [g.asnumpy().tolist() for g in both], z.grad.asnumpy().tolist(),
            prev)


def test_contrib_autograd_matches():
    got, want = _both(_contrib_autograd)
    assert got[5] == want[5]
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]),
                               rtol=1e-6)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    np.testing.assert_allclose(np.asarray(got[2]), np.asarray(want[2]),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(got[3]), np.asarray(want[3]),
                               rtol=1e-6)
    np.testing.assert_allclose(got[4], want[4], rtol=1e-6)
    # the port's tape on the same function
    x = mxt.nd.array([1.0, -2.0, 3.0], ctx=CPU)
    y = mxt.nd.array([0.5, 0.25, 2.0], ctx=CPU)
    x.attach_grad()
    with mxt.autograd.record():
        loss = (x * x * y + mxt.nd.sin(x)).sum()
    loss.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), np.asarray(got[2][0]),
                               rtol=1e-6)
