"""Token embeddings (counterpart of `mxnet_tpu/contrib/text/embedding.py`,
reference `python/mxnet/contrib/text/embedding.py`).

The registry (`register`, `create`, `get_pretrained_file_names`),
`GloVe`, `FastText`, `CustomEmbedding` and `CompositeEmbedding`. Nothing
is downloaded: `GloVe` and `FastText` read
``<embedding_root>/<glove|fasttext>/<pretrained_file_name>`` and raise
when it is absent; `CustomEmbedding` reads any local token-per-line
vector file. The vectors are an NDArray on the current context (the
host by default).
"""
from __future__ import annotations

import io
import logging
import os

import numpy as np

from . import vocab
from ... import ndarray as nd

__all__ = ["register", "create", "get_pretrained_file_names",
           "GloVe", "FastText", "CustomEmbedding", "CompositeEmbedding"]

_REGISTRY = {}


def register(embedding_cls):
    """Register a subclass of _TokenEmbedding (reference embedding.py:39)."""
    _REGISTRY[embedding_cls.__name__.lower()] = embedding_cls
    return embedding_cls


def create(embedding_name, **kwargs):
    """Create by name, e.g. create('glove', pretrained_file_name=...)
    (reference embedding.py:62)."""
    cls = _REGISTRY.get(embedding_name.lower())
    if cls is None:
        raise KeyError(
            "Cannot find embedding %s. Valid: %s"
            % (embedding_name, ", ".join(sorted(_REGISTRY))))
    return cls(**kwargs)


def get_pretrained_file_names(embedding_name=None):
    """Valid pretrained file names, per embedding or all
    (reference embedding.py:89)."""
    if embedding_name is not None:
        cls = _REGISTRY.get(embedding_name.lower())
        if cls is None:
            raise KeyError("Cannot find embedding %s" % embedding_name)
        return list(cls.pretrained_file_name_sha1.keys())
    return {name: list(cls.pretrained_file_name_sha1.keys())
            for name, cls in _REGISTRY.items()}


class _TokenEmbedding(vocab.Vocabulary):
    """Base class (reference embedding.py:132): a Vocabulary whose indices
    also map to embedding vectors (`idx_to_vec`, row 0 = unknown)."""

    def __init__(self, **kwargs):
        super(_TokenEmbedding, self).__init__(**kwargs)
        self._vec_len = 0
        self._idx_to_vec = None

    @classmethod
    def _get_pretrained_file(cls, embedding_root, pretrained_file_name):
        embedding_cls = cls.__name__.lower()
        embedding_root = os.path.expanduser(embedding_root)
        path = os.path.join(embedding_root, embedding_cls,
                            pretrained_file_name)
        if not os.path.exists(path):
            raise IOError(
                "Pretrained file %s not found under %s, and nothing is "
                "downloaded: place the file there or use CustomEmbedding "
                "with a local path." % (pretrained_file_name,
                                        os.path.dirname(path)))
        return path

    def _load_embedding(self, pretrained_file_path, elem_delim,
                        init_unknown_vec, encoding="utf8"):
        """Parse a token-per-line vector file; first-seen token wins;
        row 0 takes the file's unknown vector if present, else
        init_unknown_vec (reference embedding.py:234-320)."""
        pretrained_file_path = os.path.expanduser(pretrained_file_path)
        if not os.path.isfile(pretrained_file_path):
            raise ValueError("`pretrained_file_path` must be a valid path "
                             "to the pre-trained token embedding file.")
        logging.info("Loading pretrained embedding vectors from %s",
                     pretrained_file_path)
        vec_len = None
        all_elems = []
        tokens = set()
        loaded_unknown_vec = None
        with io.open(pretrained_file_path, "r", encoding=encoding) as f:
            for line_num, line in enumerate(f):
                elems = line.rstrip().split(elem_delim)
                assert len(elems) > 1, \
                    "line %d in %s: unexpected data format." \
                    % (line_num, pretrained_file_path)
                token, elems = elems[0], [float(i) for i in elems[1:]]
                if token == self.unknown_token \
                        and loaded_unknown_vec is None:
                    loaded_unknown_vec = elems
                elif token in tokens:
                    logging.warning("line %d in %s: duplicate embedding "
                                    "found for token %s. Skipped.",
                                    line_num, pretrained_file_path, token)
                elif len(elems) == 1:
                    logging.warning("line %d in %s: skipped likely header.",
                                    line_num, pretrained_file_path)
                else:
                    if vec_len is None:
                        vec_len = len(elems)
                        # unknown vector placeholder prepended later
                    else:
                        assert len(elems) == vec_len, \
                            "line %d in %s: found vector of inconsistent " \
                            "dimension for token %s" \
                            % (line_num, pretrained_file_path, token)
                    all_elems.extend(elems)
                    self._idx_to_token.append(token)
                    self._token_to_idx[token] = len(self._idx_to_token) - 1
                    tokens.add(token)
        self._vec_len = vec_len
        array = np.asarray(all_elems, dtype="float32").reshape(
            (-1, self._vec_len))
        if loaded_unknown_vec is not None:
            unk = np.asarray(loaded_unknown_vec, dtype="float32")
        else:
            unk = init_unknown_vec(shape=self._vec_len)
            unk = np.asarray(unk.asnumpy() if hasattr(unk, "asnumpy")
                             else unk, dtype="float32")
        n_res = 1 + (len(self._reserved_tokens)
                     if self._reserved_tokens else 0)
        head = np.tile(unk[None, :], (n_res, 1))
        self._idx_to_vec = nd.array(
            np.concatenate([head, array], axis=0))

    def _index_tokens_from_vocabulary(self, vocabulary):
        self._idx_to_token = vocabulary.idx_to_token[:]
        self._token_to_idx = vocabulary.token_to_idx.copy()
        self._unknown_token = vocabulary.unknown_token
        self._reserved_tokens = vocabulary.reserved_tokens

    def _set_idx_to_vec_by_embeddings(self, token_embeddings, vocab_len,
                                      vocab_idx_to_token):
        """Build idx_to_vec for a vocabulary from loaded embeddings
        (reference embedding.py:330)."""
        new_vec_len = sum(e.vec_len for e in token_embeddings)
        new_idx_to_vec = np.zeros((vocab_len, new_vec_len), "float32")
        col_start = 0
        for embed in token_embeddings:
            col_end = col_start + embed.vec_len
            new_idx_to_vec[0, col_start:col_end] = \
                embed.idx_to_vec[0].asnumpy()
            new_idx_to_vec[1:, col_start:col_end] = embed.get_vecs_by_tokens(
                vocab_idx_to_token[1:]).asnumpy()
            col_start = col_end
        self._vec_len = new_vec_len
        self._idx_to_vec = nd.array(new_idx_to_vec)

    @property
    def vec_len(self):
        return self._vec_len

    @property
    def idx_to_vec(self):
        return self._idx_to_vec

    def get_vecs_by_tokens(self, tokens, lower_case_backup=False):
        """Look up embedding vectors; unknown tokens get row 0
        (reference embedding.py:363)."""
        to_reduce = False
        if not isinstance(tokens, list):
            tokens = [tokens]
            to_reduce = True
        if not lower_case_backup:
            indices = [self.token_to_idx.get(t, vocab.UNKNOWN_IDX)
                       for t in tokens]
        else:
            indices = [self.token_to_idx[t] if t in self.token_to_idx
                       else self.token_to_idx.get(t.lower(),
                                                  vocab.UNKNOWN_IDX)
                       for t in tokens]
        vecs = self._idx_to_vec.take(
            nd.array(np.asarray(indices, "int32")), axis=0)
        return vecs[0] if to_reduce else vecs

    def update_token_vectors(self, tokens, new_vectors):
        """Overwrite vectors of indexed tokens (reference
        embedding.py:399)."""
        assert self._idx_to_vec is not None, \
            "The property `idx_to_vec` has not been properly set."
        if not isinstance(tokens, list) or len(tokens) == 1:
            assert isinstance(new_vectors, nd.NDArray) \
                and len(new_vectors.shape) in [1, 2], \
                "`new_vectors` must be a 1-D or 2-D NDArray if `tokens` " \
                "is a singleton."
            if not isinstance(tokens, list):
                tokens = [tokens]
            if len(new_vectors.shape) == 1:
                new_vectors = new_vectors.expand_dims(0)
        else:
            assert isinstance(new_vectors, nd.NDArray) \
                and len(new_vectors.shape) == 2, \
                "`new_vectors` must be a 2-D NDArray if `tokens` is a " \
                "list of multiple strings."
        assert new_vectors.shape == (len(tokens), self.vec_len), \
            "The length of new_vectors must be equal to the number of " \
            "tokens and the width of new_vectors must be equal to the " \
            "dimension of embeddings."
        indices = []
        for token in tokens:
            if token in self.token_to_idx:
                indices.append(self.token_to_idx[token])
            else:
                raise ValueError("Token %s is unknown. To update the "
                                 "embedding vector for an unknown token, "
                                 "please specify it explicitly as the "
                                 "`unknown_token` %s."
                                 % (token, self.unknown_token))
        arr = np.array(self._idx_to_vec.asnumpy())  # asnumpy is read-only
        arr[np.asarray(indices)] = new_vectors.asnumpy()
        self._idx_to_vec = nd.array(arr)

    def __contains__(self, token):
        return token in self._token_to_idx


@register
class GloVe(_TokenEmbedding):
    """GloVe embeddings (reference embedding.py:468). Requires the
    pretrained .txt files locally under embedding_root/glove/."""

    pretrained_file_name_sha1 = {
        f: "" for f in
        ["glove.42B.300d.txt", "glove.6B.50d.txt", "glove.6B.100d.txt",
         "glove.6B.200d.txt", "glove.6B.300d.txt", "glove.840B.300d.txt",
         "glove.twitter.27B.25d.txt", "glove.twitter.27B.50d.txt",
         "glove.twitter.27B.100d.txt", "glove.twitter.27B.200d.txt"]}

    def __init__(self, pretrained_file_name="glove.840B.300d.txt",
                 embedding_root=os.path.join("~", ".mxnet", "embeddings"),
                 init_unknown_vec=nd.zeros, vocabulary=None, **kwargs):
        super(GloVe, self).__init__(**kwargs)
        path = GloVe._get_pretrained_file(embedding_root,
                                          pretrained_file_name)
        self._load_embedding(path, " ", init_unknown_vec)
        if vocabulary is not None:
            self._set_idx_to_vec_by_embeddings(
                [self], len(vocabulary), vocabulary.idx_to_token)
            self._index_tokens_from_vocabulary(vocabulary)


@register
class FastText(_TokenEmbedding):
    """fastText embeddings (reference embedding.py:558); .vec files under
    embedding_root/fasttext/."""

    pretrained_file_name_sha1 = {
        f: "" for f in
        ["wiki.en.vec", "wiki.simple.vec", "wiki.zh.vec", "wiki.fr.vec",
         "wiki.de.vec", "wiki.es.vec", "wiki.ru.vec", "wiki.ar.vec",
         "crawl-300d-2M.vec"]}

    def __init__(self, pretrained_file_name="wiki.en.vec",
                 embedding_root=os.path.join("~", ".mxnet", "embeddings"),
                 init_unknown_vec=nd.zeros, vocabulary=None, **kwargs):
        super(FastText, self).__init__(**kwargs)
        path = FastText._get_pretrained_file(embedding_root,
                                             pretrained_file_name)
        self._load_embedding(path, " ", init_unknown_vec)
        if vocabulary is not None:
            self._set_idx_to_vec_by_embeddings(
                [self], len(vocabulary), vocabulary.idx_to_token)
            self._index_tokens_from_vocabulary(vocabulary)


class CustomEmbedding(_TokenEmbedding):
    """Load vectors from any local token-per-line file
    (reference embedding.py:658)."""

    def __init__(self, pretrained_file_path, elem_delim=" ", encoding="utf8",
                 init_unknown_vec=nd.zeros, vocabulary=None, **kwargs):
        super(CustomEmbedding, self).__init__(**kwargs)
        self._load_embedding(pretrained_file_path, elem_delim,
                             init_unknown_vec, encoding)
        if vocabulary is not None:
            self._set_idx_to_vec_by_embeddings(
                [self], len(vocabulary), vocabulary.idx_to_token)
            self._index_tokens_from_vocabulary(vocabulary)


class CompositeEmbedding(_TokenEmbedding):
    """Concatenate multiple embeddings over one vocabulary
    (reference embedding.py:719)."""

    def __init__(self, vocabulary, token_embeddings):
        if not isinstance(token_embeddings, list):
            token_embeddings = [token_embeddings]
        for embed in token_embeddings:
            assert isinstance(embed, _TokenEmbedding), \
                "The parameter `token_embeddings` must be an instance or " \
                "a list of instances of `_TokenEmbedding`."
        self._index_tokens_from_vocabulary(vocabulary)
        self._set_idx_to_vec_by_embeddings(
            token_embeddings, len(self), self.idx_to_token)
