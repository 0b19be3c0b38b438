"""Token indexing (counterpart of `mxnet_tpu/contrib/text/vocab.py`,
reference `python/mxnet/contrib/text/vocab.py:30` ``Vocabulary``).

Index 0 is always the unknown token; reserved tokens follow; counter keys
are indexed by decreasing frequency (ties broken by token order) subject
to `most_freq_count` / `min_freq`.
"""
from __future__ import annotations

__all__ = ["Vocabulary"]

UNKNOWN_IDX = 0


class Vocabulary(object):
    """Indexing for text tokens: index 0 the unknown token, then the
    reserved tokens, then the counter's keys by falling frequency (ties in
    token order), cut by ``most_freq_count`` and ``min_freq``."""

    def __init__(self, counter=None, most_freq_count=None, min_freq=1,
                 unknown_token="<unk>", reserved_tokens=None):
        assert min_freq > 0, "`min_freq` must be set to a positive value."
        if reserved_tokens is not None:
            reserved_token_set = set(reserved_tokens)
            assert unknown_token not in reserved_token_set, \
                "`reserved_token` cannot contain `unknown_token`."
            assert len(reserved_token_set) == len(reserved_tokens), \
                "`reserved_tokens` cannot contain duplicate reserved tokens."
        self._index_unknown_and_reserved_tokens(unknown_token,
                                                reserved_tokens)
        if counter is not None:
            self._index_counter_keys(counter, unknown_token, reserved_tokens,
                                     most_freq_count, min_freq)

    def _index_unknown_and_reserved_tokens(self, unknown_token,
                                           reserved_tokens):
        self._unknown_token = unknown_token
        self._idx_to_token = [unknown_token]
        if reserved_tokens is None:
            self._reserved_tokens = None
        else:
            self._reserved_tokens = reserved_tokens[:]
            self._idx_to_token.extend(reserved_tokens)
        self._token_to_idx = {token: idx for idx, token
                              in enumerate(self._idx_to_token)}

    def _index_counter_keys(self, counter, unknown_token, reserved_tokens,
                            most_freq_count, min_freq):
        unknown_and_reserved_tokens = set(reserved_tokens) \
            if reserved_tokens is not None else set()
        unknown_and_reserved_tokens.add(unknown_token)
        token_freqs = sorted(counter.items(), key=lambda x: x[0])
        token_freqs.sort(key=lambda x: x[1], reverse=True)
        token_cap = len(unknown_and_reserved_tokens) + (
            len(counter) if most_freq_count is None else most_freq_count)
        for token, freq in token_freqs:
            if freq < min_freq or len(self._idx_to_token) == token_cap:
                break
            if token not in unknown_and_reserved_tokens:
                self._idx_to_token.append(token)
                self._token_to_idx[token] = len(self._idx_to_token) - 1

    def __len__(self):
        return len(self._idx_to_token)

    @property
    def token_to_idx(self):
        return self._token_to_idx

    @property
    def idx_to_token(self):
        return self._idx_to_token

    @property
    def unknown_token(self):
        return self._unknown_token

    @property
    def reserved_tokens(self):
        return self._reserved_tokens

    def to_indices(self, tokens):
        """Token (or list of tokens) -> index (or list of indices);
        unknown tokens map to index 0."""
        to_reduce = False
        if not isinstance(tokens, list):
            tokens = [tokens]
            to_reduce = True
        indices = [self.token_to_idx.get(t, UNKNOWN_IDX) for t in tokens]
        return indices[0] if to_reduce else indices

    def to_tokens(self, indices):
        """Index (or list of indices) -> token (or list of tokens)."""
        to_reduce = False
        if not isinstance(indices, list):
            indices = [indices]
            to_reduce = True
        max_idx = len(self._idx_to_token) - 1
        tokens = []
        for idx in indices:
            if not isinstance(idx, int) or idx > max_idx:
                raise ValueError("Token index %s in the provided `indices` "
                                 "is invalid." % idx)
            tokens.append(self._idx_to_token[idx])
        return tokens[0] if to_reduce else tokens
