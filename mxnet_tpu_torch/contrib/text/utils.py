"""Token counting (counterpart of `mxnet_tpu/contrib/text/utils.py`,
reference `python/mxnet/contrib/text/utils.py`)."""
from __future__ import annotations

import re
from collections import Counter

__all__ = ["count_tokens_from_str"]


def count_tokens_from_str(source_str, token_delim=" ", seq_delim="\n",
                          to_lower=False, counter_to_update=None):
    """Count tokens in `source_str` split by `token_delim` and `seq_delim`
    (reference contrib/text/utils.py:28). Returns a collections.Counter."""
    source_str = filter(None, re.split(token_delim + "|" + seq_delim,
                                       source_str))
    if to_lower:
        source_str = [t.lower() for t in source_str]
    if counter_to_update is None:
        return Counter(source_str)
    counter_to_update.update(source_str)
    return counter_to_update
