"""Text utilities: token counting, vocabularies and token embeddings
(counterpart of `mxnet_tpu/contrib/text/`, reference
`python/mxnet/contrib/text/`)."""
from . import utils
from . import vocab
from .vocab import Vocabulary
from . import embedding

__all__ = ["utils", "vocab", "Vocabulary", "embedding"]
