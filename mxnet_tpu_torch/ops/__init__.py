"""Operators of the port: importing this package registers them."""
from . import registry
from . import shape_ops  # noqa: F401  (registers ops)
from . import elemwise  # noqa: F401  (registers ops)
from . import reduce  # noqa: F401  (registers ops)
from . import init_ops  # noqa: F401  (registers ops)
from . import nn  # noqa: F401  (registers ops)
from . import contrib_ops  # noqa: F401  (registers ops)
from . import detection  # noqa: F401  (registers ops)
from . import random_ops  # noqa: F401  (registers ops)
from . import optimizer_ops  # noqa: F401  (registers ops)
from . import compat_ops  # noqa: F401  (registers ops)
from . import linalg_ops  # noqa: F401  (registers ops)
from .attention_kernel import (FlashAttention, dense_attention_plain,
                               flash_attention, flash_attention_plain)
from .conv_kernel import conv1x1_s2_dgrad, conv1x1_s2_dgrad_plain
from .nms_kernel import greedy_nms, greedy_nms_plain
from .multi_tensor import multi_tensor_update, multi_tensor_update_plain
from .sparse_update import sparse_row_update, sparse_row_update_plain
from .lstm_kernel import (FusedLSTM, fused_lstm, fused_lstm_backward,
                          fused_lstm_backward_plain, fused_lstm_plain,
                          fused_lstm_train, fused_lstm_train_plain,
                          lstm_bwd_plan, lstm_bwd_recurrence,
                          lstm_bwd_recurrence_plain, lstm_plan)

__all__ = ["registry", "conv1x1_s2_dgrad", "conv1x1_s2_dgrad_plain",
           "multi_tensor_update", "multi_tensor_update_plain",
           "sparse_row_update", "sparse_row_update_plain",
           "greedy_nms", "greedy_nms_plain",
           "FlashAttention", "flash_attention", "flash_attention_plain",
           "dense_attention_plain",
           "FusedLSTM", "fused_lstm", "fused_lstm_plain",
           "fused_lstm_train", "fused_lstm_train_plain",
           "lstm_bwd_recurrence", "lstm_bwd_recurrence_plain",
           "fused_lstm_backward", "fused_lstm_backward_plain", "lstm_plan",
           "lstm_bwd_plan"]
