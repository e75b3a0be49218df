"""AMP op lists (counterpart of ``paddle_tpu/amp/amp_lists.py``, a copy of its lists).

Names are the reference's op names, the ones the port's entry points pass
to ``base.amp_state.amp_cast``.
"""
from __future__ import annotations

# Numerically safe, tensor-core-bound ops: always run in fp16/bf16 under amp.
WHITE_LIST = {
    "matmul",
    "linear",
    "einsum",
    "conv1d",
    "conv2d",
    "conv3d",
    "conv1d_transpose",
    "conv2d_transpose",
    "conv3d_transpose",
    "bmm",
    "mm",
    "addmm",
    "dot",
    "flash_attention",
    "scaled_dot_product_attention",
    "max_pool2d_indices",
}

# fp16-only extras (bf16 unsupported in the reference; kept for parity).
ONLY_FP16_WHITE_LIST = {
    "fused_attention",
    "fused_feedforward",
}

FP16_WHITE_LIST = WHITE_LIST | ONLY_FP16_WHITE_LIST

# Numerically dangerous in low precision: always promoted to fp32.
FP16_BLACK_LIST = {
    "tan",
    "acos",
    "asin",
    "sinh",
    "cosh",
    "atanh",
    "tanhshrink",
    "erfinv",
    "exp",
    "expm1",
    "log",
    "log10",
    "log2",
    "log1p",
    "reciprocal",
    "rsqrt",
    "pow",
    "square",
    "sum",
    "mean",
    "prod",
    "cumprod",
    "cumsum",
    "dist",
    "p_norm",
    "norm",
    "frobenius_norm",
    "renorm",
    "group_norm",
    "layer_norm",
    "softmax",
    "softmin",
    "softplus",
    "log_softmax",
    "logsumexp",
    "cross_entropy",
    "binary_cross_entropy",
    "bce_with_logits",
    "nll_loss",
    "huber_loss",
    "triplet_margin_loss",
    "log_loss",
    "hsigmoid_loss",
    "margin_cross_entropy",
    "sigmoid_focal_loss",
}

# Grad perf worse than fp32 in the reference; fp32 by default (O1 and O2).
EXTRA_BLACK_LIST = {
    "interpolate",
    "embedding",
    "scatter",
}

BF16_WHITE_LIST = WHITE_LIST
BF16_BLACK_LIST = FP16_BLACK_LIST


def white_list(dtype: str, level: str):
    if dtype == "float16":
        return set(FP16_WHITE_LIST)
    return set(BF16_WHITE_LIST)


def black_list(dtype: str, level: str):
    base = FP16_BLACK_LIST if dtype == "float16" else BF16_BLACK_LIST
    if level == "OD":
        return set()
    if level == "O2":
        return set(EXTRA_BLACK_LIST)
    return set(base) | set(EXTRA_BLACK_LIST)


class AutoCastLists:
    """User-extendable white/black lists (ref: AutoMixedPrecisionLists)."""

    def __init__(
        self,
        custom_white_list=None,
        custom_black_list=None,
        dtype: str = "float16",
        level: str = "O1",
    ):
        self.white_list = white_list(dtype, level)
        self.black_list = black_list(dtype, level)
        if custom_white_list:
            for op in custom_white_list:
                self.white_list.add(op)
                self.black_list.discard(op)
        if custom_black_list:
            for op in custom_black_list:
                self.black_list.add(op)
                self.white_list.discard(op)
        overlap = (set(custom_white_list or ()) & set(custom_black_list or ()))
        if overlap:
            raise ValueError(
                f"custom_white_list and custom_black_list overlap: {sorted(overlap)}"
            )


AutoMixedPrecisionLists = AutoCastLists
