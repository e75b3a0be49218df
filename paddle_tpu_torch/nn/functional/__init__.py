from .activation import silu
from .attention import scaled_dot_product_attention
from .loss import cross_entropy, nll_loss, softmax_with_cross_entropy
from .norm import rms_norm

__all__ = ["silu", "scaled_dot_product_attention", "rms_norm",
           "cross_entropy", "softmax_with_cross_entropy", "nll_loss"]
