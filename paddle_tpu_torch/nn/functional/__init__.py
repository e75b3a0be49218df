from . import activation, attention, common, conv, loss, norm, pooling
from .activation import *  # noqa: F401,F403
from .attention import scaled_dot_product_attention
from .common import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .loss import cross_entropy, nll_loss, softmax_with_cross_entropy
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403

__all__ = (activation.__all__ + ["scaled_dot_product_attention"]
           + common.__all__ + conv.__all__
           + ["cross_entropy", "softmax_with_cross_entropy", "nll_loss"]
           + norm.__all__ + pooling.__all__)
