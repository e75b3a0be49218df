from . import activation, common, container, conv, norm, pooling
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .container import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403

__all__ = (activation.__all__ + common.__all__ + container.__all__
           + conv.__all__ + norm.__all__ + pooling.__all__)
