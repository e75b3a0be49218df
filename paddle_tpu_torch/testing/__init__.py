"""paddle_tpu_torch.testing — test-support utilities (chaos fault injection);
counterpart of ``paddle_tpu/testing``.

Kept import-light (stdlib only) so harness code can load in contexts
that must not drag the framework in (the bench supervisor, tiny
subprocess workers).
"""
from . import chaos  # noqa: F401
