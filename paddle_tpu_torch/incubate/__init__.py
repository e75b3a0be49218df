"""paddle_tpu_torch.incubate (counterpart of ``paddle_tpu/incubate``; ref:
python/paddle/incubate/).

Ported: ``distributed`` (``distributed.models.moe``, fleet's MoE, and
``distributed.fleet``'s recompute re-exports) and ``checkpoint``
(``AutoCheckpoint``, the disk tier of fault-tolerant training). The rest of
the reference's ``incubate`` (``asp``, ``nn``, ``autograd``, ``optimizer``
and the graph, segment and fused-softmax ops) is a later slice: asking for
it raises an ``ImportError`` that says so.
"""
from . import checkpoint  # noqa: F401
from . import distributed  # noqa: F401

__all__ = ["checkpoint", "distributed"]

_LATER = frozenset({
    "asp", "nn", "autograd", "optimizer", "LookAhead",
    "ModelAverage", "graph_khop_sampler", "graph_reindex",
    "graph_sample_neighbors", "graph_send_recv", "identity_loss",
    "segment_max", "segment_mean", "segment_min", "segment_sum",
    "softmax_mask_fuse", "softmax_mask_fuse_upper_triangle"})


def __getattr__(name):
    if name in _LATER:
        raise ImportError(f"paddle_tpu_torch.incubate.{name} is not ported "
                          "yet: only incubate.distributed and incubate.checkpoint are (ROADMAP A2)")
    raise AttributeError(name)
