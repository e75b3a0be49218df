"""MoE's incubate namespace (ref: python/paddle/incubate/distributed/models/
moe/moe_layer.py, grad_clip.py): the implementation lives in
``paddle_tpu_torch.distributed.fleet.meta_parallel.moe``."""
from .....distributed.fleet.meta_parallel.moe import (  # noqa: F401
    ClipGradForMOEByGlobalNorm,
    ExpertMLP,
    MoELayer,
    TopKGate,
    place_experts_on_mesh,
)
