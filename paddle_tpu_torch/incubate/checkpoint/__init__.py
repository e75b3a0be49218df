"""incubate.checkpoint (counterpart of ``paddle_tpu/incubate/checkpoint``):
the disk tier of fault-tolerant training."""
from .auto_checkpoint import (  # noqa: F401
    ELASTIC_AUTO_CHECKPOINT_DIR,
    AutoCheckpoint,
    TrainEpochRange,
    train_epoch_range,
)

__all__ = [
    "AutoCheckpoint", "ELASTIC_AUTO_CHECKPOINT_DIR",
    "TrainEpochRange", "train_epoch_range",
]
