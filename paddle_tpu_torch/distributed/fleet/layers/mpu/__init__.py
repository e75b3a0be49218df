"""The tensor-parallel layers and the RNG tracker (counterpart of
``paddle_tpu/distributed/fleet/layers/mpu/__init__.py``)."""
from .....base.random import (  # noqa: F401  (ref: mpu/random.py RNGStatesTracker)
    RNGStatesTracker,
    get_rng_state_tracker,
    model_parallel_random_seed,
)

from .mp_layers import (  # noqa: F401
    ColumnParallelLinear,
    ParallelCrossEntropy,
    RowParallelLinear,
    VocabParallelEmbedding,
    mark_as_sequence_parallel_parameter,
)
