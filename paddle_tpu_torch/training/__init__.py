"""Fault-tolerant training: the supervision layer over a step function
(counterpart of ``paddle_tpu/training``).

The serving side is crash-only end to end (ServingSupervisor, overload
control, journaled requeue, disagg handoff); this package gives the
TRAINING loop the same treatment — MegaScale-style anomaly detection
with per-rank diagnosis, Gemini/CheckFreq-style peer-replicated
in-memory checkpoints so recovery is RAM-speed rather than disk-speed,
and cross-rank straggler / silent-data-corruption detection:

- :class:`TrainingSupervisor` (``supervisor.py``) — wraps a step
  function; detects anomalies, rolls back to the last good snapshot,
  quarantines poison batches, escalates crash-only past a rollback
  budget, and keeps the two-tier (peer RAM / disk) checkpoint fabric
  fed.
- :func:`pack_health` (``anomaly.py``) — the step's health as one small
  device tensor, the one host read a supervised step pays.
- :class:`AnomalyDetector` (``anomaly.py``) — finite checks plus
  EWMA+MAD spike gates over loss and gradient norm; the AMP
  GradScaler's found_inf skips feed the same detector.
- :class:`PeerReplicator` (``peer_snapshot.py``) — async CRC-framed
  snapshot mirroring to a peer rank's host RAM over any KVStore.
- :class:`TrainTelemetry` (``telemetry.py``) — per-step (step-time,
  gradient-fingerprint) exchange; dp-replica fingerprint divergence
  flags suspected SDC, persistent step-time outliers name the
  straggling rank in the CommWatchdog hang dump.
- :class:`DataCursor` — deterministic step→batch mapping with batch
  quarantine and a checkpointable position.
"""
from .anomaly import (  # noqa: F401
    Anomaly,
    AnomalyDetector,
    pack_health,
    unpack_health,
)
from .peer_snapshot import PeerReplicator  # noqa: F401
from .supervisor import (  # noqa: F401
    DataCursor,
    TrainingGaveUp,
    TrainingSupervisor,
    TRAINFAULT_EXIT_CODE,
)
from .telemetry import TelemetryVerdict, TrainTelemetry  # noqa: F401

__all__ = [
    "Anomaly",
    "AnomalyDetector",
    "DataCursor",
    "PeerReplicator",
    "TelemetryVerdict",
    "TrainTelemetry",
    "TrainingGaveUp",
    "TrainingSupervisor",
    "TRAINFAULT_EXIT_CODE",
    "pack_health",
    "unpack_health",
]
