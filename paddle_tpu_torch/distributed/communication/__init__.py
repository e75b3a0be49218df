"""Collective communication (counterpart of
``paddle_tpu/distributed/communication``). Only the flight recorder is
ported so far (:mod:`.flight_recorder`); the collectives themselves are a
later slice."""
from . import flight_recorder

__all__ = ["flight_recorder"]
