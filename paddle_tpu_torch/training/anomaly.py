"""Anomaly detection for training steps — the health word and gates
(counterpart of ``paddle_tpu/training/anomaly.py``).

MegaScale-style in-band health checking: every step folds a CHEAP
on-device health word into its outputs (:func:`pack_health` — loss,
global grad norm, and their finite flags in one 4-element f32 array, so
the host pays exactly one tiny D2H per step), and a host-side
:class:`AnomalyDetector` triages it:

- **finite gates** — a non-finite loss or grad norm is an anomaly
  immediately (no statistics needed);
- **spike gates** — an EWMA tracks the running level of the loss (and
  grad norm) and a second EWMA tracks the mean absolute deviation
  around it (the MAD analogue that, unlike a variance EWMA, is not
  itself destroyed by the spike it is measuring). A value more than
  ``spike_k`` deviations ABOVE the level after ``warmup_steps``
  observations trips the gate — upward only, because a loss falling
  faster than usual is called training, not an anomaly;
- **scaler-skip gate** — the AMP GradScaler's found_inf skips are
  individually benign (that is the scaler working) but a RUN of them
  means the loss scale can no longer find a representable range:
  ``max_consecutive_scaler_skips`` in a row is an anomaly.

Anomalous values are NOT folded into the running statistics — a NaN
would destroy the EWMA it is being compared against, and a spike would
raise the level that must detect its own repetition.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

__all__ = ["Anomaly", "AnomalyDetector", "pack_health", "unpack_health"]


def pack_health(loss, grad_norm=None):
    """Fold a step's health into ONE small device tensor (inside a
    captured step: no host read): ``[loss, grad_norm, loss_finite,
    grad_finite, has_grad]`` as f32 on the loss's device. Returning it
    from a step costs a single 20-byte transfer; the supervisor unpacks it
    host-side with :func:`unpack_health`. The explicit ``has_grad`` lane
    keeps a loss-only pack distinguishable from a genuine zero gradient
    norm — without it the supervisor would fingerprint the constant 0.0
    and silently disable SDC detection. The constant lanes are made by
    fills on the device (a host scalar copied in would be a host read
    under a capture)."""
    import torch

    loss = torch.as_tensor(loss).detach().to(torch.float32).reshape(())
    lfin = torch.isfinite(loss).to(torch.float32)
    if grad_norm is None:
        gn = loss.new_zeros(())
        gfin = loss.new_ones(())
        has = loss.new_zeros(())
    else:
        gn = torch.as_tensor(grad_norm).detach().to(
            device=loss.device, dtype=torch.float32).reshape(())
        gfin = torch.isfinite(gn).to(torch.float32)
        has = loss.new_ones(())
    return torch.stack([loss, gn, lfin, gfin, has])


def unpack_health(word):
    """Host-side inverse of :func:`pack_health`:
    ``(loss, grad_norm, loss_finite, grad_finite)`` as Python scalars.
    The finite FLAGS are authoritative (computed on device before the
    f32 round trip); ``grad_norm`` is None when it was not packed
    (``has_grad`` lane 0; 4-lane words from older callers keep the
    packed value)."""
    import numpy as np

    if hasattr(word, "detach"):  # a device tensor: the one host read
        word = word.detach().float().cpu().numpy()
    arr = np.asarray(word, np.float32).reshape(-1)
    loss = float(arr[0])
    gn = float(arr[1]) if len(arr) > 1 else None
    lfin = bool(arr[2] >= 0.5) if len(arr) > 2 else math.isfinite(loss)
    gfin = bool(arr[3] >= 0.5) if len(arr) > 3 else True
    if len(arr) > 4 and arr[4] < 0.5:
        gn = None
    return loss, gn, lfin, gfin


@dataclass(frozen=True)
class Anomaly:
    """One detected anomaly: ``kind`` ∈ {loss_nonfinite, grad_nonfinite,
    loss_spike, grad_spike, scaler_skips, sdc} and a human detail."""

    kind: str
    detail: str = ""

    def __str__(self):
        return f"{self.kind}: {self.detail}" if self.detail else self.kind


class _SpikeGate:
    """EWMA level + EWMA absolute-deviation gate for one scalar.

    Two guards against the false positives a descending training loss
    manufactures: (a) the warmup phase averages uniformly (effective
    alpha = max(alpha, 1/n)) so the deviation scale reflects the whole
    early sample, not the first point; (b) a spike must ALSO clear a
    relative floor — ``min_rel`` × the level above the mean — because
    once the loss plateaus the MAD shrinks toward the noise floor and
    a benign uptick would otherwise read as many "deviations". A real
    anomaly spike (corrupted batch, diverging optimizer) is a multiple
    of the level, not a wiggle."""

    def __init__(self, alpha: float, spike_k: float, warmup: int,
                 min_rel: float):
        self.alpha = float(alpha)
        self.spike_k = float(spike_k)
        self.warmup = int(warmup)
        self.min_rel = float(min_rel)
        self.mean: Optional[float] = None
        self.mad: float = 0.0
        self.n = 0

    def observe(self, x: float) -> Optional[float]:
        """Returns the deviation ratio (|x-mean|/mad) when ``x`` spikes,
        else None after folding ``x`` into the statistics."""
        if self.mean is not None and self.n >= self.warmup:
            scale = max(self.mad, 1e-12 * max(abs(self.mean), 1.0), 1e-30)
            dev = (x - self.mean) / scale
            if (dev > self.spike_k
                    and x - self.mean > self.min_rel * max(
                        abs(self.mean), 1e-30)):
                return dev  # spike: NOT folded into the stats
        a = max(self.alpha, 1.0 / (self.n + 1))  # uniform during warmup
        if self.mean is None:
            self.mean = x
        else:
            self.mean += a * (x - self.mean)
            self.mad += a * (abs(x - self.mean) - self.mad)
        self.n += 1
        return None

    def snapshot(self) -> dict:
        return {"mean": self.mean, "mad": self.mad, "n": self.n}


class AnomalyDetector:
    """Host-side triage of per-step health words. Returns an
    :class:`Anomaly` (or None) per :meth:`observe`; never raises."""

    def __init__(self, *, ewma_alpha: float = 0.1, spike_k: float = 8.0,
                 grad_spike_k: Optional[float] = None, warmup_steps: int = 8,
                 min_rel_spike: float = 1.0,
                 max_consecutive_scaler_skips: int = 4):
        self.loss_gate = _SpikeGate(ewma_alpha, spike_k, warmup_steps,
                                    min_rel_spike)
        self.grad_gate = _SpikeGate(
            ewma_alpha,
            spike_k if grad_spike_k is None else grad_spike_k,
            warmup_steps, min_rel_spike)
        self.max_consecutive_scaler_skips = int(max_consecutive_scaler_skips)
        self._consecutive_skips = 0
        self.n_anomalies = 0
        self.last_anomaly: Optional[Anomaly] = None

    # -- scaler feed ----------------------------------------------------
    def notify_scaler_skip(self, step_ix: int) -> None:
        """Wired to ``GradScaler(on_skip=...)``: each found_inf skip
        bumps the consecutive counter :meth:`observe` gates on (a
        healthy observed step resets it)."""
        self._consecutive_skips += 1

    # -- main gate ------------------------------------------------------
    def observe(self, loss: float, grad_norm: Optional[float] = None,
                loss_finite: Optional[bool] = None,
                grad_finite: Optional[bool] = None) -> Optional[Anomaly]:
        if self._consecutive_skips > self.max_consecutive_scaler_skips:
            n = self._consecutive_skips
            # reset ON flag: the supervisor responds with a rollback
            # (restored scaler state, replayed steps) — a latched
            # counter would re-flag every replayed step and burn the
            # whole rollback budget on ONE transient skip-run
            self._consecutive_skips = 0
            return self._flag(Anomaly(
                "scaler_skips",
                f"{n} consecutive GradScaler found_inf skips "
                f"(> {self.max_consecutive_scaler_skips})"))
        if loss_finite is False or not math.isfinite(loss):
            return self._flag(Anomaly("loss_nonfinite", f"loss={loss}"))
        if grad_norm is not None and (
                grad_finite is False or not math.isfinite(grad_norm)):
            return self._flag(Anomaly(
                "grad_nonfinite", f"grad_norm={grad_norm}"))
        dev = self.loss_gate.observe(float(loss))
        if dev is not None:
            return self._flag(Anomaly(
                "loss_spike",
                f"loss={loss:.6g} is {dev:.1f} deviations above the "
                f"EWMA level {self.loss_gate.mean:.6g}"))
        if grad_norm is not None:
            dev = self.grad_gate.observe(float(grad_norm))
            if dev is not None:
                return self._flag(Anomaly(
                    "grad_spike",
                    f"grad_norm={grad_norm:.6g} is {dev:.1f} deviations "
                    f"above the EWMA level {self.grad_gate.mean:.6g}"))
        self._consecutive_skips = 0  # an observed healthy step
        return None

    def _flag(self, anomaly: Anomaly) -> Anomaly:
        self.n_anomalies += 1
        self.last_anomaly = anomaly
        return anomaly

    def snapshot(self) -> dict:
        return {
            "loss": self.loss_gate.snapshot(),
            "grad": self.grad_gate.snapshot(),
            "consecutive_scaler_skips": self._consecutive_skips,
            "n_anomalies": self.n_anomalies,
            "last_anomaly": (None if self.last_anomaly is None
                             else str(self.last_anomaly)),
        }
