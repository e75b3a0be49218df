"""TrainingSupervisor — anomaly-triggered rollback + two-tier recovery
(counterpart of ``paddle_tpu/training/supervisor.py``).

The training analogue of ``inference/supervisor.py``'s
ServingSupervisor: wrap the step function, watch every step's health
word, and when something goes wrong make the failure CHEAP instead of
run-ending. The failure taxonomy and what happens per class:

- **anomaly** (non-finite loss/grads, EWMA+MAD loss or grad-norm
  spike, a run of GradScaler found_inf skips, cross-rank SDC
  suspicion) — ROLL BACK: restore the last good in-RAM snapshot
  (params + optimizer moments + LR scheduler + GradScaler + RNG +
  data cursor — token-exact), and replay. Deterministic data and
  restored RNG make the replay bit-identical to a run that never saw
  the anomaly (the loss-parity proof in tests/test_torch_trainfault.py).
- **poison batch** — the same step anomalous ``max_rollback_retries``
  times means the DATA is the trigger, not transient state: the
  offending batch index is quarantined in the :class:`DataCursor`
  (subsequent steps draw the next clean batch) and training proceeds.
- **rollback budget exhausted** — more than ``rollback_budget`` total
  rollbacks means the fault is not transient and not one batch;
  escalate crash-only: ``escalate="raise"`` raises
  :class:`TrainingGaveUp`, ``escalate="exit"`` dies loudly
  (``os._exit(TRAINFAULT_EXIT_CODE)``) for an external relaunch that
  restores from the freshest checkpoint tier.
- **kill / power loss** — in-process recovery is impossible;
  :meth:`resume` on the relaunched rank restores from the FRESHEST
  VERIFIED tier: the peer-RAM snapshot (``PeerReplicator``, RAM-speed)
  when it is at least as new as the newest verified disk checkpoint
  (``AutoCheckpoint``), else disk. A corrupt peer payload (CRC frame)
  falls back to disk automatically.

Snapshot cost model: every snapshot CLONES each tensor leaf on its device
(one copy of the state at the card's memory rate, in stream order with the
step: no host sync). The reference may capture references, since its
arrays are immutable; the port's parameters, moments and scaler state are
written in place by every step, so a reference would follow the live
tensor and a rollback would restore nothing. ``copy_snapshots`` is kept
for the reference's signature and chooses nothing. A rollback COPIES the
snapshot INTO the live tensors (parameters, accumulators, the scaler's
device state) and restores the generators' states in place, so a
``jit.to_static`` step that was captured as a CUDA graph replays over the
restored values and draws the restored stochastic-rounding salts, with no
recapture and no new graph memory. RAM-tier recovery is a deserialize and
a copy; only the async peer publish serializes (on a worker thread, after
the snapshot's clones, off the train path).

Chaos sites (``testing/chaos.py``): ``train.nan`` / ``train.spike`` /
``train.sdc`` corrupt the BATCH before the step runs — a NaN'd batch
poisons params through a real optimizer step, which is exactly what
rollback must provably undo; ``ckpt.peer`` faults the peer-publish
legs. Sites fire once per EXECUTED step, so a schedule's step index
counts executions (replayed steps advance it).
"""
from __future__ import annotations

import os
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from .. import obs as _obs
from ..incubate.checkpoint.auto_checkpoint import (
    AutoCheckpoint,
    clones_done,
    restore_optimizer,
    to_host,
)
from ..testing import chaos as _chaos
from .anomaly import Anomaly, AnomalyDetector, unpack_health
from .peer_snapshot import PeerReplicator
from .telemetry import TrainTelemetry, grad_fingerprint

__all__ = ["TrainingSupervisor", "TrainingGaveUp", "DataCursor",
           "TRAINFAULT_EXIT_CODE"]

# crash-only escalation exit code: distinct from the watchdog's 124 and
# elastic's 101 so the relauncher can tell "training gave up on this
# state" (restore a tier, maybe alert) from "hang" / "membership change"
TRAINFAULT_EXIT_CODE = 113


class TrainingGaveUp(RuntimeError):
    """The rollback budget is exhausted — the anomaly is not transient
    state and not a single poison batch; a fresh incarnation restoring
    from a checkpoint tier (or a human) has to take over."""


class DataCursor:
    """Deterministic ``step -> batch`` with quarantine and a
    checkpointable position.

    ``batch_fn(index)`` must be pure in ``index`` (the replay
    guarantee every rollback and resume relies on). Logical step ``s``
    draws data index ``s`` until quarantines shift the mapping: a
    quarantined index is skipped by EVERY subsequent step, so the
    post-quarantine run is the run that never had the poison batch in
    its stream."""

    def __init__(self, batch_fn: Callable[[int], object]):
        self._fn = batch_fn
        self.quarantined: List[int] = []

    def index(self, step: int) -> int:
        """The data index logical ``step`` draws: the step-th element
        of the non-quarantined index sequence (1-based steps)."""
        idx = int(step)
        for q in sorted(self.quarantined):
            if q <= idx:
                idx += 1
        return idx

    def batch(self, step: int):
        return self._fn(self.index(step))

    def quarantine(self, data_index: int) -> None:
        if data_index not in self.quarantined:
            self.quarantined.append(int(data_index))

    def state_dict(self) -> dict:
        return {"quarantined": sorted(self.quarantined)}

    def set_state_dict(self, state: dict) -> None:
        self.quarantined = [int(q) for q in state.get("quarantined", [])]


def _map_batch(batch, fn):
    """Apply ``fn`` to the FIRST float array leaf of a nested batch
    (dict/list/tuple of numpy arrays or Tensors) — the chaos corruption
    hook's shape. Returns (new_batch, applied?)."""
    if isinstance(batch, torch.Tensor):
        if batch.is_floating_point():
            out = fn(batch.detach().cpu().numpy())
            return torch.as_tensor(out).to(batch.device), True
        return batch, False
    if isinstance(batch, np.ndarray):
        if batch.dtype.kind == "f":
            return fn(batch), True
        return batch, False
    if isinstance(batch, dict):
        out, done = {}, False
        for k, v in batch.items():
            if done:
                out[k] = v
            else:
                out[k], done = _map_batch(v, fn)
        return out, done
    if isinstance(batch, (list, tuple)):
        out, done = [], False
        for v in batch:
            if done:
                out.append(v)
            else:
                v2, done = _map_batch(v, fn)
                out.append(v2)
        return type(batch)(out), done
    return batch, False


def _host(x) -> np.ndarray:
    """A step result on the host as f32 numpy (a card tensor: one copy)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().numpy()
    return np.asarray(x, np.float32)


def _unplaced(sd: dict) -> dict:
    """A state dict with each :class:`reshard.Placed` leaf's local tensor."""
    from ..distributed.checkpoint.reshard import Placed

    return {k: (v.tensor if isinstance(v, Placed) else v)
            for k, v in sd.items()}


class TrainingSupervisor:
    """Supervise a training loop: ``run(total_steps)`` drives
    ``step_fn(batch)`` over the :class:`DataCursor` with anomaly
    detection, rollback, two-tier checkpointing, and telemetry.

    ``step_fn`` returns the step's health: a scalar loss, a
    ``(loss, grad_norm)`` pair, the packed device tensor from
    :func:`training.pack_health` (the one-transfer idiom of a captured
    step: ``float(loss)`` inside it would be a graph break), or a dict
    with keys ``loss`` / ``grad_norm`` / ``fingerprint``.
    """

    def __init__(
        self,
        step_fn: Callable,
        data: Callable[[int], object],
        *,
        layers: Sequence = (),
        optimizers: Sequence = (),
        lr_schedulers: Sequence = (),
        scaler=None,
        detector: Optional[AnomalyDetector] = None,
        snapshot_interval: int = 10,
        snapshots_kept: int = 2,
        max_rollback_retries: int = 2,
        rollback_budget: int = 8,
        escalate: str = "raise",
        peer: Optional[PeerReplicator] = None,
        peer_interval: Optional[int] = None,
        auto_checkpoint: Optional[AutoCheckpoint] = None,
        telemetry: Optional[TrainTelemetry] = None,
        telemetry_interval: int = 1,
        copy_snapshots: bool = True,
        extra_state=None,
        set_extra_state=None,
        rank: Optional[int] = None,
        elastic=None,
        sharded_state: bool = False,
        state_layout: Optional[dict] = None,
    ):
        if escalate not in ("raise", "exit"):
            raise ValueError("escalate must be 'raise' or 'exit'")
        if snapshot_interval < 1:
            raise ValueError("snapshot_interval must be >= 1")
        self.step_fn = step_fn
        self.cursor = data if isinstance(data, DataCursor) else \
            DataCursor(data)
        self.layers = list(layers)
        self.optimizers = list(optimizers)
        self.lr_schedulers = list(lr_schedulers)
        self.scaler = scaler
        self.detector = detector if detector is not None else \
            AnomalyDetector()
        if scaler is not None:
            # found_inf skips feed the detector (satellite: observable
            # skips); chain an existing callback instead of replacing it
            prev = getattr(scaler, "_on_skip", None)

            def _feed(step_ix, _prev=prev):
                self.detector.notify_scaler_skip(step_ix)
                if _prev is not None:
                    _prev(step_ix)

            scaler.set_on_skip(_feed)
        self.snapshot_interval = int(snapshot_interval)
        self.snapshots_kept = max(1, int(snapshots_kept))
        self.max_rollback_retries = int(max_rollback_retries)
        self.rollback_budget = int(rollback_budget)
        self.escalate = escalate
        self.peer = peer
        self.peer_interval = int(peer_interval) if peer_interval \
            else self.snapshot_interval
        if self.peer_interval % self.snapshot_interval != 0:
            # peer publishes ride snapshots (they serialize the captured
            # state), so the cadence must be a multiple — a misaligned
            # value would silently publish only at common multiples
            raise ValueError(
                f"peer_interval ({self.peer_interval}) must be a "
                f"multiple of snapshot_interval "
                f"({self.snapshot_interval}) — peer publishes mirror "
                "existing snapshots")
        self.auto_checkpoint = auto_checkpoint
        if auto_checkpoint is not None:
            if auto_checkpoint.data_cursor is None:
                auto_checkpoint.data_cursor = self.cursor  # disk tier too
        self.telemetry = telemetry
        self.telemetry_interval = max(1, int(telemetry_interval))
        # copy_snapshots: the reference's choice between references and
        # device copies, kept for its signature; the port always copies
        # (the module's docstring)
        del copy_snapshots
        self._extra_state = extra_state
        self._set_extra_state = set_extra_state
        # in-RAM snapshot ring: (step, state) — device clones
        self._snapshots: List[Tuple[int, dict]] = []
        self._retries_at: Dict[int, int] = {}
        self.rollbacks = 0
        self.anomalies: List[Tuple[int, str]] = []
        self.events: List[Tuple[str, str]] = []
        self.last_loss: Optional[float] = None
        self._step = 0
        # goodput ledger: every second of run() wall time is
        # attributed to exactly one bucket — productive (healthy
        # FIRST-TIME step compute), rollback (anomalous step compute +
        # restore + replayed-step compute), checkpoint (snapshot/
        # auto-checkpoint/peer-wait), stall (everything else: data,
        # detector, telemetry, loop overhead)
        self._wall: Dict[str, float] = {
            "productive": 0.0, "rollback": 0.0,
            "checkpoint": 0.0, "stall": 0.0,
        }
        self._wall_gauges = {
            b: _obs.registry().gauge(
                "training_wall_seconds", {"bucket": b},
                help="run() wall time attributed per goodput bucket")
            for b in self._wall
        }
        # alertable series: the default training rules
        # (rollback storms, goodput floor, straggler verdicts) read
        # these registry mirrors, not supervisor attributes
        self._c_rollbacks = _obs.registry().counter(
            "training_rollbacks_total",
            help="anomaly rollbacks performed")
        self._g_goodput = _obs.registry().gauge(
            "training_goodput_frac",
            help="productive fraction of attributed run() wall time")
        self._g_stragglers = _obs.registry().gauge(
            "training_straggler_ranks",
            help="ranks currently flagged by the straggler detector")
        self._goodput_high_water = 0  # highest step ever healthy
        # elastic surfaces: explicit rank (falls
        # back to telemetry's, then the peer ring slot), the elastic
        # membership manager whose health() this supervisor embeds,
        # and the sharded-state mode where peer snapshots carry only
        # locally-owned shards (restored via the cross-topology
        # checkpoint reshard)
        self._rank_override = rank
        self.elastic = elastic
        self.sharded_state = bool(sharded_state)
        self.state_layout = state_layout
        self.reshard_resumes = 0
        self._g_world = _obs.registry().gauge(
            "training_world_size",
            help="registered elastic world size (0 before register)")
        self._g_remesh = _obs.registry().gauge(
            "training_remesh_events",
            help="distinct re-mesh decisions the elastic manager took")
        self._c_reshard = _obs.registry().counter(
            "training_reshard_resume_total",
            help="resumes that restored state saved on a different "
                 "topology (cross-topology reshard on the peer tier)")

    @property
    def rank(self) -> int:
        """This supervisor's rank: explicit override, else telemetry's,
        else the peer ring slot, else 0 — the suffix the
        ``train.kill_rank.<rank>`` chaos site fires under."""
        if self._rank_override is not None:
            return int(self._rank_override)
        if self.telemetry is not None:
            return int(self.telemetry.rank)
        if self.peer is not None:
            return int(self.peer.rank)
        return 0

    # -- state capture / restore ----------------------------------------
    def _placed(self, kind: str, i: int, sd: dict) -> dict:
        """In sharded mode, the layer's or optimizer's local shards as
        :class:`reshard.Placed` leaves (their places from the wrappers
        that cut them); the state dict as it is otherwise."""
        if not self.sharded_state:
            return sd
        from ..distributed.checkpoint import reshard

        where = (reshard.layer_placements(self.layers[i]) if kind == "model"
                 else reshard.optimizer_placements(self.optimizers[i],
                                                   self.layers))
        return reshard.place(sd, where)

    def _capture(self, step: int) -> dict:
        from ..base import random as _random

        state = {
            "step": int(step),
            # clones of every leaf: the next step writes the live tensors
            # in place (the module's docstring)
            "model": [AutoCheckpoint._snapshot(
                self._placed("model", i, l.state_dict()))
                for i, l in enumerate(self.layers)],
            "optim": [AutoCheckpoint._snapshot(
                self._placed("optim", i, o.state_dict()))
                for i, o in enumerate(self.optimizers)],
            "sched": [s.state_dict() for s in self.lr_schedulers],
            # the generators' states on the host (encoded): a state is
            # a small host tensor, restored into the same generators
            "rng": _random.encode_rng_state(_random.get_rng_state()),
            "cursor": self.cursor.state_dict(),
        }
        if self.scaler is not None:
            state["scaler"] = self.scaler.state_dict()
        if self._extra_state is not None:
            state["extra"] = self._extra_state()
        return state

    def _restore(self, state: dict) -> int:
        from ..base import random as _random

        for layer, sd in zip(self.layers, state.get("model", [])):
            # torch copies into the live parameters: their addresses stay
            layer.load_state_dict(_unplaced(sd))
        for opt, sd in zip(self.optimizers, state.get("optim", [])):
            restore_optimizer(opt, _unplaced(sd))
        for sched, sd in zip(self.lr_schedulers, state.get("sched", [])):
            sched.set_state_dict(sd)
        if self.scaler is not None and state.get("scaler"):
            self.scaler.load_state_dict(state["scaler"])
        if "rng" in state:
            _random.restore_rng_state(state["rng"])
        if "cursor" in state:
            # quarantines are MONOTONIC knowledge about the data, not
            # model state: a rollback to a pre-quarantine snapshot must
            # not forget batches proven poisonous since (two poison
            # batches would otherwise wipe each other's quarantine and
            # burn the budget) — union, never replace
            known = list(self.cursor.quarantined)
            self.cursor.set_state_dict(state["cursor"])
            for q in known:
                self.cursor.quarantine(q)
        if self._set_extra_state is not None and "extra" in state:
            self._set_extra_state(state["extra"])
        return int(state["step"])

    def _serialize(self, state: dict, events=()) -> bytes:
        """Peer-tier wire form: the SNAPSHOT's generator states lowered to
        plain arrays, the whole tree through framework.io's format-stable
        pickling. Runs on the replicator's worker thread: the host copy
        waits on ``events`` (recorded after the snapshot's clones) on a
        stream of its own — the train thread never pays the copy or the
        pickle."""
        from ..base import random as _random
        from ..framework import io as fio

        wire = to_host(dict(state), events)
        wire["rng"] = _random.encode_rng_state(state["rng"])
        if self.sharded_state:
            # each rank ships only the shards its devices own; the
            # restoring incarnation gathers every rank's payload and
            # assembles the full host tree (reshard-on-resume)
            from ..distributed.checkpoint import reshard

            return reshard.dumps_sharded(wire, layout=self.state_layout)
        return fio.dumps(wire)

    def _deserialize(self, payload: bytes) -> dict:
        from ..framework import io as fio

        return fio.loads(payload)

    # -- snapshot ring ---------------------------------------------------
    def _take_snapshot(self, step: int):
        state = self._capture(step)
        self._snapshots.append((step, state))
        del self._snapshots[:-self.snapshots_kept]
        if self.peer is not None and (
                step % self.peer_interval == 0 or step == 0):
            events = clones_done(state)
            try:
                self.peer.publish(
                    step, lambda state=state, events=events:
                    self._serialize(state, events))
            except RuntimeError as e:
                # a failed PREVIOUS publish surfaces here; note it and
                # keep training — the disk tier still advances
                self._note("peer_error", str(e))

    def _newest_snapshot(self) -> Tuple[int, dict]:
        if not self._snapshots:
            raise TrainingGaveUp(
                "anomaly before any snapshot exists — nothing to roll "
                "back to (run() snapshots step 0 before training)")
        return self._snapshots[-1]

    # -- recovery tiers --------------------------------------------------
    def resume(self) -> int:
        """Restore the freshest VERIFIED tier; returns the next step to
        run (1 on a fresh start). Order: peer RAM when its committed
        step >= the newest verified disk step (RAM wins ties — it is
        the cheaper restore and never older), else disk; a corrupt or
        unreadable peer payload falls back to disk.

        Goodput accounting: the restore itself is charged to
        the ``checkpoint`` wall bucket, and the fleet's pre-kill
        high-water step is learned from the telemetry rings — every
        replayed step up to it then lands in the ``rollback`` bucket,
        so wall lost to a killed incarnation shows up in THIS
        incarnation's ledger instead of silently counting as progress.

        An incompatible sharded layout raises
        :class:`..distributed.checkpoint.reshard.ReshardLayoutError` —
        permanent,
        never a tier fallback."""
        t_resume = time.monotonic()
        try:
            return self._resume_tiers()
        finally:
            self._ledger("checkpoint", time.monotonic() - t_resume)
            if self.telemetry is not None:
                hw = self.telemetry.high_water()
                if hw is not None and hw > self._goodput_high_water:
                    self._goodput_high_water = hw

    def _peer_cut(self):
        """The newest restorable peer step: the committed step for the
        plain (whole-payload) mode; in sharded mode the CONSISTENT CUT
        — the newest step at which EVERY saved rank has a committed
        payload (publish cadence is deterministic, so min-of-newest is
        that cut)."""
        if self.peer is None:
            return None, None
        if not self.sharded_state:
            return self.peer.latest_step(), None
        ranks = self.peer.ranks()
        if not ranks:
            return None, None
        steps = [self.peer.latest_step(r) for r in ranks]
        if any(s is None for s in steps):
            return None, None
        return min(steps), ranks

    def _restore_sharded_peer(self, step: int, ranks) -> Optional[int]:
        """Gather every saved rank's payload at ``step``, assemble the
        full host tree through the cross-topology reshard, restore.
        Returns the restored step, or None to fall to the next tier
        (missing/corrupt payloads); an incompatible layout RAISES."""
        from ..distributed.checkpoint import reshard

        payloads = []
        for r in ranks:
            p = self.peer.fetch_at(r, step)
            if p is None:
                self._note("resume_peer_failed",
                           f"sharded cut at step {step}: rank {r}'s "
                           "payload missing or corrupt")
                return None
            payloads.append(p)
        try:
            state, saved_layout = reshard.loads_combined(
                payloads, target_layout=self.state_layout)
        except reshard.ReshardLayoutError:
            raise  # permanent: a mesh mismatch, not a bad tier
        except Exception as e:  # noqa: BLE001 — tier fallback
            self._note("resume_peer_failed",
                       f"{type(e).__name__}: {e}")
            return None
        restored = self._restore(state)
        if saved_layout is not None and self.state_layout is not None \
                and saved_layout != self.state_layout:
            self.reshard_resumes += 1
            self._c_reshard.inc()
            self._note("reshard_resume",
                       f"state saved on layout {saved_layout} restored "
                       f"onto {self.state_layout}")
        self._note("resume",
                   f"peer RAM tier (sharded, {len(payloads)} rank "
                   f"payloads) at step {restored}")
        return restored

    def _resume_tiers(self) -> int:
        peer_step, peer_ranks = self._peer_cut()
        disk_step = self.auto_checkpoint.latest_step() \
            if self.auto_checkpoint is not None else None
        if peer_step is not None and (disk_step is None
                                      or peer_step >= disk_step) \
                and self.sharded_state:
            restored = self._restore_sharded_peer(peer_step, peer_ranks)
            if restored is not None:
                self._snapshots = [(restored, self._capture(restored))]
                self._step = restored
                return restored + 1
        elif peer_step is not None and (disk_step is None
                                        or peer_step >= disk_step):
            got = self.peer.fetch()
            # fetch() may fall back to an OLDER verified replica when
            # the newest payload is corrupt — re-compare the step we
            # actually got, or a stale peer replica would shadow a
            # fresher verified disk checkpoint
            if got is not None and disk_step is not None \
                    and got[0] < disk_step:
                self._note("resume_peer_stale",
                           f"verified peer replica is step {got[0]} < "
                           f"disk step {disk_step}; using disk")
                got = None
            if got is not None:
                step, payload = got
                try:
                    state = self._deserialize(payload)
                    restored = self._restore(state)
                    self._snapshots = [(restored, self._capture(restored))]
                    self._step = restored
                    self._note("resume",
                               f"peer RAM tier at step {restored}")
                    return restored + 1
                except Exception as e:  # noqa: BLE001 — tier fallback
                    self._note("resume_peer_failed",
                               f"{type(e).__name__}: {e}")
        if self.auto_checkpoint is not None:
            nxt = self.auto_checkpoint.resume()
            if nxt:
                self._step = nxt - 1
                self._snapshots = [(nxt - 1, self._capture(nxt - 1))]
                self._note("resume", f"disk tier at step {nxt - 1}")
                return nxt
        self._note("resume", "fresh start")
        return 1

    # -- chaos corruption hooks ------------------------------------------
    @staticmethod
    def _corrupt(batch):
        """Apply any scheduled train.nan/spike/sdc fault to the batch —
        the corruption enters through the DATA so a poisoned step
        corrupts params via a real optimizer step (what rollback must
        undo), and a quarantined batch genuinely removes the trigger."""
        if not _chaos.inject("train.nan"):
            batch, _ = _map_batch(batch, lambda a: a * np.float32("nan"))
        if not _chaos.inject("train.spike"):
            batch, _ = _map_batch(
                batch, lambda a: a * np.float32(1e4))
        if not _chaos.inject("train.sdc"):
            def flip(a):
                out = np.array(a)
                out.flat[0] = out.flat[0] + np.float32(1e-3)
                return out
            batch, _ = _map_batch(batch, flip)
        return batch

    # -- result parsing --------------------------------------------------
    @staticmethod
    def _parse_result(out) -> Tuple[float, Optional[float], bool, bool,
                                    Optional[str]]:
        """(loss, grad_norm, loss_finite, grad_finite, fingerprint). A
        device value is read here, once: the step's one host read."""
        import math as _math

        fp = None
        if isinstance(out, dict):
            fp = out.get("fingerprint")
            gn = out.get("grad_norm")
            loss = float(_host(out["loss"]).reshape(-1)[0])
            gn = None if gn is None else float(_host(gn).reshape(-1)[0])
            return (loss, gn, _math.isfinite(loss),
                    gn is None or _math.isfinite(gn), fp)
        if isinstance(out, tuple) and len(out) == 2:
            loss = float(_host(out[0]).reshape(-1)[0])
            gn = float(_host(out[1]).reshape(-1)[0])
            return loss, gn, _math.isfinite(loss), _math.isfinite(gn), None
        arr = _host(out).reshape(-1)
        if arr.size >= 4:
            loss, gn, lfin, gfin = unpack_health(arr)
            return loss, gn, lfin, gfin, None
        loss = float(arr[0])
        return loss, None, _math.isfinite(loss), True, None

    # -- the loop --------------------------------------------------------
    def run(self, total_steps: int, *, start: Optional[int] = None) -> dict:
        """Train steps ``start..total_steps`` (1-based; ``start``
        defaults to where :meth:`resume`/the last run() left off + 1).
        Returns a report dict (final loss, rollbacks, quarantined...).
        """
        step = int(start) if start is not None else self._step + 1
        if not self._snapshots:
            # the rollback floor: state as of "before step `step`"
            t_ck = time.monotonic()
            self._take_snapshot(step - 1)
            self._ledger("checkpoint", time.monotonic() - t_ck)
        while step <= total_steps:
            t_iter = time.monotonic()
            batch = self._corrupt(self.cursor.batch(step))
            # pod-scale worker-death fault: a no-arg ``kill`` scheduled
            # on ``train.kill_rank.<rank>`` SIGKILLs exactly this rank
            # at its N-th executed step — other ranks share the spec
            # but their suffix never matches
            _chaos.inject(f"train.kill_rank.{self.rank}")
            t0 = time.monotonic()
            out = self.step_fn(batch)
            loss, gn, lfin, gfin, fp = self._parse_result(out)
            # timed THROUGH the parse: a card step returns when it is
            # queued, so the host read inside _parse_result is where the
            # step's device compute is actually waited out — timing only
            # the launch would hand the straggler detector pure noise
            dt = time.monotonic() - t0
            anomaly = self.detector.observe(
                loss, gn, loss_finite=lfin, grad_finite=gfin)
            if anomaly is None and self.telemetry is not None:
                fp = fp if fp is not None else (
                    grad_fingerprint(gn) if gn is not None
                    else grad_fingerprint(loss))
                self.telemetry.publish(step, dt, fp)
                if step % self.telemetry_interval == 0:
                    verdict = self.telemetry.check(step, fp)
                    if verdict.sdc and self.telemetry.rank in \
                            verdict.sdc_suspects:
                        # recompute-or-rollback is the SUSPECT's remedy;
                        # consensus holders keep going (their state was
                        # never corrupted, and rolling everyone back
                        # would double the blast radius of one bad HBM
                        # bit)
                        anomaly = Anomaly("sdc", verdict.detail)
                        self.detector._flag(anomaly)
            if anomaly is not None:
                t_roll = time.monotonic()
                step = self._handle_anomaly(step, anomaly)
                now = time.monotonic()
                # the anomalous step's compute was wasted work — it
                # rides the rollback bucket along with the restore
                self._ledger("rollback", dt + (now - t_roll))
                self._ledger("stall",
                             max(0.0, (now - t_iter) - dt
                                 - (now - t_roll)))
                continue
            # healthy step: let the tiers advance
            self.last_loss = loss
            self._step = step
            self._retries_at.pop(step, None)
            t_ck = time.monotonic()
            if self.auto_checkpoint is not None:
                self.auto_checkpoint.step(step)
            if step % self.snapshot_interval == 0:
                self._take_snapshot(step)
            now = time.monotonic()
            ck = now - t_ck
            if step > self._goodput_high_water:
                self._goodput_high_water = step
                self._ledger("productive", dt)
            else:
                # a REPLAYED step: healthy this time, but the run only
                # needs it because an anomaly threw the first execution
                # away — rollback cost, not progress
                self._ledger("rollback", dt)
            self._ledger("checkpoint", ck)
            self._ledger("stall", max(0.0, (now - t_iter) - dt - ck))
            step += 1
        t_ck = time.monotonic()
        if self.auto_checkpoint is not None:
            self.auto_checkpoint.wait()
        if self.peer is not None:
            try:
                self.peer.wait()
            except RuntimeError as e:
                self._note("peer_error", str(e))
        self._ledger("checkpoint", time.monotonic() - t_ck)
        return self.report()

    # -- goodput ledger ---------------------------------------
    def _ledger(self, bucket: str, seconds: float) -> None:
        self._wall[bucket] += seconds
        self._wall_gauges[bucket].set(self._wall[bucket])
        self._g_goodput.set(self.goodput_frac())
        if self.telemetry is not None:
            self._g_stragglers.set(
                float(len(self.telemetry.stragglers())))

    def goodput_frac(self) -> Optional[float]:
        """Fraction of attributed run() wall time spent on healthy
        first-time steps. None before any wall time accrues."""
        total = sum(self._wall.values())
        return self._wall["productive"] / total if total > 0 else None

    def _handle_anomaly(self, step: int, anomaly: Anomaly) -> int:
        """Roll back; returns the step to run next."""
        self.anomalies.append((step, str(anomaly)))
        self.rollbacks += 1
        self._c_rollbacks.inc()
        if self.rollbacks > self.rollback_budget:
            msg = (f"rollback budget exhausted ({self.rollbacks} > "
                   f"{self.rollback_budget}) at step {step}: {anomaly}")
            self._note("gave_up", msg)
            if self.escalate == "exit":
                sys.stderr.write(f"TrainingSupervisor: {msg}\n"
                                 "TrainingSupervisor: exiting crash-only "
                                 f"({TRAINFAULT_EXIT_CODE}) for relaunch\n")
                sys.stderr.flush()
                os._exit(TRAINFAULT_EXIT_CODE)
            raise TrainingGaveUp(msg)
        retries = self._retries_at.get(step, 0) + 1
        self._retries_at[step] = retries
        snap_step, state = self._newest_snapshot()
        # the offending data index under the CURRENT quarantine mapping,
        # resolved before the restore rebinds the cursor state
        bad_index = self.cursor.index(step)
        self._restore(state)
        if self.telemetry is not None:
            # the replay's records carry a new epoch (lockstep peers wait
            # for them instead of reading the abandoned ones)
            self.telemetry.note_rollback()
        if retries > self.max_rollback_retries:
            # deterministic replay reproduced the anomaly at the same
            # step each time: the BATCH is the trigger — quarantine its
            # data index (AFTER the restore: quarantines are monotonic
            # knowledge about the data, not rolled-back model state),
            # and the replay draws clean data there
            self.cursor.quarantine(bad_index)
            self._retries_at.pop(step, None)
            self._note("quarantine",
                       f"step {step}: batch index {bad_index} after "
                       f"{retries - 1} rollback retries ({anomaly})")
        self._note("rollback",
                   f"step {step} anomaly ({anomaly}) -> restored "
                   f"snapshot of step {snap_step}")
        return snap_step + 1

    def _note(self, kind: str, detail: str):
        self.events.append((kind, detail))
        _obs.instant(f"train_{kind}", tid="train", detail=detail)
        if kind in ("rollback", "quarantine", "gave_up", "peer_error",
                    "resume_peer_failed"):
            sys.stderr.write(f"TrainingSupervisor: {kind}: {detail}\n")

    # -- surfaces --------------------------------------------------------
    def report(self) -> dict:
        return {
            "final_step": self._step,
            "final_loss": self.last_loss,
            "rollbacks": self.rollbacks,
            "anomalies": list(self.anomalies),
            "quarantined": sorted(self.cursor.quarantined),
        }

    def health(self) -> dict:
        """Structured snapshot (the ServingSupervisor.health() analogue)
        for probes/tests: progress, rollback ledger, detector stats,
        per-tier freshness, telemetry verdicts, and — when an elastic
        manager is attached — the membership self-report plus the
        world-size/re-mesh/reshard gauges. Wrapped in the shared
        :func:`obs.health_envelope` (HEALTH_COMMON_KEYS-conformant,
        like every other health() surface)."""
        tiers = {
            "ram": self._snapshots[-1][0] if self._snapshots else None,
            "peer": (self.peer.last_published_step
                     if self.peer is not None else None),
            "disk": (self.auto_checkpoint.latest_step()
                     if self.auto_checkpoint is not None else None),
        }
        tele = None
        if self.telemetry is not None:
            v = self.telemetry.last_verdict
            tele = {
                "stragglers": self.telemetry.stragglers(),
                "sdc_suspects": (v.sdc_suspects if v is not None else []),
                "published": self.telemetry.n_published,
            }
        elastic = None
        if self.elastic is not None:
            elastic = self.elastic.health()
            self._g_world.set(float(elastic.get("world_size") or 0))
            self._g_remesh.set(float(elastic.get("remesh_events") or 0))
        return _obs.health_envelope("training", {
            "step": self._step,
            "last_loss": self.last_loss,
            "rank": self.rank,
            "rollbacks": self.rollbacks,
            "rollback_budget": self.rollback_budget,
            "quarantined": sorted(self.cursor.quarantined),
            "detector": self.detector.snapshot(),
            "tiers": tiers,
            "telemetry": tele,
            "elastic": elastic,
            "reshard_resumes": self.reshard_resumes,
            "scaler_skips": (self.scaler.n_skipped_steps
                             if self.scaler is not None else None),
            "wall_seconds": {b: round(v, 6)
                             for b, v in sorted(self._wall.items())},
            "goodput_frac": self.goodput_frac(),
            "events": list(self.events[-20:]),
        })
