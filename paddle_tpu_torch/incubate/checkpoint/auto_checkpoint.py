"""Fault-tolerant automatic checkpointing with resume-on-restart
(counterpart of ``paddle_tpu/incubate/checkpoint/auto_checkpoint.py``).

ref: python/paddle/base/incubate/checkpoint/auto_checkpoint.py:70
AutoCheckpointChecker / :615 TrainEpochRange — epoch-range tracking,
HDFS save, resume from the newest valid checkpoint after an elastic
relaunch. As in the JAX package:

- step-interval (and optional wall-clock-interval) triggering instead
  of epoch ranges;
- saves go through ``framework.io.save`` (bf16 as raw ``uint16`` with
  its dtype name; files either package reads) into
  ``<dir>/ckpt-<step>/``, written to a tmp directory and atomically
  renamed, with a ``meta.json`` done marker carrying a CRC32 + byte
  count of the payload — a killed save can never be mistaken for a
  valid checkpoint, and a checkpoint whose payload was later
  torn/truncated fails its checksum at resume: it is QUARANTINED
  (renamed ``*.corrupt``) and resume falls back to the newest valid one;
- ``async_save=True`` serializes on a background thread;
- resume scans for the newest VALID checkpoint.

Where the port differs: every capture COPIES. The reference pins its
immutable jax arrays by reference; the port's parameters, moments and
scaler state are written in place by every step (captured CUDA graphs
keep their addresses), so a reference would hold the live tensor and an
async save would pickle a torn mix of steps. ``_capture`` clones each
leaf on the device, in stream order with the training step, and records
an event after the clones; the writer thread waits on that event and
copies to the host on a stream of its own, so the train thread never
waits for the host copy. ``copy_capture`` is kept for the reference's
signature and chooses nothing. A resume copies the loaded values INTO the
live tensors (``load_state_dict``, :func:`restore_optimizer`), so a
captured step replays over the restored state without a recapture.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zlib
from typing import Optional, Sequence

import torch

ELASTIC_AUTO_CHECKPOINT_DIR = "PADDLE_AUTO_CHECKPOINT_DIR"  # env override


def _crc32_file(path: str) -> int:
    """Streaming CRC32 of a file (the integrity record ``meta.json``
    carries per checkpoint). Deliberately a READ-BACK of the
    just-written payload rather than a hash-during-serialize: it costs
    one extra sequential read per save (on the async writer thread,
    off the train path) and in exchange the recorded checksum covers
    the write path itself — what resume() will actually load."""
    crc = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def _tensors(obj) -> list:
    from ...distributed.checkpoint.reshard import Placed

    if isinstance(obj, Placed):
        return [obj.tensor]
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _tensors(v)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _tensors(v)]
    return []


def _host_tree(obj):
    from ...distributed.checkpoint.reshard import Placed

    if isinstance(obj, torch.Tensor):
        return obj.to("cpu") if obj.is_cuda else obj
    if isinstance(obj, Placed):
        return Placed(_host_tree(obj.tensor), obj.global_shape, obj.offset)
    if isinstance(obj, dict):
        return {k: _host_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        return type(obj)(_host_tree(v) for v in obj)
    return obj


def clones_done(state) -> list:
    """``(device, event)`` for each card the captured ``state`` lies on: an
    event recorded after the capture's clones on that card's current
    stream (the training stream), for a writer thread to wait on."""
    devs = {t.device for t in _tensors(state) if t.is_cuda}
    events = []
    for dev in sorted(devs, key=str):
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        events.append((dev, ev))
    return events


def to_host(state, events=()):
    """The captured ``state`` with every card tensor copied to the host,
    after ``events`` (:func:`clones_done`) and on a stream of its own, so
    the copy neither runs before the clones nor queues behind the steps
    the training stream runs meanwhile."""
    if not events:
        return _host_tree(state)
    side = torch.cuda.Stream(events[0][0])
    for _, ev in events:
        side.wait_event(ev)
    with torch.cuda.stream(side):
        out = _host_tree(state)
    side.synchronize()
    return out


@torch.no_grad()
def restore_optimizer(opt, state: dict) -> None:
    """Copy a saved optimizer ``state_dict`` into the live accumulators in
    place wherever one exists with the same shape and dtype (a captured
    step reads and writes those addresses; AdamW's beta powers are views of
    the vectors the step advances, so the copy lands in the vectors).
    Entries with no such accumulator (a restore before the first step)
    are bound as ``set_state_dict`` binds them."""
    params = {opt._name(p): p for p in opt._parameter_list}
    rebind = {}
    for key, val in state.items():
        if key in ("global_step", "LR_Scheduler"):
            continue
        pname, _, accum = key.rpartition(".")
        cur = opt._accumulators.get(accum, {}).get(pname)
        val = torch.as_tensor(val)
        if (cur is not None and tuple(cur.shape) == tuple(val.shape)
                and cur.dtype == val.dtype and pname in params):
            cur.copy_(val)
        else:
            rebind[key] = val
    if rebind:
        opt.set_state_dict(rebind)
    opt._global_step = int(state.get("global_step", 0))
    sched = state.get("LR_Scheduler")
    if sched is not None and hasattr(opt._learning_rate, "set_state_dict"):
        opt._learning_rate.set_state_dict(sched)


class AutoCheckpoint:
    """Periodic async checkpoints + resume for layers/optimizers.

    Usage::

        ac = AutoCheckpoint("ckpts", layers=[model], optimizers=[opt],
                            save_interval_steps=50, keep_last_k=3)
        start = ac.resume()           # 0 on a fresh start
        for step in range(start, total):
            train_step(...)
            ac.step(step)             # maybe-saves (async) at intervals
        ac.wait()                     # drain the in-flight save

    ``extra_state``/``set_extra_state`` hooks let callers persist
    scheduler state, RNG, or dataloader positions alongside.
    """

    def __init__(
        self,
        directory: Optional[str] = None,
        layers: Sequence = (),
        optimizers: Sequence = (),
        save_interval_steps: int = 100,
        save_interval_seconds: Optional[float] = None,
        keep_last_k: int = 3,
        async_save: bool = True,
        extra_state=None,
        set_extra_state=None,
        track_rng: bool = True,
        data_cursor=None,
        copy_capture: bool = False,
    ):
        directory = directory or os.getenv(ELASTIC_AUTO_CHECKPOINT_DIR)
        if not directory:
            raise ValueError(
                "AutoCheckpoint needs a directory (arg or the "
                f"{ELASTIC_AUTO_CHECKPOINT_DIR} env var)"
            )
        self.dir = directory
        os.makedirs(self.dir, exist_ok=True)
        self.layers = list(layers)
        self.optimizers = list(optimizers)
        if save_interval_steps < 1:
            raise ValueError("save_interval_steps must be >= 1")
        self.save_interval_steps = int(save_interval_steps)
        self.save_interval_seconds = save_interval_seconds
        self.keep_last_k = max(int(keep_last_k), 1)
        self.async_save = bool(async_save)
        self._extra_state = extra_state
        self._set_extra_state = set_extra_state
        # token-exact resume needs more than params+moments: the RNG
        # streams (dropout masks, data augmentation) and the dataloader
        # position must both land back where the saved step left them —
        # otherwise resume restarts the epoch iterator and the resumed
        # run silently diverges from the uninterrupted one. ``track_rng``
        # records base.random's full state (keys lowered to plain
        # arrays); ``data_cursor`` is any object with ``state_dict()`` /
        # ``set_state_dict()`` (e.g. training.DataCursor).
        self.track_rng = bool(track_rng)
        self.data_cursor = data_cursor
        # copy_capture: the reference's choice between references and
        # device copies, kept for its signature; the port always copies
        # (the module's docstring)
        del copy_capture
        self._last_save_time = time.monotonic()
        self._worker: Optional[threading.Thread] = None
        self._save_error: Optional[BaseException] = None

    # -- state capture ---------------------------------------------------
    @staticmethod
    def _snapshot(obj):
        """Capture VALUES: each tensor leaf (and each
        :class:`reshard.Placed` shard) is cloned on its device (the live
        tensors are written in place by the next step; see the module's
        docstring)."""
        from ...distributed.checkpoint.reshard import Placed

        if isinstance(obj, dict):
            return {k: AutoCheckpoint._snapshot(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
            return type(obj)(AutoCheckpoint._snapshot(v) for v in obj)
        if isinstance(obj, torch.Tensor):
            return obj.detach().clone()
        if isinstance(obj, Placed):  # a shard keeps its place
            return Placed(obj.tensor.detach().clone(), obj.global_shape,
                          obj.offset)
        return obj

    def _capture(self, step: int) -> dict:
        state = {
            "step": int(step),
            "model": [self._snapshot(l.state_dict()) for l in self.layers],
            "optim": [self._snapshot(o.state_dict())
                      for o in self.optimizers],
        }
        if self._extra_state is not None:
            state["extra"] = self._extra_state()
        if self.track_rng:
            from ...base import random as _random

            state["rng"] = _random.serializable_rng_state()
        if self.data_cursor is not None:
            state["cursor"] = self.data_cursor.state_dict()
        return state


    # -- paths -----------------------------------------------------------
    def _ckpt_path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt-{step:012d}")

    def _list_ckpts(self):
        out = []
        try:
            names = os.listdir(self.dir)
        except OSError:
            return out
        for name in names:
            if (not name.startswith("ckpt-") or name.endswith(".tmp")
                    or name.endswith(".corrupt")):
                continue
            meta = os.path.join(self.dir, name, "meta.json")
            try:
                with open(meta) as f:
                    m = json.load(f)
                if m.get("done"):
                    out.append((int(m["step"]), os.path.join(self.dir, name)))
            except (OSError, ValueError, KeyError):
                continue  # torn / in-progress — not a valid checkpoint
        return sorted(out)

    # -- saving ----------------------------------------------------------
    def _write(self, state: dict, events=()):
        from ...framework import io as fio
        from ...testing import chaos as _chaos

        state = to_host(state, events)
        if not _chaos.inject("ckpt.write"):
            return  # dropped save: nothing reaches disk this interval
        step = state["step"]
        final = self._ckpt_path(step)
        tmp = final + f".{os.getpid()}.tmp"
        try:
            os.makedirs(tmp, exist_ok=True)
            fio.save(state, os.path.join(tmp, "state.pdparams"))
            # chaos at the publish point: "kill" = a mid-save death,
            # "drop" = the publish is abandoned — both leave a torn tmp
            # (payload, no done marker) that resume() must never
            # mistake for a valid checkpoint
            if not _chaos.inject("ckpt.publish"):
                return
            payload = os.path.join(tmp, "state.pdparams")
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump({"step": step, "done": True,
                           "time": time.time(),
                           "crc32": _crc32_file(payload),
                           "payload_bytes": os.path.getsize(payload)}, f)
            try:
                os.replace(tmp, final)  # atomic publish
            except OSError:
                # final exists (same-step re-save / lost race): the
                # existing valid checkpoint wins
                shutil.rmtree(tmp, ignore_errors=True)
            self._prune()
        except BaseException as e:  # noqa: BLE001 — reported on next step()
            self._save_error = e
            shutil.rmtree(tmp, ignore_errors=True)

    def _prune(self):
        ckpts = self._list_ckpts()
        for _, path in ckpts[: -self.keep_last_k]:
            shutil.rmtree(path, ignore_errors=True)
        # quarantined post-mortem evidence is bounded the same way:
        # keep the newest keep_last_k '*.corrupt' dirs (a persistently
        # failing disk must not fill the volume with full-size
        # corpses). Ordered by quarantine mtime, NOT name — the names
        # interleave step numbers and pids lexicographically.
        try:
            corrupt = [os.path.join(self.dir, n)
                       for n in os.listdir(self.dir)
                       if n.endswith(".corrupt")]
            corrupt.sort(key=lambda p: os.path.getmtime(p))
        except OSError:
            return
        for path in corrupt[: -self.keep_last_k]:
            shutil.rmtree(path, ignore_errors=True)

    def save_now(self, step: int, block: bool = False):
        """Save immediately (async unless ``block``)."""
        self.wait()  # one in-flight save at a time; raises prior errors
        state = self._capture(step)  # device clones, in stream order
        events = clones_done(state)
        if self.async_save and not block:
            self._worker = threading.Thread(
                target=self._write, args=(state, events), daemon=True
            )
            self._worker.start()
        else:
            self._write(state, events)
            if self._save_error is not None:
                err, self._save_error = self._save_error, None
                raise RuntimeError(
                    f"auto-checkpoint save failed: {err!r}"
                ) from err
        self._last_save_time = time.monotonic()

    def step(self, step: int):
        """Call once per training step; saves when the step (or time)
        interval elapses. Step 0 does not save."""
        due = step > 0 and step % self.save_interval_steps == 0
        if not due and self.save_interval_seconds is not None:
            due = (
                time.monotonic() - self._last_save_time
                >= self.save_interval_seconds
            )
        if due:
            self.save_now(step)

    def wait(self):
        """Drain the in-flight save; raises if it failed (a run's FINAL
        checkpoint failing silently would strand the next resume an
        interval back with no indication)."""
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        if self._save_error is not None:
            err, self._save_error = self._save_error, None
            raise RuntimeError(
                f"auto-checkpoint save failed: {err!r}"
            ) from err

    # -- resume ----------------------------------------------------------
    def _verify(self, path: str) -> Optional[bool]:
        """Checksum the payload against the ``meta.json`` record.
        Tri-state: True = intact; False = PROVEN mismatch (truncation,
        bit rot, torn flush) — quarantine it; None = could not read
        right now (transient fs error) — skip WITHOUT quarantining, so
        an NFS blip can never destroy a valid checkpoint. Checkpoints
        written before CRC recording (no ``crc32`` key) pass — they
        stay loadable. Any proven mismatch fails BEFORE a deserialize
        is attempted."""
        try:
            with open(os.path.join(path, "meta.json")) as f:
                meta = json.load(f)
        except ValueError:
            return False  # the marker itself is torn
        except OSError:
            return None
        if "crc32" not in meta:
            return True
        payload = os.path.join(path, "state.pdparams")
        try:
            if ("payload_bytes" in meta
                    and os.path.getsize(payload) != meta["payload_bytes"]):
                return False
            return _crc32_file(payload) == meta["crc32"]
        except FileNotFoundError:
            return False  # published marker but no payload: torn
        except OSError:
            return None

    def _quarantine(self, path: str):
        """Move a corrupt checkpoint out of the scan set (``*.corrupt``)
        so every future resume skips it without re-hashing — kept on
        disk for post-mortems rather than silently deleted. The suffix
        carries pid+time so a re-saved-then-re-corrupted step (same
        failing disk, same name) quarantines alongside the first
        incident instead of colliding into the deletion fallback."""
        dest = f"{path}.{os.getpid()}-{int(time.time() * 1000)}.corrupt"
        try:
            os.rename(path, dest)
        except OSError:
            shutil.rmtree(path, ignore_errors=True)

    def resume(self) -> int:
        """Restore the newest valid checkpoint into the registered
        layers/optimizers. Returns the NEXT step to run (saved step + 1),
        or 0 when no valid checkpoint exists. Corrupt checkpoints
        (checksum mismatch) are quarantined and unloadable ones skipped
        (next-newest wins) — a half-written or torn save never blocks
        the relaunch."""
        from ...framework import io as fio

        for step, path in reversed(self._list_ckpts()):
            intact = self._verify(path)
            if intact is None:
                continue  # transiently unreadable: try the next-newest
            if intact is False:
                self._quarantine(path)
                continue
            try:
                state = fio.load(os.path.join(path, "state.pdparams"))
            except Exception:  # noqa: BLE001 — fall back to older ckpt
                continue
            for layer, sd in zip(self.layers, state["model"]):
                # torch copies into the live parameters: a captured step
                # keeps reading the same addresses
                layer.load_state_dict(sd)
            for opt, sd in zip(self.optimizers, state["optim"]):
                restore_optimizer(opt, sd)
            if self._set_extra_state is not None and "extra" in state:
                self._set_extra_state(state["extra"])
            if self.track_rng and "rng" in state:
                from ...base import random as _random

                _random.restore_rng_state(state["rng"])
            if self.data_cursor is not None and "cursor" in state:
                self.data_cursor.set_state_dict(state["cursor"])
            return step + 1
        return 0

    def latest_step(self) -> Optional[int]:
        """Step of the newest VERIFIED checkpoint, without loading it —
        the training supervisor compares this against the peer-RAM
        tier's step to pick the freshest recovery source. Mirrors
        resume()'s triage: transiently-unreadable checkpoints are
        skipped, proven-corrupt ones quarantined."""
        for step, path in reversed(self._list_ckpts()):
            intact = self._verify(path)
            if intact is None:
                continue
            if intact is False:
                self._quarantine(path)
                continue
            return step
        return None


class TrainEpochRange:
    """Epoch-range auto-checkpointing (ref: base/incubate/checkpoint/
    auto_checkpoint.py:615 TrainEpochRange / the ``acp.train_epoch_range``
    loop idiom): iterate it instead of ``range(max_epoch)`` and every
    completed epoch checkpoints; after an elastic relaunch iteration
    resumes at the first UNFINISHED epoch.

    The reference hooks executor state implicitly; this runtime has no
    global executor, so the tracked layers/optimizers are passed
    explicitly::

        for epoch in train_epoch_range(10, "ckpts", layers=[model],
                                       optimizers=[opt]):
            ...train one epoch...
    """

    def __init__(self, max_epoch_num: int, directory: Optional[str] = None,
                 layers: Sequence = (), optimizers: Sequence = (),
                 keep_last_k: int = 3, async_save: bool = True,
                 extra_state=None, set_extra_state=None):
        self._max = int(max_epoch_num)
        self._ac = AutoCheckpoint(
            directory, layers=layers, optimizers=optimizers,
            save_interval_steps=1, keep_last_k=keep_last_k,
            async_save=async_save, extra_state=extra_state,
            set_extra_state=set_extra_state,
        )
        self._start = self._ac.resume()

    @property
    def start_epoch(self) -> int:
        """The first epoch the NEXT iteration will run (advances as
        epochs complete, so re-iterating resumes instead of repeating)."""
        return self._start

    def __iter__(self):
        try:
            while self._start < self._max:
                epoch = self._start
                yield epoch
                # only a COMPLETED epoch checkpoints (a break/exception
                # inside the epoch must not mark it finished)
                self._ac.save_now(epoch)
                self._start = epoch + 1
        finally:
            # drain (and surface errors from) the in-flight async save
            # even when the caller breaks out early
            self._ac.wait()


def train_epoch_range(max_epoch_num: int, directory: Optional[str] = None,
                      layers: Sequence = (), optimizers: Sequence = (),
                      **kw) -> TrainEpochRange:
    """ref: acp.train_epoch_range — see TrainEpochRange."""
    return TrainEpochRange(max_epoch_num, directory, layers=layers,
                           optimizers=optimizers, **kw)
