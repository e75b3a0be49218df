"""Seeded ``torch.Generator``s (counterpart of ``paddle_tpu/base/random.py``):
one per device for parameter init, and one per device for the optimizer's
stochastic-rounding salts, so drawing salts never shifts the init stream;
and the named branches of the hybrid-parallel :class:`RNGStatesTracker`.

The reference's ``Generator`` owns a JAX PRNG key that is split on every
draw. The port's :class:`Generator` owns a seed and one ``torch.Generator``
per device (Philox on the card), created on first use and re-seeded in
place, so a CUDA graph that registered one (``jit.to_static``) draws the
new stream on its next replay.

The tracker's rule is the reference's (``fleet/layers/mpu/random.py``):
:func:`model_parallel_random_seed` seeds the ``global_seed`` branch equally
on every rank and the ``local_seed`` branch offset by the rank. The
stochastic-rounding salts are the global branch's: they are drawn from the
seed of the tracker's global branch where one was added, else from the
process seed, so data-parallel and sharded replicas that seed alike draw
the same salts and their bf16 writebacks stay bitwise equal.

JAX's threefry and torch's Philox streams never agree, so no parity test
compares streams: the tests carry the JAX package's weights into the port
instead (``utils/convert.py``), pin the salts, and hold the tracker to its
invariants (equal global branches, rank-offset local ones, a state that
round-trips).
"""
from __future__ import annotations

import contextlib
import zlib
from typing import Dict, Optional, Union

import numpy as np
import torch

__all__ = ["seed", "get_generator", "sr_generator", "sr_salts", "Generator",
           "default_generator", "get_rng_state", "set_rng_state", "next_key",
           "encode_rng_state", "serializable_rng_state", "restore_rng_state",
           "RNGStatesTracker", "get_rng_state_tracker",
           "model_parallel_random_seed", "capture_rng", "replay_rng"]

# the salt stream's seed differs from the init stream's by this constant
_SR_STREAM = 0x5A17


def _key(dev: torch.device) -> str:
    """One key per device: ``cuda`` and ``cuda:<current>`` are one card."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


class Generator:
    """A seed and one ``torch.Generator`` per device drawn from it (the
    reference's seed + evolving key; Philox state on the card)."""

    def __init__(self, seed: int = 0):
        self._seed = int(seed)
        self._gens: Dict[str, torch.Generator] = {}

    def manual_seed(self, seed: int) -> "Generator":
        """Restart every device's stream from ``seed``, in place."""
        self._seed = int(seed)
        for gen in self._gens.values():
            gen.manual_seed(self._seed)
        return self

    def initial_seed(self) -> int:
        return self._seed

    def for_device(self, device: Union[str, torch.device]) -> torch.Generator:
        """This generator's stream on ``device`` (created on first use)."""
        key = _key(device)
        gen = self._gens.get(key)
        if gen is None:
            gen = torch.Generator(device=key)
            gen.manual_seed(self._seed)
            self._gens[key] = gen
        return gen

    def get_state(self) -> dict:
        return {"seed": self._seed,
                "devices": {k: g.get_state() for k, g in self._gens.items()}}

    def set_state(self, state: dict) -> None:
        """Back to ``state``: a device stream the state does not hold was
        not drawn from yet, so it restarts from the seed."""
        self.manual_seed(state["seed"])
        for key, st in state["devices"].items():
            self.for_device(key).set_state(st)


_seed = 0  # the process seed (paddle.seed)
_root_generator = Generator(0)  # the default outside any tracker branch
_default_generator = _root_generator
_sr_generators: Dict[str, torch.Generator] = {}


def default_generator() -> Generator:
    return _default_generator


def seed(value: int) -> int:
    """Set the process seed (``paddle.seed``): every per-device generator
    restarts from it, in place, and the tracker's branches are dropped, as
    the reference's ``seed`` resets its tracker."""
    global _seed
    _seed = int(value)
    _root_generator.manual_seed(_seed)
    _tracker.reset()
    _reseed_salts()
    return _seed


def get_generator(device: Optional[Union[str, torch.device]] = None
                  ) -> torch.Generator:
    """The default generator's stream on ``device`` (``None`` means the
    CUDA card); inside ``get_rng_state_tracker().rng_state(name)``, the
    named branch's."""
    from .device import get_device

    return _default_generator.for_device(get_device(device))


def _salt_seed() -> int:
    """The salts follow the tracker's global branch: its seed where one was
    added, else the process seed (equal on ranks that seed alike)."""
    branch = _tracker._states.get(RNGStatesTracker.GLOBAL)
    base = _seed if branch is None else branch.initial_seed()
    return base + _SR_STREAM


def _reseed_salts() -> None:
    for gen in _sr_generators.values():
        gen.manual_seed(_salt_seed())


def sr_generator(device: Union[str, torch.device]) -> torch.Generator:
    """The salt generator of ``device``, seeded from the global branch (see
    the module's docstring; created on first use)."""
    key = _key(device)
    gen = _sr_generators.get(key)
    if gen is None:
        gen = torch.Generator(device=key)
        gen.manual_seed(_salt_seed())
        _sr_generators[key] = gen
    return gen


def sr_salts(device: Union[str, torch.device], n: Optional[int] = None
             ) -> torch.Tensor:
    """Two uint32 salts for one stochastic-rounding writeback, as an int64
    ``[2]`` tensor (``[n, 2]`` for n writebacks, in one draw) drawn on
    ``device`` from its salt generator; no value comes back to the host."""
    dev = torch.device(device)
    return torch.randint(0, 2 ** 32, (2,) if n is None else (n, 2),
                         dtype=torch.int64, device=dev,
                         generator=sr_generator(dev))


def next_key() -> int:
    """A fresh seed drawn from the default generator's CPU stream (the
    counterpart of the reference's split-off subkey)."""
    return int(torch.randint(0, 2 ** 63 - 1, (), dtype=torch.int64,
                             generator=_default_generator.for_device("cpu")))


def get_rng_state() -> dict:
    """The default generator's, the salt generators' and the tracker's
    states (the reference's ``{"default", "tracker"}`` plus the salts)."""
    return {"default": _default_generator.get_state(),
            "salts": {k: g.get_state() for k, g in _sr_generators.items()},
            "tracker": _tracker.get_states_dict()}


def set_rng_state(state: dict) -> None:
    _default_generator.set_state(state["default"])
    for key, st in state.get("salts", {}).items():
        sr_generator(key).set_state(st)
    _tracker.set_states_dict(state["tracker"])


# -- checkpointable RNG state --------------------------------------------
# torch generator states are uint8 tensors; checkpoint writers lower them
# to numpy so a pickled state tree holds no torch object. The tag keeps the
# encoded form self-describing.
_KEY_TAG = "__paddle_tpu_prng_key__"


def _encode(state: dict) -> dict:
    if state.get(_KEY_TAG) == 1:
        return state  # encoding is idempotent
    return {_KEY_TAG: 1, "seed": int(state["seed"]),
            "devices": {k: np.asarray(v, np.uint8)
                        for k, v in state["devices"].items()}}


def _decode(enc: dict) -> dict:
    if enc.get(_KEY_TAG) != 1:
        return enc  # a live state passes through
    return {"seed": int(enc["seed"]),
            "devices": {k: torch.from_numpy(np.array(v, np.uint8))
                        for k, v in enc["devices"].items()}}


def encode_rng_state(state: dict) -> dict:
    """Lower a :func:`get_rng_state` dict's generator states to numpy
    payloads, safe to pickle and to ship across processes."""
    return {"default": _encode(state["default"]),
            "salts": {k: np.asarray(v, np.uint8)
                      for k, v in state.get("salts", {}).items()},
            "tracker": {k: _encode(v) for k, v in state["tracker"].items()}}


def serializable_rng_state() -> dict:
    """:func:`encode_rng_state` of the current global RNG state."""
    return encode_rng_state(get_rng_state())


def restore_rng_state(state: dict) -> None:
    """Inverse of :func:`serializable_rng_state`; also accepts a live
    :func:`get_rng_state` dict."""
    set_rng_state({
        "default": _decode(state["default"]),
        "salts": {k: torch.as_tensor(np.array(v, np.uint8))
                  if not isinstance(v, torch.Tensor) else v
                  for k, v in state.get("salts", {}).items()},
        "tracker": {k: _decode(v) for k, v in state["tracker"].items()}})


class RNGStatesTracker:
    """Named RNG branches for hybrid parallelism (ref: fleet/layers/mpu/
    random.py:34): ``global_seed`` shared across all ranks, ``local_seed``
    unique per rank, so dropout masks decorrelate inside a tensor-parallel
    group while weights and salts stay identical."""

    GLOBAL = "global_seed"
    LOCAL = "local_seed"

    def __init__(self):
        self._states: Dict[str, Generator] = {}

    def reset(self):
        self._states.clear()

    def add(self, name: str, seed: int):
        if name in self._states:
            raise ValueError(f"rng state {name!r} already exists")
        self._states[name] = Generator(seed)

    def exists(self, name: str) -> bool:
        return name in self._states

    @contextlib.contextmanager
    def rng_state(self, name: str = GLOBAL):
        """Swap the default generator for the named branch inside the
        block. A branch never added forks off the default seed plus a
        deterministic digest of its name (``hash`` is randomized per
        process and would break the cross-rank invariant)."""
        global _default_generator
        if name not in self._states:
            self._states[name] = Generator(
                (_default_generator.initial_seed()
                 + zlib.crc32(name.encode())) % 2 ** 31)
        prev = _default_generator
        _default_generator = self._states[name]
        try:
            yield
        finally:
            _default_generator = prev

    def get_states_dict(self) -> dict:
        return {k: g.get_state() for k, g in self._states.items()}

    def set_states_dict(self, states: dict) -> None:
        for k, v in states.items():
            if k not in self._states:
                self._states[k] = Generator(0)
            self._states[k].set_state(v)


_tracker = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _tracker


def model_parallel_random_seed(seed_: int, tp_rank: int = 0) -> None:
    """ref: fleet/layers/mpu/random.py:103 — the global branch seeded alike
    on every rank, the local branch offset by the rank; the salt
    generators follow the global branch, in place."""
    _tracker.reset()
    _tracker.add(RNGStatesTracker.GLOBAL, seed_)
    _tracker.add(RNGStatesTracker.LOCAL, seed_ + 2718 + tp_rank)
    _reseed_salts()


def capture_rng() -> tuple:
    """The draw position of every stream a forward draws from: the current
    default generator (the object: a tracker branch inside
    ``rng_state``) and its state, and the tracker's branches. Recompute
    takes it before a segment's first run (``fleet.utils.recompute``)."""
    return (_default_generator, _default_generator.get_state(),
            _tracker.get_states_dict())


@contextlib.contextmanager
def replay_rng(captured: tuple):
    """Inside the block every stream draws again from where
    :func:`capture_rng` found it (a branch added since is absent), and the
    default generator is the one current then; on exit each stream is back
    where the block found it, so the replay shifts no later draw."""
    global _default_generator
    gen, state, branches = captured
    prev_default = _default_generator
    prev_gen_state = gen.get_state()
    prev_branches = dict(_tracker._states)
    prev_states = _tracker.get_states_dict()
    _default_generator = gen
    gen.set_state(state)
    _tracker._states = {k: v for k, v in prev_branches.items() if k in branches}
    _tracker.set_states_dict(branches)
    try:
        yield
    finally:
        _tracker._states = prev_branches
        _tracker.set_states_dict(prev_states)
        gen.set_state(prev_gen_state)
        _default_generator = prev_default
