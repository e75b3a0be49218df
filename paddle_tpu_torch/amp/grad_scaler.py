"""``GradScaler``: dynamic loss scaling (counterpart of
``paddle_tpu/amp/grad_scaler.py``).

The scale, the good and bad step counters and ``found_inf`` are device
tensors, created on the device of the first tensor the scaler sees and
then written in place, so a scaled step reads nothing back to the host and
can be captured as a CUDA graph (``jit.to_static(..., scalers=[...])``).
``update()`` is the reference's device-side rule. ``n_skipped_steps``,
``last_skip_step`` and ``on_skip`` advance only on a step run eagerly, as
the reference advances them only on concrete values.

``step()`` skips an update where ``found_inf`` is set in one of two ways:

- ``AdamW(fused=True)`` (every parameter with a gradient on the kernel):
  ``found_inf`` is the fused kernel's ``skip`` row, so the kernel writes
  nothing and the beta powers do not advance. Parameters, moments and
  beta powers come out bitwise as the reference's rollback leaves them,
  without a snapshot of the parameters and their moments.
- any other optimizer: the reference's snapshot of the parameters and
  accumulators before the step and the select back where ``found_inf``
  is set (accumulators the step created go back to their initial value).

An optimizer with ``interleave_updates`` is refused before backward
(at ``scale()``/``unscale_()``) unless it is fused: a fused one is
attached for one ``scale()`` -> ``update()`` cycle, each gradient is
unscaled as it lands with the running ``found_inf`` as the kernel's veto,
and ``step()`` rolls back, against the snapshot taken at ``scale()``, the
layers updated before the overflow showed.
"""
from __future__ import annotations

import warnings
from enum import Enum
from typing import Dict

import torch

__all__ = ["AmpScaler", "GradScaler", "OptimizerState"]


class OptimizerState(Enum):
    INIT = 0
    UNSCALED = 1
    STEPPED = 2


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def _interleaving_optimizers():
    from ..optimizer.optimizer import interleaving_optimizers

    return interleaving_optimizers()


class AmpScaler:
    def __init__(self, enable: bool = True, init_loss_scaling: float = 2.0**15,
                 incr_ratio: float = 2.0, decr_ratio: float = 0.5,
                 incr_every_n_steps: int = 1000,
                 decr_every_n_nan_or_inf: int = 2,
                 use_dynamic_loss_scaling: bool = True, on_skip=None):
        if incr_ratio <= 1.0:
            raise ValueError("incr_ratio should be > 1")
        if not 0.0 < decr_ratio < 1.0:
            raise ValueError("decr_ratio should be in (0, 1)")
        self._enable = bool(enable)
        self._use_dynamic_loss_scaling = (bool(use_dynamic_loss_scaling)
                                          and self._enable)
        self._init_loss_scaling = float(init_loss_scaling)
        self._incr_ratio = float(incr_ratio)
        self._decr_ratio = float(decr_ratio)
        self._incr_every_n_steps = int(incr_every_n_steps)
        self._decr_every_n_nan_or_inf = int(decr_every_n_nan_or_inf)
        self._device = None
        self._scale = self._good_steps = self._bad_steps = None
        self._found_inf = None
        self._opt_states: Dict[int, OptimizerState] = {}
        self._n_skipped_steps = 0
        self._last_skip_step = -1
        self._n_updates = 0
        self._on_skip = on_skip
        # fused interleaved optimizers: their scale()-time snapshots
        self._interleave_snaps: Dict[int, tuple] = {}
        self._interleaved_opts: Dict[int, object] = {}

    # -- device state ----------------------------------------------------
    def _state_on(self, device) -> None:
        """Create the device state on ``device`` (the first time), or move
        it there."""
        device = torch.device(device)
        if self._scale is None:
            self._scale = torch.full((), self._init_loss_scaling,
                                     dtype=torch.float32, device=device)
            self._good_steps = torch.zeros((), dtype=torch.int32, device=device)
            self._bad_steps = torch.zeros((), dtype=torch.int32, device=device)
            self._found_inf = torch.zeros((), dtype=torch.bool, device=device)
        elif self._scale.device != device:
            self._scale, self._good_steps, self._bad_steps, self._found_inf = (
                t.to(device) for t in (self._scale, self._good_steps,
                                       self._bad_steps, self._found_inf))
        self._device = device

    def is_enable(self) -> bool:
        return self._enable

    is_enabled = is_enable

    def is_use_dynamic_loss_scaling(self) -> bool:
        return self._use_dynamic_loss_scaling

    def _attach_or_refuse_interleaved(self, when: str):
        """Interleaved updates fire during backward on scaled gradients, so
        a non-fused interleaving optimizer is refused here, before backward.
        A fused one is attached for this cycle: its gradients are unscaled
        as they land and the running found-inf flag vetoes the kernel; the
        snapshot taken here is the rollback target of the layers updated
        before an overflow showed."""
        opts = _interleaving_optimizers()
        for opt in opts:
            if not getattr(opt, "_fused", False):
                raise ValueError(
                    "GradScaler cannot drive an interleave_updates "
                    f"optimizer ({when}): interleaved updates would fire "
                    "during backward on SCALED grads, before unscale_/"
                    "inf-skip can run — construct the optimizer without "
                    "interleave_updates when using a GradScaler, or with "
                    "fused=True (the fused kernel takes a found-inf veto, "
                    "which makes scaling safe)")
        for opt in opts:
            opt._interleave_scaler = self
            self._interleaved_opts[id(opt)] = opt
            if id(opt) not in self._interleave_snaps:
                self._interleave_snaps[id(opt)] = self._snapshot(opt)
                opt._accum_creation_log = {}

    # -- scaling -----------------------------------------------------------
    def scale(self, var):
        """The loss times the current scale."""
        if not self._enable:
            return var
        self._state_on(var.device)
        self._attach_or_refuse_interleaved(
            "refused at scale(), before backward")
        return var * self._scale.to(var.dtype)

    @torch.no_grad()
    def _interleave_unscale(self, g):
        """One gradient unscaled as it lands (the fused interleaved path):
        its finiteness is OR-ed into the running ``found_inf``, which is
        returned as the veto of this and every later layer's update."""
        if g.is_floating_point():
            self._found_inf.logical_or_(~torch.isfinite(g).all())
            g = (g.float() * (1.0 / self._scale)).to(g.dtype)
        return g, self._found_inf

    def _params_with_grads(self, optimizer):
        return [p for p in optimizer._parameter_list
                if p.requires_grad and p.grad is not None]

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Divide the gradients by the scale in place and OR their
        non-finiteness into ``found_inf`` (check_finite_and_unscale)."""
        if not self._enable:
            return
        if (getattr(optimizer, "_interleave", False)
                and getattr(optimizer, "_interleave_scaler", None) is not self):
            self._attach_or_refuse_interleaved("refused at unscale_()")
        state = self._opt_states.get(id(optimizer), OptimizerState.INIT)
        if state is OptimizerState.UNSCALED:
            raise RuntimeError("unscale_() has already been called on this "
                               "optimizer since the last update()")
        if state is OptimizerState.STEPPED:
            raise RuntimeError("unscale_() is being called after step()")
        grads = [p.grad for p in self._params_with_grads(optimizer)
                 if p.grad.is_floating_point()]
        if grads:
            self._state_on(grads[0].device)
            inv_scale = 1.0 / self._scale
            finite = torch.stack([torch.isfinite(g).all() for g in grads])
            self._found_inf.logical_or_(~finite.all())
            f32 = [g for g in grads if g.dtype == torch.float32]
            if f32:
                torch._foreach_mul_(f32, inv_scale)
            for g in grads:
                if g.dtype != torch.float32:
                    g.copy_((g.float() * inv_scale).to(g.dtype))
        self._opt_states[id(optimizer)] = OptimizerState.UNSCALED

    # -- stepping ----------------------------------------------------------
    def _snapshot(self, optimizer):
        params = [p for p in optimizer._parameter_list if p.requires_grad]
        old_params = [p.detach().clone() for p in params]
        old_accums = {name: {k: t.clone() for k, t in store.items()}
                      for name, store in optimizer._accumulators.items()}
        return params, old_params, old_accums

    @torch.no_grad()
    def _rollback_where_inf(self, optimizer, params, old_params, old_accums,
                            creation_log):
        found = self._found_inf
        for p, old in zip(params, old_params):
            p.copy_(torch.where(found, old, p))
        for name, store in optimizer._accumulators.items():
            old_store = old_accums.get(name, {})
            for pname, arr in store.items():
                # accumulators the step created go back to their initial value
                old = old_store.get(pname, creation_log.get((name, pname)))
                if old is not None:
                    arr.copy_(torch.where(found, old, arr))

    @staticmethod
    def _kernel_veto(optimizer, params) -> bool:
        """Whether every update of this step goes through the fused
        kernel, which takes ``found_inf`` as its write veto."""
        return (getattr(optimizer, "_fused", False)
                and hasattr(optimizer, "_fused_supported")
                and all(optimizer._fused_supported(p, p.grad) for p in params))

    def step(self, optimizer):
        """Unscale (if not done yet), then step; where inf/nan was found the
        step changes nothing."""
        if getattr(optimizer, "_interleave", False):
            if getattr(optimizer, "_interleave_scaler", None) is self:
                return self._step_interleaved(optimizer)
            raise ValueError(
                "GradScaler cannot drive an interleave_updates optimizer: "
                "updates fire during backward with SCALED grads, before "
                "unscale_/inf-skip can run — construct it with fused=True "
                "to enable the kernel-level found-inf veto")
        if not self._enable:
            optimizer.step()
            return
        state = self._opt_states.get(id(optimizer), OptimizerState.INIT)
        if state is OptimizerState.STEPPED:
            raise RuntimeError("step() has already been called since the "
                               "last update()")
        if state is OptimizerState.INIT:
            self.unscale_(optimizer)
        params = self._params_with_grads(optimizer)
        if params and self._found_inf is None:
            self._state_on(params[0].device)
        if self._kernel_veto(optimizer, params):
            optimizer._fused_skip = self._found_inf
            try:
                optimizer.step()
            finally:
                optimizer._fused_skip = None
        else:
            snap = self._snapshot(optimizer)
            optimizer._accum_creation_log = {}
            try:
                optimizer.step()
                self._rollback_where_inf(optimizer, *snap,
                                         optimizer._accum_creation_log)
            finally:
                optimizer._accum_creation_log = None
        self._opt_states[id(optimizer)] = OptimizerState.STEPPED

    def _step_interleaved(self, optimizer):
        """step() for a fused interleaved optimizer attached at scale():
        unscale the gradients left (params whose update did not fire during
        backward), run the rest of the step, and roll back all of it where
        the global ``found_inf`` is set."""
        if not self._enable:
            optimizer.step()
            return
        state = self._opt_states.get(id(optimizer), OptimizerState.INIT)
        if state is OptimizerState.STEPPED:
            raise RuntimeError("step() has already been called since the "
                               "last update()")
        if state is OptimizerState.INIT:
            self.unscale_(optimizer)
        snap = self._interleave_snaps.pop(id(optimizer), None)
        if snap is None:  # scale() never saw this optimizer attached
            snap = self._snapshot(optimizer)
            optimizer._accum_creation_log = optimizer._accum_creation_log or {}
        creation_log = optimizer._accum_creation_log
        try:
            optimizer.step()
            self._rollback_where_inf(optimizer, *snap, creation_log or {})
        finally:
            optimizer._accum_creation_log = None
        self._opt_states[id(optimizer)] = OptimizerState.STEPPED

    @torch.no_grad()
    def update(self):
        """Advance the dynamic loss scale (the reference's device rule)."""
        if not self._enable:
            return
        if self._found_inf is None:  # nothing was scaled yet
            self._state_on("cpu")
        if not _capturing():
            # skips are observable on an eager step only: a captured step's
            # found_inf has no value until the graph is replayed
            step_ix = self._n_updates
            self._n_updates += 1
            if bool(self._found_inf):
                self._n_skipped_steps += 1
                self._last_skip_step = step_ix
                if self._on_skip is not None:
                    self._on_skip(step_ix)
        if self._use_dynamic_loss_scaling:
            found = self._found_inf
            # consecutive counters: a good step resets bad and vice versa
            bad = torch.where(found, self._bad_steps + 1, 0)
            good = torch.where(found, 0, self._good_steps + 1)
            shrink = bad >= self._decr_every_n_nan_or_inf
            scale = torch.where(shrink, self._scale * self._decr_ratio,
                                self._scale)
            bad = torch.where(shrink, 0, bad)
            grow = good >= self._incr_every_n_steps
            scale = torch.where(grow, scale * self._incr_ratio, scale)
            good = torch.where(grow, 0, good)
            self._scale.copy_(torch.clamp(scale, min=1.0))
            self._good_steps.copy_(good)
            self._bad_steps.copy_(bad)
        self._found_inf.zero_()
        self._opt_states.clear()
        self._interleave_snaps.clear()
        for opt in self._interleaved_opts.values():
            if getattr(opt, "_interleave_scaler", None) is self:
                opt._interleave_scaler = None
        self._interleaved_opts.clear()

    def minimize(self, optimizer, *args, **kwargs):
        """step + update in one call."""
        if not self._enable:
            return optimizer.step()
        self.step(optimizer)
        self.update()

    # -- observability -------------------------------------------------------
    @property
    def n_skipped_steps(self) -> int:
        """update() cycles that found inf/nan and skipped the step (steps
        run eagerly)."""
        return self._n_skipped_steps

    @property
    def last_skip_step(self) -> int:
        """0-based update() index of the latest skipped step, or -1."""
        return self._last_skip_step

    def set_on_skip(self, callback) -> None:
        self._on_skip = callback

    # -- accessors -----------------------------------------------------------
    def get_scale_value(self) -> float:
        if self._scale is None:
            return self._init_loss_scaling
        return float(self._scale)

    def set_scale_value(self, value: float):
        """Set the scale in place (a captured step reads the new value)."""
        if self._scale is None:
            self._init_loss_scaling = float(value)
        else:
            self._scale.fill_(float(value))

    def get_init_loss_scaling(self):
        return self._init_loss_scaling

    def set_init_loss_scaling(self, v):
        self._init_loss_scaling = float(v)
        if self._scale is not None:
            self._scale.fill_(self._init_loss_scaling)

    def get_incr_ratio(self):
        return self._incr_ratio

    def set_incr_ratio(self, v):
        if v <= 1.0:
            raise ValueError("incr_ratio should be > 1")
        self._incr_ratio = float(v)

    def get_decr_ratio(self):
        return self._decr_ratio

    def set_decr_ratio(self, v):
        if not 0.0 < v < 1.0:
            raise ValueError("decr_ratio should be in (0, 1)")
        self._decr_ratio = float(v)

    def get_incr_every_n_steps(self):
        return self._incr_every_n_steps

    def set_incr_every_n_steps(self, v):
        self._incr_every_n_steps = int(v)

    def get_decr_every_n_nan_or_inf(self):
        return self._decr_every_n_nan_or_inf

    def set_decr_every_n_nan_or_inf(self, v):
        self._decr_every_n_nan_or_inf = int(v)

    def state_dict(self):
        if not self._enable:
            return {}
        count = lambda t: 0 if t is None else int(t)  # noqa: E731
        return {
            "scale": torch.tensor(self.get_scale_value(), dtype=torch.float32),
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
            "incr_every_n_steps": self._incr_every_n_steps,
            "decr_every_n_nan_or_inf": self._decr_every_n_nan_or_inf,
            "incr_count": count(self._good_steps),
            "decr_count": count(self._bad_steps),
            "use_dynamic_loss_scaling": self._use_dynamic_loss_scaling,
        }

    def load_state_dict(self, state_dict):
        """Load a state dict of this class or of the reference's (numpy
        values), in place where the device state exists."""
        if not self._enable:
            if state_dict:
                warnings.warn("Load state_dict on a disabled GradScaler: "
                              "ignored")
            return
        raw = state_dict["scale"]  # a 0-d tensor, numpy array or number
        scale = float(raw.reshape(()) if hasattr(raw, "reshape") else raw)
        self._incr_ratio = float(state_dict["incr_ratio"])
        self._decr_ratio = float(state_dict["decr_ratio"])
        self._incr_every_n_steps = int(state_dict["incr_every_n_steps"])
        self._decr_every_n_nan_or_inf = int(state_dict["decr_every_n_nan_or_inf"])
        good = int(state_dict.get("incr_count", 0))
        bad = int(state_dict.get("decr_count", 0))
        if self._scale is None:
            self._state_on(self._device or "cpu")
        self._scale.fill_(scale)
        self._good_steps.fill_(good)
        self._bad_steps.fill_(bad)


class GradScaler(AmpScaler):
    """The public name (``paddle.amp.GradScaler``)."""
