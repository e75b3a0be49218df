"""Optimizer base and every optimizer of the reference (counterpart of
``paddle_tpu/optimizer/optimizer.py``).

Update arithmetic mirrors the reference op for op: f32 compute whatever the
storage dtype, ``_moments`` and ``_adam_delta`` in the reference's order,
AdamW's decay in f32, ``multi_precision`` f32 master weights for bf16/f16
params, ``moment_dtype`` storage for m/v, and the masterless-bf16
stochastic-rounding writeback. The reference rebinds immutable arrays; the
port writes every parameter, master weight and accumulator in place once
it exists, so a step's state keeps its addresses from step to step and
the step can be captured as a CUDA graph (``jit.to_static``). A param's
name is its position in the optimizer's parameter list (``param_<i>``), so
``state_dict`` keys (``param_<i>.<accumulator>``) restore positionally;
``state_dict()`` holds the live accumulators, as torch's optimizers do.

The step's order is the reference's: per group, gradient clipping
(``grad_clip``, the group's before the optimizer's), then the regularizer
(the parameter's ``regularizer``, else the group's ``weight_decay``, else
the optimizer's), then the update with the learning rate scaled by the
group's and the parameter's ``optimize_attr`` learning rate. The learning
rate is a Python float, or a device scalar while ``jit.to_static`` has set
one (``_lr_override``): then every scalar of the update is formed on the
device.

``AdamW(fused=True)`` routes the step's updates through the fused AdamW
kernel (``ops/fused_adamw.py``) with the same numerics, one launch per
(device, p, g, m dtype, SR) group of parameters; a device bool in
``_fused_skip`` (set by ``amp.GradScaler``) vetoes the launch's writes and
the beta powers' advance. ``interleave_updates=True`` applies each
parameter's update the moment its gradient is accumulated during
``backward()`` (a post-accumulate-grad hook), as the reference's tape
does. Stochastic-rounding salts come from ``base.random.sr_salts`` on the
parameter's device: no value is read back to the host.
"""
from __future__ import annotations

import weakref
from typing import Dict

import torch

from ..base import random as _random
from ..ops.fused_adamw import (adamw_scalars_multi, fused_adamw_multi_update,
                               stochastic_round_bf16)
from .lr import LRScheduler

__all__ = [
    "Optimizer", "SGD", "Momentum", "Adam", "AdamW", "L1Decay", "L2Decay",
    "Adagrad", "Adadelta", "Adamax", "RMSProp", "Lamb", "NAdam", "RAdam",
    "Rprop", "ASGD",
]


# unbiased f32 -> bf16 rounding with the reference's lowbias32 hash over
# the C-order flat index; the caller draws the two salts on x's device
_stochastic_round_bf16 = stochastic_round_bf16


class L2Decay:
    """grad += coeff * param."""

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __call__(self, param, grad):
        return grad + self.coeff * param


class L1Decay:
    """grad += coeff * sign(param)."""

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __call__(self, param, grad):
        return grad + self.coeff * torch.sign(param)


# interleaved updates: id(param) -> (hook handle, weakref to the optimizer)
_interleave_registry: Dict[int, tuple] = {}


def _unregister_interleaved(params) -> None:
    for p in params:
        entry = _interleave_registry.pop(id(p), None)
        if entry is not None:
            entry[0].remove()


def interleaving_optimizers():
    """The live optimizers that apply updates during ``backward()``."""
    opts = {}
    for _, oref in list(_interleave_registry.values()):
        o = oref()
        if o is not None:
            opts[id(o)] = o
    return list(opts.values())


def _lr_factor(lr, factor):
    """``lr * factor`` without a device op when the factor is 1."""
    return lr if factor == 1.0 else lr * factor


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        if parameters is None:
            raise ValueError("parameters must be given (dygraph mode requires "
                             "the param list)")
        self._param_groups = self._normalize_params(parameters)
        self._names = {id(p): f"param_{i}"
                       for i, p in enumerate(self._parameter_list)}
        self._learning_rate = learning_rate
        self._lr_override = None  # a float or device scalar set by jit
        if isinstance(weight_decay, (int, float)):
            self.regularization = L2Decay(float(weight_decay))
        else:
            self.regularization = weight_decay  # L1Decay/L2Decay/None
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        # accumulator name -> param name -> tensor
        self._accumulators: Dict[str, Dict[str, torch.Tensor]] = {}
        self._stochastic_rounding = False
        self._global_step = 0
        # interleaved updates (AdamW(interleave_updates=True))
        self._interleave = False
        self._interleave_applied = set()  # params updated this cycle
        self._interleave_scaler = None  # amp.GradScaler attach point
        self._fused_skip = None  # device bool: the fused kernel's veto
        # set by amp.GradScaler around a step it may roll back: the initial
        # value of every accumulator the step creates
        self._accum_creation_log = None
        # a new optimizer over these params takes them over: an abandoned
        # interleaving optimizer must not go on updating them
        _unregister_interleaved(self._parameter_list)

    def _normalize_params(self, parameters):
        parameters = list(parameters)
        if parameters and isinstance(parameters[0], dict):
            groups = []
            for g in parameters:
                g = dict(g)
                g["params"] = list(g["params"])
                groups.append(g)
            return groups
        return [{"params": parameters}]

    @property
    def _parameter_list(self):
        out = []
        for g in self._param_groups:
            out.extend(g["params"])
        return out

    def _name(self, p) -> str:
        return self._names[id(p)]

    # -- learning rate ---------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value: float):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    def _lr(self):
        if self._lr_override is not None:
            return self._lr_override
        return self.get_lr()

    # -- accumulators ------------------------------------------------------
    def _get_accum(self, name: str, param, init=None, dtype=None):
        store = self._accumulators.setdefault(name, {})
        key = self._name(param)
        if key not in store:
            if init is None:
                dt = dtype or (torch.float32 if self._use_master(param)
                               else param.dtype)
                store[key] = torch.zeros(param.shape, dtype=dt,
                                         device=param.device)
            else:  # a tensor, or a function that makes it (called once)
                store[key] = init() if callable(init) else init
            self._log_creation(name, key, store[key])
        return store[key]

    def _log_creation(self, name, key, value):
        if self._accum_creation_log is not None:
            self._accum_creation_log[(name, key)] = value.clone()

    def _set_accum(self, name: str, param, value):
        """Write ``value`` into the accumulator in place where it exists
        with the same shape and dtype (its address stays), else bind it."""
        store = self._accumulators.setdefault(name, {})
        key = self._name(param)
        old = store.get(key)
        if (old is not None and old is not value and old.shape == value.shape
                and old.dtype == value.dtype and old.device == value.device):
            old.copy_(value)
        else:
            store[key] = value

    def _use_master(self, param) -> bool:
        return self._multi_precision and param.dtype in (torch.float16,
                                                         torch.bfloat16)

    def _master_weight(self, param):
        if not self._use_master(param):
            return None
        store = self._accumulators.setdefault("master_weight", {})
        key = self._name(param)
        if key not in store:
            store[key] = param.detach().to(torch.float32)
            self._log_creation("master_weight", key, store[key])
        return store[key]

    # -- interleaved updates -------------------------------------------------
    def _enable_interleaving(self):
        """Register every parameter for an update the moment its gradient
        is accumulated (``Tensor.register_post_accumulate_grad_hook``). The
        update is the one ``step()`` would make; only its place in the
        program moves, into the backward pass. The reference's scope: one
        param group, no gradient clipping and no regularizer (both need
        every gradient before any update)."""
        if len(self._param_groups) != 1:
            raise ValueError(
                "interleave_updates supports a single param group")
        group = self._param_groups[0]
        if (self._grad_clip is not None or self.regularization is not None
                or group.get("grad_clip") is not None
                or group.get("weight_decay") is not None):
            raise ValueError(
                "interleave_updates is incompatible with grad_clip/"
                "weight_decay regularizers (they need all grads before "
                "any update); use the optimizer's decoupled decay")
        self._interleave = True
        ref = weakref.ref(self)

        def hook(p):
            o = ref()
            if o is not None:
                o._interleave_apply(p)

        for p in group["params"]:
            _interleave_registry[id(p)] = (
                p.register_post_accumulate_grad_hook(hook), ref)

    @torch.no_grad()
    def _interleave_apply(self, p):
        g = p.grad
        if g is None or not p.requires_grad:
            return
        if id(p) in self._interleave_applied:
            raise RuntimeError(
                "interleave_updates: a second backward() reached parameter "
                f"{self._name(p)!r} before step() — gradient accumulation "
                "(multiple backwards per step) is incompatible with "
                "interleaved updates; disable interleave_updates for "
                "accumulation loops")
        self._interleave_applied.add(id(p))
        scaler = self._interleave_scaler
        if scaler is not None and scaler.is_enable():
            # unscale this gradient as it lands and carry the running
            # found-inf flag into the fused kernel as its write veto
            g, self._fused_skip = scaler._interleave_unscale(g)
        group = self._param_groups[0]
        try:
            self._update_now(p, g, self._lr_scale(p, group), group)
        finally:
            self._fused_skip = None
        p.grad = None  # consumed: step() passes this parameter by

    def _update_now(self, p, g, lr_scale, group):
        self._update_param(p, g, lr_scale, group)

    # -- step --------------------------------------------------------------
    @staticmethod
    def _lr_scale(p, group) -> float:
        attr = getattr(p, "optimize_attr", None)
        own = float(attr.get("learning_rate", 1.0)) if attr else 1.0
        return own * float(group.get("learning_rate", 1.0))

    @torch.no_grad()
    def step(self):
        """The reference's order: the global step, then per group the
        params with a gradient, gradient clipping, each param's
        regularizer, and the update."""
        self._global_step += 1
        self._interleave_applied.clear()
        for group in self._param_groups:
            params_grads = [(p, p.grad) for p in group["params"]
                            if p.requires_grad and p.grad is not None]
            grad_clip = group.get("grad_clip", self._grad_clip)
            if grad_clip is not None and params_grads:
                params_grads = grad_clip(params_grads)
            group_reg = group.get("weight_decay", None)
            if isinstance(group_reg, (int, float)):
                group_reg = L2Decay(float(group_reg))
            for p, g in params_grads:
                reg = (getattr(p, "regularizer", None) or group_reg
                       or self.regularization)
                if reg is not None:
                    g = reg(p, g)
                self._update_param(p, g, self._lr_scale(p, group), group)

    def _update_param(self, p, g, lr_scale, group):
        raise NotImplementedError

    def _apply(self, p, new_value):
        """Write back an update computed in master precision."""
        if self._use_master(p):
            self._accumulators["master_weight"][self._name(p)].copy_(new_value)
            p.copy_(new_value)
        elif (self._stochastic_rounding and p.dtype == torch.bfloat16
              and new_value.dtype != torch.bfloat16):
            p.copy_(_stochastic_round_bf16(new_value, _random.sr_salts(p.device)))
        else:
            p.copy_(new_value)

    def _param_value(self, p):
        mw = self._master_weight(p)
        return mw if mw is not None else p.detach()

    def clear_grad(self, set_to_zero: bool = False):
        for p in self._parameter_list:
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        self.step()
        return None, None

    # -- state dict --------------------------------------------------------
    def state_dict(self):
        sd = {}
        for name, store in self._accumulators.items():
            for pname, t in store.items():
                sd[f"{pname}.{name}"] = t
        sd["global_step"] = self._global_step
        if isinstance(self._learning_rate, LRScheduler):
            sd["LR_Scheduler"] = self._learning_rate.state_dict()
        return sd

    def set_state_dict(self, state_dict):
        """Restore by position: ``param_<i>`` is the i-th parameter of this
        optimizer, as it was of the one that saved."""
        self._global_step = int(state_dict.get("global_step", 0))
        if ("LR_Scheduler" in state_dict
                and isinstance(self._learning_rate, LRScheduler)):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])
        params = {self._name(p): p for p in self._parameter_list}
        for key, val in state_dict.items():
            if key in ("global_step", "LR_Scheduler"):
                continue
            pname, _, accum = key.rpartition(".")
            if pname not in params:
                raise KeyError(f"state_dict entry {key!r} names no parameter "
                               f"of this optimizer")
            dev = params[pname].device
            self._accumulators.setdefault(accum, {})[pname] = (
                torch.as_tensor(val).detach().to(dev).clone())

    set_dict = set_state_dict


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    def _update_param(self, p, g, lr_scale, group):
        lr = _lr_factor(self._lr(), lr_scale)
        pv = self._param_value(p)
        self._apply(p, pv - lr * g.to(pv.dtype))


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _update_param(self, p, g, lr_scale, group):
        lr = _lr_factor(self._lr(), lr_scale)
        pv = self._param_value(p)
        g = g.to(pv.dtype)
        vel = self._get_accum("velocity", p)
        vel = self._momentum * vel + g
        self._set_accum("velocity", p, vel)
        if self._use_nesterov:
            self._apply(p, pv - lr * (g + self._momentum * vel))
        else:
            self._apply(p, pv - lr * vel)


_MOMENT_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                  "float32": torch.float32}


class _AdamBase(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None, moment_dtype=None, use_stochastic_rounding=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        # masterless-bf16 mode: unbiased stochastic-rounded writes (ignored
        # where master weights exist)
        self._stochastic_rounding = bool(use_stochastic_rounding)
        # storage dtype of m/v; the update arithmetic stays f32
        self._moment_dtype = (None if moment_dtype is None else
                              _MOMENT_DTYPES.get(str(moment_dtype), moment_dtype))

    def _moments(self, p, g):
        pv = self._param_value(p)
        compute = torch.float64 if pv.dtype == torch.float64 else torch.float32
        store = self._moment_dtype or pv.dtype
        g = g.to(compute)
        m = self._get_accum("moment1", p, dtype=self._moment_dtype).to(compute)
        v = self._get_accum("moment2", p, dtype=self._moment_dtype).to(compute)
        ones = lambda: torch.ones((), dtype=compute, device=p.device)  # noqa: E731
        b1p = self._get_accum("beta1_pow", p, init=ones).to(compute) * self._beta1
        b2p = self._get_accum("beta2_pow", p, init=ones).to(compute) * self._beta2
        m = self._beta1 * m + (1 - self._beta1) * g
        v = self._beta2 * v + (1 - self._beta2) * g * g
        self._set_accum("moment1", p, m.to(store))
        self._set_accum("moment2", p, v.to(store))
        self._set_accum("beta1_pow", p, b1p)
        self._set_accum("beta2_pow", p, b2p)
        return pv, g, m, v, b1p, b2p

    def _adam_delta(self, lr, m, v, b1p, b2p):
        # lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t);
        # denom = sqrt(v) + eps * sqrt(1 - b2^t)
        lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
        return lr_t * m / (torch.sqrt(v) + self._epsilon * torch.sqrt(1 - b2p))


class Adam(_AdamBase):
    def _update_param(self, p, g, lr_scale, group):
        lr = _lr_factor(self._lr(), lr_scale)
        pv, g, m, v, b1p, b2p = self._moments(p, g)
        self._apply(p, pv - self._adam_delta(lr, m, v, b1p, b2p))


class AdamW(_AdamBase):
    """Decoupled weight decay (default coeff 0.01). ``weight_decay`` is a
    float, or a callable that takes a parameter and returns its
    coefficient; ``apply_decay_param_fun`` takes a param name
    (``param_<i>``) and filters which params decay. ``fused=True`` runs the
    step's updates through the fused AdamW kernel with the same numerics,
    one launch per group of parameters that share the kernel's types;
    ``interleave_updates=True`` updates each parameter during
    ``backward()`` as its gradient lands (with ``fused=True``, one launch
    per parameter)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None,
                 moment_dtype=None, use_stochastic_rounding=False,
                 interleave_updates=False, fused=False):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision, name,
                         moment_dtype=moment_dtype,
                         use_stochastic_rounding=use_stochastic_rounding)
        self._coeff = (weight_decay if callable(weight_decay)
                       else float(weight_decay))
        self._lr_ratio = lr_ratio
        self._apply_decay_param_fun = apply_decay_param_fun
        self._fused = bool(fused)
        self._fused_pending = None  # (p, g, lr) of this step's fused updates
        # per group of parameter names: the [T] beta-power vectors their
        # accumulators view, kept so a step advances them in place
        self._beta_vecs: Dict[tuple, list] = {}
        if interleave_updates:
            self._enable_interleaving()

    def _decay_for(self, p) -> float:
        decay = (float(self._coeff(p)) if callable(self._coeff)
                 else self._coeff)
        if (self._apply_decay_param_fun is not None
                and not self._apply_decay_param_fun(self._name(p))):
            decay = 0.0
        if getattr(p, "no_weight_decay", False):
            decay = 0.0
        return decay

    def _fused_supported(self, p, g) -> bool:
        # the kernel computes in f32: f64 params keep the unfused path
        return p.dtype != torch.float64 and g.is_floating_point()

    @torch.no_grad()
    def step(self):
        """The reference's step; the fused updates are gathered on the way
        and launched together at its end (each parameter's update depends
        on nothing but its own tensors, so the order does not matter)."""
        self._fused_pending = []
        try:
            super().step()
            if self._fused_pending:
                self._fused_step(self._fused_pending)
        finally:
            self._fused_pending = None

    def _update_now(self, p, g, lr_scale, group):
        self._fused_pending = []
        try:
            self._update_param(p, g, lr_scale, group)
            if self._fused_pending:
                self._fused_step(self._fused_pending)
        finally:
            self._fused_pending = None

    def _update_param(self, p, g, lr_scale, group):
        lr = _lr_factor(self._lr(), lr_scale)
        if self._lr_ratio is not None:
            lr = lr * self._lr_ratio(p)
        if self._fused and self._fused_supported(p, g):
            self._fused_pending.append((p, g, lr))
            return
        pv, g, m, v, b1p, b2p = self._moments(p, g)
        decay = self._decay_for(p)
        # decay in the f32 compute dtype (in bf16 a relative change of
        # ~1e-6 would round away and never reach the parameter)
        compute = torch.float64 if pv.dtype == torch.float64 else torch.float32
        pv = pv.to(compute) * (1.0 - lr * decay)
        self._apply(p, pv - self._adam_delta(lr, m, v, b1p, b2p))

    def _beta_pows(self, ps, device, skip=None):
        """This group's beta powers advanced by one step (not where
        ``skip`` is set), as two f32 ``[T]`` vectors (the unfused path's
        f32 products); each parameter's ``beta1_pow`` / ``beta2_pow``
        accumulator is a view of its entry, so ``state_dict`` keeps its
        keys. While the accumulators are still the views a previous step
        made, the vectors advance in place."""
        names = tuple(self._name(p) for p in ps)
        kept = self._beta_vecs.setdefault(names, [None, None])
        out = []
        for i, (accum, beta) in enumerate((("beta1_pow", self._beta1),
                                           ("beta2_pow", self._beta2))):
            store = self._accumulators.setdefault(accum, {})
            if kept[i] is not None and all(
                    store.get(n) is v for n, v in zip(names, kept[i][1])):
                vec = kept[i][0]
                new = vec * beta
                vec.copy_(new if skip is None else torch.where(skip, vec, new))
            else:
                if any(n not in store for n in names):  # first step: ones
                    ones = torch.ones((), dtype=torch.float32, device=device)
                    for n in names:
                        if n not in store:
                            store[n] = ones
                            self._log_creation(accum, n, ones)
                old = torch.stack([store[n].to(torch.float32) for n in names])
                vec = old * beta
                if skip is not None:
                    vec = torch.where(skip, old, vec)
                views = vec.unbind(0)
                store.update(zip(names, views))
                kept[i] = (vec, views)
            out.append(vec)
        return out

    def _fused_step(self, pending):
        """Kernel backend: same accumulator layout and writeback modes as
        _moments/_apply (master weights updated in place, masterless bf16
        with the SR writeback, or a plain cast), one launch per (device, p,
        g, m dtype, SR) group."""
        groups = {}
        for p, g, lr in pending:
            pv = self._param_value(p)
            m = self._get_accum("moment1", p, dtype=self._moment_dtype)
            v = self._get_accum("moment2", p, dtype=self._moment_dtype)
            use_master = self._use_master(p)
            sr = (not use_master and self._stochastic_rounding
                  and p.dtype == torch.bfloat16)
            key = (p.device, pv.dtype, g.dtype, m.dtype, sr)
            groups.setdefault(key, []).append((p, pv, g, m, v, lr, use_master))
        skip = self._fused_skip
        for (device, *_, sr), items in groups.items():
            ps, pvs, gs, ms, vs, lrs, masters = map(list, zip(*items))
            b1p, b2p = self._beta_pows(ps, device, skip)
            lr = lrs[0] if all(x is lrs[0] for x in lrs) else lrs
            scalars = adamw_scalars_multi(
                lr=lr, epsilon=self._epsilon, beta1_pow=b1p, beta2_pow=b2p,
                weight_decay=[self._decay_for(p) for p in ps], skip=skip)
            fused_adamw_multi_update(
                pvs, gs, ms, vs, scalars=scalars, beta1=self._beta1,
                beta2=self._beta2,
                sr_salts=_random.sr_salts(device, len(ps)) if sr else None)
            for p, pv, use_master in zip(ps, pvs, masters):
                if use_master:
                    p.copy_(pv)


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._epsilon = epsilon
        self._initial = initial_accumulator_value

    def _update_param(self, p, g, lr_scale, group):
        lr = _lr_factor(self._lr(), lr_scale)
        pv = self._param_value(p)
        g = g.to(pv.dtype)
        mom = self._get_accum("moment", p, init=lambda: torch.full(
            pv.shape, self._initial, dtype=pv.dtype, device=pv.device))
        mom = mom + g * g
        self._set_accum("moment", p, mom)
        self._apply(p, pv - lr * g / (torch.sqrt(mom) + self._epsilon))


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._epsilon = epsilon
        self._rho = rho

    def _update_param(self, p, g, lr_scale, group):
        lr = _lr_factor(self._lr(), lr_scale)
        pv = self._param_value(p)
        g = g.to(pv.dtype)
        e_g = self._get_accum("avg_squared_grad", p)
        e_u = self._get_accum("avg_squared_update", p)
        e_g = self._rho * e_g + (1 - self._rho) * g * g
        update = torch.sqrt(e_u + self._epsilon) / torch.sqrt(e_g + self._epsilon) * g
        e_u = self._rho * e_u + (1 - self._rho) * update * update
        self._set_accum("avg_squared_grad", p, e_g)
        self._set_accum("avg_squared_update", p, e_u)
        self._apply(p, pv - lr * update)


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _update_param(self, p, g, lr_scale, group):
        lr = _lr_factor(self._lr(), lr_scale)
        pv = self._param_value(p)
        g = g.to(pv.dtype)
        m = self._get_accum("moment", p)
        inf = self._get_accum("inf_norm", p)
        b1p = self._get_accum("beta1_pow", p, init=lambda: torch.ones(
            (), dtype=pv.dtype, device=pv.device))
        b1p = b1p * self._beta1
        m = self._beta1 * m + (1 - self._beta1) * g
        inf = torch.maximum(self._beta2 * inf, torch.abs(g))
        self._set_accum("moment", p, m)
        self._set_accum("inf_norm", p, inf)
        self._set_accum("beta1_pow", p, b1p)
        self._apply(p, pv - (lr / (1 - b1p)) * m / (inf + self._epsilon))


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _update_param(self, p, g, lr_scale, group):
        lr = _lr_factor(self._lr(), lr_scale)
        pv = self._param_value(p)
        g = g.to(pv.dtype)
        ms = self._get_accum("mean_square", p)
        mom = self._get_accum("momentum", p)
        ms = self._rho * ms + (1 - self._rho) * g * g
        self._set_accum("mean_square", p, ms)
        if self._centered:
            mg = self._get_accum("mean_grad", p)
            mg = self._rho * mg + (1 - self._rho) * g
            self._set_accum("mean_grad", p, mg)
            denom = torch.sqrt(ms - mg * mg + self._epsilon)
        else:
            denom = torch.sqrt(ms + self._epsilon)
        mom = self._momentum * mom + lr * g / denom
        self._set_accum("momentum", p, mom)
        self._apply(p, pv - mom)


class Lamb(Optimizer):
    """Layer-wise trust ratio (the reference's ``lamb.py``)."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01, beta1=0.9,
                 beta2=0.999, epsilon=1e-6, parameters=None, grad_clip=None,
                 exclude_from_weight_decay_fn=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision, name)
        self._wd = lamb_weight_decay
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _update_param(self, p, g, lr_scale, group):
        lr = _lr_factor(self._lr(), lr_scale)
        pv = self._param_value(p)
        g = g.to(pv.dtype)
        ones = lambda: torch.ones((), dtype=pv.dtype, device=pv.device)  # noqa: E731
        m = self._get_accum("moment1", p)
        v = self._get_accum("moment2", p)
        b1p = self._get_accum("beta1_pow", p, init=ones)
        b2p = self._get_accum("beta2_pow", p, init=ones)
        b1p, b2p = b1p * self._beta1, b2p * self._beta2
        m = self._beta1 * m + (1 - self._beta1) * g
        v = self._beta2 * v + (1 - self._beta2) * g * g
        self._set_accum("moment1", p, m)
        self._set_accum("moment2", p, v)
        self._set_accum("beta1_pow", p, b1p)
        self._set_accum("beta2_pow", p, b2p)
        m_hat = m / (1 - b1p)
        v_hat = v / (1 - b2p)
        wd = (0.0 if (self._exclude_fn is not None and self._exclude_fn(p))
              else self._wd)
        r = m_hat / (torch.sqrt(v_hat) + self._epsilon) + wd * pv
        p_norm = torch.linalg.vector_norm(pv)
        r_norm = torch.linalg.vector_norm(r)
        trust = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm,
                            torch.ones_like(p_norm))
        self._apply(p, pv - lr * trust * r)


class NAdam(_AdamBase):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip)
        self._momentum_decay = momentum_decay

    def _update_param(self, p, g, lr_scale, group):
        lr = _lr_factor(self._lr(), lr_scale)
        pv = self._param_value(p)
        g = g.to(pv.dtype)
        # the step count is a device accumulator (never the host
        # _global_step), so a captured step and a GradScaler rollback see it
        t = self._get_accum("step", p, init=lambda: torch.zeros(
            (), dtype=torch.float32, device=pv.device)) + 1
        self._set_accum("step", p, t)
        md = self._momentum_decay
        mu_t = self._beta1 * (1 - 0.5 * torch.pow(0.96, t * md))
        mu_next = self._beta1 * (1 - 0.5 * torch.pow(0.96, (t + 1) * md))
        mu_prod = self._get_accum("mu_product", p, init=lambda: torch.ones(
            (), dtype=pv.dtype, device=pv.device))
        mu_prod = mu_prod * mu_t
        self._set_accum("mu_product", p, mu_prod)
        m = self._get_accum("moment1", p)
        v = self._get_accum("moment2", p)
        m = self._beta1 * m + (1 - self._beta1) * g
        v = self._beta2 * v + (1 - self._beta2) * g * g
        self._set_accum("moment1", p, m)
        self._set_accum("moment2", p, v)
        m_hat = (mu_next * m / (1 - mu_prod * mu_next)
                 + (1 - mu_t) * g / (1 - mu_prod))
        v_hat = v / (1 - torch.pow(self._beta2, t))
        self._apply(p, pv - lr * m_hat / (torch.sqrt(v_hat) + self._epsilon))


class RAdam(_AdamBase):
    def _update_param(self, p, g, lr_scale, group):
        lr = _lr_factor(self._lr(), lr_scale)
        pv, g, m, v, b1p, b2p = self._moments(p, g)
        t = self._get_accum("step", p, init=lambda: torch.zeros(
            (), dtype=torch.float32, device=pv.device)) + 1
        self._set_accum("step", p, t)
        rho_inf = 2.0 / (1 - self._beta2) - 1
        rho_t = rho_inf - 2 * t * b2p / (1 - b2p)
        m_hat = m / (1 - b1p)
        # the rectification gate as a select (no host branch); the clamp
        # keeps the branch not taken finite
        rho_s = torch.clamp(rho_t, min=5.0)
        r = torch.sqrt(((rho_s - 4) * (rho_s - 2) * rho_inf)
                       / ((rho_inf - 4) * (rho_inf - 2) * rho_s)).to(pv.dtype)
        v_hat = torch.sqrt(v / (1 - b2p))
        rect = pv - lr * r * m_hat / (v_hat + self._epsilon)
        plain = pv - lr * m_hat
        self._apply(p, torch.where(rho_t > 5, rect, plain))


class Rprop(Optimizer):
    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision, name)
        self._lr_range = learning_rate_range
        self._etas = etas

    def _update_param(self, p, g, lr_scale, group):
        pv = self._param_value(p)
        g = g.to(pv.dtype)
        prev = self._get_accum("prev_grad", p)
        lrs = self._get_accum("lrs", p,
                              init=lambda: torch.zeros_like(pv) + self._lr())
        sign = torch.sign(g * prev)
        lrs = torch.where(
            sign > 0, torch.clamp(lrs * self._etas[1], max=self._lr_range[1]),
            torch.where(sign < 0,
                        torch.clamp(lrs * self._etas[0], min=self._lr_range[0]),
                        lrs))
        g_eff = torch.where(sign < 0, torch.zeros_like(g), g)
        self._set_accum("prev_grad", p, g_eff)
        self._set_accum("lrs", p, lrs)
        self._apply(p, pv - lrs * torch.sign(g_eff))


class ASGD(Optimizer):
    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._batch_num = batch_num

    def _update_param(self, p, g, lr_scale, group):
        lr = _lr_factor(self._lr(), lr_scale)
        pv = self._param_value(p)
        self._apply(p, pv - lr * g.to(pv.dtype))
