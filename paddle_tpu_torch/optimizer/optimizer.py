"""Optimizer base and the optimizers of the training slice (counterpart of
``paddle_tpu/optimizer/optimizer.py``).

Update arithmetic mirrors the reference op for op: f32 compute whatever the
storage dtype, ``_moments`` and ``_adam_delta`` in the reference's order,
AdamW's decay in f32, ``multi_precision`` f32 master weights for bf16/f16
params, ``moment_dtype`` storage for m/v, and the masterless-bf16
stochastic-rounding writeback. The port updates parameters in place under
``torch.no_grad()`` where the reference rebinds immutable arrays.
Accumulators live in ``self._accumulators[name][param_name]``; a param's
name is its position in the optimizer's parameter list (``param_<i>``), so
``state_dict`` keys (``param_<i>.<accumulator>``) restore positionally.

``AdamW(fused=True)`` routes the step's updates through the fused AdamW
kernel (``ops/fused_adamw.py``) with the same numerics, one launch per
(device, p, g, m dtype, SR) group of parameters. Stochastic-rounding salts
come from ``base.random.sr_salts`` on the parameter's device, one ``[T, 2]``
draw per group: no value is read back to the host.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..base import random as _random
from ..ops.fused_adamw import (adamw_scalars_multi, fused_adamw_multi_update,
                               stochastic_round_bf16)
from .lr import LRScheduler

__all__ = [
    "Optimizer", "SGD", "Momentum", "Adam", "AdamW", "L2Decay", "Adagrad",
    "Adadelta", "Adamax", "RMSProp", "Lamb", "NAdam", "RAdam", "Rprop", "ASGD",
    "LBFGS",
]

_LATER = "a later slice of paddle_tpu_torch"


# unbiased f32 -> bf16 rounding with the reference's lowbias32 hash over
# the C-order flat index; the caller draws the two salts on x's device
_stochastic_round_bf16 = stochastic_round_bf16


class L2Decay:
    """grad += coeff * param."""

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __call__(self, param, grad):
        return grad + self.coeff * param


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        if parameters is None:
            raise ValueError("parameters must be given (dygraph mode requires "
                             "the param list)")
        if grad_clip is not None:
            raise NotImplementedError(f"grad_clip arrives with {_LATER}")
        self._param_groups = self._normalize_params(parameters)
        self._names = {id(p): f"param_{i}"
                       for i, p in enumerate(self._parameter_list)}
        self._learning_rate = learning_rate
        self._lr_override = None  # set by jit.StaticFunction.multi_step
        if isinstance(weight_decay, (int, float)):
            self.regularization = L2Decay(float(weight_decay))
        else:
            self.regularization = weight_decay  # an L2Decay, or None
        self._multi_precision = multi_precision
        # accumulator name -> param name -> tensor
        self._accumulators: Dict[str, Dict[str, torch.Tensor]] = {}
        self._stochastic_rounding = False
        self._global_step = 0

    def _normalize_params(self, parameters):
        parameters = list(parameters)
        if parameters and isinstance(parameters[0], dict):
            groups = []
            for g in parameters:
                g = dict(g)
                g["params"] = list(g["params"])
                if g.get("grad_clip") is not None:
                    raise NotImplementedError(f"grad_clip arrives with {_LATER}")
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

    def _lr(self) -> float:
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
            else:
                store[key] = init
        return store[key]

    def _set_accum(self, name: str, param, value):
        self._accumulators[name][self._name(param)] = value

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
        return store[key]

    # -- step --------------------------------------------------------------
    @torch.no_grad()
    def step(self):
        """The reference's order: the global step, then per group each
        param with a gradient, its regularizer (the group's weight_decay
        before the optimizer's), and the update."""
        self._global_step += 1
        for group in self._param_groups:
            params_grads = [(p, p.grad) for p in group["params"]
                            if p.requires_grad and p.grad is not None]
            group_reg = group.get("weight_decay", None)
            if isinstance(group_reg, (int, float)):
                group_reg = L2Decay(float(group_reg))
            group_lr_scale = float(group.get("learning_rate", 1.0))
            for p, g in params_grads:
                reg = group_reg or self.regularization
                if reg is not None:
                    g = reg(p, g)
                self._update_param(p, g, group_lr_scale, group)

    def _update_param(self, p, g, lr_scale, group):
        raise NotImplementedError

    def _apply(self, p, new_value):
        """Write back an update computed in master precision."""
        if self._use_master(p):
            self._accumulators["master_weight"][self._name(p)] = new_value
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
        lr = self._lr() * lr_scale
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
        lr = self._lr() * lr_scale
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
        ones = torch.ones((), dtype=compute, device=p.device)
        b1p = self._get_accum("beta1_pow", p, init=ones).to(compute) * self._beta1
        b2p = self._get_accum("beta2_pow", p, init=ones.clone()).to(compute) * self._beta2
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
        lr = self._lr() * lr_scale
        pv, g, m, v, b1p, b2p = self._moments(p, g)
        self._apply(p, pv - self._adam_delta(lr, m, v, b1p, b2p))


class AdamW(_AdamBase):
    """Decoupled weight decay (default coeff 0.01); ``apply_decay_param_fun``
    takes a param name (``param_<i>``) and filters which params decay.
    ``fused=True`` runs the step's updates through the fused AdamW kernel
    with the same numerics, one launch per group of parameters that share
    the kernel's types."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None,
                 moment_dtype=None, use_stochastic_rounding=False,
                 interleave_updates=False, fused=False):
        if interleave_updates:
            raise NotImplementedError(f"interleave_updates arrives with {_LATER}")
        if callable(weight_decay):
            raise NotImplementedError(
                f"a callable weight_decay arrives with {_LATER}")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision, name,
                         moment_dtype=moment_dtype,
                         use_stochastic_rounding=use_stochastic_rounding)
        self._coeff = float(weight_decay)
        self._lr_ratio = lr_ratio
        self._apply_decay_param_fun = apply_decay_param_fun
        self._fused = bool(fused)
        self._fused_pending = None  # (p, g, lr) of this step's fused updates

    def _decay_for(self, p) -> float:
        decay = self._coeff
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

    def _update_param(self, p, g, lr_scale, group):
        lr = self._lr() * lr_scale
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

    def _beta_pows(self, ps, device):
        """This group's beta powers advanced by one step, as two f32 ``[T]``
        vectors (the unfused path's f32 products, one launch per vector);
        each parameter's ``beta1_pow`` / ``beta2_pow`` accumulator becomes
        a view of its entry, so ``state_dict`` keeps its keys."""
        names = [self._name(p) for p in ps]
        out = []
        for accum, beta in (("beta1_pow", self._beta1),
                            ("beta2_pow", self._beta2)):
            store = self._accumulators.setdefault(accum, {})
            if any(n not in store for n in names):  # first step: ones
                ones = torch.ones((), dtype=torch.float32, device=device)
                for n in names:
                    store.setdefault(n, ones)
            vec = torch.stack([store[n].to(torch.float32) for n in names]) * beta
            store.update(zip(names, vec.unbind(0)))
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
        for (device, *_, sr), items in groups.items():
            ps, pvs, gs, ms, vs, lrs, masters = map(list, zip(*items))
            b1p, b2p = self._beta_pows(ps, device)
            scalars = adamw_scalars_multi(
                lr=lrs, epsilon=self._epsilon, beta1_pow=b1p, beta2_pow=b2p,
                weight_decay=[self._decay_for(p) for p in ps])
            fused_adamw_multi_update(
                pvs, gs, ms, vs, scalars=scalars, beta1=self._beta1,
                beta2=self._beta2,
                sr_salts=_random.sr_salts(device, len(ps)) if sr else None)
            for p, pv, use_master in zip(ps, pvs, masters):
                if use_master:
                    p.copy_(pv)


def _later(name: str):
    """An optimizer of the reference that a later slice ports: constructing
    it raises."""
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"{name} arrives with {_LATER}")

    return type(name, (Optimizer,), {"__init__": __init__, "__doc__":
                                     f"Not ported yet: {name} arrives with "
                                     f"{_LATER}."})


Adagrad = _later("Adagrad")
Adadelta = _later("Adadelta")
Adamax = _later("Adamax")
RMSProp = _later("RMSProp")
Lamb = _later("Lamb")
NAdam = _later("NAdam")
RAdam = _later("RAdam")
Rprop = _later("Rprop")
ASGD = _later("ASGD")
LBFGS = _later("LBFGS")
