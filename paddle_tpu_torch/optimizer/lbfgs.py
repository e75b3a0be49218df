"""L-BFGS (counterpart of ``paddle_tpu/optimizer/lbfgs.py``).

A ``step(closure)`` runs up to ``max_iter`` L-BFGS iterations: the
two-loop recursion over a ``history_size`` history of flattened f32
parameter and gradient differences, a fixed step or the strong-Wolfe line
search, and the reference's stopping tests. The closure re-evaluates the
loss and the gradients; the recursion's dot products and the stopping
tests are host decisions (one host read each), as in the reference, so
this optimizer is not captured by ``jit.to_static``.
"""
from __future__ import annotations

from typing import List

import torch

from .optimizer import Optimizer

__all__ = ["LBFGS"]


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])


def _dot(a, b) -> float:
    return float(torch.dot(a, b))


class LBFGS(Optimizer):
    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9, history_size=100,
                 line_search_fn=None, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate=learning_rate, parameters=parameters,
                         weight_decay=weight_decay, grad_clip=grad_clip,
                         name=name)
        self.max_iter = max_iter
        self.max_eval = max_eval if max_eval is not None else max_iter * 5 // 4
        self.tolerance_grad = tolerance_grad
        self.tolerance_change = tolerance_change
        self.history_size = history_size
        if line_search_fn not in (None, "strong_wolfe"):
            raise ValueError("line_search_fn must be None or 'strong_wolfe'")
        self.line_search_fn = line_search_fn
        self._s: List[torch.Tensor] = []
        self._y: List[torch.Tensor] = []
        self._n_evals = 0

    @torch.no_grad()
    def _set_flat_params(self, flat):
        off = 0
        for p in self._parameter_list:
            n = p.numel()
            p.copy_(flat[off:off + n].reshape(p.shape).to(p.dtype))
            off += n

    def _eval(self, closure):
        self._n_evals += 1
        with torch.enable_grad():
            loss = closure()
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 if p.grad is None else p.grad for p in self._parameter_list]
        return float(loss.detach()), _flat(grads)

    def step(self, closure=None):
        """One call is up to ``max_iter`` iterations driven by ``closure``;
        returns the last loss (a float)."""
        if closure is None:
            raise ValueError("LBFGS.step requires a closure")
        lr = float(self.get_lr())
        x0 = _flat([p.detach() for p in self._parameter_list])

        loss, flat_grad = self._eval(closure)
        if float(flat_grad.abs().max()) <= self.tolerance_grad:
            return loss

        x = x0
        for it in range(self.max_iter):
            # two-loop recursion
            q = flat_grad
            alphas = []
            for s, y in zip(reversed(self._s), reversed(self._y)):
                rho = 1.0 / _dot(y, s)
                a = rho * _dot(s, q)
                alphas.append((a, rho, s, y))
                q = q - a * y
            if self._y:
                y_last, s_last = self._y[-1], self._s[-1]
                gamma = _dot(s_last, y_last) / _dot(y_last, y_last)
            else:
                gamma = 1.0
            r = q * gamma
            for a, rho, s, y in reversed(alphas):
                b = rho * _dot(y, r)
                r = r + s * (a - b)
            d = -r
            gtd = _dot(flat_grad, d)
            if gtd > -self.tolerance_change:
                break

            t = (lr if (self._y or it > 0)
                 else min(1.0, 1.0 / float(flat_grad.abs().sum())) * lr)

            if self.line_search_fn == "strong_wolfe":
                t, loss_new, grad_new = self._strong_wolfe(
                    closure, x, t, d, loss, flat_grad, gtd)
            else:
                self._set_flat_params(x + t * d)
                loss_new, grad_new = self._eval(closure)

            x_new = x + t * d
            s_vec = x_new - x
            y_vec = grad_new - flat_grad
            if _dot(s_vec, y_vec) > 1e-10:
                self._s.append(s_vec)
                self._y.append(y_vec)
                if len(self._s) > self.history_size:
                    self._s.pop(0)
                    self._y.pop(0)

            x, loss_prev, loss, flat_grad = x_new, loss, loss_new, grad_new
            if float(flat_grad.abs().max()) <= self.tolerance_grad:
                break
            if float(s_vec.abs().max()) <= self.tolerance_change:
                break
            if abs(loss - loss_prev) < self.tolerance_change:
                break
            if self._n_evals >= self.max_eval:
                break
        self._set_flat_params(x)
        return loss

    def _strong_wolfe(self, closure, x, t, d, f0, g0, gtd0, c1=1e-4, c2=0.9,
                      max_ls=25):
        """Strong-Wolfe line search (the reference's ``_strong_wolfe``)."""

        def phi(step):
            self._set_flat_params(x + step * d)
            f, g = self._eval(closure)
            return f, g, _dot(g, d)

        f_prev, t_prev = f0, 0.0
        f_new, g_new, gtd_new = phi(t)
        for i in range(max_ls):
            if f_new > f0 + c1 * t * gtd0 or (i > 0 and f_new >= f_prev):
                return self._zoom(phi, t_prev, t, f_prev, f_new, f0, gtd0, c1, c2)
            if abs(gtd_new) <= -c2 * gtd0:
                return t, f_new, g_new
            if gtd_new >= 0:
                return self._zoom(phi, t, t_prev, f_new, f_prev, f0, gtd0, c1, c2)
            t_prev, f_prev = t, f_new
            t = t * 2.0
            f_new, g_new, gtd_new = phi(t)
        return t, f_new, g_new

    def _zoom(self, phi, lo, hi, f_lo, f_hi, f0, gtd0, c1, c2, max_zoom=25):
        for _ in range(max_zoom):
            t = 0.5 * (lo + hi)
            f_new, g_new, gtd_new = phi(t)
            if f_new > f0 + c1 * t * gtd0 or f_new >= f_lo:
                hi, f_hi = t, f_new
            else:
                if abs(gtd_new) <= -c2 * gtd0:
                    return t, f_new, g_new
                if gtd_new * (hi - lo) >= 0:
                    hi, f_hi = lo, f_lo
                lo, f_lo = t, f_new
            if abs(hi - lo) < 1e-9:
                break
        f_new, g_new, _ = phi(lo)
        return lo, f_new, g_new
