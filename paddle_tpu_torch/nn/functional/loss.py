"""Loss functionals (counterpart of ``paddle_tpu/nn/functional/loss.py``).

``cross_entropy`` keeps the reference's combined softmax + CE surface
(``use_softmax``, ``soft_label``, ``ignore_index``, ``weight``,
``label_smoothing``, ``reduction``). The hard-label softmax path is the
logsumexp-gather form in f32, ``-log p[y] = logsumexp(logits) - logits[y]``,
which never materialises a log-softmax array of tokens x classes.
"""
from __future__ import annotations

import torch

from ...base.amp_state import amp_cast

__all__ = ["cross_entropy", "softmax_with_cross_entropy", "nll_loss"]


def _reduce(out, reduction):
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    return out


def cross_entropy(input, label, weight=None, ignore_index=-100,  # noqa: A002
                  reduction="mean", soft_label=False, axis=-1, use_softmax=True,
                  label_smoothing=0.0, name=None):
    logits, label, weight = amp_cast("cross_entropy", input, label, weight)
    ax = axis % logits.dim()
    num_classes = logits.shape[ax]
    hard = not (soft_label or (label.dim() == logits.dim()
                               and label.shape[ax] == num_classes
                               and label.is_floating_point()))
    if not hard or not use_softmax:
        logp = (torch.log_softmax(logits, dim=ax) if use_softmax
                else torch.log(torch.clamp(logits, 1e-15, 1.0)))
    if not hard:
        soft = label
        if label_smoothing > 0:
            soft = soft * (1 - label_smoothing) + label_smoothing / num_classes
        loss = -(soft * logp).sum(dim=ax)
        valid = None
    else:
        ids = label
        if ids.dim() == logits.dim():  # trailing singleton label dim
            ids = ids.squeeze(ax)
        ids = ids.long()
        valid = ids != ignore_index
        safe = torch.where(valid, ids, torch.zeros_like(ids))
        if use_softmax:
            lse = torch.logsumexp(logits.float(), dim=ax)
            picked = torch.gather(logits, ax, safe.unsqueeze(ax)).squeeze(ax).float()
            if label_smoothing > 0:
                mean_logit = logits.float().mean(dim=ax)
                loss = ((1 - label_smoothing) * (lse - picked)
                        + label_smoothing * (lse - mean_logit))
            else:
                loss = lse - picked
        else:
            picked = torch.gather(logp, ax, safe.unsqueeze(ax)).squeeze(ax)
            if label_smoothing > 0:
                loss = (-(1 - label_smoothing) * picked
                        - label_smoothing * logp.mean(dim=ax))
            else:
                loss = -picked
        loss = torch.where(valid, loss, torch.zeros_like(loss))
        if weight is not None:
            w = weight[safe]
            w = torch.where(valid, w, torch.zeros_like(w))
            loss = loss * w
            if reduction == "mean":
                return loss.sum() / torch.clamp(w.sum(), min=1e-12)
    if reduction == "mean":
        if valid is not None:
            return loss.sum() / torch.clamp(valid.to(loss.dtype).sum(), min=1.0)
        return loss.mean()
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none", axis=axis)
    if not soft_label:  # the reference keeps a trailing singleton dim
        loss = loss.unsqueeze(axis)
    if return_softmax:
        return loss, torch.softmax(logits, dim=axis)
    return loss


def nll_loss(input, label, weight=None, ignore_index=-100,  # noqa: A002
             reduction="mean", name=None):
    ids = label.long()
    valid = ids != ignore_index
    safe = torch.where(valid, ids, torch.zeros_like(ids))
    picked = torch.gather(input, 1, safe.unsqueeze(1)).squeeze(1)
    loss = -torch.where(valid, picked, torch.zeros_like(picked))
    if weight is not None:
        w = weight[safe] * valid.to(input.dtype)
        loss = loss * w
        if reduction == "mean":
            return loss.sum() / torch.clamp(w.sum(), min=1e-12)
    if reduction == "mean":
        return loss.sum() / torch.clamp(valid.to(input.dtype).sum(), min=1.0)
    return _reduce(loss, reduction)
