"""Draft proposers for self-speculative decoding (counterpart of
``paddle_tpu/inference/speculative.py``, pure numpy, the same behaviour).

Speculative decoding factors each decode step into a cheap DRAFT of k
candidate tokens plus ONE batched verify dispatch that scores all k+1
positions through the normal model (Leviathan et al. 2023; the serving
engine's verify program is the paged prefill path at width k+1, see
inference/serving.py). With greedy (temperature-0) decoding the
accept rule is exact-prefix: position j's draft is accepted iff it
equals the argmax the model produced at position j-1 — so every
emitted token is, by construction, the token the plain one-at-a-time
loop would have produced. Speculation changes THROUGHPUT, never
tokens.

The default draft source needs no second model: prompt-lookup /
n-gram speculation (vLLM's ``ngram`` speculative method, Saxena 2023).
LLM output constantly re-quotes its own context — retrieved spans,
code identifiers, boilerplate — so the best predictor of the next few
tokens is often "the last time this n-gram appeared, what followed
it?". :class:`NgramProposer` keeps that lookup pure-numpy on the host:
the proposal rides along with the token append the host loop already
does, adding ZERO extra device dispatches (the verify result must
surface on host each round anyway to extend ragged per-slot outputs).

:class:`DraftProposer` is the pluggable seam: a small draft MODEL
(Medusa/EAGLE-class) implements the same two methods and slots into
the engine unchanged.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["DraftProposer", "NgramProposer", "accept_length"]


class DraftProposer:
    """Interface the serving engine / generate() drive.

    ``propose`` receives the sequence's FULL token history (prompt +
    generated, host int32 array) and returns up to ``k`` draft tokens
    (1-D int array, possibly empty). Proposals are free to be wrong —
    the verify dispatch accepts only exact greedy prefixes — but every
    proposed-but-rejected token is wasted verify compute, so a proposer
    should return nothing when it has no signal."""

    def propose(self, tokens: np.ndarray, k: int) -> np.ndarray:
        raise NotImplementedError


class NgramProposer(DraftProposer):
    """Prompt/output n-gram lookup (vLLM-style prompt lookup decoding).

    Finds the MOST RECENT earlier occurrence of the sequence's trailing
    n-gram (longest n first, ``max_ngram`` down to ``min_ngram``) and
    proposes the tokens that followed it. Pure numpy sliding-window
    match — O(history · max_ngram) per call on small ints, microseconds
    at serving lengths."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"({min_ngram}, {max_ngram})")
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)

    def propose(self, tokens: np.ndarray, k: int) -> np.ndarray:
        toks = np.asarray(tokens, np.int32).reshape(-1)
        n_hist = toks.size
        if k <= 0 or n_hist < self.min_ngram + 1:
            return np.zeros((0,), np.int32)
        for n in range(min(self.max_ngram, n_hist - 1), self.min_ngram - 1,
                       -1):
            tail = toks[n_hist - n:]
            # windows[i] == toks[i:i+n]; exclude the tail itself
            windows = np.lib.stride_tricks.sliding_window_view(
                toks[:-1], n)
            hits = np.flatnonzero((windows == tail).all(axis=1))
            if hits.size == 0:
                continue
            start = int(hits[-1]) + n  # most recent occurrence wins
            cont = toks[start:start + k]
            if cont.size:
                return cont.astype(np.int32, copy=True)
        return np.zeros((0,), np.int32)


def accept_length(drafts: np.ndarray, target: np.ndarray) -> int:
    """Greedy accept-prefix length: how many leading ``drafts`` equal
    the verify dispatch's argmax at the same position. (Any draft that
    matches the argmax IS the greedy token — acceptance by equality is
    what makes speculative output byte-identical.)"""
    drafts = np.asarray(drafts).reshape(-1)
    target = np.asarray(target).reshape(-1)[: drafts.size]
    neq = np.flatnonzero(drafts != target)
    return int(neq[0]) if neq.size else int(drafts.size)
