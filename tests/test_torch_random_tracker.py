"""The port's rank-aware RNG (``paddle_tpu_torch/base/random.py``) against
the reference's (``paddle_tpu/base/random.py``).

JAX's threefry and torch's Philox streams never match, so no stream is
compared across packages. Held instead: the tracker's invariants, across
two gloo ranks in processes (``model_parallel_random_seed(seed, rank)``:
the global branch and the stochastic-rounding salts equal on both ranks,
the local branch different); the branches' seeds equal the reference's
(the global seed, ``seed + 2718 + rank``, and a never-added branch's
``default seed + crc32(name)``); ``get_rng_state``/``set_rng_state`` and
the encoded form round-trip; ``seed`` drops the branches.
"""
import pickle

import numpy as np
import pytest
import torch

from paddle_tpu.base import random as jrandom
from paddle_tpu_torch import seed as pt_seed
from paddle_tpu_torch.base import random as trandom

import torch_dist_ranks as R


@pytest.fixture(autouse=True)
def _fresh_state():
    yield
    pt_seed(0)
    jrandom.seed(0)


def test_global_branch_equal_across_ranks_local_branch_not(tmp_path):
    a, b = R.run_ranks(R.rng_body, 2, tmp_path, args=(11,))
    g, loc = trandom.RNGStatesTracker.GLOBAL, trandom.RNGStatesTracker.LOCAL
    np.testing.assert_array_equal(a[g], b[g])
    assert not np.array_equal(a[loc], b[loc])
    # the salts follow the global branch: equal on both ranks
    np.testing.assert_array_equal(a["salts"], b["salts"])
    np.testing.assert_array_equal(a["default"], b["default"])


def test_branch_seeds_equal_the_references():
    for rank in (0, 1, 3):
        trandom.model_parallel_random_seed(1234, tp_rank=rank)
        jrandom.model_parallel_random_seed(1234, tp_rank=rank)
        tt, jt = trandom.get_rng_state_tracker(), jrandom.get_rng_state_tracker()
        for name in (tt.GLOBAL, tt.LOCAL):
            assert (tt._states[name].initial_seed()
                    == jt._states[name].initial_seed())
    pt_seed(77)
    jrandom.seed(77)
    tt, jt = trandom.get_rng_state_tracker(), jrandom.get_rng_state_tracker()
    assert not tt.exists("dropout") and not jt.exists("dropout")
    with tt.rng_state("dropout"), jt.rng_state("dropout"):
        assert (trandom.default_generator().initial_seed()
                == jrandom.default_generator().initial_seed())
    with pytest.raises(ValueError, match="already exists"):
        tt.add("dropout", 1)


def test_salts_follow_the_global_branch_in_place():
    pt_seed(5)
    gen = trandom.sr_generator("cpu")  # created from the process seed
    first = trandom.sr_salts("cpu", 3)
    trandom.model_parallel_random_seed(5, tp_rank=0)
    a = trandom.sr_salts("cpu", 3)
    trandom.model_parallel_random_seed(5, tp_rank=1)
    b = trandom.sr_salts("cpu", 3)
    assert trandom.sr_generator("cpu") is gen  # re-seeded in place
    assert torch.equal(a, b) and torch.equal(a, first)
    trandom.model_parallel_random_seed(6, tp_rank=0)
    assert not torch.equal(trandom.sr_salts("cpu", 3), a)


def test_rng_state_round_trips():
    pt_seed(3)
    trandom.model_parallel_random_seed(3, tp_rank=1)
    tracker = trandom.get_rng_state_tracker()
    gen = trandom.get_generator("cpu")
    torch.rand(5, generator=gen)
    trandom.sr_salts("cpu")
    state = trandom.get_rng_state()
    want = (torch.rand(5, generator=gen), trandom.sr_salts("cpu"))
    with tracker.rng_state(tracker.LOCAL):
        want_local = torch.rand(5, generator=trandom.get_generator("cpu"))
    for restore in (trandom.set_rng_state,
                    lambda s: trandom.restore_rng_state(pickle.loads(
                        pickle.dumps(trandom.encode_rng_state(s))))):
        restore(state)
        got = (torch.rand(5, generator=gen), trandom.sr_salts("cpu"))
        with tracker.rng_state(tracker.LOCAL):
            got_local = torch.rand(5, generator=trandom.get_generator("cpu"))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.equal(got_local, want_local)
    enc = trandom.serializable_rng_state()
    again = trandom.encode_rng_state(enc)  # encoding is idempotent
    assert pickle.dumps(again) == pickle.dumps(enc)
    assert isinstance(trandom.next_key(), int)
    assert trandom.next_key() != trandom.next_key()


def test_the_eleven_names_are_public():
    names = ["Generator", "default_generator", "get_rng_state",
             "set_rng_state", "next_key", "encode_rng_state",
             "serializable_rng_state", "restore_rng_state",
             "RNGStatesTracker", "get_rng_state_tracker",
             "model_parallel_random_seed"]
    for n in names:
        assert hasattr(jrandom, n) and n in trandom.__all__, n
