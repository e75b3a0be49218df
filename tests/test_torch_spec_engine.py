"""Port parity: the port's ``ContinuousBatchingEngine(spec_decode_k=...)``
against the JAX package's engine with the same keywords, on
``LlamaConfig.tiny()`` with carried weights (the cases of
``tests/test_spec_decode.py``'s engine tests).

Token streams and every ``spec_stats()`` field must agree exactly, and the
speculative streams must equal the port's plain engine's (f32 on the CPU;
the logits agree to ~1e-6, far inside any argmax margin of these prompts).
"""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.inference.speculative import DraftProposer
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.utils import load_jax_params

_RNG = np.random.RandomState(7)
_BASE = _RNG.randint(0, 50, (6,))
_PROMPTS = {
    "rep": np.concatenate([_BASE, _BASE, _BASE])[:16],
    "rand": _RNG.randint(0, 250, (11,)),
    "rep2": np.concatenate([_BASE, _BASE])[:10],
}
_BUDGETS = {"rep": 10, "rand": 7, "rep2": 12}
_BASE_KW = dict(max_batch=3, max_len=64, block_size=8, num_blocks=24,
                prompt_pad=32)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JLlama(JConfig.tiny())
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    load_jax_params(tm, {n: np.asarray(p._data)
                         for n, p in jm.named_parameters()})
    return jm, tm


def _serve(engine_cls, model, prompts=None, budgets=None, **kw):
    eng = engine_cls(model, **{**_BASE_KW, **kw})
    for rid, p in (prompts or _PROMPTS).items():
        eng.add_request(rid, p, max_new_tokens=(budgets or _BUDGETS)[rid])
    done = eng.run()
    return {r: list(map(int, done[r].out)) for r in done}, eng


def _both(models, **kw):
    """The reference engine and the port's over the same workload; tokens
    and spec_stats() must agree exactly. Returns (tokens, port engine)."""
    jm, tm = models
    want, jeng = _serve(JEngine, jm, **kw)
    got, eng = _serve(ContinuousBatchingEngine, tm, **kw)
    assert got == want
    assert eng.spec_stats() == jeng.spec_stats()
    assert eng.max_step_tokens == jeng.max_step_tokens
    return got, eng


class _Oracle(DraftProposer):
    """Proposes each request's true greedy continuation: every draft is
    accepted, so the multi-token paths and the stats run."""

    def __init__(self, table):
        self.table = {tuple(int(t) for t in k): list(v)
                      for k, v in table.items()}

    def propose(self, tokens, k):
        toks = [int(t) for t in np.asarray(tokens).reshape(-1)]
        for prompt, ref in self.table.items():
            n = len(prompt)
            if toks[:n] == list(prompt):
                done = len(toks) - n
                return np.asarray(ref[done:done + k], np.int32)
        return np.zeros((0,), np.int32)


@pytest.fixture(scope="module")
def plain(models):
    return _serve(ContinuousBatchingEngine, models[1])[0]


@pytest.mark.parametrize("kw", [dict(spec_decode_k=2),
                                dict(spec_decode_k=4, kv_dtype="int8"),
                                dict(spec_decode_k=3, decode_chunk=4)],
                         ids=["whole_k2", "int8_k4", "with_chunk"])
def test_spec_engine_matches_reference(models, plain, kw):
    got, eng = _both(models, **kw)
    if "kv_dtype" not in kw:
        assert got == plain
    assert eng.spec_stats()["enabled"] and eng.spec_stats()["dispatches"] > 0


def test_chunked_prefill_and_prefix_cache(models):
    """Cache-hit slots decode speculatively on adopted blocks: two waves,
    the second admitted after the first's blocks are cached."""
    jm, tm = models

    def run(cls, model, spec_k):
        eng = cls(model, max_batch=2, max_len=64, block_size=8,
                  num_blocks=24, prefill_chunk=8, max_num_batched_tokens=32,
                  prefix_cache=True, spec_decode_k=spec_k)
        eng.add_request("rep", _PROMPTS["rep"], max_new_tokens=8)
        eng.add_request("rand", _PROMPTS["rand"], max_new_tokens=6)
        eng.run()
        eng.add_request("hit", _PROMPTS["rep"].copy(), max_new_tokens=8)
        eng.add_request("hit2", _PROMPTS["rep2"].copy(), max_new_tokens=6)
        done = eng.run()
        return {r: list(map(int, done[r].out)) for r in done}, eng

    want, jeng = run(JEngine, jm, 4)
    got, eng = run(ContinuousBatchingEngine, tm, 4)
    plain, _ = run(ContinuousBatchingEngine, tm, None)
    assert got == want == plain
    assert got["hit"] == got["rep"]
    assert eng.spec_stats() == jeng.spec_stats()
    assert eng.prefix_stats() == jeng.prefix_stats()
    assert eng.prefix_stats()["hit_tokens"] > 0
    assert eng.manager.accounting() == jeng.manager.accounting()


def test_oracle_full_accept_and_eos_inside_accepted_prefix(models, plain):
    oracle = _Oracle({tuple(_PROMPTS[r]): plain[r] for r in plain})
    got, eng = _both(models, spec_decode_k=4, draft_proposer=oracle)
    st = eng.spec_stats()
    assert got == plain and st["acceptance_rate"] == 1.0
    assert st["dispatches"] * (4 + 1) < sum(_BUDGETS.values())
    eos = plain["rep"][4]
    ref, _ = _serve(ContinuousBatchingEngine, models[1], eos_token_id=eos)
    got, _ = _both(models, spec_decode_k=4, draft_proposer=oracle,
                   eos_token_id=eos)
    assert got == ref and got["rep"] == plain["rep"][:5]


def test_budget_fallbacks(models):
    # k+1 = 9 > budget 8: no verify round ever fits, every step decodes
    one = {"rep": _PROMPTS["rep"]}
    got, eng = _both(models, prompts=one, budgets={"rep": 8}, max_batch=1,
                     num_blocks=16, prefill_chunk=8, max_num_batched_tokens=8,
                     spec_decode_k=8)
    assert eng.spec_stats()["dispatches"] == 0
    # a verify round runs when the leftover budget covers it
    got, eng = _both(models, prefill_chunk=8, max_num_batched_tokens=16,
                     spec_decode_k=4)
    assert eng.max_step_tokens <= 16
    assert eng.spec_stats()["dispatches"] > 0


def test_budget_charges_verify_positions_not_emitted_tokens(models, plain):
    """An always-wrong proposer drains one token a round: the budget is
    charged k+1 positions a slot, the service-rate EWMA sees 1."""
    ref = plain["rep"]
    n_prompt = len(_PROMPTS["rep"])

    class Anti(DraftProposer):
        def propose(self, tokens, k):
            g = len(tokens) - n_prompt
            nxt = ref[g] if 0 <= g < len(ref) else 0
            return np.full((k,), (int(nxt) + 1) % 256, np.int32)

    jm, tm = models
    kw = dict(prefill_chunk=8, max_num_batched_tokens=32, spec_decode_k=4,
              draft_proposer=Anti())
    one = {"rep": _PROMPTS["rep"]}
    want, jeng = _serve(JEngine, jm, one, {"rep": 10}, **kw)
    got, eng = _serve(ContinuousBatchingEngine, tm, one, {"rep": 10}, **kw)
    assert got == want and got["rep"] == ref
    assert eng.spec_stats() == jeng.spec_stats()
    st = eng.spec_stats()
    assert st["dispatches"] > 0 and st["accepted"] == 0
    assert eng.max_step_tokens == jeng.max_step_tokens >= 5
    assert eng.ewma_step_tokens == pytest.approx(jeng.ewma_step_tokens)
    assert eng.ewma_step_tokens < 3


def test_verify_yields_budget_to_mid_prefill_slot(models, plain):
    """Under a tight budget a verify round (1 * (k+1) = 5 = the budget)
    would fit every step; it must yield while a slot is mid-prefill."""
    jm, tm = models

    def build(cls, model, spec_k, proposer=None):
        eng = cls(model, max_batch=2, max_len=64, block_size=8,
                  num_blocks=24, prefill_chunk=4, max_num_batched_tokens=5,
                  spec_decode_k=spec_k, draft_proposer=proposer)
        eng.add_request("a", _PROMPTS["rep"], max_new_tokens=48)
        while eng.num_prefilling or not any(s.active for s in eng._slots):
            eng.step()
        eng.add_request("b", _PROMPTS["rand"], max_new_tokens=4)
        return eng

    ref = {r: list(map(int, g.out))
           for r, g in build(ContinuousBatchingEngine, tm, None).run().items()}
    oracle = _Oracle({tuple(_PROMPTS["rep"]): ref["a"]})
    outs, steps = [], []
    for cls, model in ((JEngine, jm), (ContinuousBatchingEngine, tm)):
        eng = build(cls, model, 4, oracle)
        n = 0
        while "b" not in eng._completed:
            eng.step()
            n += 1
            assert n < 12, "mid-prefill slot starved by verify rounds"
        steps.append(n)
        outs.append({r: list(map(int, g.out)) for r, g in eng.run().items()})
        outs.append(eng.spec_stats())
    assert outs[0] == outs[2] == ref and outs[1] == outs[3]
    assert steps[0] == steps[1]


def test_spec_engine_validation(models):
    _, tm = models
    with pytest.raises(ValueError, match="spec_decode_k"):
        ContinuousBatchingEngine(tm, max_batch=1, max_len=32, block_size=8,
                                 num_blocks=8, spec_decode_k=0)
    eng = ContinuousBatchingEngine(tm, max_batch=1, max_len=32, block_size=8,
                                   num_blocks=8)
    assert eng.spec_stats() == {
        "enabled": False, "k": None, "proposed": 0, "accepted": 0,
        "acceptance_rate": 0.0, "dispatches": 0, "emitted": 0,
        "tokens_per_slot_round": 0.0}
