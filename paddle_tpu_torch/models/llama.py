"""Llama-family decoder LM (counterpart of ``paddle_tpu/models/llama.py``).

Module and parameter names mirror the reference (``llama.layers.0.
self_attn.q_proj.weight``, ...), so ``utils/convert.py`` carries its
weights over name for name. Attention goes through
``nn.functional.scaled_dot_product_attention`` (the flash kernels on the
card for qualifying shapes: forward, and backward when a gradient is
taken) or, with a cache, through the paged cache (the paged-decode kernel
on decode steps) or a dense cache. ``loss`` is the training objective of
``bench.py``'s step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..base.amp_state import amp_cast
from ..base.device import get_device
from ..base.dtype import to_torch_dtype
from ..base.random import get_generator
from ..nn import Embedding, Linear, RMSNorm
from ..nn import functional as F

__all__ = ["LlamaConfig", "LlamaAttention", "LlamaMLP", "LlamaDecoderLayer",
           "LlamaModel", "LlamaForCausalLM"]


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False

    @staticmethod
    def tiny(**kw):
        base = dict(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=256,
        )
        base.update(kw)
        return LlamaConfig(**base)


def _rope(q, k, theta: float, position_offset=0):
    """Rotary position embedding on ``[B, S, H, D]`` (half-split layout).
    ``position_offset`` is a scalar or a per-sequence ``[B]`` tensor;
    positions and angles are f32, the rotation runs in q's dtype."""
    q, k = amp_cast("rope", q, k)
    d = q.shape[-1]
    s = q.shape[1]
    dev = q.device
    pos = torch.arange(s, dtype=torch.float32, device=dev)[None, :]
    if isinstance(position_offset, torch.Tensor):
        pos = pos + position_offset.to(dev, torch.float32).reshape(-1, 1)
    elif position_offset:
        pos = pos + float(position_offset)
    inv_freq = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                             device=dev) / d))
    angles = pos[..., None] * inv_freq  # [B|1, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]

    def rot(x):
        x1, x2 = x.chunk(2, dim=-1)
        c = cos.to(x.dtype)
        s_ = sin.to(x.dtype)
        return torch.cat([x1 * c - x2 * s_, x2 * c + x1 * s_], dim=-1)

    return rot(q), rot(k)


def _init_kw(device, dtype, generator):
    return dict(device=device, dtype=dtype, generator=generator)


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, *, device, dtype, generator):
        super().__init__()
        self.config = config
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = config.hidden_size // config.num_attention_heads
        h = config.hidden_size
        kw = _init_kw(device, dtype, generator)
        self.q_proj = Linear(h, self.num_heads * self.head_dim, bias=False, **kw)
        self.k_proj = Linear(h, self.num_kv_heads * self.head_dim, bias=False, **kw)
        self.v_proj = Linear(h, self.num_kv_heads * self.head_dim, bias=False, **kw)
        self.o_proj = Linear(self.num_heads * self.head_dim, h, bias=False, **kw)

    def forward(self, x, cache=None, cur_len=None):
        """``cache``: a :class:`PagedLayerCache` or a dense ``(k_cache,
        v_cache)`` pair ``[B, max_len, Hkv, D]`` with ``cur_len`` valid
        entries; returns ``(out, cache)`` when caching."""
        b, s = x.shape[0], x.shape[1]
        q = self.q_proj(x).reshape(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(x).reshape(b, s, self.num_kv_heads, self.head_dim)
        v = self.v_proj(x).reshape(b, s, self.num_kv_heads, self.head_dim)
        theta = self.config.rope_theta

        if cache is None:
            q, k = _rope(q, k, theta)
            out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                 training=self.training)
            return self.o_proj(out.reshape(b, s, self.num_heads * self.head_dim))

        from ..ops.paged_attention import PagedLayerCache, paged_attention_step

        if isinstance(cache, PagedLayerCache):
            rope_fn = lambda qq, kk, cl: _rope(qq, kk, theta, cl)  # noqa: E731
            if s == 1:
                out, cache = paged_attention_step(q, k, v, cache, cur_len, 1,
                                                  rope_fn=rope_fn)
            else:
                q, kc, vc, mask, cache = paged_attention_step(
                    q, k, v, cache, cur_len, s, rope_fn=rope_fn)
                out = F.scaled_dot_product_attention(
                    q, kc, vc, attn_mask=mask, is_causal=False,
                    training=self.training)
            return self.o_proj(out.reshape(b, s, self.num_heads * self.head_dim)), cache

        from .generation import update_kv_cache

        k_cache, v_cache = cache
        q, k = _rope(q, k, theta, cur_len)
        k_cache, v_cache, mask = update_kv_cache(k, v, k_cache, v_cache, cur_len, s)
        out = F.scaled_dot_product_attention(q, k_cache, v_cache, attn_mask=mask,
                                             is_causal=False, training=self.training)
        out = out.reshape(b, s, self.num_heads * self.head_dim)
        return self.o_proj(out), (k_cache, v_cache)


def _add(a, b):
    a, b = amp_cast("add", a, b)
    return a + b


class LlamaMLP(nn.Module):
    """SwiGLU feed-forward."""

    def __init__(self, config: LlamaConfig, *, device, dtype, generator):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        kw = _init_kw(device, dtype, generator)
        self.gate_proj = Linear(h, i, bias=False, **kw)
        self.up_proj = Linear(h, i, bias=False, **kw)
        self.down_proj = Linear(i, h, bias=False, **kw)

    def forward(self, x):
        gate, up = amp_cast("multiply", F.silu(self.gate_proj(x)),
                            self.up_proj(x))
        return self.down_proj(gate * up)


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, *, device, dtype, generator):
        super().__init__()
        eps = config.rms_norm_eps
        self.input_layernorm = RMSNorm(config.hidden_size, eps, device=device,
                                       dtype=dtype)
        self.self_attn = LlamaAttention(config, device=device, dtype=dtype,
                                        generator=generator)
        self.post_attention_layernorm = RMSNorm(config.hidden_size, eps,
                                                device=device, dtype=dtype)
        self.mlp = LlamaMLP(config, device=device, dtype=dtype,
                            generator=generator)

    def forward(self, x, cache=None, cur_len=None):
        if cache is None:
            attn_out = self.self_attn(self.input_layernorm(x))
        else:
            attn_out, cache = self.self_attn(self.input_layernorm(x),
                                             cache=cache, cur_len=cur_len)
        x = _add(x, attn_out)
        x = _add(x, self.mlp(self.post_attention_layernorm(x)))
        return x if cache is None else (x, cache)


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, *, device, dtype, generator):
        super().__init__()
        self.config = config
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      device=device, dtype=dtype,
                                      generator=generator)
        self.layers = nn.ModuleList([
            LlamaDecoderLayer(config, device=device, dtype=dtype,
                              generator=generator)
            for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps,
                            device=device, dtype=dtype)

    def forward(self, input_ids, caches=None, cur_len=None):
        x = self.embed_tokens(input_ids)
        if caches is None:
            for layer in self.layers:
                x = layer(x)
            return self.norm(x)
        new_caches = []
        for layer, cache in zip(self.layers, caches):
            x, cache = layer(x, cache=cache, cur_len=cur_len)
            new_caches.append(cache)
        return self.norm(x), new_caches


class LlamaForCausalLM(nn.Module):
    """``device=None`` builds on the CUDA card (and raises without one);
    pass ``device="cpu"`` for the CPU. Weights are drawn from ``generator``
    (default: the seeded per-device generator of ``base/random.py``)."""

    def __init__(self, config: LlamaConfig, *, device=None,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = get_device(device)
        dtype = to_torch_dtype(dtype)
        gen = generator if generator is not None else get_generator(dev)
        self.config = config
        self.llama = LlamaModel(config, device=dev, dtype=dtype, generator=gen)
        self.lm_head = (None if config.tie_word_embeddings else
                        Linear(config.hidden_size, config.vocab_size,
                               bias=False, device=dev, dtype=dtype,
                               generator=gen))

    @property
    def device(self) -> torch.device:
        return self.llama.embed_tokens.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.llama.embed_tokens.weight.dtype

    def forward(self, input_ids):
        return self._head(self.llama(input_ids))

    def _head(self, h):
        if self.lm_head is None:
            h, w = amp_cast("tied_lm_head", h, self.llama.embed_tokens.weight)
            return torch.matmul(h, w.t())
        return self.lm_head(h)

    # -- KV-cache generation (see models/generation.py) -----------------
    def init_cache(self, batch: int, max_len: int, dtype=None,
                   block_size: Optional[int] = None, num_blocks=None,
                   tables=None, kv_dtype: Optional[str] = None):
        """Dense caches by default; ``block_size`` gives a paged
        (block-table) cache on the model's device."""
        c = self.config
        dt = to_torch_dtype(dtype) if dtype is not None else self.dtype
        head_dim = c.hidden_size // c.num_attention_heads
        if block_size is not None:
            from ..ops.paged_attention import alloc_paged_kv_caches

            return alloc_paged_kv_caches(
                c.num_hidden_layers, batch, max_len, c.num_key_value_heads,
                head_dim, dt, block_size=block_size, num_blocks=num_blocks,
                tables=tables, kv_dtype=kv_dtype, device=self.device)
        if kv_dtype is not None:
            raise ValueError("kv_dtype quantization requires the paged cache "
                             "(pass block_size)")
        from .generation import alloc_kv_caches

        return alloc_kv_caches(c.num_hidden_layers, batch, max_len,
                               c.num_key_value_heads, head_dim, dt,
                               device=self.device)

    def forward_with_cache(self, input_ids, caches, cur_len):
        h, caches = self.llama(input_ids, caches=caches, cur_len=cur_len)
        return self._head(h), caches

    def loss(self, input_ids, labels):
        """Mean token cross entropy of ``self(input_ids)`` against
        ``labels`` (``F.cross_entropy`` on ``[B*S, V]``)."""
        logits = self(input_ids)
        b, s, v = logits.shape
        return F.cross_entropy(logits.reshape(b * s, v), labels.reshape(b * s))

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def flops_per_token(self, seq_len: int) -> float:
        """~6*N + attention flops per token (train forward + backward)."""
        c = self.config
        return 6 * self.num_params() + 12 * c.num_hidden_layers * c.hidden_size * seq_len
