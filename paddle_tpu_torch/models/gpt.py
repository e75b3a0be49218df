"""GPT family, a decoder-only LM with learned positions (counterpart of
``paddle_tpu/models/gpt.py``; BASELINE.md config #4, GPT-3-13B).

Module and parameter names mirror the reference (``transformer.h.0.attn.
qkv_proj.weight``, ...), so ``utils/convert.py`` carries its weights over
name for name. Pre-LayerNorm blocks with a fused qkv projection and a GELU
MLP; attention goes through ``nn.functional.scaled_dot_product_attention``
(the flash kernels on the card for qualifying shapes) or, with a cache,
through the paged cache (the paged-decode kernels on decode steps, float
or int8 pools) or a dense cache. Every projection carries the reference's
``tp_axis`` (column-parallel qkv and fc1, row-parallel out_proj and fc2,
the vocabulary-parallel embedding); the fused qkv is cut into whole heads
of each of q, k and v (``tp_groups``), and the attention reads its local
head count off its shard.

Under a cache the positions are ``cur_len + arange(s)``; ``cur_len`` is a
scalar or, on the paged cache, one length per sequence (``[B]``), each row
then taking its own positions.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..base.device import get_device
from ..base.dtype import to_torch_dtype
from ..base.random import get_generator
from ..nn import Dropout, Embedding, LayerList, LayerNorm, Linear
from ..nn import functional as F
from .llama import _add, token_loss

__all__ = ["GPTConfig", "GPTAttention", "GPTBlock", "GPTModel",
           "GPTForCausalLM"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 1024
    layer_norm_epsilon: float = 1e-5
    dropout: float = 0.0

    @classmethod
    def tiny(cls, **kw):
        base = dict(vocab_size=512, hidden_size=64, intermediate_size=256,
                    num_hidden_layers=2, num_attention_heads=4,
                    max_position_embeddings=128)
        base.update(kw)
        return cls(**base)

    @classmethod
    def gpt3_13b(cls, **kw):
        base = dict(vocab_size=50304, hidden_size=5120,
                    intermediate_size=20480, num_hidden_layers=40,
                    num_attention_heads=40, max_position_embeddings=2048)
        base.update(kw)
        return cls(**base)


def fuse_qkv_tp_meta(qkv: Linear, head_dim: int) -> None:
    """Tensor-parallel metadata of a fused qkv projection (``[h, 3h]``,
    its columns laid out ``(3, heads, head_dim)``): column parallel, cut
    into whole heads in each of q, k and v (``tp_groups`` 3), so every
    rank keeps the same heads of all three, weight and bias alike."""
    qkv.weight.tp_axis, qkv.weight.tp_unit = 1, head_dim
    for p in (qkv.weight, qkv.bias):
        if p is not None:
            p.tp_groups = 3


class GPTAttention(nn.Module):
    def __init__(self, config: GPTConfig, *, device, dtype, generator):
        super().__init__()
        self.num_heads = config.num_attention_heads
        self.head_dim = config.hidden_size // config.num_attention_heads
        h = config.hidden_size
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.qkv_proj = Linear(h, 3 * h, **kw)
        self.out_proj = Linear(h, h, **kw)
        fuse_qkv_tp_meta(self.qkv_proj, self.head_dim)
        self.out_proj.weight.tp_axis = 0  # row parallel
        self.out_proj.weight.tp_unit = self.head_dim
        self.dropout = config.dropout

    def forward(self, x, cache=None, cur_len=None):
        b, s = x.shape[0], x.shape[1]
        # the local head count, read off the (maybe tensor-parallel) shard
        qkv = self.qkv_proj(x).reshape(b, s, 3, -1, self.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        h = q.shape[2] * self.head_dim
        if cache is None:
            out = F.scaled_dot_product_attention(
                q, k, v, is_causal=True, dropout_p=self.dropout,
                training=self.training)
            return self.out_proj(out.reshape(b, s, h))

        from ..ops.paged_attention import PagedLayerCache, paged_attention_step

        if isinstance(cache, PagedLayerCache):
            if s == 1:
                if self.training and self.dropout > 0:
                    raise ValueError(
                        "the paged KV decode path has no attention-"
                        "probability dropout (the dense cache path does) — "
                        "call model.eval() before paged-cache generation")
                out, cache = paged_attention_step(q, k, v, cache, cur_len, 1)
            else:
                q, kc, vc, mask, cache = paged_attention_step(
                    q, k, v, cache, cur_len, s)
                out = F.scaled_dot_product_attention(
                    q, kc, vc, attn_mask=mask, is_causal=False,
                    dropout_p=self.dropout, training=self.training)
            return self.out_proj(out.reshape(b, s, h)), cache

        from .generation import update_kv_cache

        k_cache, v_cache = cache
        k_cache, v_cache, mask = update_kv_cache(k, v, k_cache, v_cache,
                                                 cur_len, s)
        out = F.scaled_dot_product_attention(
            q, k_cache, v_cache, attn_mask=mask, is_causal=False,
            dropout_p=self.dropout, training=self.training)
        return self.out_proj(out.reshape(b, s, h)), (k_cache, v_cache)


class GPTBlock(nn.Module):
    def __init__(self, config: GPTConfig, *, device, dtype, generator):
        super().__init__()
        h, eps = config.hidden_size, config.layer_norm_epsilon
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.ln_1 = LayerNorm(h, epsilon=eps, device=device, dtype=dtype)
        self.attn = GPTAttention(config, **kw)
        self.ln_2 = LayerNorm(h, epsilon=eps, device=device, dtype=dtype)
        self.fc1 = Linear(h, config.intermediate_size, **kw)
        self.fc2 = Linear(config.intermediate_size, h, **kw)
        self.fc1.weight.tp_axis = 1
        self.fc2.weight.tp_axis = 0
        self.dropout = Dropout(config.dropout)

    def forward(self, x, cache=None, cur_len=None):
        if cache is None:
            x = _add(x, self.attn(self.ln_1(x)))
        else:
            attn_out, cache = self.attn(self.ln_1(x), cache=cache,
                                        cur_len=cur_len)
            x = _add(x, attn_out)
        out = _add(x, self.dropout(self.fc2(F.gelu(self.fc1(self.ln_2(x))))))
        return out if cache is None else (out, cache)


class GPTModel(nn.Module):
    def __init__(self, config: GPTConfig, *, device, dtype, generator):
        super().__init__()
        self.config = config
        h = config.hidden_size
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.wte = Embedding(config.vocab_size, h, **kw)
        self.wte.weight.tp_axis = 0  # vocab parallel
        self.wpe = Embedding(config.max_position_embeddings, h, **kw)
        self.h = LayerList([GPTBlock(config, **kw)
                            for _ in range(config.num_hidden_layers)])
        self.ln_f = LayerNorm(h, epsilon=config.layer_norm_epsilon,
                              device=device, dtype=dtype)
        self.drop = Dropout(config.dropout)

    def forward(self, input_ids, caches=None, cur_len=None):
        s = input_ids.shape[1]
        dev = input_ids.device
        pos = torch.arange(s, device=dev)[None, :]
        if caches is not None:
            cl = torch.as_tensor(cur_len, device=dev).long()
            pos = cl.reshape(-1, 1) + pos  # [1 or B, s]
        x = self.drop(_add(self.wte(input_ids), self.wpe(pos)))
        if caches is None:
            for block in self.h:
                x = block(x)
            return self.ln_f(x)
        new_caches = []
        for block, cache in zip(self.h, caches):
            x, cache = block(x, cache=cache, cur_len=cur_len)
            new_caches.append(cache)
        return self.ln_f(x), new_caches


class GPTForCausalLM(nn.Module):
    """``device=None`` builds on the CUDA card (and raises without one);
    pass ``device="cpu"`` for the CPU. Weights are drawn on the device from
    ``generator`` (default: the seeded per-device generator of
    ``base/random.py``), so a full-size model is never built on the host."""

    def __init__(self, config: GPTConfig, *, device=None,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = get_device(device)
        dtype = to_torch_dtype(dtype)
        gen = generator if generator is not None else get_generator(dev)
        self.config = config
        self.transformer = GPTModel(config, device=dev, dtype=dtype,
                                    generator=gen)
        self.lm_head = Linear(config.hidden_size, config.vocab_size,
                              bias=False, device=dev, dtype=dtype,
                              generator=gen)
        self.lm_head.weight.tp_axis = 1

    @property
    def device(self) -> torch.device:
        return self.transformer.wte.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.transformer.wte.weight.dtype

    def forward(self, input_ids):
        return self.lm_head(self.transformer(input_ids))

    def init_cache(self, batch: int, max_len: int, dtype=None,
                   block_size: Optional[int] = None, num_blocks=None,
                   tables=None, kv_dtype: Optional[str] = None):
        """Dense caches by default; ``block_size`` gives a paged
        (block-table) cache on the model's device, with int8 pools for
        ``kv_dtype="int8"``."""
        c = self.config
        dt = to_torch_dtype(dtype) if dtype is not None else self.dtype
        head_dim = c.hidden_size // c.num_attention_heads
        if block_size is not None:
            from ..ops.paged_attention import alloc_paged_kv_caches

            return alloc_paged_kv_caches(
                c.num_hidden_layers, batch, max_len, c.num_attention_heads,
                head_dim, dt, block_size=block_size, num_blocks=num_blocks,
                tables=tables, kv_dtype=kv_dtype, device=self.device)
        if kv_dtype is not None:
            raise ValueError("kv_dtype quantization requires the paged cache "
                             "(pass block_size)")
        from .generation import alloc_kv_caches

        return alloc_kv_caches(c.num_hidden_layers, batch, max_len,
                               c.num_attention_heads, head_dim, dt,
                               device=self.device)

    def forward_with_cache(self, input_ids, caches, cur_len):
        h, caches = self.transformer(input_ids, caches=caches,
                                     cur_len=cur_len)
        return self.lm_head(h), caches

    def loss(self, input_ids, labels):
        """Mean token cross entropy of ``self(input_ids)`` against
        ``labels``; through ``ParallelCrossEntropy`` where ``fleet``'s
        ``TensorParallel`` left the logits sharded on the vocabulary."""
        return token_loss(self(input_ids), labels, self.lm_head)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def flops_per_token(self, seq_len: int) -> float:
        c = self.config
        return (6 * self.num_params()
                + 12 * c.num_hidden_layers * c.hidden_size * seq_len)
