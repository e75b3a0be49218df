"""BERT family, a bidirectional encoder with MLM and classification heads
(counterpart of ``paddle_tpu/models/bert.py``; BASELINE.md config #2).

Post-LayerNorm encoder layers with a fused qkv projection. Attention is
non-causal ``nn.functional.scaled_dot_product_attention``: the flash
kernels on the card where no mask is given and the shape qualifies; an
``attention_mask`` (``[B, S]``, 1 = keep) becomes the reference's additive
``[B, 1, 1, S]`` mask (``-1e9`` on padding, in f32), which takes the plain
path, as in the reference. Parameter names mirror the reference's, so
``utils/convert.py`` carries its weights over name for name.
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
from .gpt import fuse_qkv_tp_meta
from .llama import _add, token_loss

__all__ = ["BertConfig", "BertModel", "BertForMaskedLM",
           "BertForSequenceClassification"]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dropout: float = 0.0

    @classmethod
    def tiny(cls, **kw):
        base = dict(vocab_size=512, hidden_size=64, intermediate_size=256,
                    num_hidden_layers=2, num_attention_heads=4,
                    max_position_embeddings=128)
        base.update(kw)
        return cls(**base)

    @classmethod
    def base(cls, **kw):
        return cls(**kw)


class BertEmbeddings(nn.Module):
    def __init__(self, config: BertConfig, *, device, dtype, generator):
        super().__init__()
        h = config.hidden_size
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.word_embeddings = Embedding(config.vocab_size, h, **kw)
        self.word_embeddings.weight.tp_axis = 0
        self.position_embeddings = Embedding(config.max_position_embeddings,
                                             h, **kw)
        self.token_type_embeddings = Embedding(config.type_vocab_size, h,
                                               **kw)
        self.layer_norm = LayerNorm(h, epsilon=config.layer_norm_eps,
                                    device=device, dtype=dtype)
        self.dropout = Dropout(config.dropout)

    def forward(self, input_ids, token_type_ids=None):
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)[None, :]
        x = _add(self.word_embeddings(input_ids),
                 self.position_embeddings(pos))
        if token_type_ids is not None:
            x = _add(x, self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(x))


class BertLayer(nn.Module):
    def __init__(self, config: BertConfig, *, device, dtype, generator):
        super().__init__()
        h, eps = config.hidden_size, config.layer_norm_eps
        self.num_heads = config.num_attention_heads
        self.head_dim = h // config.num_attention_heads
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.qkv = Linear(h, 3 * h, **kw)
        fuse_qkv_tp_meta(self.qkv, self.head_dim)
        self.attn_out = Linear(h, h, **kw)
        self.attn_out.weight.tp_axis = 0
        self.attn_out.weight.tp_unit = self.head_dim
        self.attn_norm = LayerNorm(h, epsilon=eps, device=device, dtype=dtype)
        self.fc1 = Linear(h, config.intermediate_size, **kw)
        self.fc1.weight.tp_axis = 1
        self.fc2 = Linear(config.intermediate_size, h, **kw)
        self.fc2.weight.tp_axis = 0
        self.ffn_norm = LayerNorm(h, epsilon=eps, device=device, dtype=dtype)
        self.dropout = Dropout(config.dropout)

    def forward(self, x, attn_mask=None):
        b, s = x.shape[0], x.shape[1]
        # the local head count, read off the (maybe tensor-parallel) shard
        qkv = self.qkv(x).reshape(b, s, 3, -1, self.head_dim)
        out = F.scaled_dot_product_attention(
            qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], attn_mask=attn_mask,
            is_causal=False, training=self.training)
        x = self.attn_norm(_add(x, self.dropout(
            self.attn_out(out.reshape(b, s, -1)))))
        ffn = self.fc2(F.gelu(self.fc1(x)))
        return self.ffn_norm(_add(x, self.dropout(ffn)))


def additive_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """``[B, S]`` 1 (keep) / 0 (pad) -> the additive f32 ``[B, 1, 1, S]``
    mask, ``-1e9`` on padding (broadcast over heads and queries)."""
    return (1.0 - attention_mask.float())[:, None, None, :] * -1e9


class BertModel(nn.Module):
    """``device=None`` builds on the CUDA card; ``device="cpu"`` on the
    CPU. Weights are drawn from ``generator`` (default: the seeded
    per-device generator)."""

    def __init__(self, config: BertConfig, *, device=None,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev, dtype, gen = _resolve(device, dtype, generator)
        kw = dict(device=dev, dtype=dtype, generator=gen)
        self.config = config
        self.embeddings = BertEmbeddings(config, **kw)
        self.encoder = LayerList([BertLayer(config, **kw)
                                  for _ in range(config.num_hidden_layers)])
        self.pooler = Linear(config.hidden_size, config.hidden_size, **kw)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        x = self.embeddings(input_ids, token_type_ids)
        mask = None if attention_mask is None else additive_mask(
            attention_mask)
        for layer in self.encoder:
            x = layer(x, mask)
        pooled = F.tanh(self.pooler(x[:, 0]))
        return x, pooled


def _resolve(device, dtype, generator):
    dev = get_device(device)
    return (dev, to_torch_dtype(dtype),
            generator if generator is not None else get_generator(dev))


class BertForMaskedLM(nn.Module):
    def __init__(self, config: BertConfig, *, device=None,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev, dtype, gen = _resolve(device, dtype, generator)
        kw = dict(device=dev, dtype=dtype, generator=gen)
        h = config.hidden_size
        self.config = config
        self.bert = BertModel(config, **kw)
        self.transform = Linear(h, h, **kw)
        self.transform_norm = LayerNorm(h, epsilon=config.layer_norm_eps,
                                        device=dev, dtype=dtype)
        self.decoder = Linear(h, config.vocab_size, **kw)
        self.decoder.weight.tp_axis = 1

    @property
    def device(self) -> torch.device:
        return self.decoder.weight.device

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        x, _ = self.bert(input_ids, token_type_ids, attention_mask)
        x = self.transform_norm(F.gelu(self.transform(x)))
        return self.decoder(x)

    def loss(self, input_ids, labels, attention_mask=None,
             token_type_ids=None):
        """The MLM objective: mean cross entropy over the positions whose
        label is not ``-100`` (the masked tokens); through
        ``ParallelCrossEntropy`` where ``fleet``'s ``TensorParallel`` left
        the logits sharded on the vocabulary."""
        return token_loss(self(input_ids, token_type_ids, attention_mask),
                          labels, self.decoder)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())


class BertForSequenceClassification(nn.Module):
    def __init__(self, config: BertConfig, num_classes: int = 2, *,
                 device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev, dtype, gen = _resolve(device, dtype, generator)
        kw = dict(device=dev, dtype=dtype, generator=gen)
        self.bert = BertModel(config, **kw)
        self.classifier = Linear(config.hidden_size, num_classes, **kw)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        return self.classifier(pooled)
