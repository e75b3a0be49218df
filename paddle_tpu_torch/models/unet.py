"""Stable-Diffusion-style conditional UNet (counterpart of
``paddle_tpu/models/unet.py``; BASELINE.md config #5).

NCHW convolutions (``nn.Conv2D``), ``GroupNorm``, SiLU, and spatial
transformers whose self- and cross-attention run on ``[B, HW, heads,
head_dim]`` through ``nn.functional.scaled_dot_product_attention``: on the
card the flash kernels take every attention whose query length is a
multiple of 128 (the key length may be anything, as in the reference:
cross-attention over the 77-token context), the rest the plain path. The
sinusoidal timestep embedding is computed in f32 and then cast to the
parameters' dtype. Parameter names mirror the reference's (``down_attn``
and ``up_attn`` hold ``None`` where a block has no transformer, as there).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from ..base.device import get_device
from ..base.dtype import to_torch_dtype
from ..base.random import get_generator
from ..nn import (Conv2D, GroupNorm, LayerList, LayerNorm, Linear, Sequential,
                  Silu)
from ..nn import functional as F
from .llama import _add

__all__ = ["UNetConfig", "timestep_embedding", "UNet2DConditionModel"]


@dataclass
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    attention_head_dim: int = 64
    cross_attention_dim: int = 768
    norm_num_groups: int = 32
    attn_resolutions: Tuple[int, ...] = (1, 2, 3)  # block indices with attn

    @classmethod
    def tiny(cls, **kw):
        base = dict(in_channels=4, out_channels=4, block_out_channels=(32, 64),
                    layers_per_block=1, attention_head_dim=16,
                    cross_attention_dim=32, norm_num_groups=8,
                    attn_resolutions=(1,))
        base.update(kw)
        return cls(**base)


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """The SD sinusoid, ``[cos(t f), sin(t f)]`` with ``f = exp(-log(
    max_period) * i / half)``, in f32 (``[B, 2 * (dim // 2)]``)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class ResBlock(nn.Module):
    def __init__(self, in_c, out_c, temb_c, groups, *, device, dtype,
                 generator):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        gkw = dict(kw, generator=generator)
        self.norm1 = GroupNorm(min(groups, in_c), in_c, **kw)
        self.conv1 = Conv2D(in_c, out_c, 3, padding=1, **gkw)
        self.temb_proj = Linear(temb_c, out_c, **gkw)
        self.norm2 = GroupNorm(min(groups, out_c), out_c, **kw)
        self.conv2 = Conv2D(out_c, out_c, 3, padding=1, **gkw)
        self.skip = Conv2D(in_c, out_c, 1, **gkw) if in_c != out_c else None

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = _add(h, self.temb_proj(F.silu(temb)).reshape(x.shape[0], -1, 1, 1))
        h = self.conv2(F.silu(self.norm2(h)))
        return _add(h, self.skip(x) if self.skip is not None else x)


class SpatialTransformer(nn.Module):
    """Self-attention, cross-attention and a GELU FFN on the flattened HW
    tokens."""

    def __init__(self, channels, head_dim, context_dim, groups, *, device,
                 dtype, generator):
        super().__init__()
        self.num_heads = max(1, channels // head_dim)
        self.head_dim = channels // self.num_heads
        c = channels
        kw = dict(device=device, dtype=dtype)
        gkw = dict(kw, generator=generator)
        self.norm = GroupNorm(min(groups, c), c, **kw)
        self.proj_in = Linear(c, c, **gkw)
        self.norm1 = LayerNorm(c, **kw)
        self.to_qkv = Linear(c, 3 * c, bias=False, **gkw)
        self.to_out1 = Linear(c, c, **gkw)
        self.norm2 = LayerNorm(c, **kw)
        self.to_q2 = Linear(c, c, bias=False, **gkw)
        self.to_kv2 = Linear(context_dim, 2 * c, bias=False, **gkw)
        self.to_out2 = Linear(c, c, **gkw)
        self.norm3 = LayerNorm(c, **kw)
        self.ff1 = Linear(c, 4 * c, **gkw)
        self.ff2 = Linear(4 * c, c, **gkw)
        self.proj_out = Linear(c, c, **gkw)

    def _attn(self, q, k, v):
        b, sq = q.shape[0], q.shape[1]
        sk = k.shape[1]
        q = q.reshape(b, sq, self.num_heads, self.head_dim)
        k = k.reshape(b, sk, self.num_heads, self.head_dim)
        v = v.reshape(b, sk, self.num_heads, self.head_dim)
        out = F.scaled_dot_product_attention(q, k, v, is_causal=False,
                                             training=self.training)
        return out.reshape(b, sq, self.num_heads * self.head_dim)

    def forward(self, x, context):
        b, c, h, w = x.shape
        t = self.norm(x).reshape(b, c, h * w).transpose(1, 2)  # [B, HW, C]
        t = self.proj_in(t)
        q, k, v = torch.chunk(self.to_qkv(self.norm1(t)), 3, dim=-1)
        t = _add(t, self.to_out1(self._attn(q, k, v)))
        k2, v2 = torch.chunk(self.to_kv2(context), 2, dim=-1)
        t = _add(t, self.to_out2(self._attn(self.to_q2(self.norm2(t)), k2,
                                            v2)))
        t = _add(t, self.ff2(F.gelu(self.ff1(self.norm3(t)))))
        t = self.proj_out(t).transpose(1, 2)
        return _add(t.reshape(b, c, h, w), x)


class UNet2DConditionModel(nn.Module):
    """Down blocks, a middle (res, attention, res) and up blocks with
    skips. ``device=None`` builds on the CUDA card; ``device="cpu"`` on
    the CPU. Weights are drawn from ``generator`` (default: the seeded
    per-device generator)."""

    def __init__(self, config: Optional[UNetConfig] = None, *, device=None,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__()
        if config is not None and kwargs:
            raise ValueError(
                "pass either a UNetConfig or field kwargs, not both "
                f"(got config and {sorted(kwargs)})")
        config = config or UNetConfig(**kwargs)
        self.config = config
        dev = get_device(device)
        dtype = to_torch_dtype(dtype)
        gen = generator if generator is not None else get_generator(dev)
        kw = dict(device=dev, dtype=dtype, generator=gen)
        chs = config.block_out_channels
        temb_c = chs[0] * 4
        g = config.norm_num_groups

        def transformer(c):
            return SpatialTransformer(c, config.attention_head_dim,
                                      config.cross_attention_dim, g, **kw)

        self.time_embed = Sequential(Linear(chs[0], temb_c, **kw), Silu(),
                                     Linear(temb_c, temb_c, **kw))
        self.conv_in = Conv2D(config.in_channels, chs[0], 3, padding=1, **kw)

        self.down_res = LayerList()
        self.down_attn = LayerList()
        self.downsamplers = LayerList()
        skip_chs = [chs[0]]
        in_c = chs[0]
        for i, out_c in enumerate(chs):
            for _ in range(config.layers_per_block):
                self.down_res.append(ResBlock(in_c, out_c, temb_c, g, **kw))
                self.down_attn.append(transformer(out_c)
                                      if i in config.attn_resolutions
                                      else None)
                in_c = out_c
                skip_chs.append(out_c)
            if i < len(chs) - 1:
                self.downsamplers.append(Conv2D(out_c, out_c, 3, stride=2,
                                                padding=1, **kw))
                skip_chs.append(out_c)

        self.mid_res1 = ResBlock(in_c, in_c, temb_c, g, **kw)
        self.mid_attn = transformer(in_c)
        self.mid_res2 = ResBlock(in_c, in_c, temb_c, g, **kw)

        self.up_res = LayerList()
        self.up_attn = LayerList()
        self.upsamplers = LayerList()
        for i, out_c in reversed(list(enumerate(chs))):
            for _ in range(config.layers_per_block + 1):
                skip = skip_chs.pop()
                self.up_res.append(ResBlock(in_c + skip, out_c, temb_c, g,
                                            **kw))
                self.up_attn.append(transformer(out_c)
                                    if i in config.attn_resolutions else None)
                in_c = out_c
            if i > 0:
                self.upsamplers.append(Conv2D(out_c, out_c, 3, padding=1,
                                              **kw))

        self.norm_out = GroupNorm(min(g, chs[0]), chs[0], device=dev,
                                  dtype=dtype)
        self.conv_out = Conv2D(chs[0], config.out_channels, 3, padding=1,
                               **kw)

    @property
    def device(self) -> torch.device:
        return self.conv_in.weight.device

    def forward(self, sample, timestep, encoder_hidden_states):
        """sample ``[B, C, H, W]``; timestep ``[B]``; context ``[B, L,
        D]``."""
        config = self.config
        emb = timestep_embedding(timestep, config.block_out_channels[0])
        temb = self.time_embed(emb.to(self.conv_in.weight.dtype))

        x = self.conv_in(sample)
        skips = [x]
        li = 0
        n_down = len(config.block_out_channels)
        for i in range(n_down):
            for _ in range(config.layers_per_block):
                x = self.down_res[li](x, temb)
                if self.down_attn[li] is not None:
                    x = self.down_attn[li](x, encoder_hidden_states)
                skips.append(x)
                li += 1
            if i < n_down - 1:
                x = self.downsamplers[i](x)
                skips.append(x)

        x = self.mid_res1(x, temb)
        x = self.mid_attn(x, encoder_hidden_states)
        x = self.mid_res2(x, temb)

        li = 0
        for j, i in enumerate(reversed(range(n_down))):
            for _ in range(config.layers_per_block + 1):
                x = torch.cat([x, skips.pop()], dim=1)
                x = self.up_res[li](x, temb)
                if self.up_attn[li] is not None:
                    x = self.up_attn[li](x, encoder_hidden_states)
                li += 1
            if i > 0:
                x = F.interpolate(x, scale_factor=2, mode="nearest")
                x = self.upsamplers[j](x)

        return self.conv_out(F.silu(self.norm_out(x)))

    def loss(self, sample, timestep, encoder_hidden_states, target):
        """The denoising objective: mean squared error of the predicted
        noise against ``target``, in f32."""
        pred = self(sample, timestep, encoder_hidden_states)
        return (pred.float() - target.float()).square().mean()

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())
