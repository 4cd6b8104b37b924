"""Stable-Diffusion UNet (port of ``paddle_tpu/models/unet.py``; BASELINE
config #5), the denoise step's forward.

Same classes, attribute names and layouts as the reference (NCHW, Conv2D
kernels (out, in, kh, kw), Linear weights (in, out)), so the state keys and
shapes are the JAX ``state_dict(include_buffers=False)``'s. The convolutions
are ``torch.nn.functional.conv2d`` (cuDNN on the card), the projections
``torch.matmul``, GroupNorm ``torch.nn.functional.group_norm``: the
reference leaves all of them to XLA, outside any Pallas kernel. Every
attention call (self-attention over the pixels and cross-attention to the
77-token text context) goes through ``F.scaled_dot_product_attention``: on
the card the hand-written K1, at SD-1.5's head dims 40 / 80 / 160 read in
place on its kernel widths 64 / 128 / 256, the columns past d TMA's zero
fill (``ops.flash_attention.kernel_width``): no pad, no slice.

Weight init follows the reference's defaults: Conv2D ``KaimingUniform``,
Linear ``XavierNormal``, norms weight 1 and bias 0. ``ddpm_loss`` is the
reference's training objective (ε-prediction MSE); its gradient runs every
attention backward on K3/K4 on the card (head dim 160 on their width-256
kernels, at its own width).
"""

import dataclasses
import math
from typing import Optional, Tuple

import torch

from paddle_tpu_torch import nn
from paddle_tpu_torch.models.llama import model_generator
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as init


@dataclasses.dataclass
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attention_levels: Tuple[int, ...] = (0, 1, 2)   # levels with transformers
    num_heads: int = 8
    context_dim: Optional[int] = 768                 # None → self-attn only
    groups: int = 32

    @classmethod
    def sd15(cls):
        return cls()

    @classmethod
    def tiny(cls):
        return cls(in_channels=4, out_channels=4, model_channels=32,
                   channel_mult=(1, 2), num_res_blocks=1,
                   attention_levels=(1,), num_heads=4, context_dim=16,
                   groups=8)


def timestep_embedding(t, dim, max_period=10000.0):
    """Sinusoidal embeddings (b,) → (b, dim) in fp32: cos, then sin."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.to(torch.float32)[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb


def _linear(fan_in, fan_out, kw, bias=True):
    """A Linear with the reference's default init (XavierNormal)."""
    return nn.Linear(fan_in, fan_out, weight_attr=init.XavierNormal(),
                     bias_attr=None if bias else False, **kw)


def _norm_kw(kw):
    return dict(dtype=kw["dtype"], device=kw["device"])


class ResBlock(nn.Layer):
    def __init__(self, in_ch, out_ch, temb_ch, groups, **kw):
        super().__init__()
        self.norm1 = nn.GroupNorm(min(groups, in_ch), in_ch, **_norm_kw(kw))
        self.conv1 = nn.Conv2D(in_ch, out_ch, 3, padding=1, **kw)
        self.temb_proj = _linear(temb_ch, out_ch, kw)
        self.norm2 = nn.GroupNorm(min(groups, out_ch), out_ch,
                                  **_norm_kw(kw))
        self.conv2 = nn.Conv2D(out_ch, out_ch, 3, padding=1, **kw)
        self.skip = (nn.Conv2D(in_ch, out_ch, 1, **kw) if in_ch != out_ch
                     else nn.Identity())

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.temb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        return self.skip(x) + h


class _CrossAttention(nn.Layer):
    def __init__(self, dim, ctx_dim, num_heads, **kw):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.to_q = _linear(dim, dim, kw, bias=False)
        self.to_k = _linear(ctx_dim, dim, kw, bias=False)
        self.to_v = _linear(ctx_dim, dim, kw, bias=False)
        self.to_out = _linear(dim, dim, kw)

    def forward(self, x, ctx=None):
        ctx = x if ctx is None else ctx
        b, s, _ = x.shape
        sk = ctx.shape[1]
        q = self.to_q(x).reshape(b, s, self.num_heads, self.head_dim)
        k = self.to_k(ctx).reshape(b, sk, self.num_heads, self.head_dim)
        v = self.to_v(ctx).reshape(b, sk, self.num_heads, self.head_dim)
        out = F.scaled_dot_product_attention(q, k, v)
        return self.to_out(out.reshape(b, s, -1))


class _GEGLU(nn.Layer):
    def __init__(self, dim, inner, **kw):
        super().__init__()
        self.proj = _linear(dim, inner * 2, kw)
        self.out = _linear(inner, dim, kw)

    def forward(self, x):
        a, g = torch.chunk(self.proj(x), 2, dim=-1)
        return self.out(a * F.gelu(g))


class SpatialTransformer(nn.Layer):
    """GN → 1x1 in → [self-attn, cross-attn, GEGLU-FF] → 1x1 out (+residual)."""

    def __init__(self, ch, num_heads, ctx_dim, groups, **kw):
        super().__init__()
        self.norm = nn.GroupNorm(min(groups, ch), ch, **_norm_kw(kw))
        self.proj_in = nn.Conv2D(ch, ch, 1, **kw)
        self.norm1 = nn.LayerNorm(ch, **_norm_kw(kw))
        self.attn1 = _CrossAttention(ch, ch, num_heads, **kw)
        self.norm2 = nn.LayerNorm(ch, **_norm_kw(kw))
        self.attn2 = _CrossAttention(ch, ctx_dim if ctx_dim else ch,
                                     num_heads, **kw)
        self.norm3 = nn.LayerNorm(ch, **_norm_kw(kw))
        self.ff = _GEGLU(ch, 4 * ch, **kw)
        self.proj_out = nn.Conv2D(ch, ch, 1, **kw)
        self.has_ctx = ctx_dim is not None

    def forward(self, x, ctx=None):
        b, c, h, w = x.shape
        res = x
        y = self.proj_in(self.norm(x))
        y = y.reshape(b, c, h * w).transpose(1, 2)           # (b, hw, c)
        y = y + self.attn1(self.norm1(y))
        y = y + self.attn2(self.norm2(y), ctx if self.has_ctx else None)
        y = y + self.ff(self.norm3(y))
        y = y.transpose(1, 2).reshape(b, c, h, w)
        return res + self.proj_out(y)


class Downsample(nn.Layer):
    def __init__(self, ch, **kw):
        super().__init__()
        self.op = nn.Conv2D(ch, ch, 3, stride=2, padding=1, **kw)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Layer):
    def __init__(self, ch, **kw):
        super().__init__()
        self.conv = nn.Conv2D(ch, ch, 3, padding=1, **kw)

    def forward(self, x):
        x = F.interpolate(x, scale_factor=2, mode="nearest",
                          data_format="NCHW")
        return self.conv(x)


class UNetModel(nn.Layer):
    """The SD UNet. ``device`` defaults to cuda (raises without a GPU);
    ``dtype`` is the parameter dtype the weights are drawn in, from a
    ``torch.Generator`` on ``device`` seeded with ``seed`` (or from the
    global seed stream when ``seed`` is None)."""

    def __init__(self, cfg: UNetConfig, dtype=torch.float32, device=None,
                 seed: Optional[int] = None):
        super().__init__()
        dev, generator = model_generator(device, seed)
        kw = dict(dtype=dtype, device=dev, generator=generator)
        self.cfg = cfg
        mc = cfg.model_channels
        temb_ch = mc * 4
        self.time_mlp1 = _linear(mc, temb_ch, kw)
        self.time_mlp2 = _linear(temb_ch, temb_ch, kw)
        self.conv_in = nn.Conv2D(cfg.in_channels, mc, 3, padding=1, **kw)

        chans = [mc]
        ch = mc
        self.down_blocks = nn.LayerList()
        self.down_attns = nn.LayerList()
        self.downsamplers = nn.LayerList()
        for level, mult in enumerate(cfg.channel_mult):
            out_ch = mc * mult
            for _ in range(cfg.num_res_blocks):
                self.down_blocks.append(ResBlock(ch, out_ch, temb_ch,
                                                 cfg.groups, **kw))
                ch = out_ch
                self.down_attns.append(
                    SpatialTransformer(ch, cfg.num_heads, cfg.context_dim,
                                       cfg.groups, **kw)
                    if level in cfg.attention_levels else nn.Identity())
                chans.append(ch)
            if level != len(cfg.channel_mult) - 1:
                self.downsamplers.append(Downsample(ch, **kw))
                chans.append(ch)
            else:
                self.downsamplers.append(nn.Identity())

        self.mid_block1 = ResBlock(ch, ch, temb_ch, cfg.groups, **kw)
        self.mid_attn = SpatialTransformer(ch, cfg.num_heads, cfg.context_dim,
                                           cfg.groups, **kw)
        self.mid_block2 = ResBlock(ch, ch, temb_ch, cfg.groups, **kw)

        self.up_blocks = nn.LayerList()
        self.up_attns = nn.LayerList()
        self.upsamplers = nn.LayerList()
        for level, mult in reversed(list(enumerate(cfg.channel_mult))):
            out_ch = mc * mult
            for _ in range(cfg.num_res_blocks + 1):
                skip = chans.pop()
                self.up_blocks.append(ResBlock(ch + skip, out_ch, temb_ch,
                                               cfg.groups, **kw))
                ch = out_ch
                self.up_attns.append(
                    SpatialTransformer(ch, cfg.num_heads, cfg.context_dim,
                                       cfg.groups, **kw)
                    if level in cfg.attention_levels else nn.Identity())
            if level != 0:
                self.upsamplers.append(Upsample(ch, **kw))
            else:
                self.upsamplers.append(nn.Identity())

        self.norm_out = nn.GroupNorm(min(cfg.groups, ch), ch, **_norm_kw(kw))
        self.conv_out = nn.Conv2D(ch, cfg.out_channels, 3, padding=1, **kw)

    def forward(self, x, timesteps, context=None):
        cfg = self.cfg
        temb = timestep_embedding(timesteps, cfg.model_channels)
        # the sinusoidal table is fp32; follow the model's compute dtype
        temb = temb.to(self.time_mlp1.weight.dtype)
        temb = self.time_mlp2(F.silu(self.time_mlp1(temb)))

        h = self.conv_in(x)
        skips = [h]
        bi = 0
        for level in range(len(cfg.channel_mult)):
            for _ in range(cfg.num_res_blocks):
                h = self.down_blocks[bi](h, temb)
                attn = self.down_attns[bi]
                h = attn(h, context) if isinstance(
                    attn, SpatialTransformer) else attn(h)
                skips.append(h)
                bi += 1
            ds = self.downsamplers[level]
            if not isinstance(ds, nn.Identity):
                h = ds(h)
                skips.append(h)

        h = self.mid_block1(h, temb)
        h = self.mid_attn(h, context)
        h = self.mid_block2(h, temb)

        bi = 0
        for li in range(len(cfg.channel_mult)):
            for _ in range(cfg.num_res_blocks + 1):
                h = torch.cat([h, skips.pop()], dim=1)
                h = self.up_blocks[bi](h, temb)
                attn = self.up_attns[bi]
                h = attn(h, context) if isinstance(
                    attn, SpatialTransformer) else attn(h)
                bi += 1
            us = self.upsamplers[li]
            if not isinstance(us, nn.Identity):
                h = us(h)

        return self.conv_out(F.silu(self.norm_out(h)))


def cosine_alphas_cumprod(T=1000, s=0.008):
    """ᾱ_t of the cosine schedule, (T,) fp32, clipped to [1e-5, 1]."""
    t = torch.arange(T + 1, dtype=torch.float32) / T
    f = torch.cos((t + s) / (1 + s) * math.pi / 2) ** 2
    return torch.clip(f[1:] / f[0], 1e-5, 1.0)


def ddpm_loss(model_or_state, model, x0, t, noise, context=None,
              alphas_cumprod=None):
    """ε-prediction MSE, the SD pretrain objective (port of
    ``paddle_tpu/models/unet.py:265-276``): x_t = √ᾱ_t·x0 + √(1 − ᾱ_t)·noise
    with ᾱ = ``alphas_cumprod[t]``, then mean((ε(x_t, t, context) −
    noise)²). A dict `model_or_state` runs `model` with that state bound
    (``nn.functional_call``); otherwise `model` runs as it is."""
    a = torch.as_tensor(alphas_cumprod, device=x0.device)[t][:, None, None,
                                                             None]
    xt = torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * noise
    if isinstance(model_or_state, dict):
        eps = nn.functional_call(model, model_or_state, xt, t, context)
    else:
        eps = model(xt, t, context)
    return torch.mean((eps - noise) ** 2)
