"""GPT-2 (port of ``paddle_tpu/models/gpt.py``), single device, pretraining.

Same module tree and attribute names as the reference (``gpt.wte``,
``gpt.h.0.attn.qkv_proj``, ``gpt.ln_f`` …), so the state keys are the JAX
``state_dict(include_buffers=False)`` keys. Pre-norm blocks, learned
positions, tanh GELU, a tied unembedding (``x @ wte.weightᵀ``). The
projections and the unembedding are ``torch.matmul`` (the reference leaves
them to XLA, outside any Pallas kernel); attention goes through
``F.scaled_dot_product_attention`` — on the card the flash-attention
kernels, forward and backward.

The no-cache forward only: GPT decode over a KV cache needs the dense-mask
attention and the fused gpt decode arch (ROADMAP Queue B row 4).
"""

import dataclasses
import math
from typing import Optional

import torch

from paddle_tpu_torch import nn
from paddle_tpu_torch.core import rng as rng_mod
from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as init


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    max_position_embeddings: int = 1024
    intermediate_size: Optional[int] = None
    hidden_dropout_prob: float = 0.1
    attention_dropout_prob: float = 0.1
    initializer_range: float = 0.02
    layer_norm_epsilon: float = 1e-5
    tie_word_embeddings: bool = True

    @classmethod
    def gpt2_medium(cls):
        return cls(hidden_size=1024, num_layers=24, num_heads=16)

    @classmethod
    def tiny(cls, vocab_size=1024):
        return cls(vocab_size=vocab_size, hidden_size=128, num_layers=2,
                   num_heads=4, max_position_embeddings=128,
                   hidden_dropout_prob=0.0, attention_dropout_prob=0.0)

    @property
    def ffn_size(self):
        return self.intermediate_size or 4 * self.hidden_size


def _no_cache(cache):
    if cache is not None:
        raise NotImplementedError(
            "GPT decode over a KV cache is not ported yet (ROADMAP Queue B "
            "row 4, arch='gpt')")


class GPTAttention(nn.Layer):
    def __init__(self, cfg: GPTConfig, **kw):
        super().__init__()
        h, nh = cfg.hidden_size, cfg.num_heads
        self.qkv_proj = nn.Linear(h, 3 * h, weight_attr=init.Normal(
            0.0, cfg.initializer_range), **kw)
        self.out_proj = nn.Linear(h, h, weight_attr=init.Normal(
            0.0, cfg.initializer_range / math.sqrt(2 * cfg.num_layers)), **kw)
        self.num_heads = nh
        self.head_dim = h // nh
        self.attn_dropout = cfg.attention_dropout_prob

    def forward(self, x):
        b, s, h = x.shape
        q, k, v = self.qkv_proj(x).split(h, dim=-1)
        shape = (b, s, self.num_heads, self.head_dim)
        out = F.scaled_dot_product_attention(
            q.reshape(shape), k.reshape(shape), v.reshape(shape),
            is_causal=True, dropout_p=self.attn_dropout,
            training=self.training)
        return self.out_proj(out.reshape(b, s, h))


class GPTBlock(nn.Layer):
    def __init__(self, cfg: GPTConfig, **kw):
        super().__init__()
        dev = dict(dtype=kw["dtype"], device=kw["device"])
        self.ln_1 = nn.LayerNorm(cfg.hidden_size,
                                 epsilon=cfg.layer_norm_epsilon, **dev)
        self.attn = GPTAttention(cfg, **kw)
        self.ln_2 = nn.LayerNorm(cfg.hidden_size,
                                 epsilon=cfg.layer_norm_epsilon, **dev)
        self.fc_in = nn.Linear(cfg.hidden_size, cfg.ffn_size,
                               weight_attr=init.Normal(
                                   0.0, cfg.initializer_range), **kw)
        self.fc_out = nn.Linear(cfg.ffn_size, cfg.hidden_size,
                                weight_attr=init.Normal(
                                    0.0, cfg.initializer_range
                                    / math.sqrt(2 * cfg.num_layers)), **kw)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)

    def forward(self, x):
        x = x + self.dropout(self.attn(self.ln_1(x)))
        return x + self.dropout(self.fc_out(F.gelu(self.fc_in(self.ln_2(x)),
                                                   approximate=True)))


class GPTModel(nn.Layer):
    def __init__(self, cfg: GPTConfig, **kw):
        super().__init__()
        self.cfg = cfg
        w = init.Normal(0.0, cfg.initializer_range)
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                weight_attr=w, **kw)
        self.wpe = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size,
                                weight_attr=w, **kw)
        self.drop = nn.Dropout(cfg.hidden_dropout_prob)
        self.h = nn.LayerList([GPTBlock(cfg, **kw)
                               for _ in range(cfg.num_layers)])
        self.ln_f = nn.LayerNorm(cfg.hidden_size,
                                 epsilon=cfg.layer_norm_epsilon,
                                 dtype=kw["dtype"], device=kw["device"])

    def forward(self, input_ids, cache=None, start_pos=0):
        _no_cache(cache)
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)[None, :]
        x = self.drop(self.wte(input_ids) + self.wpe(pos))
        for block in self.h:
            x = block(x)
        return self.ln_f(x)


class GPTPretrainModel(nn.Layer):
    """LM head (tied) + causal LM loss. ``device`` defaults to cuda (raises
    without a GPU); ``dtype`` is the parameter dtype the weights are drawn
    in, from a ``torch.Generator`` on ``device`` seeded with ``seed`` (or
    from the global seed stream when ``seed`` is None)."""

    def __init__(self, cfg: GPTConfig, dtype=torch.float32, device=None,
                 seed: Optional[int] = None):
        super().__init__()
        dev = resolve_device(device)
        if seed is None:
            generator = rng_mod.next_generator(dev)
        else:
            generator = torch.Generator(device=dev)
            generator.manual_seed(int(seed))
        self.cfg = cfg
        kw = dict(dtype=dtype, device=dev, generator=generator)
        self.gpt = GPTModel(cfg, **kw)
        if not cfg.tie_word_embeddings:
            self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                     bias_attr=False, **kw)

    def forward(self, input_ids, cache=None, start_pos=0):
        _no_cache(cache)
        x = self.gpt(input_ids)
        if self.cfg.tie_word_embeddings:
            return torch.matmul(x, self.gpt.wte.weight.T)
        return self.lm_head(x)

    def loss(self, logits, labels):
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels.reshape(-1))
