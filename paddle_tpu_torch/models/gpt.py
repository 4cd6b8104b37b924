"""GPT-2 (port of ``paddle_tpu/models/gpt.py``), single device: pretraining,
generation and serving.

Same module tree and attribute names as the reference (``gpt.wte``,
``gpt.h.0.attn.qkv_proj``, ``gpt.ln_f`` …), so the state keys are the JAX
``state_dict(include_buffers=False)`` keys. Pre-norm blocks, learned
positions, tanh GELU, a tied unembedding (``x @ wte.weightᵀ``). The
projections and the unembedding are ``torch.matmul`` (the reference leaves
them to XLA, outside any Pallas kernel); attention goes through
``F.scaled_dot_product_attention`` — on the card the flash-attention
kernels, forward and backward.

The cache forward (``init_cache``, ``cache=``/``start_pos=``) writes k/v at
[start_pos, start_pos + s) in place and attends the filled prefix: the
reference's dense mask ``k_pos <= q_pos`` goes to the kernel as a causal
offset and a kv length, as in the port's Llama. ``fused_decode_plan`` is
the fused decode step's gpt arch (``ops.fused_decode``; the gpt modes of
the decode kernels on the card). Positions index the learned table ``wpe``:
callers keep every position below ``max_position_embeddings``.
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
from paddle_tpu_torch.ops import tied_unembed


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

    def forward(self, x, cache=None, start_pos=0):
        b, s, h = x.shape
        q, k, v = self.qkv_proj(x).split(h, dim=-1)
        shape = (b, s, self.num_heads, self.head_dim)
        q, k, v = q.reshape(shape), k.reshape(shape), v.reshape(shape)
        if cache is not None:
            # append at [start_pos, start_pos + s) in place, attend the
            # filled prefix (the reference's mask k_pos <= q_pos)
            cache["k"][:, start_pos:start_pos + s] = k.to(cache["k"].dtype)
            cache["v"][:, start_pos:start_pos + s] = v.to(cache["v"].dtype)
            out = F.scaled_dot_product_attention(
                q, cache["k"], cache["v"], is_causal=True,
                causal_offset=start_pos, kv_lens=start_pos + s,
                training=False)
            return self.out_proj(out.reshape(b, s, h)), cache
        out = F.scaled_dot_product_attention(
            q, k, v, is_causal=True, dropout_p=self.attn_dropout,
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

    def forward(self, x, cache=None, start_pos=0):
        if cache is not None:
            attn, cache = self.attn(self.ln_1(x), cache=cache,
                                    start_pos=start_pos)
            x = x + attn
            x = x + self.fc_out(F.gelu(self.fc_in(self.ln_2(x)),
                                       approximate=True))
            return x, cache
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
        s = input_ids.shape[1]
        pos = start_pos + torch.arange(s, device=input_ids.device)[None, :]
        x = self.wte(input_ids) + self.wpe(pos)
        if cache is not None:
            new_cache = []
            for i, block in enumerate(self.h):
                x, c = block(x, cache=cache[i], start_pos=start_pos)
                new_cache.append(c)
            return self.ln_f(x), new_cache
        x = self.drop(x)
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
        if cache is not None:
            x, cache = self.gpt(input_ids, cache=cache, start_pos=start_pos)
            return self._head(x), cache
        return self._head(self.gpt(input_ids))

    def _head(self, x):
        if self.cfg.tie_word_embeddings:
            return tied_unembed(x, self.gpt.wte.weight)
        return self.lm_head(x)

    def init_cache(self, batch_size, max_len, dtype=torch.bfloat16):
        """Preallocated KV cache: one {'k','v'} pair of (b, max_len, nh, hd)
        buffers per layer, on the model's device."""
        cfg = self.cfg
        shape = (batch_size, max_len, cfg.num_heads,
                 cfg.hidden_size // cfg.num_heads)
        dev = self.device
        return [{"k": torch.zeros(shape, dtype=dtype, device=dev),
                 "v": torch.zeros(shape, dtype=dtype, device=dev)}
                for _ in range(cfg.num_layers)]

    def fused_decode_plan(self, state, probe=False):
        """Plan of the fused decode step, gpt arch (``ops.fused_decode``
        arch="gpt": LayerNorm with bias, MHA, biases on all four products,
        tanh-GELU FFN, no rope): stacked per-layer weights plus embed/head
        closures, or None when this config cannot ride it (odd head_dim,
        non-standard state, a weight-only int8 state: the reference builds
        no int8 gpt stacks). It takes a bf16 or an int8 KV cache.
        ``rope_base`` is meta only: the gpt step takes no rope. With
        probe=True only eligibility and static meta are computed."""
        cfg = self.cfg
        hd = cfg.hidden_size // cfg.num_heads
        if hd % 2 or "gpt.h.0.attn.qkv_proj.weight" not in state:
            return None
        from paddle_tpu_torch.ops import fused_decode as fd
        h = cfg.hidden_size
        blocks = fd.decode_block_plan(h, 3 * h, h, hd, cfg.ffn_size)
        meta = {
            "num_heads": cfg.num_heads, "num_kv_heads": cfg.num_heads,
            "head_dim": hd, "eps": cfg.layer_norm_epsilon,
            "rope_base": 10000.0, "arch": "gpt", "blocks": blocks,
        }
        if probe:
            return meta
        params = fd.build_fused_params_gpt(state, cfg.num_layers)
        wte = state["gpt.wte.weight"]
        wpe = state["gpt.wpe.weight"]
        lnf_w = state["gpt.ln_f.weight"]
        lnf_b = state["gpt.ln_f.bias"]
        eps = cfg.layer_norm_epsilon

        def embed(tok, pos):      # (b,), scalar or (b,) -> (b, h)
            return wte[tok] + wpe[pos]

        def head(x):              # (b, h) -> (b, vocab)
            xn = F.layer_norm(x, (h,), lnf_w, lnf_b, eps)
            if cfg.tie_word_embeddings:
                return tied_unembed(xn, wte)
            return torch.matmul(xn, state["lm_head.weight"])

        return dict(meta, params=params, embed=embed, head=head)

    def loss(self, logits, labels):
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels.reshape(-1))
