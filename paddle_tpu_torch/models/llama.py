"""Llama (port of ``paddle_tpu/models/llama.py``), single device: training,
generation and serving.

Same module tree and attribute names as the reference, so the state keys
are the JAX ``state_dict(include_buffers=False)`` keys (a tied model has no
``lm_head``). The projections and the unembedding are ``torch.matmul`` (the
reference leaves them to XLA, outside any Pallas kernel); attention goes
through ``F.scaled_dot_product_attention`` — the flash-attention kernels on
the card, forward and backward.

Training: ``train_loss`` (the loss in ``loss_seq_chunks`` recomputed
sequence chunks, so the (b, s, vocab) logits never exist at once) and
per-layer recompute (``recompute``, ``recompute_granularity``) over the
named values of the reference: ``attn_qkv`` (the q/k/v projections),
``ffn_gate`` and ``ffn_up`` (``utils/recompute.py``).

Entry points build on ``cuda`` unless a device is given; the weights are
drawn directly on that device in the requested dtype from an explicit
``torch.Generator`` (a 7B model never exists in fp32 on the host).
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
from paddle_tpu_torch.ops import rope as rope_ops
from paddle_tpu_torch.ops import tied_unembed
from paddle_tpu_torch.parallel import mp_layers as mp
from paddle_tpu_torch.utils import recompute as rc

# recompute_granularity -> the names its policy saves besides the layer's
# input (reference :276-292). attn_out is not saved: the flash backward
# replays its forward for the LSE anyway.
RECOMPUTE_SAVES = {
    "full": None,
    "full_attn": ("ffn_gate", "ffn_up"),
    "core_attn": ("attn_qkv", "ffn_gate", "ffn_up"),
}


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: Optional[int] = None      # None → MHA
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_base: float = 10000.0
    initializer_range: float = 0.02
    tie_word_embeddings: bool = False
    # per-layer activation recompute in the no-cache (training) forward;
    # recompute_granularity names what is RECOMPUTED in the backward:
    # 'full' the whole layer (its input saved), 'full_attn' the attention
    # block (the FFN's gate/up products saved too), 'core_attn' only the
    # attention core (q/k/v saved as well)
    recompute: bool = False
    recompute_granularity: str = "full"
    # train_loss(): the final unembed -> cross entropy in this many sequence
    # chunks under recompute; 1 = plain head + loss
    loss_seq_chunks: int = 1
    # Mistral-style causal sliding-window attention (None = full causal):
    # a query at position p sees the keys p - sliding_window < k <= p, in
    # the no-cache forward and on the cache path alike (K1's window mode)
    sliding_window: Optional[int] = None

    @property
    def kv_heads(self):
        return self.num_kv_heads or self.num_heads

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    @classmethod
    def tiny(cls, vocab_size=256):
        return cls(vocab_size=vocab_size, hidden_size=64, intermediate_size=128,
                   num_layers=2, num_heads=4, num_kv_heads=2,
                   max_position_embeddings=128)

    @classmethod
    def llama2_7b(cls):
        return cls()

    @classmethod
    def mistral_7b(cls):
        # the reference's numbers (paddle_tpu/models/llama.py:68-75): a
        # 4096-key window over a 32k context, rope base 10000
        return cls(vocab_size=32000, hidden_size=4096,
                   intermediate_size=14336, num_layers=32, num_heads=32,
                   num_kv_heads=8, max_position_embeddings=32768,
                   sliding_window=4096)


class LlamaAttention(nn.Layer):
    def __init__(self, cfg: LlamaConfig, dtype=None, device=None,
                 generator=None):
        super().__init__()
        h, nh, nkv, hd = (cfg.hidden_size, cfg.num_heads, cfg.kv_heads,
                          cfg.head_dim)
        w = init.Normal(0.0, cfg.initializer_range)
        kw = dict(dtype=dtype, device=device, generator=generator)
        col = lambda n: mp.ColumnParallelLinear(h, n, weight_attr=w,
                                                has_bias=False, **kw)
        self.q_proj = col(nh * hd)
        self.k_proj = col(nkv * hd)
        self.v_proj = col(nkv * hd)
        self.o_proj = mp.RowParallelLinear(nh * hd, h, weight_attr=init.Normal(
            0.0, cfg.initializer_range / math.sqrt(2 * cfg.num_layers)),
            has_bias=False, **kw)
        self.cfg = cfg

    def forward(self, x, cos=None, sin=None, attn_mask=None, cache=None,
                start_pos=0):
        cfg = self.cfg
        b, s, _ = x.shape
        # named for the recompute_granularity save policies (the reference
        # names q, k, v after the rotation; the products are what a saved
        # name spares the backward, the rotation is recomputed)
        with rc.checkpoint_name("attn_qkv"):
            q = self.q_proj(x).reshape(b, s, cfg.num_heads, cfg.head_dim)
            k = self.k_proj(x).reshape(b, s, cfg.kv_heads, cfg.head_dim)
            v = self.v_proj(x).reshape(b, s, cfg.kv_heads, cfg.head_dim)
        if cos is None or sin is None:
            pos = start_pos + torch.arange(s, device=x.device)
            cos, sin = rope_ops.rope_cos_sin(s, cfg.head_dim,
                                             base=cfg.rope_base,
                                             position_ids=pos)
        q = rope_ops.apply_rotary_pos_emb(q, cos, sin)
        k = rope_ops.apply_rotary_pos_emb(k, cos, sin)
        if cache is not None:
            # decode/prefill into the preallocated cache: write k/v at
            # [start_pos, start_pos+s) IN PLACE, attend to the filled
            # prefix. The reference passes the dense bool mask
            # k_pos <= start_pos + i (and, with a window,
            # k_pos > start_pos + i - window) over the whole cache; the
            # same limits go here as structured arguments (causal offset
            # start_pos, kv_len start_pos + s, the window), which the
            # kernel takes directly. A caller's attn_mask is taken and
            # ignored here, as the reference ignores it on its cache path
            # (it builds its own position mask, :151-166).
            cache["k"][:, start_pos:start_pos + s] = k.to(cache["k"].dtype)
            cache["v"][:, start_pos:start_pos + s] = v.to(cache["v"].dtype)
            out = F.scaled_dot_product_attention(
                q, cache["k"], cache["v"], is_causal=True,
                causal_offset=start_pos, kv_lens=start_pos + s,
                training=False, window_size=cfg.sliding_window)
            out = self.o_proj(out.reshape(b, s, cfg.num_heads * cfg.head_dim))
            return out, cache
        # no cache: causal, bottom-right aligned (sq == sk here)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, is_causal=True, training=False,
            window_size=cfg.sliding_window)
        return self.o_proj(out.reshape(b, s, cfg.num_heads * cfg.head_dim))


class LlamaMLP(nn.Layer):
    """SwiGLU: down(silu(gate(x)) * up(x))."""

    def __init__(self, cfg: LlamaConfig, dtype=None, device=None,
                 generator=None):
        super().__init__()
        h, ffn = cfg.hidden_size, cfg.intermediate_size
        w = init.Normal(0.0, cfg.initializer_range)
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.gate_proj = mp.ColumnParallelLinear(h, ffn, weight_attr=w,
                                                 has_bias=False, **kw)
        self.up_proj = mp.ColumnParallelLinear(h, ffn, weight_attr=w,
                                               has_bias=False, **kw)
        self.down_proj = mp.RowParallelLinear(ffn, h, weight_attr=init.Normal(
            0.0, cfg.initializer_range / math.sqrt(2 * cfg.num_layers)),
            has_bias=False, **kw)

    def forward(self, x):
        with rc.checkpoint_name("ffn_gate"):
            g = self.gate_proj(x)
        with rc.checkpoint_name("ffn_up"):
            u = self.up_proj(x)
        return self.down_proj(F.silu(g) * u)


class LlamaDecoderLayer(nn.Layer):
    def __init__(self, cfg: LlamaConfig, dtype=None, device=None,
                 generator=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.input_layernorm = nn.RMSNorm(cfg.hidden_size,
                                          epsilon=cfg.rms_norm_eps, **kw)
        self.self_attn = LlamaAttention(cfg, generator=generator, **kw)
        self.post_attention_layernorm = nn.RMSNorm(
            cfg.hidden_size, epsilon=cfg.rms_norm_eps, **kw)
        self.mlp = LlamaMLP(cfg, generator=generator, **kw)

    def forward(self, x, cos=None, sin=None, attn_mask=None, cache=None,
                start_pos=0):
        if cache is not None:
            attn, new_cache = self.self_attn(self.input_layernorm(x), cos,
                                             sin, attn_mask, cache=cache,
                                             start_pos=start_pos)
            x = x + attn
            x = x + self.mlp(self.post_attention_layernorm(x))
            return x, new_cache
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, attn_mask)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(nn.Layer):
    def __init__(self, cfg: LlamaConfig, dtype=None, device=None,
                 generator=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=dtype, device=device)
        self.embed_tokens = mp.VocabParallelEmbedding(
            cfg.vocab_size, cfg.hidden_size,
            weight_attr=init.Normal(0.0, cfg.initializer_range),
            generator=generator, **kw)
        self.layers = nn.LayerList([
            LlamaDecoderLayer(cfg, generator=generator, **kw)
            for _ in range(cfg.num_layers)])
        self.norm = nn.RMSNorm(cfg.hidden_size, epsilon=cfg.rms_norm_eps,
                               **kw)

    def forward(self, input_ids, attn_mask=None, cache=None, start_pos=0):
        cfg = self.cfg
        s = input_ids.shape[1]
        pos = (start_pos + torch.arange(s, device=input_ids.device)
               if cache is not None else None)
        cos, sin = rope_ops.rope_cos_sin(s, cfg.head_dim, base=cfg.rope_base,
                                         position_ids=pos,
                                         device=input_ids.device)
        x = self.embed_tokens(input_ids)
        if cache is not None:
            new_cache = []
            for i, layer in enumerate(self.layers):
                x, c = layer(x, cos, sin, attn_mask, cache=cache[i],
                             start_pos=start_pos)
                new_cache.append(c)
            return self.norm(x), new_cache
        if cfg.recompute:
            # per-layer activation recompute (reference :264-294): the
            # granularity's names saved, the rest of the layer recomputed
            gran = cfg.recompute_granularity
            if gran not in RECOMPUTE_SAVES:
                raise ValueError(
                    f"unknown recompute_granularity {gran!r}; expected "
                    "'full', 'full_attn' or 'core_attn'")
            names = RECOMPUTE_SAVES[gran]
            policy = None if names is None else \
                rc.save_only_these_names(*names)
            for layer in self.layers:
                x = rc.recompute(layer, x, cos, sin, attn_mask,
                                 policy=policy)
        else:
            for layer in self.layers:
                x = layer(x, cos, sin, attn_mask)
        return self.norm(x)


class CausalLMBase(nn.Layer):
    """What the decoder-only LMs share (``paddle_tpu/models/llama.py:300``):
    the preallocated KV cache of the ``cfg``'s shape, the parameter count,
    the fused training loss and the unembedding (tied or ``lm_head``), over
    ``.model`` (``embed_tokens`` / ``layers`` / ``norm``), ``.lm_head`` and
    ``.loss_fn``."""

    def init_cache(self, batch_size, max_len, dtype=torch.bfloat16):
        """Preallocated KV cache: one {'k','v'} buffer pair per layer, on
        the model's device."""
        cfg = self.cfg
        shape = (batch_size, max_len, cfg.kv_heads, cfg.head_dim)
        dev = self.device
        return [{"k": torch.zeros(shape, dtype=dtype, device=dev),
                 "v": torch.zeros(shape, dtype=dtype, device=dev)}
                for _ in range(cfg.num_layers)]

    def train_loss(self, input_ids, labels, attn_mask=None):
        """Forward and mean LM loss over the labels that are not the loss's
        ``ignore_index`` (reference :317-354). With ``cfg.loss_seq_chunks``
        > 1 the unembedding and cross entropy run in that many sequence
        chunks, each recomputed in the backward, so the (b, s, vocab)
        logits never exist at once: the loss is the chunks' summed token
        losses over the count of counted labels."""
        chunks = self.cfg.loss_seq_chunks
        x = self.model(input_ids, attn_mask)
        if chunks <= 1:
            return self.loss_fn(self._unembed(x), labels, reduction="mean")
        s = x.shape[1]
        if s % chunks:
            raise ValueError(
                f"loss_seq_chunks={chunks} does not divide seq {s}")
        sc = s // chunks
        ignore = getattr(self.loss_fn, "ignore_index", -100)

        def chunk_sum(x_c, l_c):
            return self.loss_fn(self._unembed(x_c), l_c,
                                reduction="none").sum()

        loss_sum, count = 0.0, 0
        for c in range(chunks):
            cut = slice(c * sc, (c + 1) * sc)
            loss_sum = loss_sum + rc.recompute(chunk_sum, x[:, cut],
                                               labels[:, cut])
            count = count + (labels[:, cut] != ignore).sum()
        return loss_sum / count.clamp_min(1)

    def _unembed(self, x):
        if self.cfg.tie_word_embeddings:
            return tied_unembed(x, self.model.embed_tokens.weight)
        return self.lm_head(x)


def model_generator(device, seed):
    """(device, generator) of an entry point: `device` resolved (cuda by
    default), the generator on it seeded with `seed`, or the next one of
    the global seed stream when `seed` is None."""
    dev = resolve_device(device)
    if seed is None:
        return dev, rng_mod.next_generator(dev)
    generator = torch.Generator(device=dev)
    generator.manual_seed(int(seed))
    return dev, generator


class LlamaForCausalLM(CausalLMBase):
    """Llama LM head model. ``device`` defaults to cuda (raises without a
    GPU); ``dtype`` is the parameter dtype the weights are drawn in; they
    are drawn from a ``torch.Generator`` on ``device`` seeded with ``seed``
    (or from the global seed stream when ``seed`` is None). A
    ``sliding_window`` config (Mistral) runs the window modes of K1 (the
    no-cache forward and the cache path) and of K3/K4 (the backward), and
    decodes on the layered path (its fused plan is None, as in the
    reference). ``tie_word_embeddings`` unembeds against the embedding
    table (no ``lm_head``)."""

    def __init__(self, cfg: LlamaConfig, dtype=torch.float32, device=None,
                 seed: Optional[int] = None):
        super().__init__()
        dev, generator = model_generator(device, seed)
        self.cfg = cfg
        self.model = LlamaModel(cfg, dtype=dtype, device=dev,
                                generator=generator)
        if not cfg.tie_word_embeddings:
            self.lm_head = mp.ColumnParallelLinear(
                cfg.hidden_size, cfg.vocab_size,
                weight_attr=init.Normal(0.0, cfg.initializer_range),
                has_bias=False, dtype=dtype, device=dev, generator=generator)
        self.loss_fn = mp.ParallelCrossEntropy()

    def forward(self, input_ids, attn_mask=None, cache=None, start_pos=0):
        if cache is not None:
            x, new_cache = self.model(input_ids, attn_mask, cache=cache,
                                      start_pos=start_pos)
            return self._unembed(x), new_cache
        return self._unembed(self.model(input_ids, attn_mask))

    def loss(self, logits, labels):
        """Mean cross entropy over the labels that are not ignore_index."""
        return self.loss_fn(logits, labels, reduction="mean")

    def fused_decode_plan(self, state, probe=False):
        """Plan for the fused decode-step path (ops.fused_decode): stacked
        per-layer weights plus embed/head closures, or None when this
        config can't ride it (odd head_dim, a sliding window — the fused
        step attends the whole filled prefix, so the layered path serves
        it, as in the reference — non-standard state). llama,
        bf16 or fp32 weights, or a weight-only int8 state
        (``quantization.quantize_model``: int8 stacks with per-out-channel
        scale rows, the head ``weight_only_linear``'s product on the
        dequantized ``lm_head``); the CUDA kernel itself takes bf16 or int8
        weights.

        With probe=True only eligibility + static meta are computed."""
        cfg = self.cfg
        if cfg.head_dim % 2 or cfg.sliding_window is not None:
            return None
        int8 = "model.layers.0.self_attn.q_proj.weight_q" in state
        if not int8 and "model.layers.0.self_attn.q_proj.weight" not in state:
            return None     # non-standard state
        from paddle_tpu_torch.ops import fused_decode as fd
        from paddle_tpu_torch.ops.rms_norm import rms_norm
        hd = cfg.head_dim
        dq = cfg.num_heads * hd
        blocks = fd.decode_block_plan(
            cfg.hidden_size, dq + 2 * cfg.kv_heads * hd, dq, hd,
            cfg.intermediate_size)
        meta = {
            "num_heads": cfg.num_heads, "num_kv_heads": cfg.kv_heads,
            "head_dim": hd, "eps": cfg.rms_norm_eps,
            "rope_base": cfg.rope_base, "blocks": blocks,
        }
        if probe:
            return meta
        params = fd.build_fused_params(state, cfg.num_layers,
                                       ffn_pad=blocks["ffn_pad"])
        embed_w = state["model.embed_tokens.weight"]
        norm_w = state["model.norm.weight"]

        def embed(tok, pos):          # (b,), scalar or (b,) -> (b, h)
            del pos                   # rope positions, not learned
            return embed_w[tok]

        if cfg.tie_word_embeddings:
            head_mm = lambda xn: tied_unembed(xn, embed_w)
        elif int8 and "lm_head.weight_q" in state:
            hq, hs = state["lm_head.weight_q"], state["lm_head.weight_scale"]
            deq = {}

            def head_mm(xn):
                # weight_only_linear(xn, hq, hs), its dequantized weight
                # made once for the plan's life rather than once per step
                w = deq.get(xn.dtype)
                if w is None:
                    w = deq[xn.dtype] = hq.to(xn.dtype) * hs.to(xn.dtype)
                return torch.matmul(xn, w)
        else:
            head_mm = lambda xn: torch.matmul(xn, state["lm_head.weight"])

        def head(x):                          # (b, h) -> (b, vocab)
            return head_mm(rms_norm(x, norm_w, cfg.rms_norm_eps))

        return dict(meta, params=params, embed=embed, head=head)
