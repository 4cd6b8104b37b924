"""Mixtral / DeepSeekMoE (port of ``paddle_tpu/models/mixtral.py``), one device.

A Llama decoder (GQA attention, RMSNorm, RoPE) whose FFN is a token-choice
MoE (``nn.layers.moe.MoELayer``, any one-device dispatch mode: scatter by
default, sort, fused, einsum or dropless), with the DeepSeekMoE
shared experts (an always-on SwiGLU beside the routed experts, the model's
``shared_mlp``) optional. Forward returns (logits, weighted aux loss); the
cache forward returns logits only (``generate``'s contract). Same module
tree and attribute names as the reference, so the state keys are the JAX
``state_dict(include_buffers=False)`` keys (``moe.gate.proj.weight``,
``moe.experts.w_gate`` …).

Weights are drawn on ``device`` (cuda by default) in ``dtype`` from an
explicit ``torch.Generator``, as for Llama.
"""

import dataclasses

import torch

from paddle_tpu_torch import nn
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as init
from paddle_tpu_torch.nn.layers.moe import MoELayer
from paddle_tpu_torch.ops import rope as rope_ops
from paddle_tpu_torch.parallel import mp_layers as mp
from paddle_tpu_torch.models.llama import (
    CausalLMBase,
    LlamaAttention,
    LlamaConfig,
    LlamaMLP,
    model_generator,
)


@dataclasses.dataclass
class MixtralConfig(LlamaConfig):
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    num_shared_experts: int = 0       # DeepSeekMoE: always-on experts
    moe_gate: str = "gshard"          # 'gshard' (top-k) | 'switch' (top-1)
    moe_dispatch: str = "scatter"     # 'scatter'|'sort'|'fused'|'einsum'
                                      # |'alltoall' (alltoall: not ported)
    moe_dropless: bool = False        # sort + segments, no capacity drops
    ep_axes: tuple = ("dp",)

    @classmethod
    def tiny(cls, vocab_size=256):
        return cls(vocab_size=vocab_size, hidden_size=64, intermediate_size=96,
                   num_layers=2, num_heads=4, num_kv_heads=2,
                   max_position_embeddings=128, num_experts=4, top_k=2)

    @classmethod
    def mixtral_8x7b(cls):
        return cls(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                   num_layers=32, num_heads=32, num_kv_heads=8,
                   num_experts=8, top_k=2)

    @classmethod
    def deepseek_moe_16b(cls):
        # fine-grained experts + 2 shared (DeepSeekMoE scheme)
        return cls(vocab_size=102400, hidden_size=2048, intermediate_size=1408,
                   num_layers=28, num_heads=16, num_experts=64, top_k=6,
                   num_shared_experts=2)


class MixtralDecoderLayer(nn.Layer):
    def __init__(self, cfg: MixtralConfig, dtype=None, device=None,
                 generator=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.input_layernorm = nn.RMSNorm(cfg.hidden_size,
                                          epsilon=cfg.rms_norm_eps, **kw)
        self.self_attn = LlamaAttention(cfg, generator=generator, **kw)
        self.post_attention_layernorm = nn.RMSNorm(
            cfg.hidden_size, epsilon=cfg.rms_norm_eps, **kw)
        self.moe = MoELayer(cfg.hidden_size, cfg.intermediate_size,
                            cfg.num_experts, top_k=cfg.top_k,
                            capacity_factor=cfg.capacity_factor,
                            gate=cfg.moe_gate,
                            initializer_range=cfg.initializer_range,
                            dispatch_mode=cfg.moe_dispatch,
                            dropless=cfg.moe_dropless, ep_axes=cfg.ep_axes,
                            generator=generator, **kw)
        if cfg.num_shared_experts:
            shared_cfg = dataclasses.replace(
                cfg, intermediate_size=cfg.intermediate_size
                * cfg.num_shared_experts)
            self.shared_mlp = LlamaMLP(shared_cfg, generator=generator, **kw)
        self.cfg = cfg

    def forward(self, x, cos=None, sin=None, attn_mask=None, cache=None,
                start_pos=0):
        if cache is not None:
            attn, new_cache = self.self_attn(self.input_layernorm(x), cos,
                                             sin, attn_mask, cache=cache,
                                             start_pos=start_pos)
            x = x + attn
        else:
            new_cache = None
            x = x + self.self_attn(self.input_layernorm(x), cos, sin,
                                   attn_mask)
        h = self.post_attention_layernorm(x)
        moe_out, aux = self.moe(h)
        if self.cfg.num_shared_experts:
            moe_out = moe_out + self.shared_mlp(h)
        out = x + moe_out
        if cache is not None:
            return (out, aux), new_cache
        return out, aux


class MixtralModel(nn.Layer):
    def __init__(self, cfg: MixtralConfig, dtype=None, device=None,
                 generator=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=dtype, device=device)
        self.embed_tokens = mp.VocabParallelEmbedding(
            cfg.vocab_size, cfg.hidden_size,
            weight_attr=init.Normal(0.0, cfg.initializer_range),
            generator=generator, **kw)
        self.layers = nn.LayerList([
            MixtralDecoderLayer(cfg, generator=generator, **kw)
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
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        if cache is not None:
            new_cache = []
            for i, layer in enumerate(self.layers):
                (x, aux), c = layer(x, cos, sin, attn_mask, cache=cache[i],
                                    start_pos=start_pos)
                aux_total = aux_total + aux
                new_cache.append(c)
            return (self.norm(x), aux_total), new_cache
        for layer in self.layers:
            x, aux = layer(x, cos, sin, attn_mask)
            aux_total = aux_total + aux
        return self.norm(x), aux_total


class MixtralForCausalLM(CausalLMBase):
    """Forward returns (logits, weighted_aux); ``loss()`` adds them.
    ``device`` defaults to cuda; weights are drawn there in ``dtype`` from a
    generator seeded with ``seed`` (the global seed stream when None)."""

    def __init__(self, cfg: MixtralConfig, dtype=torch.float32, device=None,
                 seed=None):
        super().__init__()
        if cfg.tie_word_embeddings:
            raise ValueError(
                "MixtralForCausalLM does not support tie_word_embeddings")
        dev, generator = model_generator(device, seed)
        self.cfg = cfg
        self.model = MixtralModel(cfg, dtype=dtype, device=dev,
                                  generator=generator)
        self.lm_head = mp.ColumnParallelLinear(
            cfg.hidden_size, cfg.vocab_size,
            weight_attr=init.Normal(0.0, cfg.initializer_range),
            has_bias=False, dtype=dtype, device=dev, generator=generator)

    def forward(self, input_ids, attn_mask=None, cache=None, start_pos=0):
        if cache is not None:
            (x, _), new_cache = self.model(input_ids, attn_mask, cache=cache,
                                           start_pos=start_pos)
            return self.lm_head(x), new_cache
        x, aux = self.model(input_ids, attn_mask)
        return self.lm_head(x), self.cfg.aux_loss_weight * aux

    def loss(self, outputs, labels):
        logits, aux = outputs
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels.reshape(-1)) + aux

    def fused_decode_plan(self, state, probe=False):
        """Plan of the fused MoE decode step (ops.fused_decode arch="moe"):
        stacked weights plus embed/head closures, or None when this config
        cannot ride it. Eligibility as the reference's: even head_dim,
        E % 8 == 0, not dropless, no sliding window (the layered path
        serves a windowed config), a standard state. ``max_batch`` is the
        largest b with b <= the gate's capacity(b): a token's top-k experts
        are distinct, so the worst load of one expert is b, and no copy is
        dropped. With probe=True only eligibility and static meta are
        computed."""
        cfg = self.cfg
        if (cfg.head_dim % 2 or cfg.num_experts % 8 or cfg.moe_dropless
                or cfg.sliding_window is not None):
            return None
        if "model.layers.0.self_attn.q_proj.weight" not in state:
            return None     # non-standard state (e.g. int8, not ported)
        gate = self.model.layers[0].moe.gate
        max_batch = 0
        for b in range(1, 65):
            if b <= gate.capacity(b):
                max_batch = b
            else:
                break
        if max_batch == 0:
            return None
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
            "rope_base": cfg.rope_base, "arch": "moe",
            "top_k": gate.top_k, "max_batch": max_batch, "blocks": blocks,
        }
        if probe:
            return meta
        params = fd.build_fused_params_moe(state, cfg.num_layers)
        embed_w = state["model.embed_tokens.weight"]
        norm_w = state["model.norm.weight"]
        head_w = state["lm_head.weight"]

        def embed(tok, pos):
            del pos
            return embed_w[tok]

        def head(x):
            return torch.matmul(rms_norm(x, norm_w, cfg.rms_norm_eps),
                                head_w)

        return dict(meta, params=params, embed=embed, head=head)
