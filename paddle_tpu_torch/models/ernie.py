"""ERNIE 3.0 (port of ``paddle_tpu/models/ernie.py``), single device.

BASELINE config #3: a bidirectional encoder backbone (the "universal
representation") shared by a masked-LM NLU branch and a causal NLG branch,
each with its own task layers, and one LM head over both. Post-norm blocks
(BERT/ERNIE), learned positions, token types, exact GELU.

Same module tree and attribute names as the reference (``ernie.word_emb``,
``ernie.layers.0.attn.qkv``, ``nlu_layers.0.fc1``, ``mlm_head`` …) and its
(in, out) weight layout, so ``utils.convert.load_jax_state`` carries a JAX
state across unchanged. The products are ``torch.matmul`` (the reference
leaves them to XLA); attention goes through ``F.scaled_dot_product_attention``
— on the card the flash-attention kernels, forward and backward, and with
``ErnieModel``'s dense ``attn_mask`` (a (b, 1, 1, s) padding mask, bool or
PaddleNLP's additive −1e4) their mask instantiations.
"""

import dataclasses
from typing import Optional

import torch

from paddle_tpu_torch import nn
from paddle_tpu_torch.core import rng as rng_mod
from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as init
from paddle_tpu_torch.parallel import mp_layers as mp


@dataclasses.dataclass
class ErnieConfig:
    vocab_size: int = 40000
    hidden_size: int = 768
    num_hidden_layers: int = 12        # universal representation depth
    num_task_layers: int = 2           # task-specific (NLU/NLG) depth
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 4
    hidden_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-5
    initializer_range: float = 0.02

    @classmethod
    def tiny(cls, vocab_size=256):
        return cls(vocab_size=vocab_size, hidden_size=64,
                   num_hidden_layers=2, num_task_layers=1, num_heads=4,
                   intermediate_size=128, max_position_embeddings=64,
                   hidden_dropout_prob=0.0)

    @classmethod
    def ernie3_titan(cls):
        # 260B-class: 48 shared + 12 task layers, hidden 12288 (paper scale)
        return cls(vocab_size=40000, hidden_size=12288,
                   num_hidden_layers=48, num_task_layers=12, num_heads=96,
                   intermediate_size=49152, max_position_embeddings=2048)


def _init_kw(dtype, device, seed, generator):
    """The sublayers' (dtype, device, generator): the weights are drawn in
    `dtype` from a generator on `device` seeded with `seed` (or from the
    global seed stream when both are None)."""
    dev = resolve_device(device)
    if generator is None:
        if seed is None:
            generator = rng_mod.next_generator(dev)
        else:
            generator = torch.Generator(device=dev)
            generator.manual_seed(int(seed))
    return dict(dtype=dtype, device=dev, generator=generator)


class ErnieSelfAttention(nn.Layer):
    def __init__(self, cfg: ErnieConfig, **kw):
        super().__init__()
        h = cfg.hidden_size
        w = init.Normal(0.0, cfg.initializer_range)
        self.qkv = mp.ColumnParallelLinear(h, 3 * h, weight_attr=w, **kw)
        self.out = mp.RowParallelLinear(h, h, weight_attr=w, **kw)
        self.num_heads = cfg.num_heads
        self.head_dim = h // cfg.num_heads

    def forward(self, x, attn_mask=None, causal=False):
        b, s, h = x.shape
        q, k, v = self.qkv(x).split(h, dim=-1)
        shape = (b, s, self.num_heads, self.head_dim)
        out = F.scaled_dot_product_attention(
            q.reshape(shape), k.reshape(shape), v.reshape(shape),
            attn_mask=attn_mask, is_causal=causal)
        return self.out(out.reshape(b, s, h))


class ErnieLayer(nn.Layer):
    """Post-norm encoder block (BERT/ERNIE convention)."""

    def __init__(self, cfg: ErnieConfig, **kw):
        super().__init__()
        h = cfg.hidden_size
        w = init.Normal(0.0, cfg.initializer_range)
        dev = dict(dtype=kw["dtype"], device=kw["device"])
        self.attn = ErnieSelfAttention(cfg, **kw)
        self.norm1 = nn.LayerNorm(h, epsilon=cfg.layer_norm_eps, **dev)
        self.fc1 = mp.ColumnParallelLinear(h, cfg.intermediate_size,
                                           weight_attr=w, **kw)
        self.fc2 = mp.RowParallelLinear(cfg.intermediate_size, h,
                                        weight_attr=w, **kw)
        self.norm2 = nn.LayerNorm(h, epsilon=cfg.layer_norm_eps, **dev)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)

    def forward(self, x, attn_mask=None, causal=False):
        x = self.norm1(x + self.dropout(self.attn(x, attn_mask, causal)))
        return self.norm2(x + self.dropout(self.fc2(F.gelu(self.fc1(x)))))


class ErnieModel(nn.Layer):
    """Shared universal-representation backbone. ``device`` defaults to
    cuda (raises without a GPU); ``dtype``, ``seed``: as
    ``GPTPretrainModel``'s (a parent passes its ``generator``)."""

    def __init__(self, cfg: ErnieConfig, dtype=torch.float32, device=None,
                 seed: Optional[int] = None, generator=None):
        super().__init__()
        kw = _init_kw(dtype, device, seed, generator)
        self.cfg = cfg
        w = init.Normal(0.0, cfg.initializer_range)
        self.word_emb = mp.VocabParallelEmbedding(cfg.vocab_size,
                                                  cfg.hidden_size,
                                                  weight_attr=w, **kw)
        self.pos_emb = nn.Embedding(cfg.max_position_embeddings,
                                    cfg.hidden_size, weight_attr=w, **kw)
        self.type_emb = nn.Embedding(cfg.type_vocab_size, cfg.hidden_size,
                                     weight_attr=w, **kw)
        self.emb_norm = nn.LayerNorm(cfg.hidden_size,
                                     epsilon=cfg.layer_norm_eps,
                                     dtype=dtype, device=kw["device"])
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)
        self.layers = nn.LayerList([ErnieLayer(cfg, **kw)
                                    for _ in range(cfg.num_hidden_layers)])

    def forward(self, input_ids, token_type_ids=None, attn_mask=None,
                causal=False):
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)[None, :]
        x = self.word_emb(input_ids) + self.pos_emb(pos)
        if token_type_ids is not None:
            x = x + self.type_emb(token_type_ids)
        x = self.dropout(self.emb_norm(x))
        for layer in self.layers:
            x = layer(x, attn_mask, causal)
        return x


class ErnieForPretraining(nn.Layer):
    """NLU branch (bidirectional masked-LM) + NLG branch (causal LM), both
    over the shared backbone — the ERNIE 3.0 task split. Construction as
    ``ErnieModel``'s."""

    def __init__(self, cfg: ErnieConfig, dtype=torch.float32, device=None,
                 seed: Optional[int] = None):
        super().__init__()
        kw = _init_kw(dtype, device, seed, None)
        self.cfg = cfg
        self.ernie = ErnieModel(cfg, **kw)
        self.nlu_layers = nn.LayerList([ErnieLayer(cfg, **kw)
                                        for _ in range(cfg.num_task_layers)])
        self.nlg_layers = nn.LayerList([ErnieLayer(cfg, **kw)
                                        for _ in range(cfg.num_task_layers)])
        self.mlm_head = mp.ColumnParallelLinear(
            cfg.hidden_size, cfg.vocab_size,
            weight_attr=init.Normal(0.0, cfg.initializer_range),
            has_bias=False, **kw)
        self.loss_fn = mp.ParallelCrossEntropy()

    def forward(self, input_ids, token_type_ids=None, branch="nlu"):
        causal = branch == "nlg"
        x = self.ernie(input_ids, token_type_ids, causal=causal)
        task_layers = self.nlg_layers if causal else self.nlu_layers
        for layer in task_layers:
            x = layer(x, causal=causal)
        return self.mlm_head(x)

    def loss(self, logits, labels):
        """labels: ignore_index=-100 marks unmasked positions (MLM) or
        padding (NLG)."""
        return self.loss_fn(logits, labels, reduction="mean")
