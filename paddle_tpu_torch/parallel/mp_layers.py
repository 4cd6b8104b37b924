"""Tensor-parallel layers, single-device forms.

Port of the four classes of ``paddle_tpu/parallel/mp_layers.py`` that
``models/llama.py`` builds (``ColumnParallelLinear`` :103,
``RowParallelLinear`` :139, ``VocabParallelEmbedding`` :180,
``ParallelCrossEntropy`` :205). On one device they are dense layers with
the reference's parameter names and (in, out) weight layout, and the plain
cross entropy; the sharded forms come with the parallel slice.
"""

from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as init
from paddle_tpu_torch.nn.layer import Layer
from paddle_tpu_torch.nn.layers.common import Embedding, Linear


class ColumnParallelLinear(Linear):
    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, dtype=None, device=None, generator=None):
        super().__init__(in_features, out_features, weight_attr=weight_attr,
                         bias_attr=None if has_bias else False, dtype=dtype,
                         device=device, generator=generator)


class RowParallelLinear(ColumnParallelLinear):
    """The input (contracting) dim is the sharded one under TP; on one
    device the same dense layer."""


class VocabParallelEmbedding(Embedding):
    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 dtype=None, device=None, generator=None):
        w_init = weight_attr if isinstance(weight_attr, init.Initializer) \
            else init.Normal(0.0, 1.0)
        super().__init__(num_embeddings, embedding_dim, weight_attr=w_init,
                         dtype=dtype, device=device, generator=generator)


class ParallelCrossEntropy(Layer):
    """Softmax cross entropy over (vocab-sharded, under TP) logits. On one
    device it is ``F.cross_entropy`` with ``ignore_index``; ``reduction``
    defaults to "none", as the reference's does."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, logits, labels, soft_label=False, reduction="none"):
        return F.cross_entropy(logits, labels, soft_label=soft_label,
                               ignore_index=self.ignore_index,
                               reduction=reduction)
