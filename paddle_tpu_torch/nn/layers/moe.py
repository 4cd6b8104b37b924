"""Mixture-of-experts: top-k gating and grouped experts, one device.

Port of ``paddle_tpu/nn/layers/moe.py`` for the path MoE generation runs:
``topk_routing`` (:208), ``GShardGate`` / ``SwitchGate`` with ``capacity``
(:269-299), ``_GateProj``, ``GroupedSwiGLUExperts.forward`` and
``MoELayer`` with the scatter dispatch (``_forward_capacity``,
``_slot_scatter``, ``_slot_combine``), ``MixtralConfig``'s default. The
parameter names and layouts are the reference's: the router weight is
(h, E) and runs in fp32; the experts are three grouped weights,
``w_gate``/``w_up`` (E, h, f) and ``w_down`` (E, f, h). The expert
products are batched ``torch.matmul``s, as the reference leaves its
``_swiglu`` einsums to XLA outside any Pallas kernel.

Not ported yet (they raise NotImplementedError naming ROADMAP Queue A item
9): the sort, fused, einsum and alltoall dispatch modes, ``dropless`` /
``forward_ragged``, and expert-parallel sharding.
"""

import math
from typing import Sequence

import torch

from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as init
from paddle_tpu_torch.nn.layer import Layer
from paddle_tpu_torch.nn.layers.common import make_parameter

EP_AXES = ("dp",)
_UNPORTED = "is not ported yet (ROADMAP Queue A item 9)"


def _swiglu(xe, wg, wu, wd):
    """(E, C, h) grouped SwiGLU — the expert-FFN math of every dispatch."""
    h1 = torch.matmul(xe, wg)
    h2 = torch.matmul(xe, wu)
    return torch.matmul(F.silu(h1) * h2, wd)


def _slots(idx, pos, keep, cap, e):
    """Copy→slot map (t·k,): kept copies get unique slots in [0, e·cap);
    dropped copies get the out-of-range value e·cap."""
    return torch.where(keep, idx * cap + pos,
                       torch.full_like(idx, e * cap)).reshape(-1)


def _slot_scatter(xt, idx, pos, keep, cap, e):
    """Tokens → flat (e·cap, h) expert buffer; dropped copies land in one
    spare row past the end, which is cut off. Returns (buffer, slot ids)."""
    slot = _slots(idx, pos, keep, cap, e)
    t, h = xt.shape
    k = idx.shape[1]
    xt_k = xt[:, None].expand(t, k, h).reshape(t * k, h)
    buf = torch.zeros((e * cap + 1, h), dtype=xt.dtype, device=xt.device)
    buf[slot] = xt_k
    return buf[:e * cap], slot


def _slot_combine(ye_flat, slot, vals, keep, dtype):
    """Gather expert outputs back by slot (0 for a dropped copy) and mix
    them with the gate weights."""
    t, k = vals.shape
    h = ye_flat.shape[-1]
    padded = torch.cat([ye_flat, ye_flat.new_zeros((1, h))])
    gathered = padded[slot].reshape(t, k, h)
    w = (vals * keep).to(dtype)
    return torch.einsum("tk,tkh->th", w, gathered)


def topk_routing(logits, k: int, capacity: int, normalize_topk: bool = True):
    """GShard-style top-k routing with static capacity, compact form.

    logits (T, E). Returns (gate_idx (T, k) long, gate_vals (T, k) fp32,
    pos (T, k) long — the copy's place in its expert's queue, keep (T, k)
    bool, aux_loss scalar, stats dict). Top-k breaks ties by the lowest
    index, as ``lax.top_k`` does (a stable descending sort). Choice 0 of
    every token claims capacity before choice 1: the queue positions are a
    cumsum over the flattened (k·T, E) mask."""
    t, e = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    gate_idx = order[:, :k]
    gate_vals = torch.gather(probs, 1, gate_idx)
    if normalize_topk:
        gate_vals = gate_vals / torch.clamp(
            gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    me = probs.mean(dim=0)
    ce = torch.nn.functional.one_hot(gate_idx[:, 0], e).float().mean(dim=0)
    aux = e * torch.sum(me * ce)

    mask = torch.nn.functional.one_hot(gate_idx, e)            # (T, k, E)
    mask_kt = mask.transpose(0, 1).reshape(k * t, e)            # (k·T, E)
    pos_kt = torch.cumsum(mask_kt, dim=0) - mask_kt             # before me
    pos = pos_kt.reshape(k, t, e).transpose(0, 1)               # (T, k, E)
    pos = torch.sum(pos * mask, dim=-1)                         # (T, k)
    routed = gate_vals > 0.0
    keep = (pos < capacity) & routed

    load = mask.sum(dim=(0, 1)).float()
    n_routed = torch.clamp(routed.float().sum(), min=1.0)
    stats = {
        "moe_dropped_fraction": (routed & ~keep).float().sum() / n_routed,
        "moe_expert_load": load / torch.clamp(load.sum(), min=1.0),
        "moe_capacity": torch.tensor(float(capacity)),
        "moe_max_load_over_capacity": load.max() / float(capacity),
    }
    return gate_idx, gate_vals, pos, keep, aux, stats


class _GateProj(Layer):
    def __init__(self, hidden_size, num_experts, dtype=None, device=None,
                 generator=None):
        super().__init__()
        self.weight = make_parameter((hidden_size, num_experts),
                                     init.Normal(0.0, 0.02), dtype, device,
                                     generator)

    def forward(self, x):
        # the router runs in fp32 (routing is precision-sensitive)
        return torch.matmul(x.float(), self.weight.float())


class GShardGate(Layer):
    """Top-2 gate (reference: moe/gate/gshard_gate.py)."""

    top_k = 2

    def __init__(self, hidden_size, num_experts, capacity_factor=1.25,
                 dtype=None, device=None, generator=None):
        super().__init__()
        self.proj = _GateProj(hidden_size, num_experts, dtype, device,
                              generator)
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor

    def capacity(self, n_tokens):
        return max(4, int(math.ceil(
            self.capacity_factor * self.top_k * n_tokens / self.num_experts)))

    def forward(self, x_tokens):
        raise NotImplementedError(f"the one-hot topk_gating view {_UNPORTED}")

    def route(self, x_tokens):
        """Compact routing: (idx, vals, pos, keep, aux, stats, capacity)."""
        logits = self.proj(x_tokens)
        cap = self.capacity(x_tokens.shape[0])
        return topk_routing(logits, self.top_k, cap) + (cap,)


class SwitchGate(GShardGate):
    """Top-1 gate (reference: moe/gate/switch_gate.py)."""

    top_k = 1


class GroupedSwiGLUExperts(Layer):
    """All experts' SwiGLU FFNs as three grouped (E, ·, ·) weights."""

    def __init__(self, num_experts, hidden_size, ffn_size,
                 initializer_range=0.02, ep_axes: Sequence[str] = EP_AXES,
                 mp_axis: str = "mp", dtype=None, device=None,
                 generator=None):
        super().__init__()
        w = init.Normal(0.0, initializer_range)
        e, h, f = num_experts, hidden_size, ffn_size
        kw = (dtype, device, generator)
        self.w_gate = make_parameter((e, h, f), w, *kw)
        self.w_up = make_parameter((e, h, f), w, *kw)
        self.w_down = make_parameter((e, f, h), w, *kw)
        self.ep_axes = tuple(ep_axes)
        self.mp_axis = mp_axis

    def forward(self, xe):
        """xe: (E, C, h) dispatched tokens → (E, C, h). One device: the
        expert-parallel constraints of the reference are no-ops."""
        return _swiglu(xe, self.w_gate, self.w_up, self.w_down)

    def forward_ragged(self, xs, group_sizes):
        raise NotImplementedError(f"forward_ragged (dropless) {_UNPORTED}")


class MoELayer(Layer):
    """Token-choice MoE block: gate → scatter dispatch → grouped experts →
    combine. Returns (output, aux_loss)."""

    def __init__(self, hidden_size, ffn_size, num_experts, top_k=None,
                 capacity_factor=1.25, gate: str = "gshard",
                 initializer_range=0.02, ep_axes: Sequence[str] = EP_AXES,
                 mp_axis: str = "mp", dtype=None, dropless: bool = False,
                 dispatch_mode: str = "scatter", device=None,
                 generator=None):
        super().__init__()
        gate_cls = {"gshard": GShardGate, "switch": SwitchGate}[gate]
        if gate == "switch" and top_k not in (None, 1):
            raise ValueError(f"gate='switch' is top-1 routing; got top_k={top_k}")
        if dispatch_mode not in ("scatter", "sort", "fused", "einsum",
                                 "alltoall"):
            raise ValueError(f"unknown dispatch_mode {dispatch_mode!r}")
        self.gate = gate_cls(hidden_size, num_experts,
                             capacity_factor=capacity_factor, dtype=dtype,
                             device=device, generator=generator)
        if top_k is not None:
            self.gate.top_k = top_k
        self.experts = GroupedSwiGLUExperts(
            num_experts, hidden_size, ffn_size,
            initializer_range=initializer_range,
            ep_axes=() if dropless else ep_axes, mp_axis=mp_axis,
            dtype=dtype, device=device, generator=generator)
        self.num_experts = num_experts
        self.hidden_size = hidden_size
        self.dropless = dropless
        self.dispatch_mode = dispatch_mode

    def _forward_capacity(self, xt, dtype):
        """Scatter dispatch: O(T·k) index ops into an (E·cap, h) buffer."""
        e = self.num_experts
        idx, vals, pos, keep, aux, stats, cap = self.gate.route(xt)
        buf, slot = _slot_scatter(xt.to(dtype), idx, pos, keep, cap, e)
        ye = self.experts(buf.reshape(e, cap, -1)).reshape(e * cap, -1)
        yt = _slot_combine(ye, slot, vals, keep, dtype)
        return yt, aux, stats

    def forward(self, x, return_stats: bool = False):
        if self.dropless:
            raise NotImplementedError(f"dropless MoE {_UNPORTED}")
        if self.dispatch_mode != "scatter":
            raise NotImplementedError(
                f"dispatch_mode={self.dispatch_mode!r} {_UNPORTED}")
        b, s, h = x.shape
        yt, aux, stats = self._forward_capacity(x.reshape(b * s, h), x.dtype)
        out = yt.reshape(b, s, h)
        if return_stats:
            return out, aux, stats
        return out, aux
