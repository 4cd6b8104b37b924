"""Mixture-of-experts: top-k gating and grouped experts, one device.

Port of ``paddle_tpu/nn/layers/moe.py``: ``topk_routing`` (:208) and its
one-hot view ``topk_gating`` (:253), ``GShardGate`` / ``SwitchGate``,
``_GateProj``, ``GroupedSwiGLUExperts`` (``forward`` and the dropless
``forward_ragged``) and ``MoELayer`` with every one-device dispatch mode:
scatter (``_forward_capacity``, ``MixtralConfig``'s default), sort and
fused (row permutations as ``torch.autograd.Function``s whose backward is
the inverse gather, as the reference's custom VJPs: no row scatter in
either direction), einsum (the (T, E, C) one-hot tensors) and dropless
(sort + per-expert segments). The parameter names and layouts are the
reference's: the router weight is (h, E) and runs in fp32; the experts are
three grouped weights, ``w_gate``/``w_up`` (E, h, f) and ``w_down``
(E, f, h). The expert products are ``torch.matmul``s, as the reference
leaves its ``_swiglu`` einsums and its ``ragged_dot`` to XLA outside any
Pallas kernel.

Not ported yet (NotImplementedError naming ROADMAP Queue A item 10): the
alltoall dispatch and expert-parallel sharding, which need a mesh.
"""

import math
from typing import Sequence

import torch

from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as init
from paddle_tpu_torch.nn.layer import Layer
from paddle_tpu_torch.nn.layers.common import make_parameter

EP_AXES = ("dp",)
DISPATCH_MODES = ("scatter", "sort", "fused", "einsum", "alltoall")


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


def _token_copies(xt, k):
    """(t, h) → (t·k, h) row copies; autograd sums the k copy-grads back
    per token."""
    t, h = xt.shape
    return xt[:, None].expand(t, k, h).reshape(t * k, h)


def _slot_scatter(xt, idx, pos, keep, cap, e):
    """Tokens → flat (e·cap, h) expert buffer; dropped copies land in one
    spare row past the end, which is cut off. Returns (buffer, slot ids)."""
    slot = _slots(idx, pos, keep, cap, e)
    xt_k = _token_copies(xt, idx.shape[1])
    buf = torch.zeros((e * cap + 1, xt.shape[1]), dtype=xt.dtype,
                      device=xt.device)
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


def _perm_maps(slot, e, cap, tk):
    """Invert the copy→slot map: (buf_src (E·cap,) long, hit (E·cap,) bool)
    give, for every expert-buffer slot, which token-copy fills it (if any).

    One scatter of tk integer scalars. Kept copies have unique in-range
    slots; dropped copies carry the slot e·cap, the spare entry cut off
    below. The row movement itself is all gathers (``_PermuteRows``)."""
    buf_src = torch.full((e * cap + 1,), tk, dtype=torch.long,
                         device=slot.device)
    buf_src[slot] = torch.arange(tk, device=slot.device)
    buf_src = buf_src[:e * cap]
    hit = buf_src < tk
    return torch.where(hit, buf_src, 0), hit


def _take_rows(x, idx, ok):
    """out[i] = ok[i] ? x[idx[i]] : 0 — one row gather."""
    out = x.index_select(0, torch.where(ok, idx, 0))
    return out.masked_fill(~ok[:, None], 0)


class _PermuteRows(torch.autograd.Function):
    """out[i] = fwd_ok[i] ? x[fwd_idx[i]] : 0 — a (partial) row permutation
    whose backward is the INVERSE gather (bwd_idx/bwd_ok), so neither
    direction scatters rows (reference :106-129). The index sets must be
    mutually inverse over their valid entries."""

    @staticmethod
    def forward(ctx, x, fwd_idx, fwd_ok, bwd_idx, bwd_ok):
        ctx.save_for_backward(bwd_idx, bwd_ok)
        return _take_rows(x, fwd_idx, fwd_ok)

    @staticmethod
    def backward(ctx, g):
        bwd_idx, bwd_ok = ctx.saved_tensors
        return _take_rows(g, bwd_idx, bwd_ok), None, None, None, None


class _GatherDispatch(torch.autograd.Function):
    """out[s] = hit[s] ? xt[buf_src[s] // k] : 0 — dispatch straight from
    the (t, h) token rows into the flat (E·cap, h) expert blocks, the token
    index recovered from the copy index inside the gather (reference
    :136-165). Backward: the inverse gather (slot_cl/keep) and a
    contiguous segment-sum over each token's k copy rows."""

    @staticmethod
    def forward(ctx, xt, buf_src, hit, slot_cl, keep, k):
        ctx.save_for_backward(slot_cl, keep)
        ctx.k = k
        return _take_rows(xt, buf_src // k, hit)

    @staticmethod
    def backward(ctx, g):
        slot_cl, keep = ctx.saved_tensors
        k = ctx.k
        rows = _take_rows(g, slot_cl, keep)                     # (t·k, h)
        dx = rows.reshape(keep.shape[0] // k, k, -1).sum(dim=1)
        return dx, None, None, None, None, None


class _CombineGather(torch.autograd.Function):
    """yt[t] = Σ_c w[t, c] · ye[slot(t, c)] — the combine as one inverse
    gather plus a per-token segment-sum over the k copy rows (reference
    :168-205). Backward re-disperses the incoming grad into the expert
    blocks with the forward maps, d_ye[s] = w[token(s), choice(s)] ·
    g[token(s)], again one gather; d_w recomputes the gathered rows. Each
    gradient comes back in its input's dtype."""

    @staticmethod
    def forward(ctx, ye, w, slot_cl, keep, buf_src, hit):
        ctx.save_for_backward(ye, w, slot_cl, keep, buf_src, hit)
        t, k = w.shape
        rows = _take_rows(ye, slot_cl, keep).reshape(t, k, -1)
        return torch.einsum("tk,tkh->th", w, rows)

    @staticmethod
    def backward(ctx, g):
        ye, w, slot_cl, keep, buf_src, hit = ctx.saved_tensors
        t, k = w.shape
        src = torch.where(hit, buf_src, 0)
        w_slot = w.reshape(-1)[src].masked_fill(~hit, 0)
        d_ye = (g.index_select(0, src // k) * w_slot[:, None]).to(ye.dtype)
        rows = _take_rows(ye, slot_cl, keep).reshape(t, k, -1)
        dw = torch.einsum("th,tkh->tk", g, rows).to(w.dtype)
        return d_ye, dw, None, None, None, None


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


def topk_gating(logits, k: int, capacity: int, normalize_topk: bool = True):
    """(T, E, C) one-hot view of ``topk_routing`` (the einsum dispatch).

    Returns (combine (T, E, C) fp32, dispatch bool (T, E, C), aux_loss). A
    copy past its expert's capacity has no one-hot row, as
    ``jax.nn.one_hot`` of an index past the end."""
    t, e = logits.shape
    gate_idx, gate_vals, pos, keep, aux, _ = topk_routing(
        logits, k, capacity, normalize_topk)
    mask = torch.nn.functional.one_hot(gate_idx, e).float()     # (T, k, E)
    pos_oh = torch.nn.functional.one_hot(
        pos.clamp(max=capacity), capacity + 1)[..., :capacity].float()
    contrib = (gate_vals * keep)[..., None] * pos_oh            # (T, k, C)
    combine = torch.einsum("tkc,tke->tec", contrib, mask)
    return combine, combine > 0.0, aux


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
        """The one-hot view: (combine, dispatch, aux) of ``topk_gating``."""
        return topk_gating(self.proj(x_tokens), self.top_k,
                           self.capacity(x_tokens.shape[0]))

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

    #: host reads of ``forward_ragged``'s group sizes (one a call)
    host_reads = 0

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
        """Dropless path: xs (N, h) rows sorted by expert, group_sizes (E,)
        — each expert's contiguous segment length, summing to N. Expert
        e's SwiGLU runs as ``torch.matmul``s over its own segment (the
        reference's ``jax.lax.ragged_dot``, an XLA product outside any
        Pallas kernel). The group
        sizes are read on the host once a call (a device sync, counted on
        ``GroupedSwiGLUExperts.host_reads``): the segments' bounds drive
        the Python loop."""
        sizes = group_sizes.tolist()
        GroupedSwiGLUExperts.host_reads += 1
        dt = xs.dtype
        wg, wu, wd = (w.to(dt) for w in (self.w_gate, self.w_up,
                                         self.w_down))
        outs, start = [], 0
        for e, n in enumerate(sizes):
            if n:
                outs.append(_swiglu(xs[start:start + n], wg[e], wu[e],
                                    wd[e]))
            start += n
        return torch.cat(outs)


class MoELayer(Layer):
    """Token-choice MoE block: gate → dispatch → grouped experts →
    combine. Returns (output, aux_loss), or also the routing stats with
    ``return_stats`` (None for einsum, as the reference's)."""

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
        if dispatch_mode not in DISPATCH_MODES:
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

    def _route_maps(self, xt):
        """Routing plus the permutation maps of sort and fused: (idx, vals,
        keep, aux, stats, cap, keep_f, slot_cl, buf_src, hit)."""
        e = self.num_experts
        idx, vals, pos, keep, aux, stats, cap = self.gate.route(xt)
        slot = _slots(idx, pos, keep, cap, e)
        buf_src, hit = _perm_maps(slot, e, cap, slot.shape[0])
        return (idx, vals, keep, aux, stats, cap, keep.reshape(-1),
                slot.clamp(0, e * cap - 1), buf_src, hit)

    def _forward_sort(self, xt, dtype):
        """Permutation dispatch: the inverse copy→slot map, then dispatch
        and combine as row gathers in forward and backward over the
        (t·k, h) token copies (reference :407-429)."""
        e = self.num_experts
        t, h = xt.shape
        (idx, vals, keep, aux, stats, cap, keep_f, slot_cl, buf_src,
         hit) = self._route_maps(xt)
        k = idx.shape[1]
        xt_k = _token_copies(xt.to(dtype), k)
        buf = _PermuteRows.apply(xt_k, buf_src, hit, slot_cl, keep_f)
        ye = self.experts(buf.reshape(e, cap, h)).reshape(e * cap, h)
        gathered = _PermuteRows.apply(ye, slot_cl, keep_f, buf_src, hit)
        w = (vals * keep).to(dtype)
        yt = torch.einsum("tk,tkh->th", w, gathered.reshape(t, k, h))
        return yt, aux, stats

    def _forward_fused(self, xt, dtype):
        """Fused permutation dispatch (reference :431-457): the (E, cap, h)
        blocks gathered straight from the (t, h) token rows, and the
        combine one inverse gather plus a per-token segment-sum; two row
        passes a direction, no (t·k, h) intermediate, no row scatter."""
        e = self.num_experts
        h = xt.shape[1]
        (idx, vals, keep, aux, stats, cap, keep_f, slot_cl, buf_src,
         hit) = self._route_maps(xt)
        buf = _GatherDispatch.apply(xt.to(dtype), buf_src, hit, slot_cl,
                                    keep_f, idx.shape[1])
        ye = self.experts(buf.reshape(e, cap, h)).reshape(e * cap, h)
        w = (vals * keep).to(dtype)
        yt = _CombineGather.apply(ye, w, slot_cl, keep_f, buf_src, hit)
        return yt, aux, stats

    def _forward_einsum(self, xt, dtype):
        """The (T, E, C) one-hot dispatch (reference :459-465)."""
        combine, dispatch, aux = self.gate(xt)
        xe = torch.einsum("tec,th->ech", dispatch.to(dtype), xt)
        ye = self.experts(xe)
        yt = torch.einsum("tec,ech->th", combine.to(dtype), ye)
        return yt, aux, None

    def _forward_alltoall(self, xt, dtype):
        raise NotImplementedError(
            "dispatch_mode='alltoall' needs an expert-parallel mesh, which "
            "is not ported yet (ROADMAP Queue A item 10)")

    def _forward_dropless(self, xt, dtype):
        """Sort + per-expert segments (reference :567-588): every routed
        copy is computed. The copies are sorted by expert and put back
        with row permutations whose backward is the inverse gather."""
        e = self.num_experts
        idx, vals, pos, keep, aux, stats, _ = self.gate.route(xt)
        t, k = idx.shape
        e_flat = idx.reshape(-1)
        order = torch.sort(e_flat, stable=True).indices
        inv = torch.argsort(order)
        every = torch.ones_like(e_flat, dtype=torch.bool)
        xs = _PermuteRows.apply(_token_copies(xt, k), order, every, inv,
                                every)
        ys = self.experts.forward_ragged(xs, torch.bincount(e_flat,
                                                            minlength=e))
        ys = _PermuteRows.apply(ys, inv, every, order, every)
        yt = torch.einsum("tk,tkh->th", vals.to(dtype),
                          ys.reshape(t, k, -1))
        stats = dict(stats, moe_dropped_fraction=torch.zeros(
            (), device=xt.device))
        return yt, aux, stats

    def forward(self, x, return_stats: bool = False):
        b, s, h = x.shape
        if self.dropless:
            fwd = self._forward_dropless
        else:
            fwd = {"scatter": self._forward_capacity,
                   "sort": self._forward_sort,
                   "fused": self._forward_fused,
                   "einsum": self._forward_einsum,
                   "alltoall": self._forward_alltoall}[self.dispatch_mode]
        yt, aux, stats = fwd(x.reshape(b * s, h), x.dtype)
        out = yt.reshape(b, s, h)
        if return_stats:
            return out, aux, stats
        return out, aux
