"""Speculative-decoding proposers for the serving engine (port of
``paddle_tpu/serving/spec.py``).

Decode is memory-bandwidth-bound: every serial decode step streams the
whole model once to produce ONE token per slot. Speculation trades k cheap
*proposed* tokens per slot for one batched *verify* pass through the paged
verify step (``ops.fused_decode.fused_paged_verify_step``; the kernel K7 on
the card), committing however many proposals the engine's own sampling
stream agrees with: fewer weight streams per generated token, the same
tokens.

The n-gram proposer (self-speculative, no extra model) is ported: a
per-slot suffix match over the committed tokens (prompt + generated), the
prompt-lookup trick. ``ngram_propose`` runs on the engine's device over a
carried token-history tensor, so a steady speculative tick uploads
nothing. The draft-model proposer is not ported yet: ``SpecConfig``
accepts it, and ``ServingEngine`` refuses it with NotImplementedError.

Acceptance is token-exact, not distribution-level rejection sampling: a
proposal survives only if it equals the token the engine's own
per-request stream (``fold_in(seed, count)``) samples at that position
from the verify logits. The committed tokens are the non-speculative
engine's.
"""

import numbers
from typing import Optional

import numpy as np
import torch

__all__ = ["SpecConfig", "PROPOSERS", "ngram_propose",
           "ngram_propose_host"]

#: supported proposer kinds
PROPOSERS = ("ngram", "draft")


class SpecConfig:
    """Speculative-decoding config for ``ServingEngine(speculate=...)``.

    ``k`` proposals are verified per slot per tick (one verify pass scores
    k+1 tail tokens). ``proposer="ngram"`` needs no extra model;
    ``proposer="draft"`` requires ``draft_model`` (not ported yet: the
    engine refuses it). ``ngram_max``/``ngram_min`` bound the suffix
    lengths the n-gram matcher tries (longest first).

    ``adaptive=True`` arms per-slot adaptive k: each slot carries an
    acceptance EWMA (accepted/proposed per verify tick); every
    ``adapt_every`` spec ticks a slot whose EWMA sits below
    ``acceptance_floor`` steps its k down one (toward ``k_min``) and one
    above ``acceptance_ceiling`` steps it back up (toward ``k``). The
    tick's verify tail is sized by the MAX k over active slots; with
    ``k_min=0`` a tick whose slots all sit at 0 runs the plain per-token
    decode step. A slot parked at 0 is probed every ``adapt_every`` parked
    ticks with a one-proposal cap for two ticks, so its EWMA can observe
    again and the slot climb back.

    Everything is validated here with plain ``ValueError``s.
    """

    __slots__ = ("k", "proposer", "ngram_max", "ngram_min",
                 "draft_model", "draft_state", "adaptive", "k_min",
                 "acceptance_floor", "acceptance_ceiling", "adapt_every",
                 "share_embeddings")

    def __init__(self, k: int = 4, proposer: str = "ngram",
                 ngram_max: int = 3, ngram_min: int = 1,
                 draft_model=None, draft_state: Optional[dict] = None,
                 adaptive: bool = False, k_min: int = 1,
                 acceptance_floor: float = 0.35,
                 acceptance_ceiling: float = 0.65,
                 adapt_every: int = 4,
                 share_embeddings: bool = True):
        if isinstance(k, bool) or not isinstance(k, numbers.Integral) \
                or k < 1:
            raise ValueError(f"speculate k must be an int >= 1, got {k!r}")
        self.k = int(k)
        self.adaptive = bool(adaptive)
        if isinstance(k_min, bool) or not isinstance(k_min, numbers.Integral) \
                or not 0 <= k_min <= k:
            raise ValueError(
                f"k_min must be an int in [0, k={k}], got {k_min!r}")
        self.k_min = int(k_min)
        for name, v in (("acceptance_floor", acceptance_floor),
                        ("acceptance_ceiling", acceptance_ceiling)):
            if not isinstance(v, numbers.Real) or isinstance(v, bool) \
                    or not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v!r}")
        if acceptance_floor > acceptance_ceiling:
            raise ValueError(
                f"acceptance_floor {acceptance_floor} > "
                f"acceptance_ceiling {acceptance_ceiling} (the hysteresis "
                f"band would thrash k every tick)")
        self.acceptance_floor = float(acceptance_floor)
        self.acceptance_ceiling = float(acceptance_ceiling)
        if isinstance(adapt_every, bool) \
                or not isinstance(adapt_every, numbers.Integral) \
                or adapt_every < 1:
            raise ValueError(
                f"adapt_every must be an int >= 1, got {adapt_every!r}")
        self.adapt_every = int(adapt_every)
        if proposer not in PROPOSERS:
            raise ValueError(f"unknown proposer {proposer!r}; one of "
                             f"{PROPOSERS}")
        self.proposer = proposer
        for name, v in (("ngram_max", ngram_max), ("ngram_min", ngram_min)):
            if isinstance(v, bool) or not isinstance(v, numbers.Integral) \
                    or v < 1:
                raise ValueError(f"{name} must be an int >= 1, got {v!r}")
        if ngram_min > ngram_max:
            raise ValueError(f"ngram_min {ngram_min} > ngram_max "
                             f"{ngram_max}")
        self.ngram_max = int(ngram_max)
        self.ngram_min = int(ngram_min)
        if proposer == "draft" and draft_model is None:
            raise ValueError(
                "proposer='draft' requires draft_model (a fused-decode-"
                "eligible small model)")
        self.draft_model = draft_model
        self.draft_state = draft_state
        self.share_embeddings = bool(share_embeddings)

    def to_config(self) -> dict:
        """JSON-serializable form (the draft model is not serializable)."""
        return {"k": self.k, "proposer": self.proposer,
                "ngram_max": self.ngram_max, "ngram_min": self.ngram_min,
                "adaptive": self.adaptive, "k_min": self.k_min,
                "acceptance_floor": self.acceptance_floor,
                "acceptance_ceiling": self.acceptance_ceiling,
                "adapt_every": self.adapt_every,
                "share_embeddings": self.share_embeddings}


def ngram_propose(history, lengths, k: int, nmax: int, nmin: int):
    """Device-side n-gram proposal (prompt-lookup decoding), vectorized
    over slots, on the device of ``history``.

    history (b, S) int — each row's committed tokens (prompt + generated)
    at indices ``[0, lengths[r])``; entries beyond are stale and never
    read. For the longest n in [nmin, nmax] whose length-n suffix of the
    committed sequence re-occurs ending strictly before the suffix itself,
    the MOST RECENT occurrence wins and the committed tokens that followed
    it become the proposal.

    Returns (proposals (b, k) int32, nprop (b,) int32); rows with no match
    (or too-short histories) propose nothing (nprop 0, zero padding).
    """
    b, S = history.shape
    dev = history.device
    lengths = lengths.to(torch.int64)
    pos_i = torch.arange(S, device=dev)[None]           # match END index i
    Lm1 = lengths[:, None] - 1                          # suffix end index
    best_idx = torch.full((b,), -1, dtype=torch.int64, device=dev)
    best_n = torch.zeros((b,), dtype=torch.int64, device=dev)
    for n in range(nmax, nmin - 1, -1):                 # longest wins
        eq = torch.ones((b, S), dtype=torch.bool, device=dev)
        for d in range(n):
            # history[i - d] == history[L-1 - d]; the roll wraps at the
            # left edge and the pos_i >= d mask kills the wrap
            shifted = torch.roll(history, d, dims=1)
            suf_d = torch.gather(history, 1, torch.clamp(Lm1 - d, min=0))
            eq = eq & (shifted == suf_d) & (pos_i >= d)
        valid = eq & (pos_i >= n - 1) & (pos_i < Lm1) & (Lm1 >= n)
        idx = torch.where(valid, pos_i, -1).amax(dim=1)
        take = (idx >= 0) & (best_n == 0)
        best_idx = torch.where(take, idx, best_idx)
        best_n = torch.where(take, n, best_n)
    start = best_idx + 1
    gidx = torch.clamp(start[:, None] + torch.arange(k, device=dev)[None],
                       0, S - 1)
    props = torch.gather(history, 1, gidx)
    nprop = torch.where(best_idx >= 0,
                        torch.clamp(lengths - start, 0, k), 0)
    props = torch.where(torch.arange(k, device=dev)[None] < nprop[:, None],
                        props, 0)
    return props.to(torch.int32), nprop.to(torch.int32)


def ngram_propose_host(tokens, k: int, nmax: int, nmin: int):
    """Plain-Python twin of :func:`ngram_propose` for one sequence — the
    readable specification the device matcher is tested against."""
    toks = [int(t) for t in tokens]
    L = len(toks)
    for n in range(nmax, nmin - 1, -1):
        if L - 1 < n:
            continue
        suffix = toks[L - n:]
        best = -1
        for i in range(n - 1, L - 1):                   # match END index
            if toks[i - n + 1:i + 1] == suffix:
                best = i                                # most recent wins
        if best >= 0:
            props = toks[best + 1:best + 1 + k]
            return (np.asarray(props + [0] * (k - len(props)), np.int32),
                    len(props))
    return np.zeros(k, np.int32), 0
