"""Continuous-batching serving engine over the paged decode kernel (K5).

Port of the core of ``paddle_tpu/serving/engine.py``. ``inference.generate``
runs one fixed batch to ``max_new_tokens``: a request that finishes early
burns decode steps, and one that arrives late waits for the whole batch.
This engine schedules at *slot* granularity over a shared paged KV pool:

* **join** — a queued request is admitted when a batch slot and enough
  pool blocks are free; admissions that land on the same tick with the same
  prefill shape share one batched prefill forward (the flash-attention
  kernel K1 on the card), reusing any content-hashed cached prefix blocks,
  and the slot joins the running decode batch;
* **leave** — a slot that hits eos, its token budget or its deadline
  retires at once: its blocks return to the pool the same tick;
* every decode tick is ONE ``fused_paged_decode_step`` for all slots,
  whatever their lengths (K5 on the card): per-row positions and block
  tables steer each row's append and attention.

Parity contract (tests/test_torch_serving.py): a request's tokens from a
merged run equal an isolated ``generate`` call and the JAX package's engine
— greedy and sampled, because row r draws token t from
``fold_in(PRNGKey(seed_r), t)`` whatever its batch neighbours.

Priority preemption with token-exact resume: when a higher-priority request
cannot be admitted, the lowest-priority slot is requeued with its tokens;
resume re-prefills the PROMPT, then REPLAYS the generated tokens one per
decode step (a replay through the prefill forward would round differently),
and continues sampling at ``fold_in(seed, count)``.

Device state: the engine keeps device twins of the block tables, positions,
last tokens, seeds and counts. They are uploaded from the host mirrors only
on a dirty tick (a join, a leave, a new block); the decode step advances
positions and counts on the device, so a steady tick uploads nothing and
its one sync is the pull of the (max_slots,) sampled ids.

Speculative decoding (``speculate=SpecConfig(k=...)``, the n-gram proposer,
optionally with per-slot adaptive k): every tick is ONE
``fused_paged_verify_step`` (K7 on the card) that scores each slot's last
token plus k proposals, samples position j at ``fold_in(seed, count + j)``
and commits the longest proposal prefix that matches, plus the next
sampled token. The committed tokens are the non-speculative engine's. The
committed-token history and the next tick's proposals stay on the device;
a steady speculative tick uploads nothing and pulls one (b, 2k+3) array.
An adaptive tick whose slots all sit at k = 0 runs the plain K5 step.

Int8 (``cache_dtype=torch.int8``, and/or a weight-only int8 llama from
``quantization.quantize_model``): the pool holds int8 KV with per-SLOT
scales (L, max_slots, 2*nkv*hd), calibrated at each request's prefill over
its original prompt positions (the scales an isolated ``generate`` with an
int8 cache computes), and the paged steps run K5's and K7's int8 modes.
Int8 blocks are never shared: the prefix cache keeps exact bf16 host copies
of the prompt blocks and a hit requantizes them with the adopting request's
own scales, so a hit saves prefill work but no pool capacity.

PyTorch runs eagerly, so the reference's jitted programs are plain methods
and its program cache has no counterpart. Not ported yet (each raises
NotImplementedError naming its ROADMAP item): chunked prefill, the draft
proposer, offload, tensor-parallel meshes, the sanitizer, bounded queues
and shedding, the flight recorder and snapshot/restore. Models of arch
llama and gpt ride the engine, as in the reference; any other arch (moe)
is refused with a ValueError.
The metrics registry and spans are left out; ``stats`` carries the counts.
"""

import heapq
import numbers
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.serving.pool import (SCRATCH_BLOCK, BlockPool,
                                           PoolExhausted, PrefixCache)
from paddle_tpu_torch.serving.spec import SpecConfig

__all__ = ["PRIORITIES", "Request", "RequestResult", "ServingEngine"]

#: admission classes, lowest to highest. The queue orders by (priority,
#: submit order); preemption only ever evicts a STRICTLY lower class, so
#: two requests of the same class can never ping-pong each other.
PRIORITIES = ("low", "normal", "high")
_PRIORITY_RANK = {p: i for i, p in enumerate(PRIORITIES)}

# module-wide request-id source, locked so concurrent submitters never mint
# the same id (results are keyed by it)
_req_id_state = {"next": 0}
_req_id_lock = threading.Lock()


def _next_req_id() -> int:
    with _req_id_lock:
        v = _req_id_state["next"]
        _req_id_state["next"] = v + 1
        return v


def _note_req_id(rid: int):
    """Keep the auto-id source ahead of every explicitly assigned id."""
    with _req_id_lock:
        if rid >= _req_id_state["next"]:
            _req_id_state["next"] = rid + 1


def _unported(what: str, item: str):
    return NotImplementedError(
        f"ServingEngine: {what} is not ported yet (ROADMAP {item})")


class _Ewma:
    """One exponentially-weighted moving average (a slot's speculative
    acceptance rate)."""

    __slots__ = ("alpha", "value")

    def __init__(self, alpha: float = 0.25):
        self.alpha = float(alpha)
        self.value: Optional[float] = None

    def update(self, x: float):
        self.value = (float(x) if self.value is None
                      else (1.0 - self.alpha) * self.value
                      + self.alpha * float(x))


class Request:
    """One generation request.

    Sampling knobs (temperature/top_k/top_p/eos) live on the engine. Per
    request: the prompt, the token budget, the RNG ``seed`` (defaults to an
    engine-assigned seed; pass the seed an isolated
    ``generate(..., request_seeds=[seed])`` call would use to reproduce it),
    an optional wall-clock ``deadline_s`` from submit (on expiry the request
    retires with the tokens it has) and a ``priority`` class (one of
    :data:`PRIORITIES`). Every argument is validated here with a plain
    ``ValueError``.
    """

    __slots__ = ("request_id", "prompt", "max_new_tokens", "seed",
                 "deadline_s", "priority", "_t_submit", "_t_first",
                 "_resume_tokens", "_seq")

    def __init__(self, prompt, max_new_tokens: int = 32,
                 seed: Optional[int] = None,
                 deadline_s: Optional[float] = None,
                 priority: str = "normal",
                 request_id: Optional[int] = None):
        prompt = np.asarray(prompt)
        if not np.issubdtype(prompt.dtype, np.integer):
            raise ValueError(
                f"prompt must hold integer token ids, got dtype "
                f"{prompt.dtype}")
        self.prompt = prompt.astype(np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        if isinstance(max_new_tokens, bool) \
                or not isinstance(max_new_tokens, numbers.Integral):
            raise ValueError(
                f"max_new_tokens must be an int, got "
                f"{type(max_new_tokens).__name__}")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        self.max_new_tokens = int(max_new_tokens)
        if seed is not None and (isinstance(seed, bool)
                                 or not isinstance(seed, numbers.Integral)):
            raise ValueError(f"seed must be an int or None, got "
                             f"{type(seed).__name__}")
        self.seed = None if seed is None else int(seed)
        if deadline_s is not None:
            if isinstance(deadline_s, bool) \
                    or not isinstance(deadline_s, numbers.Real):
                raise ValueError(f"deadline_s must be a number or None, "
                                 f"got {type(deadline_s).__name__}")
            if not deadline_s > 0:
                raise ValueError(
                    f"deadline_s must be > 0 (it is a wall-clock budget "
                    f"from submit), got {deadline_s}")
            deadline_s = float(deadline_s)
        self.deadline_s = deadline_s
        if priority not in _PRIORITY_RANK:
            raise ValueError(f"unknown priority {priority!r}; one of "
                             f"{PRIORITIES}")
        self.priority = priority
        if request_id is None:
            self.request_id = _next_req_id()
        else:
            self.request_id = int(request_id)
            _note_req_id(self.request_id)
        self._t_submit: Optional[float] = None
        # preempt/resume state: the generated-so-far tokens a requeued
        # request resumes from (None = fresh), and the original first-token
        # time so TTFT survives a preemption
        self._resume_tokens: Optional[List[int]] = None
        self._t_first: Optional[float] = None
        self._seq: int = 0          # engine submit ordinal (FIFO tiebreak)

    @property
    def rank(self) -> int:
        return _PRIORITY_RANK[self.priority]


class RequestResult:
    """Terminal state of a request. ``tokens`` are the generated ids (eos
    included when hit); ``gen_len`` counts tokens before the first eos, as
    ``generate(return_lengths=True)`` does. ``finish`` is one of ``eos`` /
    ``length`` / ``deadline``."""

    __slots__ = ("request_id", "prompt", "tokens", "gen_len", "finish",
                 "ttft_s", "tpot_s", "prefix_hit_blocks")

    def __init__(self, request_id, prompt, tokens, gen_len, finish,
                 ttft_s, tpot_s, prefix_hit_blocks):
        self.request_id = request_id
        self.prompt = prompt
        self.tokens = np.asarray(tokens, np.int32)
        self.gen_len = int(gen_len)
        self.finish = finish
        self.ttft_s = ttft_s
        self.tpot_s = tpot_s
        self.prefix_hit_blocks = prefix_hit_blocks

    @property
    def ids(self) -> np.ndarray:
        """prompt + generated tokens, the ``generate`` output row."""
        return np.concatenate([self.prompt, self.tokens])


class _Slot:
    __slots__ = ("req", "tok", "pos", "count", "tokens", "blocks", "ntab",
                 "worst_blocks", "t_first", "deadline_at",
                 "prefix_hit_blocks", "feed", "resume", "R")

    def __init__(self, req: Request, worst_blocks: int,
                 prefix_hit_blocks: int, feed: np.ndarray,
                 resume: Optional[List[int]]):
        self.req = req
        self.tok = 0            # last sampled, kv not yet appended
        self.pos = 0            # append position of the next decode step
        self.count = 0          # tokens generated so far
        self.tokens: List[int] = []
        self.blocks: List[int] = []     # owned pool refs (shared + private)
        self.ntab = 0                   # blocks allocated for this slot
        self.worst_blocks = worst_blocks
        self.t_first: Optional[float] = None
        self.deadline_at: Optional[float] = None
        self.prefix_hit_blocks = prefix_hit_blocks
        # what the prefill runs over: the PROMPT, for fresh and resumed
        # admissions alike (a resume's generated tokens replay through the
        # decode step afterwards, _replay_resume)
        self.feed = feed
        self.resume = resume            # generated-so-far tokens, or None
        self.R = 0                      # prefix-hit depth in tokens


class _PriorityQueue:
    """Priority-then-FIFO request queue: a heap ordered by
    (-priority_rank, submit_seq)."""

    def __init__(self):
        self._heap: List = []           # (neg_rank, seq, req)

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)

    def push(self, req: Request):
        heapq.heappush(self._heap, (-req.rank, req._seq, req))

    def peek(self) -> Optional[Request]:
        return self._heap[0][2] if self._heap else None

    def pop(self) -> Request:
        return heapq.heappop(self._heap)[2]


class ServingEngine:
    """Continuous-batching decode over a paged KV pool.

    ``max_slots`` is the decode batch width (one K5 call serves all
    slots: one launch up to 64 rows, consecutive launches over groups of
    rows beyond; a speculative tick's K7 call groups whole slots of k + 1
    tail rows the same way). The pool holds ``num_blocks`` blocks of
    ``block_tokens`` tokens — sized directly, by byte budget
    (``pool_bytes``), or defaulted to the worst case (every slot filled to
    ``max_seq_len``). Admission reserves each request's worst-case blocks
    (prompt + max_new) so lazy per-step block allocation can never fail
    mid-flight. ``device`` defaults to ``cuda`` (raises without a GPU); the
    model must live there. ``speculate=SpecConfig(...)`` arms speculative
    decoding with the n-gram proposer (see the module docstring).
    ``stats`` counts steps, tokens, prefill groups, replays, preemptions,
    speculative ticks, proposals and acceptances, and the wall seconds of
    each tick segment.
    """

    def __init__(self, model, *, max_slots: int = 4,
                 block_tokens: int = 128, num_blocks: Optional[int] = None,
                 pool_bytes: Optional[int] = None, max_seq_len: int = 1024,
                 cache_dtype=torch.bfloat16, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0,
                 eos_token_id: Optional[int] = None, seed: int = 0,
                 prefix_caching: bool = True,
                 prefix_cache_blocks: int = 256, device=None,
                 chunk_tokens: Optional[int] = None, speculate=None,
                 offload: bool = False, mesh=None, layout=None,
                 sanitize=False, max_queue: Optional[int] = None,
                 shed_infeasible: bool = False,
                 flight_dump_path: Optional[str] = None):
        for what, on, item in (
                ("chunked prefill (chunk_tokens)", chunk_tokens is not None,
                 "Queue A item 7: chunked prefill"),
                ("offload", bool(offload), "Queue A item 7: offload"),
                ("mesh / layout", mesh is not None or layout is not None,
                 "Queue A item 8"),
                ("sanitize", bool(sanitize),
                 "Queue A item 7: observability"),
                ("max_queue / shed_infeasible",
                 max_queue is not None or bool(shed_infeasible),
                 "Queue A item 7: overload control"),
                ("flight_dump_path", flight_dump_path is not None,
                 "Queue A item 7: observability")):
            if on:
                raise _unported(what, item)
        self.kv_int8 = cache_dtype == torch.int8
        if not self.kv_int8 \
                and torch.empty((), dtype=cache_dtype).element_size() != 2:
            raise ValueError(f"cache_dtype must be bf16-width or int8, got "
                             f"{cache_dtype}")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.model = model
        if model.device != self.device:
            raise ValueError(f"the model lives on {model.device}, the "
                             f"engine runs on {self.device}")
        state = model.state_dict(include_buffers=False)
        meta = (model.fused_decode_plan(state, probe=True)
                if hasattr(model, "fused_decode_plan") else None)
        if meta is None:
            raise ValueError(
                "ServingEngine needs a fused_decode_plan-eligible model "
                "(llama/gpt); this model/config cannot ride the paged "
                "kernel")
        self.arch = meta.get("arch", "llama")
        if self.arch not in ("llama", "gpt"):
            raise ValueError(
                f"paged serving supports arch llama/gpt, got {self.arch!r}")
        if max_seq_len % block_tokens:
            raise ValueError(
                f"max_seq_len {max_seq_len} must be a multiple of "
                f"block_tokens {block_tokens}")
        if speculate is not None:
            if not isinstance(speculate, SpecConfig):
                raise ValueError(
                    f"speculate must be a serving.SpecConfig, got "
                    f"{type(speculate).__name__}")
            if speculate.proposer == "draft":
                raise _unported("the draft proposer (SpecConfig(proposer="
                                "'draft'))",
                                "Queue A item 7: draft proposer")
            if speculate.k >= max_seq_len:
                raise ValueError(
                    f"speculate k {speculate.k} must be < max_seq_len "
                    f"{max_seq_len}")
        self.meta = meta
        # the plan's cache-width consistency check, per pool dtype
        self._blocks = (dict(meta["blocks"], cache_wbytes=1)
                        if self.kv_int8 else meta["blocks"])
        self.cache_dtype = cache_dtype
        self.block_tokens = int(block_tokens)
        self.max_seq_len = int(max_seq_len)
        self.max_slots = ms = int(max_slots)
        self.max_blocks_per_slot = max_seq_len // block_tokens
        L = self._num_layers = int(model.cfg.num_layers)
        nkv, hd = meta["num_kv_heads"], meta["head_dim"]
        self._dkv = nkv * hd
        bpb = self.block_bytes = (L * block_tokens * 2 * self._dkv
                                  * (1 if self.kv_int8 else 2))
        if num_blocks is None:
            if pool_bytes is not None:
                num_blocks = max(2, int(pool_bytes) // bpb)
            else:   # worst case: every slot filled to max_seq_len
                num_blocks = ms * self.max_blocks_per_slot + 1
        self.pool = BlockPool(num_blocks, block_tokens)
        from paddle_tpu_torch.ops.fused_decode import paged_pool_shape
        self.kv_pool = torch.zeros(
            paged_pool_shape(L, num_blocks, block_tokens, nkv, hd),
            dtype=cache_dtype, device=self.device)
        self.prefix_cache = (PrefixCache(self.pool, prefix_cache_blocks)
                             if prefix_caching else None)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.eos_token_id = eos_token_id
        self.seed = int(seed)
        self._seeds_issued = 0
        self._closed = False

        from paddle_tpu_torch.ops import rope as rope_ops
        self._cos_tab, self._sin_tab = rope_ops.rope_cos_sin(
            max_seq_len, hd, base=meta["rope_base"], device=self.device)
        # the stacked per-layer weights (a second copy of the layer
        # weights), embed and head, built once
        self._plan = model.fused_decode_plan(state)

        # host mirrors of the per-slot device state
        self._tables = np.full((ms, self.max_blocks_per_slot),
                               SCRATCH_BLOCK, np.int32)
        self._positions = np.zeros(ms, np.int32)
        self._toks = np.zeros(ms, np.int64)
        self._seeds = np.zeros(ms, np.int64)        # uint32 values
        self._counts = np.zeros(ms, np.int32)
        # the int8 pool's per-slot scales (a slot's row is written at its
        # adoption; ones until then)
        self._kv_scales = (np.ones((L, ms, 2 * self._dkv), np.float32)
                           if self.kv_int8 else None)
        # their device twins: re-uploaded only when a join/leave/new-block
        # event marks them dirty; the step advances positions/counts and
        # replaces the tokens on the device
        self._dev = None
        self._dev_scales = None
        self._dirty = True

        # speculative decoding: the per-slot proposal cap (the adaptive k;
        # k everywhere without adaptivity), per-slot k and acceptance EWMA,
        # the tick's tail width (max k over active slots), the host history
        # of committed tokens (ms, max_seq_len) the n-gram matcher runs
        # over, and the device twins of cap, history and the proposals the
        # last verify produced
        self.speculate = speculate
        self._spec_k = 0 if speculate is None else speculate.k
        self._spec_cap = self._spec_k_slot = self._spec_acc_ewma = None
        self._history = None
        if speculate is not None:
            self._spec_cap = np.full(ms, speculate.k, np.int32)
            self._spec_k_slot = np.full(ms, speculate.k, np.int32)
            self._spec_acc_ewma = [_Ewma() for _ in range(ms)]
            self._history = np.zeros((ms, max_seq_len), np.int32)
        self._spec_k_eff = 0
        self._last_spec_k = None
        self._spec_adapt_tick = 0
        self._prop_zeros: Dict[int, tuple] = {}
        self._dev_cap = self._dev_hist = self._dev_prop = None
        # k = 0 recovery probing (adaptive, k_min = 0): the wait counter and
        # the open two-tick window over the probed slots
        self._spec_probe_wait = 0
        self._probe_window = 0
        self._probe_slots: List[int] = []

        self._slots: List[Optional[_Slot]] = [None] * ms
        self._queue = _PriorityQueue()
        self._submit_seq = 0
        self.results: Dict[int, RequestResult] = {}
        self._reserved = 0      # blocks promised to in-flight slots
        self._finished_tick: List[int] = []
        self._tick_prefill_s = 0.0
        self.stats = self._fresh_stats()

    # ------------------------------------------------------------- helpers
    def _fresh_stats(self) -> Dict:
        """The cumulative stats dict. ``step_*_s`` are cumulative wall seconds per
        tick segment; ``prefill_groups`` counts batched prefill forwards."""
        return dict(steps=0, decode_tokens=0, idle_slot_steps=0,
                    prefill_tokens=0, prefill_tokens_reused=0,
                    prefill_groups=0, replay_tokens=0,
                    requests_finished=0, requests_admitted=0,
                    preemptions=0, requests_resumed=0,
                    spec_ticks=0, spec_proposed=0, spec_accepted=0,
                    spec_k_probes=0,
                    step_admit_s=0.0, step_prefill_s=0.0,
                    step_dispatch_s=0.0, step_sync_s=0.0)

    def _up(self, a) -> torch.Tensor:
        """A device copy of a host array. Always a copy (on the CPU too,
        where ``from_numpy`` would alias the mirror the host keeps
        mutating), and a blocking one: the source buffer may be reused as
        soon as this returns."""
        return torch.tensor(a, device=self.device)

    @property
    def active_slots(self) -> int:
        return sum(s is not None for s in self._slots)

    @property
    def queued(self) -> int:
        return len(self._queue)

    @property
    def idle(self) -> bool:
        return self.active_slots == 0 and not self._queue

    # ---------------------------------------------------------- submission
    def _check_fits(self, request: Request):
        P = len(request.prompt)
        worst = -(-(P + request.max_new_tokens - 1) // self.block_tokens)
        if worst > self.max_blocks_per_slot:
            raise ValueError(
                f"request needs {worst} blocks "
                f"({P}+{request.max_new_tokens} tokens) but max_seq_len "
                f"{self.max_seq_len} caps a slot at "
                f"{self.max_blocks_per_slot}")
        # optimistic: up to (P-1)//BT prompt blocks may be shared
        lookup = ((P - 1) // self.block_tokens
                  if self.prefix_cache is not None else 0)
        if worst - lookup > self.pool.num_blocks - 1:
            raise PoolExhausted(
                f"request needs at least {worst - lookup} blocks; the "
                f"whole pool has {self.pool.num_blocks - 1}")

    def _enqueue(self, request: Request) -> int:
        if request.seed is None:
            request.seed = self.seed + self._seeds_issued
            self._seeds_issued += 1
        request._t_submit = time.perf_counter()
        request._seq = self._submit_seq
        self._submit_seq += 1
        self._queue.push(request)
        return request.request_id

    def submit(self, request) -> int:
        """Queue a request (a :class:`Request` or a 1-D prompt). Returns
        the request id; the result lands in ``self.results``. Raises
        ``ValueError`` when the request cannot fit a slot and
        :class:`PoolExhausted` when it needs more than the whole pool."""
        if self._closed:
            raise RuntimeError("ServingEngine is closed")
        if not isinstance(request, Request):
            request = Request(request)
        self._check_fits(request)
        return self._enqueue(request)

    # ----------------------------------------------------------- admission
    def _admit(self):
        """Priority admission: while a slot and the head request's
        worst-case block reservation both fit, pop it into the current
        wave; the wave is grouped by prefill shape ``(R, s_pad)`` and each
        group runs as ONE batched prefill. When the head cannot be placed,
        strictly lower-priority slots are preempted (requeued resumable)
        to make room — first for a slot, then for blocks."""
        while self._queue:
            wave = []           # (slot_idx, slot, hits, R, s_pad)
            wave_idx = set()    # slots admitted this wave: not preemptable
            try:
                self._collect_wave(wave, wave_idx)
            except BaseException:
                self._unwind_wave(wave)
                raise
            if not wave:
                return
            self._dirty = True
            groups: Dict = {}
            for item in wave:
                groups.setdefault((item[3], item[4]), []).append(item)
            try:
                for (R, s_pad), grp in groups.items():
                    self._run_prefill_group(R, s_pad, grp)
            except BaseException:
                self._unwind_wave(wave)     # only count==0 slots unwind
                raise
            # an instantly-finished admission frees its slot: loop

    def _unwind_wave(self, wave):
        """Return every slot in ``wave`` whose prefill never ran to the
        queue, releasing its blocks and reservation."""
        for slot_idx, slot, _hits, _R, _s_pad in wave:
            if slot.count != 0 or self._slots[slot_idx] is not slot:
                continue
            req = slot.req
            self._release_slot(slot_idx)
            req._resume_tokens = slot.resume
            self._queue.push(req)
            self.stats["requests_admitted"] -= 1
            if slot.resume:
                self.stats["requests_resumed"] -= 1

    def _lookup(self, feed, n_lookup):
        return (self.prefix_cache.lookup(feed, n_lookup, record=False)
                if self.prefix_cache is not None else [])

    def _collect_wave(self, wave, wave_idx):
        """Pop admissible requests into ``wave`` (see :meth:`_admit`)."""
        BT = self.block_tokens
        while self._queue:
            req = self._queue.peek()
            rank = req.rank
            resume = req._resume_tokens
            # a resume prefills the PROMPT only; its generated tokens
            # replay through the decode step afterwards (_replay_resume)
            feed = req.prompt
            P = len(feed)
            n_lookup = (P - 1) // BT
            hits = self._lookup(feed, n_lookup)
            # worst case covers the FINAL sequence, identical for fresh
            # and resumed admissions
            worst = -(-(len(req.prompt) + req.max_new_tokens - 1) // BT)
            # bf16 hits ride the cached physical blocks; int8 hits only
            # skip prefill work (the slot allocates every prompt block)
            spare = 0 if self.kv_int8 else len(hits)
            short = worst - spare - (self.pool.free_blocks
                                     - self._reserved)
            if short > 0:
                # feasibility BEFORE destroying live work: preempting a
                # victim gains at most its full reservation, eviction at
                # most the cache-only blocks
                potential = sum(
                    s.worst_blocks for i, s in enumerate(self._slots)
                    if s is not None and i not in wave_idx
                    and s.req.rank < rank)
                if self.prefix_cache is not None:
                    potential += self.prefix_cache.evictable_count(
                        keep=hits)
                if short > potential:
                    break
            try:
                slot_idx = self._slots.index(None)
            except ValueError:
                victim = self._preempt_victim(rank, wave_idx)
                if victim is None:
                    break
                self._preempt(victim)
                slot_idx = victim
                # the preempt's cache insert may have evicted stale hits
                # and donated shareable blocks: re-probe
                hits = self._lookup(feed, n_lookup)
                spare = 0 if self.kv_int8 else len(hits)
            while True:
                short = (worst - spare
                         - (self.pool.free_blocks - self._reserved))
                if short <= 0:
                    break
                if self.prefix_cache is not None \
                        and self.prefix_cache.evict_free(short, keep=hits):
                    continue
                victim = self._preempt_victim(rank, wave_idx)
                if victim is None:
                    break
                self._preempt(victim)
                hits = self._lookup(feed, n_lookup)
                spare = 0 if self.kv_int8 else len(hits)
            if short > 0:
                break       # head-of-line within priority order
            self._queue.pop()
            req._resume_tokens = None   # consumed; _preempt re-sets
            if self.prefix_cache is not None:
                self.prefix_cache.commit(hits, n_lookup)

            R = len(hits) * BT
            n0 = -(-P // BT)        # blocks covering the feed
            s_pad = -(-(P - R) // BT) * BT
            slot = _Slot(req, worst, len(hits), feed, resume)
            slot.R = R
            if self.kv_int8:
                slot.blocks = self.pool.alloc(n0)
            else:
                for e in hits:  # the slot's own ref on shared blocks
                    self.pool.ref(e.block_id)
                slot.blocks = ([e.block_id for e in hits]
                               + self.pool.alloc(n0 - len(hits)))
            slot.ntab = n0
            row = self._tables[slot_idx]
            row[:] = SCRATCH_BLOCK
            row[:n0] = slot.blocks
            self._reserved += worst - n0
            self._slots[slot_idx] = slot
            self.stats["requests_admitted"] += 1
            if resume:
                self.stats["requests_resumed"] += 1
            wave.append((slot_idx, slot, hits, R, s_pad))
            wave_idx.add(slot_idx)

    # ------------------------------------------------------------- prefill
    def _prefill(self, R, s_pad, prefix, ids, last_idx, seeds, new_bids,
                 valid=None):
        """ONE batched prefill of ``n`` same-shape admissions (shared prefix
        depth ``R``, padded prompt tail ``s_pad``): fill a fresh contiguous
        cache with the prefix, run the cache forward at ``start_pos=R``
        (the flash-attention kernel on the card), sample each row's first
        token from its own last logits at ``fold_in(seed, 0)``, and scatter
        the new blocks into the pool. Pad tokens sit after the real ones,
        so the causal limit keeps them from every real token.

        bf16 pool: ``prefix`` holds the (n, R/BT) shared block ids, gathered
        from the pool; ``new_bids`` the blocks after them. Int8 pool: the
        cache is bf16, ``prefix`` holds the (L, n, R, 2*dkv) bf16 host
        copies of the hit blocks, and each row's scales are calibrated over
        its first ``valid[r]`` positions (its original prompt): amax per kv
        head, max(amax / 127, 1e-8) repeated over hd (``quantize_kv_cache``'s
        rule); every prompt block is quantized with them into ``new_bids``
        (n, n0). Returns the (n,) sampled ids on the device, and for int8
        also the (L, n, 2*dkv) scales and the bf16 cache."""
        from paddle_tpu_torch.inference import (_fold_rows, _row_keys,
                                                _sample_logits)
        n = ids.shape[0]
        BT = self.block_tokens
        dkv = self._dkv
        nkv, hd = self.meta["num_kv_heads"], self.meta["head_dim"]
        T = R + s_pad
        cache = self.model.init_cache(
            n, T, dtype=torch.bfloat16 if self.kv_int8 else self.cache_dtype)
        for l, c in enumerate(cache):
            if R:
                pk = (prefix[l] if self.kv_int8 else
                      self.kv_pool[l][prefix].reshape(n, R, 2 * dkv))
                c["k"][:, :R] = pk[:, :, :dkv].reshape(n, R, nkv, hd)
                c["v"][:, :R] = pk[:, :, dkv:].reshape(n, R, nkv, hd)
        out, cache = self.model(ids, cache=cache, start_pos=R)
        logits = out[torch.arange(n, device=self.device), last_idx]
        del out
        tok = _sample_logits(logits, _fold_rows(_row_keys(seeds), 0),
                             self.temperature, self.top_k, self.top_p)
        if self.kv_int8:
            lanes = torch.empty((len(cache), n, 2 * dkv),
                                dtype=torch.float32, device=self.device)
            mask = (torch.arange(T, device=self.device)[None]
                    < valid[:, None])[:, :, None]               # (n, T, 1)
            for l, c in enumerate(cache):   # one layer's temporaries
                kf = torch.cat([c["k"].reshape(n, T, dkv),
                                c["v"].reshape(n, T, dkv)], dim=-1).float()
                a = torch.where(mask, kf.abs(), 0.0).amax(dim=1)
                a = a.reshape(n, 2 * nkv, hd).amax(dim=-1)
                lanes[l] = torch.clamp(a / 127.0, min=1e-8) \
                    .repeat_interleave(hd, dim=-1)
                q = torch.clamp(torch.round(kf / lanes[l][:, None]), -127,
                                127)
                self.kv_pool[l, new_bids] = q.to(torch.int8).reshape(
                    n, T // BT, BT, 2 * dkv)
            return tok, lanes, cache
        nb = s_pad // BT
        for l, c in enumerate(cache):
            self.kv_pool[l, new_bids, :, :dkv] = \
                c["k"][:, R:].reshape(n, nb, BT, dkv)
            self.kv_pool[l, new_bids, :, dkv:] = \
                c["v"][:, R:].reshape(n, nb, BT, dkv)
        return tok

    def _run_prefill_group(self, R, s_pad, grp):
        """Run one batched prefill and adopt each row's slot into the
        running decode batch (timed as the tick's prefill segment)."""
        t_pf0 = time.perf_counter()
        n = len(grp)
        hb = R // self.block_tokens
        ids = np.zeros((n, s_pad), np.int64)
        last_idx = np.zeros(n, np.int64)
        seeds = np.zeros(n, np.int64)
        # int8 calibration runs over the ORIGINAL prompt positions only:
        # the whole feed for a fresh request; for a resume the scales the
        # uninterrupted run calibrated at its own prefill
        valid = np.zeros(n, np.int64)
        for r, (_, slot, _, _, _) in enumerate(grp):
            P = len(slot.feed)
            ids[r, :P - R] = slot.feed[R:]
            last_idx[r] = P - 1 - R
            seeds[r] = np.uint32(slot.req.seed)
            valid[r] = len(slot.req.prompt)
        lanes_np = cache = None
        if self.kv_int8:
            # no shared blocks: the prefix from the hits' bf16 host copies,
            # every prompt block freshly quantized
            new_bids = np.asarray([s.blocks for _, s, _, _, _ in grp],
                                  np.int64)
            prefix = (torch.stack([torch.cat(
                [e.kv_host.to(self.device) for e in hits], dim=1)
                for _, _, hits, _, _ in grp], dim=1) if hb else None)
            tok, lanes, cache = self._prefill(
                R, s_pad, prefix, self._up(ids), self._up(last_idx),
                self._up(seeds), self._up(new_bids), self._up(valid))
            lanes_np = lanes.cpu().numpy()  # once per group: the scales
        else:
            prefix = np.asarray([[e.block_id for e in hits]
                                 for _, _, hits, _, _ in grp],
                                np.int64).reshape(n, hb)
            new_bids = np.asarray([s.blocks[hb:] for _, s, _, _, _ in grp],
                                  np.int64)
            tok = self._prefill(R, s_pad, self._up(prefix), self._up(ids),
                                self._up(last_idx), self._up(seeds),
                                self._up(new_bids))
        tok_np = tok.cpu().numpy()      # once per group: the first tokens
        self.stats["prefill_groups"] += 1
        for r, (slot_idx, slot, _, _, _) in enumerate(grp):
            self._adopt_slot(slot_idx, slot, int(tok_np[r]),
                             None if lanes_np is None else lanes_np[:, r],
                             None if cache is None else (cache, r))
        self._tick_prefill_s += time.perf_counter() - t_pf0

    def _host_blocks(self, cache, r, c0, c1):
        """Exact bf16 host copies (L, BT, 2*dkv) of blocks c0 .. c1-1 of
        prefill row r (an int8 prefix-cache entry's ``kv_host``): one
        contiguous tensor a block, each its own copy (a view would keep the
        prefill cache alive). From a card they land in pinned memory: a
        copy into fresh pageable memory ran at about 2 GB/s on an H100
        host (examples/torch_int8_prefill_profile.py) and set the int8
        engine's time to first token."""
        BT, dkv = self.block_tokens, self._dkv
        out = []
        for i in range(c0, c1):
            t = slice(i * BT, (i + 1) * BT)
            blk = torch.stack([torch.cat(
                [c["k"][r, t].reshape(BT, dkv), c["v"][r, t].reshape(BT, dkv)],
                dim=-1) for c in cache])
            host = torch.empty(blk.shape, dtype=blk.dtype,
                               pin_memory=self.device.type == "cuda")
            out.append(host.copy_(blk))
        return out

    def _replay_resume(self, slot_idx: int, s: _Slot):
        """Replay a resumed request's generated-so-far tokens through the
        REAL decode step, one forced token per step, every other row idle
        against scratch: the same inputs at the same positions reproduce
        the uninterrupted run's KV (a decode row's result does not depend
        on its batch neighbours). ``len(resume) - 1`` steps per resume."""
        ms = self.max_slots
        for j, tok in enumerate(s.resume[:-1]):
            self._ensure_blocks(slot_idx)   # append position = s.pos
            # fresh host arrays per step, copied before use
            tables = np.full((ms, self.max_blocks_per_slot), SCRATCH_BLOCK,
                             np.int32)
            positions = np.zeros(ms, np.int32)
            toks = np.zeros(ms, np.int64)
            seeds = np.zeros(ms, np.int64)
            counts = np.zeros(ms, np.int32)
            seeds[slot_idx] = np.uint32(s.req.seed)
            tables[slot_idx, :s.ntab] = s.blocks
            positions[slot_idx] = s.pos
            toks[slot_idx] = int(tok)
            counts[slot_idx] = j + 1
            self._decode(*(self._up(a) for a in
                           (tables, positions, toks, seeds, counts)),
                         kv_scales=self._up_scales())
            s.pos += 1
        self.stats["replay_tokens"] += len(s.resume) - 1

    def _adopt_slot(self, slot_idx: int, s: _Slot, tok: int,
                    lanes_row=None, kv_src=None):
        """Join a prefilled slot to the running decode batch: the int8
        slot's scale row (``lanes_row`` (L, 2*dkv), before any replay),
        resume/TTFT bookkeeping, the prefix-cache insert (int8: host copies
        of the prompt blocks from ``kv_src`` = (prefill cache, row)) and
        instant finishes. A FRESH request's prefill sample is its first
        generated token; a resumed slot's sample is discarded — its next
        token comes from the next decode step at ``fold_in(seed, count)``."""
        req = s.req
        P = len(s.feed)
        BT = self.block_tokens
        self._dirty = True
        if lanes_row is not None:
            self._kv_scales[:, slot_idx, :] = lanes_row
        s.pos = P
        if s.resume:
            s.count = len(s.resume)
            s.tok = int(s.resume[-1])
            s.tokens = list(s.resume)
            s.t_first = (req._t_first if req._t_first is not None
                         else time.perf_counter())
            self._replay_resume(slot_idx, s)    # s.pos -> P + count - 1
        else:
            s.count = 1
            s.tok = int(tok)
            s.tokens = [s.tok]
            s.t_first = time.perf_counter()
        if req.deadline_s is not None and s.deadline_at is None:
            s.deadline_at = req._t_submit + req.deadline_s
        self._positions[slot_idx] = s.pos
        self._toks[slot_idx] = s.tok
        self._seeds[slot_idx] = np.uint32(req.seed)
        self._counts[slot_idx] = s.count
        if self._history is not None:
            # the committed tokens: the prompt, the replayed resume prefix
            # and the slot's current last token, the suffix the n-gram
            # matcher extends
            hist = (s.feed if not s.resume else np.concatenate(
                [s.feed, np.asarray(s.resume[:-1], np.int32)]))
            self._history[slot_idx][:] = 0
            self._history[slot_idx, :len(hist)] = hist
            self._history[slot_idx,
                          min(len(hist), self.max_seq_len - 1)] = s.tok
        self.stats["prefill_tokens"] += P - s.R
        self.stats["prefill_tokens_reused"] += s.R
        if self.prefix_cache is not None:
            # full feed blocks are append-proof (appends land at pos >= P):
            # shared as they are, copy-on-write by construction. Inserted
            # AFTER the prefill, so a same-wave sibling never hits blocks
            # not written yet (it misses; the next wave sees them).
            nh = s.prefix_hit_blocks
            if self.kv_int8:
                if P // BT > nh:
                    self.prefix_cache.insert(s.feed, nh,
                                             kv_host=self._host_blocks(
                                                 *kv_src, nh, P // BT))
            else:
                self.prefix_cache.insert(s.feed, nh,
                                         block_ids=s.blocks[nh:P // BT])
        eos = self.eos_token_id
        if (eos is not None and s.tok == int(eos)) \
                or s.count >= req.max_new_tokens:
            self._retire(slot_idx,
                         "eos" if eos is not None
                         and s.tok == int(eos) else "length")

    # -------------------------------------------------------------- decode
    def _up_scales(self):
        """The int8 pool's per-slot scales on the device (None for bf16)."""
        return None if self._kv_scales is None else self._up(self._kv_scales)

    def _decode(self, tables, positions, toks, seeds, counts,
                kv_scales=None):
        """One paged decode step for every slot (K5 on the card): embed,
        rope rows at each row's position, ``fused_paged_decode_step`` (the
        int8 pool with the slots' ``kv_scales``), head, and per-row
        sampling at ``fold_in(key(seed_r), count_r)``.
        Everything stays on the device. Returns (sampled ids, positions
        + 1 clamped at max_seq_len - 1, counts + 1); the clamp only binds
        on idle rows, keeping their table lookups in range."""
        from paddle_tpu_torch.inference import (_fold_rows, _row_keys,
                                                _sample_logits)
        from paddle_tpu_torch.ops.fused_decode import fused_paged_decode_step
        plan, meta = self._plan, self.meta
        x = plan["embed"](toks, positions)
        cos = self._cos_tab.index_select(0, positions)
        sin = self._sin_tab.index_select(0, positions)
        x, self.kv_pool = fused_paged_decode_step(
            x, plan["params"], self.kv_pool, tables, positions, cos, sin,
            num_heads=meta["num_heads"], num_kv_heads=meta["num_kv_heads"],
            eps=meta["eps"], arch=self.arch, blocks=self._blocks,
            kv_scales=kv_scales)
        # greedy draws no randomness: skip the key fold
        keys = (_fold_rows(_row_keys(seeds), counts)
                if self.temperature != 0.0 else None)
        nxt = _sample_logits(plan["head"](x), keys, self.temperature,
                             self.top_k, self.top_p)
        pos2 = torch.clamp(positions + 1, max=self.max_seq_len - 1)
        return nxt, pos2, counts + 1

    # ---------------------------------------------------- speculative decode
    def _verify(self, tables, positions, toks, seeds, counts, props, nprop,
                cap, K: int, kv_scales=None):
        """One speculative verify for every slot (K7 on the card): embed
        the K+1-token tail (last sampled token + K proposals) at positions
        ``pos + j`` (rope rows at ``min(pos + j, max_seq_len - 1)``; the
        clamp binds only on over-speculation, garbage rows), score it
        through ``fused_paged_verify_step``, apply the head to all
        (b·(K+1), h) rows at once, sample position j at
        ``fold_in(seed, count + j)`` (the key the plain step folds for
        that token), and accept the longest proposal prefix that matches.
        Then advance positions, counts and the last token, write the tail
        and the next token into the device history, and run the n-gram
        matcher for the next tick's proposals — all on the device.
        Returns (g (b, K+1), acc (b,), pos2, tok2, counts2, prop2,
        nprop2)."""
        from paddle_tpu_torch.inference import (_fold_rows, _row_keys,
                                                _sample_logits)
        from paddle_tpu_torch.ops.fused_decode import fused_paged_verify_step
        from paddle_tpu_torch.serving.spec import ngram_propose
        plan, meta, sc = self._plan, self.meta, self.speculate
        ms, K1 = self.max_slots, K + 1
        pos_cap = self.max_seq_len - 1
        offs = torch.arange(K1, device=self.device)
        tail = torch.cat([toks[:, None], props.to(toks.dtype)], dim=1)
        pj = torch.clamp(positions[:, None].long() + offs[None], max=pos_cap)
        x = plan["embed"](tail.reshape(-1), pj.reshape(-1)).reshape(
            ms, K1, -1)
        x, self.kv_pool = fused_paged_verify_step(
            x, plan["params"], self.kv_pool, tables, positions,
            self._cos_tab[pj], self._sin_tab[pj],
            num_heads=meta["num_heads"], num_kv_heads=meta["num_kv_heads"],
            eps=meta["eps"], arch=self.arch, blocks=self._blocks,
            kv_scales=kv_scales)
        keys = (_fold_rows(_row_keys(seeds).repeat_interleave(K1, dim=0),
                           (counts[:, None] + offs[None]).reshape(-1))
                if self.temperature != 0.0 else None)
        g = _sample_logits(plan["head"](x.reshape(ms * K1, -1)), keys,
                           self.temperature, self.top_k,
                           self.top_p).reshape(ms, K1)
        # the per-slot proposal cap: the adaptive k (k when not adaptive)
        nprop_eff = torch.clamp(torch.minimum(nprop, cap), max=K)
        match = (props.to(g.dtype) == g[:, :K]) \
            & (offs[None, :K] < nprop_eff[:, None])
        acc = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
        tok2 = torch.gather(g, 1, acc[:, None])[:, 0]
        pos2 = torch.clamp(positions + acc + 1, max=pos_cap).to(
            positions.dtype)
        counts2 = (counts + acc + 1).to(counts.dtype)
        # committed-token history: the tail at its absolute indices, then
        # the next token at pos2; writes past the accepted prefix sit
        # beyond the committed length, like rejected KV
        rows = torch.arange(ms, device=self.device)
        hist = self._dev_hist
        hist[rows[:, None], pj] = tail.to(hist.dtype)
        hist[rows, pos2.long()] = tok2.to(hist.dtype)
        prop2, nprop2 = ngram_propose(hist, pos2 + 1, K, sc.ngram_max,
                                      sc.ngram_min)
        return g, acc, pos2, tok2, counts2, prop2, torch.minimum(nprop2, cap)

    def _prop_zero(self, K: int):
        """The (proposals, nprop) reset pair for tail width ``K``, built
        once per width: a dirty tick re-arms the proposer with it."""
        z = self._prop_zeros.get(K)
        if z is None:
            z = (torch.zeros((self.max_slots, K), dtype=torch.int32,
                             device=self.device),
                 torch.zeros((self.max_slots,), dtype=torch.int32,
                             device=self.device))
            self._prop_zeros[K] = z
        return z

    def _current_spec_k(self, active) -> int:
        """This tick's verify-tail width: the configured k, or with
        adaptive speculation the MAX per-slot k (or probe cap) over the
        active slots; slots below it are capped through ``cap``. 0 means
        the tick runs the plain per-token step."""
        if not self.speculate.adaptive:
            return self._spec_k
        return int(max(max(int(self._spec_k_slot[i]),
                           int(self._spec_cap[i])) for i in active))

    def _maybe_probe(self, active):
        """k = 0 recovery probing, at the top of every tick of an adaptive
        engine: a slot parked at ``k_min = 0`` proposes nothing, so its
        EWMA could never observe again. Every ``adapt_every`` consecutive
        parked ticks, raise each parked active slot's cap to ONE for a
        two-tick window: the first (dirty) tick re-zeroes the carried
        proposals and primes the matcher, the second verifies a real
        one-token proposal and feeds the EWMA. ``spec_k_probes`` counts
        probed slots."""
        if self._probe_window > 0:
            # the window lives only while a probed slot is active (a
            # retirement mid-window resets its cap in _release_slot)
            if any(self._slots[i] is not None for i in self._probe_slots):
                return
            self._probe_window = 0
            self._probe_slots = []
            return
        parked = [i for i in active if self._spec_k_slot[i] == 0]
        if not parked:
            self._spec_probe_wait = 0
            return
        self._spec_probe_wait += 1
        if self._spec_probe_wait < self.speculate.adapt_every:
            return
        self._spec_probe_wait = 0
        self._probe_window = 2
        self._probe_slots = list(parked)
        for i in parked:
            self._spec_cap[i] = 1
        self._dirty = True
        self.stats["spec_k_probes"] += len(parked)

    def _close_probe_window(self):
        """End-of-spec-tick bookkeeping of an open probe window: when it
        closes, parked slots drop back to their k, unless the adapt step
        climbed it in between."""
        if self._probe_window <= 0:
            return
        self._probe_window -= 1
        if self._probe_window:
            return
        changed = False
        for i in self._probe_slots:
            if self._slots[i] is not None \
                    and int(self._spec_cap[i]) != int(self._spec_k_slot[i]):
                self._spec_cap[i] = int(self._spec_k_slot[i])
                changed = True
        self._probe_slots = []
        if changed:
            self._dirty = True

    def _adapt_spec_k(self, active, acc_np, nprop_np):
        """Per-slot adaptive-k update off the acceptance EWMA, at the end of
        each speculative tick. A k change is an event: the cap re-uploads
        and the proposals re-zero on the next tick."""
        sc = self.speculate
        K_eff = self._spec_k_eff
        for i in active:
            if self._slots[i] is None:      # retired in this tick's commit
                continue
            neff = min(int(nprop_np[i]), int(self._spec_cap[i]), K_eff)
            if neff > 0:
                self._spec_acc_ewma[i].update(int(acc_np[i]) / neff)
        self._spec_adapt_tick += 1
        if self._spec_adapt_tick % sc.adapt_every:
            return
        changed = False
        for i in active:
            if self._slots[i] is None:
                continue
            ew = self._spec_acc_ewma[i].value
            if ew is None:
                continue
            k_i = int(self._spec_k_slot[i])
            if ew < sc.acceptance_floor and k_i > sc.k_min:
                k_i -= 1
            elif ew > sc.acceptance_ceiling and k_i < sc.k:
                k_i += 1
            else:
                continue
            self._spec_k_slot[i] = k_i
            self._spec_cap[i] = k_i
            changed = True
        if changed:
            self._dirty = True

    def _ensure_blocks(self, slot_idx: int, horizon: int = 0):
        """Append positions [pos, pos + horizon] must resolve to allocated
        blocks: allocate lazily as a slot crosses a block boundary
        (admission reserved the worst case, so this cannot exhaust the
        pool). ``horizon`` is the speculative append depth (k tail tokens
        beyond the base append); allocation never exceeds the slot's
        reservation, and over-speculation past it lands in the scratch
        block through the table."""
        s = self._slots[slot_idx]
        c = min((s.pos + horizon) // self.block_tokens, s.worst_blocks - 1)
        while s.ntab <= c:
            bid = self.pool.alloc(1)[0]
            s.blocks.append(bid)
            self._tables[slot_idx][s.ntab] = bid
            s.ntab += 1
            self._reserved -= 1
            self._dirty = True

    # ---------------------------------------------------------- retirement
    def _release_slot(self, slot_idx: int):
        """Free a slot's blocks and reservation and zero its table row and
        mirrors — the ONE teardown behind retire, preempt and unwind."""
        s = self._slots[slot_idx]
        for bid in s.blocks:
            self.pool.free(bid)
        if self._history is not None:
            self._history[slot_idx][:] = 0
            # a fresh occupant starts at the configured k, optimistic
            self._spec_cap[slot_idx] = self._spec_k
            self._spec_k_slot[slot_idx] = self._spec_k
            self._spec_acc_ewma[slot_idx] = _Ewma()
        self._reserved -= s.worst_blocks - s.ntab
        self._slots[slot_idx] = None
        self._tables[slot_idx][:] = SCRATCH_BLOCK
        self._positions[slot_idx] = 0
        self._toks[slot_idx] = 0
        self._counts[slot_idx] = 0
        self._dirty = True

    def _preempt_victim(self, rank: int, exclude) -> Optional[int]:
        """Slot index of the lowest-priority, loosest-deadline active slot
        with priority STRICTLY below ``rank``; ``exclude`` holds this
        wave's freshly admitted slots (nothing to resume from)."""
        best = best_key = None
        for i, s in enumerate(self._slots):
            if s is None or i in exclude or s.req.rank >= rank:
                continue
            slack = (float("inf") if s.deadline_at is None
                     else s.deadline_at)
            key = (s.req.rank, -slack)
            if best_key is None or key < best_key:
                best, best_key = i, key
        return best

    def _preempt(self, slot_idx: int):
        """Requeue a slot with its generated-so-far tokens: donate its full
        (immutable) blocks to the prefix cache so the resume prefill reuses
        the prompt's, free the rest, and push the request back."""
        s = self._slots[slot_idx]
        req = s.req
        req._resume_tokens = list(s.tokens)
        req._t_first = s.t_first
        if self.prefix_cache is not None and not self.kv_int8:
            # feed = prompt + generated[:-1]: exactly the s.pos written
            # positions; its full blocks are append-proof (an int8 pool's
            # blocks carry the slot's own scales: nothing to donate)
            full = s.pos // self.block_tokens
            if full:
                self.prefix_cache.insert(
                    np.concatenate([req.prompt, np.asarray(
                        s.tokens[:-1], np.int32)]),
                    0, block_ids=s.blocks[:full])
        self._release_slot(slot_idx)
        self._queue.push(req)
        self.stats["preemptions"] += 1

    def _retire(self, slot_idx: int, finish: str) -> RequestResult:
        s = self._slots[slot_idx]
        now = time.perf_counter()
        self._release_slot(slot_idx)
        toks = np.asarray(s.tokens, np.int32)
        eos = self.eos_token_id
        if eos is not None and (toks == int(eos)).any():
            gen_len = int((toks == int(eos)).argmax())
        else:
            gen_len = len(toks)
        ttft = (s.t_first - s.req._t_submit if s.t_first is not None
                else None)
        tpot = ((now - s.t_first) / (s.count - 1) if s.count > 1 else None)
        res = RequestResult(s.req.request_id, s.req.prompt, toks, gen_len,
                            finish, ttft, tpot, s.prefix_hit_blocks)
        self.results[s.req.request_id] = res
        self._finished_tick.append(s.req.request_id)
        self.stats["requests_finished"] += 1
        return res

    # ----------------------------------------------------------------- tick
    def step(self) -> Dict:
        """One scheduler tick: admit what fits (batched prefills), retire
        expired deadlines, run ONE paged decode step for every active slot,
        retire the slots that finished. Returns
        ``dict(active, queued, finished)``."""
        if self._closed:
            raise RuntimeError("ServingEngine is closed")
        self._finished_tick = []
        self._tick_prefill_s = 0.0
        t0 = time.perf_counter()
        with torch.no_grad():
            self._admit()
            now = time.perf_counter()
            for i, s in enumerate(self._slots):
                if s is not None and s.deadline_at is not None \
                        and now > s.deadline_at:
                    self._retire(i, "deadline")
            active = [i for i, s in enumerate(self._slots) if s is not None]
            spec_tick = False
            if active:
                if self.speculate is not None:
                    if self.speculate.adaptive:
                        self._maybe_probe(active)
                    self._spec_k_eff = K_eff = self._current_spec_k(active)
                    spec_tick = K_eff > 0
                    if K_eff != self._last_spec_k:
                        # a changed tail width is an event: the carried
                        # proposals re-zero at the new width
                        self._dirty = True
                        self._last_spec_k = K_eff
                for i in active:
                    self._ensure_blocks(i, self._spec_k)
                if self._dirty:
                    self._dev = tuple(self._up(a) for a in (
                        self._tables, self._positions, self._toks,
                        self._seeds, self._counts))
                    self._dev_scales = self._up_scales()
                    if self.speculate is not None:
                        # a join/leave tick drops the carried proposals:
                        # the matcher re-primes them at the end of this
                        # tick's verify (one proposal-free tick per event)
                        self._dev_hist = self._up(self._history)
                        self._dev_prop = (self._prop_zero(K_eff)
                                          if spec_tick else None)
                        self._dev_cap = self._up(self._spec_cap)
                    self._dirty = False
            t_d0 = time.perf_counter()
            self.stats["step_admit_s"] += t_d0 - t0 - self._tick_prefill_s
            self.stats["step_prefill_s"] += self._tick_prefill_s
            if spec_tick:
                self._spec_decode(active, t_d0)
            elif active:
                self._plain_decode(active, t_d0)
        return dict(active=self.active_slots, queued=len(self._queue),
                    finished=self._finished_tick)

    def _plain_decode(self, active, t_d0):
        """One decode dispatch over the device twins and its host commit
        (the tick's one sync: the pull of the sampled ids)."""
        tables, positions, toks, seeds, counts = self._dev
        nxt, pos2, cnt2 = self._decode(tables, positions, toks, seeds,
                                       counts, self._dev_scales)
        self._dev = (tables, pos2, nxt, seeds, cnt2)
        t_s0 = time.perf_counter()
        nxt_np = nxt.cpu().numpy()
        st = self.stats
        st["step_dispatch_s"] += t_s0 - t_d0
        st["step_sync_s"] += time.perf_counter() - t_s0
        st["steps"] += 1
        st["decode_tokens"] += len(active)
        st["idle_slot_steps"] += self.max_slots - len(active)
        eos = self.eos_token_id
        for i in active:
            s = self._slots[i]
            tok = int(nxt_np[i])
            s.tokens.append(tok)
            s.tok = tok
            s.pos += 1
            s.count += 1
            if self._history is not None:
                # an adaptive engine's plain (k = 0) tick keeps the host
                # history current; the device twin refreshes on the next
                # event tick's upload
                self._history[i, min(s.pos, self.max_seq_len - 1)] = tok
            self._positions[i] = s.pos
            self._toks[i] = tok
            self._counts[i] = s.count
            if eos is not None and tok == int(eos):
                self._retire(i, "eos")
            elif s.count >= s.req.max_new_tokens:
                self._retire(i, "length")

    def _spec_decode(self, active, t_d0):
        """One speculative tick: the verify over the device twins, ONE pull
        of (g, acc, proposals, nprop), then the host commit of each slot's
        accepted prefix and its next token. The commit stops at eos or
        ``max_new_tokens`` inside an accepted run; a retirement marks the
        mirrors dirty like any leave."""
        tables, positions, toks, seeds, counts = self._dev
        props, nprop = self._dev_prop
        K = self._spec_k_eff
        K1 = K + 1
        g, acc, pos2, tok2, cnt2, prop2, nprop2 = self._verify(
            tables, positions, toks, seeds, counts, props, nprop,
            self._dev_cap, K, self._dev_scales)
        self._dev = (tables, pos2, tok2, seeds, cnt2)
        self._dev_prop = (prop2, nprop2)
        t_s0 = time.perf_counter()
        pulled = torch.cat([g, acc[:, None].long(), props.long(),
                            nprop[:, None].long()], dim=1).cpu().numpy()
        g_np, acc_np = pulled[:, :K1], pulled[:, K1]
        prop_np, nprop_np = pulled[:, K1 + 1:K1 + 1 + K], pulled[:, -1]
        st = self.stats
        st["step_dispatch_s"] += t_s0 - t_d0
        st["step_sync_s"] += time.perf_counter() - t_s0
        st["steps"] += 1
        st["spec_ticks"] += 1
        st["idle_slot_steps"] += self.max_slots - len(active)
        pos_cap = self.max_seq_len - 1
        eos = self.eos_token_id
        for i in active:
            s = self._slots[i]
            a = int(acc_np[i])
            # the EFFECTIVE proposal count the verify considered
            st["spec_proposed"] += min(int(nprop_np[i]),
                                       int(self._spec_cap[i]), K)
            st["spec_accepted"] += a
            for tok in [int(t) for t in prop_np[i, :a]] + [int(g_np[i, a])]:
                s.tokens.append(tok)
                s.tok = tok
                s.pos += 1
                s.count += 1
                st["decode_tokens"] += 1
                self._history[i, min(s.pos, pos_cap)] = tok
                self._positions[i] = s.pos
                self._toks[i] = tok
                self._counts[i] = s.count
                if eos is not None and tok == int(eos):
                    self._retire(i, "eos")
                    break
                if s.count >= s.req.max_new_tokens:
                    self._retire(i, "length")
                    break
        if self.speculate.adaptive:
            self._adapt_spec_k(active, acc_np, nprop_np)
            self._close_probe_window()

    # ------------------------------------------------------------- results
    def pop_result(self, request_id: int) -> RequestResult:
        """Remove and return a finished request's result."""
        return self.results.pop(request_id)

    def drain(self, max_steps: Optional[int] = None) -> Dict[int,
                                                             RequestResult]:
        """Step until every submitted request has finished (or
        ``max_steps`` elapsed). Returns ``self.results``. Raises
        :class:`PoolExhausted` on a stall: a step that began with every
        slot free and still admitted nothing."""
        steps = 0
        while not self.idle:
            q0 = len(self._queue) if self.active_slots == 0 else -1
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
            if q0 > 0 and self.active_slots == 0 and len(self._queue) == q0:
                head = self._queue.peek()
                raise PoolExhausted(
                    f"drain stalled: request {head.request_id} "
                    f"({len(head.prompt)}+{head.max_new_tokens} tokens) "
                    f"cannot be admitted even with an idle engine")
        return self.results

    def generate(self, prompts: Sequence, **req_kwargs) -> List[np.ndarray]:
        """Batch convenience: submit every prompt, drain, return the
        ``prompt+tokens`` id rows in submission order."""
        ids = [self.submit(Request(np.asarray(p).reshape(-1), **req_kwargs))
               for p in prompts]
        self.drain()
        return [self.results[i].ids for i in ids]

    def close(self):
        """Release the pool, the stacked weights and the device twins;
        queued and in-flight requests are dropped. Idempotent; a closed
        engine rejects ``submit``/``step``."""
        if self._closed:
            return
        self._closed = True
        if self.prefix_cache is not None:
            self.prefix_cache.clear()
        self.kv_pool = None
        self._plan = None
        self._dev = self._dev_scales = None
        self._dev_hist = self._dev_prop = self._dev_cap = None
        self._prop_zeros = {}
        self._cos_tab = self._sin_tab = None
        self._slots = [None] * self.max_slots
        self._queue = _PriorityQueue()

    def snapshot(self) -> Dict:
        raise _unported("snapshot", "Queue A item 7: snapshot/restore")

    def save_snapshot(self, root: str) -> str:
        raise _unported("save_snapshot", "Queue A item 7: snapshot/restore")

    @classmethod
    def restore(cls, model, source, **kw):
        raise _unported("restore", "Queue A item 7: snapshot/restore")
