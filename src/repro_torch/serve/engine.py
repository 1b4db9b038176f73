"""Continuous-batching fleet serving engine — port of ``repro.serve.engine``.

The reference keeps ONE compiled decode step hot under churn (ragged
arrivals, ragged lengths): per-slot state lives on the device, sampling
and next-feed selection run inside the step, admission is a masked merge
at the top of the same step, and the KV cache and slot state are donated,
so a steady step copies no cache. The port keeps that contract:

  * **per-slot state lives on the device** — position, prompt buffer,
    prompt length, tokens-remaining budget, active mask, feed token and the
    per-request sample key are (B,)-shaped tensors the engine allocates
    once and the step updates in place;
  * **sampling and next-feed selection run inside the step** — the host
    never sees logits; each step writes four (B,) values (sampled token,
    emitted / finished / truncated flags) that the host drains with a
    one-step lag, so bookkeeping overlaps device work;
  * **admission is a masked merge at the top of the SAME step** — freed
    slots take queued prompts through a staged ``(mask, evict, plen,
    budget, key, prompt)`` buffer that the step consumes and clears, so
    admit / evict / cancel / refresh / recompact reuse one step;
  * **the cache is written in place** (``models.transformer.decode_step_``)
    — the counterpart of the reference's donation: a steady step copies no
    cache, and the cache tensors keep their addresses for the engine's
    whole life.

Dispatch goes by the device of the loaded parameters. On CPU tensors the
step runs eagerly and ``n_traces`` counts how many times it was built (once,
and again only after a ``load`` of a tree with other shapes, dtypes or
structure, as a retrace in JAX). On CUDA tensors the first ``step`` warms
the step up on clones of the live state, on the engine's stream, then
captures it into one ``torch.cuda.CUDAGraph``; every later ``step`` replays
it, and ``n_traces`` counts captures. A failed capture raises: there is no
eager fallback. ``load`` / ``refresh`` / ``recompact`` copy the new values
(the compact tree's int32 ``sel`` riders too) into the tensors the graph
reads, so ``engine.params`` is always the graph's own tree. Admission
buffers go to the card from pinned host memory (two buffers, each reused
only after the event of its last copy has fired), and the four outputs come
back to a pinned ring with one event a step, which the drain waits on.

Rows are independent through the decode step (per-row positions, per-row
cache masks), so a request admitted into a freed slot mid-flight produces
exactly the tokens a solo run of its prompt at the same batch width
produces. Scan-state (SSM / hybrid) cache leaves are recurrent rather than
position-indexed, so slot reuse zeroes the admitted rows of those leaves
inside the step; position-indexed KV leaves are self-cleaning.

Sampling. Temperature 0 is ``argmax`` inside the step, equal to the
reference token for token. At temperature > 0 the reference draws with
``jax.random.fold_in(key, pos)`` and ``categorical``, whose threefry stream
torch cannot reproduce. The port draws by Gumbel-max from a counter-based
hash: the uniform for (row key, row position, vocab index) is murmur3's
32-bit finalizer chained over those counters, computed in int64 tensor ops
that keep every value in [0, 2**32) (so each ``>>`` is a logical shift and
no product overflows), and bit-equal on the CPU and the card. It needs no
generator state and depends only on the request's own key and position, so
continuous == solo holds by construction. The stream differs from JAX's;
the distribution, ``softmax(logits / T)``, is the same.

Over a mesh (``mesh`` / ``rules``, the reference's shard_map'd step): the
B slots are laid out over the mesh axes that the rules assign to "batch"
(B must divide), and each rank holds its B / D of them: the cache's rows
(dim 1 of the layer-stacked ``blocks`` leaves, dim 0 of the others), the
slot state and the admission buffer. Params are replicated (every rank
loads the whole tree), so each rank's step is the one-device step on its
rows, captured into its own CUDA graph on the card, and holds no
collective. The host bookkeeping runs the same on every rank: every rank
makes the same ``submit`` / ``cancel`` / ``refresh`` / ``recompact``
calls, so the queue, the slot assignment and the admission merge are the
same everywhere (the reference's single controller), and each rank stages
its rows of the merge. The step's packed (4, B / D) outputs reach every
rank by one all-gather over the batch axes a step, outside the graph, on
the host copies at drain time (``dist.sharding.gather_rows``, counted
``engine_out_gather``; its seconds in ``stats()["exchange_s"]``).

``step_hlo`` has no counterpart: it returns the reference's compiled XLA
text, and the port has no compiler; its tests read the cache's addresses
instead.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .._tree import flatten_with_path, leaves, tree_map
from ..models.transformer import decode_step_, init_cache
from .compact import CompactModel, compact_model, support_selection
from .refresh import refresh_model, recompact_model

__all__ = ["EngineConfig", "Request", "Completion", "LatencyStats",
           "RecompactScheduler", "FleetEngine"]

# cache leaves carrying recurrent (non-position-indexed) state: stale rows
# WOULD leak into a newly admitted request, so the step zeroes them under
# the admit mask. Position-indexed leaves (k/v) are self-cleaning.
_RECURRENT_CACHE_KEYS = frozenset({"state", "conv_x", "conv_B", "conv_C"})

# columns of the packed (B, _ADMIT_FIXED + Pmax) int64 admission buffer
_MASK, _EVICT, _PLEN, _BUDGET, _KEY = 0, 1, 2, 3, 4
_ADMIT_FIXED = 6
# rows of the packed (4, B) int64 step output
_OUTPUTS = ("token", "emitted", "finished", "truncated")
_OUT_RING = 2


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static serving-engine configuration (one step per config).

    ``max_seq``: KV-cache slot depth Smax — a request stops (and is flagged
    ``truncated``) when its next position would reach it. ``max_prompt``:
    on-device prompt buffer width (defaults to ``max_seq``); longer prompts
    are refused at submit. ``temperature``: 0 = greedy argmax inside the
    step; > 0 samples by Gumbel-max from a hash of the request's key and
    the row position (so continuous and solo runs of the same request draw
    the same stream). ``cache_dtype``: KV-cache dtype — ``None`` matches
    the first floating param leaf. ``pipeline``: drain step outputs with a
    one-step lag so host bookkeeping overlaps device work.

    >>> cfg = EngineConfig(max_seq=256, temperature=0.0)
    """
    max_seq: int = 256
    max_prompt: Optional[int] = None
    temperature: float = 0.0     # 0 = greedy
    seed: int = 0
    cache_dtype: Any = None      # None -> match the checkpoint's param dtype
    pipeline: bool = True

    @property
    def prompt_width(self) -> int:
        """The (B, Pmax) on-device prompt buffer width (static)."""
        return self.max_seq if self.max_prompt is None else self.max_prompt


@dataclasses.dataclass
class Request:
    """One queued generation request (host-side bookkeeping).

    ``rid``: engine-assigned id; ``prompt``: token ids (1 <= len <=
    ``EngineConfig.prompt_width``); ``max_new``: generation budget;
    ``key``: (2,) uint32 per-request sample key; ``arrival``: wall-clock
    submit time (or the caller-provided open-loop arrival instant) that
    TTFT is measured from.

    >>> req = Request(rid=0, prompt=[1, 2], max_new=8,
    ...               key=np.zeros(2, np.uint32), arrival=0.0)
    """
    rid: int
    prompt: List[int]
    max_new: int
    key: np.ndarray
    arrival: float


@dataclasses.dataclass
class Completion:
    """One finished request: tokens plus per-request service telemetry.

    ``tokens`` is prompt + generated; ``truncated`` is True when the row ran
    out of cache depth (``max_seq``) before emitting its full ``max_new``
    budget. ``ttft``: seconds from arrival to the first generated token;
    ``token_times``: drain timestamp per generated token (inter-token gaps
    feed the latency percentiles); ``evicted``: cancelled before finishing.

    >>> done = Completion(rid=0, tokens=[1, 2, 9], prompt_len=2,
    ...                   truncated=False, evicted=False, ttft=0.01,
    ...                   token_times=[0.01])
    """
    rid: int
    tokens: List[int]
    prompt_len: int
    truncated: bool
    evicted: bool
    ttft: Optional[float]
    token_times: List[float]

    @property
    def generated(self) -> List[int]:
        """The generated suffix (``tokens`` without the prompt)."""
        return self.tokens[self.prompt_len:]


@dataclasses.dataclass
class LatencyStats:
    """Percentile summary of a latency sample set (seconds).

    >>> LatencyStats.from_samples([0.1, 0.2, 0.3]).p50
    0.2
    """
    count: int
    mean: float
    p50: float
    p95: float
    p99: float

    @classmethod
    def from_samples(cls, samples: Sequence[float]) -> "LatencyStats":
        """Build from raw samples; empty input yields all-zero stats."""
        if not samples:
            return cls(count=0, mean=0.0, p50=0.0, p95=0.0, p99=0.0)
        a = np.asarray(samples, np.float64)
        return cls(count=int(a.size), mean=float(a.mean()),
                   p50=float(np.percentile(a, 50)),
                   p95=float(np.percentile(a, 95)),
                   p99=float(np.percentile(a, 99)))

    def as_dict(self) -> Dict[str, float]:
        """Plain-dict form for JSON artifacts."""
        return dataclasses.asdict(self)


@dataclasses.dataclass
class RecompactScheduler:
    """Hysteretic trigger for live re-compaction under checkpoint churn.

    Projected training only kills columns, so the live/slot ratio of a
    served ``CompactModel`` decays monotonically across refreshed
    checkpoints. The rule: fire when the ratio first crosses below
    ``threshold``, then again only after it has dropped a further
    ``hysteresis`` since the LAST fire. ``reslot_threshold``: below this
    ratio the padded slots dominate the GEMMs and a full (recapturing)
    ``compact_model`` re-slot pays off — surfaced as
    ``reslot_recommended``, never done implicitly.

    >>> sched = RecompactScheduler(threshold=0.9, hysteresis=0.05)
    """
    threshold: float = 0.9
    hysteresis: float = 0.05
    reslot_threshold: float = 0.5
    last_fired_ratio: float = 1.0 + 1e-9
    fires: int = 0

    def decide(self, ratio: float) -> bool:
        """True iff a recompact should run at this live/slot ratio."""
        if ratio >= self.threshold:
            return False
        if ratio > self.last_fired_ratio - self.hysteresis:
            return False
        self.last_fired_ratio = ratio
        self.fires += 1
        return True

    def reslot_recommended(self, ratio: float) -> bool:
        """True when the ratio is low enough that a re-slot (fresh
        ``compact_model``, one new capture) would pay for itself."""
        return ratio < self.reslot_threshold


def _request_key(seed: int, sample_seed: int) -> np.ndarray:
    """Host-side per-request PRNG key: splitmix64 of (engine seed,
    request seed) as a (2,) uint32 key. Pure python — a device call
    here would cost more under open-loop load than the decode steps."""
    mask = (1 << 64) - 1
    x = ((seed & 0xFFFFFFFF) << 32) | (sample_seed & 0xFFFFFFFF)
    x = (x + 0x9E3779B97F4A7C15) & mask
    z = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & mask
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
    z = z ^ (z >> 31)
    return np.array([z >> 32, z & 0xFFFFFFFF], np.uint32)


def _param_dtype(params) -> torch.dtype:
    """Dtype of the first floating leaf (sel leaves are int32 riders)."""
    for leaf in leaves(params):
        if torch.is_floating_point(leaf):
            return leaf.dtype
    return torch.float32


def _reset_recurrent(cache, mask: torch.Tensor) -> None:
    """Zero the admitted rows of recurrent cache leaves (SSM conv/state) in
    place: unlike position-indexed KV leaves, their stale values WOULD leak
    into a new request. mask: (B,) bool, True = slot (re)admitted this
    step. The batch axis is 1 under ``blocks`` (layer-stacked), else 0."""
    keep = ~mask
    for key, sub in cache.items():
        axis = 1 if key == "blocks" else 0
        for path, leaf in flatten_with_path(sub):
            if path.rsplit("/", 1)[-1] in _RECURRENT_CACHE_KEYS:
                shape = [1] * leaf.ndim
                shape[axis] = keep.shape[0]
                leaf.mul_(keep.to(leaf.dtype).reshape(shape))


# ------------------------------ sampling ------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 ``x`` in [0, 2**32) and a 32-bit
    constant ``c``, in 16-bit halves of c so no product leaves [0, 2**49)."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on int64 lanes holding uint32 values
    (every value stays non-negative, so ``>>`` is a logical shift)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def sample_bits(key: torch.Tensor, pos: torch.Tensor,
                vocab: int) -> torch.Tensor:
    """(B, vocab) int64 values in [0, 2**32): the hash of each row's key
    (B, 2), its position (B,) and the vocab index. Integer ops only, so
    equal on every device.

    >>> sample_bits(torch.zeros(1, 2, dtype=torch.long),
    ...             torch.zeros(1, dtype=torch.long), 4).shape
    torch.Size([1, 4])
    """
    v = torch.arange(vocab, device=key.device)
    h = _fmix32(key[:, 0] ^ 0x9E3779B9)
    h = _fmix32(h ^ key[:, 1])
    h = _fmix32(h ^ (pos & _M32))
    return _fmix32(_fmix32(h[:, None] ^ v[None, :]) ^ 0x7F4A7C15)


def gumbel_sample(logits: torch.Tensor, key: torch.Tensor,
                  pos: torch.Tensor, temperature: float) -> torch.Tensor:
    """One draw per row from softmax(logits / temperature) by Gumbel-max:
    argmax(logits / T - log(-log u)), u = (bits + 0.5) / 2**32 from
    ``sample_bits`` (exact in float64). logits (B, V); returns (B,) int64."""
    u = (sample_bits(key, pos, logits.shape[-1]).double() + 0.5) * 2.0 ** -32
    g = -torch.log(-torch.log(u))
    return torch.argmax(logits.double() / temperature + g, dim=-1)


# ------------------------------ the engine ----------------------------------

def _signature(params):
    return tuple((p, tuple(a.shape), a.dtype) for p, a in
                 flatten_with_path(params))


class FleetEngine:
    """Continuous-batching decode engine over one step (one CUDA graph on
    the card).

    ``model``: a zoo ``Model``; ``batch_slots``: fixed decode width B;
    ``cfg``: ``EngineConfig``; ``mesh`` / ``rules`` (optional): lay the
    slots out over the mesh axes the rules (``default_rules()`` when
    None) assign to "batch", each rank stepping its rows with replicated
    params and no collective in the step; one all-gather of the outputs
    a step (see the module docstring). Every rank must make the same
    calls.

    Lifecycle: ``load`` / ``load_compact`` a checkpoint, ``submit``
    requests, call ``step`` per decode step (or ``drain`` to run the
    backlog dry). ``refresh`` / ``recompact`` hot-swap checkpoints
    mid-flight into the same tensors; a ``RecompactScheduler``
    (``scheduler=``) turns refreshes into recompactions when the live/slot
    ratio decays past its threshold. ``n_traces`` counts step builds (CPU)
    or graph captures (CUDA) — admission, eviction, refresh and
    recompaction all reuse the first; ``n_replays`` counts graph replays.

    >>> eng = FleetEngine(model, batch_slots=4, cfg=EngineConfig())
    """

    def __init__(self, model, batch_slots: int, cfg: EngineConfig,
                 mesh=None, rules=None,
                 scheduler: Optional[RecompactScheduler] = None):
        if model.cfg.encdec or model.cfg.n_img_tokens:
            raise ValueError(
                "FleetEngine serves decoder-only archs; enc-dec / vision "
                "memory caches need per-request prefill plumbing")
        self.model = model
        self.cfg = cfg
        self.B = batch_slots
        self.scheduler = scheduler
        self.compact: Optional[CompactModel] = None
        self.n_traces = 0            # step builds (CPU) / captures (CUDA)
        self.n_replays = 0           # graph replays (CUDA)
        self._mesh = mesh
        self._rows = slice(0, batch_slots)   # this rank's slots
        self._exchange_s = 0.0       # host seconds in the output gather
        if mesh is not None:
            from ..dist.sharding import axes_index, default_rules
            rules = dict(default_rules() if rules is None else rules)
            self._batch_axes = rules.get("batch")
            if self._batch_axes is None:
                raise ValueError(
                    "FleetEngine: the sharding rules map 'batch' to None — "
                    "every rank would redundantly serve the FULL batch; "
                    "name a mesh axis for 'batch' (see "
                    "dist.sharding.default_rules)")
            index, ways = axes_index(mesh, self._batch_axes)
            if batch_slots % ways:
                raise ValueError(f"FleetEngine: {batch_slots} slots do not "
                                 f"divide over {ways} ranks of "
                                 f"{self._batch_axes!r}")
            n = batch_slots // ways
            self._rows = slice(index * n, (index + 1) * n)
        # device state: the step's inputs and outputs, allocated once
        self._params = None
        self._sig = None             # signature of _params
        self._built_sig = None       # signature the step was built for
        self._dev: Optional[torch.device] = None
        self._stream = None
        self._graph = None
        self._cache = None
        self._slots = None
        self._admit = None
        self._out = None
        # host-side bookkeeping
        self._next_rid = 0
        self._queue: collections.Deque[Request] = collections.deque()
        self._reqs: Dict[int, Request] = {}
        self._slot_rid: List[Optional[int]] = [None] * batch_slots
        self._gen: Dict[int, List[int]] = {}
        self._times: Dict[int, List[float]] = {}
        self._cancelled: set = set()
        self._evict_pending: List[int] = []
        self._pending: collections.Deque = collections.deque()
        self._completions: List[Completion] = []
        self._retired: List[Completion] = []
        self._steps = 0
        self._tokens_out = 0

    # ---------------------- checkpoint lifecycle -------------------------

    @property
    def params(self):
        """The served param tree: the tensors the step reads."""
        return self._params

    def _on_stream(self):
        """The engine's stream as the current one (a no-op on the CPU)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _adopt(self, params) -> None:
        """Serve ``params``: copy them into the step's tensors when shapes,
        dtypes and structure match the served tree, else take a copy of
        the new tree (the step is rebuilt at the next ``step``)."""
        devs = {a.device for a in leaves(params)}
        if len(devs) != 1:
            raise ValueError(f"checkpoint leaves span devices {devs}")
        dev = devs.pop()
        if self._dev is None:
            self._dev = dev
            if dev.type == "cuda":
                self._stream = torch.cuda.Stream(device=dev)
        elif dev != self._dev:
            raise ValueError(f"checkpoint on {dev}, but this engine serves "
                             f"on {self._dev}")
        sig = _signature(params)
        if self._stream is not None:
            self._stream.wait_stream(torch.cuda.current_stream(dev))
        with self._on_stream():
            if sig == self._sig:
                for dst, src in zip(leaves(self._params), leaves(params)):
                    dst.copy_(src)
            else:
                # free the old tree (and the graph over it) before copying
                self._graph = None
                self._params = None
                self._params = tree_map(lambda a: a.detach().clone(), params)
                self._sig = sig
        if self._stream is not None:
            # the caller may free or overwrite its tree once we return
            self._stream.synchronize()

    def _adopt_compact(self, compact: CompactModel) -> None:
        self._adopt(compact.params)
        self.compact = dataclasses.replace(compact, params=self._params)

    def load(self, params) -> None:
        """Serve a dense checkpoint (drops any compact state)."""
        self._adopt(params)
        self.compact = None

    def load_compact(self, compact: Optional[CompactModel] = None, *,
                     params=None) -> None:
        """Serve a compacted checkpoint: a prebuilt ``serve.CompactModel``
        or a dense ``params`` tree compacted here under the model's own
        ``projection_specs``."""
        if compact is None:
            compact = compact_model(params, self.model.cfg.projection_specs)
        self._adopt_compact(compact)

    def _live_ratio(self, new_params) -> float:
        """Prospective min live/slot ratio of a new checkpoint against the
        frozen slot widths (host-side; checkpoint-rate, not step-rate)."""
        sups = support_selection(new_params, self.compact.specs)
        ratios = [sups[p].n_selected / max(self.compact.slot_width(p), 1)
                  for p in self.compact.sels]
        return min(ratios) if ratios else 1.0

    def refresh(self, new_dense_params) -> bool:
        """Hot refresh: new checkpoint values through the frozen compact
        recipe (or a plain param swap when serving dense). Shapes are
        unchanged, so the step is not rebuilt — safe mid-flight. With a
        ``scheduler``, decaying live/slot ratios upgrade the refresh to a
        live re-compaction; returns True when that fired."""
        if self.compact is None:
            self._adopt(new_dense_params)
            return False
        if self.scheduler is not None and \
                self.scheduler.decide(self._live_ratio(new_dense_params)):
            self.recompact(new_dense_params)
            return True
        self._adopt_compact(refresh_model(self.compact, new_dense_params))
        return False

    def recompact(self, new_dense_params) -> None:
        """Live re-compaction: adopt the new checkpoint's (monotonically
        smaller) support inside the frozen slot widths. Not rebuilt; exact
        mid-flight (surviving columns keep their ascending order, so the
        re-gathered GEMMs sum the same nonzero terms)."""
        self._adopt_compact(recompact_model(self.compact, new_dense_params))

    def reslot_recommended(self) -> bool:
        """True when the scheduler judges the live/slot ratio low enough
        that a full (recapturing) ``compact_model`` re-slot pays off."""
        if self.scheduler is None or self.compact is None:
            return False
        live = [self.compact.live[p] / max(self.compact.slot_width(p), 1)
                for p in self.compact.sels] or [1.0]
        return self.scheduler.reslot_recommended(min(live))

    # ---------------------- request intake -------------------------------

    def submit(self, prompt: Sequence[int], max_new: int,
               arrival: Optional[float] = None,
               sample_seed: Optional[int] = None) -> int:
        """Queue one request; returns its rid. ``arrival`` backdates the
        TTFT clock for open-loop load generators; ``sample_seed`` pins the
        per-request sample key (defaults to the rid) so a temperature>0
        request reproduces across solo and batched runs."""
        if not 0 < len(prompt) <= self.cfg.prompt_width:
            raise ValueError(
                f"prompt length {len(prompt)} outside (0, "
                f"{self.cfg.prompt_width}] — raise EngineConfig.max_prompt")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        rid = self._next_rid
        self._next_rid += 1
        key = _request_key(
            self.cfg.seed, sample_seed if sample_seed is not None else rid)
        req = Request(rid=rid, prompt=list(prompt), max_new=max_new,
                      key=key,
                      arrival=time.perf_counter() if arrival is None
                      else arrival)
        self._queue.append(req)
        self._reqs[rid] = req
        return rid

    def cancel(self, rid: int) -> bool:
        """Evict a queued or in-flight request (its slot frees next step);
        returns False when the rid is unknown or already finished."""
        for i, q in enumerate(self._queue):
            if q.rid == rid:
                del self._queue[i]
                self._finalize(rid, evicted=True)
                return True
        for slot, srid in enumerate(self._slot_rid):
            if srid == rid and rid not in self._cancelled:
                self._cancelled.add(rid)
                self._evict_pending.append(slot)
                return True
        return False

    # ---------------------- the step ------------------------------------

    def _traced_step(self, params, cache, slots, admit, out) -> None:
        """The ONE step: evict + admit-merge -> decode at per-row positions
        -> in-step sampling -> next-feed/budget/truncation update. Writes
        ``cache``, ``slots`` and ``out`` in place and clears the consumed
        merge in ``admit``; no host sync, no data-dependent shape."""
        Smax = self.cfg.max_seq
        Pmax = self.cfg.prompt_width
        m = admit[:, _MASK] != 0
        evict = admit[:, _EVICT] != 0
        a_prompt = admit[:, _ADMIT_FIXED:]
        feed = torch.where(m, a_prompt[:, 0], slots["feed"])
        pos = slots["pos"].masked_fill(m, 0)
        plen = torch.where(m, admit[:, _PLEN], slots["plen"])
        rem = torch.where(m, admit[:, _BUDGET], slots["remaining"])
        active = (slots["active"] & ~evict) | m
        prompt = torch.where(m[:, None], a_prompt, slots["prompt"])
        key = torch.where(m[:, None], admit[:, _KEY:_KEY + 2], slots["key"])
        _reset_recurrent(cache, m)
        logits = decode_step_(params, cache, feed[:, None], pos,
                              self.model.cfg)
        lg = logits[:, -1, :]
        if self.cfg.temperature > 0:
            nxt = gumbel_sample(lg, key, pos, self.cfg.temperature)
        else:
            nxt = torch.argmax(lg, dim=-1)

        emitted = active & (pos >= plen - 1) & (rem > 0)
        new_rem = torch.where(emitted, rem - 1, rem)
        done = active & (new_rem <= 0)
        want_more = active & ~done
        trunc = want_more & (pos + 1 >= Smax)
        new_active = want_more & ~trunc
        in_prompt = (pos + 1) < plen
        nxt_prompt = prompt.gather(
            1, (pos + 1).clamp(0, Pmax - 1)[:, None])[:, 0]
        new_feed = torch.where(new_active & in_prompt, nxt_prompt,
                               torch.where(new_active, nxt, feed))
        out.copy_(torch.stack([nxt, emitted.long(), (done | trunc).long(),
                               trunc.long()]))
        slots["feed"].copy_(new_feed)
        slots["pos"].copy_(torch.where(new_active, pos + 1, pos))
        slots["plen"].copy_(plen)
        slots["remaining"].copy_(new_rem)
        slots["active"].copy_(new_active)
        slots["prompt"].copy_(prompt)
        slots["key"].copy_(key)
        admit[:, :_PLEN].zero_()     # consumed: the next step merges nothing

    def _ensure_ready(self):
        if self._params is None:
            raise RuntimeError("no checkpoint loaded: call load/load_compact")
        if self._cache is not None:
            return
        B = self._rows.stop - self._rows.start      # this rank's slots
        Pmax, dev = self.cfg.prompt_width, self._dev
        dtype = (self.cfg.cache_dtype if self.cfg.cache_dtype is not None
                 else _param_dtype(self._params))
        long = dict(dtype=torch.long, device=dev)
        with self._on_stream():
            self._cache = init_cache(self.model.cfg, B, self.cfg.max_seq,
                                     dtype, device=dev)
            self._slots = {
                "feed": torch.zeros((B,), **long),
                "pos": torch.zeros((B,), **long),
                "plen": torch.ones((B,), **long),
                "remaining": torch.zeros((B,), **long),
                "active": torch.zeros((B,), dtype=torch.bool, device=dev),
                "prompt": torch.zeros((B, Pmax), **long),
                "key": torch.zeros((B, 2), **long),
            }
            self._admit = torch.zeros((B, _ADMIT_FIXED + Pmax), **long)
            self._out = torch.zeros((len(_OUTPUTS), B), **long)
        if self._stream is not None:
            pinned = dict(dtype=torch.long, pin_memory=True)
            self._admit_host = [torch.zeros(self._admit.shape, **pinned)
                                for _ in range(2)]
            self._admit_events = [torch.cuda.Event() for _ in range(2)]
            self._admit_turn = 0
            self._out_host = [torch.zeros(self._out.shape, **pinned)
                              for _ in range(_OUT_RING)]
            self._out_events = [torch.cuda.Event() for _ in range(_OUT_RING)]

    def _state(self):
        return self._cache, self._slots, self._admit, self._out

    def _capture(self) -> None:
        """Warm the step up on clones of the live state (so no live row
        moves), then capture it into one CUDA graph on the engine's
        stream. Raises if capture fails."""
        s = self._stream
        self._graph = None
        s.wait_stream(torch.cuda.current_stream(self._dev))
        with torch.cuda.stream(s):
            cache, slots, admit, out = self._state()
            warm = (tree_map(torch.clone, cache), tree_map(torch.clone, slots),
                    admit.clone(), out.clone())
            for _ in range(2):
                self._traced_step(self._params, *warm)
        s.synchronize()
        del warm
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=s):
            self._traced_step(self._params, *self._state())
        self._graph = graph

    def _run_step(self, admit: Optional[np.ndarray]):
        """Stage the merge (if any), run the step once; returns the handle
        ``_drain_one`` reads this step's outputs through."""
        rebuild = self._built_sig != self._sig
        if admit is not None:
            admit = admit[self._rows]
        if self._stream is None:
            if rebuild:
                self.n_traces += 1
                self._built_sig = self._sig
            if admit is not None:
                self._admit.copy_(torch.from_numpy(admit))
            self._traced_step(self._params, *self._state())
            return self._out.numpy().copy()
        if rebuild:
            self._capture()
            self.n_traces += 1
            self._built_sig = self._sig
        with torch.cuda.stream(self._stream):
            if admit is not None:
                j = self._admit_turn
                self._admit_turn ^= 1
                # the copy that last read this pinned buffer must have run
                self._admit_events[j].synchronize()
                self._admit_host[j].numpy()[...] = admit
                self._admit.copy_(self._admit_host[j], non_blocking=True)
                self._admit_events[j].record(self._stream)
            self._graph.replay()
            self.n_replays += 1
            j = self._steps % _OUT_RING
            self._out_host[j].copy_(self._out, non_blocking=True)
            self._out_events[j].record(self._stream)
        return j

    # ---------------------- the serving loop -----------------------------

    def _admit_args(self) -> Optional[np.ndarray]:
        """Build this step's admission/eviction merge (host numpy, packed
        as the device buffer); None when there is nothing to merge."""
        B = self.B
        admit = np.zeros((B, _ADMIT_FIXED + self.cfg.prompt_width), np.int64)
        admit[:, _PLEN] = 1
        staged = False
        for slot in self._evict_pending:
            admit[slot, _EVICT] = 1
            staged = True
            rid = self._slot_rid[slot]
            self._slot_rid[slot] = None
            if rid is not None:
                self._finalize(rid, evicted=True)
        self._evict_pending = []
        for i in range(B):
            if not self._queue:
                break
            if self._slot_rid[i] is None:
                req = self._queue.popleft()
                staged = True
                admit[i, _MASK] = 1
                admit[i, _ADMIT_FIXED:_ADMIT_FIXED + len(req.prompt)] = \
                    req.prompt
                admit[i, _PLEN] = len(req.prompt)
                admit[i, _BUDGET] = req.max_new
                admit[i, _KEY:_KEY + 2] = req.key
                self._slot_rid[i] = req.rid
                self._gen[req.rid] = []
                self._times[req.rid] = []
        return admit if staged else None

    def _finalize(self, rid: int, truncated: bool = False,
                  evicted: bool = False):
        req = self._reqs.pop(rid)
        gen = self._gen.pop(rid, [])
        times = self._times.pop(rid, [])
        self._cancelled.discard(rid)
        done = Completion(
            rid=rid, tokens=list(req.prompt) + gen,
            prompt_len=len(req.prompt), truncated=truncated,
            evicted=evicted,
            ttft=(times[0] - req.arrival) if times else None,
            token_times=times)
        self._completions.append(done)
        self._retired.append(done)

    def _drain_one(self, pending) -> None:
        """Host-side drain of ONE step's (B,) outputs: append emitted
        tokens, retire finished rows, free their slots. ``pending`` pairs
        the outputs with the slot->rid map AT DISPATCH TIME — with the
        one-step drain lag a slot can be evicted and re-admitted before
        its old output drains, and the token must credit the old rid. On
        the card it waits for that step's event only."""
        handle, owners = pending
        if isinstance(handle, int):
            self._out_events[handle].synchronize()
            handle = self._out_host[handle].numpy().copy()
        if self._mesh is not None:
            handle = self._exchange(handle)
        now = time.perf_counter()
        token, emitted, finished, truncated = handle
        for i in range(self.B):
            rid = owners[i]
            if rid is None or rid not in self._gen:
                continue             # empty slot, or evicted + finalized
            if emitted[i]:
                self._gen[rid].append(int(token[i]))
                self._times[rid].append(now)
                self._tokens_out += 1
            if finished[i]:
                if self._slot_rid[i] == rid:
                    self._slot_rid[i] = None
                self._finalize(rid, truncated=bool(truncated[i]))

    def _exchange(self, local: np.ndarray) -> np.ndarray:
        """Every rank's (4, B / D) step outputs as the whole (4, B): one
        all-gather over the batch axes of the host copies."""
        from ..dist.sharding import gather_rows
        t = time.perf_counter()
        out = gather_rows(torch.from_numpy(local), self._mesh,
                          self._batch_axes, dim=1).numpy()
        self._exchange_s += time.perf_counter() - t
        return out

    def step(self) -> List[Completion]:
        """One engine step: admit queued prompts into freed slots, run the
        decode step (a graph replay on the card), drain the previous
        step's outputs (one-step pipeline lag; ``pipeline=False`` drains
        synchronously). Returns the requests that finished at the drained
        step."""
        self._ensure_ready()
        handle = self._run_step(self._admit_args())
        self._pending.append((handle, tuple(self._slot_rid)))
        self._steps += 1
        lag = 1 if self.cfg.pipeline else 0
        while len(self._pending) > lag:
            self._drain_one(self._pending.popleft())
        return self._pop_completions()

    def flush(self) -> List[Completion]:
        """Drain every undrained step output (no new device step)."""
        while self._pending:
            self._drain_one(self._pending.popleft())
        return self._pop_completions()

    def drain(self, max_steps: Optional[int] = None) -> List[Completion]:
        """Run steps until the queue and all slots are empty (or
        ``max_steps`` is hit); returns all completions, rid-ordered."""
        done: List[Completion] = []
        steps = 0
        while self._queue or any(r is not None for r in self._slot_rid):
            done += self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        done += self.flush()
        return sorted(done, key=lambda c: c.rid)

    def _pop_completions(self) -> List[Completion]:
        out, self._completions = self._completions, []
        return out

    # ---------------------- telemetry ------------------------------------

    def latency_report(self) -> Dict[str, Any]:
        """TTFT and inter-token latency percentiles over every finished
        request since construction (seconds)."""
        ttft = [c.ttft for c in self._retired if c.ttft is not None]
        gaps: List[float] = []
        for c in self._retired:
            ts = c.token_times
            gaps += [b - a for a, b in zip(ts, ts[1:])]
        return {"ttft": LatencyStats.from_samples(ttft).as_dict(),
                "per_token": LatencyStats.from_samples(gaps).as_dict()}

    def stats(self) -> Dict[str, Any]:
        """Engine counters: steps run, tokens emitted, slot occupancy,
        queue depth, step builds, live compaction ratios."""
        busy = sum(r is not None for r in self._slot_rid)
        out: Dict[str, Any] = {
            "steps": self._steps, "tokens": self._tokens_out,
            "busy_slots": busy, "queue": len(self._queue),
            "n_traces": self.n_traces,
            "slot_utilization": (self._tokens_out / (self._steps * self.B)
                                 if self._steps else 0.0),
        }
        if self._mesh is not None:
            out["exchange_s"] = self._exchange_s
        if self.compact is not None:
            out["live_ratio"] = {
                p: self.compact.live[p] / max(self.compact.slot_width(p), 1)
                for p in self.compact.sels}
            out["reslot_recommended"] = self.reslot_recommended()
        return out
