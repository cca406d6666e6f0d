"""Request schedulers for the continuous-batching engine: port of
``repro/serve/scheduler.py`` (host-side Python, no tensors; the
reference's, verbatim but for this docstring, its import and the
``clock`` a serving mesh hands it).

A bounded queue of heterogeneous-length requests, per-slot progress
tracking, admission batching (free slots x queued requests, grouped by
padded prompt length so each admission group is ONE ``prefill_at``
call), and retirement on EOS/max-tokens. The device never sees any of
this — the data plane is the slot cache plus one decode step per token.

Two schedulers share the mechanism:

  * :class:`RequestScheduler` — bounded FIFO;
  * :class:`PriorityScheduler` — per-request priority *tiers* with
    per-tier TTFT/latency SLOs (:class:`TierSLO`): admission orders by
    effective tier (FIFO within a tier; a queued request's effective
    tier improves one level per ``aging_s`` seconds waited, so a
    sustained high-tier flood cannot starve low tiers unboundedly),
    and :meth:`PriorityScheduler.select_preemptions` names over-budget
    lower-tier decoding slots to evict when a higher-tier request
    would otherwise miss its TTFT deadline.

Preemption (:meth:`RequestScheduler.preempt`) releases the victim's slot
and re-queues the request as a *continuation* whose prompt is the
original prompt extended by every token emitted so far — on
re-admission the replayed tokens prefill (one suffix token when the
engine snapshotted the resident state into the prefix store) and
decoding resumes byte-identically, because a token at absolute position
``p`` is always sampled with the request's key folded with ``p``,
however the state reached ``p``. Latency accounting (submit time,
first-token time, previously emitted tokens) is carried across
preemptions, so TTFT/latency percentiles measure the request, not the
attempt.

Cancellation is tombstone-safe: cancelling a request that sits in an
already-popped admission group (queued -> popped -> cancelled) parks the
slot instead of releasing it, and the popper discovers the tombstone via
:meth:`RequestScheduler.claim_popped` before issuing the prefill — the
engine can no longer prefill a cancelled rid, and the slot is released
exactly once. ``pop_admissions`` asserts the free/active/limbo slot
accounting on every call.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Optional, Sequence, Union

import numpy as np

from repro_torch.serve.cache import SlotCache


class QueueFull(RuntimeError):
    """Raised when submit() hits the bounded queue's limit."""


@dataclasses.dataclass(eq=False)
class Request:
    """One generation request. ``tokens`` is the (S,) int prompt;
    ``tier`` is the priority class (0 = highest)."""

    rid: int
    tokens: np.ndarray
    max_new_tokens: int
    eos_id: Optional[int] = None
    tier: int = 0

    def __post_init__(self):
        self.tokens = np.asarray(self.tokens, np.int32).reshape(-1)
        if self.tokens.size < 1:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.rid}: max_new_tokens < 1")
        if self.tier < 0:
            raise ValueError(f"request {self.rid}: tier < 0")

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.size)


@dataclasses.dataclass(eq=False)
class FinishedRequest:
    """Completed generation + latency accounting (host wall-clock).

    ``request`` is the ORIGINAL request even when the generation was
    preempted and resumed; ``tokens`` concatenates every attempt."""

    request: Request
    tokens: np.ndarray                 # (n_generated,) int32
    submit_time: float
    finish_time: float
    first_token_time: float
    preemptions: int = 0

    @property
    def latency(self) -> float:
        return self.finish_time - self.submit_time

    @property
    def ttft(self) -> float:
        return self.first_token_time - self.submit_time


@dataclasses.dataclass(eq=False)
class _Queued:
    """One queue entry. Continuations of preempted requests carry the
    accounting of the original submission."""

    req: Request
    submit_time: float
    seq: int                            # FIFO ticket (kept across preempts)
    first_token_time: float = 0.0
    prior: tuple = ()                   # tokens emitted before preemption
    origin: Optional[Request] = None    # original request (None = req)
    preemptions: int = 0


@dataclasses.dataclass(eq=False)
class _SlotState:
    request: Request
    submit_time: float
    first_token_time: float = 0.0
    emitted: list = dataclasses.field(default_factory=list)
    issued: bool = False                # prefill handed to the device
    seq: int = 0
    prior: tuple = ()
    origin: Optional[Request] = None
    preemptions: int = 0


class RequestScheduler:
    """Bounded FIFO + per-slot state over a :class:`SlotCache`.

    The engine drives it: ``submit`` enqueues; ``pop_admissions`` drains
    the queue into free slots (called every step, so new requests join
    mid-flight while resident slots keep decoding); ``claim_popped``
    confirms a popped row right before its prefill is issued (dropping
    rows cancelled in between); ``record`` appends one emitted token to
    a slot and retires it on EOS/max-tokens; ``preempt`` evicts a slot
    and re-queues the request as a replayable continuation.

    ``clock`` gives the time a call without ``now`` decides by
    (``time.perf_counter``; on a serving mesh the engine's, rank 0's
    time broadcast to every rank, so that every rank decides alike).
    """

    def __init__(self, cache: SlotCache, *, max_queue: int = 1024,
                 prefill_bucket: int = 1,
                 clock: Callable[[], float] = time.perf_counter):
        if prefill_bucket < 1:
            raise ValueError("prefill_bucket must be >= 1")
        self.clock = clock
        self.cache = cache
        self.max_queue = max_queue
        self.prefill_bucket = prefill_bucket
        self.queue: deque[_Queued] = deque()
        self.active: dict[int, _SlotState] = {}
        self._seq = 0
        self._tombstones: set[int] = set()      # rids cancelled post-pop
        self._limbo: dict[int, int] = {}        # rid -> parked slot

    # ----------------------------------------------------------- submit

    def padded_len(self, prompt_len: int) -> int:
        """Prompt-buffer length after bucket rounding (bounds the number
        of distinct prefill compilations)."""
        b = self.prefill_bucket
        return -(-prompt_len // b) * b

    def submit(self, request: Request, now: float = 0.0) -> None:
        if len(self.queue) >= self.max_queue:
            raise QueueFull(f"queue limit {self.max_queue} reached")
        if not self.cache.fits(self.padded_len(request.prompt_len),
                               request.max_new_tokens):
            raise ValueError(
                f"request {request.rid}: padded prompt "
                f"{self.padded_len(request.prompt_len)} + "
                f"{request.max_new_tokens} new tokens exceeds cache "
                f"capacity {self.cache.capacity}")
        self.queue.append(_Queued(request, now, self._seq))
        self._seq += 1

    # -------------------------------------------------------- admission

    def _admission_order(self, now: float) -> list[_Queued]:
        """Queue entries in admission order. FIFO here; overridden by
        :class:`PriorityScheduler`. Must NOT re-order leftovers behind
        later arrivals within a tier — ``seq`` is the tie-break."""
        return list(self.queue)

    def _may_admit(self, q: _Queued) -> bool:
        """Admission veto hook (e.g. reserved-headroom policy)."""
        return True

    def pop_admissions(self, limit: Optional[int] = None, *,
                       now: Optional[float] = None
                       ) -> dict[int, list[tuple[int, Request, float]]]:
        """Drain queued requests into free slots.

        Returns {padded_len: [(slot, request, submit_time), ...]} — one
        ``prefill_at`` call per group (same prompt-buffer shape).
        ``limit`` caps admissions this call: group batch shapes then
        stay small and stable (at most ``limit`` rows), bounding prefill
        recompilation under bursty arrivals. The caller must confirm
        each row with :meth:`claim_popped` before issuing its prefill.
        """
        now = self.clock() if now is None else now
        groups: dict[int, list[tuple[int, Request, float]]] = {}
        admitted = 0
        picked: list[_Queued] = []
        for q in self._admission_order(now):
            if not self.cache.free_slots or (limit is not None
                                             and admitted >= limit):
                break
            if not self._may_admit(q):
                continue
            admitted += 1
            picked.append(q)
            slot = self.cache.acquire()
            assert slot is not None
            self.active[slot] = _SlotState(
                q.req, q.submit_time, first_token_time=q.first_token_time,
                seq=q.seq, prior=q.prior, origin=q.origin,
                preemptions=q.preemptions)
            groups.setdefault(self.padded_len(q.req.prompt_len), []).append(
                (slot, q.req, q.submit_time))
        if picked:
            chosen = {id(q) for q in picked}
            self.queue = deque(q for q in self.queue
                               if id(q) not in chosen)
        assert (self.cache.free_slots + len(self.active) + len(self._limbo)
                == self.cache.slots), "free-slot accounting leak"
        return groups

    def claim_popped(self, slot: int, rid: int) -> bool:
        """Confirm a popped admission row right before its prefill.

        Returns False when the row was cancelled between the pop and the
        prefill (tombstoned): the parked slot is released here — exactly
        once — and the caller must drop the row. Returns True and marks
        the slot's prefill as issued otherwise."""
        st = self.active.get(slot)
        if st is None or st.request.rid != rid:
            if self._limbo.get(rid) == slot:
                del self._limbo[rid]
                self._tombstones.discard(rid)
                self.cache.release(slot)
            return False
        st.issued = True
        return True

    # ----------------------------------------------------------- record

    def record(self, slot: int, token: int, now: float
               ) -> Optional[FinishedRequest]:
        """Append one emitted token; retire the slot when done."""
        st = self.active[slot]
        if st.first_token_time == 0.0:
            st.first_token_time = now
        st.emitted.append(int(token))
        req = st.request
        done = (len(st.emitted) >= req.max_new_tokens
                or (req.eos_id is not None and int(token) == req.eos_id))
        if not done:
            return None
        del self.active[slot]
        self.cache.release(slot)
        return FinishedRequest(
            request=st.origin if st.origin is not None else req,
            tokens=np.asarray(list(st.prior) + st.emitted, np.int32),
            submit_time=st.submit_time, finish_time=now,
            first_token_time=st.first_token_time,
            preemptions=st.preemptions)

    # ------------------------------------------------------- preemption

    def preempt(self, slot: int, now: Optional[float] = None) -> Request:
        """Evict an active slot; its request re-queues at the front as a
        continuation whose prompt includes every emitted token, so
        re-admission replays them (a 1-token suffix prefill when the
        engine snapshotted the resident state into the prefix store)
        and the token stream resumes byte-identically."""
        st = self.active.pop(slot)
        if not st.issued:
            self.active[slot] = st
            raise ValueError(f"slot {slot}: cannot preempt before its "
                             "prefill was issued")
        self.cache.release(slot)
        req = st.request
        emitted = np.asarray(st.emitted, np.int32)
        cont = Request(
            rid=req.rid,
            tokens=np.concatenate([req.tokens, emitted]),
            max_new_tokens=req.max_new_tokens - len(st.emitted),
            eos_id=req.eos_id, tier=req.tier)
        self.queue.appendleft(_Queued(
            cont, st.submit_time, st.seq,
            first_token_time=st.first_token_time,
            prior=st.prior + tuple(st.emitted),
            origin=st.origin if st.origin is not None else req,
            preemptions=st.preemptions + 1))
        return cont

    # ----------------------------------------------------------- cancel

    def cancel(self, rid: int) -> tuple[Optional[str], Optional[int]]:
        """Abort a request by rid. Returns ("queued", None) if it was
        still waiting, ("active", slot) if its (prefill-issued) slot was
        retired — the slot is released here —, ("popped", slot) if it
        sat in an admission group the caller popped but has not yet
        prefilled (the slot is parked until :meth:`claim_popped`
        discovers the tombstone and releases it), or (None, None) if
        unknown."""
        for i, q in enumerate(self.queue):
            if q.req.rid == rid:
                del self.queue[i]
                return "queued", None
        for slot, st in self.active.items():
            if st.request.rid == rid:
                del self.active[slot]
                if st.issued:
                    self.cache.release(slot)
                    return "active", slot
                self._tombstones.add(rid)
                self._limbo[rid] = slot
                return "popped", slot
        return None, None

    # ------------------------------------------------------------ state

    @property
    def queued(self) -> int:
        return len(self.queue)

    def queued_requests(self) -> list[Request]:
        return [q.req for q in self.queue]

    def slot_accounting_ok(self) -> bool:
        """No free-slot leak: every slot is free, active, or parked."""
        return (self.cache.free_slots + len(self.active) + len(self._limbo)
                == self.cache.slots)

    def has_work(self) -> bool:
        return bool(self.queue or self.active)


# ------------------------------------------------------------- priority

@dataclasses.dataclass(frozen=True)
class TierSLO:
    """Per-tier service-level objectives (seconds).

    ``ttft_s`` is the first-token deadline: a queued request that has
    burned ``preempt_at`` of it triggers preemption when no free slot
    exists. ``latency_s`` is the completion budget: an active request
    past it counts as *over budget* and is the preferred victim."""

    ttft_s: float
    latency_s: float = float("inf")

    def __post_init__(self):
        if self.ttft_s <= 0 or self.latency_s <= 0:
            raise ValueError("TierSLO budgets must be > 0")


def normalize_slos(slos: Union[dict, Sequence]) -> dict[int, TierSLO]:
    """{tier: TierSLO | (ttft, latency) | ttft} or a sequence by tier."""
    if not isinstance(slos, dict):
        slos = dict(enumerate(slos))
    out = {}
    for tier, s in slos.items():
        if isinstance(s, TierSLO):
            out[int(tier)] = s
        elif isinstance(s, (tuple, list)):
            out[int(tier)] = TierSLO(*s)
        else:
            out[int(tier)] = TierSLO(float(s))
    return out


class PriorityScheduler(RequestScheduler):
    """Tier-aware admission + SLO-driven preemption policy.

    Admission order is (effective tier, seq): strict FIFO *within* a
    tier, and a queued request's effective tier improves one level per
    ``aging_s`` seconds waited (clamped at 0), so under a sustained
    higher-tier burst every request is still admitted within
    ``tier * aging_s`` of the flood's FIFO schedule — no unbounded
    starvation, and leftover admission groups can never be re-sorted
    behind later-arriving requests of the same effective tier.

    ``reserve_slots`` keeps headroom for tier 0: a request of tier > 0
    is only admitted while more than ``reserve_slots`` slots are free,
    so a tier-0 arrival never has to wait behind a wall of mid-prefill
    batch rows (which are not preemptable). Preemption then only has to
    cover *overlapping* tier-0 arrivals.
    """

    def __init__(self, cache: SlotCache, *,
                 slos: Union[dict, Sequence],
                 max_queue: int = 1024, prefill_bucket: int = 1,
                 aging_s: Optional[float] = None,
                 preempt_at: float = 0.5,
                 over_budget_only: bool = False,
                 reserve_slots: int = 0,
                 clock: Callable[[], float] = time.perf_counter):
        super().__init__(cache, max_queue=max_queue,
                         prefill_bucket=prefill_bucket, clock=clock)
        self.slos = normalize_slos(slos)
        if not self.slos:
            raise ValueError("PriorityScheduler needs at least one TierSLO")
        if not 0.0 < preempt_at <= 1.0:
            raise ValueError("preempt_at must be in (0, 1]")
        finite = [s.ttft_s for s in self.slos.values()]
        self.aging_s = (max(finite) if aging_s is None else aging_s)
        if self.aging_s <= 0:
            raise ValueError("aging_s must be > 0")
        if not 0 <= reserve_slots < cache.slots:
            raise ValueError("reserve_slots must be in [0, slots)")
        self.preempt_at = preempt_at
        self.over_budget_only = over_budget_only
        self.reserve_slots = reserve_slots

    # ordering ---------------------------------------------------------

    def effective_tier(self, q: _Queued, now: float) -> int:
        waited = max(0.0, now - q.submit_time)
        return max(0, q.req.tier - int(waited / self.aging_s))

    def _admission_order(self, now: float) -> list[_Queued]:
        return sorted(self.queue,
                      key=lambda q: (self.effective_tier(q, now), q.seq))

    def _may_admit(self, q: _Queued) -> bool:
        return (q.req.tier == 0
                or self.cache.free_slots > self.reserve_slots)

    # preemption policy ------------------------------------------------

    def over_budget(self, st: _SlotState, now: float) -> bool:
        slo = self.slos.get(st.request.tier)
        return (slo is not None
                and now - st.submit_time > slo.latency_s)

    def select_preemptions(self, now: Optional[float] = None, *,
                           prefilling: frozenset = frozenset()
                           ) -> list[int]:
        """Victim slots to evict so deadline-risk queued requests get in.

        A queued request is *at risk* when ``preempt_at`` of its tier's
        TTFT budget has burned. Risk beyond the free-slot budget is
        matched against active decoding slots (prefill-complete, not in
        ``prefilling``) of strictly lower priority whose continuation
        still fits the cache — preferring higher tier numbers, then
        over-budget decodes, then the oldest. With ``over_budget_only``
        only victims past their latency SLO are eligible."""
        now = self.clock() if now is None else now
        if not self.queue:
            return []
        at_risk = []
        for q in self._admission_order(now):
            slo = self.slos.get(q.req.tier)
            if slo is None or slo.ttft_s == float("inf"):
                continue
            if now - q.submit_time >= self.preempt_at * slo.ttft_s:
                at_risk.append(q)
        at_risk = at_risk[self.cache.free_slots:]
        if not at_risk:
            return []
        cands = []
        for slot, st in self.active.items():
            if not st.issued or slot in prefilling:
                continue
            cont_len = st.request.prompt_len + len(st.emitted)
            remaining = st.request.max_new_tokens - len(st.emitted)
            if remaining < 1 or not self.cache.fits(
                    self.padded_len(cont_len), remaining):
                continue
            over = self.over_budget(st, now)
            if self.over_budget_only and not over:
                continue
            cands.append((slot, st, over))
        victims: list[int] = []
        for q in at_risk:
            best = None
            for i, (slot, st, over) in enumerate(cands):
                if st.request.tier <= q.req.tier:
                    continue
                key = (-st.request.tier, not over, st.seq)
                if best is None or key < best[0]:
                    best = (key, i, slot)
            if best is None:
                break
            cands.pop(best[1])
            victims.append(best[2])
        return victims
