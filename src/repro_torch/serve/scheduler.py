"""Request scheduler for the continuous-batching engine: port of the FIFO
part of ``repro/serve/scheduler.py`` (host-side Python, no tensors).

A bounded queue of heterogeneous-length requests, per-slot progress
tracking, admission batching (free slots x queued requests, grouped by
padded prompt length so each admission group is ONE ``prefill_at``
call), and retirement on EOS/max-tokens. The device never sees any of
this — the data plane is the slot cache plus one decode step per token.
The reference's preemption, cancellation, priority tiers,
``PriorityScheduler`` and ``TierSLO`` are not yet ported.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np

from repro_torch.serve.cache import SlotCache


class QueueFull(RuntimeError):
    """Raised when submit() hits the bounded queue's limit."""


@dataclasses.dataclass(eq=False)
class Request:
    """One generation request. ``tokens`` is the (S,) int prompt."""

    rid: int
    tokens: np.ndarray
    max_new_tokens: int
    eos_id: Optional[int] = None

    def __post_init__(self):
        self.tokens = np.asarray(self.tokens, np.int32).reshape(-1)
        if self.tokens.size < 1:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.rid}: max_new_tokens < 1")

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.size)


@dataclasses.dataclass(eq=False)
class FinishedRequest:
    """Completed generation + latency accounting (host wall-clock)."""

    request: Request
    tokens: np.ndarray                 # (n_generated,) int32
    submit_time: float
    finish_time: float
    first_token_time: float

    @property
    def latency(self) -> float:
        return self.finish_time - self.submit_time

    @property
    def ttft(self) -> float:
        return self.first_token_time - self.submit_time


@dataclasses.dataclass(eq=False)
class _Queued:
    req: Request
    submit_time: float


@dataclasses.dataclass(eq=False)
class _SlotState:
    request: Request
    submit_time: float
    first_token_time: float = 0.0
    emitted: list = dataclasses.field(default_factory=list)


class RequestScheduler:
    """Bounded FIFO + per-slot state over a :class:`SlotCache`.

    The engine drives it: ``submit`` enqueues; ``pop_admissions`` drains
    the queue into free slots (called every step, so new requests join
    mid-flight while resident slots keep decoding); ``record`` appends
    one emitted token to a slot and retires it on EOS/max-tokens.
    """

    def __init__(self, cache: SlotCache, *, max_queue: int = 1024,
                 prefill_bucket: int = 1):
        if prefill_bucket < 1:
            raise ValueError("prefill_bucket must be >= 1")
        self.cache = cache
        self.max_queue = max_queue
        self.prefill_bucket = prefill_bucket
        self.queue: deque[_Queued] = deque()
        self.active: dict[int, _SlotState] = {}

    # ----------------------------------------------------------- submit

    def padded_len(self, prompt_len: int) -> int:
        """Prompt-buffer length after bucket rounding (bounds the number
        of distinct prefill shapes)."""
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
        self.queue.append(_Queued(request, now))

    # -------------------------------------------------------- admission

    def pop_admissions(self) -> dict[int, list[tuple[int, Request, float]]]:
        """Drain the head of the queue into free slots, in FIFO order.

        Returns {padded_len: [(slot, request, submit_time), ...]} — one
        ``prefill_at`` call per group (same prompt-buffer shape).
        """
        groups: dict[int, list[tuple[int, Request, float]]] = {}
        for _ in range(min(len(self.queue), self.cache.free_slots)):
            q = self.queue.popleft()
            slot = self.cache.acquire()
            self.active[slot] = _SlotState(q.req, q.submit_time)
            groups.setdefault(self.padded_len(q.req.prompt_len), []).append(
                (slot, q.req, q.submit_time))
        if not self.slot_accounting_ok():
            raise RuntimeError("free-slot accounting leak")
        return groups

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
            request=req, tokens=np.asarray(st.emitted, np.int32),
            submit_time=st.submit_time, finish_time=now,
            first_token_time=st.first_token_time)

    # ------------------------------------------------------------ state

    def slot_accounting_ok(self) -> bool:
        """No free-slot leak: every slot is free or active."""
        return self.cache.free_slots + len(self.active) == self.cache.slots

    def has_work(self) -> bool:
        return bool(self.queue or self.active)
