"""Slot-paged persistent decode cache: port of ``repro/serve/cache.py``.

The continuous-batching engine decodes a FIXED device-resident batch of
``slots`` sequences; requests are admitted into free slots (prefill
copies their K/V or latent state into the slot's rows — see
``LanguageModel.prefill_at``) and retired on EOS/max-tokens, at which
point the slot is simply marked free. Cache contents never round-trip
through the host: the tensors live on the device for the engine's
lifetime and are written in place by every decode step and admission;
only (slots, 1) int32 tokens cross to the host per step.

A retired-but-unreused slot keeps decoding garbage (its lane of the
batch still runs); that compute is the price of a static batch shape
and is reported as (1 - occupancy).
"""

from __future__ import annotations

from typing import Optional


class SlotCache:
    """Fixed (slots, capacity) device cache + free-slot accounting.

    ``capacity`` bounds prompt_len + max_new_tokens per request (the
    cache leaves are (L, slots, capacity, ...)). A ``mesh`` is not yet
    ported.
    """

    def __init__(self, model, slots: int, capacity: int, *, mesh=None,
                 device=None):
        if mesh is not None:
            raise NotImplementedError(
                "a mesh-sharded SlotCache is not yet ported to repro_torch")
        if slots < 1 or capacity < 1:
            raise ValueError(f"bad slot cache shape ({slots}, {capacity})")
        self.model = model
        self.slots = slots
        self.capacity = capacity
        self.mesh = None
        self.data = model.init_cache(slots, capacity, device=device)
        self._free = list(range(slots - 1, -1, -1))   # pop() -> slot 0 first

    # ------------------------------------------------------------ slots

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def active_slots(self) -> int:
        return self.slots - len(self._free)

    def acquire(self) -> Optional[int]:
        """Claim a free slot (None if fully occupied)."""
        return self._free.pop() if self._free else None

    def release(self, slot: int) -> None:
        """Retire a slot; its device rows become reusable garbage."""
        if not 0 <= slot < self.slots:
            raise ValueError(f"slot {slot} out of range [0, {self.slots})")
        if slot in self._free:
            raise ValueError(f"slot {slot} already free")
        self._free.append(slot)

    def fits(self, prompt_len: int, max_new_tokens: int) -> bool:
        return prompt_len + max_new_tokens <= self.capacity
