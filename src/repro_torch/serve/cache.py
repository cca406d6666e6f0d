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
    cache leaves are (L, slots, capacity, ...)).

    With a ``mesh`` (:class:`repro_torch.launch.mesh.Mesh`) the cache is
    placed by ``distributed.sharding.cache_pspecs``, as the reference's:
    the sequence over ``model`` (split-KV), the slots over ``data`` where
    ``data`` divides them, else the sequence over ``("data", "model")``
    (context parallelism: every rank holds every slot). ``data`` holds
    this rank's leaves (a ``LocalCache`` that knows its stripe),
    ``pspecs`` the reference's specs and ``shardings`` each leaf's
    :class:`~repro_torch.distributed.sharding.LeafSharding`;
    ``slot_block`` is the global slots this rank holds. The accounting
    (``slots``, ``capacity``, the free list, :meth:`fits`) is global and
    the same on every rank. MLA's latent cache (``ckv``, ``krope``) is
    striped as a K/V cache is.
    """

    def __init__(self, model, slots: int, capacity: int, *, mesh=None,
                 device=None):
        if slots < 1 or capacity < 1:
            raise ValueError(f"bad slot cache shape ({slots}, {capacity})")
        self.model = model
        self.slots = slots
        self.capacity = capacity
        self.mesh = mesh
        self.pspecs = self.shardings = self.sharding = None
        self.slot_block = slice(0, slots)
        if mesh is None:
            self.data = model.init_cache(slots, capacity, device=device)
        else:
            from repro_torch.distributed.sharding import CacheSharding
            shapes = {k: v[0] for k, v in
                      model.cache_shapes(slots, capacity).items()}
            self.sharding = CacheSharding(model.cfg, mesh, shapes,
                                          slots=slots)
            self.pspecs = self.sharding.specs
            self.shardings = self.sharding.shardings
            self.slot_block = self.sharding.slot_block
            self.data = model.init_cache(slots, capacity, device=device,
                                         sharding=self.sharding)
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
