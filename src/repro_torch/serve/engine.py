"""The continuous-batching :class:`ServeEngine` (slot cache + FIFO
scheduler + on-device sampling), the static-batch :class:`DecodeEngine`
and the prefill/serve step factories: port of the FIFO, unchunked path
of ``repro/serve/engine.py``.

ServeEngine contract (the decode hot path):
  * ONE decode step per emitted token for the whole slot batch. The
    reference jits it and donates the cache; here the decode cache (K/V,
    MLA's latents, or the SSM and hybrid families' conv and recurrent
    states beside the hybrid's shared-block K/V) is a set of persistent
    device tensors that the step writes in place (one row per slot,
    layer and leaf; one state per slot and Mamba layer), so it is never
    copied per token. On the card, GQA attention runs as one
    ``flash_decode`` kernel launch per layer (per application of the
    hybrid's shared block); MLA's absorbed decode and the Mamba layers
    are torch ops, as the reference's are jnp;
  * sampling (greedy/temperature/top-k/top-p, per-request keys) runs on
    the device in that step, so only (slots, 1) int32 tokens are copied
    to the host, once per tick;
  * admission is ``prefill_at``: a batch of new requests is prefilled
    and its prompt rows (and recurrent states) written into free slots
    in place while resident slots keep theirs — the NEXT decode step
    serves old and new together.

``ServeEngine`` serves the families of ``SERVE_FAMILIES``, as the
reference's: the encdec and vlm families' prompts carry frames or image
embeddings, which slot admission does not take, so they are served by
:class:`DecodeEngine`. The reference's SLO priority scheduling
(``slos``), chunked prefill (``prefill_chunk``), the prefix store
(``prefix_entries``), meshes and slot autoscaling (``min_slots``) are
not yet ported and raise.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.serve import sampling
from repro_torch.serve.cache import SlotCache
from repro_torch.serve.sampling import SamplerConfig
from repro_torch.serve.scheduler import (FinishedRequest, Request,
                                         RequestScheduler)

SERVE_FAMILIES = ("dense", "moe", "ssm", "hybrid")


def make_prefill_step(model) -> Callable:
    """(params, batch) -> (last-token logits (B, V), cache).

    batch: {"tokens"} (+"frames" encdec, +"image_embeddings" vlm).
    ``cache_len`` fixes the decode-cache capacity (defaults to the prompt
    length).
    """
    family = model.cfg.family

    def step(params, batch, *, cache_len: Optional[int] = None):
        kw = {}
        if family == "encdec":
            kw["frames"] = batch["frames"]
        if family == "vlm":
            kw["image_embeddings"] = batch["image_embeddings"]
        return model.prefill(params, batch["tokens"], cache_len=cache_len,
                             **kw)

    return step


def make_serve_step(model) -> Callable:
    """(params, cache, tokens (B,1)) -> (logits (B,1,V), the cache,
    updated in place): ONE new token against the standing cache."""
    def step(params, cache, tokens):
        return model.decode_step(params, cache, tokens)

    return step


class DecodeEngine:
    """Static-batch greedy decoding: one prefill of a fixed batch, then
    one decode step per token for a fixed number of tokens, every
    sequence in its lane until the last token. The reference keeps it as
    the serving benchmark's baseline and as the way to serve the encdec
    and vlm families.

    It runs on the params' device: GQA decode attention is the
    ``flash_decode`` kernel on the card, its plain version on the CPU.
    The batch's tensors are moved there.
    """

    def __init__(self, model, params, cfg=None):
        self.model = model
        self.cfg = cfg if cfg is not None else model.cfg
        self.params = params
        self.device = params["embed"].device
        self._prefill = make_prefill_step(model)
        self._step = make_serve_step(model)

    def generate(self, batch, *, max_new_tokens: int,
                 cache_len: Optional[int] = None) -> torch.Tensor:
        """Greedy tokens (B, max_new_tokens) int32 on the params' device.
        The cache's capacity defaults to the text prompt's length plus
        ``max_new_tokens``, as the reference's; a vlm caller passes
        ``cache_len`` to make room for the image prefix too."""
        batch = {k: v.to(self.device) for k, v in batch.items()}
        B, S = batch["tokens"].shape
        cap = cache_len or (S + max_new_tokens)
        logits, cache = self._prefill(self.params, batch, cache_len=cap)
        tok = logits.argmax(dim=-1).to(torch.int32)[:, None]
        out = [tok]
        for _ in range(max_new_tokens - 1):
            logits, cache = self._step(self.params, cache, tok)
            tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
            out.append(tok)
        return torch.cat(out, dim=1)


class ServeEngine:
    """Continuous-batching decode over a slot-paged persistent cache.

    Drive it either with :meth:`run` (drain a request list) or manually
    — ``submit()`` between ``step()`` calls injects traffic mid-flight;
    each ``step()`` admits whatever fits into free slots and decodes
    ONE token for every resident sequence.

    The engine runs on the params' device; GQA decode attention is the
    ``flash_decode`` kernel on the card and its plain version on the
    CPU. ``use_flash`` checks that placement (``None``/``"auto"``: either;
    ``True``: the card; ``False``: the CPU).
    """

    def __init__(self, model, params, cfg=None, *, slots: int = 4,
                 capacity: int = 256, sampler: Optional[SamplerConfig] = None,
                 mesh=None, use_flash: Optional[bool] = None,
                 prefill_bucket: int = 1, max_queue: int = 1024,
                 prefill_chunk: Optional[int] = None,
                 prefix_entries: int = 0, seed: int = 0, slos=None,
                 min_slots: Optional[int] = None):
        self.model = model
        self.cfg = cfg if cfg is not None else model.cfg
        if self.cfg.family not in SERVE_FAMILIES:
            raise ValueError(f"ServeEngine covers {SERVE_FAMILIES}, got "
                             f"{self.cfg.family!r}")
        unported = {"slos": slos is not None, "prefill_chunk":
                    prefill_chunk is not None, "prefix_entries":
                    prefix_entries > 0, "mesh": mesh is not None,
                    "min_slots": min_slots is not None}
        for name, given in unported.items():
            if given:
                raise NotImplementedError(
                    f"ServeEngine({name}=...) is not yet ported to "
                    "repro_torch")
        self.sampler = sampler if sampler is not None else SamplerConfig()
        self.params = params
        self.device = params["embed"].device
        self.use_flash = "auto" if use_flash is None else use_flash
        kops.check_use_kernels(self.use_flash, self.device,
                               option="use_flash")
        self.seed = seed
        self.cache = SlotCache(model, slots, capacity, device=self.device)
        self.scheduler = RequestScheduler(self.cache, max_queue=max_queue,
                                          prefill_bucket=prefill_bucket)
        self._next_rid = 0
        self.stats = {"decode_steps": 0, "admit_calls": 0, "tokens_out": 0,
                      "occupancy_sum": 0.0, "ticks": 0}
        self._toks = torch.zeros((slots, 1), dtype=torch.int32,
                                 device=self.device)
        self._keys = torch.zeros((slots, 2), dtype=torch.int64,
                                 device=self.device)
        # True while every logits row computed so far was finite; read
        # on the host only by :attr:`logits_finite`
        self._finite = torch.ones((), dtype=torch.bool, device=self.device)

    # ----------------------------------------------------------- device

    def _decode(self) -> None:
        """One token for every slot: decode, fold each slot's key with
        the position the token is written at, sample — on the device."""
        logits, cache = self.model.decode_step(
            self.params, self.cache.data, self._toks,
            use_flash=self.use_flash)
        self._finite &= torch.isfinite(logits).all()
        keys = sampling.fold_positions(self._keys, cache["pos"])
        self._toks = sampling.sample(self.sampler, logits[:, -1],
                                     keys)[:, None]

    def _admit(self, prompt: torch.Tensor, lengths: torch.Tensor,
               slot_ids: torch.Tensor, req_keys: torch.Tensor
               ) -> torch.Tensor:
        """Prefill a group into its slots; sample its first tokens."""
        logits, _ = self.model.prefill_at(self.params, self.cache.data,
                                          prompt, slot_ids, lengths=lengths)
        self._finite &= torch.isfinite(logits).all()
        self._keys[slot_ids] = req_keys
        first = sampling.sample(
            self.sampler, logits, sampling.fold_positions(req_keys, lengths))
        self._toks[slot_ids, 0] = first
        return first

    @property
    def logits_finite(self) -> bool:
        """Whether every logits row of every decode step and admission
        so far was finite (one host read)."""
        return bool(self._finite.item())

    # ------------------------------------------------------------- host

    def submit(self, tokens, max_new_tokens: int, *,
               eos_id: Optional[int] = None,
               rid: Optional[int] = None) -> int:
        """Enqueue one request (bounded queue); returns its rid."""
        if rid is None:
            rid = self._next_rid
        self._next_rid = max(self._next_rid, rid) + 1
        req = Request(rid=rid, tokens=np.asarray(tokens),
                      max_new_tokens=max_new_tokens, eos_id=eos_id)
        self.scheduler.submit(req, now=time.perf_counter())
        return rid

    def _admit_pending(self) -> list[FinishedRequest]:
        finished = []
        for pad_len, group in sorted(
                self.scheduler.pop_admissions().items()):
            n = len(group)
            prompt = np.zeros((n, pad_len), np.int32)
            lengths = np.zeros((n,), np.int32)
            for i, (_, req, _) in enumerate(group):
                prompt[i, :req.prompt_len] = req.tokens
                lengths[i] = req.prompt_len
            slot_ids = torch.tensor([s for s, _, _ in group],
                                    device=self.device)
            req_keys = sampling.make_keys(
                self.seed, [req.rid for _, req, _ in group], self.device)
            first = self._admit(torch.from_numpy(prompt).to(self.device),
                                torch.from_numpy(lengths).to(self.device),
                                slot_ids, req_keys)
            self.stats["admit_calls"] += 1
            first = first.cpu().numpy()
            now = time.perf_counter()
            for (slot, _, _), tok in zip(group, first):
                self.stats["tokens_out"] += 1
                fin = self.scheduler.record(slot, int(tok), now)
                if fin is not None:
                    finished.append(fin)
        return finished

    # -------------------------------------------------------------- tick

    def step(self) -> list[FinishedRequest]:
        """One engine tick: admit into free slots, then decode ONE token
        for every resident sequence."""
        self.stats["ticks"] += 1
        finished = self._admit_pending()
        live = list(self.scheduler.active)
        if live:
            self.stats["decode_steps"] += 1
            self.stats["occupancy_sum"] += len(live) / self.cache.slots
            self._decode()
            emitted = self._toks[:, 0].cpu().numpy()   # the ONLY host copy
            now = time.perf_counter()
            for slot in live:
                self.stats["tokens_out"] += 1
                fin = self.scheduler.record(slot, int(emitted[slot]), now)
                if fin is not None:
                    finished.append(fin)
        return finished

    def run(self, requests: Optional[Iterable] = None
            ) -> list[FinishedRequest]:
        """Submit ``requests`` (Request objects or (tokens, max_new)
        pairs), then step until queue and slots drain."""
        for r in requests or ():
            if isinstance(r, Request):
                self.submit(r.tokens, r.max_new_tokens, eos_id=r.eos_id,
                            rid=r.rid)
            else:
                tokens, max_new = r
                self.submit(tokens, max_new)
        finished = []
        while self.scheduler.has_work():
            finished.extend(self.step())
        return finished

    def generate(self, prompts: Sequence, max_new_tokens: int
                 ) -> list[np.ndarray]:
        """Convenience: decode ``max_new_tokens`` for each prompt; output
        ordered like ``prompts`` regardless of scheduling."""
        rids = [self.submit(p, max_new_tokens) for p in prompts]
        by_rid = {f.request.rid: f.tokens for f in self.run()}
        return [by_rid[r] for r in rids]

    @property
    def occupancy(self) -> float:
        """Mean fraction of slots doing useful work per decode step."""
        steps = self.stats["decode_steps"]
        return self.stats["occupancy_sum"] / steps if steps else 0.0

    def reset_stats(self) -> None:
        """Zero the step/occupancy counters (e.g. after a warm-up)."""
        self.stats = {k: 0.0 if k == "occupancy_sum" else 0
                      for k in self.stats}
