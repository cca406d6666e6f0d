"""The continuous-batching :class:`ServeEngine` (slot cache + FIFO or
SLO-tiered scheduler + on-device sampling, with chunked prefill, a prefix
store and preemption), the static-batch :class:`DecodeEngine` and the
prefill/serve step factories: port of ``repro/serve/engine.py``, on one
device or on a serving mesh of ``torch.distributed`` ranks.

ServeEngine contract (the decode hot path):
  * ONE decode step per emitted token for the whole slot batch — every
    slot decodes, and the rows that are not live are masked, so the
    tick's shapes never change. The reference jits it and donates the
    cache; here the decode cache (K/V or a window's ring, MLA's latents,
    or the SSM and hybrid families' conv and recurrent states beside the
    hybrid's shared-block K/V) is a set of persistent device tensors that
    the step writes in place (one row per slot, layer and leaf; one state
    per slot and Mamba layer), so it is never copied per token. On the
    card, GQA attention runs as one ``flash_decode`` kernel launch per
    layer (per application of the hybrid's shared block); MLA's absorbed
    decode and the Mamba layers are torch ops, as the reference's are
    jnp;
  * sampling (greedy/temperature/top-k/top-p, per-request keys) runs on
    the device in that step, so only (slots, 1) int32 tokens are copied
    to the host, once per tick;
  * admission is ``prefill_at`` (a batch of new requests prefilled and
    written into free slots in place) or, with ``prefill_chunk`` or
    ``prefix_entries``, ``prefill_chunk_at``: each mid-prefill slot
    advances one chunk a tick inside the resident cache while the live
    slots keep decoding (the masked live decode drops the masked rows'
    cache writes, so a slot mid-prefill is not touched), and a prefix
    matched in the prefix store is restored by an on-device row copy.
    None of these launches ``flash_decode``: its launches happen in the
    ticks only, and the engine counts them (``stats``).

``ServeEngine`` serves the families of ``SERVE_FAMILIES``, as the
reference's: the encdec and vlm families' prompts carry frames or image
embeddings, which slot admission does not take, so they are served by
:class:`DecodeEngine`.

The serving mesh (``ServeEngine(mesh=...)``, a
:class:`repro_torch.launch.mesh.Mesh`): every rank runs the same host
scheduler over the same requests, so every host decision (admissions,
finishes, tier order) comes out the same on every rank; the clock they
decide by is rank 0's, broadcast (:meth:`ServeEngine.clock`). The params
are cut by ``serve_param_pspecs``' ``model`` entries and the cache by
``cache_pspecs`` (:class:`~repro_torch.serve.cache.SlotCache`): a rank
decodes its block of the slots, against its stripe of the sequence
(``flash_decode`` on the stripe, the ranks' partial softmaxes merged),
samples from whole rows of the vocabulary (its block's argmax gathered
under greedy, the rows gathered otherwise), and the ranks of ``data``
gather their tokens, so the host sees every slot's. A ``model`` axis
above 1 serves the dense family and the moe family (its experts split
over ``model``, each rank combining its experts' slots and the ranks'
partial outputs summed), with GQA or MLA attention (MLA's latent cache
striped as a K/V cache, its absorbed decode merged over the stripes);
the ssm and hybrid families raise, naming ROADMAP.md queue 1 item
4b-ii. A ``model`` axis
of 1 serves every family of ``SERVE_FAMILIES``. For the moe family over
a ``data`` axis above 1 the tick's MoE blocks route every slot of the
mesh together (dead slots included, as the reference's one engine
routes its whole slot batch), and a rank holding a slot of an admitted
group prefills the whole group, whose tokens the reference routes
together, and writes only its own slots (no collective in the prefill:
a rank without a slot of the group skips it). Chunked prefill, the
prefix store, preemption and :class:`DecodeEngine` on a mesh raise,
naming queue 1 item 4c-ii.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch

from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import (check_model_parallel,
                                              serve_param_shardings,
                                              shard_params)
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops as kops
from repro_torch.serve import sampling
from repro_torch.serve.cache import SlotCache
from repro_torch.serve.prefix import PrefixPool
from repro_torch.serve.sampling import SamplerConfig
from repro_torch.serve.scheduler import (FinishedRequest, PriorityScheduler,
                                         Request, RequestScheduler)

SERVE_FAMILIES = ("dense", "moe", "ssm", "hybrid")


def _not_on_mesh(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} on a serving mesh is ROADMAP.md queue 1 item 4c-ii, not "
        "yet ported to repro_torch")


@dataclasses.dataclass
class _PendingRow:
    """A slot mid-prefill on the chunked admission path."""

    slot: int
    req: Request
    start: int                    # next prompt position to fill
    hold: Optional[int]           # pinned prefix-store entry (refcount)

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

    def __init__(self, model, params, cfg=None, *, mesh=None):
        if mesh is not None:
            raise _not_on_mesh("DecodeEngine")
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

    Passing ``slos`` ({tier: TierSLO}) swaps the FIFO scheduler for the
    :class:`PriorityScheduler`: admission orders by (aged) tier, and an
    SLO-driven preemption pass runs before admission each tick — when a
    queued high-tier request has burned ``preempt_at`` of its TTFT
    budget and no slot is free, the worst over-budget lower-tier decode
    is evicted. Its resident state (prompt + emitted[:-1]) is
    snapshotted into the prefix store and PINNED, so re-admission
    replays the emitted tokens as a one-suffix-token prefill and the
    token stream resumes byte-identically (position-folded sampling).
    ``min_slots`` bounds slot autoscaling: the admission target starts
    there and ramps one slot per tick while the queue is non-empty
    (decaying back when it drains). ``reserve_slots`` keeps that many
    slots off-limits to tier > 0 admissions. ``admit_limit`` caps the
    admissions of one tick. As the reference's.

    ``stats`` holds the reference's counters and three of the port's:
    ``decode_calls`` (``decode_step`` calls: one per decode tick, the
    port's form of the reference's one-trace contract),
    ``flash_decode_launches`` (kernel launches inside those calls) and
    ``flash_decode_outside_ticks`` (launches during admission, chunks,
    restores and snapshots: none, on either device). On a mesh they are
    this rank's.

    ``mesh``: the serving mesh (module docstring). ``params`` are the
    whole params; the engine keeps this rank's blocks of them.
    """

    def __init__(self, model, params, cfg=None, *, slots: int = 4,
                 capacity: int = 256, sampler: Optional[SamplerConfig] = None,
                 mesh=None, use_flash: Optional[bool] = None,
                 prefill_bucket: int = 1, max_queue: int = 1024,
                 prefill_chunk: Optional[int] = None,
                 prefix_entries: int = 0, prefix_min_tokens: int = 4,
                 admit_limit: Optional[int] = None, seed: int = 0,
                 slos=None, min_slots: Optional[int] = None,
                 aging_s: Optional[float] = None, preempt_at: float = 0.5,
                 over_budget_only: bool = False, preempt: bool = True,
                 reserve_slots: int = 0):
        self.model = model
        self.cfg = cfg if cfg is not None else model.cfg
        if self.cfg.family not in SERVE_FAMILIES:
            raise ValueError(f"ServeEngine covers {SERVE_FAMILIES}, got "
                             f"{self.cfg.family!r}")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        self.mesh = mesh
        if mesh is not None:
            from repro_torch.launch.mesh import Mesh
            if not isinstance(mesh, Mesh):
                raise TypeError("ServeEngine's mesh must be a repro_torch."
                                f"launch.mesh.Mesh, got {type(mesh)!r}")
            check_model_parallel(self.cfg, mesh)
            if prefill_chunk is not None:
                raise _not_on_mesh("chunked prefill (prefill_chunk)")
            if prefix_entries > 0:
                raise _not_on_mesh("the prefix store (prefix_entries)")
            if preempt and slos is not None:
                raise _not_on_mesh("preemption (slos with preempt=True)")
            params = shard_params(params, serve_param_shardings(
                self.cfg, params, mesh))
        self._tp = C.model_parallel(mesh)
        self.sampler = sampler if sampler is not None else SamplerConfig()
        self.params = params
        self.device = params["embed"].device
        self.use_flash = "auto" if use_flash is None else use_flash
        kops.check_use_kernels(self.use_flash, self.device,
                               option="use_flash")
        self.seed = seed
        self.cache = SlotCache(model, slots, capacity, mesh=mesh,
                               device=self.device)
        if slos is not None:
            self.scheduler: RequestScheduler = PriorityScheduler(
                self.cache, slos=slos, max_queue=max_queue,
                prefill_bucket=prefill_bucket, aging_s=aging_s,
                preempt_at=preempt_at, over_budget_only=over_budget_only,
                reserve_slots=reserve_slots, clock=self.clock)
        else:
            self.scheduler = RequestScheduler(
                self.cache, max_queue=max_queue,
                prefill_bucket=prefill_bucket, clock=self.clock)
        self.preempt_enabled = preempt and slos is not None
        if min_slots is not None and not 1 <= min_slots <= slots:
            raise ValueError(f"min_slots must be in [1, {slots}]")
        self.min_slots = min_slots
        self._slot_target = min_slots if min_slots is not None else slots
        self._preempt_holds: dict[int, int] = {}   # rid -> pinned entry
        self._next_rid = 0
        self.stats = {"decode_steps": 0, "admit_calls": 0,
                      "chunk_calls": 0, "restore_calls": 0,
                      "snap_calls": 0, "prefix_hits": 0,
                      "prefix_hit_tokens": 0,
                      "tokens_out": 0, "occupancy_sum": 0.0,
                      "ticks": 0, "preemptions": 0,
                      "replayed_tokens": 0, "slot_target_sum": 0.0,
                      "decode_calls": 0, "flash_decode_launches": 0,
                      "flash_decode_outside_ticks": 0}
        # chunked admission path: active when either knob is set. With
        # `prefill_chunk` each engine tick advances every mid-prefill
        # slot by ONE C-token chunk and still decodes the resident
        # slots (the masked live decode leaves mid-prefill rows alone);
        # with only `prefix_entries` the suffix past the matched prefix
        # is filled in one shot.
        self.prefill_chunk = prefill_chunk
        self.admit_limit = admit_limit
        self._chunked = prefill_chunk is not None or prefix_entries > 0
        self.pool: Optional[PrefixPool] = None
        self.store: Optional[SlotCache] = None
        if prefix_entries > 0:
            self.pool = PrefixPool(prefix_entries,
                                   min_tokens=prefix_min_tokens)
            self.store = SlotCache(model, prefix_entries, capacity,
                                   device=self.device)
        self._pending: list[_PendingRow] = []
        self._prefilling: set[int] = set()
        self._snap_q: list[tuple[int, int]] = []    # (entry, src slot)
        # this rank's slots' tokens and keys (every slot off a mesh)
        local = self.cache.slot_block.stop - self.cache.slot_block.start
        self._toks = torch.zeros((local, 1), dtype=torch.int32,
                                 device=self.device)
        self._keys = torch.zeros((local, 2), dtype=torch.int64,
                                 device=self.device)
        # on a mesh, every token recorded, folded in order: the host's
        # decisions, to be compared across the ranks (scheduler_digest)
        self._trail = hashlib.sha256() if mesh is not None else None
        # True while every logits row computed for a live request so far
        # was finite; read on the host only by :attr:`logits_finite`
        self._finite = torch.ones((), dtype=torch.bool, device=self.device)

    # ----------------------------------------------------------- device

    def clock(self) -> float:
        """The time the host decides by: ``time.perf_counter()``, and on a
        mesh rank 0's, broadcast to every rank (a collective: every rank
        reads it at the same points of the same host loop)."""
        now = time.perf_counter()
        return now if self.mesh is None else C.broadcast_scalar(now,
                                                                self.mesh)

    def _sample(self, logits: torch.Tensor, keys: torch.Tensor
                ) -> torch.Tensor:
        """One token a row from logits (n, V), or from this rank's block
        of the vocabulary (n, V / ranks) where the mesh splits it: its
        argmax gathered under greedy, the whole rows otherwise. The same
        tokens on every rank of ``model``."""
        if self._tp is None or logits.shape[-1] == self.cfg.vocab_size:
            return sampling.sample(self.sampler, logits, keys)
        if not self.sampler.stochastic:
            return C.argmax_vocab(logits, self._tp)
        return sampling.sample(self.sampler,
                               C.gather_vocab(logits, self._tp), keys)

    def _every_slot(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a per-slot tensor -> every slot's, gathered
        over ``data`` where the mesh splits the slots."""
        if self.cache.sharding is None or not self.cache.sharding.slots_split:
            return x
        return C.all_gather_rows(x.contiguous(), self.mesh, "data")

    def _outside_ticks(self, fn: Callable, *args):
        """Call ``fn`` and count the ``flash_decode`` launches it made
        (admission, chunks, restores and snapshots make none)."""
        before = fd.LAUNCHES["flash_decode"]
        out = fn(*args)
        self.stats["flash_decode_outside_ticks"] += \
            fd.LAUNCHES["flash_decode"] - before
        return out

    def _decode(self, live: Optional[torch.Tensor] = None) -> None:
        """One token for every slot: decode, fold each slot's key with
        the position the token is written at, sample — on the device.
        With ``live`` (slots,) bool the masked rows keep their cache and
        their token (the masked live decode)."""
        before = fd.LAUNCHES["flash_decode"]
        logits, cache = self.model.decode_step(
            self.params, self.cache.data, self._toks,
            use_flash=self.use_flash, live=live, mesh=self.mesh)
        self.stats["decode_calls"] += 1
        self.stats["flash_decode_launches"] += \
            fd.LAUNCHES["flash_decode"] - before
        ok = torch.isfinite(logits)
        if live is not None:
            ok = ok | ~live[:, None, None]
        self._finite &= ok.all()
        keys = sampling.fold_positions(self._keys, cache["pos"])
        nxt = self._sample(logits[:, -1], keys)[:, None]
        self._toks = nxt if live is None else torch.where(
            live[:, None], nxt, self._toks)

    def _admit(self, prompt: torch.Tensor, lengths: torch.Tensor,
               slot_ids: torch.Tensor, req_keys: torch.Tensor
               ) -> torch.Tensor:
        """Prefill a group into its slots; sample its first tokens. On a
        mesh a rank prefills the rows whose slots it holds (the moe
        family over ``data``: the whole group, keeping those rows), and
        the ranks of ``data`` sum their first tokens (each row's is
        nonzero on its own rank only), so every rank returns every
        row's."""
        if self.mesh is not None:
            return self._admit_on_mesh(prompt, lengths, slot_ids, req_keys)
        logits, _ = self.model.prefill_at(self.params, self.cache.data,
                                          prompt, slot_ids, lengths=lengths)
        self._finite &= torch.isfinite(logits).all()
        self._keys[slot_ids] = req_keys
        first = sampling.sample(
            self.sampler, logits, sampling.fold_positions(req_keys, lengths))
        self._toks[slot_ids, 0] = first
        return first

    def _admit_on_mesh(self, prompt, lengths, slot_ids, req_keys
                       ) -> torch.Tensor:
        blk = self.cache.slot_block
        ids = slot_ids.cpu()
        rows = torch.nonzero((ids >= blk.start) & (ids < blk.stop))[:, 0]
        first = torch.zeros(len(ids), dtype=torch.int32, device=self.device)
        if len(rows):
            local = (ids[rows] - blk.start).to(self.device)
            rows = rows.to(self.device)
            if self.cfg.family == "moe" and self.cache.sharding.slots_split:
                # the MoE routes the group's tokens together: prefill it
                # whole, keep this rank's rows
                logits, _ = self.model.prefill_at(
                    self.params, self.cache.data, prompt, local,
                    lengths=lengths, mesh=self.mesh, write=rows)
                logits = logits[rows]
            else:
                logits, _ = self.model.prefill_at(
                    self.params, self.cache.data, prompt[rows], local,
                    lengths=lengths[rows], mesh=self.mesh)
            self._finite &= torch.isfinite(logits).all()
            self._keys[local] = req_keys[rows]
            mine = self._sample(logits, sampling.fold_positions(
                req_keys[rows], lengths[rows]))
            self._toks[local, 0] = mine
            first[rows] = mine
        if self.cache.sharding.slots_split:
            C.all_reduce_sum(first, self.mesh, "data")
        return first

    def _admit_chunk(self, slot_ids: np.ndarray, chunk: np.ndarray,
                     start: np.ndarray, cl: np.ndarray, full: np.ndarray,
                     rids: list, done: np.ndarray) -> np.ndarray:
        """One ``prefill_chunk_at`` call over the mid-prefill rows: rows
        with ``cl`` > 0 take their request's key; rows completing their
        prompt (``done``) sample their first token from the chunk's last
        valid logits, folded at the prompt length — the stream of a
        monolithic admission. Returns the first tokens (host)."""
        dev = self.device
        slots_t = torch.from_numpy(slot_ids).to(dev, torch.long)
        logits, _ = self.model.prefill_chunk_at(
            self.params, self.cache.data, torch.from_numpy(chunk).to(dev),
            slots_t, start=start, chunk_lengths=cl)
        write = torch.from_numpy(np.nonzero(cl > 0)[0]).to(dev)
        self._finite &= torch.isfinite(logits[write]).all()
        req_keys = sampling.make_keys(self.seed, rids, dev)
        self._keys[slots_t[write]] = req_keys[write]
        first = sampling.sample(
            self.sampler, logits, sampling.fold_positions(
                req_keys, torch.from_numpy(full).to(dev)))
        sel = torch.from_numpy(np.nonzero(done & (cl > 0))[0]).to(dev)
        self._toks[slots_t[sel], 0] = first[sel]
        return first.cpu().numpy()

    def _copy_rows(self, dst: dict, src: dict, pairs) -> None:
        """dst[slot] <- src[slot'] for each (dst slot, src slot) of
        ``pairs``, every leaf and ``pos``: one on-device copy of a
        slot's whole state per pair, with no temporary."""
        for d, s_ in pairs:
            for name, big in dst.items():
                if name == "pos":
                    big[d].copy_(src[name][s_])
                else:
                    big[:, d].copy_(src[name][:, s_])

    def _restore(self, pairs) -> None:
        """cache[slot] <- store[entry] for each (slot, entry): the prefix
        copy that replaces recomputing the matched prefix."""
        self._copy_rows(self.cache.data, self.store.data, pairs)

    def _snap(self, pairs) -> None:
        """store[entry] <- cache[slot] for each (entry, slot): a slot's
        complete decode state snapshotted into the prefix store."""
        self._copy_rows(self.store.data, self.cache.data, pairs)

    @property
    def logits_finite(self) -> bool:
        """Whether every logits row of every decode step and admission
        so far was finite, for the live requests (one host read)."""
        return bool(self._finite.item())

    # ------------------------------------------------------------- host

    def submit(self, tokens, max_new_tokens: int, *,
               eos_id: Optional[int] = None,
               rid: Optional[int] = None, tier: int = 0) -> int:
        """Enqueue one request (bounded queue); returns its rid."""
        if rid is None:
            rid = self._next_rid
        self._next_rid = max(self._next_rid, rid) + 1
        req = Request(rid=rid, tokens=np.asarray(tokens),
                      max_new_tokens=max_new_tokens, eos_id=eos_id,
                      tier=tier)
        self.scheduler.submit(req, now=self.clock())
        return rid

    def _admit_budget(self) -> Optional[int]:
        """Admissions allowed this tick: the static ``admit_limit`` cap
        combined with the autoscaled slot target."""
        lim = self.admit_limit
        if self.min_slots is not None:
            budget = max(0, self._slot_target - len(self.scheduler.active))
            lim = budget if lim is None else min(lim, budget)
        return lim

    def _autoscale(self) -> None:
        if self.min_slots is None:
            return
        if self.scheduler.queued > 0:
            self._slot_target = min(self.cache.slots, self._slot_target + 1)
        else:
            self._slot_target = max(self.min_slots, self._slot_target - 1)

    def _admit_pending(self) -> list[FinishedRequest]:
        finished = []
        for pad_len, group in sorted(
                self.scheduler.pop_admissions(self._admit_budget()).items()):
            group = [(s, req, t0) for s, req, t0 in group
                     if self.scheduler.claim_popped(s, req.rid)]
            if not group:
                continue
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
            first = self._outside_ticks(
                self._admit, torch.from_numpy(prompt).to(self.device),
                torch.from_numpy(lengths).to(self.device), slot_ids,
                req_keys)
            self.stats["admit_calls"] += 1
            first = first.cpu().numpy()
            now = self.clock()
            for (slot, req, _), tok in zip(group, first):
                self.stats["tokens_out"] += 1
                if self._trail is not None:
                    self._trail.update(np.asarray([req.rid, slot, int(tok)],
                                                  np.int64).tobytes())
                fin = self.scheduler.record(slot, int(tok), now)
                if fin is not None:
                    finished.append(fin)
        return finished

    # --------------------------------------------------- chunked admission

    def _record(self, slot: int, token: int, now: float,
                finished: list) -> None:
        """Record one emitted token; on retirement queue a prefix-store
        snapshot of prompt + emitted[:-1] (exactly the tokens whose
        state is resident — the last sampled token was never fed back),
        which is what a follow-up session turn will prefix-match."""
        st = self.scheduler.active[slot]
        self.stats["tokens_out"] += 1
        if self._trail is not None:
            self._trail.update(np.asarray([st.request.rid, slot, token],
                                          np.int64).tobytes())
        fin = self.scheduler.record(slot, token, now)
        if fin is None:
            return
        if self.pool is not None:
            # this slot's resident tokens: the CONTINUATION prompt (which
            # already holds any pre-preemption output) plus the tokens
            # emitted by this attempt, minus the never-fed last one
            self._queue_snapshot(
                np.concatenate([st.request.tokens,
                                np.asarray(st.emitted[:-1], np.int32)]),
                slot)
        finished.append(fin)

    def _queue_snapshot(self, tokens: np.ndarray, slot: int) -> None:
        e = self.pool.insert(tokens)
        if e is not None:
            self._snap_q.append((e, slot))

    def _flush_snaps(self) -> None:
        """Copy every snapshot queued since the last flush. Must run
        BEFORE anything rewrites the source slots (the next decode or
        chunk for live rows, the next admission for freed ones) so each
        stored state matches its token key. A later snapshot into the
        same entry wins, as the reference's masked select does."""
        if not self._snap_q:
            return
        by_entry = {e: slot for e, slot in self._snap_q}
        self._snap_q.clear()
        self.stats["snap_calls"] += 1
        self._outside_ticks(self._snap, sorted(by_entry.items()))

    def _admit_chunked(self) -> None:
        """Move queued requests into slots on the chunk path: consult
        the prefix pool, restore matched prefix states on the device
        (pinning their entries), and leave each row mid-prefill."""
        groups = self.scheduler.pop_admissions(self._admit_budget())
        rows = [rt for g in sorted(groups) for rt in groups[g]]
        rows = [(slot, req, t0) for slot, req, t0 in rows
                if self.scheduler.claim_popped(slot, req.rid)]
        if not rows:
            return
        restores = []
        for slot, req, _t0 in rows:
            start, hold = 0, None
            if self.pool is not None and req.prompt_len >= 2:
                # match capped at prompt_len - 1: at least one suffix
                # token must run to produce the first-token logits
                m = self.pool.acquire(req.tokens[:req.prompt_len - 1])
                if m is not None:
                    hold, start = m
                    restores.append((slot, hold))
                    self.stats["prefix_hits"] += 1
                    self.stats["prefix_hit_tokens"] += start
            # a preempted request's snapshot hold is released only now,
            # AFTER acquire pinned it again — the entry stays live from
            # preemption through replay with no eviction window
            prev = self._preempt_holds.pop(req.rid, None)
            if prev is not None:
                self.pool.release(prev)
            self._pending.append(_PendingRow(slot, req, start, hold))
            self._prefilling.add(slot)
        if restores:
            self.stats["restore_calls"] += 1
            self._outside_ticks(self._restore, restores)

    def _advance_chunks(self, finished: list) -> None:
        """Advance every mid-prefill slot by one chunk (one
        ``prefill_chunk_at`` call over the pending rows). Rows completing
        their prompt emit their first token and join the decode batch
        this tick."""
        if not self._pending:
            return
        if self.prefill_chunk is not None:
            C = self.prefill_chunk
        else:   # prefix-only mode: drain each suffix in one shot
            C = self.scheduler.padded_len(
                max(r.req.prompt_len - r.start for r in self._pending))
        # the row count padded to the next power of two (capped at the
        # slot count), as the reference pads it: pad rows point at
        # DISTINCT unused slots with cl == 0, so they pass through
        # untouched (and a MoE routes the same rows as the reference's)
        S = self.cache.slots
        n_real = len(self._pending)
        n_rows = n_real
        if n_rows & (n_rows - 1):
            n_rows = 1 << n_rows.bit_length()
        n_rows = min(n_rows, S)
        used = {r.slot for r in self._pending}
        spare = iter(s for s in range(S) if s not in used)
        slot_ids = np.zeros((n_rows,), np.int64)
        chunk = np.zeros((n_rows, C), np.int32)
        start = np.zeros((n_rows,), np.int32)
        cl = np.zeros((n_rows,), np.int32)
        full = np.ones((n_rows,), np.int32)
        rids = [0] * n_rows
        done = np.zeros((n_rows,), bool)
        for i in range(n_real, n_rows):
            slot_ids[i] = next(spare)
        for i, r in enumerate(self._pending):
            li = r.req.prompt_len
            n = min(C, li - r.start)
            slot_ids[i] = r.slot
            chunk[i, :n] = r.req.tokens[r.start:r.start + n]
            start[i] = r.start
            cl[i] = n
            full[i] = li
            rids[i] = r.req.rid
            done[i] = r.start + n == li
        self.stats["chunk_calls"] += 1
        first = self._outside_ticks(self._admit_chunk, slot_ids, chunk,
                                    start, cl, full, rids, done)
        now = self.clock()
        still = []
        for i, r in enumerate(self._pending):
            r.start += int(cl[i])
            if done[i]:
                self._prefilling.discard(r.slot)
                if r.hold is not None:
                    self.pool.release(r.hold)
                    r.hold = None
                if self.pool is not None:
                    self._queue_snapshot(r.req.tokens, r.slot)
                self._record(r.slot, int(first[i]), now, finished)
            else:
                if self.pool is not None \
                        and r.req.prompt_len - r.start <= C:
                    # the LAST chunk-boundary snapshot only: it still
                    # lets a concurrent request sharing only PART of this
                    # prompt (a system prompt) hit before this one
                    # finishes prefilling, without one never-reused entry
                    # per chunk of distinct-suffix traffic
                    self._queue_snapshot(r.req.tokens[:r.start], r.slot)
                still.append(r)
        self._pending = still

    def _preempt_pass(self) -> None:
        """Evict SLO-selected victims so deadline-risk queued requests
        admit this same tick. Each victim's resident state is inserted
        into the prefix store and PINNED under its rid before the slot
        is surrendered; the snapshot copy flushes before admission can
        rewrite the freed rows."""
        victims = self.scheduler.select_preemptions(
            prefilling=frozenset(self._prefilling))
        if not victims:
            return
        for slot in victims:
            st = self.scheduler.active[slot]
            if self.pool is not None:
                resident = np.concatenate(
                    [st.request.tokens,
                     np.asarray(st.emitted[:-1], np.int32)])
                self._hold_preempt_snapshot(st.request.rid, resident, slot)
            self.stats["preemptions"] += 1
            self.stats["replayed_tokens"] += len(st.emitted)
            self.scheduler.preempt(slot, self.clock())
        self._flush_snaps()     # before admission reuses the freed slots

    def _hold_preempt_snapshot(self, rid: int, tokens: np.ndarray,
                               slot: int) -> None:
        if len(tokens) < self.pool.min_tokens:
            return
        e = self.pool.insert(tokens)
        if e is not None:
            self._snap_q.append((e, slot))
        else:
            # exact prefix already stored (e.g. a second preemption at
            # the same position): its state is byte-identical, reuse it
            e = self.pool.index.get(tokens)
        if e is None:
            return          # pool fully pinned: re-admission recomputes
        self.pool.pin(e)
        prev = self._preempt_holds.pop(rid, None)
        if prev is not None:
            self.pool.release(prev)
        self._preempt_holds[rid] = e

    def cancel(self, rid: int) -> bool:
        """Abort a request: drop it from the queue (tombstoning it if
        its admission group was already popped), or retire its slot
        mid-prefill/mid-decode (releasing any pinned prefix entry). The
        survivor slots are untouched — a cancelled row is masked off the
        decode from the next tick on."""
        kind, slot = self.scheduler.cancel(rid)
        if kind is None:
            return False
        hold = self._preempt_holds.pop(rid, None)
        if hold is not None:
            self.pool.release(hold)
        if kind == "active":
            self._prefilling.discard(slot)
            for r in list(self._pending):
                if r.slot == slot:
                    if r.hold is not None:
                        self.pool.release(r.hold)
                    self._pending.remove(r)
        return True

    # -------------------------------------------------------------- tick

    def step(self) -> list[FinishedRequest]:
        """One engine tick: preempt SLO victims (priority mode), admit
        into free slots (chunk path: restore matched prefixes and
        advance one chunk), then decode ONE token for every live
        resident sequence (one ``decode_step`` call)."""
        finished: list[FinishedRequest] = []
        self.stats["ticks"] += 1
        self._autoscale()
        self.stats["slot_target_sum"] += self._slot_target
        if self.preempt_enabled:
            self._preempt_pass()
        if self._chunked:
            self._admit_chunked()
            self._advance_chunks(finished)
            self._flush_snaps()     # before decode rewrites source rows
        else:
            finished.extend(self._admit_pending())
        live = [s for s in self.scheduler.active
                if s not in self._prefilling]
        if live:
            self.stats["decode_steps"] += 1
            self.stats["occupancy_sum"] += len(live) / self.cache.slots
            if self._chunked:
                mask = np.zeros((self.cache.slots,), bool)
                mask[live] = True
                self._decode(torch.from_numpy(mask).to(self.device))
            else:
                self._decode()
            # the ONLY host copy (every slot's: gathered over a mesh's data)
            emitted = self._every_slot(self._toks[:, 0]).cpu().numpy()
            now = self.clock()
            for slot in live:
                self._record(slot, int(emitted[slot]), now, finished)
        self._flush_snaps()         # retirement snapshots from this tick
        return finished

    def run(self, requests: Optional[Iterable] = None
            ) -> list[FinishedRequest]:
        """Submit ``requests`` (Request objects or (tokens, max_new)
        pairs), then step until queue and slots drain."""
        for r in requests or ():
            if isinstance(r, Request):
                self.submit(r.tokens, r.max_new_tokens, eos_id=r.eos_id,
                            rid=r.rid, tier=r.tier)
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

    def scheduler_digest(self) -> int:
        """A 62-bit digest of the host's decisions so far: on a mesh every
        token recorded (request, slot, token, in order), the free slots,
        the queue and the counters that are not times. Equal on every rank
        of a mesh whose ranks decided alike."""
        h = self._trail.copy() if self._trail is not None \
            else hashlib.sha256()
        h.update(repr((sorted(self.scheduler.active),
                       [q.req.rid for q in self.scheduler.queue],
                       {k: v for k, v in sorted(self.stats.items())
                        if not k.startswith("flash_decode")})).encode())
        return int.from_bytes(h.digest()[:8], "little") >> 2

    def ranks_agree(self) -> bool:
        """Whether every rank of the mesh has the same
        :meth:`scheduler_digest` (a collective: every rank calls it).
        True off a mesh."""
        return C.all_agree(self.scheduler_digest(), self.mesh)

    @property
    def occupancy(self) -> float:
        """Mean fraction of slots doing useful work per decode step."""
        steps = self.stats["decode_steps"]
        return self.stats["occupancy_sum"] / steps if steps else 0.0

    def reset_stats(self) -> None:
        """Zero the step/occupancy counters (e.g. after a warm-up) and
        the prefix pool's."""
        self.stats = {k: 0.0 if k in ("occupancy_sum", "slot_target_sum")
                      else 0 for k in self.stats}
        if self.pool is not None:
            self.pool.stats = {k: 0 for k in self.pool.stats}
