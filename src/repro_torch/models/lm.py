"""Decoder-only language model, the dense, MoE, SSM, hybrid and vlm
families (with GQA or MLA attention): port of ``repro/models/lm.py`` —
init, the training forward, the decode cache, one-token decode,
(length-masked) prefill and slot admission into a persistent cache.

Params are nested dicts in the reference's leaf layouts: per-layer
leaves stacked on a leading ``(L, ...)`` axis under ``"layers"``,
``(in, out)`` dense weights, an ``(V, d)`` embedding (tied to the
unembedding when the config says so), f32 norm scales. The layer loop
is a Python loop over ``L`` views of the stacked leaves. In training
(:meth:`forward`) ``cfg.remat`` checkpoints each layer
(``torch.utils.checkpoint``, non-reentrant), as the reference's
``jax.checkpoint`` of its scan body does: only the residual stream
between layers is kept for the backward pass. ``remat_block = b``
(dividing the layer count) nests that in a second level, as the
reference's two-level remat: an outer checkpoint over each block of b
layers keeps only the L/b block inputs, and the inner per-layer
checkpoints keep b more while one block's backward runs. Where b does
not divide the layer count the flat per-layer remat runs, as in the
reference.

The MoE family swaps each layer's MLP for
:func:`~repro_torch.models.moe.moe_block`. In training its load-balance
loss is carried with the residual stream through every layer (and every
checkpoint) and summed in layer order, as the reference's scan carry
does; decode and prefill discard it. Routing couples the tokens of one
call through the experts' capacity, so decode routes the whole slot
batch and prefill the whole padded prompt buffer, as the reference.

With ``use_mla`` each layer's attention is
:mod:`repro_torch.models.mla`'s: the expanded block in training and
prefill, the absorbed decode over a latent cache.

The SSM family (falcon-mamba-7b) is a stack of ``x + mamba1(norm(x))``
layers (:mod:`repro_torch.models.ssm`); the hybrid (zamba2-7b) stacks
Mamba-2 layers and, after every ``attn_every``-th one, applies ONE
shared attention + MLP block (``params["shared"]``, the same weights at
every application; a Python ``if`` where the reference has
``lax.cond``), so the shared block's gradient is the sum over its
applications.

The vlm family (paligemma-3b) is the dense stack fed the stub
frontend's image patch embeddings (B, n_img, d) ahead of the text
tokens, as a bidirectional prefix: the attention's mask lets a position
inside the prefix see the whole prefix (``prefix_len``), the rest is
causal. The forward returns logits over the whole sequence (the loss
slices the prefix off); prefill takes the image embeddings too, and its
cache ``pos`` counts the image tokens. Decode is the dense family's: a
decoded token sits after the prefix.

The decode cache is the reference's: ``{"pos": (B,) int32, "k", "v":
(L, B, S, Hkv, hd)}`` (with a sliding window S = min(capacity, window):
a ring, position p in row p % S); with MLA ``{"pos", "ckv": (L, B, S, r),
"krope": (L, B, S, rope)}``; for the SSM family ``{"pos", "conv":
(L, B, K-1, C), "h": (L, B, d_inner, N) f32}``, and for the hybrid
``{"pos", "conv", "h": (L, B, heads, hd, N) f32, "attn_k", "attn_v":
(A, B, S, Hkv, hd)}``, one K/V cache per application of the shared
block (A = ceil(L / attn_every)). Where the reference returns new
arrays (and donates the old ones to XLA), the port writes in place:
:meth:`decode_step` writes one row per sequence and layer of each K/V
or latent leaf, each Mamba layer's new conv and recurrent state, and
advances ``pos`` (with ``live``, only for the rows it keeps: the masked
live decode of chunked admission); :meth:`prefill_at` writes the
admitted slots' prompt rows, their whole recurrent state and ``pos``;
:meth:`prefill_chunk_at` resumes a prefill one chunk at a time inside
the resident cache, writing each chunk's valid positions and reading
only the chunk rows' slots. All return the cache they were given.

A prompt longer than a ring (a window's, or the hybrid's shared block's
cache) is aligned as the reference aligns it: each ring row holds the
newest position that maps to it, per row of a right-padded batch
(:func:`_ring_gather`).

On a serving mesh (:meth:`decode_step` and :meth:`prefill_at` with
``mesh``) the cache is this rank's
(:class:`~repro_torch.distributed.sharding.LocalCache`: its slots, and
its stripe of the sequence where the mesh splits it) and, on a
``model`` axis above 1 (the dense and moe families, MLA included), the
params are this rank's blocks: the lookup and the logits are
vocab-parallel, the attention (GQA or MLA) and MLP blocks Megatron's, the
MoE blocks expert-parallel, the decode attention (``flash_decode``, or
MLA's absorbed decode over the latent cache) runs on the stripe and
merges the ranks' partials, and prefill writes only the stripe's rows.
Where the slots are split over ``data``, decode's MoE blocks route every
slot of the mesh together, and each rank prefills a whole admitted group
(``prefill_at(write=)``).

The encdec family is :mod:`repro_torch.models.encdec`'s. MLA with a
window or the softcap raises ``NotImplementedError`` wherever a decode
cache is made (:func:`repro_torch.models.attention.check_decode_supported`).
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import collectives as C
from repro_torch.distributed.constrain import current_mesh, data_rows
from repro_torch.distributed.sharding import LocalCache, check_model_parallel
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import ssm as SSM
from repro_torch.models.mlp import init_mlp, mlp_block
from repro_torch.models.moe import init_moe, moe_block
from repro_torch.treepath import tree_flatten_with_path, tree_unflatten

Pytree = Any

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")
RECURRENT = ("ssm", "hybrid")
# cache leaves without a sequence axis: a slot's whole recurrent state
STATE_LEAVES = ("conv", "h")


class LanguageModel:
    def __init__(self, cfg):
        if cfg.family not in FAMILIES:
            raise ValueError(f"unknown model family {cfg.family!r} (the LM "
                             f"covers {', '.join(FAMILIES)})")
        self.cfg = cfg
        self.dtype = DTYPES[cfg.dtype]
        self.recurrent = cfg.family in RECURRENT

    def _ssm_forward(self, p, x, **kw):
        fwd = (SSM.mamba1_forward if self.cfg.family == "ssm"
               else SSM.mamba2_forward)
        return fwd(self.cfg, p, x, **kw)

    def _shared_applications(self) -> int:
        """How often the hybrid's shared block runs: ceil(L / attn_every)."""
        every = self.cfg.attn_every
        return -(-self.cfg.num_layers // every) if every else 0

    def _applies_shared(self, i: int) -> bool:
        """Whether the hybrid's shared block follows layer ``i``."""
        every = self.cfg.attn_every
        return self.cfg.family == "hybrid" and bool(every) and i % every == 0

    def _check_decode(self) -> None:
        """Decode, prefill and serving refuse what
        ``check_decode_supported`` refuses (MLA with a window or the
        softcap)."""
        A.check_decode_supported(self.cfg)

    def _kv_len(self, seq_len: int) -> int:
        """Rows of an attention K/V cache of capacity ``seq_len``: the
        window where one is set (a ring), as the reference's."""
        win = self.cfg.sliding_window
        return min(seq_len, win) if win else seq_len

    # ------------------------------------------------------------------ init

    def _init_layer(self, gen: torch.Generator, device) -> dict:
        cfg, d, dt = self.cfg, self.cfg.d_model, self.dtype
        if self.recurrent:
            init_ssm = (SSM.init_mamba1 if cfg.family == "ssm"
                        else SSM.init_mamba2)
            return {"ln1": L.init_norm(cfg, d, device),
                    "ssm": init_ssm(gen, cfg, dt, device)}
        init_attn = MLA.init_mla if cfg.use_mla else A.init_attention
        p = {"ln1": L.init_norm(cfg, d, device),
             "ln2": L.init_norm(cfg, d, device),
             "attn": init_attn(gen, cfg, d, dt, device)}
        if cfg.family == "moe":
            p["moe"] = init_moe(gen, cfg, d, dt, device)
        else:
            p["mlp"] = init_mlp(gen, cfg, d, cfg.d_ff, dt, device)
        return p

    def init(self, generator: torch.Generator, device) -> Pytree:
        """Random params at the reference's distributions (fan-in normal
        dense weights, embedding std 0.02, norms at one), drawn from
        ``generator`` (a CPU generator) in a fixed order and moved to
        ``device``: one seed gives the same weights on every device. The
        hybrid's shared block is drawn last, as the reference orders its
        keys."""
        cfg, d, dt = self.cfg, self.cfg.d_model, self.dtype
        embed = L.embed_init(generator, cfg.vocab_size, d, dt, device)
        layers = [self._init_layer(generator, device)
                  for _ in range(cfg.num_layers)]
        params = {"embed": embed,
                  "layers": _stack(layers),
                  "final_norm": L.init_norm(cfg, d, device)}
        if not cfg.tie_embeddings:
            params["unembed"] = L.dense_init(generator, d, cfg.vocab_size,
                                             dt, device)
        if cfg.family == "hybrid":
            params["shared"] = {
                "ln1": L.init_norm(cfg, d, device),
                "attn": A.init_attention(generator, cfg, d, dt, device),
                "ln2": L.init_norm(cfg, d, device),
                "mlp": init_mlp(generator, cfg, d, cfg.d_ff, dt, device)}
        return params

    def stacked_marker(self, params: Pytree) -> Pytree:
        """Bool pytree: True for (L, ...)-stacked leaves (under 'layers')."""
        leaves, treedef = tree_flatten_with_path(params)
        return tree_unflatten(treedef, ["layers" in path
                                        for path, _ in leaves])

    # ------------------------------------------------------------- embedding

    def embed_tokens(self, params, tokens: torch.Tensor, tp=None
                     ) -> torch.Tensor:
        """The token embeddings. Under a tensor-parallel mesh ``tp`` whose
        ``model`` axis splits the vocabulary (``embed``'s rows) the lookup
        is vocab-parallel: each rank looks up the tokens in its rows,
        zeros the others, and the ranks' lookups are summed."""
        emb = params["embed"]
        if tp is None or emb.shape[0] == self.cfg.vocab_size:
            return F.embedding(tokens, emb)
        n = emb.shape[0]
        local = tokens - tp.coords["model"] * n
        inside = (local >= 0) & (local < n)
        x = F.embedding(torch.where(inside, local, 0), emb)
        return C.reduce_from_model(x.masked_fill(~inside[..., None], 0), tp)

    def logits(self, params, x: torch.Tensor, tp=None) -> torch.Tensor:
        """Final norm, then the matmul in the params' dtype, then f32.
        Under a mesh ``tp`` that splits the unembedding's columns (the
        tied embedding's rows) the logits stay this rank's block of the
        vocabulary (the reference's ``shard_batch(..., last="model")``),
        the hidden state passing ``copy_to_model`` first."""
        x = L.apply_norm(self.cfg, x, params["final_norm"])
        w = self.unembed_matrix(params)
        if tp is not None and w.shape[1] != self.cfg.vocab_size:
            x = C.copy_to_model(x, tp)
        return (x @ w).float()

    def unembed_matrix(self, params) -> torch.Tensor:
        return (params["embed"].T if self.cfg.tie_embeddings
                else params["unembed"])

    # ----------------------------------------------------------------- train

    def attention_block(self, params_attn, h: torch.Tensor,
                        positions: torch.Tensor,
                        prefix_len: Optional[int] = None, tp=None
                        ) -> torch.Tensor:
        """The layer's attention sub-block for training: MLA's expanded
        block or the GQA block, with the vlm family's bidirectional
        prefix of ``prefix_len`` positions; ``tp``: the tensor-parallel
        mesh (Megatron's split by heads, for both)."""
        if self.cfg.use_mla:
            return MLA.mla_block(self.cfg, params_attn, h, positions, tp=tp)
        return A.attention_block(self.cfg, params_attn, h, positions,
                                 prefix_len=prefix_len, tp=tp)

    def _ffn(self, params_l, h: torch.Tensor, tp=None, data=None
             ) -> tuple[torch.Tensor, Optional[dict]]:
        """The layer's MLP, or its MoE block with the block's aux
        (``data``: the mesh whose ``data`` axis splits ``h``'s rows, for
        the MoE's routing of the global batch)."""
        if self.cfg.family == "moe":
            if tp is None and data is None:
                return moe_block(self.cfg, params_l["moe"], h)
            return moe_block(self.cfg, params_l["moe"], h, tp=tp,
                             data=data)
        return mlp_block(self.cfg, params_l["mlp"], h, tp), None

    def _shared_block(self, shared, x: torch.Tensor,
                      positions: torch.Tensor) -> torch.Tensor:
        """The hybrid's shared attention + MLP block, in training."""
        cfg = self.cfg
        h = L.apply_norm(cfg, x, shared["ln1"])
        x = x + A.attention_block(cfg, shared["attn"], h, positions)
        h = L.apply_norm(cfg, x, shared["ln2"])
        return x + mlp_block(cfg, shared["mlp"], h)

    def _layer_train(self, params_l, x: torch.Tensor, aux: torch.Tensor,
                     positions: torch.Tensor, shared=None,
                     prefix_len: Optional[int] = None, tp=None, data=None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """One layer on the carry (x, aux): aux gains the MoE block's
        load-balance loss. A Mamba layer is ``x + ssm(norm(x))``, then
        the hybrid's shared block where ``shared`` is given."""
        cfg = self.cfg
        h = L.apply_norm(cfg, x, params_l["ln1"])
        if self.recurrent:
            x = x + self._ssm_forward(params_l["ssm"], h)[0]
            if shared is not None:
                x = self._shared_block(shared, x, positions)
            return x, aux
        x = x + self.attention_block(params_l["attn"], h, positions,
                                     prefix_len, tp)
        h = L.apply_norm(cfg, x, params_l["ln2"])
        y, moe_aux = self._ffn(params_l, h, tp, data)
        if moe_aux is not None:
            aux = aux + moe_aux["aux_loss"]
        return x + y, aux

    def _block_train(self, layers, shared, x: torch.Tensor,
                     aux: torch.Tensor, positions: torch.Tensor, idx: range,
                     prefix_len: Optional[int] = None, tp=None, data=None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """Layers ``idx`` in order on the carry (x, aux), each
        checkpointed when ``cfg.remat``; ``shared``: the hybrid's shared
        block, applied after the layers :meth:`_applies_shared` names.
        ``tp`` and ``data`` ride in the checkpoints' arguments, so a
        recompute (on the autograd engine's thread, which has no ambient
        mesh) splits and routes as the forward did."""
        for i in idx:
            args = (_index(layers, i), x, aux, positions,
                    shared if self._applies_shared(i) else None, prefix_len,
                    tp, data)
            if self.cfg.remat:
                x, aux = checkpoint(self._layer_train, *args,
                                    use_reentrant=False)
            else:
                x, aux = self._layer_train(*args)
        return x, aux

    def forward(self, params, tokens: torch.Tensor, *,
                image_embeddings: Optional[torch.Tensor] = None,
                return_hidden: bool = False
                ) -> tuple[torch.Tensor, dict]:
        """Train/eval forward. tokens (B, S_text) int; for the vlm family
        ``image_embeddings`` (B, n_img, d), prepended as a bidirectional
        prefix, so S = n_img + S_text.

        Returns (logits (B, S, V) f32, {"aux_loss": f32 scalar: the MoE
        blocks' load-balance losses summed over the layers, 0 for the
        dense family}) — or the final-norm hidden states (B, S, d) when
        ``return_hidden``. The reference wraps each layer's carry in an
        optimization barrier, an XLA layout workaround that is the
        identity in value and in gradient; it has no counterpart here.

        Under an ambient mesh whose ``model`` axis has more than one rank
        (the dense and moe families; any other raises) ``params`` are
        this rank's shards and the forward is Megatron's: a
        vocab-parallel embedding, column- then row-parallel attention and
        MLP blocks, expert-parallel MoE blocks, and logits over this
        rank's block of the vocabulary. Within
        :func:`~repro_torch.distributed.constrain.rows_over_data` the
        tokens are this rank's rows of a batch split over ``data``, and
        the MoE blocks route the global batch.
        """
        cfg = self.cfg
        tp = C.model_parallel(current_mesh())
        if tp is not None:
            check_model_parallel(cfg, tp)
        data = data_rows() if cfg.family == "moe" else None
        x, prefix_len = self._embed_inputs(params, tokens, image_embeddings,
                                           tp)
        positions = torch.arange(x.shape[1], device=x.device)
        aux = torch.zeros((), device=x.device)
        blk = cfg.remat_block
        shared = params.get("shared")
        if cfg.remat and blk and cfg.num_layers % blk == 0:
            for i in range(0, cfg.num_layers, blk):
                x, aux = checkpoint(self._block_train, params["layers"],
                                    shared, x, aux, positions,
                                    range(i, i + blk), prefix_len, tp,
                                    data, use_reentrant=False)
        else:
            x, aux = self._block_train(params["layers"], shared, x, aux,
                                       positions, range(cfg.num_layers),
                                       prefix_len, tp, data)
        aux = {"aux_loss": aux}
        if return_hidden:
            return L.apply_norm(cfg, x, params["final_norm"]), aux
        return self.logits(params, x, tp), aux

    def _embed_inputs(self, params, tokens: torch.Tensor,
                      image_embeddings: Optional[torch.Tensor], tp=None
                      ) -> tuple[torch.Tensor, Optional[int]]:
        """The embedded tokens, behind the image embeddings for the vlm
        family; and the bidirectional prefix's length (None but for
        vlm)."""
        x = self.embed_tokens(params, tokens, tp)
        if self.cfg.family != "vlm":
            return x, None
        if image_embeddings is None:
            raise ValueError("the vlm family needs its image embeddings "
                             "(the stub frontend's patch embeddings)")
        return (torch.cat([image_embeddings.to(x.dtype), x], dim=1),
                image_embeddings.shape[1])

    # ----------------------------------------------------------------- cache

    def cache_shapes(self, batch: int, seq_len: int) -> dict:
        """Every leaf of the decode cache, ``pos`` first: {name: (shape,
        dtype)}."""
        return dict({"pos": ((batch,), torch.int32)},
                    **self._cache_shapes(batch, seq_len))

    def _cache_shapes(self, batch: int, seq_len: int) -> dict:
        """The decode cache's leaves other than ``pos``: {name: (shape,
        dtype)}. MLA's latent and rope-key caches; the SSM family's conv
        and recurrent states; the hybrid's states and one K/V cache per
        shared-block application; else K and V."""
        cfg, dt, f32 = self.cfg, self.dtype, torch.float32
        L_, K = cfg.num_layers, cfg.ssm_conv
        lead = (L_, batch, seq_len)
        _, Hkv, hd = cfg.attn_dims
        s_kv = self._kv_len(seq_len)
        if cfg.family == "ssm":
            din = cfg.ssm_d_inner
            return {"conv": ((L_, batch, K - 1, din), dt),
                    "h": ((L_, batch, din, cfg.ssm_state), f32)}
        if cfg.family == "hybrid":
            din, N, shd = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_head_dim
            kv = ((self._shared_applications(), batch, s_kv, Hkv, hd), dt)
            return {"conv": ((L_, batch, K - 1,
                              din + 2 * cfg.ssm_groups * N), dt),
                    "h": ((L_, batch, din // shd, shd, N), f32),
                    "attn_k": kv, "attn_v": kv}
        if cfg.use_mla:
            return {"ckv": (lead + (cfg.kv_lora_rank,), dt),
                    "krope": (lead + (cfg.qk_rope_dim,), dt)}
        kv = (L_, batch, s_kv, Hkv, hd)
        return {"k": (kv, dt), "v": (kv, dt)}

    def init_cache(self, batch: int, seq_len: int, *, device=None,
                   sharding=None) -> dict:
        """A zero decode cache of ``batch`` slots and capacity
        ``seq_len``; with ``sharding``
        (:class:`~repro_torch.distributed.sharding.CacheSharding`), this
        rank's leaves of it, as a ``LocalCache`` that knows its
        stripe."""
        self._check_decode()
        cache = {}
        for name, (shape, dt) in self.cache_shapes(batch, seq_len).items():
            if sharding is not None:
                shape = sharding.local_shape(name)
            cache[name] = torch.zeros(shape, dtype=dt, device=device)
        if sharding is None:
            return cache
        return LocalCache(cache, stripe=sharding.stripe,
                          data=sharding.mesh if sharding.slots_split
                          else None)

    def flash_decode_per_step(self) -> int:
        """``flash_decode`` launches one :meth:`decode_step` makes on the
        card: one per GQA layer, or per application of the hybrid's
        shared block; none for MLA or Mamba layers."""
        cfg = self.cfg
        if cfg.family == "hybrid":
            return self._shared_applications()
        return 0 if cfg.family == "ssm" or cfg.use_mla else cfg.num_layers

    def cache_capacity(self, cache: dict) -> Optional[int]:
        """Token capacity of a decode cache, looked up by leaf name as
        the reference does: None for a pure-SSM cache, whose state does
        not grow with the sequence. A rank's stripe of a cache reports
        the whole cache's."""
        stripe = getattr(cache, "stripe", None)
        for name in ("k", "ckv", "attn_k"):
            if name in cache:
                return cache[name].shape[2] * (stripe.count if stripe
                                               else 1)
        return None

    # ---------------------------------------------------------------- decode

    def _layer_decode(self, params_l, x, cache_l: dict, pos, live=None,
                      tp=None, stripe=None, data=None):
        """One layer, one token; writes this layer's cache rows, or its
        new conv and recurrent state (``cache_l``: the layer's views of
        the cache leaves), for the rows ``live`` keeps (all without
        it). ``tp``/``stripe``: the serving mesh's split (the decode
        attention's); ``data``: the mesh whose ``data`` axis splits the
        slots (the MoE routes every slot)."""
        cfg = self.cfg
        h = L.apply_norm(cfg, x, params_l["ln1"])
        if self.recurrent:
            y, st = self._ssm_forward(params_l["ssm"], h, state=cache_l)
            for name in STATE_LEAVES:
                new = st[name]
                if live is not None:
                    keep = live.reshape((-1,) + (1,) * (new.ndim - 1))
                    new = torch.where(keep, new, cache_l[name])
                cache_l[name].copy_(new)
            return x + y
        if cfg.use_mla:
            out, _, _ = MLA.mla_decode(cfg, params_l["attn"], h,
                                       cache_l["ckv"], cache_l["krope"], pos,
                                       live, tp=tp, stripe=stripe)
        else:
            out, _, _ = A.decode_attention(cfg, params_l["attn"], h,
                                           cache_l["k"], cache_l["v"], pos,
                                           live, tp=tp, stripe=stripe)
        x = x + out
        h = L.apply_norm(cfg, x, params_l["ln2"])
        return x + self._ffn(params_l, h, tp, data)[0]

    def _shared_decode(self, shared, x, cache_k, cache_v, pos, live=None,
                       stripe=None):
        """The hybrid's shared block, one token, over one application's
        K/V cache (written in place; ``stripe``: this rank's stripe of
        it)."""
        cfg = self.cfg
        h = L.apply_norm(cfg, x, shared["ln1"])
        out, _, _ = A.decode_attention(cfg, shared["attn"], h, cache_k,
                                       cache_v, pos, live, stripe=stripe)
        x = x + out
        h = L.apply_norm(cfg, x, shared["ln2"])
        return x + mlp_block(cfg, shared["mlp"], h)

    @torch.no_grad()
    def decode_step(self, params, cache: dict, tokens: torch.Tensor, *,
                    use_flash: bool | str = "auto",
                    live: Optional[torch.Tensor] = None, mesh=None
                    ) -> tuple[torch.Tensor, dict]:
        """tokens (B, 1) -> (logits (B, 1, V) f32, the cache, updated in
        place: one row per sequence and layer of each K/V or latent
        leaf, each Mamba layer's conv and recurrent state, and
        ``pos + 1``).

        GQA attention (the dense and MoE layers, the hybrid's shared
        block) runs through the ``flash_decode`` wrapper: one kernel
        launch per layer or shared-block application on CUDA tensors,
        its plain version on CPU tensors. The hybrid's shared block at
        layer i reads and writes K/V cache ``i // attn_every``. MLA's
        absorbed decode and the Mamba layers are torch ops, as the
        reference's are jnp: they launch no kernel. ``use_flash`` only
        checks the placement, as LARS's ``use_kernels`` does:
        ``"auto"`` takes either, ``True`` needs CUDA tensors, ``False``
        CPU tensors.

        ``live`` (B,) bool on the cache's device is the masked live
        decode: every row is computed (the shapes do not depend on the
        mask), but the rows it masks off keep their cache — no K/V or
        latent write, no state update, no ``pos`` advance — and their
        logits are to be discarded. The reference selects old against
        new over every leaf (free under XLA's donation); the port drops
        the writes instead, so no cache leaf is copied.

        ``mesh``: the serving mesh. ``cache`` is then this rank's
        (``LocalCache``: its slots' rows, its stripe of the sequence),
        and on a ``model`` axis above 1 ``params`` are this rank's blocks
        and the logits (B, 1, V / ranks) its block of the vocabulary
        where the unembedding is split. Where the cache's slots are split
        over ``data`` (``cache.data``) the MoE blocks route every slot of
        the mesh at once, as the reference's single-device step does.
        """
        pos = cache["pos"]
        kops.check_use_kernels(use_flash, pos.device, option="use_flash")
        tp = C.model_parallel(mesh)
        if tp is not None:
            check_model_parallel(self.cfg, tp)
        stripe = getattr(cache, "stripe", None)
        data = getattr(cache, "data", None)
        x = self.embed_tokens(params, tokens, tp)
        layers = params["layers"]
        leaves = [name for name in cache
                  if name not in ("pos", "attn_k", "attn_v")]
        for i in range(self.cfg.num_layers):
            x = self._layer_decode(_index(layers, i), x,
                                   {name: cache[name][i] for name in leaves},
                                   pos, live, tp, stripe, data)
            if self._applies_shared(i):
                a = i // self.cfg.attn_every
                x = self._shared_decode(params["shared"], x,
                                        cache["attn_k"][a],
                                        cache["attn_v"][a], pos, live,
                                        stripe)
        pos.add_(1 if live is None else live.to(pos.dtype))
        return self.logits(params, x, tp), cache

    # --------------------------------------------------------------- prefill

    @torch.no_grad()
    def prefill(self, params, tokens: torch.Tensor, *,
                image_embeddings: Optional[torch.Tensor] = None,
                cache_len: Optional[int] = None,
                lengths: Optional[torch.Tensor] = None, mesh=None
                ) -> tuple[torch.Tensor, dict]:
        """Run the full prompt, building a decode cache of capacity
        ``cache_len`` (default: the prompt length). The vlm family's
        prompt is its ``image_embeddings`` and then its tokens, the
        image a bidirectional prefix; its cache ``pos`` counts both, and
        it takes no ``lengths``, as the reference's.

        ``lengths`` (B,) int32 marks per-row true prompt lengths of a
        right-padded token batch: logits come from each row's last valid
        position and the cache ``pos`` is set to ``lengths``. Causality
        makes the padded forward exact for valid positions; pad-position
        cache entries are never read back (decode masks kv_len = pos + 1).
        A windowed K/V cache is a ring (:func:`_align`): with ``lengths``
        each row keeps its own newest positions.
        With MLA the cache takes each layer's latents (c_kv and the roped
        shared key) and the attention runs expanded, as the reference.
        The SSM and hybrid families carry their recurrent state through
        the prompt (:meth:`_prefill_recurrent`). Returns
        (last-valid-token logits (B, V) f32, cache). ``mesh``: a serving
        mesh whose ``model`` axis splits the params (the dense and moe
        families, MLA included): the forward is tensor-parallel, the
        cache's K/V hold every head (MLA's latents are whole: every rank
        computes them from the replicated ``kv_down``) and the logits are
        this rank's block of the vocabulary. The prompts are the whole
        batch on every rank: the MoE blocks route them alone.
        """
        cfg = self.cfg
        self._check_decode()
        if cfg.family == "vlm" and lengths is not None:
            raise ValueError("the vlm family's prefill takes no lengths, as "
                             "the reference's")
        tp = C.model_parallel(mesh)
        if tp is not None:
            check_model_parallel(cfg, tp)
        x, prefix_len = self._embed_inputs(params, tokens, image_embeddings,
                                           tp)
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device)
        cap = cache_len or S
        if self.recurrent:
            logits, cache = self._prefill_recurrent(params, x, positions,
                                                    cap, lengths)
        else:
            rows = {name: [] for name in self._cache_shapes(B, cap)}
            for i in range(cfg.num_layers):
                params_l = _index(params["layers"], i)
                p = params_l["attn"]
                h = L.apply_norm(cfg, x, params_l["ln1"])
                if cfg.use_mla:
                    ckv, krope = MLA._latents(cfg, p, h, positions)
                    x = x + MLA.mla_block(cfg, p, h, positions, tp=tp)
                    rows["ckv"].append(ckv)
                    rows["krope"].append(krope[:, :, 0])
                else:
                    out, k, v = A.prefill_attention(cfg, p, h, positions,
                                                    prefix_len, tp)
                    x = x + out
                    rows["k"].append(k)
                    rows["v"].append(v)
                h = L.apply_norm(cfg, x, params_l["ln2"])
                x = x + self._ffn(params_l, h, tp)[0]
            logits = self._last_valid_logits(params, x, lengths, tp)
            shapes = self._cache_shapes(B, cap)
            windowed = not cfg.use_mla and A.ring_windowed(
                cfg, shapes["k"][0][2])
            cache = {name: _align(
                torch.stack(ts).to(self.dtype), shapes[name][0][2], lengths,
                gather=windowed and lengths is not None,
                roll=bool(cfg.sliding_window))
                for name, ts in rows.items()}
        # a copy: decode_step advances pos in place
        cache["pos"] = (torch.full((B,), S, dtype=torch.int32,
                                   device=x.device)
                        if lengths is None
                        else lengths.to(torch.int32, copy=True))
        return logits, cache

    def _prefill_recurrent(self, params, x: torch.Tensor,
                           positions: torch.Tensor, cap: int,
                           lengths: Optional[torch.Tensor]
                           ) -> tuple[torch.Tensor, dict]:
        """The SSM and hybrid prefill: each layer's full-sequence pass
        from a zero state, masked by ``lengths`` (pad steps are identity
        steps, so the state is each row's after its last true token),
        keeping its conv and recurrent state; at each application of the
        hybrid's shared block, its full-length K and V. Returns (logits,
        the cache without ``pos``).

        The shared block's K/V is aligned as the reference aligns it
        (:func:`_align`): with ``lengths``, each row's ring of the newest
        positions (rows past a short row's length repeat a row that is
        never read); without, the last ``S_buf`` positions rolled to
        their ring rows when the prompt is longer than the cache.
        """
        cfg = self.cfg
        B, S, _ = x.shape
        shapes = self._cache_shapes(B, cap)
        zero = {name: torch.zeros(shapes[name][0][1:], dtype=shapes[name][1],
                                  device=x.device) for name in STATE_LEAVES}
        rows = {name: [] for name in shapes}
        for i in range(cfg.num_layers):
            params_l = _index(params["layers"], i)
            h = L.apply_norm(cfg, x, params_l["ln1"])
            y, st = self._ssm_forward(params_l["ssm"], h, state=zero,
                                      lengths=lengths)
            x = x + y
            for name in STATE_LEAVES:
                rows[name].append(st[name])
            if self._applies_shared(i):
                shared = params["shared"]
                h = L.apply_norm(cfg, x, shared["ln1"])
                out, k, v = A.prefill_attention(cfg, shared["attn"], h,
                                                positions)
                x = x + out
                h = L.apply_norm(cfg, x, shared["ln2"])
                x = x + mlp_block(cfg, shared["mlp"], h)
                rows["attn_k"].append(k)
                rows["attn_v"].append(v)
        cache = {}
        for name, ts in rows.items():
            t = torch.stack(ts).to(shapes[name][1])
            cache[name] = t if name in STATE_LEAVES else _align(
                t, shapes[name][0][2], lengths, gather=lengths is not None,
                roll=True)
        return self._last_valid_logits(params, x, lengths), cache

    def _last_valid_logits(self, params, x: torch.Tensor,
                           lengths: Optional[torch.Tensor], tp=None
                           ) -> torch.Tensor:
        """Logits of each row's last valid position ((B, V) f32; this
        rank's block of the vocabulary under a ``tp`` that splits it)."""
        if lengths is None:
            return self.logits(params, x[:, -1:], tp)[:, 0]
        rows = torch.arange(x.shape[0], device=x.device)
        x_last = x[rows, lengths.long() - 1][:, None]          # (B, 1, d)
        return self.logits(params, x_last, tp)[:, 0]

    # ------------------------------------------------------ slot admission

    @torch.no_grad()
    def prefill_at(self, params, cache: dict, tokens: torch.Tensor,
                   slots: torch.Tensor, *,
                   lengths: Optional[torch.Tensor] = None, mesh=None,
                   write: Optional[torch.Tensor] = None
                   ) -> tuple[torch.Tensor, dict]:
        """Prefill prompts and write the resulting decode state into
        rows ``slots`` of a persistent slot cache (continuous-batching
        admission).

        cache: a live decode cache for ALL slots; tokens (n, S)
        right-padded prompts; slots (n,) slot ids; lengths (n,) true
        prompt lengths (None = all S). Returns (last-valid-token logits
        (n, V), the cache), written in place by each leaf's layout: the
        admitted slots' ``pos``; their first S rows of each leaf with a
        sequence axis; their whole ``conv`` and ``h`` (no sequence
        axis), so an admitted slot's recurrent state is exactly the
        prefill's, whatever the slot held before. Every other slot's
        state is untouched. Rows at S and past keep what they held:
        decode writes row ``pos`` before it attends to it, so they are
        never read. A linear cache bounds the prompt by its capacity (a
        pure-SSM cache has none); a ring (a sliding window's) admits a
        longer prompt and keeps each row's newest window, as the
        reference's.

        ``mesh``: the serving mesh. ``cache`` is this rank's
        (``LocalCache``) and ``slots`` index its slots; the prompts are
        prefilled as :meth:`prefill` does on the mesh, and a leaf with a
        sequence axis takes only the rows of this rank's stripe.
        ``write`` (m,): the rows of ``tokens`` whose state is written,
        into ``slots`` (m,), the rest prefilled only (all rows without
        it): a rank prefills a whole admitted group, whose tokens the MoE
        routes together, and keeps the rows of its own slots.
        """
        if self.cfg.family == "vlm":
            raise ValueError("prefill_at admits text prompts into slots; the "
                             "vlm family's prompt carries its image "
                             "embeddings, and the reference's slot "
                             "admission does not serve vlm (use "
                             "DecodeEngine)")
        S = tokens.shape[1]
        cap = self.cache_capacity(cache)
        ring = cap is not None and A.ring_windowed(self.cfg, cap)
        if cap is not None and not ring and S > cap:
            raise ValueError(f"prompt buffer {S} exceeds "
                             f"cache capacity {cap}")
        logits, small = self.prefill(
            params, tokens, cache_len=None if cap is None else min(S, cap),
            lengths=lengths, mesh=mesh)
        stripe = getattr(cache, "stripe", None)
        if write is not None:
            small = {name: new[write] if name == "pos" else new[:, write]
                     for name, new in small.items()}
        slots = slots.to(device=cache["pos"].device, dtype=torch.long)
        cache["pos"].index_copy_(0, slots, small["pos"])
        for name, new in small.items():
            if name in STATE_LEAVES:           # (L, B, ...)
                cache[name][:, slots] = new
            elif name != "pos":                # (L or A, B, S_buf, ...)
                if stripe is not None:         # this rank's rows of them
                    lo = stripe.index * stripe.rows
                    new = new[:, :, lo:lo + stripe.rows]
                if new.shape[2]:
                    cache[name][:, slots, :new.shape[2]] = new
        return logits, cache

    @torch.no_grad()
    def prefill_chunk_at(self, params, cache: dict, tokens: torch.Tensor,
                         slots: Optional[torch.Tensor], *, start,
                         chunk_lengths) -> tuple[torch.Tensor, dict]:
        """Resume prefill for a C-token chunk directly inside a
        persistent slot cache (chunked admission, a suffix after a
        prefix-store restore), in place.

        tokens (n, C) right-padded chunk tokens; slots (n,) slot ids, or
        None for rows 0..n-1; ``start`` (n,) resume positions (tokens[i,
        0] is absolute position start[i] of its prompt: 0 for a cold
        chunk, the prefix length after a restore, or a prior chunk
        boundary); ``chunk_lengths`` (n,) valid tokens in this chunk, 0
        marking an INACTIVE row, whose slot is left as it is. ``start``
        and ``chunk_lengths`` are read on the host (the writes' index is
        built there): pass CPU tensors or arrays to avoid a sync.

        Per layer, only the chunk rows' slots are read, and only each
        active row's valid positions are written (K/V rows, a ring's
        newest, latents); an active row's SSM state is carried in (zeros
        for a cold chunk: the slot may hold a retired occupant's) and
        written back, and ``pos`` becomes start + chunk_lengths. The
        reference gathers the rows' whole caches, runs the chunk and
        scatters them back merged; the port never copies a slot's cache.

        Returns (logits (n, V) of each row's last valid chunk token — a
        row with 0 valid tokens gives its first position's, to be
        discarded — and the cache).
        """
        cfg = self.cfg
        if cfg.family == "vlm":
            raise ValueError("the vlm family has no chunked prefill, as the "
                             "reference's")
        self._check_decode()
        dev = cache["pos"].device
        start_h = torch.as_tensor(start).cpu().to(torch.int64)
        len_h = torch.as_tensor(chunk_lengths).cpu().to(torch.int64)
        n, C = tokens.shape
        rows = (torch.arange(n, device=dev) if slots is None
                else torch.as_tensor(slots).to(dev, torch.long))
        start_d, len_d = start_h.to(dev), len_h.to(dev)
        qpos = start_d[:, None] + torch.arange(C, device=dev)[None, :]
        act_d = torch.nonzero(len_h > 0).flatten().to(dev)
        act_rows = rows[act_d]
        fresh = start_d == 0
        index: dict = {}                       # span writes, per layout
        x = self.embed_tokens(params, torch.as_tensor(tokens).to(dev))
        layers = params["layers"]
        for i in range(cfg.num_layers):
            params_l = _index(layers, i)
            h = L.apply_norm(cfg, x, params_l["ln1"])
            if self.recurrent:
                state = {}
                for name in STATE_LEAVES:
                    st = cache[name][i][rows]
                    state[name] = st.masked_fill(
                        fresh.reshape((-1,) + (1,) * (st.ndim - 1)), 0)
                y, st = self._ssm_forward(params_l["ssm"], h, state=state,
                                          lengths=len_d)
                x = x + y
                for name in STATE_LEAVES:
                    cache[name][i][act_rows] = st[name][act_d].to(
                        cache[name].dtype)
                if self._applies_shared(i):
                    a = i // cfg.attn_every
                    x = self._shared_chunk(params["shared"], x,
                                           cache["attn_k"][a],
                                           cache["attn_v"][a], qpos, start_h,
                                           len_h, rows, index)
                continue
            if cfg.use_mla:
                out, _, _ = MLA.mla_chunk(cfg, params_l["attn"], h,
                                          cache["ckv"][i], cache["krope"][i],
                                          qpos, start_h, len_h, rows,
                                          index=index)
            else:
                out, _, _ = A.chunk_attention(cfg, params_l["attn"], h,
                                              cache["k"][i], cache["v"][i],
                                              qpos, start_h, len_h, rows,
                                              index=index)
            x = x + out
            h = L.apply_norm(cfg, x, params_l["ln2"])
            x = x + self._ffn(params_l, h)[0]
        cache["pos"][act_rows] = (start_d + len_d)[act_d].to(torch.int32)
        logits = self._last_valid_logits(params, x,
                                         torch.clamp(len_d, min=1))
        return logits, cache

    def _shared_chunk(self, shared, x, cache_k, cache_v, qpos, start,
                      lengths, rows, index):
        """The hybrid's shared block over one chunk, against one
        application's K/V cache (written in place)."""
        cfg = self.cfg
        h = L.apply_norm(cfg, x, shared["ln1"])
        out, _, _ = A.chunk_attention(cfg, shared["attn"], h, cache_k,
                                      cache_v, qpos, start, lengths, rows,
                                      index=index)
        x = x + out
        h = L.apply_norm(cfg, x, shared["ln2"])
        return x + mlp_block(cfg, shared["mlp"], h)



def _index(tree: Pytree, i: int) -> Pytree:
    """Layer ``i``'s views of the stacked ``(L, ...)`` leaves."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _stack(trees: list) -> Pytree:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _ring_gather(kv: torch.Tensor, lengths: torch.Tensor, cap: int
                 ) -> torch.Tensor:
    """Per-row ring alignment of full-length stacked K/V: kv (L, B, S,
    ...) holds positions 0..S-1 of a right-padded batch whose true
    lengths are ``lengths`` (B,). Returns (L, B, cap, ...) where ring
    slot j of row b holds the newest valid position p < lengths[b] with
    p % cap == j — the layout the windowed decode ring expects (slot =
    pos % cap). Slots with no valid position (short rows) repeat a row
    that the decode's kv_len never reads. As the reference's."""
    S = kv.shape[2]
    j = torch.arange(cap, device=kv.device)[None, :]
    base = lengths.to(kv.device, torch.int64)[:, None] - cap
    # the smallest multiple of cap lifting j into [len - cap, len)
    extra = torch.clamp(torch.div(base - j + cap - 1, cap,
                                  rounding_mode="floor"), min=0)
    p = torch.clamp(j + cap * extra, 0, S - 1)              # (B, cap)
    b = torch.arange(kv.shape[1], device=kv.device)[:, None]
    return kv[:, b, p]


def _align(t: torch.Tensor, s_buf: int, lengths: Optional[torch.Tensor], *,
           gather: bool, roll: bool) -> torch.Tensor:
    """Stacked prefill K/V t (L, B, S, ...) to a cache of ``s_buf`` rows:
    with ``gather`` each row's ring (:func:`_ring_gather`); else the last
    ``s_buf`` positions (zeros past S), rolled so that position p sits at
    row p % s_buf when ``roll`` and the prompt is longer than the cache —
    the reference's alignment, for its dense and hybrid branches."""
    S = t.shape[2]
    if gather:
        return _ring_gather(t, lengths, s_buf)
    t = _fit(t, s_buf, dim=2)
    if roll and S > s_buf:
        t = torch.roll(t, S % s_buf, dims=2)
    return t


def _fit(x: torch.Tensor, cap: int, *, dim: int) -> torch.Tensor:

    """Pad (zeros) or crop (keep the last ``cap``) x along ``dim``."""
    S = x.shape[dim]
    if S == cap:
        return x
    if S > cap:
        return x.narrow(dim, S - cap, cap)
    shape = list(x.shape)
    shape[dim] = cap
    out = x.new_zeros(shape)
    out.narrow(dim, 0, S).copy_(x)
    return out
