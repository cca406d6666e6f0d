"""Decoder-only language model, dense and MoE families (with GQA or MLA
attention): port of those branches of ``repro/models/lm.py`` — init,
the training forward, the decode cache, one-token decode,
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

The decode cache is the reference's: ``{"pos": (B,) int32, "k", "v":
(L, B, S, Hkv, hd)}``, or with MLA ``{"pos", "ckv": (L, B, S, r),
"krope": (L, B, S, rope)}``. Where the reference returns new arrays
(and donates the old ones to XLA), the port writes in place:
:meth:`decode_step` writes one row per sequence and layer of each cache
leaf and advances ``pos``; :meth:`prefill_at` writes the admitted
slots' prompt rows and ``pos``. Both return the cache they were given.

Other families (ssm, hybrid, encdec, vlm) raise
``NotImplementedError``, and so do decode, prefill and serving with the
attention features of
:func:`repro_torch.models.attention.check_decode_supported`.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops as kops
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models.mlp import init_mlp, mlp_block
from repro_torch.models.moe import init_moe, moe_block
from repro_torch.treepath import tree_flatten_with_path, tree_unflatten

Pytree = Any

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class LanguageModel:
    def __init__(self, cfg):
        if cfg.family not in ("dense", "moe"):
            raise NotImplementedError(
                f"model family {cfg.family!r} is not yet ported to "
                "repro_torch (the LM port covers the dense and moe "
                "families)")
        self.cfg = cfg
        self.dtype = DTYPES[cfg.dtype]

    # ------------------------------------------------------------------ init

    def _init_layer(self, gen: torch.Generator, device) -> dict:
        cfg, d, dt = self.cfg, self.cfg.d_model, self.dtype
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
        ``device``: one seed gives the same weights on every device."""
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
        return params

    def stacked_marker(self, params: Pytree) -> Pytree:
        """Bool pytree: True for (L, ...)-stacked leaves (under 'layers')."""
        leaves, treedef = tree_flatten_with_path(params)
        return tree_unflatten(treedef, ["layers" in path
                                        for path, _ in leaves])

    # ------------------------------------------------------------- embedding

    def embed_tokens(self, params, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens, params["embed"])

    def logits(self, params, x: torch.Tensor) -> torch.Tensor:
        """Final norm, then the matmul in the params' dtype, then f32."""
        x = L.apply_norm(self.cfg, x, params["final_norm"])
        return (x @ self.unembed_matrix(params)).float()

    def unembed_matrix(self, params) -> torch.Tensor:
        return (params["embed"].T if self.cfg.tie_embeddings
                else params["unembed"])

    # ----------------------------------------------------------------- train

    def attention_block(self, params_attn, h: torch.Tensor,
                        positions: torch.Tensor) -> torch.Tensor:
        """The layer's attention sub-block for training and prefill: MLA's
        expanded block or the GQA block."""
        if self.cfg.use_mla:
            return MLA.mla_block(self.cfg, params_attn, h, positions)
        return A.attention_block(self.cfg, params_attn, h, positions)

    def _ffn(self, params_l, h: torch.Tensor
             ) -> tuple[torch.Tensor, Optional[dict]]:
        """The layer's MLP, or its MoE block with the block's aux."""
        if self.cfg.family == "moe":
            return moe_block(self.cfg, params_l["moe"], h)
        return mlp_block(self.cfg, params_l["mlp"], h), None

    def _layer_train(self, params_l, x: torch.Tensor, aux: torch.Tensor,
                     positions: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """One layer on the carry (x, aux): aux gains the MoE block's
        load-balance loss."""
        cfg = self.cfg
        h = L.apply_norm(cfg, x, params_l["ln1"])
        x = x + self.attention_block(params_l["attn"], h, positions)
        h = L.apply_norm(cfg, x, params_l["ln2"])
        y, moe_aux = self._ffn(params_l, h)
        if moe_aux is not None:
            aux = aux + moe_aux["aux_loss"]
        return x + y, aux

    def _block_train(self, layers, x: torch.Tensor, aux: torch.Tensor,
                     positions: torch.Tensor, idx: range
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """Layers ``idx`` in order on the carry (x, aux), each
        checkpointed when ``cfg.remat``."""
        for i in idx:
            params_l = _index(layers, i)
            if self.cfg.remat:
                x, aux = checkpoint(self._layer_train, params_l, x, aux,
                                    positions, use_reentrant=False)
            else:
                x, aux = self._layer_train(params_l, x, aux, positions)
        return x, aux

    def forward(self, params, tokens: torch.Tensor, *,
                return_hidden: bool = False
                ) -> tuple[torch.Tensor, dict]:
        """Train/eval forward. tokens (B, S) int.

        Returns (logits (B, S, V) f32, {"aux_loss": f32 scalar: the MoE
        blocks' load-balance losses summed over the layers, 0 for the
        dense family}) — or the final-norm hidden states (B, S, d) when
        ``return_hidden``. The reference wraps each layer's carry in an
        optimization barrier, an XLA layout workaround that is the
        identity in value and in gradient; it has no counterpart here.
        """
        cfg = self.cfg
        x = self.embed_tokens(params, tokens)
        positions = torch.arange(x.shape[1], device=x.device)
        aux = torch.zeros((), device=x.device)
        blk = cfg.remat_block
        if cfg.remat and blk and cfg.num_layers % blk == 0:
            for i in range(0, cfg.num_layers, blk):
                x, aux = checkpoint(self._block_train, params["layers"], x,
                                    aux, positions, range(i, i + blk),
                                    use_reentrant=False)
        else:
            x, aux = self._block_train(params["layers"], x, aux, positions,
                                       range(cfg.num_layers))
        aux = {"aux_loss": aux}
        if return_hidden:
            return L.apply_norm(cfg, x, params["final_norm"]), aux
        return self.logits(params, x), aux

    # ----------------------------------------------------------------- cache

    def _cache_shapes(self, batch: int, seq_len: int) -> dict:
        """The decode cache's leaves other than ``pos``: MLA's latent and
        rope-key caches, else K and V."""
        cfg = self.cfg
        lead = (cfg.num_layers, batch, seq_len)
        if cfg.use_mla:
            return {"ckv": lead + (cfg.kv_lora_rank,),
                    "krope": lead + (cfg.qk_rope_dim,)}
        _, Hkv, hd = cfg.attn_dims
        return {"k": lead + (Hkv, hd), "v": lead + (Hkv, hd)}

    def init_cache(self, batch: int, seq_len: int, *, device=None) -> dict:
        A.check_decode_supported(self.cfg)
        cache = {"pos": torch.zeros(batch, dtype=torch.int32, device=device)}
        for name, shape in self._cache_shapes(batch, seq_len).items():
            cache[name] = torch.zeros(shape, dtype=self.dtype, device=device)
        return cache

    def cache_capacity(self, cache: dict) -> int:
        """Token capacity of a decode cache (its leaves are (L, B, S, ...))."""
        return next(v for k, v in cache.items() if k != "pos").shape[2]

    # ---------------------------------------------------------------- decode

    def _layer_decode(self, params_l, x, cache_l: dict, pos):
        """One layer, one token; writes this layer's cache rows
        (``cache_l``: the layer's views of the cache leaves)."""
        cfg = self.cfg
        h = L.apply_norm(cfg, x, params_l["ln1"])
        if cfg.use_mla:
            out, _, _ = MLA.mla_decode(cfg, params_l["attn"], h,
                                       cache_l["ckv"], cache_l["krope"], pos)
        else:
            out, _, _ = A.decode_attention(cfg, params_l["attn"], h,
                                           cache_l["k"], cache_l["v"], pos)
        x = x + out
        h = L.apply_norm(cfg, x, params_l["ln2"])
        return x + self._ffn(params_l, h)[0]

    @torch.no_grad()
    def decode_step(self, params, cache: dict, tokens: torch.Tensor, *,
                    use_flash: bool | str = "auto"
                    ) -> tuple[torch.Tensor, dict]:
        """tokens (B, 1) -> (logits (B, 1, V) f32, the cache, updated in
        place: one row per sequence and layer of each cache leaf, and
        ``pos + 1``).

        GQA attention runs through the ``flash_decode`` wrapper: one
        kernel launch per layer on CUDA tensors, its plain version on CPU
        tensors. MLA's absorbed decode is torch ops, as the reference's
        is jnp: it launches no kernel. ``use_flash`` only checks the
        placement, as LARS's ``use_kernels`` does: ``"auto"`` takes
        either, ``True`` needs CUDA tensors, ``False`` CPU tensors.
        """
        pos = cache["pos"]
        kops.check_use_kernels(use_flash, pos.device, option="use_flash")
        x = self.embed_tokens(params, tokens)
        layers = params["layers"]
        leaves = [name for name in cache if name != "pos"]
        for i in range(self.cfg.num_layers):
            params_l = _index(layers, i)
            x = self._layer_decode(params_l, x,
                                   {name: cache[name][i] for name in leaves},
                                   pos)
        pos.add_(1)
        return self.logits(params, x), cache

    # --------------------------------------------------------------- prefill

    @torch.no_grad()
    def prefill(self, params, tokens: torch.Tensor, *,
                cache_len: Optional[int] = None,
                lengths: Optional[torch.Tensor] = None
                ) -> tuple[torch.Tensor, dict]:
        """Run the full prompt, building a decode cache of capacity
        ``cache_len`` (default: the prompt length).

        ``lengths`` (B,) int32 marks per-row true prompt lengths of a
        right-padded token batch: logits come from each row's last valid
        position and the cache ``pos`` is set to ``lengths``. Causality
        makes the padded forward exact for valid positions; pad-position
        cache entries are never read back (decode masks kv_len = pos + 1).
        With MLA the cache takes each layer's latents (c_kv and the roped
        shared key) and the attention runs expanded, as the reference.
        Returns (last-valid-token logits (B, V) f32, cache).
        """
        cfg = self.cfg
        A.check_decode_supported(cfg)
        x = self.embed_tokens(params, tokens)
        B, S, _ = x.shape
        H, _, hd = cfg.attn_dims
        positions = torch.arange(S, device=x.device)
        cap = cache_len or S
        rows = {name: [] for name in self._cache_shapes(B, cap)}
        for i in range(cfg.num_layers):
            params_l = _index(params["layers"], i)
            p = params_l["attn"]
            h = L.apply_norm(cfg, x, params_l["ln1"])
            if cfg.use_mla:
                ckv, krope = MLA._latents(cfg, p, h, positions)
                x = x + MLA.mla_block(cfg, p, h, positions)
                rows["ckv"].append(ckv)
                rows["krope"].append(krope[:, :, 0])
            else:
                q, k, v = A.qkv_project(cfg, p, h, positions)
                out = A.attention_core(q, k, v, q_positions=positions,
                                       q_chunk=cfg.attn_q_chunk,
                                       flash_vjp=cfg.flash_vjp)
                x = x + out.reshape(B, S, H * hd) @ p["wo"]
                rows["k"].append(k)
                rows["v"].append(v)
            h = L.apply_norm(cfg, x, params_l["ln2"])
            x = x + self._ffn(params_l, h)[0]
        logits = self._last_valid_logits(params, x, lengths)
        # a copy: decode_step advances pos in place
        pos = (torch.full((B,), S, dtype=torch.int32, device=x.device)
               if lengths is None else lengths.to(torch.int32, copy=True))
        cache = {"pos": pos}
        for name, ts in rows.items():
            cache[name] = _fit(torch.stack(ts).to(self.dtype), cap, dim=2)
        return logits, cache

    def _last_valid_logits(self, params, x: torch.Tensor,
                           lengths: Optional[torch.Tensor]) -> torch.Tensor:
        """Logits of each row's last valid position ((B, V) f32)."""
        if lengths is None:
            return self.logits(params, x[:, -1:])[:, 0]
        rows = torch.arange(x.shape[0], device=x.device)
        x_last = x[rows, lengths.long() - 1][:, None]          # (B, 1, d)
        return self.logits(params, x_last)[:, 0]

    # ------------------------------------------------------ slot admission

    @torch.no_grad()
    def prefill_at(self, params, cache: dict, tokens: torch.Tensor,
                   slots: torch.Tensor, *,
                   lengths: Optional[torch.Tensor] = None
                   ) -> tuple[torch.Tensor, dict]:
        """Prefill prompts and write the resulting decode state into
        rows ``slots`` of a persistent slot cache (continuous-batching
        admission).

        cache: a live decode cache for ALL slots; tokens (n, S)
        right-padded prompts; slots (n,) slot ids; lengths (n,) true
        prompt lengths (None = all S). Returns (last-valid-token logits
        (n, V), the cache): the admitted slots' ``pos`` and their first
        S rows of each cache leaf are written in place, every other
        slot's state is untouched. Rows at S and past keep what they
        held: decode writes row ``pos`` before it attends to it, so they
        are never read.
        """
        S = tokens.shape[1]
        cap = self.cache_capacity(cache)
        if S > cap:
            raise ValueError(f"prompt buffer {S} exceeds "
                             f"cache capacity {cap}")
        logits, small = self.prefill(params, tokens, lengths=lengths)
        slots = slots.to(device=cache["pos"].device, dtype=torch.long)
        cache["pos"].index_copy_(0, slots, small["pos"])
        for name in small:                     # (L, B, cap, ...)
            if name != "pos":
                cache[name][:, slots, :S] = small[name]
        return logits, cache


def _index(tree: Pytree, i: int) -> Pytree:
    """Layer ``i``'s views of the stacked ``(L, ...)`` leaves."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _stack(trees: list) -> Pytree:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


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
