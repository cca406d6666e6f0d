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
(L, B, S, Hkv, hd)}``; with MLA ``{"pos", "ckv": (L, B, S, r),
"krope": (L, B, S, rope)}``; for the SSM family ``{"pos", "conv":
(L, B, K-1, C), "h": (L, B, d_inner, N) f32}``, and for the hybrid
``{"pos", "conv", "h": (L, B, heads, hd, N) f32, "attn_k", "attn_v":
(A, B, S, Hkv, hd)}``, one K/V cache per application of the shared
block (A = ceil(L / attn_every)). Where the reference returns new
arrays (and donates the old ones to XLA), the port writes in place:
:meth:`decode_step` writes one row per sequence and layer of each K/V
or latent leaf, each Mamba layer's new conv and recurrent state, and
advances ``pos``; :meth:`prefill_at` writes the admitted slots' prompt
rows, their whole recurrent state and ``pos``. Both return the cache
they were given.

The encdec family is :mod:`repro_torch.models.encdec`'s. Decode,
prefill and serving with the attention features of
:func:`repro_torch.models.attention.check_decode_supported` raise
``NotImplementedError`` (on every family that has attention). A hybrid
prompt longer than its shared block's cache needs the reference's ring
alignment, which is not ported, and raises too.
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
        ``check_decode_supported`` refuses, where there is attention."""
        if self.cfg.family != "ssm":
            A.check_decode_supported(self.cfg)

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
                        positions: torch.Tensor,
                        prefix_len: Optional[int] = None) -> torch.Tensor:
        """The layer's attention sub-block for training: MLA's expanded
        block or the GQA block, with the vlm family's bidirectional
        prefix of ``prefix_len`` positions."""
        if self.cfg.use_mla:
            return MLA.mla_block(self.cfg, params_attn, h, positions)
        return A.attention_block(self.cfg, params_attn, h, positions,
                                 prefix_len=prefix_len)

    def _ffn(self, params_l, h: torch.Tensor
             ) -> tuple[torch.Tensor, Optional[dict]]:
        """The layer's MLP, or its MoE block with the block's aux."""
        if self.cfg.family == "moe":
            return moe_block(self.cfg, params_l["moe"], h)
        return mlp_block(self.cfg, params_l["mlp"], h), None

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
                     prefix_len: Optional[int] = None
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
                                     prefix_len)
        h = L.apply_norm(cfg, x, params_l["ln2"])
        y, moe_aux = self._ffn(params_l, h)
        if moe_aux is not None:
            aux = aux + moe_aux["aux_loss"]
        return x + y, aux

    def _block_train(self, layers, shared, x: torch.Tensor,
                     aux: torch.Tensor, positions: torch.Tensor, idx: range,
                     prefix_len: Optional[int] = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """Layers ``idx`` in order on the carry (x, aux), each
        checkpointed when ``cfg.remat``; ``shared``: the hybrid's shared
        block, applied after the layers :meth:`_applies_shared` names."""
        for i in idx:
            args = (_index(layers, i), x, aux, positions,
                    shared if self._applies_shared(i) else None, prefix_len)
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
        """
        cfg = self.cfg
        x, prefix_len = self._embed_inputs(params, tokens, image_embeddings)
        positions = torch.arange(x.shape[1], device=x.device)
        aux = torch.zeros((), device=x.device)
        blk = cfg.remat_block
        shared = params.get("shared")
        if cfg.remat and blk and cfg.num_layers % blk == 0:
            for i in range(0, cfg.num_layers, blk):
                x, aux = checkpoint(self._block_train, params["layers"],
                                    shared, x, aux, positions,
                                    range(i, i + blk), prefix_len,
                                    use_reentrant=False)
        else:
            x, aux = self._block_train(params["layers"], shared, x, aux,
                                       positions, range(cfg.num_layers),
                                       prefix_len)
        aux = {"aux_loss": aux}
        if return_hidden:
            return L.apply_norm(cfg, x, params["final_norm"]), aux
        return self.logits(params, x), aux

    def _embed_inputs(self, params, tokens: torch.Tensor,
                      image_embeddings: Optional[torch.Tensor]
                      ) -> tuple[torch.Tensor, Optional[int]]:
        """The embedded tokens, behind the image embeddings for the vlm
        family; and the bidirectional prefix's length (None but for
        vlm)."""
        x = self.embed_tokens(params, tokens)
        if self.cfg.family != "vlm":
            return x, None
        if image_embeddings is None:
            raise ValueError("the vlm family needs its image embeddings "
                             "(the stub frontend's patch embeddings)")
        return (torch.cat([image_embeddings.to(x.dtype), x], dim=1),
                image_embeddings.shape[1])

    # ----------------------------------------------------------------- cache

    def _cache_shapes(self, batch: int, seq_len: int) -> dict:
        """The decode cache's leaves other than ``pos``: {name: (shape,
        dtype)}. MLA's latent and rope-key caches; the SSM family's conv
        and recurrent states; the hybrid's states and one K/V cache per
        shared-block application; else K and V."""
        cfg, dt, f32 = self.cfg, self.dtype, torch.float32
        L_, K = cfg.num_layers, cfg.ssm_conv
        lead = (L_, batch, seq_len)
        _, Hkv, hd = cfg.attn_dims
        if cfg.family == "ssm":
            din = cfg.ssm_d_inner
            return {"conv": ((L_, batch, K - 1, din), dt),
                    "h": ((L_, batch, din, cfg.ssm_state), f32)}
        if cfg.family == "hybrid":
            din, N, shd = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_head_dim
            kv = ((self._shared_applications(), batch, seq_len, Hkv, hd), dt)
            return {"conv": ((L_, batch, K - 1,
                              din + 2 * cfg.ssm_groups * N), dt),
                    "h": ((L_, batch, din // shd, shd, N), f32),
                    "attn_k": kv, "attn_v": kv}
        if cfg.use_mla:
            return {"ckv": (lead + (cfg.kv_lora_rank,), dt),
                    "krope": (lead + (cfg.qk_rope_dim,), dt)}
        return {"k": (lead + (Hkv, hd), dt), "v": (lead + (Hkv, hd), dt)}

    def init_cache(self, batch: int, seq_len: int, *, device=None) -> dict:
        self._check_decode()
        cache = {"pos": torch.zeros(batch, dtype=torch.int32, device=device)}
        for name, (shape, dt) in self._cache_shapes(batch, seq_len).items():
            cache[name] = torch.zeros(shape, dtype=dt, device=device)
        return cache

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
        not grow with the sequence."""
        for name in ("k", "ckv", "attn_k"):
            if name in cache:
                return cache[name].shape[2]
        return None

    # ---------------------------------------------------------------- decode

    def _layer_decode(self, params_l, x, cache_l: dict, pos):
        """One layer, one token; writes this layer's cache rows, or its
        new conv and recurrent state (``cache_l``: the layer's views of
        the cache leaves)."""
        cfg = self.cfg
        h = L.apply_norm(cfg, x, params_l["ln1"])
        if self.recurrent:
            y, st = self._ssm_forward(params_l["ssm"], h, state=cache_l)
            for name in STATE_LEAVES:
                cache_l[name].copy_(st[name])
            return x + y
        if cfg.use_mla:
            out, _, _ = MLA.mla_decode(cfg, params_l["attn"], h,
                                       cache_l["ckv"], cache_l["krope"], pos)
        else:
            out, _, _ = A.decode_attention(cfg, params_l["attn"], h,
                                           cache_l["k"], cache_l["v"], pos)
        x = x + out
        h = L.apply_norm(cfg, x, params_l["ln2"])
        return x + self._ffn(params_l, h)[0]

    def _shared_decode(self, shared, x, cache_k, cache_v, pos):
        """The hybrid's shared block, one token, over one application's
        K/V cache (written in place)."""
        cfg = self.cfg
        h = L.apply_norm(cfg, x, shared["ln1"])
        out, _, _ = A.decode_attention(cfg, shared["attn"], h, cache_k,
                                       cache_v, pos)
        x = x + out
        h = L.apply_norm(cfg, x, shared["ln2"])
        return x + mlp_block(cfg, shared["mlp"], h)

    @torch.no_grad()
    def decode_step(self, params, cache: dict, tokens: torch.Tensor, *,
                    use_flash: bool | str = "auto"
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
        """
        pos = cache["pos"]
        kops.check_use_kernels(use_flash, pos.device, option="use_flash")
        x = self.embed_tokens(params, tokens)
        layers = params["layers"]
        leaves = [name for name in cache
                  if name not in ("pos", "attn_k", "attn_v")]
        for i in range(self.cfg.num_layers):
            x = self._layer_decode(_index(layers, i), x,
                                   {name: cache[name][i] for name in leaves},
                                   pos)
            if self._applies_shared(i):
                a = i // self.cfg.attn_every
                x = self._shared_decode(params["shared"], x,
                                        cache["attn_k"][a],
                                        cache["attn_v"][a], pos)
        pos.add_(1)
        return self.logits(params, x), cache

    # --------------------------------------------------------------- prefill

    def _attention_prefill(self, p, h: torch.Tensor, positions: torch.Tensor,
                           prefix_len: Optional[int] = None
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
        """A GQA attention sub-block over the whole prompt: (out (B, S,
        d), k, v (B, S, Hkv, hd)) for the cache."""
        cfg = self.cfg
        B, S, _ = h.shape
        H, _, hd = cfg.attn_dims
        q, k, v = A.qkv_project(cfg, p, h, positions)
        out = A.attention_core(q, k, v, q_positions=positions,
                               prefix_len=prefix_len,
                               q_chunk=cfg.attn_q_chunk,
                               flash_vjp=cfg.flash_vjp)
        return out.reshape(B, S, H * hd) @ p["wo"], k, v

    @torch.no_grad()
    def prefill(self, params, tokens: torch.Tensor, *,
                image_embeddings: Optional[torch.Tensor] = None,
                cache_len: Optional[int] = None,
                lengths: Optional[torch.Tensor] = None
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
        With MLA the cache takes each layer's latents (c_kv and the roped
        shared key) and the attention runs expanded, as the reference.
        The SSM and hybrid families carry their recurrent state through
        the prompt (:meth:`_prefill_recurrent`). Returns
        (last-valid-token logits (B, V) f32, cache).
        """
        cfg = self.cfg
        self._check_decode()
        if cfg.family == "vlm" and lengths is not None:
            raise ValueError("the vlm family's prefill takes no lengths, as "
                             "the reference's")
        x, prefix_len = self._embed_inputs(params, tokens, image_embeddings)
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
                    x = x + MLA.mla_block(cfg, p, h, positions)
                    rows["ckv"].append(ckv)
                    rows["krope"].append(krope[:, :, 0])
                else:
                    out, k, v = self._attention_prefill(p, h, positions,
                                                        prefix_len)
                    x = x + out
                    rows["k"].append(k)
                    rows["v"].append(v)
                h = L.apply_norm(cfg, x, params_l["ln2"])
                x = x + self._ffn(params_l, h)[0]
            logits = self._last_valid_logits(params, x, lengths)
            cache = {name: _fit(torch.stack(ts).to(self.dtype), cap, dim=2)
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

        The reference aligns the shared block's K/V to a ring where a
        window is set or the prompt is longer than the cache. No
        registered hybrid sets a window (and decode refuses one), and a
        prompt longer than the cache raises here: the ring is not
        ported, so the layout is linear, rows 0..S-1 holding positions
        0..S-1. The rows past S are zeros where the reference repeats
        row S-1; decode never reads them.
        """
        cfg = self.cfg
        B, S, _ = x.shape
        if cfg.family == "hybrid" and S > cap:
            raise NotImplementedError(
                f"a {S}-token prompt into a hybrid cache of capacity {cap} "
                "needs the reference's ring alignment, which is not yet "
                "ported to repro_torch")
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
                out, k, v = self._attention_prefill(shared["attn"], h,
                                                    positions)
                x = x + out
                h = L.apply_norm(cfg, x, shared["ln2"])
                x = x + mlp_block(cfg, shared["mlp"], h)
                rows["attn_k"].append(k)
                rows["attn_v"].append(v)
        cache = {}
        for name, ts in rows.items():
            t = torch.stack(ts).to(shapes[name][1])
            cache[name] = t if name in STATE_LEAVES else _fit(t, cap, dim=2)
        return self._last_valid_logits(params, x, lengths), cache

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
        (n, V), the cache), written in place by each leaf's layout: the
        admitted slots' ``pos``; their first S rows of each leaf with a
        sequence axis; their whole ``conv`` and ``h`` (no sequence
        axis), so an admitted slot's recurrent state is exactly the
        prefill's, whatever the slot held before. Every other slot's
        state is untouched. Rows at S and past keep what they held:
        decode writes row ``pos`` before it attends to it, so they are
        never read. The prompt is bounded only by a cache that has a
        capacity (a pure-SSM cache has none).
        """
        if self.cfg.family == "vlm":
            raise ValueError("prefill_at admits text prompts into slots; the "
                             "vlm family's prompt carries its image "
                             "embeddings, and the reference's slot "
                             "admission does not serve vlm (use "
                             "DecodeEngine)")
        S = tokens.shape[1]
        cap = self.cache_capacity(cache)
        if cap is not None and S > cap:
            raise ValueError(f"prompt buffer {S} exceeds "
                             f"cache capacity {cap}")
        logits, small = self.prefill(params, tokens, lengths=lengths)
        slots = slots.to(device=cache["pos"].device, dtype=torch.long)
        cache["pos"].index_copy_(0, slots, small["pos"])
        for name, new in small.items():
            if name in STATE_LEAVES:           # (L, B, ...)
                cache[name][:, slots] = new
            elif name != "pos":                # (L or A, B, cap, ...)
                cache[name][:, slots, :S] = new
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
