"""Encoder-decoder transformer, the encdec family (whisper-base's
backbone, arXiv:2212.04356): port of ``repro/models/encdec.py`` — init,
the teacher-forced training forward, the decode cache, prefill and
one-token decode.

As in the reference, the mel-spectrogram and conv frontend is a stub:
the caller supplies precomputed frame embeddings (B, encoder_seq,
d_model). The transformer is a bidirectional encoder and a causal
decoder with cross-attention over the encoder's output, LayerNorm and
GELU, and computed sinusoidal positions on both sides (the reference's
deviation from Whisper's learned tables, which keeps the backbone
shape-faithful at any length).

Params are nested dicts in the reference's leaf layouts: ``embed``
(V, d) (tied to the unembedding when the config says so, else an
``unembed`` (d, V)), the encoder's layers stacked on a leading
``(encoder_layers, ...)`` axis under ``enc_layers`` (``ln1``, ``attn``,
``ln2``, ``mlp``), ``enc_norm``, the decoder's stacked under
``dec_layers`` (``ln1``, ``self_attn``, ``ln_x``, ``cross_attn``,
``ln2``, ``mlp``) and ``final_norm``. In training ``cfg.remat``
checkpoints each layer of both stacks, as the reference's
``jax.checkpoint`` of its scan bodies.

The decode cache is the reference's: ``{"pos": (B,) int32, "k", "v":
(L, B, S, Hkv, hd), "xk", "xv": (L, B, encoder_seq, Hkv, hd)}``, the
last two the cross-attention's keys and values, computed once from the
encoder's output by :meth:`prefill`. :meth:`decode_step` writes one
self-attention row per sequence and layer in place and advances
``pos``. Both of a decoder layer's attentions run through the
``flash_decode`` wrapper: the self-attention over ``pos + 1`` rows
(:func:`repro_torch.models.attention.decode_attention`), the
cross-attention over all ``encoder_seq`` rows — the reference's
non-causal core over the encoder's keys, the same function. On the card
a tick launches two kernels a layer.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops as kops
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.lm import DTYPES, _fit, _index, _stack
from repro_torch.models.mlp import init_mlp, mlp_block
from repro_torch.treepath import tree_flatten_with_path, tree_unflatten

Pytree = Any
STACKS = ("enc_layers", "dec_layers")


def _check_decode(cfg) -> None:
    """The encdec decode cache is linear: a sliding window (the
    reference's ring) and the logit softcap are not served here (no
    registered encoder-decoder sets either; training takes both)."""
    if cfg.sliding_window or cfg.attn_logit_softcap:
        raise NotImplementedError(
            f"sliding_window={cfg.sliding_window} or attn_logit_softcap="
            f"{cfg.attn_logit_softcap} is not yet ported to the encdec "
            "family's decode; training takes both")


def sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(N,) positions -> (N, d) f32: sines then cosines of the positions
    at ``d // 2`` geometric frequencies from 1 to 1/10000, computed as the
    reference computes them."""
    half = d // 2
    freqs = torch.exp(-torch.log(torch.tensor(10000.0)) * torch.arange(
        half, dtype=torch.float32) / max(half - 1, 1)).to(positions.device)
    ang = positions[:, None].float() * freqs[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class EncDecModel:
    def __init__(self, cfg):
        if cfg.family != "encdec":
            raise ValueError(f"EncDecModel takes the encdec family, got "
                             f"{cfg.family!r}")
        self.cfg = cfg
        self.dtype = DTYPES[cfg.dtype]

    # ------------------------------------------------------------------ init

    def _init_enc_layer(self, gen: torch.Generator, device) -> dict:
        cfg, d, dt = self.cfg, self.cfg.d_model, self.dtype
        return {"ln1": L.init_norm(cfg, d, device),
                "attn": A.init_attention(gen, cfg, d, dt, device),
                "ln2": L.init_norm(cfg, d, device),
                "mlp": init_mlp(gen, cfg, d, cfg.d_ff, dt, device)}

    def _init_dec_layer(self, gen: torch.Generator, device) -> dict:
        cfg, d, dt = self.cfg, self.cfg.d_model, self.dtype
        return {"ln1": L.init_norm(cfg, d, device),
                "self_attn": A.init_attention(gen, cfg, d, dt, device),
                "ln_x": L.init_norm(cfg, d, device),
                "cross_attn": A.init_attention(gen, cfg, d, dt, device),
                "ln2": L.init_norm(cfg, d, device),
                "mlp": init_mlp(gen, cfg, d, cfg.d_ff, dt, device)}

    def init(self, generator: torch.Generator, device) -> Pytree:
        """Random params at the reference's distributions, drawn from
        ``generator`` (a CPU generator) in the reference's key order —
        encoder layers, decoder layers, embedding, unembedding — and
        moved to ``device``."""
        cfg, d = self.cfg, self.cfg.d_model
        enc = [self._init_enc_layer(generator, device)
               for _ in range(cfg.encoder_layers)]
        dec = [self._init_dec_layer(generator, device)
               for _ in range(cfg.num_layers)]
        params = {"embed": L.embed_init(generator, cfg.vocab_size, d,
                                        self.dtype, device),
                  "enc_layers": _stack(enc),
                  "enc_norm": L.init_norm(cfg, d, device),
                  "dec_layers": _stack(dec),
                  "final_norm": L.init_norm(cfg, d, device)}
        if not cfg.tie_embeddings:
            params["unembed"] = L.dense_init(generator, d, cfg.vocab_size,
                                             self.dtype, device)
        return params

    def stacked_marker(self, params: Pytree) -> Pytree:
        """Bool pytree: True for the (L, ...)-stacked leaves of both
        stacks."""
        leaves, treedef = tree_flatten_with_path(params)
        return tree_unflatten(treedef, [path[0] in STACKS
                                        for path, _ in leaves])

    # --------------------------------------------------------------- encoder

    def _positions(self, params, S: int, device
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """(positions (S,), their sinusoids (1, S, d) in the params'
        dtype)."""
        positions = torch.arange(S, device=device)
        return positions, sinusoid(positions, self.cfg.d_model).to(
            params["embed"].dtype)[None]

    def _enc_layer(self, params_l, x: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = L.apply_norm(cfg, x, params_l["ln1"])
        x = x + A.attention_block(cfg, params_l["attn"], h, positions,
                                  causal=False)
        h = L.apply_norm(cfg, x, params_l["ln2"])
        return x + mlp_block(cfg, params_l["mlp"], h)

    def encode(self, params, frames: torch.Tensor) -> torch.Tensor:
        """frames (B, S_enc, d): the stub frontend's frame embeddings ->
        the encoder's normed output (B, S_enc, d), in the params' dtype
        (the reference's model dtype: the two differ only where a
        precision policy casts the params)."""
        positions, pe = self._positions(params, frames.shape[1],
                                        frames.device)
        x = frames.to(pe.dtype) + pe
        for i in range(self.cfg.encoder_layers):
            args = (_index(params["enc_layers"], i), x, positions)
            x = (checkpoint(self._enc_layer, *args, use_reentrant=False)
                 if self.cfg.remat else self._enc_layer(*args))
        return L.apply_norm(self.cfg, x, params["enc_norm"])

    # --------------------------------------------------------------- decoder

    def _cross_kv(self, p, enc_out: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
        """The cross-attention's keys and values (B, S_enc, Hkv, hd)."""
        _, Hkv, hd = self.cfg.attn_dims
        B = enc_out.shape[0]
        return ((enc_out @ p["wk"]).reshape(B, -1, Hkv, hd),
                (enc_out @ p["wv"]).reshape(B, -1, Hkv, hd))

    def _cross_attend(self, p, x: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, positions: torch.Tensor
                      ) -> torch.Tensor:
        """Every decoder position attends every encoder row."""
        cfg = self.cfg
        B, S, _ = x.shape
        H, _, hd = cfg.attn_dims
        q = (x @ p["wq"]).reshape(B, S, H, hd)
        out = A.attention_core(q, k, v, q_positions=positions, causal=False,
                               q_chunk=cfg.attn_q_chunk,
                               flash_vjp=cfg.flash_vjp)
        return out.reshape(B, S, H * hd) @ p["wo"]

    def _dec_layer(self, params_l, x: torch.Tensor, enc_out: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = L.apply_norm(cfg, x, params_l["ln1"])
        x = x + A.attention_block(cfg, params_l["self_attn"], h, positions,
                                  causal=True, window=cfg.sliding_window)
        h = L.apply_norm(cfg, x, params_l["ln_x"])
        p = params_l["cross_attn"]
        x = x + self._cross_attend(p, h, *self._cross_kv(p, enc_out),
                                   positions)
        h = L.apply_norm(cfg, x, params_l["ln2"])
        return x + mlp_block(cfg, params_l["mlp"], h)

    def _embed(self, params, tokens: torch.Tensor, pe: torch.Tensor
               ) -> torch.Tensor:
        return F.embedding(tokens, params["embed"]) + pe

    def logits(self, params, x: torch.Tensor) -> torch.Tensor:
        """Final norm, then the matmul in the params' dtype, then f32."""
        x = L.apply_norm(self.cfg, x, params["final_norm"])
        w = (params["embed"].T if self.cfg.tie_embeddings
             else params["unembed"])
        return (x @ w).float()

    def forward(self, params, tokens: torch.Tensor, *, frames: torch.Tensor
                ) -> tuple[torch.Tensor, dict]:
        """Teacher-forced training forward. tokens (B, S_dec) int, frames
        (B, S_enc, d). Returns (logits (B, S_dec, V) f32, {"aux_loss":
        0})."""
        enc_out = self.encode(params, frames)
        positions, pe = self._positions(params, tokens.shape[1],
                                        tokens.device)
        x = self._embed(params, tokens, pe)
        for i in range(self.cfg.num_layers):
            args = (_index(params["dec_layers"], i), x, enc_out, positions)
            x = (checkpoint(self._dec_layer, *args, use_reentrant=False)
                 if self.cfg.remat else self._dec_layer(*args))
        return self.logits(params, x), {
            "aux_loss": torch.zeros((), device=x.device)}

    # ----------------------------------------------------------------- serve

    def init_cache(self, batch: int, seq_len: int, *, device=None) -> dict:
        _check_decode(self.cfg)
        cfg = self.cfg
        _, Hkv, hd = cfg.attn_dims
        lead = (cfg.num_layers, batch)
        kv = dict(dtype=self.dtype, device=device)
        return {"pos": torch.zeros(batch, dtype=torch.int32, device=device),
                "k": torch.zeros(lead + (seq_len, Hkv, hd), **kv),
                "v": torch.zeros(lead + (seq_len, Hkv, hd), **kv),
                "xk": torch.zeros(lead + (cfg.encoder_seq, Hkv, hd), **kv),
                "xv": torch.zeros(lead + (cfg.encoder_seq, Hkv, hd), **kv)}

    def flash_decode_per_step(self) -> int:
        """``flash_decode`` launches one :meth:`decode_step` makes on the
        card: a decoder layer's self- and cross-attention."""
        return 2 * self.cfg.num_layers

    @torch.no_grad()
    def prefill(self, params, tokens: torch.Tensor, *, frames: torch.Tensor,
                cache_len: Optional[int] = None
                ) -> tuple[torch.Tensor, dict]:
        """Encode the frames once, run the decoder over the whole prompt
        and build both caches: the self-attention's K/V at capacity
        ``cache_len`` (default: the prompt length) and the
        cross-attention's from the encoder's output. Returns
        (last-token logits (B, V) f32, cache)."""
        cfg = self.cfg
        _check_decode(cfg)
        enc_out = self.encode(params, frames)
        B, S = tokens.shape
        H, _, hd = cfg.attn_dims
        positions, pe = self._positions(params, S, tokens.device)
        x = self._embed(params, tokens, pe)
        rows = {name: [] for name in ("k", "v", "xk", "xv")}
        for i in range(cfg.num_layers):
            params_l = _index(params["dec_layers"], i)
            p = params_l["self_attn"]
            h = L.apply_norm(cfg, x, params_l["ln1"])
            q, k, v = A.qkv_project(cfg, p, h, positions)
            out = A.attention_core(q, k, v, q_positions=positions,
                                   q_chunk=cfg.attn_q_chunk,
                                   flash_vjp=cfg.flash_vjp)
            x = x + out.reshape(B, S, H * hd) @ p["wo"]
            h = L.apply_norm(cfg, x, params_l["ln_x"])
            p = params_l["cross_attn"]
            xk, xv = self._cross_kv(p, enc_out)
            x = x + self._cross_attend(p, h, xk, xv, positions)
            h = L.apply_norm(cfg, x, params_l["ln2"])
            x = x + mlp_block(cfg, params_l["mlp"], h)
            for name, t in zip(rows, (k, v, xk, xv)):
                rows[name].append(t)
        cap = cache_len or S
        cache = {name: torch.stack(ts).to(self.dtype)
                 for name, ts in rows.items()}
        for name in ("k", "v"):
            cache[name] = _fit(cache[name], cap, dim=2)
        cache["pos"] = torch.full((B,), S, dtype=torch.int32,
                                  device=tokens.device)
        return self.logits(params, x[:, -1:])[:, 0], cache

    @torch.no_grad()
    def decode_step(self, params, cache: dict, tokens: torch.Tensor, *,
                    use_flash: bool | str = "auto"
                    ) -> tuple[torch.Tensor, dict]:
        """tokens (B, 1) -> (logits (B, 1, V) f32, the cache, updated in
        place: one self-attention row per sequence and layer, and ``pos +
        1``). Both attentions of every layer run through ``flash_decode``
        (a kernel launch each on CUDA tensors, the plain version on CPU
        tensors); ``use_flash`` checks the placement, as
        :meth:`repro_torch.models.lm.LanguageModel.decode_step`'s does."""
        cfg = self.cfg
        pos = cache["pos"]
        kops.check_use_kernels(use_flash, pos.device, option="use_flash")
        B = tokens.shape[0]
        H, _, hd = cfg.attn_dims
        pe = sinusoid(pos, cfg.d_model).to(params["embed"].dtype)[:, None]
        x = self._embed(params, tokens, pe)
        enc_len = torch.full((B,), cache["xk"].shape[2], dtype=torch.int32,
                             device=pos.device)
        for i in range(cfg.num_layers):
            params_l = _index(params["dec_layers"], i)
            h = L.apply_norm(cfg, x, params_l["ln1"])
            out, _, _ = A.decode_attention(cfg, params_l["self_attn"], h,
                                           cache["k"][i], cache["v"][i], pos)
            x = x + out
            h = L.apply_norm(cfg, x, params_l["ln_x"])
            p = params_l["cross_attn"]
            q = (h @ p["wq"]).reshape(B, H, hd)
            out = kops.flash_decode(q, cache["xk"][i], cache["xv"][i],
                                    enc_len, scale=hd ** -0.5)
            x = x + out.reshape(B, 1, H * hd) @ p["wo"]
            h = L.apply_norm(cfg, x, params_l["ln2"])
            x = x + mlp_block(cfg, params_l["mlp"], h)
        pos.add_(1)
        return self.logits(params, x), cache
