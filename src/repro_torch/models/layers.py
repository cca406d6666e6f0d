"""Shared primitive layers: init helpers, norms, rotary embeddings,
activations. Port of ``repro/models/layers.py``: plain functions over
plain dict params, in the reference's leaf layouts (``(in, out)`` dense
weights, ``(d,)`` f32 norm scales).

The initializers draw from an explicit ``torch.Generator`` (a CPU
generator) in f32 and then cast and move, so one seed gives the same
weights on every device, at the reference's distributions (not its
bits: ``jax.random`` cannot be reproduced). On the meta device they draw
nothing: a meta init gives the shapes and dtypes of a full-size model
at no cost.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


# ----------------------------------------------------------------- initizers

def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype, device, *, scale: float = 1.0
               ) -> torch.Tensor:
    """Fan-in normal init: std = scale / sqrt(d_in)."""
    return _normal(gen, (d_in, d_out), scale / (d_in ** 0.5), dtype, device)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype, device) -> torch.Tensor:
    return _normal(gen, (vocab, d), 0.02, dtype, device)


def _normal(gen: torch.Generator, shape: tuple, std: float,
            dtype: torch.dtype, device) -> torch.Tensor:
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    # scaled in place and cast on the device (the same round to nearest
    # even as on the host): the same values as drawing, scaling and
    # casting on the host, with less host work per element
    w = torch.randn(shape, generator=gen).mul_(std)
    return w.to(device).to(dtype)


# ----------------------------------------------------------------- norms

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """Stats in f32; the apply stays in x.dtype (as the reference: the
    square in x.dtype, accumulated in f32, the inverse cast back)."""
    var = torch.mean(torch.square(x), dim=-1, keepdim=True,
                     dtype=torch.float32)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * scale.to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (x - mu.to(x.dtype)) * torch.rsqrt(var + eps).to(x.dtype)
    return out * scale.to(x.dtype) + bias.to(x.dtype)


def apply_norm(cfg, x: torch.Tensor, p: dict) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layernorm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rmsnorm(x, p["scale"], cfg.norm_eps)


def init_norm(cfg, d: int, device) -> dict:
    if cfg.norm == "layernorm":
        return {"scale": torch.ones(d, device=device),
                "bias": torch.zeros(d, device=device)}
    return {"scale": torch.ones(d, device=device)}


# ----------------------------------------------------------------- rotary

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, D) rotated pairwise-half style; positions: (..., S).
    The rotation is computed in f32 and cast back to x.dtype."""
    D = x.shape[-1]
    freqs = rope_freqs(D, theta, x.device)                    # (D/2,)
    angles = positions[..., None].float() * freqs             # (..., S, D/2)
    cos = torch.cos(angles)[..., :, None, :]                  # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- act fns

def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


ACTS = {
    "silu": F.silu,
    "gelu": gelu,
    "relu": F.relu,
    "relu2": lambda x: torch.square(F.relu(x)),     # nemotron/minitron
}


def gated(cfg) -> bool:
    return cfg.act in ("silu", "swiglu", "geglu")


def act_fn(cfg):
    name = {"swiglu": "silu", "geglu": "gelu"}.get(cfg.act, cfg.act)
    return ACTS[name]
