"""Token sampling for the serve decode step: port of
``repro/serve/sampling.py``.

Greedy / temperature / top-k / top-p over a (B, V) logits batch with
per-slot keys. Everything here runs on the logits' device inside the
decode step, so the serve loop only ever ships (B, 1) int32 tokens to
the host — logits never leave the card.

Keys. The reference draws with JAX's threefry, which the port does not
reproduce. It keeps the reference's contract with its own counter-based
keys: a request's key is a pure function of (seed, request id)
(:func:`make_keys`), and the token at absolute position p is drawn from
that key folded with p (:func:`fold_positions`) — so output does not
depend on the slot a request lands in or on the tick it was admitted at.
A key is two 32-bit words held in int64 (every value in [0, 2^32));
the mixing function is the integer hash "lowbias32" (C. Wellons), its
32-bit products split into 16-bit halves so no int64 product overflows.
The draw is Gumbel-max (as ``jax.random.categorical``): one uniform per
(row, vocab entry) hashed from the folded key and the vocab index.
"""

from __future__ import annotations

import dataclasses

import torch

NEG_INF = -1.0e30
_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Sampling policy.

    kind: "greedy" | "temperature" | "top_k" | "top_p". temperature
    applies to all stochastic kinds; top_k/top_p additionally restrict
    the support before the categorical draw.
    """

    kind: str = "greedy"
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0

    def __post_init__(self):
        if self.kind not in ("greedy", "temperature", "top_k", "top_p"):
            raise ValueError(f"unknown sampler kind {self.kind!r}")
        if self.kind == "top_k" and self.top_k <= 0:
            raise ValueError("top_k sampler needs top_k > 0")
        if self.kind == "top_p" and not 0.0 < self.top_p <= 1.0:
            raise ValueError("top_p sampler needs 0 < top_p <= 1")

    @property
    def stochastic(self) -> bool:
        return self.kind != "greedy" and self.temperature > 0.0


def parse_sampler(spec: str) -> SamplerConfig:
    """CLI sampler spec -> SamplerConfig.

    ``greedy`` | ``temperature:T`` | ``top_k:K[:T]`` | ``top_p:P[:T]``
    (T defaults to 1.0), e.g. ``top_k:40:0.8``.
    """
    parts = spec.split(":")
    kind = parts[0]
    try:
        if kind == "greedy" and len(parts) == 1:
            return SamplerConfig("greedy")
        if kind == "temperature" and len(parts) == 2:
            return SamplerConfig("temperature", temperature=float(parts[1]))
        if kind == "top_k" and len(parts) in (2, 3):
            t = float(parts[2]) if len(parts) > 2 else 1.0
            return SamplerConfig("top_k", top_k=int(parts[1]), temperature=t)
        if kind == "top_p" and len(parts) in (2, 3):
            t = float(parts[2]) if len(parts) > 2 else 1.0
            return SamplerConfig("top_p", top_p=float(parts[1]),
                                 temperature=t)
    except ValueError as e:                 # bad number / bad range
        raise ValueError(f"cannot parse sampler spec {spec!r}: {e}")
    raise ValueError(f"cannot parse sampler spec {spec!r}")


# ------------------------------------------------------------------- keys

def _mul32(x, c: int):
    """(x * c) mod 2^32 for x in [0, 2^32), without an int64 overflow."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _hash32(x):
    """lowbias32: a bijective 32-bit integer mix (tensors or ints)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def make_keys(seed: int, ids, device=None) -> torch.Tensor:
    """Per-request keys, a pure function of (seed, id).

    ids: (n,) ints (request ids). Returns (n, 2) int64 on ``device``.
    """
    r = torch.as_tensor(ids, dtype=torch.int64, device=device) & _M32
    k0 = _hash32(r ^ _hash32(seed & _M32))
    k1 = _hash32(k0 ^ 0x9E3779B9)
    return torch.stack([k0, k1], dim=-1)


def fold_positions(keys: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Fold each row's key with its position: ((B, 2) int64, (B,) int)
    -> (B, 2) int64, a pure function of (key, position)."""
    p = pos.to(torch.int64) & _M32
    k0 = _hash32(keys[:, 0] ^ _hash32(p))
    k1 = _hash32(keys[:, 1] ^ _hash32(p ^ 0x85EBCA6B))
    return torch.stack([k0, k1], dim=-1)


def _uniform(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) f32 uniforms in (0, 1): entry (b, v) hashed from key b and
    the index v."""
    v = torch.arange(n, dtype=torch.int64, device=keys.device)
    h = _hash32(_hash32(keys[:, :1] ^ v) ^ keys[:, 1:])
    return ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))


# ----------------------------------------------------------------- sample

def _top_k_mask(x: torch.Tensor, k: int) -> torch.Tensor:
    kth = torch.topk(x, k, dim=-1).values[..., -1:]          # (B, 1)
    return torch.where(x < kth, NEG_INF, x)


def _top_p_mask(x: torch.Tensor, p: float) -> torch.Tensor:
    # nucleus: keep the smallest prefix of the sorted distribution whose
    # mass reaches p (the token crossing the boundary is kept)
    sorted_x = torch.sort(x, dim=-1, descending=True).values
    probs = torch.softmax(sorted_x, dim=-1)
    csum = torch.cumsum(probs, dim=-1)
    keep = (csum - probs) < p                                 # exclusive prefix
    kth = torch.amin(torch.where(keep, sorted_x, torch.inf), dim=-1,
                     keepdim=True)
    return torch.where(x < kth, NEG_INF, x)


def sample(scfg: SamplerConfig, logits: torch.Tensor,
           keys: torch.Tensor) -> torch.Tensor:
    """One token per row. logits (B, V) f32; keys (B, 2) int64.

    Returns (B,) int32 on the logits' device, with no host sync. As
    temperature -> 0 every stochastic kind converges to greedy.
    """
    if not scfg.stochastic:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    x = logits.float() / max(scfg.temperature, 1e-8)
    if scfg.kind == "top_k":
        x = _top_k_mask(x, scfg.top_k)
    elif scfg.kind == "top_p":
        x = _top_p_mask(x, scfg.top_p)
    gumbel = -torch.log(-torch.log(_uniform(keys, x.shape[-1])))
    return torch.argmax(x + gumbel, dim=-1).to(torch.int32)
