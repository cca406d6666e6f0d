"""Single-token GQA decode attention, as a hand-written CUDA kernel for
Hopper (``csrc/flash_decode.cu``) beside its plain PyTorch version.

Port of ``repro/kernels/flash_decode.py`` (``flash_decode_grouped``):
q4 (B, Hkv, G, D), k/v (B, S, Hkv, D), lengths (B,) int32 -> the
attention output (B, Hkv, G, D) in q4's dtype, an online softmax in f32
over the positions ``j < lengths[b]``; a row of length 0 gives zeros.
``softcap`` > 0 caps each scaled score s to softcap * tanh(s / softcap)
before the softmax, as training does (the reference's kernel takes no
cap); the kernel then launches its capped instances, and 0 the ones
without the cap.
The kernel reads only the ``min(lengths[b], S)`` valid rows of each
sequence, takes any S, and needs no padding of the cache.

The kernel splits each (b, kv head)'s keys over several CTAs
(:func:`split_plan`, from the shapes and the card's SM count only) and
merges the splits inside the same launch: the last CTA of a pair to
finish, found through an integer ticket per pair, merges the partial
results from an f32 workspace in split order. One launch per call, two
calls give the same bits. :func:`flash_decode_split_plain` models that
decomposition in plain PyTorch for the tests.

``lse=True`` launches the instances that also write each row's
log-sum-exp (B, Hkv, G) in f32 (-inf for an empty row) and the output in
f32: a sequence split over ranks (the serving mesh's stripes of the KV
cache) runs the kernel on each stripe and merges the stripes by their
log-sum-exp (:func:`merge_stripes`, and over ranks
:func:`repro_torch.distributed.collectives.merge_stripes`), rounding once
after the merge.

A wrapper runs its plain version only because the tensors it was given
lie on the CPU. On CUDA tensors it launches the kernel or raises; there
is no fallback from one to the other. It counts its launches in
:data:`LAUNCHES`, where it launches and nowhere else.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.lars_kernels import _on_cpu, _raise_on

MAX_GROUP = 8         # query heads per kv head
MAX_HEAD_DIM = 256

# The kernel's CTA (csrc/flash_decode.cu) has 4 warps, each streaming
# tiles of at most 16 keys: a split of a multiple of 64 keys is a whole
# number of the CTA's rounds of tiles.
SPLIT_ROUND = 64
# split_plan aims at CTAS_PER_SM CTAs per SM (2 to 4 waves: 2 to 4 CTAs
# are resident per SM at D <= 128), and gives a split no fewer keys than
# MIN_KEYS_PER_SPLIT. Past D 128 bf16 runs the wide kernel: 8 warps take
# the 16-key tiles that 4 copy warps bring into a 12-stage ring (207 KB
# of shared memory, one CTA an SM), so a split of 128 keys is one tile
# for each of them. There the plan aims at WIDE_CTAS_PER_SM, one CTA an
# SM: measured on an H100, more and shorter splits lost more to the
# merge of the splits (read by one CTA a pair, after the rest) than they
# gained in balance (tools/flash_decode_probe.py --shapes d256). At
# paligemma's serve shape (B 32, S 448): 4 splits of 128 keys, 128 CTAs.
CTAS_PER_SM = 8
WIDE_CTAS_PER_SM = 1
MIN_KEYS_PER_SPLIT = 256
WIDE_MIN_KEYS_PER_SPLIT = 128
# the wide kernel's split merge keeps every split's (m, l) in shared
# memory: at most this many splits
WIDE_MAX_SPLITS = 512

# kernel launches since the last reset_launch_counts()
LAUNCHES = {"flash_decode": 0}

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_P = ctypes.c_void_p
_I = ctypes.c_int
# per device: one int32 ticket per (b, kv head), zero between calls
_TICKETS: dict[torch.device, torch.Tensor] = {}


class SplitPlan(NamedTuple):
    splits: int                 # CTAs per (b, kv head)
    keys_per_split: int         # split s reads keys [s * kps, (s + 1) * kps)
    workspace: tuple[int, int, int, int]   # f32 (B * Hkv, splits, G, D + 2)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def ctas_per_sm(D: int) -> int:
    """The CTAs per SM that :func:`split_plan` aims at for head dim D."""
    return CTAS_PER_SM if D <= 128 else WIDE_CTAS_PER_SM


def min_keys_per_split(D: int) -> int:
    """The fewest keys :func:`split_plan` gives a split at head dim D."""
    return MIN_KEYS_PER_SPLIT if D <= 128 else WIDE_MIN_KEYS_PER_SPLIT


def split_plan(B: int, S: int, Hkv: int, G: int, D: int,
               sm_count: int) -> SplitPlan:
    """How the kernel splits the keys: from the shapes and the SM count
    only, never from the lengths (reading them would cost a sync).

    About ``ctas_per_sm(D) * sm_count`` CTAs over B * Hkv pairs, no split
    under ``min_keys_per_split(D)`` keys, and a multiple of SPLIT_ROUND
    keys per split. The workspace holds each split's running max,
    denominator and (G, D) accumulator.
    """
    pairs = B * Hkv
    want = _cdiv(ctas_per_sm(D) * sm_count, max(pairs, 1))
    splits = max(1, min(want, _cdiv(S, min_keys_per_split(D))))
    if D > 128:
        splits = min(splits, WIDE_MAX_SPLITS)
    keys = _cdiv(_cdiv(max(S, 1), splits), SPLIT_ROUND) * SPLIT_ROUND
    splits = max(1, _cdiv(S, keys))
    return SplitPlan(splits, keys, (pairs, splits, G, D + 2))


@functools.cache
def _sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan(q4: torch.Tensor, k: torch.Tensor) -> SplitPlan:
    """The split plan the kernel runs for these CUDA tensors."""
    B, Hkv, G, D = q4.shape
    return split_plan(B, k.shape[1], Hkv, G, D, _sm_count(q4.device.index))


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    """The device's ticket buffer, with at least ``n`` tickets. Made with
    zeros once (and again only to grow); the kernel leaves it zero."""
    t = _TICKETS.get(device)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _TICKETS[device] = t
    return t


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.cache
def _fn(dtype: torch.dtype, lse: bool = False):
    """The C entry point for ``dtype``, with the log-sum-exp or without
    (builds on first use)."""
    name = f"flash_decode_{'lse_' if lse else ''}{_SUFFIX[dtype]}"
    fn = getattr(build.load("flash_decode"), name)
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                   ctypes.c_float, ctypes.c_float, _I, _I] + (
                       [_P] if lse else []) + [_P]
    fn.restype = ctypes.c_int
    return fn


def flash_decode_plain(q4: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       lengths: torch.Tensor, *, scale: float,
                       softcap: float = 0.0, lse: bool = False):
    """The kernel's function in plain PyTorch (``kernels.ref``): f32
    scores over the whole cache, capped, masked, a guarded softmax. With
    ``lse``: (out f32, lse (B, Hkv, G) f32), as the kernel's."""
    B, Hkv, G, D = q4.shape
    out = ref.flash_decode(q4.reshape(B, Hkv * G, D), k, v, lengths,
                           scale=scale, softcap=softcap, lse=lse)
    if lse:
        return out[0].reshape(B, Hkv, G, D), out[1].reshape(B, Hkv, G)
    return out.reshape(B, Hkv, G, D)


def merge_stripes(outs, lses) -> torch.Tensor:
    """Attention over a sequence cut into stripes, from each stripe's
    ``(out, lse)`` of ``flash_decode(..., lse=True)`` (f32, any matching
    leading shapes; ``out`` has one more trailing dim): each stripe's
    output weighted by exp(lse - max lse), an empty stripe (lse -inf) by
    0, summed in stripe order and divided by the weights' sum, in f32. A
    row empty in every stripe gives zeros. The plain form of the merge
    over ranks (:func:`repro_torch.distributed.collectives.
    merge_stripes`)."""
    lse = torch.stack([x.float() for x in lses])
    m = torch.amax(lse, dim=0)
    m = torch.where(torch.isfinite(m), m, 0.0)
    num = torch.zeros_like(outs[0], dtype=torch.float32)
    den = torch.zeros_like(m)
    for out, x in zip(outs, lse):                 # stripe order
        w = torch.exp(x - m)                      # exp(-inf) = 0
        num = num + out.float() * w[..., None]
        den = den + w
    return num / den.clamp(min=1e-30)[..., None]


def flash_decode_split_plain(q4: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, lengths: torch.Tensor, *,
                             scale: float, splits: int,
                             keys_per_split: int | None = None,
                             softcap: float = 0.0, lse: bool = False):
    """The kernel's decomposition in plain PyTorch, for the tests: split
    s reduces keys [s * kps, (s + 1) * kps) (``kps`` defaults to
    ceil(S / splits)) to a running max m, denominator l and accumulator,
    all f32; the valid splits merge in split order. With ``lse``: (out
    f32, lse = m + log l per row, -inf for an empty row). The main path
    never calls it."""
    B, Hkv, G, D = q4.shape
    S = k.shape[1]
    kps = keys_per_split or _cdiv(S, splits)
    n = lengths.to(q4.device, torch.int64).clamp(0, S)[:, None, None, None]
    qf = q4.float() * scale
    kf, vf = k.float(), v.float()
    dev = q4.device
    m_all = torch.full((B, Hkv, G, 1), -torch.inf, device=dev)
    parts = []
    for s in range(splits):
        lo, hi = s * kps, min(S, (s + 1) * kps)
        if lo >= hi:
            break
        sc = torch.einsum("bhgd,bshd->bhgs", qf, kf[:, lo:hi])
        if softcap:
            sc = softcap * torch.tanh(sc / softcap)
        valid = torch.arange(lo, hi, device=dev)[None, None, None, :] < n
        sc = torch.where(valid, sc, -torch.inf)
        m = torch.amax(sc, dim=-1, keepdim=True)
        p = torch.exp(sc - torch.where(torch.isfinite(m), m, 0.0))
        parts.append((m, p.sum(-1, keepdim=True),
                      torch.einsum("bhgs,bshd->bhgd", p, vf[:, lo:hi])))
        m_all = torch.maximum(m_all, m)
    m_all = torch.where(torch.isfinite(m_all), m_all, 0.0)
    acc = torch.zeros(B, Hkv, G, D, device=dev)
    den = torch.zeros(B, Hkv, G, 1, device=dev)
    for m, l, a in parts:                  # split order
        f = torch.exp(m - m_all)           # exp(-inf) = 0: an empty split
        acc = acc + a * f
        den = den + l * f
    out = acc / den.clamp(min=1e-30)
    if lse:
        return out, (m_all + torch.log(den))[..., 0]   # log 0 = -inf
    return out.to(q4.dtype)


def _check(q4: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           lengths: torch.Tensor) -> None:
    """What the kernel takes: contiguous f32 or bf16 q4/k/v of one dtype
    on 16-byte boundaries, int32 lengths, 1 <= G <= 8, D a multiple of 8
    up to 256 (its loads are 16 B wide)."""
    if q4.ndim != 4 or k.ndim != 4 or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"expected q4 (B, Hkv, G, D) and k, v (B, S, Hkv, "
                         f"D), got {tuple(q4.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Hkv, G, D = q4.shape
    if k.shape[0] != B or k.shape[2] != Hkv or k.shape[3] != D \
            or tuple(lengths.shape) != (B,):
        raise ValueError(f"shapes do not agree: q4 {tuple(q4.shape)}, k "
                         f"{tuple(k.shape)}, lengths {tuple(lengths.shape)}")
    if q4.dtype not in _SUFFIX or k.dtype != q4.dtype \
            or v.dtype != q4.dtype or lengths.dtype != torch.int32:
        raise ValueError(f"flash_decode takes f32 or bf16 q, k, v of one "
                         f"dtype and int32 lengths, got {q4.dtype}, "
                         f"{k.dtype}, {v.dtype}, {lengths.dtype}")
    if not 1 <= G <= MAX_GROUP or D % 8 or not 8 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"flash_decode takes 1 <= G <= {MAX_GROUP} and D a "
                         f"multiple of 8 up to {MAX_HEAD_DIM}, got G={G}, "
                         f"D={D}")
    for name, x in (("q4", q4), ("k", k), ("v", v), ("lengths", lengths)):
        if not x.is_contiguous():
            raise ValueError(f"flash_decode takes a contiguous {name}")
    for name, x in (("q4", q4), ("k", k), ("v", v)):
        if x.data_ptr() % 16:
            raise ValueError(f"flash_decode takes {name} on a 16-byte "
                             "boundary")


def flash_decode(q4: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor, *, scale: float,
                 softcap: float = 0.0, lse: bool = False):
    """Decode attention of the G query heads of each kv head against a
    KV cache with per-sequence valid lengths. Returns a fresh
    (B, Hkv, G, D) tensor in q4.dtype; with ``lse``, (out (B, Hkv, G, D)
    f32, lse (B, Hkv, G) f32), each row's log-sum-exp of its scaled
    (capped) scores over its valid keys (-inf where there is none): the
    kernel's ``lse`` instances, in the same one launch.

    One launch, with no host sync and no memset: the f32 workspace of
    :func:`plan` comes from ``torch.empty``, and the kernel's tickets
    from a buffer cached per device, zeroed once when made, which the
    kernel leaves zero. The cached tickets assume calls on one stream at
    a time: two calls running concurrently on one device would share
    them. ``softcap`` > 0 launches the capped instances."""
    if softcap < 0 or softcap != softcap:
        raise ValueError(f"flash_decode takes a softcap >= 0, got {softcap}")
    if _on_cpu(q4, k, v, lengths):
        return flash_decode_plain(q4, k, v, lengths, scale=scale,
                                  softcap=softcap, lse=lse)
    _check(q4, k, v, lengths)
    B, Hkv, G, D = q4.shape
    splits, keys, ws_shape = plan(q4, k)
    out = torch.empty(q4.shape, device=q4.device,
                      dtype=torch.float32 if lse else q4.dtype)
    lse_t = torch.empty((B, Hkv, G), dtype=torch.float32,
                        device=q4.device) if lse else None
    ws = torch.empty(ws_shape, dtype=torch.float32, device=q4.device)
    tickets = _tickets(q4.device, B * Hkv)
    fn = _fn(q4.dtype, lse)
    with torch.cuda.device(q4.device):
        stream = torch.cuda.current_stream().cuda_stream
        extra = (lse_t.data_ptr(),) if lse else ()
        _raise_on(fn(q4.data_ptr(), k.data_ptr(), v.data_ptr(),
                     lengths.data_ptr(), out.data_ptr(), ws.data_ptr(),
                     tickets.data_ptr(), B, k.shape[1], Hkv, G, D,
                     float(scale), float(softcap), splits, keys, *extra,
                     stream),
                  "flash_decode")
    LAUNCHES["flash_decode"] += 1
    return (out, lse_t) if lse else out
