"""Single-token GQA decode attention, as a hand-written CUDA kernel for
Hopper (``csrc/flash_decode.cu``) beside its plain PyTorch version.

Port of ``repro/kernels/flash_decode.py`` (``flash_decode_grouped``):
q4 (B, Hkv, G, D), k/v (B, S, Hkv, D), lengths (B,) int32 -> the
attention output (B, Hkv, G, D) in q4's dtype, an online softmax in f32
over the positions ``j < lengths[b]``; a row of length 0 gives zeros.
The kernel reads only the ``min(lengths[b], S)`` valid rows of each
sequence, takes any S, and needs no padding of the cache.

A wrapper runs its plain version only because the tensors it was given
lie on the CPU. On CUDA tensors it launches the kernel or raises; there
is no fallback from one to the other. It counts its launches in
:data:`LAUNCHES`, where it launches and nowhere else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.lars_kernels import _on_cpu, _raise_on

MAX_GROUP = 8         # query heads per kv head
MAX_HEAD_DIM = 128

# kernel launches since the last reset_launch_counts()
LAUNCHES = {"flash_decode": 0}

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.cache
def _fn(dtype: torch.dtype):
    """The C entry point for ``dtype`` (builds on first use)."""
    fn = getattr(build.load("flash_decode"), f"flash_decode_{_SUFFIX[dtype]}")
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float,
                   _P]
    fn.restype = ctypes.c_int
    return fn


def flash_decode_plain(q4: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       lengths: torch.Tensor, *, scale: float
                       ) -> torch.Tensor:
    """The kernel's function in plain PyTorch (``kernels.ref``): f32
    scores over the whole cache, masked, a guarded softmax."""
    B, Hkv, G, D = q4.shape
    out = ref.flash_decode(q4.reshape(B, Hkv * G, D), k, v, lengths,
                           scale=scale)
    return out.reshape(B, Hkv, G, D)


def _check(q4: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           lengths: torch.Tensor) -> None:
    """What the kernel takes: contiguous f32 or bf16 q4/k/v of one dtype
    on 16-byte boundaries, int32 lengths, 1 <= G <= 8, D a multiple of 8
    up to 128 (its loads are 16 B wide)."""
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
                 lengths: torch.Tensor, *, scale: float) -> torch.Tensor:
    """Decode attention of the G query heads of each kv head against a
    KV cache with per-sequence valid lengths. Returns a fresh
    (B, Hkv, G, D) tensor in q4.dtype. One launch."""
    if _on_cpu(q4, k, v, lengths):
        return flash_decode_plain(q4, k, v, lengths, scale=scale)
    _check(q4, k, v, lengths)
    B, Hkv, G, D = q4.shape
    out = torch.empty_like(q4)
    fn = _fn(q4.dtype)
    with torch.cuda.device(q4.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on(fn(q4.data_ptr(), k.data_ptr(), v.data_ptr(),
                     lengths.data_ptr(), out.data_ptr(), B, k.shape[1], Hkv,
                     G, D, float(scale), stream), "flash_decode")
    LAUNCHES["flash_decode"] += 1
    return out
