"""The packed LARS step's two memory-bound passes, as hand-written CUDA
kernels for Hopper (``csrc/lars_kernels.cu``), each beside its plain
PyTorch version.

Port of ``repro/kernels/lars_kernels.py``:

  * ``norms_flat``    — per row (the reference's ``block_rows=1``), f32
                        ``sum w^2`` and ``sum g^2`` over the packed
                        ``(R, 512)`` pair;
  * ``apply_flat``    — ``m' = mu*m + lr_blk*(g + beta*w); w' = w - m'``
                        with one learning rate per row block;
  * ``apply_flat_q8`` — ``apply_flat`` with the momentum held as int8
                        codes and one f32 scale per row block: it
                        dequantizes, updates and requantizes in one pass,
                        and the f32 momentum never reaches memory.

A wrapper runs its plain version only because the tensors it was given
lie on the CPU. On CUDA tensors it launches the kernel or raises; there
is no fallback from one to the other. Each wrapper counts its launches
in :data:`LAUNCHES`, where it launches and nowhere else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.packing import quantize_blocks_q8
from repro_torch.kernels import build

LANE = 512
BLOCK_ROWS = 8

# kernel launches since the last reset_launch_counts()
LAUNCHES = {"norms_flat": 0, "apply_flat": 0, "apply_flat_q8": 0}

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_P = ctypes.c_void_p
_ARGTYPES = {
    "norms_flat": [_P, _P, _P, _P, ctypes.c_longlong, _P],
    "apply_flat": [_P, _P, _P, _P, _P, _P, ctypes.c_float, ctypes.c_float,
                   ctypes.c_longlong, _P],
    "apply_flat_q8": [_P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_float,
                      ctypes.c_float, ctypes.c_longlong, _P],
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.cache
def _fn(name: str, dtype: torch.dtype):
    """The C entry point of ``name`` for ``dtype`` (builds on first use)."""
    fn = getattr(build.load("lars_kernels"), f"lars_{name}_{_SUFFIX[dtype]}")
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _on_cpu(*xs: torch.Tensor) -> bool:
    devices = {x.device.type for x in xs}
    if devices == {"cpu"}:
        return True
    if devices != {"cuda"} or len({x.device for x in xs}) != 1:
        raise ValueError(f"tensors must all lie on the CPU or all on one "
                         f"CUDA device, got {[str(x.device) for x in xs]}")
    return False


def _check_buffers(block_rows: int, *xs: torch.Tensor,
                   kernel_rows: int = BLOCK_ROWS) -> tuple[int, int]:
    """The kernels take contiguous (R, 512) buffers with R % 8 == 0 that
    start on a 16-byte boundary (their loads and stores are 16 B wide),
    and partials or learning rates per ``kernel_rows`` rows."""
    if block_rows != kernel_rows:
        raise ValueError(f"the CUDA kernel takes block_rows={kernel_rows}, "
                         f"got {block_rows}")
    shape = tuple(xs[0].shape)
    for x in xs:
        if tuple(x.shape) != shape or x.ndim != 2 or shape[1] != LANE \
                or shape[0] % BLOCK_ROWS:
            raise ValueError(f"expected (R, {LANE}) buffers with R % "
                             f"{BLOCK_ROWS} == 0, got "
                             f"{[tuple(x.shape) for x in xs]}")
        if not x.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous buffers")
        if x.data_ptr() % 16:
            raise ValueError("the CUDA kernels take buffers that start on "
                             "a 16-byte boundary")
    return shape


def _check_block_vector(name: str, x: torch.Tensor, rows: int) -> None:
    """Per-row-block operands are contiguous f32 (rows // 8, 1)."""
    if tuple(x.shape) != (rows // BLOCK_ROWS, 1) \
            or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous f32 "
                         f"({rows // BLOCK_ROWS}, 1), got "
                         f"{tuple(x.shape)} {x.dtype}")


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} CUDA launch failed: cudaError {err}")


# --------------------------------------------------------------------- norms

def norms_flat_plain(w2: torch.Tensor, g2: torch.Tensor, *,
                     block_rows: int = 1
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row-block (sum w^2, sum g^2) in f32; two (R // block_rows,)."""
    R = w2.shape[0]
    if R % block_rows:
        raise ValueError(f"rows {R} not a multiple of {block_rows}")
    wf = w2.float().reshape(R // block_rows, -1)
    gf = g2.float().reshape(R // block_rows, -1)
    return torch.sum(wf * wf, dim=1), torch.sum(gf * gf, dim=1)


def norms_flat(w2: torch.Tensor, g2: torch.Tensor, *,
               block_rows: int = 1
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row-block (sum w^2, sum g^2) over a packed (R, 512) pair of
    f32 or bf16 buffers: two (R // block_rows,) f32 vectors. The kernel
    sums per row, so on CUDA ``block_rows`` must be 1 (the caller folds
    rows into slices). One launch."""
    if _on_cpu(w2, g2):
        return norms_flat_plain(w2, g2, block_rows=block_rows)
    R, _ = _check_buffers(block_rows, w2, g2, kernel_rows=1)
    if w2.dtype not in _SUFFIX or g2.dtype != w2.dtype:
        raise ValueError(f"norms_flat takes f32 or bf16 w and g of one "
                         f"dtype, got {w2.dtype}, {g2.dtype}")
    wsq = torch.empty(R, dtype=torch.float32, device=w2.device)
    gsq = torch.empty_like(wsq)
    fn = _fn("norms_flat", w2.dtype)
    with torch.cuda.device(w2.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on(fn(w2.data_ptr(), g2.data_ptr(), wsq.data_ptr(),
                     gsq.data_ptr(), R, stream), "norms_flat")
    LAUNCHES["norms_flat"] += 1
    return wsq, gsq


# --------------------------------------------------------------------- apply

def apply_flat_plain(w2: torch.Tensor, g2: torch.Tensor, m2: torch.Tensor,
                     lr_blocks: torch.Tensor, *, momentum: float,
                     weight_decay: float, block_rows: int = BLOCK_ROWS
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """m' = mu*m + lr_blk*(g + wd*w); w' = w - m'. lr_blocks is
    (R // block_rows, 1) f32. Returns (w' in w2.dtype, m' f32)."""
    R, C = w2.shape
    nblk = R // block_rows
    if R % block_rows or tuple(lr_blocks.shape) != (nblk, 1):
        raise ValueError(f"rows {R} / lr_blocks {tuple(lr_blocks.shape)} "
                         f"do not fit block_rows {block_rows}")
    wf = w2.float().reshape(nblk, -1)
    gf = g2.float().reshape(nblk, -1)
    m_new = momentum * m2.float().reshape(nblk, -1) \
        + lr_blocks.float() * (gf + weight_decay * wf)
    w_new = (wf - m_new).to(w2.dtype)
    return w_new.reshape(R, C), m_new.reshape(R, C)


def apply_flat(w2: torch.Tensor, g2: torch.Tensor, m2: torch.Tensor,
               lr_blocks: torch.Tensor, *, momentum: float,
               weight_decay: float, block_rows: int = BLOCK_ROWS
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused momentum+decay+apply over a packed (R, 512) superbuffer.

    w2, g2: f32 or bf16 of one dtype; m2: f32; lr_blocks: (R // 8, 1)
    f32, the per-layer local LR pre-broadcast to one scalar per row
    block. Returns fresh (w' in w2.dtype, m' f32) buffers. One launch.
    """
    if _on_cpu(w2, g2, m2, lr_blocks):
        return apply_flat_plain(w2, g2, m2, lr_blocks, momentum=momentum,
                                weight_decay=weight_decay,
                                block_rows=block_rows)
    R, _ = _check_buffers(block_rows, w2, g2, m2)
    if w2.dtype not in _SUFFIX or g2.dtype != w2.dtype \
            or m2.dtype != torch.float32:
        raise ValueError(f"apply_flat takes f32 or bf16 w and g of one "
                         f"dtype and f32 m, got {w2.dtype}, {g2.dtype}, "
                         f"{m2.dtype}")
    _check_block_vector("lr_blocks", lr_blocks, R)
    w_new = torch.empty_like(w2)
    m_new = torch.empty_like(m2)
    fn = _fn("apply_flat", w2.dtype)
    with torch.cuda.device(w2.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on(fn(lr_blocks.data_ptr(), w2.data_ptr(), g2.data_ptr(),
                     m2.data_ptr(), w_new.data_ptr(), m_new.data_ptr(),
                     momentum, weight_decay, R, stream), "apply_flat")
    LAUNCHES["apply_flat"] += 1
    return w_new, m_new


# ------------------------------------------------------------ int8 apply

def apply_flat_q8_plain(w2: torch.Tensor, g2: torch.Tensor,
                        q2: torch.Tensor, scale: torch.Tensor,
                        lr_blocks: torch.Tensor, *, momentum: float,
                        weight_decay: float, block_rows: int = BLOCK_ROWS
                        ) -> tuple[torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """``apply_flat`` on the int8 momentum: m = q * scale_blk, the update,
    then each row block requantized against its new absmax / 127 (round
    half to even, clip to +-127, scale 1.0 for an all-zero block, a NaN
    scale and code 0 where the block holds a NaN). q2: (R, 512) int8;
    scale, lr_blocks: (R // block_rows, 1) f32. Returns (w' in w2.dtype,
    q' int8, scale' f32)."""
    R, C = w2.shape
    nblk = R // block_rows
    if R % block_rows or tuple(scale.shape) != (nblk, 1):
        raise ValueError(f"rows {R} / scale {tuple(scale.shape)} do not "
                         f"fit block_rows {block_rows}")
    m = q2.reshape(nblk, -1).float() * scale.float()
    w_new, m_new = apply_flat_plain(w2, g2, m.reshape(R, C), lr_blocks,
                                    momentum=momentum,
                                    weight_decay=weight_decay,
                                    block_rows=block_rows)
    q_new, s_new = quantize_blocks_q8(m_new.reshape(nblk, -1))
    return w_new, q_new.reshape(R, C), s_new


def apply_flat_q8(w2: torch.Tensor, g2: torch.Tensor, q2: torch.Tensor,
                  scale: torch.Tensor, lr_blocks: torch.Tensor, *,
                  momentum: float, weight_decay: float,
                  block_rows: int = BLOCK_ROWS
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused dequantize + momentum/decay/apply + requantize over a packed
    (R, 512) superbuffer whose momentum is int8 codes with one f32 scale
    per row block.

    w2, g2: f32 or bf16 of one dtype; q2: int8; scale, lr_blocks:
    (R // 8, 1) f32. Returns fresh (w' in w2.dtype, q' int8, scale' f32)
    buffers; nothing else is written. One launch.
    """
    if _on_cpu(w2, g2, q2, scale, lr_blocks):
        return apply_flat_q8_plain(w2, g2, q2, scale, lr_blocks,
                                   momentum=momentum,
                                   weight_decay=weight_decay,
                                   block_rows=block_rows)
    R, _ = _check_buffers(block_rows, w2, g2, q2)
    if w2.dtype not in _SUFFIX or g2.dtype != w2.dtype \
            or q2.dtype != torch.int8:
        raise ValueError(f"apply_flat_q8 takes f32 or bf16 w and g of one "
                         f"dtype and int8 q, got {w2.dtype}, {g2.dtype}, "
                         f"{q2.dtype}")
    _check_block_vector("scale", scale, R)
    _check_block_vector("lr_blocks", lr_blocks, R)
    w_new = torch.empty_like(w2)
    q_new = torch.empty_like(q2)
    s_new = torch.empty_like(scale)
    fn = _fn("apply_flat_q8", w2.dtype)
    with torch.cuda.device(w2.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on(fn(lr_blocks.data_ptr(), scale.data_ptr(), w2.data_ptr(),
                     g2.data_ptr(), q2.data_ptr(), w_new.data_ptr(),
                     q_new.data_ptr(), s_new.data_ptr(), momentum,
                     weight_decay, R, stream), "apply_flat_q8")
    LAUNCHES["apply_flat_q8"] += 1
    return w_new, q_new, s_new
