"""The port's CUDA kernels on the card, against their plain versions.

Needs a CUDA device and ``nvcc``; skipped elsewhere. Imports no JAX (the
card's machine has none): the plain versions these tests hold the
kernels against are themselves held against the JAX package on the CPU
in ``tests/test_torch_kernels.py``.

Tolerances: ``apply_flat`` is built with ``-fmad=false`` and performs
the plain version's operations in its order, so the two agree bit for
bit. ``norms_flat`` sums 4096 squares per block in another order than
``torch.sum``; the f32 relative error of such a sum stays near
sqrt(4096) * 2^-24 ~ 4e-6, so rtol 1e-5 holds it.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import lars, sgd
from repro_torch.kernels import lars_kernels as lk

pytestmark = pytest.mark.cuda

NORMS_RTOL = 1e-5
SHAPES = [(272, 512), (65536, 512)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _buffers(rows, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    w, gr, m = (torch.randn(rows, 512, generator=g) for _ in range(3))
    lr = torch.rand(rows // 8, 1, generator=g) * 0.1
    return (w.to(device, dtype), gr.to(device, dtype), m.to(device),
            lr.to(device))


@pytest.mark.parametrize("rows", [r for r, _ in SHAPES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_norms_flat_matches_plain(cuda, rows, dtype):
    w, g, _, _ = _buffers(rows, dtype, cuda)
    before = lk.LAUNCHES["norms_flat"]
    wsq, gsq = lk.norms_flat(w, g)
    torch.cuda.synchronize()
    assert lk.LAUNCHES["norms_flat"] == before + 1
    pw, pg = lk.norms_flat_plain(w, g)
    torch.testing.assert_close(wsq, pw, rtol=NORMS_RTOL, atol=0)
    torch.testing.assert_close(gsq, pg, rtol=NORMS_RTOL, atol=0)
    # no atomics: the same inputs give the same bits
    wsq2, _ = lk.norms_flat(w, g)
    assert torch.equal(wsq, wsq2)


@pytest.mark.parametrize("rows", [r for r, _ in SHAPES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_apply_flat_matches_plain_bit_for_bit(cuda, rows, dtype):
    w, g, m, lr = _buffers(rows, dtype, cuda, seed=1)
    before = lk.LAUNCHES["apply_flat"]
    w2, m2 = lk.apply_flat(w, g, m, lr, momentum=0.9, weight_decay=1e-4)
    torch.cuda.synchronize()
    assert lk.LAUNCHES["apply_flat"] == before + 1
    pw, pm = lk.apply_flat_plain(w, g, m, lr, momentum=0.9,
                                 weight_decay=1e-4)
    assert w2.dtype == dtype and m2.dtype == torch.float32
    assert torch.equal(m2, pm)
    assert torch.equal(w2, pw)


@pytest.mark.parametrize("bad", ["rows", "lane", "strided", "dtype",
                                 "misaligned"])
def test_wrappers_reject_what_the_kernels_do_not_take(cuda, bad):
    w, g, m, lr = _buffers(16, torch.float32, cuda)
    if bad == "misaligned":
        flat = torch.zeros(16 * 512 + 1, device=cuda)
        w = flat[1:].view(16, 512)
    elif bad == "rows":
        w, g, m = w[:12], g[:12], m[:12]
    elif bad == "lane":
        w, g, m = (x.reshape(32, 256) for x in (w, g, m))
    elif bad == "strided":
        w = torch.cat([w, w], 1)[:, ::2]
    else:
        w, g = w.half(), g.half()
    with pytest.raises(ValueError):
        lk.norms_flat(w, g)
    with pytest.raises(ValueError):
        lk.apply_flat(w, g, m, lr, momentum=0.9, weight_decay=1e-4)
    with pytest.raises(ValueError):
        lk.norms_flat(w, g.cpu())


def _tree(device):
    g = torch.Generator().manual_seed(3)
    t = {"a": {"w": torch.randn(37, 19, generator=g),
               "b": torch.randn(7, generator=g)},
         "stack": torch.randn(3, 11, 13, generator=g),
         "big": torch.randn(600, 40, generator=g)}
    return {k: (v.to(device) if isinstance(v, torch.Tensor) else
                {kk: vv.to(device) for kk, vv in v.items()})
            for k, v in t.items()}


@pytest.mark.parametrize("make,launches", [(lars, 1), (sgd, 0)])
def test_packed_step_launch_contract_and_cpu_agreement(cuda, make, launches):
    """One norms_flat and one apply_flat launch per LARS step, whatever
    the leaf count; none for SGD. The card's step agrees with the CPU
    run of the plain versions."""
    marker = {"a": {"w": False, "b": False}, "stack": True, "big": False}
    results = {}
    for dev in ("cpu", cuda):
        params = _tree(dev)
        grads = {k: (v * 0.01 if isinstance(v, torch.Tensor) else
                     {kk: vv * 0.01 for kk, vv in v.items()})
                 for k, v in params.items()}
        opt = make(0.2)
        state = opt.init(params, stacked=marker)
        lk.reset_launch_counts()
        for _ in range(3):
            params, state = opt.update(grads, state, params, stacked=marker)
        if dev is cuda:
            torch.cuda.synchronize()
            assert lk.LAUNCHES == {"norms_flat": 3 * launches,
                                   "apply_flat": 3 * launches}
        results[str(dev)] = state.slots
    for k, v in results["cpu"].items():
        np.testing.assert_allclose(results["cuda"][k].cpu().numpy(),
                                   v.numpy(), rtol=1e-5, atol=1e-6)


def test_use_kernels_true_runs_the_kernels(cuda):
    """use_kernels=True takes CUDA buffers and launches both kernels;
    False, which asks for the plain versions, refuses them."""
    params = _tree(cuda)
    marker = {"a": {"w": False, "b": False}, "stack": True, "big": False}
    opt = lars(0.2, use_kernels=True)
    state = opt.init(params, stacked=marker)
    lk.reset_launch_counts()
    opt.update(params, state, params, stacked=marker)
    assert lk.LAUNCHES == {"norms_flat": 1, "apply_flat": 1}
    with pytest.raises(ValueError, match="needs CPU buffers"):
        lars(0.2, use_kernels=False).update(params, state, params)
