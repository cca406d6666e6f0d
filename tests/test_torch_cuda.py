"""The port's CUDA kernels on the card, against their plain versions.

Needs a CUDA device and ``nvcc``; skipped elsewhere. Imports no JAX (the
card's machine has none): the plain versions these tests hold the
kernels against are themselves held against the JAX package on the CPU
in ``tests/test_torch_kernels.py``.

Tolerances: ``apply_flat`` and ``apply_flat_q8`` are built with
``-fmad=false`` and perform the plain versions' operations in their
order (IEEE division and round half to even in the requantization), so
each agrees with its plain version bit for bit. ``norms_flat`` sums 4096 squares per block in another order than
``torch.sum``; the f32 relative error of such a sum stays near
sqrt(4096) * 2^-24 ~ 4e-6, so rtol 1e-5 holds it.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import lars, packing, sgd
from repro_torch.kernels import lars_kernels as lk
from repro_torch.models import build_model
from repro_torch.train import TrainPipeline

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
                                   "apply_flat": 3 * launches,
                                   "apply_flat_q8": 0}
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
    assert lk.LAUNCHES == {"norms_flat": 1, "apply_flat": 1,
                           "apply_flat_q8": 0}
    with pytest.raises(ValueError, match="needs CPU buffers"):
        lars(0.2, use_kernels=False).update(params, state, params)


def _q8_buffers(rows, dtype, device, seed=2):
    w, g, m, lr = _buffers(rows, dtype, device, seed)
    q, scale = packing.quantize_blocks_q8((m * 0.05).view(rows // 8, -1))
    scale = scale.contiguous()
    q = q.view(rows, 512)
    q[:8] = 0                       # a zero block keeps scale 1.0 ...
    scale[0] = 1.0
    lr[0] = 0.0                     # ... when its lr and w, g are zero
    w[:8] = 0
    g[:8] = 0
    return w, g, q, scale, lr


@pytest.mark.parametrize("rows", [r for r, _ in SHAPES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_apply_flat_q8_matches_plain_bit_for_bit(cuda, rows, dtype):
    w, g, q, s, lr = _q8_buffers(rows, dtype, cuda)
    ins = [x.clone() for x in (w, g, q, s, lr)]
    before = dict(lk.LAUNCHES)
    w2, q2, s2 = lk.apply_flat_q8(w, g, q, s, lr, momentum=0.9,
                                  weight_decay=1e-4)
    torch.cuda.synchronize()
    assert lk.LAUNCHES["apply_flat_q8"] == before["apply_flat_q8"] + 1
    assert lk.LAUNCHES["apply_flat"] == before["apply_flat"]
    pw, pq, ps = lk.apply_flat_q8_plain(w, g, q, s, lr, momentum=0.9,
                                        weight_decay=1e-4)
    assert (w2.dtype, q2.dtype, s2.dtype) == (dtype, torch.int8,
                                              torch.float32)
    assert torch.equal(s2, ps)
    assert torch.equal(q2, pq)
    assert torch.equal(w2, pw)
    assert float(s2[0]) == 1.0 and not q2[:8].any()
    # its only outputs are w', q' and scale': the inputs are untouched
    for a, b in zip((w, g, q, s, lr), ins):
        assert torch.equal(a, b)


def test_apply_flat_q8_propagates_nan(cuda):
    """A block holding a NaN comes out with a NaN scale, as the plain
    version's does (fmaxf would have dropped it), and code 0 there."""
    w, g, q, s, lr = _q8_buffers(32, torch.float32, cuda)
    g[9, 17] = float("nan")
    w2, q2, s2 = lk.apply_flat_q8(w, g, q, s, lr, momentum=0.9,
                                  weight_decay=1e-4)
    pw, pq, ps = lk.apply_flat_q8_plain(w, g, q, s, lr, momentum=0.9,
                                        weight_decay=1e-4)
    torch.cuda.synchronize()
    assert torch.isnan(s2[1, 0]) and torch.isnan(ps[1, 0])
    assert torch.isfinite(s2[[0, 2, 3]]).all()
    assert q2[9, 17].item() == 0 and torch.equal(q2, pq)
    assert torch.equal(s2[[0, 2, 3]], ps[[0, 2, 3]])


@pytest.mark.parametrize("bad", ["q_misaligned", "q_dtype", "scale_shape",
                                 "scale_dtype", "lr_shape", "q_shape"])
def test_apply_flat_q8_refuses_what_the_kernel_does_not_take(cuda, bad):
    w, g, q, s, lr = _q8_buffers(16, torch.float32, cuda)
    if bad == "q_misaligned":
        flat = torch.zeros(16 * 512 + 1, dtype=torch.int8, device=cuda)
        q = flat[1:].view(16, 512)
    elif bad == "q_dtype":
        q = q.to(torch.int16)
    elif bad == "scale_shape":
        s = s.view(-1)
    elif bad == "scale_dtype":
        s = s.double()
    elif bad == "lr_shape":
        lr = lr[:1]
    else:
        q = q[:8]
    with pytest.raises(ValueError):
        lk.apply_flat_q8(w, g, q, s, lr, momentum=0.9, weight_decay=1e-4)


def test_int8_lars_step_is_norms_flat_plus_apply_flat_q8(cuda):
    """One norms_flat and one apply_flat_q8 launch per int8 LARS step,
    none of apply_flat; the step agrees with the CPU run of the plain
    versions (codes within one step, where the norms' summation order
    moves a value across a rounding boundary)."""
    marker = {"a": {"w": False, "b": False}, "stack": True, "big": False}
    results = {}
    for dev in ("cpu", cuda):
        params = _tree(dev)
        grads = {k: (v * 0.01 if isinstance(v, torch.Tensor) else
                     {kk: vv * 0.01 for kk, vv in v.items()})
                 for k, v in params.items()}
        opt = lars(0.2, slot_dtype="int8")
        state = opt.init(params, stacked=marker)
        lk.reset_launch_counts()
        for _ in range(3):
            params, state = opt.update(grads, state, params, stacked=marker)
        if dev is cuda:
            torch.cuda.synchronize()
            assert lk.LAUNCHES == {"norms_flat": 3, "apply_flat": 0,
                                   "apply_flat_q8": 3}
        results[str(dev)] = state.slots
    cpu, card = results["cpu"], results["cuda"]
    assert card["momentum"].dtype == torch.int8
    diff = (card["momentum"].cpu().int() - cpu["momentum"].int()).abs()
    assert int(diff.max()) <= 1
    np.testing.assert_allclose(card["momentum_scale"].cpu().numpy(),
                               cpu["momentum_scale"].numpy(), rtol=1e-5)
    np.testing.assert_allclose(card[packing.WEIGHT_SLOT].cpu().numpy(),
                               cpu[packing.WEIGHT_SLOT].numpy(), rtol=1e-5,
                               atol=1e-4)


def test_pipeline_bf16_int8_accumulation_on_the_card(cuda):
    """TrainPipeline at the main path's settings on a small batch: bf16
    compute, f32 master, int8 momentum, 4 microbatches; one launch of
    each LARS kernel per step."""
    cfg = get_config("lenet-mnist")
    model = build_model(cfg)
    pipe = TrainPipeline(model, lars(0.05, slot_dtype="int8"), cfg,
                         accum_steps=4, precision="bf16")
    state = pipe.init_state(torch.Generator().manual_seed(0), cuda)
    gen = torch.Generator().manual_seed(1)
    batch = {"x": torch.rand(64, 28, 28, 1, generator=gen).to(cuda),
             "y": torch.randint(0, 10, (64,), generator=gen).to(cuda)}
    lk.reset_launch_counts()
    for _ in range(2):
        state, metrics = pipe(state, batch)
    torch.cuda.synchronize()
    assert lk.LAUNCHES == {"norms_flat": 2, "apply_flat": 0,
                           "apply_flat_q8": 2}
    assert torch.isfinite(metrics["loss"])
    assert state.opt_state.slots[packing.MASTER_SLOT].dtype == torch.float32
    assert state.params["fc1"]["w"].dtype == torch.bfloat16
