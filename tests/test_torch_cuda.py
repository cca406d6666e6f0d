"""The port's CUDA kernels on the card, against their plain versions.

Needs a CUDA device and ``nvcc``; skipped elsewhere. Imports no JAX (the
card's machine has none): the plain versions these tests hold the
kernels against are themselves held against the JAX package on the CPU
in ``tests/test_torch_kernels.py``.

Tolerances: ``apply_flat`` and ``apply_flat_q8`` are built with
``-fmad=false`` and perform the plain versions' operations in their
order (IEEE division and round half to even in the requantization), so
each agrees with its plain version bit for bit. ``norms_flat`` sums the
512 squares of a row in another order than ``torch.sum``; the f32
relative error of such a sum stays near sqrt(512) * 2^-24 ~ 1.3e-6, so
rtol 1e-5 holds it.
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
ROWS = [8, 272, 65536]


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


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_norms_flat_matches_plain(cuda, rows, dtype):
    w, g, _, _ = _buffers(rows, dtype, cuda)
    before = lk.LAUNCHES["norms_flat"]
    wsq, gsq = lk.norms_flat(w, g, block_rows=1)
    torch.cuda.synchronize()
    assert lk.LAUNCHES["norms_flat"] == before + 1
    assert wsq.shape == gsq.shape == (rows,)
    pw, pg = lk.norms_flat_plain(w, g, block_rows=1)
    torch.testing.assert_close(wsq, pw, rtol=NORMS_RTOL, atol=0)
    torch.testing.assert_close(gsq, pg, rtol=NORMS_RTOL, atol=0)
    # no atomics, no cross-CTA step: the same inputs give the same bits
    for _ in range(3):
        wsq2, gsq2 = lk.norms_flat(w, g, block_rows=1)
        assert torch.equal(wsq, wsq2) and torch.equal(gsq, gsq2)


def test_norms_flat_refuses_block_rows_other_than_1(cuda):
    w, g, _, _ = _buffers(16, torch.float32, cuda)
    before = lk.LAUNCHES["norms_flat"]
    with pytest.raises(ValueError, match="block_rows=1"):
        lk.norms_flat(w, g, block_rows=8)
    assert lk.LAUNCHES["norms_flat"] == before


def _apply_check(w, g, m, lr):
    before = lk.LAUNCHES["apply_flat"]
    w2, m2 = lk.apply_flat(w, g, m, lr, momentum=0.9, weight_decay=1e-4)
    torch.cuda.synchronize()
    assert lk.LAUNCHES["apply_flat"] == before + 1
    pw, pm = lk.apply_flat_plain(w, g, m, lr, momentum=0.9,
                                 weight_decay=1e-4)
    assert w2.dtype == w.dtype and m2.dtype == torch.float32
    assert torch.equal(m2, pm)
    assert torch.equal(w2, pw)


@pytest.mark.parametrize("rows", ROWS + [65544])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_apply_flat_matches_plain_bit_for_bit(cuda, rows, dtype):
    _apply_check(*_buffers(rows, dtype, cuda, seed=1))


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


def _q8_buffers(rows, dtype, device, seed=2, zero_block=True):
    w, g, m, lr = _buffers(rows, dtype, device, seed)
    q, scale = packing.quantize_blocks_q8((m * 0.05).view(rows // 8, -1))
    scale = scale.contiguous()
    q = q.view(rows, 512)
    if zero_block:
        q[:8] = 0                   # a zero block keeps scale 1.0 ...
        scale[0] = 1.0
        lr[0] = 0.0                 # ... when its lr and w, g are zero
        w[:8] = 0
        g[:8] = 0
    return w, g, q, scale, lr


def _q8_check(w, g, q, s, lr):
    """One launch; w', q' and scale' equal the plain version's bits."""
    before = dict(lk.LAUNCHES)
    got = lk.apply_flat_q8(w, g, q, s, lr, momentum=0.9, weight_decay=1e-4)
    torch.cuda.synchronize()
    assert lk.LAUNCHES["apply_flat_q8"] == before["apply_flat_q8"] + 1
    assert lk.LAUNCHES["apply_flat"] == before["apply_flat"]
    want = lk.apply_flat_q8_plain(w, g, q, s, lr, momentum=0.9,
                                  weight_decay=1e-4)
    assert tuple(x.dtype for x in got) == (w.dtype, torch.int8,
                                           torch.float32)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    return got


# R = 8 is one cluster (one row block); 65544 is 8,193 clusters
@pytest.mark.parametrize("rows", [8, 272, 65536, 65544])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_apply_flat_q8_matches_plain_bit_for_bit(cuda, rows, dtype):
    zero_block = rows > 8           # R = 8: its one block holds values
    w, g, q, s, lr = _q8_buffers(rows, dtype, cuda, zero_block=zero_block)
    ins = [x.clone() for x in (w, g, q, s, lr)]
    w2, q2, s2 = _q8_check(w, g, q, s, lr)
    if zero_block:
        assert float(s2[0]) == 1.0 and not q2[:8].any()
    else:
        assert int(q2.abs().max()) == 127
    # its only outputs are w', q' and scale': the inputs are untouched
    for a, b in zip((w, g, q, s, lr), ins):
        assert torch.equal(a, b)


@pytest.mark.parametrize("row", range(8))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_apply_flat_q8_absmax_in_each_row_of_a_block(cuda, row, dtype):
    """The block's largest |m'| sits in one row, and so in one CTA of the
    block's cluster, in a block that is not the first: every other CTA
    must take it from that peer, so scale' and all the block's codes
    match the plain version's. A word sent to the wrong rank, or read
    before it arrived, shows here."""
    w, g, q, s, lr = _q8_buffers(32, dtype, cuda, seed=5)
    lr[2] = 0.05
    col = (37 * row + 5) % 512
    g[16 + row, col] = 40.0 if row % 2 else -40.0
    w2, q2, s2 = _q8_check(w, g, q, s, lr)
    assert abs(int(q2[16 + row, col])) == 127
    assert int(q2[16:24].abs().max()) == 127
    assert int((q2[16:24].abs() == 127).sum()) == 1
    assert float(s2[2]) > float(s2[[1, 3]].max())


def test_apply_flat_q8_propagates_nan(cuda):
    """A block holding a NaN comes out with a NaN scale, as the plain
    version's does (fmaxf would have dropped it), and code 0 there; with
    the NaN in a block's second row and in another block's last row."""
    w, g, q, s, lr = _q8_buffers(32, torch.float32, cuda)
    g[9, 17] = float("nan")
    g[31, 500] = float("nan")
    w2, q2, s2 = lk.apply_flat_q8(w, g, q, s, lr, momentum=0.9,
                                  weight_decay=1e-4)
    pw, pq, ps = lk.apply_flat_q8_plain(w, g, q, s, lr, momentum=0.9,
                                        weight_decay=1e-4)
    torch.cuda.synchronize()
    for blk in (1, 3):
        assert torch.isnan(s2[blk, 0]) and torch.isnan(ps[blk, 0])
    assert torch.isfinite(s2[[0, 2]]).all()
    assert q2[9, 17].item() == 0 and q2[31, 500].item() == 0
    assert torch.equal(q2, pq)
    assert torch.equal(s2[[0, 2]], ps[[0, 2]])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_apply_flat_q8_repeat_calls_are_bit_identical(cuda, dtype):
    """The absmax is a max over bit patterns, exchanged without atomics:
    two calls on the same inputs give the same bits."""
    w, g, q, s, lr = _q8_buffers(65544, dtype, cuda, seed=6)
    kw = dict(momentum=0.9, weight_decay=1e-4)
    first = lk.apply_flat_q8(w, g, q, s, lr, **kw)
    second = lk.apply_flat_q8(w, g, q, s, lr, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


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


def test_pipeline_stats_and_peak_bytes_on_the_card(cuda):
    """The statistics hook on the card matches the CPU's table on the same
    init and batch (f32, the conv sums' order apart: rtol 1e-5), and
    ``peak_bytes`` comes from the second step, makes no extra launch and
    is the same for a fresh pipeline."""
    from repro_torch.core import grad_stats
    cfg = get_config("lenet-mnist")
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(1)
    batch = {"x": torch.rand(64, 28, 28, 1, generator=gen),
             "y": torch.randint(0, 10, (64,), generator=gen)}
    stats, peaks = {}, []
    for dev in ("cpu", cuda, cuda):
        pipe = TrainPipeline(model, lars(0.05), cfg,
                             stats_fn=grad_stats.stats_hook(eta=0.02))
        state = pipe.init_state(torch.Generator().manual_seed(0), dev)
        b = {k: v.to(dev) for k, v in batch.items()}
        lk.reset_launch_counts()
        for _ in range(2):
            state, metrics = pipe(state, b)
        stats[str(dev)] = grad_stats.summarize(metrics["stats"])
        if dev == "cpu":
            assert pipe.peak_bytes(b) is None
            continue
        torch.cuda.synchronize()
        assert lk.LAUNCHES == {"norms_flat": 2, "apply_flat": 2,
                               "apply_flat_q8": 0}
        peaks.append(pipe.peak_bytes(b))
        assert lk.LAUNCHES["norms_flat"] == 2
    assert isinstance(peaks[0], int) and peaks[0] > 0
    assert peaks[0] == peaks[1]
    for key, want in stats["cpu"].items():
        assert abs(stats["cuda"][key] - want) <= 1e-5 * abs(want), key


# ------------------------------------------------------------ flash_decode
#
# The kernel sums the softmax and the value products in another order
# than its plain version (splits of the keys, warps' tiles of 4-16 keys,
# an online rescale per tile, base-2 exponentials of a query scaled by
# log2 e, a fixed-order merge of warps and splits): in f32 the outputs agree to a few ulp of values of order one,
# held at atol 1e-5 / rtol 1e-5. In bf16 both round the same f32 result
# to bf16 at the end, so an output may differ by one bf16 ulp: rtol
# 2^-7 (one ulp relative), atol 1e-6.

from repro_torch.kernels import flash_decode as fdk  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.treepath import tree_map  # noqa: E402

FD_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
          torch.bfloat16: dict(rtol=2 ** -7, atol=1e-6)}
# (B, S, Hkv, G, D): smollm's G = 3 at D 64, qwen3's G = 5 at D 128,
# MQA with G = 8, G = 1, the reduced smollm's D = 72, zamba2's shared
# block: MHA (G = 1) at D 112, one row of length 0; paligemma's MQA at
# G = 8, D 256, and D 136 in the 256 instance; in bf16 past D 128 the
# wide kernel: paligemma's serve shape and decode_32k's length
# (chip_smoke.PALI_FD), and D 136 and 200
FD_SHAPES = [(4, 1000, 3, 3, 64), (2, 700, 8, 5, 128), (3, 129, 1, 8, 64),
             (2, 300, 2, 1, 128), (2, 50, 1, 4, 72), (3, 600, 4, 1, 112),
             (4, 448, 1, 8, 256), (3, 130, 1, 8, 136), (32, 448, 1, 8, 256),
             (8, 32768, 1, 8, 256), (6, 1000, 1, 8, 136),
             (5, 700, 2, 5, 200)]


def _fd_inputs(B, S, Hkv, G, D, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, Hkv, G, D, generator=g)
    k = torch.randn(B, S, Hkv, D, generator=g)
    v = torch.randn(B, S, Hkv, D, generator=g)
    # lengths 0, 1, S and past S among the rows, the rest drawn
    lengths = torch.randint(1, S + 1, (B,), generator=g, dtype=torch.int32)
    lengths[0] = S
    lengths[-1] = 0 if B > 2 else S + 7
    if B > 3:
        lengths[1] = 1
    if B > 4:
        lengths[2] = S + 7
    return (q.to(device, dtype), k.to(device, dtype), v.to(device, dtype),
            lengths.to(device))


@pytest.mark.parametrize("shape", FD_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_matches_plain(cuda, shape, dtype):
    q, k, v, lengths = _fd_inputs(*shape, dtype, cuda)
    scale = shape[-1] ** -0.5
    before = fdk.LAUNCHES["flash_decode"]
    got = fdk.flash_decode(q, k, v, lengths, scale=scale)
    torch.cuda.synchronize()
    assert fdk.LAUNCHES["flash_decode"] == before + 1
    want = fdk.flash_decode_plain(q, k, v, lengths, scale=scale)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **FD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_zero_length_rows_give_zeros(cuda, dtype):
    q, k, v, _ = _fd_inputs(3, 256, 2, 4, 64, dtype, cuda)
    lengths = torch.tensor([0, 5, 0], dtype=torch.int32, device=cuda)
    v[1] = 1.0
    out = fdk.flash_decode(q, k, v, lengths, scale=0.125)
    torch.cuda.synchronize()
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert torch.equal(out[2], torch.zeros_like(out[2]))
    # a row attending to identical values gives that value
    torch.testing.assert_close(out[1].float(), torch.ones_like(out[1].float()),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bad", ["misaligned", "strided", "dtype", "lengths",
                                 "group", "head_dim", "device", "wide"])
def test_flash_decode_refuses_what_the_kernel_does_not_take(cuda, bad):
    q, k, v, lengths = _fd_inputs(2, 64, 2, 3, 64, torch.bfloat16, cuda)
    if bad == "misaligned":
        flat = torch.zeros(k.numel() + 1, dtype=k.dtype, device=cuda)
        k = flat[1:].view(k.shape)
    elif bad == "strided":
        k = torch.cat([k, k], dim=3)[..., ::2]
    elif bad == "dtype":
        k = k.half()
    elif bad == "lengths":
        lengths = lengths.long()
    elif bad == "group":
        q = torch.zeros(2, 2, 9, 64, dtype=q.dtype, device=cuda)
    elif bad == "head_dim":
        q, k, v = (x[..., :60].contiguous() for x in (q, k, v))
    elif bad == "wide":                 # past the kernel's D 256
        q, k, v = (torch.cat([x] * 5, dim=3)[..., :264].contiguous()
                   for x in (q, k, v))
    else:
        lengths = lengths.cpu()
    before = fdk.LAUNCHES["flash_decode"]
    with pytest.raises(ValueError):
        fdk.flash_decode(q, k, v, lengths, scale=0.125)
    assert fdk.LAUNCHES["flash_decode"] == before


def _fd_check(q, k, v, lengths, scale=None):
    """One call: exactly one launch, within FD_TOL of the plain version."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    before = fdk.LAUNCHES["flash_decode"]
    got = fdk.flash_decode(q, k, v, lengths, scale=scale)
    torch.cuda.synchronize()
    assert fdk.LAUNCHES["flash_decode"] == before + 1
    want = fdk.flash_decode_plain(q, k, v, lengths, scale=scale)
    torch.testing.assert_close(got.float(), want.float(), **FD_TOL[q.dtype])
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 136, 256])
def test_flash_decode_split_boundaries(cuda, dtype, D):
    """Lengths at every split boundary and one either side of it, with
    many splits per (b, kv head), and at the 16-key tiles of a split."""
    B, S, Hkv, G = 16, 2048, 1, 3
    q, k, v, _ = _fd_inputs(B, S, Hkv, G, D, dtype, cuda, seed=4)
    plan = fdk.plan(q, k)
    assert plan.splits >= 4
    kps = plan.keys_per_split
    lens = [kps - 1, kps, kps + 1, 2 * kps - 1, 2 * kps, 2 * kps + 1,
            S - 1, S, S + 7, 1, 0, 3 * kps, 15, 16, 17, kps + 16]
    _fd_check(q, k, v, torch.tensor(lens, dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_all_splits_empty_gives_exact_zeros(cuda, dtype):
    q, k, v, _ = _fd_inputs(3, 4096, 2, 5, 128, dtype, cuda, seed=5)
    assert fdk.plan(q, k).splits > 1
    lengths = torch.zeros(3, dtype=torch.int32, device=cuda)
    out = _fd_check(q, k, v, lengths)
    assert torch.equal(out, torch.zeros_like(out))


def test_flash_decode_many_pairs_few_splits(cuda):
    """B * Hkv >= 2 * the SM count: few splits (or one) per pair."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    B, Hkv = -(-2 * sms // 8), 8
    q, k, v, lengths = _fd_inputs(B, 1024, Hkv, 5, 128, torch.bfloat16,
                                  cuda, seed=6)
    assert fdk.plan(q, k).splits <= 4
    _fd_check(q, k, v, lengths)
    q, k, v, lengths = _fd_inputs(B * 4, 512, Hkv, 3, 64, torch.bfloat16,
                                  cuda, seed=7)
    assert fdk.plan(q, k).splits == 1
    _fd_check(q, k, v, lengths)


@pytest.mark.parametrize("shape", [(4, 8192, 2, 5, 128), (4, 8192, 1, 8, 256)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_repeat_calls_are_bit_identical(cuda, dtype, shape):
    """The splits merge in a fixed order with no float atomics."""
    q, k, v, lengths = _fd_inputs(*shape, dtype, cuda, seed=8)
    assert fdk.plan(q, k).splits > 1
    first = _fd_check(q, k, v, lengths)
    for _ in range(3):
        assert torch.equal(fdk.flash_decode(q, k, v, lengths,
                                            scale=shape[-1] ** -0.5), first)


def test_flash_decode_tickets_reused_across_shapes_and_dtypes(cuda):
    """The cached tickets serve calls of other shapes and dtypes, and
    every call leaves them zero."""
    shapes = [(4, 8192, 2, 5, 128), (32, 4096, 3, 3, 64), (2, 700, 8, 5, 128),
              (3, 129, 1, 8, 64), (2, 50, 1, 4, 72), (4, 8192, 2, 5, 128)]
    for i, shape in enumerate(shapes):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, lengths = _fd_inputs(*shape, dtype, cuda, seed=10 + i)
            _fd_check(q, k, v, lengths)
            assert not bool(fdk._TICKETS[q.device].any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_decode_nan_past_the_length_never_reaches_the_output(
        cuda, dtype, D):
    """K and V rows past each length filled with NaN give the same output
    bits as finite rows: every instance's copies zero-fill the V rows
    past the length and the scores there are -1e30 by index, so no NaN
    reaches the value product (0 x NaN would be NaN). Lengths end inside
    a tile, on a tile and on a split boundary."""
    B, S, Hkv, G = 8, 1024, 1, 8
    q, k, v, _ = _fd_inputs(B, S, Hkv, G, D, dtype, cuda, seed=14)
    kps = fdk.plan(q, k).keys_per_split
    lens = torch.tensor([0, 1, 17, 16, kps, kps + 5, S - 3, S],
                        dtype=torch.int32, device=cuda)
    clean = _fd_check(q, k, v, lens)
    past = (torch.arange(S, device=cuda)[None, :]
            >= lens[:, None].long())[:, :, None, None]
    nan = torch.tensor(float("nan"), dtype=dtype, device=cuda)
    kp, vp = torch.where(past, nan, k), torch.where(past, nan, v)
    assert torch.equal(fdk.flash_decode(q, kp, vp, lens, scale=D ** -0.5),
                       clean)


def _lm(device, **changes):
    import dataclasses
    cfg = dataclasses.replace(get_config("smollm-135m").reduced(), **changes)
    model = build_model(cfg)
    return cfg, model, model.init(torch.Generator().manual_seed(1), device)


def test_decode_tick_is_one_flash_decode_launch_per_layer(cuda):
    """A decode tick launches the kernel once per layer; admission
    (prefill) launches it never."""
    cfg, model, params = _lm(cuda, num_layers=3)
    engine = ServeEngine(model, params, cfg, slots=4, capacity=64)
    rng = np.random.default_rng(0)
    for n in (5, 9, 17):
        engine.submit(rng.integers(0, cfg.vocab_size, (n,)), 6)
    fdk.reset_launch_counts()
    engine._admit_pending()
    torch.cuda.synchronize()
    assert fdk.LAUNCHES["flash_decode"] == 0
    while engine.scheduler.has_work():
        engine.step()
    assert engine.stats["decode_steps"] == 5
    assert fdk.LAUNCHES["flash_decode"] == 5 * cfg.num_layers
    assert engine.logits_finite


def test_decode_step_on_the_card_matches_the_cpu(cuda):
    """Reduced smollm in f32 (head_dim 64, G = 3): prefill then 8
    teacher-forced decode steps, card (kernel) vs CPU (plain version).
    Only f32 summation orders differ: logits within 1e-4."""
    cfg, model, params = _lm("cpu", num_heads=9, num_kv_heads=3,
                             head_dim=64)
    card = tree_map(lambda t: t.to(cuda), params)
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 12)))
    lens = torch.tensor([12, 4, 9], dtype=torch.int32)
    feed = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 3, 1)))
    out = {}
    for dev, p in (("cpu", params), ("cuda", card)):
        _, cache = model.prefill(p, toks.to(dev), cache_len=32,
                                 lengths=lens.to(dev))
        out[dev] = [model.decode_step(p, cache, t.to(dev))[0].cpu()
                    for t in feed]
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


# ------------------------------------------------------- the LM training path

from repro_torch.core import lamb  # noqa: E402
from repro_torch.data import ShardedLoader, TokenTaskConfig, token_batches  # noqa: E402
from repro_torch.train.step import value_and_grad  # noqa: E402
from repro_torch.treepath import tree_leaves  # noqa: E402

SMOLLM_ROWS = 263144          # smollm-135m's packed (rows, 512) buffer


@pytest.mark.parametrize("prefetch", [0, 2])
def test_sharded_loader_places_through_pinned_memory(cuda, prefetch):
    """Each batch arrives on the card equal to its host array; the pinned
    host buffers stay held until their copies' events complete, and
    close() leaves none in flight."""
    host = [{"tokens": np.arange(4096, dtype=np.int32).reshape(4, 1024) + i,
             "x": np.full((8, 3), i, np.float32)} for i in range(6)]
    loader = ShardedLoader(iter(host), cuda, prefetch=prefetch)
    got = []
    for _ in range(6):
        b = next(loader)
        assert all(t.is_cuda for t in b.values())
        for event, pinned in loader._inflight:
            assert all(p.is_pinned() for p in pinned.values())
        got.append({k: v.cpu().numpy() for k, v in b.items()})
    with pytest.raises(StopIteration):
        next(loader)
    loader.close()
    assert not loader._inflight
    for a, b in zip(got, host):
        assert all(np.array_equal(a[k], b[k]) for k in b)


def test_lm_steps_launch_lars_kernels_and_no_lamb_kernel(cuda):
    """Reduced smollm on the card: a LARS step is one norms_flat and one
    apply_flat launch, a LAMB step none; losses finite; remat on and off
    give identical gradients on the card too."""
    import dataclasses
    cfg = get_config("smollm-135m").reduced()
    model = build_model(cfg)
    toks = next(token_batches(TokenTaskConfig(vocab_size=cfg.vocab_size),
                              batch=4, seq_len=64))
    batch = {"tokens": torch.from_numpy(toks).to(cuda)}
    for opt, want in ((lars(0.01), 1), (lamb(0.01), 0)):
        pipe = TrainPipeline(model, opt, cfg)
        state = pipe.init_state(torch.Generator().manual_seed(0), cuda)
        lk.reset_launch_counts()
        for _ in range(2):
            state, metrics = pipe(state, batch)
        torch.cuda.synchronize()
        assert lk.LAUNCHES == {"norms_flat": 2 * want,
                               "apply_flat": 2 * want, "apply_flat_q8": 0}
        assert torch.isfinite(metrics["loss"])
    grads = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        _, g, _ = value_and_grad(build_model(c), c, state.params, batch)
        grads[remat] = tree_leaves(g)
    assert all(torch.equal(a, b) for a, b in zip(grads[True], grads[False]))


@pytest.mark.parametrize("kernel", ["norms_flat", "apply_flat",
                                    "apply_flat_q8"])
def test_lars_kernels_at_smollm_rows_match_plain(cuda, kernel):
    """At smollm-135m's (263144, 512) — 131,572 to 263,144 CTAs: no grid
    dimension or index overflows — each kernel agrees with its plain
    version (norms rtol 1e-5, the applies bit for bit)."""
    w, g, m, lr = _buffers(SMOLLM_ROWS, torch.float32, cuda, seed=3)
    if kernel == "norms_flat":
        got = lk.norms_flat(w, g, block_rows=1)
        want = lk.norms_flat_plain(w, g, block_rows=1)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=NORMS_RTOL, atol=0)
        return
    kw = dict(momentum=0.9, weight_decay=1e-4)
    if kernel == "apply_flat":
        got = lk.apply_flat(w, g, m, lr, **kw)
        want = lk.apply_flat_plain(w, g, m, lr, **kw)
    else:
        q, s = packing.quantize_blocks_q8(m.view(SMOLLM_ROWS // 8, -1))
        q = q.view(SMOLLM_ROWS, 512)
        got = lk.apply_flat_q8(w, g, q, s, lr, **kw)
        want = lk.apply_flat_q8_plain(w, g, q, s, lr, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ------------------------------------------------ the memory-lean LM path

from repro_torch.models.flash_attn import (  # noqa: E402
    _mm_f32, flash_attention)

# flash_attention, card against CPU: f32 differs only in the order of f32
# sums (cuBLAS against the CPU's products); bf16 operands reach cuBLAS as
# bf16 (products exact in f32, f32 accumulation) and the bf16 outputs and
# gradients round the f32 results, which may then fall one bf16 ulp
# apart (2^-7 relative; atol for entries near zero, at 2^-7 of the
# largest entry's magnitude scale 1)
FLASH_CARD_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
                  torch.bfloat16: dict(rtol=2 ** -7, atol=2 ** -7)}


@pytest.mark.parametrize("K", [64, 4096])
def test_out_dtype_bf16_products_accumulate_in_f32(cuda, K):
    """The score products: bf16 operands with an f32 result through
    cuBLAS. Every product of two bf16 values is exact in f32, so with f32
    accumulation the result is the f32 product of their f32 values up to
    summation order: within 1e-5 of the largest entry (bf16 accumulation
    would be off by ~2^-8 of it)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(8, 256, K, generator=g, device=cuda).to(torch.bfloat16)
    b = torch.randn(8, K, 192, generator=g, device=cuda).to(torch.bfloat16)
    got = _mm_f32(a, b)
    want = torch.bmm(a.float(), b.float())
    assert got.dtype == torch.float32
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [dict(), dict(window=64, kv_len=200),
                                  dict(softcap=30.0, prefix_len=48)])
def test_flash_attention_on_the_card_matches_the_cpu(cuda, dtype, case):
    """Values and gradients of flash_attention (GQA G = 4, a padded last
    KV chunk) on the card against the CPU, the same inputs."""
    gen = torch.Generator().manual_seed(1)
    B, S, H, Hkv, D = 2, 250, 8, 2, 64
    q, k, v = (torch.randn(B, S, h, D, generator=gen)
               for h in (H, Hkv, Hkv))
    do = torch.randn(B, S, H, D, generator=gen)
    kw = dict(causal=True, window=0, prefix_len=None, softcap=0.0,
              kv_len=None)
    kw.update(case)
    cfgt = (kw["causal"], kw["window"], kw["prefix_len"], D ** -0.5,
            kw["softcap"], kw["kv_len"])
    out = {}
    for dev in ("cpu", "cuda"):
        xs = [x.to(dev, dtype).requires_grad_() for x in (q, k, v)]
        o = flash_attention(*xs, torch.arange(S, device=dev), cfgt, 64)
        grads = torch.autograd.grad(o, xs, do.to(dev, dtype))
        out[dev] = [t.detach().float().cpu() for t in (o,) + grads]
    tol = FLASH_CARD_TOL[dtype]
    for name, a, b in zip(("out", "dq", "dk", "dv"), out["cuda"],
                          out["cpu"]):
        scale = b.abs().max().item()
        torch.testing.assert_close(a, b, rtol=tol["rtol"],
                                   atol=tol["atol"] * scale, msg=name)


def test_lean_lm_gradients_on_the_card_match_the_cpu(cuda):
    """Reduced qwen3 in f32 with flash_vjp, attn_q_chunk, loss_chunk and
    remat_block all set: the loss and every gradient leaf on the card
    within 1e-5 (of the leaf's largest entry) of the CPU's, and equal to
    the stock path's on the card within the same."""
    import dataclasses
    lean = dict(flash_vjp=True, attn_q_chunk=32, loss_chunk=16,
                remat_block=2)
    cfg = dataclasses.replace(get_config("qwen3-14b").reduced(), **lean)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 64)))
    runs = {}
    for tag, c, dev in (("cpu", cfg, "cpu"), ("cuda", cfg, "cuda"),
                        ("stock", get_config("qwen3-14b").reduced(),
                         "cuda")):
        p = tree_map(lambda t: t.to(dev), params)
        loss, g, _ = value_and_grad(build_model(c), c, p,
                                    {"tokens": toks.to(dev)})
        runs[tag] = [loss.cpu()] + [x.cpu() for x in tree_leaves(g)]
    for other in ("cuda", "stock"):
        for a, b in zip(runs[other], runs["cpu"]):
            assert (a - b).abs().max() <= 1e-5 * max(b.abs().max(), 1e-30)


# ------------------------------------------------------------ the MoE family

from repro_torch.models import moe  # noqa: E402
from repro_torch.train import train_state_from_params  # noqa: E402

# reduced granite that drops slots (the reduced config routes top-4 of 4)
GRANITE_DROP = dict(num_experts=8, experts_per_token=2, capacity_factor=0.5)
# card against CPU: only the products' summation orders differ (f32), or
# their bf16 roundings, as tests/test_torch_moe.py bounds the CPU port
# against the reference (one or two bf16 ulps)
MOE_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
           torch.bfloat16: dict(rtol=2 ** -5, atol=2 ** -5)}


def _granite(**changes):
    import dataclasses
    return dataclasses.replace(
        get_config("granite-moe-3b-a800m").reduced(), **GRANITE_DROP,
        **changes)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups", [1, 2])
def test_moe_block_on_the_card_matches_the_cpu(cuda, dtype, groups):
    """The MoE block of reduced granite, dropping slots: the same share of
    dropped slots on the card and the CPU, outputs and aux loss within
    MOE_TOL and 1e-6, f32 gradients within 1e-5 of each leaf's largest
    entry; the card's forward is the same bits on every run (the combine
    gathers each token's slots, no atomic add)."""
    cfg = _granite(moe_groups=groups, num_shared_experts=1)
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, cfg.d_model,
                     dtype, "cpu")
    x = torch.randn(4, 64, cfg.d_model,
                    generator=torch.Generator().manual_seed(1)).to(dtype)
    runs = {}
    for dev in ("cpu", "cuda", "cuda"):
        pd = tree_map(lambda t: t.detach().to(dev).requires_grad_(
            dtype == torch.float32), p)
        xd = x.detach().to(dev).requires_grad_(dtype == torch.float32)
        out, aux = moe.moe_block(cfg, pd, xd)
        grads = []
        if dtype == torch.float32:
            grads = torch.autograd.grad(out.square().sum() + aux["aux_loss"],
                                        [xd] + tree_leaves(pd))
        run = [out.detach().cpu(), aux["aux_loss"].detach().cpu(),
               aux["dropped_frac"].cpu()] + [g.cpu() for g in grads]
        if dev in runs:
            assert torch.equal(run[0], runs[dev][0])
        runs[dev] = run
    (out, aux, drop), (cout, caux, cdrop) = runs["cuda"][:3], runs["cpu"][:3]
    assert float(drop) == float(cdrop) > 0
    torch.testing.assert_close(out, cout, **MOE_TOL[dtype])
    torch.testing.assert_close(aux, caux, rtol=1e-6, atol=0)
    for a, b in zip(runs["cuda"][3:], runs["cpu"][3:]):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


def test_granite_lars_step_on_the_card_matches_the_cpu(cuda):
    """One LARS step of reduced granite (dropping slots, f32): one
    norms_flat and one apply_flat launch on the card; the loss, the aux
    loss and the updated weights within 1e-5 of the CPU's."""
    cfg = _granite()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    toks = next(token_batches(TokenTaskConfig(vocab_size=cfg.vocab_size),
                              batch=8, seq_len=64))
    out = {}
    for dev in ("cpu", "cuda"):
        opt = lars(0.05, momentum=0.9, weight_decay=1e-4)
        state = train_state_from_params(
            model, opt, tree_map(lambda t: t.to(dev), params))
        lk.reset_launch_counts()
        state, metrics = TrainPipeline(model, opt, cfg)(
            state, {"tokens": torch.from_numpy(toks).to(dev)})
        out[dev] = (metrics, tree_leaves(state.params))
        if dev == "cuda":
            torch.cuda.synchronize()
            assert lk.LAUNCHES == {"norms_flat": 1, "apply_flat": 1,
                                   "apply_flat_q8": 0}
    (m, w), (cm, cw) = out["cuda"], out["cpu"]
    for key in ("loss", "aux_loss"):
        torch.testing.assert_close(m[key].cpu(), cm[key], rtol=1e-5, atol=0)
    assert float(cm["aux_loss"]) > 0
    for a, b in zip(w, cw):
        assert (a.cpu() - b).abs().max() <= 1e-5 * b.abs().max()


# ------------------------------------------- MLA, sliding windows, softcap

from repro_torch.models import attention as A  # noqa: E402


def _deepseek(**changes):
    """Reduced deepseek-v2-236b in f32 with a nonzero query rank (the
    full width's q_down / q_norm / q_up path)."""
    import dataclasses
    return dataclasses.replace(get_config("deepseek-v2-236b").reduced(),
                               q_lora_rank=48, **changes)


def test_mla_decode_on_the_card_matches_the_cpu(cuda):
    """Reduced deepseek: prefill into the latent cache, then 8
    teacher-forced decode steps (one slot past capacity at the end), card
    against CPU: logits within 1e-4 (f32 products, TF32 off), the caches
    within 1e-5, and no flash_decode launch (the absorbed decode is torch
    ops)."""
    cfg = _deepseek()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(2), "cpu")
    card = tree_map(lambda t: t.to(cuda), params)
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 12)))
    lens = torch.tensor([12, 4, 9], dtype=torch.int32)
    feed = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 3, 1)))
    out = {}
    for dev, p in (("cpu", params), ("cuda", card)):
        fdk.reset_launch_counts()
        _, cache = model.prefill(p, toks.to(dev), cache_len=16,
                                 lengths=lens.to(dev))
        logits = [model.decode_step(p, cache, t.to(dev))[0].cpu()
                  for t in feed]
        out[dev] = (logits, {k: v.cpu() for k, v in cache.items()})
        assert fdk.LAUNCHES["flash_decode"] == 0
    assert out["cuda"][1]["pos"].tolist() == [20, 12, 17]
    for a, b in zip(out["cuda"][0], out["cpu"][0]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    for name in ("ckv", "krope"):
        torch.testing.assert_close(out["cuda"][1][name], out["cpu"][1][name],
                                   rtol=1e-5, atol=1e-5)


def test_mla_lars_step_on_the_card_matches_the_cpu(cuda):
    """One LARS step of reduced deepseek (f32): one norms_flat and one
    apply_flat launch on the card; the loss and the updated weights
    within 1e-5 of the CPU's."""
    cfg = _deepseek()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    toks = next(token_batches(TokenTaskConfig(vocab_size=cfg.vocab_size),
                              batch=4, seq_len=32))
    out = {}
    for dev in ("cpu", "cuda"):
        opt = lars(0.05, momentum=0.9, weight_decay=1e-4)
        state = train_state_from_params(
            model, opt, tree_map(lambda t: t.to(dev), params))
        lk.reset_launch_counts()
        state, metrics = TrainPipeline(model, opt, cfg)(
            state, {"tokens": torch.from_numpy(toks).to(dev)})
        out[dev] = (metrics, tree_leaves(state.params))
        if dev == "cuda":
            torch.cuda.synchronize()
            assert lk.LAUNCHES == {"norms_flat": 1, "apply_flat": 1,
                                   "apply_flat_q8": 0}
    (m, w), (cm, cw) = out["cuda"], out["cpu"]
    torch.testing.assert_close(m["loss"].cpu(), cm["loss"], rtol=1e-5,
                               atol=0)
    for a, b in zip(w, cw):
        assert (a.cpu() - b).abs().max() <= 1e-5 * b.abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [dict(window=48), dict(softcap=30.0),
                                  dict(window=48, softcap=20.0, scale=0.1)])
def test_windowed_stock_core_matches_flash_attention_on_the_card(
        cuda, dtype, case):
    """The stock attention_core with a window, the softcap and a custom
    scale (autograd through f32 scores) against flash_attention (the
    flash_vjp path: bf16 tensor-core score products, recomputed in the
    backward pass) on the card, values and gradients; D 192 and Dv 128,
    MLA's shapes, and query blocks whose first KV chunks the window
    masks wholly."""
    gen = torch.Generator().manual_seed(4)
    B, S, H, D, Dv = 2, 256, 4, 192, 128
    q, k = (torch.randn(B, S, H, D, generator=gen) for _ in range(2))
    v = torch.randn(B, S, H, Dv, generator=gen)
    do = torch.randn(B, S, H, Dv, generator=gen)
    out = {}
    for fv in (False, True):
        xs = [x.to(cuda, dtype).requires_grad_() for x in (q, k, v)]
        o = A.attention_core(*xs, q_positions=torch.arange(S, device=cuda),
                             kv_chunk=32, q_chunk=64, flash_vjp=fv, **case)
        grads = torch.autograd.grad(o, xs, do.to(cuda, dtype))
        out[fv] = [t.detach().float().cpu() for t in (o,) + grads]
    tol = FLASH_CARD_TOL[dtype]
    for name, a, b in zip(("out", "dq", "dk", "dv"), out[True], out[False]):
        scale = b.abs().max().item()
        torch.testing.assert_close(a, b, rtol=tol["rtol"],
                                   atol=tol["atol"] * scale, msg=name)


# --------------------------------------------------- the SSM and hybrid LMs

SSM_ARCHS = ("falcon-mamba-7b", "zamba2-7b")


def _ssm(arch):
    """Reduced falcon-mamba or zamba2 (3 layers: the shared block runs
    after layers 0 and 2) in f32."""
    import dataclasses
    return dataclasses.replace(get_config(arch).reduced(), num_layers=3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_gives_the_same_weights_on_the_card_and_the_cpu(cuda, dtype):
    """One seed, one set of weights: the normals are drawn on the host
    and cast on the device, and the card's cast to bf16 rounds as the
    host's does (reduced zamba2: uniforms, normals, the shared block)."""
    import dataclasses
    cfg = dataclasses.replace(_ssm("zamba2-7b"), dtype=dtype)
    model = build_model(cfg)
    cpu, card = (model.init(torch.Generator().manual_seed(4), dev)
                 for dev in ("cpu", cuda))
    for a, b in zip(tree_leaves(cpu), tree_leaves(card)):
        assert a.dtype == b.dtype and torch.equal(a, b.cpu())


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_lars_step_on_the_card_matches_the_cpu(cuda, arch):
    """One LARS step of a reduced SSM or hybrid LM (f32, TF32 off): one
    norms_flat and one apply_flat launch on the card; the loss and the
    updated weights within 1e-5 of the CPU's (summation orders differ:
    cuBLAS, and the scan's and the SSD's sums)."""
    cfg = _ssm(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    toks = next(token_batches(TokenTaskConfig(vocab_size=cfg.vocab_size),
                              batch=4, seq_len=80))
    out = {}
    for dev in ("cpu", "cuda"):
        opt = lars(0.05, momentum=0.9, weight_decay=1e-4)
        state = train_state_from_params(
            model, opt, tree_map(lambda t: t.to(dev), params))
        lk.reset_launch_counts()
        state, metrics = TrainPipeline(model, opt, cfg)(
            state, {"tokens": torch.from_numpy(toks).to(dev)})
        out[dev] = (metrics, tree_leaves(state.params))
        if dev == "cuda":
            torch.cuda.synchronize()
            assert lk.LAUNCHES == {"norms_flat": 1, "apply_flat": 1,
                                   "apply_flat_q8": 0}
    (m, w), (cm, cw) = out["cuda"], out["cpu"]
    torch.testing.assert_close(m["loss"].cpu(), cm["loss"], rtol=1e-5,
                               atol=0)
    for a, b in zip(w, cw):
        assert (a.cpu() - b).abs().max() <= 1e-5 * b.abs().max()


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_decode_on_the_card_matches_the_cpu(cuda, arch):
    """A reduced SSM or hybrid LM: a lengths-masked prefill, then 8
    teacher-forced decode steps, card against CPU: logits within 1e-4,
    the recurrent states and K/V within 1e-5; flash_decode launches once
    per application of the hybrid's shared block a step (2 here), never
    for Mamba layers or in prefill."""
    cfg = _ssm(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(2), "cpu")
    card = tree_map(lambda t: t.to(cuda), params)
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 70)))
    lens = torch.tensor([70, 4, 33], dtype=torch.int32)
    feed = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 3, 1)))
    out = {}
    for dev, p in (("cpu", params), ("cuda", card)):
        fdk.reset_launch_counts()
        _, cache = model.prefill(p, toks.to(dev), cache_len=96,
                                 lengths=lens.to(dev))
        assert fdk.LAUNCHES["flash_decode"] == 0
        logits = [model.decode_step(p, cache, t.to(dev))[0].cpu()
                  for t in feed]
        out[dev] = (logits, {k: v.cpu() for k, v in cache.items()})
        want = 8 * model.flash_decode_per_step() if dev == "cuda" else 0
        assert fdk.LAUNCHES["flash_decode"] == want
    assert model.flash_decode_per_step() == (2 if arch == "zamba2-7b"
                                             else 0)
    for a, b in zip(out["cuda"][0], out["cpu"][0]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    pos = out["cpu"][1]["pos"]
    assert pos.tolist() == [78, 12, 41]
    for name, b in out["cpu"][1].items():
        a = out["cuda"][1][name]
        if name in ("attn_k", "attn_v"):
            for r, n in enumerate(pos.tolist()):
                torch.testing.assert_close(a[:, r, :n], b[:, r, :n],
                                           rtol=1e-5, atol=1e-5)
        else:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# ------------------------------------------------- the encdec and vlm families

from repro_torch.serve import DecodeEngine  # noqa: E402

# reduced whisper-base, reduced paligemma, and reduced paligemma at the
# full width's attention (8 query heads on 1 kv head of 256: the D 256
# instance of flash_decode)
FAMILY_CASES = {"whisper": ("whisper-base", {}),
                "paligemma": ("paligemma-3b", {}),
                "paligemma_d256": ("paligemma-3b", dict(
                    num_heads=8, num_kv_heads=1, head_dim=256))}


def _family(case):
    import dataclasses
    arch, changes = FAMILY_CASES[case]
    cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    return cfg, build_model(cfg)


def _family_batch(cfg, B, S, seed):
    g = torch.Generator().manual_seed(seed)
    name, n = (("frames", cfg.encoder_seq) if cfg.family == "encdec"
               else ("image_embeddings", cfg.num_image_tokens))
    return {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                                    dtype=torch.int32),
            name: torch.randn(B, n, cfg.d_model, generator=g) * 0.5}


@pytest.mark.parametrize("case", sorted(FAMILY_CASES))
def test_family_lars_step_on_the_card_matches_the_cpu(cuda, case):
    """One LARS step of reduced whisper or paligemma (f32, TF32 off): one
    norms_flat and one apply_flat launch on the card; the loss and the
    updated weights within 1e-5 of the CPU's (cuBLAS sums in another
    order)."""
    cfg, model = _family(case)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    batch = _family_batch(cfg, 4, 24, 1)
    out = {}
    for dev in ("cpu", "cuda"):
        opt = lars(0.05, momentum=0.9, weight_decay=1e-4)
        state = train_state_from_params(
            model, opt, tree_map(lambda t: t.to(dev), params))
        lk.reset_launch_counts()
        state, metrics = TrainPipeline(model, opt, cfg)(
            state, {k: v.to(dev) for k, v in batch.items()})
        out[dev] = (metrics, tree_leaves(state.params))
        if dev == "cuda":
            torch.cuda.synchronize()
            assert lk.LAUNCHES == {"norms_flat": 1, "apply_flat": 1,
                                   "apply_flat_q8": 0}
    (m, w), (cm, cw) = out["cuda"], out["cpu"]
    torch.testing.assert_close(m["loss"].cpu(), cm["loss"], rtol=1e-5,
                               atol=0)
    for a, b in zip(w, cw):
        assert (a.cpu() - b).abs().max() <= 1e-5 * b.abs().max()


@pytest.mark.parametrize("case", sorted(FAMILY_CASES))
def test_family_decode_on_the_card_matches_the_cpu(cuda, case):
    """Prefill, then 8 teacher-forced decode steps, card against CPU:
    logits within 1e-4; ``flash_decode`` launches twice a layer a step
    for whisper (self- and cross-attention), once for paligemma, never in
    prefill; ``DecodeEngine``'s greedy tokens identical on both."""
    cfg, model = _family(case)
    params = model.init(torch.Generator().manual_seed(2), "cpu")
    card = tree_map(lambda t: t.to(cuda), params)
    batch = _family_batch(cfg, 3, 10, 3)
    stub = next(k for k in batch if k != "tokens")
    feed = torch.randint(0, cfg.vocab_size, (8, 3, 1), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(4))
    cap = 32 + (cfg.num_image_tokens if cfg.family == "vlm" else 0)
    per_step = 2 * cfg.num_layers if cfg.family == "encdec" \
        else cfg.num_layers
    assert model.flash_decode_per_step() == per_step
    out, greedy = {}, {}
    for dev, p in (("cpu", params), ("cuda", card)):
        fdk.reset_launch_counts()
        _, cache = model.prefill(p, batch["tokens"].to(dev),
                                 cache_len=cap, **{stub: batch[stub].to(dev)})
        assert fdk.LAUNCHES["flash_decode"] == 0
        out[dev] = [model.decode_step(p, cache, t.to(dev))[0].cpu()
                    for t in feed]
        assert fdk.LAUNCHES["flash_decode"] == (8 * per_step if dev == "cuda"
                                                else 0)
        greedy[dev] = DecodeEngine(model, p, cfg).generate(
            batch, max_new_tokens=12, cache_len=cap).cpu()
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    assert torch.equal(greedy["cuda"], greedy["cpu"])


# the tree engine (a markerless optimizer state): one step on the card
# against the same step on the CPU. cuDNN's convolutions sum in another
# order than the CPU's (chip_smoke.py's phase 5 holds LeNet's losses to
# 1e-4 over 5 steps): the loss and params within 1e-5 after one step;
# with int8 slots a momentum code may round the other way (one code step
# of the largest scale, as tests/test_torch_checkpoint.py holds): 1e-4.
TREE_CASES = {"lars": ("lars", "f32", 1e-5), "lamb": ("lamb", "f32", 1e-5),
              "lars_int8": ("lars", "int8", 1e-4)}


@pytest.mark.parametrize("case", sorted(TREE_CASES))
def test_tree_state_step_on_the_card_matches_the_cpu(cuda, case):
    from repro_torch.core import get_optimizer
    from repro_torch.data import batch_iterator, synthetic_mnist
    from repro_torch.treepath import tree_leaves
    name, slot_dtype, atol = TREE_CASES[case]
    cfg = get_config("lenet-mnist")
    model = build_model(cfg)
    opt = get_optimizer(name, learning_rate=0.05, slot_dtype=slot_dtype)
    x, y, _, _ = synthetic_mnist(256, 8, seed=0)
    batch = next(batch_iterator(x, y, batch=64, seed=0))
    out = {}
    for dev in ("cpu", "cuda"):
        pipe = TrainPipeline(model, opt, cfg, accum_steps=2, packed=False)
        state = pipe.init_state(torch.Generator().manual_seed(0), dev)
        before = dict(lk.LAUNCHES)
        state, m = pipe(state, {k: torch.from_numpy(v).to(dev)
                                for k, v in batch.items()})
        torch.cuda.synchronize()
        assert lk.LAUNCHES == before            # no LARS kernel on a tree
        assert state.opt_state.layout is None
        out[dev] = (float(m["loss"]), [t.cpu() for t in tree_leaves(
            state.params) + tree_leaves(state.opt_state.slots)
            if t.is_floating_point()])
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5 * abs(out["cpu"][0])
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("slot_dtype", ["f32", "int8"])
def test_markerless_state_built_on_the_card_stays_there(cuda, slot_dtype):
    from repro_torch.treepath import tree_leaves, tree_map
    model = build_model(get_config("lenet-mnist"))
    params = model.init(torch.Generator().manual_seed(1), cuda)
    opt = lars(0.1, slot_dtype=slot_dtype)
    state = opt.init(params, master=True)
    assert state.layout is None
    assert all(t.is_cuda for t in tree_leaves(state.slots))
    grads = tree_map(torch.ones_like, params)
    before = dict(lk.LAUNCHES)
    new, state = opt.update(grads, state, params)
    torch.cuda.synchronize()
    assert lk.LAUNCHES == before
    assert all(t.is_cuda for t in tree_leaves(new) + tree_leaves(
        state.slots))
    with pytest.raises(ValueError, match="flat-packed"):
        lars(0.1, use_kernels=True).update(grads, state, params)


# ------------------------- the decode softcap, the masked live decode

# the capped instances at D 64, 128 and 256 (in bf16 past D 128 the wide
# kernel), with lengths 0, 1, S and past S among the rows
CAP_SHAPES = [(5, 1000, 3, 3, 64), (5, 700, 8, 5, 128), (5, 448, 1, 8, 256)]


@pytest.mark.parametrize("shape", CAP_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cap", [2.0, 30.0])
def test_flash_decode_softcap_matches_plain(cuda, shape, dtype, cap):
    """The capped kernel against its plain version (cap * tanh(s / cap)
    on each scaled score) at FD_TOL, in one launch; the zero-length row
    gives zeros; and a cap that bites moves the output away from the
    uncapped kernel's."""
    q, k, v, lengths = _fd_inputs(*shape, dtype, cuda, seed=3)
    q = q * 4                       # scores large enough for the cap
    scale = shape[-1] ** -0.5
    before = fdk.LAUNCHES["flash_decode"]
    got = fdk.flash_decode(q, k, v, lengths, scale=scale, softcap=cap)
    torch.cuda.synchronize()
    assert fdk.LAUNCHES["flash_decode"] == before + 1
    want = fdk.flash_decode_plain(q, k, v, lengths, scale=scale,
                                  softcap=cap)
    torch.testing.assert_close(got.float(), want.float(), **FD_TOL[dtype])
    zero = (lengths == 0).nonzero().flatten()
    assert len(zero) and torch.equal(got[zero], torch.zeros_like(got[zero]))
    if cap == 2.0:
        plain = fdk.flash_decode(q, k, v, lengths, scale=scale)
        assert (got.float() - plain.float()).abs().max() > 1e-2


@pytest.mark.parametrize("shape", CAP_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_softcap_zero_is_the_uncapped_kernel(cuda, shape,
                                                          dtype):
    """softcap=0 launches the uncapped instance: the same bits as a call
    without the keyword, call after call; the capped instance at a cap
    far above every score agrees with it within FD_TOL."""
    q, k, v, lengths = _fd_inputs(*shape, dtype, cuda, seed=4)
    scale = shape[-1] ** -0.5
    base = fdk.flash_decode(q, k, v, lengths, scale=scale)
    for _ in range(2):
        assert torch.equal(fdk.flash_decode(q, k, v, lengths, scale=scale,
                                            softcap=0.0), base)
    wide = fdk.flash_decode(q, k, v, lengths, scale=scale, softcap=1e4)
    torch.testing.assert_close(wide.float(), base.float(), **FD_TOL[dtype])
    with pytest.raises(ValueError, match="softcap"):
        fdk.flash_decode(q, k, v, lengths, scale=scale, softcap=-1.0)


@pytest.mark.parametrize("changes", [dict(), dict(sliding_window=8),
                                     dict(attn_logit_softcap=2.0)],
                         ids=["linear", "ring", "softcap"])
def test_masked_live_decode_leaves_masked_rows_untouched(cuda, changes):
    """``decode_step(live=...)`` on the card: the masked rows' K/V rows
    and ``pos`` keep every bit, the live rows' logits and cache equal an
    unmasked step's, and the tick is one flash_decode launch a layer."""
    cfg, model, params = _lm(cuda, **changes)
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 20))).to(
        cuda)
    lens = torch.tensor([20, 3, 11, 7], dtype=torch.int32, device=cuda)
    cache = model.init_cache(4, 32, device=cuda)
    model.prefill_at(params, cache, toks, torch.arange(4, device=cuda),
                     lengths=lens)
    ref = {k: v.clone() for k, v in cache.items()}
    live = torch.tensor([True, False, True, False], device=cuda)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 1))).to(cuda)
    fdk.reset_launch_counts()
    logits, _ = model.decode_step(params, cache, tok, live=live)
    torch.cuda.synchronize()
    assert fdk.LAUNCHES["flash_decode"] == cfg.num_layers
    want, _ = model.decode_step(params, ref, tok)
    for b in range(4):
        for name in ("k", "v"):
            if live[b]:
                assert torch.equal(cache[name][:, b], ref[name][:, b])
            else:
                assert not torch.equal(cache[name][:, b], ref[name][:, b])
        if live[b]:
            torch.testing.assert_close(logits[b], want[b])
    assert cache["pos"].tolist() == [21, 3, 12, 7]
    before = {k: v.clone() for k, v in cache.items()}
    model.decode_step(params, cache, tok,
                      live=torch.zeros(4, dtype=torch.bool, device=cuda))
    for name in cache:
        assert torch.equal(cache[name], before[name]), name


def test_chunked_engine_on_the_card_matches_the_cpu(cuda):
    """Reduced smollm in f32 with a ring (window 8) and the softcap,
    through the chunked engine with the prefix store and a forced
    preemption: the card's greedy tokens equal the CPU's, and the card
    launched flash_decode only in the decode ticks, one a layer."""
    from repro_torch.serve.scheduler import TierSLO
    out = {}
    for dev in ("cpu", "cuda"):
        cfg, model, params = _lm(dev, sliding_window=8,
                                 attn_logit_softcap=30.0)
        eng = ServeEngine(model, params, cfg, slots=2, capacity=64, seed=7,
                          prefill_chunk=5, prefix_entries=4,
                          slos={0: TierSLO(1e-6, 10.0),
                                1: TierSLO(10.0, 60.0)})
        rng = np.random.default_rng(6)
        fdk.reset_launch_counts()
        rids = [eng.submit(rng.integers(1, cfg.vocab_size, (n,)), 10,
                           tier=1) for n in (13, 21)]
        for _ in range(8):
            eng.step()
        rids.append(eng.submit(rng.integers(1, cfg.vocab_size, (6,)), 4,
                               tier=0))
        got = {f.request.rid: f.tokens.tolist() for f in eng.run([])}
        torch.cuda.synchronize()
        assert eng.stats["preemptions"] >= 1
        assert eng.stats["flash_decode_outside_ticks"] == 0
        assert fdk.LAUNCHES["flash_decode"] == (
            cfg.num_layers * eng.stats["decode_steps"] if dev == "cuda"
            else 0)
        out[dev] = [got[r] for r in rids]
    assert out["cuda"] == out["cpu"]


# ------------------------------- the log-sum-exp instances (serving mesh)

# the lse instances at the mma kernel's D 64 and 128, the wide kernel's
# D 256 (bf16) and the SIMT kernel's (f32), lengths 0, 1, S and past S
# among the rows; each against its plain version: out at FD_TOL, lse at
# 1e-5 of max(|lse|, 1), -inf exactly where a row has no key
LSE_SHAPES = [(5, 1000, 3, 3, 64), (5, 700, 8, 5, 128), (5, 448, 1, 8, 256)]


@pytest.mark.parametrize("shape", LSE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_flash_decode_lse_matches_plain(cuda, shape, dtype, cap):
    q, k, v, lengths = _fd_inputs(*shape, dtype, cuda, seed=5)
    scale = shape[-1] ** -0.5
    before = fdk.LAUNCHES["flash_decode"]
    out, lse = fdk.flash_decode(q, k, v, lengths, scale=scale, softcap=cap,
                                lse=True)
    torch.cuda.synchronize()
    assert fdk.LAUNCHES["flash_decode"] == before + 1
    want, want_lse = fdk.flash_decode_plain(q, k, v, lengths, scale=scale,
                                            softcap=cap, lse=True)
    assert out.dtype == lse.dtype == torch.float32
    assert lse.shape == q.shape[:3]
    torch.testing.assert_close(out, want, **FD_TOL[dtype])
    empty = lengths == 0
    assert torch.isneginf(lse[empty]).all() and (out[empty] == 0).all()
    rel = (lse[~empty] - want_lse[~empty]).abs() \
        / want_lse[~empty].abs().clamp(min=1.0)
    assert rel.max() <= 1e-5
    # the output without lse is the same kernel's, rounded to q's type
    plain = fdk.flash_decode(q, k, v, lengths, scale=scale, softcap=cap)
    torch.testing.assert_close(out.to(dtype).float(), plain.float(),
                               **FD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 256])
def test_three_merged_stripes_equal_the_whole_cache_kernel(cuda, dtype, D):
    """The cache cut into three stripes of its keys, the lse instance on
    each at its own valid length, merged (``merge_stripes``) and rounded
    once: the whole-cache kernel's one launch within FD_TOL (f32) or one
    bf16 ulp."""
    rows, stripes = 300, 3
    S = rows * stripes
    q, k, v, lengths = _fd_inputs(6, S, 1, 8, D, dtype, cuda, seed=6)
    lengths[1:5] = torch.tensor([rows, rows + 1, 2 * rows - 1, 1],
                                device=cuda)
    scale = D ** -0.5
    whole = fdk.flash_decode(q, k, v, lengths, scale=scale)
    outs, lses = [], []
    for r in range(stripes):
        n = torch.clamp(torch.clamp(lengths, max=S) - r * rows, 0, rows)
        o, x = fdk.flash_decode(
            q, k[:, r * rows:(r + 1) * rows].contiguous(),
            v[:, r * rows:(r + 1) * rows].contiguous(), n.to(torch.int32),
            scale=scale, lse=True)
        outs.append(o)
        lses.append(x)
    got = fdk.merge_stripes(outs, lses).to(dtype)
    torch.testing.assert_close(got.float(), whole.float(), **FD_TOL[dtype])
