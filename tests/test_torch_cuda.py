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
# MQA with G = 8, G = 1, and the reduced smollm's D = 72
FD_SHAPES = [(4, 1000, 3, 3, 64), (2, 700, 8, 5, 128), (3, 129, 1, 8, 64),
             (2, 300, 2, 1, 128), (2, 50, 1, 4, 72)]


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
                                 "group", "head_dim", "device"])
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
@pytest.mark.parametrize("D", [64, 128])
def test_flash_decode_split_boundaries(cuda, dtype, D):
    """Lengths at every split boundary and one either side of it, with
    many splits per (b, kv head)."""
    B, S, Hkv, G = 12, 2048, 1, 3
    q, k, v, _ = _fd_inputs(B, S, Hkv, G, D, dtype, cuda, seed=4)
    plan = fdk.plan(q, k)
    assert plan.splits >= 4
    kps = plan.keys_per_split
    lens = [kps - 1, kps, kps + 1, 2 * kps - 1, 2 * kps, 2 * kps + 1,
            S - 1, S, S + 7, 1, 0, 3 * kps]
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_repeat_calls_are_bit_identical(cuda, dtype):
    """The splits merge in a fixed order with no float atomics."""
    q, k, v, lengths = _fd_inputs(4, 8192, 2, 5, 128, dtype, cuda, seed=8)
    assert fdk.plan(q, k).splits > 1
    first = _fd_check(q, k, v, lengths)
    for _ in range(3):
        assert torch.equal(fdk.flash_decode(q, k, v, lengths, scale=128 ** -0.5),
                           first)


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
