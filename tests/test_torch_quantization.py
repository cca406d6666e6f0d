"""int8 optimizer slots in the port against the JAX package: the packed
quantizer, ``apply_flat_q8``'s plain version against the Pallas kernel in
interpret mode, and LARS/SGD with ``slot_dtype="int8"`` step by step.

Tolerances, each measured on the CPU:
  * ``quantize_q8`` / ``dequantize_q8``: bit-identical codes and scales
    (the same f32 division, round half to even and clip).
  * ``apply_flat_q8_plain`` vs Pallas interpret at (32, 512) and at
    LeNet's (272, 512): scales rtol 5e-7 (measured 9.1e-8 and 1.8e-7,
    one to two ulp: the absmax of a momentum that differs by an ulp
    where XLA contracts a multiply-add), codes within +-1 (a value on a
    .5 boundary may round either way; measured: no code differs at 32
    rows, one bf16 code of 139,264 at 272), weights atol 1e-6 as
    ``apply_flat``'s (w' = w - m' cancels near zero; measured 2.4e-7 in
    f32, 0 in bf16) plus one bf16 ulp for bf16 weights.
  * int8 LARS over 4 steps on LeNet: the trust ratios differ by ~1e-7
    relative (norms summed in another order), which flips a few codes by
    one step of their block's scale; measured 1-3 codes per step (of
    139,264), scales <= 2.2e-7 relative, params <= 1.04e-5 absolute.
    Held at codes +-1 in at most 0.01 % of positions, scales rtol 1e-6
    and params atol 1e-4: one code step of the largest block scale
    (6.9e-5 at step 4) moves a weight by that much.
  * int8 SGD has no trust ratio: measured bit-identical to the
    reference; held so.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro.core import packing as ref_packing
from repro.kernels import lars_kernels as ref_lk
from repro.models.lenet import LeNet as RefLeNet
import repro_torch.core as port_core
from repro_torch import bridge
from repro_torch.core import packing
from repro_torch.core.optim_base import SCALE_SUFFIX, SLOT_DTYPES
from repro_torch.kernels import lars_kernels as lk, ops
from repro_torch.treepath import tree_map

SCALE_RTOL = 5e-7
W_ATOL = 1e-6
BF16_RTOL = 2.0 ** -8
LARS_SCALE_RTOL = 1e-6
LARS_PARAM_ATOL = 1e-4
LARS_FLIP_SHARE = 1e-4


def _layouts(tree, marker):
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    return (ref_packing.build_layout(jt, marker),
            packing.build_layout(bridge.params_to_torch(tree), marker))


def _lenet():
    params = jax.tree_util.tree_map(np.asarray,
                                    RefLeNet().init(jax.random.key(1)))
    return params, jax.tree_util.tree_map(lambda _: False, params)


def _special_buffer(rows: int, seed: int) -> np.ndarray:
    """Random rows, with one all-zero block, one block of exact .5 ties at
    scale 1.0 (absmax 127 -> scale 1.0, so 0.5, 1.5, 2.5, -0.5 round half
    to even), and one block with a dominant value that saturates."""
    rng = np.random.default_rng(seed)
    buf = (rng.standard_normal((rows, 512)) * 0.1).astype(np.float32)
    buf[0:8] = 0.0
    ties = np.tile(np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5],
                            np.float32), 8 * 512 // 7 + 1)[:8 * 512]
    buf[8:16] = ties.reshape(8, 512)
    buf[8, 0] = 127.0
    buf[16:24, :] *= 1e-3
    buf[16, 7] = 5.0
    return buf


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_q8_is_the_references_bit_for_bit(seed):
    tree = {"a": np.zeros((40, 512), np.float32), "b": np.zeros((3,),
                                                                  np.float32)}
    marker = {"a": False, "b": False}
    ref_layout, layout = _layouts(tree, marker)
    assert layout.buffer_shape == ref_layout.buffer_shape == (48, 512)
    buf = _special_buffer(48, seed)
    rq, rs = ref_packing.quantize_q8(ref_layout, jnp.asarray(buf))
    q, s = packing.quantize_q8(layout, torch.from_numpy(buf))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.numpy().tobytes() == np.asarray(rq).tobytes()
    assert s.numpy().tobytes() == np.asarray(rs).tobytes()
    assert float(s[0, 0]) == 1.0 and not q[:8].any()          # zero block
    assert float(s[1, 0]) == 1.0                              # ties block
    assert q[8, 1:7].tolist() == [2, 2, -0, -2, -2, 126]      # half to even
    assert q[8, 3].item() == 0 and q[8, 0].item() == 127
    assert q[16, 7].item() == 127                             # saturates
    dq = packing.dequantize_q8(layout, q, s)
    assert dq.numpy().tobytes() == np.asarray(
        ref_packing.dequantize_q8(ref_layout, rq, rs)).tobytes()


def test_quantize_q8_clips_and_keeps_nan_visible():
    """Codes never leave +-127. A block holding a NaN keeps a NaN scale
    (the JAX package's ``jnp.where(amax > 0, ...)`` turns it into 1.0 and
    zeroes the block's momentum — a difference kept on purpose), and its
    NaN values get code 0."""
    layout = packing.build_layout({"a": torch.zeros(16, 512)},
                                  {"a": False})
    buf = torch.randn(16, 512, generator=torch.Generator().manual_seed(0))
    buf[8, 5] = float("nan")
    q, s = packing.quantize_q8(layout, buf)
    assert int(q.abs().max()) <= 127
    assert torch.isnan(s[1, 0]) and torch.isfinite(s[0, 0])
    assert q[8, 5].item() == 0
    assert torch.isnan(packing.dequantize_q8(layout, q, s)[8:16]).all()


def _q8_inputs(rows, dtype, seed=0):
    rng = np.random.default_rng(seed)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    w = np.array(jnp.asarray(rng.standard_normal((rows, 512)), jdt)
                 .astype(jnp.float32))
    g = np.array(jnp.asarray(rng.standard_normal((rows, 512)) * 0.01,
                             jdt).astype(jnp.float32))
    m = (rng.standard_normal((rows, 512)) * 0.05).astype(np.float32)
    m[:8] = 0.0                                   # a zero momentum block
    lr = (rng.random((rows // 8, 1)) * 0.1).astype(np.float32)
    lr[0] = 0.0                                   # ... that stays zero
    w[:8] = 0.0
    g[:8] = 0.0
    q, s = ref_packing.quantize_q8(
        ref_packing.build_layout({"m": jnp.zeros((rows, 512))},
                                 {"m": False}), jnp.asarray(m))
    q, s = np.asarray(q), np.asarray(s)
    j = [jnp.asarray(w, jdt), jnp.asarray(g, jdt), jnp.asarray(q),
         jnp.asarray(s), jnp.asarray(lr)]
    t = [torch.tensor(w).to(tdt), torch.tensor(g).to(tdt),
         torch.tensor(q), torch.tensor(s), torch.tensor(lr)]
    return j, t


# 272 rows is LeNet's packed buffer: 34 blocks
@pytest.mark.parametrize("rows", [32, 272])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_flat_q8_plain_matches_pallas_interpret(dtype, rows):
    j, t = _q8_inputs(rows, dtype)
    kw = dict(momentum=0.9, weight_decay=1e-4)
    rw, rq, rs = ref_lk.apply_flat_q8(*j, **kw, interpret=True)
    before = dict(lk.LAUNCHES)
    for fn in (lk.apply_flat_q8_plain, lk.apply_flat_q8):   # CPU: plain
        w2, q2, s2 = fn(*t, **kw)
        assert w2.dtype == t[0].dtype and q2.dtype == torch.int8
        assert tuple(s2.shape) == (rows // 8, 1) \
            and s2.dtype == torch.float32
        np.testing.assert_allclose(s2.numpy(), np.asarray(rs),
                                   rtol=SCALE_RTOL, atol=0)
        dq = np.abs(q2.numpy().astype(int) - np.asarray(rq).astype(int))
        assert dq.max() <= 1, dq.max()
        assert float(s2[0, 0]) == 1.0 and not q2[:8].any()
        np.testing.assert_allclose(
            w2.float().numpy(), np.asarray(rw.astype(jnp.float32)),
            rtol=0 if dtype == "float32" else BF16_RTOL, atol=W_ATOL)
    assert lk.LAUNCHES == before


def test_apply_flat_q8_plain_is_apply_flat_then_quantize():
    """The plain version is apply_flat_plain on the dequantized momentum,
    then the packed quantizer: bit for bit."""
    _, (w, g, q, s, lr) = _q8_inputs(24, "float32", seed=3)
    kw = dict(momentum=0.9, weight_decay=1e-4)
    layout = packing.build_layout({"m": torch.zeros(24, 512)}, {"m": False})
    m = packing.dequantize_q8(layout, q, s)
    w_ref, m_ref = lk.apply_flat_plain(w, g, m, lr, **kw)
    q_ref, s_ref = packing.quantize_q8(layout, m_ref)
    w2, q2, s2 = lk.apply_flat_q8_plain(w, g, q, s, lr, **kw)
    assert torch.equal(w2, w_ref) and torch.equal(q2, q_ref)
    assert torch.equal(s2, s_ref)


def test_ops_apply_packed_q8_expands_slice_lrs_to_blocks():
    params, marker = _lenet()
    tp = bridge.params_to_torch(params)
    layout = packing.build_layout(tp, marker)
    wbuf = packing.pack(layout, tp)
    gbuf = wbuf * 0.01
    q, s = packing.quantize_q8(layout, wbuf * 0.1)
    lr = torch.linspace(0.01, 0.1, layout.num_slices)
    got = ops.lars_apply_packed_q8(layout, wbuf, gbuf, q, s, lr,
                                   momentum=0.9, weight_decay=1e-4)
    want = lk.apply_flat_q8_plain(wbuf, gbuf, q, s,
                                  packing.blocks_expand(layout, lr),
                                  momentum=0.9, weight_decay=1e-4)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _make(name, lib, **extra):
    kw = dict(momentum=0.9, weight_decay=1e-4, slot_dtype="int8")
    if name == "lars":
        return lib.lars(0.2, trust_coefficient=0.01, **kw, **extra)
    return lib.sgd(0.2, **kw)


def _grads(params, step):
    rng = np.random.default_rng(100 + step)
    return jax.tree_util.tree_map(
        lambda p: (rng.standard_normal(p.shape) * 0.01).astype(np.float32),
        params)


@pytest.mark.parametrize("name", ["lars", "sgd"])
def test_int8_engine_matches_reference_step_by_step(name):
    params, marker = _lenet()
    ref_opt = _make(name, ref_core,
                    **({"use_pallas": False} if name == "lars" else {}))
    opt = _make(name, port_core)
    rp = jax.tree_util.tree_map(jnp.asarray, params)
    rs = ref_opt.init(rp, stacked=marker)
    tp = bridge.params_to_torch(params)
    ts = opt.init(tp, stacked=marker)
    assert sorted(ts.slots) == sorted(rs.slots) == [
        "momentum", "momentum" + SCALE_SUFFIX, packing.WEIGHT_SLOT]
    for k in ts.slots:                # 0 codes, unit scales, same weights
        assert ts.slots[k].numpy().tobytes() == \
            np.asarray(rs.slots[k]).tobytes(), k
    before = dict(lk.LAUNCHES)
    for step in range(4):
        grads = _grads(params, step)
        rp, rs = ref_opt.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                rs, rp, stacked=marker)
        tp, ts = opt.update(bridge.params_to_torch(grads), ts, tp,
                            stacked=marker)
        codes = ts.slots["momentum"].numpy()
        ref_codes = np.asarray(rs.slots["momentum"])
        assert codes.dtype == np.int8
        scales = ts.slots["momentum_scale"].numpy()
        ref_scales = np.asarray(rs.slots["momentum_scale"])
        if name == "sgd":
            assert codes.tobytes() == ref_codes.tobytes()
            assert scales.tobytes() == ref_scales.tobytes()
            tree_map(lambda a, b: np.testing.assert_array_equal(
                a.numpy(), np.asarray(b)), tp, rp)
            continue
        flips = np.abs(codes.astype(int) - ref_codes.astype(int))
        assert flips.max() <= 1
        assert (flips > 0).mean() <= LARS_FLIP_SHARE, (flips > 0).sum()
        np.testing.assert_allclose(scales, ref_scales, rtol=LARS_SCALE_RTOL)
        tree_map(lambda a, b: np.testing.assert_allclose(
            a.numpy(), np.asarray(b), rtol=0, atol=LARS_PARAM_ATOL,
            err_msg=f"params step {step}"), tp, rp)
    assert lk.LAUNCHES == before              # CPU: plain versions only


def test_int8_slots_are_a_quarter_of_f32():
    """LeNet's momentum: 557,056 B in f32; 139,264 B of codes + 136 B of
    scales in int8."""
    params, marker = _lenet()
    tp = bridge.params_to_torch(params)
    nbytes = {}
    for dt in SLOT_DTYPES:
        st = port_core.lars(0.1, slot_dtype=dt).init(tp, stacked=marker)
        nbytes[dt] = sum(v.numel() * v.element_size()
                         for k, v in st.slots.items()
                         if k != packing.WEIGHT_SLOT)
    assert nbytes == {"f32": 557_056, "int8": 139_264 + 136}


def test_unknown_slot_dtype_is_refused():
    with pytest.raises(ValueError, match="slot_dtype"):
        port_core.sgd(0.1, slot_dtype="int4")
