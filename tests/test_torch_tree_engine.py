"""The port's per-leaf tree engine (``init(params)`` without a marker),
its leaf quantizers, tree-state ``TrainState``/``TrainPipeline``
(``packed=False``, ``fuse_update=False``), and tree-state checkpoints and
bridging, against the JAX package's in one process on the same inputs.

Tolerances, each measured on the CPU:
  * the engine, 3 steps on a zoo of stacked, unstacked, bf16, vector and
    scalar leaves, against the reference's tree engine and against the
    port's own packed engine: rtol 2e-5, atol 1e-5 (the reference's
    packed-against-tree class, tests/test_core_optim.py). Only the f32
    summation order of the per-layer norms differs. Measured against the
    reference: <= 2.4e-7 absolute in the params and the master, <= 2.8e-9
    in the f32 slots, scales equal, and one LARS momentum code rounded
    the other way (int8 codes are compared within one code). Against the
    packed engine, f32 slots: <= 1.2e-7 in the params, the slots and the
    master. The packed engine's int8 slots are quantized in other groups
    (one scale per 4,096 packed values against one per leading index of
    a leaf), so int8 states are held against the reference only: there
    the two engines differ by up to 0.147 in AdamW's params after 3
    steps, a different quantization, not a fault.
  * the leaf quantizers: codes equal and scales equal to the reference's
    on finite inputs (the same IEEE division and round half to even).
    NaN is where the port differs on purpose (ROADMAP.md queue 3): the
    reference's scale 1.0 becomes NaN.
  * the fused epilogue against the two-pass update (the reference's
    tests/test_pipeline.py cases): loss rtol 1e-6 and params rtol 1e-5,
    atol 1e-7 in f32; loss rtol 1e-5 and params rtol 1e-4, atol 1e-6 for
    bf16 with int8 slots, the reference's bars. Measured: bit-identical
    in all three (the packed engine takes LARS's norms off the packed
    buffer either way, and packing is exact).
  * TrainPipeline(packed=False, accum_steps=4) on LeNet against the
    reference's, 4 steps from its init: the convolutions sum in another
    order; measured 9.3e-8 relative in the losses and 6.0e-8 absolute in
    the params in f32 (held at rtol 1e-5, atol 1e-5); with bf16 compute
    and int8 slots 5.2e-4 in the losses, held at tests/test_torch_
    pipeline.py's bf16 bar of 2e-3.
  * checkpoints: byte-equal re-saves in both directions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro.checkpoint import restore_train_state as ref_restore
from repro.checkpoint import save_train_state as ref_save
from repro.core import packing as ref_packing
from repro.models.lenet import LeNet as RefLeNet
from repro.train import TrainPipeline as RefPipeline
import repro_torch.core as port_core
from repro_torch import bridge
from repro_torch.checkpoint import restore_train_state, save_train_state
from repro_torch.configs import get_config
from repro_torch.core import grad_stats, lamb, lars, packing, trust_ratio
from repro_torch.core.optim_base import PackedGrads
from repro_torch.data import batch_iterator, synthetic_mnist
from repro_torch.kernels import lars_kernels as lk
from repro_torch.models import build_model
from repro_torch.train import (TrainPipeline, create_train_state,
                               train_state_from_params)
from repro_torch.treepath import (tree_flatten_with_path, tree_leaves,
                                  tree_map)

RTOL, ATOL = 2e-5, 1e-5
FUSED = {"f32": ((1e-6, 1e-5, 1e-7)), "bf16_int8": (1e-5, 1e-4, 1e-6)}
PIPE_RTOL, PIPE_BF16_RTOL = 1e-5, 2e-3
CFG = get_config("lenet-mnist")
MODEL = build_model(CFG)
OPTS = ["sgd", "sgd_nesterov", "lars", "lamb", "adamw"]


def _make(name, lib, slot_dtype="f32", **extra):
    kw = dict(slot_dtype=slot_dtype, **extra)
    if name.startswith("sgd"):
        return lib.sgd(0.2, momentum=0.9, weight_decay=1e-4,
                       nesterov=name == "sgd_nesterov", **kw)
    if name == "lars":
        pallas = {"use_pallas": False} if lib is ref_core else {}
        return lib.lars(0.2, momentum=0.9, weight_decay=1e-4,
                        trust_coefficient=0.01, **pallas, **kw)
    if name == "lamb":
        return lib.lamb(0.01, weight_decay=1e-4, **kw)
    return lib.adamw(0.01, weight_decay=1e-4, **kw)


def _zoo():
    """Stacked, unstacked, bf16, vector and scalar leaves."""
    rng = np.random.default_rng(4)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    params = {"w": f(37, 19), "stack": f(3, 11, 13),
              "half": {"w": f(9, 5), "stack": f(2, 6, 4)},
              "b": np.ones((7,), np.float32), "s": np.float32(0.7)}
    marker = {"w": False, "stack": True, "half": {"w": False, "stack": True},
              "b": False, "s": False}
    return params, marker


def _ref_params(params):
    """The zoo on the reference's side: the "half" leaves in bf16."""
    out = jax.tree_util.tree_map(jnp.asarray, params)
    out["half"] = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16),
                                         out["half"])
    return out


def _port_params(params):
    out = bridge.params_to_torch(params)
    out["half"] = tree_map(lambda x: x.bfloat16(), out["half"])
    return out


def _grads(params, step):
    rng = np.random.default_rng(100 + step)
    return jax.tree_util.tree_map(
        lambda p: (rng.standard_normal(np.shape(p)) * 0.01).astype(
            np.float32), params)


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else bridge.tensor_to_numpy(x).astype(
            np.float32 if x.is_floating_point() else np.int32)


def _flat(tree):
    """{path: leaf} of a nested dict, the port's or the reference's."""
    return {"/".join(p): leaf for p, leaf in tree_flatten_with_path(tree)[0]}


def _close_trees(got, want, label, codes=False):
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w), label
    for k in g:
        a, b = _np(g[k]), _np(w[k])
        assert a.shape == b.shape, (label, k)
        if codes:
            assert np.max(np.abs(a - b), initial=0) <= 1, (label, k)
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{label} {k}")


def _run_port(opt, tp, marker, params, master, stacked_init=None, steps=3):
    state = opt.init(tp, stacked=stacked_init, master=master)
    for step in range(steps):
        tp, state = opt.update(bridge.params_to_torch(_grads(params, step)),
                               state, tp, stacked=marker)
    return tp, state


@pytest.mark.parametrize("master", [False, True], ids=["f32", "master"])
@pytest.mark.parametrize("slot_dtype", ["f32", "int8"])
@pytest.mark.parametrize("name", OPTS)
def test_tree_engine_matches_reference_and_packed_engine(name, slot_dtype,
                                                         master):
    params, marker = _zoo()
    ref_opt = _make(name, ref_core, slot_dtype)
    rp = _ref_params(params)
    rs = ref_opt.init(rp, master=master)
    assert rs.layout is None
    for step in range(3):
        rp, rs = ref_opt.update(jax.tree_util.tree_map(
            jnp.asarray, _grads(params, step)), rs, rp, stacked=marker)

    opt = _make(name, port_core, slot_dtype)
    before = dict(lk.LAUNCHES)
    tp, ts = _run_port(opt, _port_params(params), marker, params, master)
    assert ts.layout is None and ts.step == int(rs.step) == 3
    assert lk.LAUNCHES == before
    _close_trees(tp, rp, "params")
    assert {k: str(v.dtype) for k, v in _flat(tp).items()} == {
        k: str(v.dtype).replace("bfloat16", "torch.bfloat16").replace(
            "float32", "torch.float32") for k, v in _flat(rp).items()}
    assert set(ts.slots) == set(rs.slots)
    for k in ts.slots:
        _close_trees(ts.slots[k], rs.slots[k], k,
                     codes=_flat(ts.slots[k])["w"].dtype == torch.int8)

    if slot_dtype == "int8":
        return      # the packed engine quantizes in other groups
    # the port's packed engine from the same params and gradients
    pp, ps = _run_port(opt, _port_params(params), marker, params, master,
                       stacked_init=marker)
    assert ps.layout is not None
    _close_trees(tp, pp, "params against the packed engine")
    for k in opt_slots(name) + ((packing.MASTER_SLOT,) if master else ()):
        unpacked = packing.unpack(ps.layout, ps.slots[k],
                                  dtype=torch.float32)
        _close_trees(ts.slots[k], unpacked, f"{k} against packed")


def opt_slots(name):
    return ("mu", "nu") if name in ("lamb", "adamw") else ("momentum",)


# --------------------------------------------------------- leaf quantizers

@pytest.mark.parametrize("shape", [(), (7,), (5, 9), (3, 4, 6), (2, 3, 4, 5)])
def test_leaf_quantizers_match_the_reference(shape):
    rng = np.random.default_rng(len(shape))
    x = (rng.standard_normal(shape) * 3.0).astype(np.float32)
    if len(shape) >= 2:
        x[0] = 0.0                            # an all-zero group
    q, s = packing.quantize_leaf_q8(torch.from_numpy(np.array(x)))
    rq, rs = ref_packing.quantize_leaf_q8(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(q.shape) == tuple(rq.shape) == shape
    assert tuple(s.shape) == tuple(rs.shape)
    want_scale = () if not shape else (shape if len(shape) == 1
                                       else (shape[0],) + (1,) * (
                                           len(shape) - 1))
    assert tuple(s.shape) == want_scale
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(
        packing.dequantize_leaf_q8(q, s).numpy(),
        np.asarray(ref_packing.dequantize_leaf_q8(rq, rs)))
    if len(shape) >= 2:
        assert torch.all(q[0] == 0) and torch.all(s[0] == 1.0)


def test_leaf_quantizer_zeros_give_unit_scales_and_nan_keeps_its_scale():
    q, s = packing.quantize_leaf_q8(torch.zeros(4, 3))
    assert torch.all(q == 0) and torch.all(s == 1.0)
    x = np.ones((2, 4), np.float32)
    x[1, 2] = np.nan
    q, s = packing.quantize_leaf_q8(torch.from_numpy(x))
    rq, rs = ref_packing.quantize_leaf_q8(jnp.asarray(x))
    # the clean group agrees; in the NaN group the reference drops the
    # NaN (scale 1.0, code 0) and the port keeps the scale NaN
    assert torch.equal(q[0], torch.full((4,), 127, dtype=torch.int8))
    np.testing.assert_array_equal(np.asarray(rq)[0], q[0].numpy())
    assert float(np.asarray(rs)[1, 0]) == 1.0
    assert torch.isnan(s[1, 0]) and torch.all(q[1] == 0)
    assert torch.all(torch.isnan(packing.dequantize_leaf_q8(q, s)[1]))


# ------------------------------------------------------------- the state

@pytest.mark.parametrize("master", [False, True], ids=["f32", "master"])
@pytest.mark.parametrize("slot_dtype", ["f32", "int8"])
@pytest.mark.parametrize("name", ["sgd", "lars", "lamb", "adamw"])
def test_tree_state_slots_match_the_reference_init(name, slot_dtype,
                                                   master):
    params, _ = _zoo()
    rs = _make(name, ref_core, slot_dtype).init(_ref_params(params),
                                                master=master)
    ts = _make(name, port_core, slot_dtype).init(_port_params(params),
                                                 master=master)
    assert ts.step == 0 and ts.layout is None
    assert set(ts.slots) == set(rs.slots)
    for k in ts.slots:
        got, want = _flat(ts.slots[k]), _flat(rs.slots[k])
        assert set(got) == set(want), k
        for path in got:
            assert tuple(got[path].shape) == tuple(np.shape(want[path]))
            assert bridge.tensor_to_numpy(got[path]).dtype == \
                np.asarray(want[path]).dtype, (k, path)
            np.testing.assert_array_equal(_np(got[path]),
                                          _np(np.asarray(want[path])))


def test_tree_state_refusals():
    params, marker = _zoo()
    tp = _port_params(params)
    grads = bridge.params_to_torch(_grads(params, 0))
    state = lars(0.1, use_kernels=True).init(tp)
    with pytest.raises(ValueError, match=r"use_kernels=True\) requires "
                                         "the flat-packed layout"):
        lars(0.1, use_kernels=True).update(grads, state, tp)
    for opt in (lars(0.1), lamb(0.01)):
        state = opt.init(tp)
        with pytest.raises(ValueError, match="PackedGrads requires the "
                                             "flat-packed layout"):
            opt.update(PackedGrads(torch.zeros(8, 512)), state, tp)
    # nothing routes a packed state to the tree engine
    packed = lars(0.1, use_kernels=True).init(tp, stacked=marker)
    assert packed.layout is not None


def test_create_train_state_packed_false_is_a_tree_state():
    for precision in ("f32", "bf16"):
        st = create_train_state(MODEL, lars(0.1),
                                torch.Generator().manual_seed(3),
                                device="cpu", packed=False,
                                precision=precision)
        assert st.opt_state.layout is None
        assert set(st.opt_state.slots) == (
            {"momentum", packing.MASTER_SLOT} if precision == "bf16"
            else {"momentum"})
        for k, v in st.opt_state.slots.items():
            assert tree_flatten_with_path(v)[1] == \
                tree_flatten_with_path(st.params)[1]
            assert all(x.dtype == torch.float32 for x in tree_leaves(v))


# ------------------------------------------------------------ pipeline

def _lenet_init(seed):
    return bridge.params_to_torch(jax.tree_util.tree_map(
        np.asarray, RefLeNet().init(jax.random.key(seed))))


def _mnist_batch(n, seed=0):
    x, y, _, _ = synthetic_mnist(max(256, n), 8, seed=seed)
    return next(batch_iterator(x, y, batch=n, seed=seed))


def _t(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("opt_name", ["lars", "lamb"])
def test_fused_epilogue_matches_two_pass(opt_name):
    opt = lars(0.05, trust_coefficient=0.01) if opt_name == "lars" \
        else lamb(0.01)
    batch = _t(_mnist_batch(64, seed=3))
    params = _lenet_init(4)
    states, losses = {}, {}
    for fuse in (True, False):
        pipe = TrainPipeline(MODEL, opt, CFG, accum_steps=4, donate=False,
                             fuse_update=fuse)
        s = train_state_from_params(MODEL, opt, params)
        for _ in range(4):
            s, m = pipe(s, batch)
        states[fuse], losses[fuse] = s, float(m["loss"])
    loss_rtol, rtol, atol = FUSED["f32"]
    np.testing.assert_allclose(losses[True], losses[False], rtol=loss_rtol)
    for a, b in zip(tree_leaves(states[True].params),
                    tree_leaves(states[False].params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=rtol,
                                   atol=atol)


def test_fused_epilogue_matches_two_pass_bf16_int8():
    opt = lars(0.05, trust_coefficient=0.01, slot_dtype="int8")
    batch = _t(_mnist_batch(64, seed=5))
    params = _lenet_init(6)
    losses, out = {}, {}
    for fuse in (True, False):
        pipe = TrainPipeline(MODEL, opt, CFG, accum_steps=4,
                             precision="bf16", donate=False,
                             fuse_update=fuse)
        s = train_state_from_params(MODEL, opt, params, precision="bf16")
        for _ in range(4):
            s, m = pipe(s, batch)
        losses[fuse], out[fuse] = float(m["loss"]), s.params
    loss_rtol, rtol, atol = FUSED["bf16_int8"]
    np.testing.assert_allclose(losses[True], losses[False], rtol=loss_rtol)
    for a, b in zip(tree_leaves(out[True]), tree_leaves(out[False])):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=rtol, atol=atol)


def test_fuse_update_validation():
    opt = lars(0.05)
    with pytest.raises(ValueError, match="fuse_update"):
        TrainPipeline(MODEL, opt, CFG, fuse_update="sometimes")
    batch = _t(_mnist_batch(32))
    params = _lenet_init(0)
    for kw, packed in (({"accum_steps": 1}, True),
                       ({"accum_steps": 4}, False)):
        pipe = TrainPipeline(MODEL, opt, CFG, fuse_update=True,
                             packed=packed, **kw)
        with pytest.raises(ValueError, match="accum_steps > 1, a flat-"):
            pipe(pipe.init_state(torch.Generator().manual_seed(0), "cpu"),
                 batch)
    # "auto" at accum 1 and on a tree state runs
    for packed in (True, False):
        pipe = TrainPipeline(MODEL, opt, CFG, accum_steps=2, packed=packed)
        state = train_state_from_params(MODEL, opt, params, packed=packed)
        assert (state.opt_state.layout is None) == (not packed)
        state, m = pipe(state, batch)
        assert np.isfinite(float(m["loss"]))


@pytest.mark.parametrize("precision,slot_dtype", [("f32", "f32"),
                                                  ("bf16", "int8")])
def test_tree_pipeline_matches_the_reference_pipeline(precision,
                                                      slot_dtype):
    kw = dict(momentum=0.9, weight_decay=1e-4, trust_coefficient=0.01,
              slot_dtype=slot_dtype)
    ref_pipe = RefPipeline(RefLeNet(), ref_core.lars(0.05, use_pallas=False,
                                                     **kw), CFG,
                           accum_steps=4, precision=precision,
                           donate=False, packed=False)
    rs = ref_pipe.init_state(jax.random.key(4))
    assert rs.opt_state.layout is None
    pipe = TrainPipeline(MODEL, lars(0.05, **kw), CFG, accum_steps=4,
                         precision=precision, donate=False, packed=False)
    ts = train_state_from_params(
        MODEL, pipe.optimizer, bridge.params_to_torch(jax.tree_util.tree_map(
            lambda x: np.asarray(x, np.float32), rs.params)),
        precision=precision, packed=False)
    x, y, _, _ = synthetic_mnist(256, 8, seed=0)
    it = batch_iterator(x, y, batch=64, seed=0)
    for step in range(4):
        b = next(it)
        rs, rm = ref_pipe(rs, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tm = pipe(ts, _t(b))
        rel = abs(float(tm["loss"]) - float(rm["loss"])) / abs(
            float(rm["loss"]))
        # bf16 products reduce in another order in the two frameworks:
        # tests/test_torch_pipeline.py's bf16 bar
        assert rel <= (PIPE_RTOL if precision == "f32"
                       else PIPE_BF16_RTOL), step
    assert ts.opt_state.layout is None and ts.opt_state.step == 4
    if precision == "f32":
        _close_trees(ts.params, rs.params, "params")


def test_donate_is_accepted_and_the_callers_state_is_kept():
    batch = _t(_mnist_batch(64, seed=1))
    params = _lenet_init(2)
    out = {}
    for donate in (True, False):
        pipe = TrainPipeline(MODEL, lars(0.05), CFG, accum_steps=2,
                             donate=donate, packed=False)
        state = train_state_from_params(MODEL, pipe.optimizer, params,
                                        packed=False)
        before = [x.clone() for x in tree_leaves(state.params)
                  + tree_leaves(state.opt_state.slots)]
        new, _ = pipe(state, batch)
        assert all(torch.equal(a, b) for a, b in zip(
            before, tree_leaves(state.params)
            + tree_leaves(state.opt_state.slots)))
        out[donate] = tree_leaves(new.params)
    assert all(torch.equal(a, b) for a, b in zip(out[True], out[False]))


def test_stats_fn_gets_tree_grads_on_the_unfused_path():
    seen = {}

    def stats(params, grads, stacked):
        seen["grads"], seen["stacked"] = grads, stacked
        return grad_stats.layer_stats(params, grads, eta=0.01,
                                      weight_decay=1e-4, stacked=stacked)

    pipe = TrainPipeline(MODEL, lars(0.05), CFG, accum_steps=2,
                         fuse_update=False, stats_fn=stats)
    state = train_state_from_params(MODEL, pipe.optimizer, _lenet_init(3))
    assert state.opt_state.layout is not None       # a packed state
    _, m = pipe(state, _t(_mnist_batch(32)))
    assert isinstance(seen["grads"], dict) and "stats" in m
    assert tree_flatten_with_path(seen["grads"])[1] == \
        tree_flatten_with_path(state.params)[1]
    assert seen["stacked"] is not None              # packed=True


# ---------------------------------------------------- checkpoints, bridge

CKPT_POLICIES = [("f32", "f32"), ("f32", "int8"), ("bf16", "f32")]


def _ref_tree_state(precision, slot_dtype, steps=2):
    kw = dict(momentum=0.9, weight_decay=1e-4, trust_coefficient=0.01,
              slot_dtype=slot_dtype)
    pipe = RefPipeline(RefLeNet(), ref_core.lars(0.05, use_pallas=False,
                                                 **kw), CFG,
                       precision=precision, donate=False, packed=False)
    rs = pipe.init_state(jax.random.key(9))
    x, y, _, _ = synthetic_mnist(256, 8, seed=0)
    it = batch_iterator(x, y, batch=32, seed=0)
    for _ in range(steps):
        rs, _ = pipe(rs, {k: jnp.asarray(v) for k, v in next(it).items()})
    return pipe, rs


def _port_tree_state(precision, slot_dtype, steps=2):
    pipe = TrainPipeline(MODEL, lars(0.05, trust_coefficient=0.01,
                                     slot_dtype=slot_dtype), CFG,
                         precision=precision, packed=False)
    st = pipe.init_state(torch.Generator().manual_seed(9), "cpu")
    x, y, _, _ = synthetic_mnist(256, 8, seed=0)
    it = batch_iterator(x, y, batch=32, seed=0)
    for _ in range(steps):
        st, _ = pipe(st, _t(next(it)))
    return pipe, st


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("precision,slot_dtype", CKPT_POLICIES)
def test_port_tree_checkpoint_restores_in_the_reference(tmp_path, precision,
                                                        slot_dtype):
    _, st = _port_tree_state(precision, slot_dtype)
    ref_pipe, _ = _ref_tree_state(precision, slot_dtype, steps=0)
    path, again = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    save_train_state(path, st)
    template = ref_pipe.init_state(jax.random.key(0))
    restored = ref_restore(path, template)
    assert int(restored.opt_state.step) == 2
    ref_save(again, restored)
    assert _bytes(again) == _bytes(path)
    with np.load(path) as data:
        keys = set(data.files)
    assert ".opt_state/.slots/momentum/conv1/w" in keys
    assert (".opt_state/.slots/momentum_scale/conv1/w" in keys) == \
        (slot_dtype == "int8")
    assert (".opt_state/.slots/master/conv1/w" in keys) == \
        (precision == "bf16")


@pytest.mark.parametrize("precision,slot_dtype", CKPT_POLICIES)
def test_reference_tree_checkpoint_restores_in_the_port(tmp_path, precision,
                                                        slot_dtype):
    _, rs = _ref_tree_state(precision, slot_dtype)
    pipe, _ = _port_tree_state(precision, slot_dtype, steps=0)
    path, again = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    ref_save(path, rs)
    template = pipe.init_state(torch.Generator().manual_seed(1), "cpu")
    restored = restore_train_state(path, template)
    assert restored.opt_state.step == 2 and restored.opt_state.layout is None
    save_train_state(again, restored)
    assert _bytes(again) == _bytes(path)
    # a tree checkpoint does not restore into a packed template
    packed = TrainPipeline(MODEL, pipe.optimizer, CFG,
                           precision=precision).init_state(
        torch.Generator().manual_seed(1), "cpu")
    with pytest.raises(ValueError, match="cannot hold|lacks"):
        restore_train_state(path, packed)


@pytest.mark.parametrize("precision,slot_dtype", CKPT_POLICIES)
def test_bridge_carries_a_tree_state_both_ways(precision, slot_dtype):
    _, rs = _ref_tree_state(precision, slot_dtype)
    slots = jax.tree_util.tree_map(lambda x: np.asarray(x), dict(
        rs.opt_state.slots))
    ts = bridge.opt_state_to_torch(int(rs.opt_state.step), slots, None)
    assert ts.layout is None and ts.step == 2
    step, back = bridge.opt_state_to_numpy(ts)
    assert step == 2 and set(back) == set(slots)
    for k in slots:
        got, want = _flat(back[k]), _flat(slots[k])
        assert set(got) == set(want)
        for path in got:
            assert got[path].dtype == want[path].dtype
            np.testing.assert_array_equal(got[path], want[path])
    # one more step on each side from the carried state
    params = bridge.params_to_torch(jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32), rs.params))
    params = tree_map(lambda x: x.bfloat16(), params) \
        if precision == "bf16" else params
    opt = lars(0.05, trust_coefficient=0.01, slot_dtype=slot_dtype)
    ref_opt = ref_core.lars(0.05, trust_coefficient=0.01,
                            slot_dtype=slot_dtype, use_pallas=False)
    grads = _grads(jax.tree_util.tree_map(np.asarray, rs.params), 0)
    tp, ts = opt.update(bridge.params_to_torch(grads), ts, params)
    rp, rs2 = ref_opt.update(jax.tree_util.tree_map(jnp.asarray, grads),
                             rs.opt_state, rs.params)
    _close_trees(tp, rp, "params after the carried step")
    with pytest.raises(ValueError, match="leaf paths"):
        bridge.opt_state_to_torch(
            2, {"momentum": {"a": np.zeros(2, np.float32)},
                "master": {"b": np.zeros(2, np.float32)}}, None)


def test_stacked_vector_leaves_adapt_per_layer_as_the_reference():
    """With ``skip_adaptation_1d=False`` a stacked (L,) leaf takes one
    trust ratio per element (a norm over no axis is the identity, as
    ``jnp.sum(axis=())`` is), and a scalar leaf its own."""
    rng = np.random.default_rng(9)
    params = {"v": rng.standard_normal(5).astype(np.float32),
              "m": rng.standard_normal((4, 3)).astype(np.float32),
              "s": np.float32(-1.5)}
    marker = {"v": True, "m": False, "s": False}
    w, g = torch.from_numpy(params["v"]), torch.from_numpy(
        _grads(params, 0)["v"])
    for got, want in zip(trust_ratio.layer_norms(w, g, True),
                         ref_core.trust_ratio.layer_norms(
                             jnp.asarray(w.numpy()), jnp.asarray(g.numpy()),
                             True)):
        assert tuple(got.shape) == (5,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    kw = dict(trust_coefficient=0.01, skip_adaptation_1d=False)
    ref_opt = ref_core.lars(0.2, use_pallas=False, **kw)
    opt = lars(0.2, **kw)
    rp = jax.tree_util.tree_map(jnp.asarray, params)
    rs = ref_opt.init(rp)
    tp = bridge.params_to_torch(params)
    ts = opt.init(tp)
    for step in range(3):
        grads = _grads(params, step)
        rp, rs = ref_opt.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                rs, rp, stacked=marker)
        tp, ts = opt.update(bridge.params_to_torch(grads), ts, tp,
                            stacked=marker)
    _close_trees(tp, rp, "params")
    _close_trees(ts.slots["momentum"], rs.slots["momentum"], "momentum")
