"""The port's ``TrainPipeline`` (``repro_torch.train.pipeline``): against
its own one-shot step, and against the JAX package's ``TrainPipeline``
on the same init and batches.

Tolerances, each measured on the CPU:
  * accum_steps=1 is ``make_train_step``'s step: bit-identical.
  * accum_steps=4 on batch 4B against one step on 4B: the mean of four
    microbatch means sums in another order than one mean; measured
    <= 1.0e-7 relative in the loss and <= 6.0e-8 absolute in the params
    after 3 steps (LARS and SGD). Held at loss rtol 1e-6, params atol
    1e-6.
  * f32 accumulation against the reference's (accum_steps=4, 3 steps):
    the convolutions sum in another order (PyTorch's vs XLA's); measured
    1.0e-7 relative in the losses. Held at rtol 1e-5, a tenth of the
    golden b32 bar.
  * bf16 against the reference's ``TrainPipeline(precision="bf16")`` (5
    steps at batch 32 with f32 slots; 3 accumulated steps at batch 64
    with int8 slots). The two frameworks reduce bf16 products in another
    order: after ONE step the bias gradients already differ by up to 17 %
    (conv1/b; the weights' by <= 1.9e-3), and the difference feeds back.
    Measured: <= 5.3e-4 relative in the losses (held at 2e-3), and, leaf
    by leaf, ||d_port - d_ref|| / ||d_ref|| for the f32 master weights'
    change from init d: <= 5.3e-3 in the output layer fc3, whose
    gradient is one bf16 product away from the loss (held at 1e-2), and
    <= 9.8e-2 in every other leaf (held at 0.2).
    Teeth, both must fail: the port at lr 0.051 against the reference at
    0.05 moves fc3 by 1.8e-2 (f32 slots) and 1.8e-2 (int8 slots); a port
    whose master copy never moves reads 1.0 in every leaf.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro.models.lenet import LeNet as RefLeNet
from repro.train import TrainPipeline as RefPipeline
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import lars, packing, sgd
from repro_torch.data import batch_iterator, synthetic_mnist
from repro_torch.models import build_model
from repro_torch.train import (TrainPipeline, create_train_state,
                               get_precision, make_eval_step,
                               make_train_step, train_state_from_params)
from repro_torch.treepath import tree_leaves, tree_map

ACCUM_LOSS_RTOL, ACCUM_PARAM_ATOL = 1e-6, 1e-6
REF_F32_RTOL = 1e-5
REF_BF16_LOSS_RTOL = 2e-3
REF_BF16_DELTA_RTOL = {"fc3": 1e-2}  # leaf by leaf; other layers below
REF_BF16_DELTA_RTOL_DEEP = 0.2

CFG = get_config("lenet-mnist")
MODEL = build_model(CFG)


def _init_numpy(seed=7):
    return jax.tree_util.tree_map(np.asarray,
                                  RefLeNet().init(jax.random.key(seed)))


def _batches(batch, n):
    x, y, _, _ = synthetic_mnist(256, 8, seed=0)
    it = batch_iterator(x, y, batch=batch, seed=0)
    return [next(it) for _ in range(n)]


def _t(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _opt(name, **kw):
    make = lars if name == "lars" else sgd
    extra = dict(trust_coefficient=0.01) if name == "lars" else {}
    return make(0.05, momentum=0.9, weight_decay=1e-4, **extra, **kw)


def _run(pipe_or_step, state, batches):
    losses = []
    for b in batches:
        state, m = pipe_or_step(state, _t(b))
        losses.append(float(m["loss"]))
    return state, losses


def _same_bits(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _state(opt, params, precision="f32"):
    return train_state_from_params(MODEL, opt, params, precision=precision)


@pytest.mark.parametrize("name,slot_dtype", [("lars", "f32"),
                                             ("lars", "int8"),
                                             ("sgd", "f32")])
def test_accum_1_is_make_train_step_bit_for_bit(name, slot_dtype):
    params = bridge.params_to_torch(_init_numpy())
    batches = _batches(32, 3)
    opt = _opt(name, slot_dtype=slot_dtype)
    s1, l1 = _run(TrainPipeline(MODEL, opt, CFG), _state(opt, params),
                  batches)
    s2, l2 = _run(make_train_step(MODEL, opt, CFG), _state(opt, params),
                  batches)
    assert l1 == l2
    _same_bits(s1.params, s2.params)
    _same_bits(s1.opt_state.slots, s2.opt_state.slots)


@pytest.mark.parametrize("name", ["lars", "sgd"])
def test_accum_k_on_kB_matches_one_step_on_kB(name):
    params = bridge.params_to_torch(_init_numpy())
    batches = _batches(128, 3)
    runs = []
    for k in (1, 4):
        opt = _opt(name)
        pipe = TrainPipeline(MODEL, opt, CFG, accum_steps=k)
        runs.append(_run(pipe, _state(opt, params), batches))
    (s1, l1), (s4, l4) = runs
    np.testing.assert_allclose(l4, l1, rtol=ACCUM_LOSS_RTOL)
    tree_map(lambda a, b: np.testing.assert_allclose(
        a.numpy(), b.numpy(), rtol=0, atol=ACCUM_PARAM_ATOL),
        s4.params, s1.params)


@functools.lru_cache(maxsize=None)
def _reference_run(precision, accum, batch, steps, slot_dtype="f32"):
    opt = ref_core.lars(0.05, momentum=0.9, weight_decay=1e-4,
                        trust_coefficient=0.01, use_pallas=False,
                        slot_dtype=slot_dtype)
    pipe = RefPipeline(RefLeNet(), opt, CFG, accum_steps=accum,
                       precision=precision, donate=False)
    state = pipe.init_state(jax.random.key(7))
    losses = []
    for b in _batches(batch, steps):
        state, m = pipe(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return state, losses


class _FrozenMaster:
    """A planted fault: the optimizer's update, with the f32 master slot
    written back unchanged (params still move)."""

    def __init__(self, opt):
        self.opt = opt

    def init(self, *a, **kw):
        return self.opt.init(*a, **kw)

    def update(self, grads, opt_state, params, **kw):
        new_params, new_opt = self.opt.update(grads, opt_state, params,
                                              **kw)
        slots = dict(new_opt.slots)
        slots[packing.MASTER_SLOT] = opt_state.slots[packing.MASTER_SLOT]
        return new_params, dataclasses.replace(new_opt, slots=slots)


def _run_against_reference(precision, accum, batch, steps, slot_dtype,
                           lr=0.05, fault=None):
    ref_state, ref_losses = _reference_run(precision, accum, batch, steps,
                                           slot_dtype)
    opt = lars(lr, momentum=0.9, weight_decay=1e-4, trust_coefficient=0.01,
               slot_dtype=slot_dtype)
    if fault is not None:
        opt = fault(opt)
    state = _state(opt, bridge.params_to_torch(_init_numpy()), precision)
    init = state.opt_state.slots.get(packing.MASTER_SLOT)
    init = None if init is None else init.clone()
    pipe = TrainPipeline(MODEL, opt, CFG, accum_steps=accum,
                         precision=precision)
    state, losses = _run(pipe, state, _batches(batch, steps))
    if precision == "f32":
        np.testing.assert_allclose(losses, ref_losses, rtol=REF_F32_RTOL)
        return
    assert all(x.dtype == torch.bfloat16 for x in tree_leaves(state.params))
    np.testing.assert_allclose(losses, ref_losses, rtol=REF_BF16_LOSS_RTOL)
    master = state.opt_state.slots[packing.MASTER_SLOT]
    assert master.dtype == torch.float32
    layout = state.opt_state.layout
    ref_master = torch.from_numpy(
        np.array(ref_state.opt_state.slots["master"]))
    d_port = packing.unpack(layout, master - init, torch.float32)
    d_ref = packing.unpack(layout, ref_master - init, torch.float32)
    for layer, leaves in d_ref.items():
        rtol = REF_BF16_DELTA_RTOL.get(layer, REF_BF16_DELTA_RTOL_DEEP)
        for name, d in leaves.items():
            err = float((d_port[layer][name] - d).norm() / d.norm())
            assert err <= rtol, (f"{layer}/{name}: master change off the "
                                 f"reference's by {err:.3e} > {rtol}")


REF_RUNS = [("f32", 4, 64, 3, "f32"), ("bf16", 1, 32, 5, "f32"),
            ("bf16", 4, 64, 3, "int8")]


@pytest.mark.parametrize("precision,accum,batch,steps,slot_dtype",
                         REF_RUNS)
def test_pipeline_matches_the_reference(precision, accum, batch, steps,
                                        slot_dtype):
    _run_against_reference(precision, accum, batch, steps, slot_dtype)


@pytest.mark.parametrize("fault", ["lr+1e-3", "frozen_master"])
@pytest.mark.parametrize("run", [r for r in REF_RUNS if r[0] == "bf16"])
def test_bf16_reference_check_has_teeth(run, fault):
    kw = dict(lr=0.051) if fault == "lr+1e-3" else \
        dict(fault=_FrozenMaster)
    with pytest.raises(AssertionError):
        _run_against_reference(*run, **kw)


def test_bf16_policy_state_layout_matches_the_reference():
    """bf16 params, an f32 master slot seeded from them (byte-equal to the
    reference's), no packed-weight slot; eval runs on f32 host data."""
    params = bridge.params_to_torch(_init_numpy())
    state = _state(_opt("lars", slot_dtype="int8"), params, "bf16")
    ref_opt = ref_core.lars(0.05, slot_dtype="int8", use_pallas=False)
    ref_state = RefPipeline(RefLeNet(), ref_opt, CFG, precision="bf16",
                            donate=False).init_state(jax.random.key(7))
    assert sorted(state.opt_state.slots) == sorted(ref_state.opt_state.slots)
    for k, v in state.opt_state.slots.items():
        assert v.numpy().tobytes() == \
            np.asarray(ref_state.opt_state.slots[k]).tobytes(), k
    assert get_precision("bf16").master_weights
    ev = make_eval_step(MODEL, CFG)(state.params, _t(_batches(32, 1)[0]))
    assert ev["loss"].dtype == torch.float32
    assert 0.0 <= float(ev["accuracy"]) <= 1.0


def test_create_train_state_precision_matches_pipeline():
    opt = _opt("lars", slot_dtype="int8")
    pipe = TrainPipeline(MODEL, opt, CFG, precision="bf16")
    a = pipe.init_state(torch.Generator().manual_seed(9), "cpu")
    b = create_train_state(MODEL, opt, torch.Generator().manual_seed(9),
                           device="cpu", precision="bf16")
    _same_bits(a.params, b.params)
    _same_bits(a.opt_state.slots, b.opt_state.slots)
    assert a.params["conv1"]["w"].dtype == torch.bfloat16


def test_pipeline_refuses_what_it_cannot_do():
    opt = _opt("lars")
    for kw in ({"mesh": object()}, {"zero": True}):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            TrainPipeline(MODEL, opt, CFG, **kw)
    with pytest.raises(ValueError, match="accum_steps"):
        TrainPipeline(MODEL, opt, CFG, accum_steps=0)
    # unfused accumulation is ported (tests/test_torch_tree_engine.py);
    # an unknown mode is the reference's ValueError
    TrainPipeline(MODEL, opt, CFG, fuse_update=False)
    with pytest.raises(ValueError, match="fuse_update"):
        TrainPipeline(MODEL, opt, CFG, fuse_update="yes")
    with pytest.raises(ValueError, match="precision"):
        TrainPipeline(MODEL, opt, CFG, precision="fp8")
    pipe = TrainPipeline(MODEL, opt, CFG, accum_steps=3)
    state = _state(opt, bridge.params_to_torch(_init_numpy()))
    with pytest.raises(ValueError, match="divisible"):
        pipe(state, _t(_batches(32, 1)[0]))
