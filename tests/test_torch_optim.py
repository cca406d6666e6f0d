"""The port's optimizer core against ``repro.core``: schedules, scaling,
trust ratios, and the packed engine step by step (params, momentum and
the packed weight buffer over 3 steps) for LARS and SGD.

Tolerances: schedules rtol 1e-6 (the same f32 operations; numpy's and
XLA's pow/cos may differ in the last ulp); trust ratios rtol 1e-6; the
engine rtol 1e-5 / atol 1e-6 — per-slice norms are summed in another
order, which moves each trust ratio by ~1e-7 relative, and that
difference scales the update.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro.core import packing as ref_packing
from repro.core import schedules as ref_sched
from repro.core import trust_ratio as ref_tr
from repro.core.scaling import scaled_lr as ref_scaled_lr
from repro.models.lenet import LeNet as RefLeNet
import repro_torch.core as port_core
from repro_torch import bridge
from repro_torch.core import (get_optimizer, lars, packing, schedules, sgd,
                              trust_ratio as tr)
from repro_torch.core.scaling import scaled_lr
from repro_torch.kernels import lars_kernels as lk
from repro_torch.treepath import tree_map

SCHED_RTOL = 1e-6
ENGINE_RTOL, ENGINE_ATOL = 1e-5, 1e-6

SCHEDULES = {
    "constant": lambda m: m.constant(0.3),
    "inverse_time": lambda m: m.inverse_time_decay(0.01, 1e-2),
    "step": lambda m: m.step_decay(0.5, 0.3, every=7),
    "poly": lambda m: m.polynomial_decay(0.2, 25, power=2.0, lr_end=0.01),
    "cosine": lambda m: m.cosine_decay(0.2, 25, lr_end=0.001),
    "poly_warmup": lambda m: m.poly_decay_with_warmup(0.2, 30, 5),
    "warmup": lambda m: m.with_warmup(m.constant(0.1), 4),
    "large_batch": lambda m: m.large_batch_lr(0.01, 32, 8192, 20,
                                              warmup_steps=5),
    "large_batch_sqrt": lambda m: m.large_batch_lr(0.01, 32, 512, 20,
                                                   policy="sqrt"),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_reference(name):
    got, want = SCHEDULES[name](schedules), SCHEDULES[name](ref_sched)
    for step in range(32):
        g = got(step)
        assert isinstance(g, np.float32), type(g)
        np.testing.assert_allclose(
            g, np.asarray(want(jnp.asarray(step, jnp.int32))),
            rtol=SCHED_RTOL, err_msg=f"{name} step {step}")


@pytest.mark.parametrize("policy", ["none", "linear", "sqrt"])
def test_scaled_lr_matches_reference(policy):
    assert scaled_lr(0.01, 32, 8192, policy) == \
        ref_scaled_lr(0.01, 32, 8192, policy)


@pytest.mark.parametrize("stacked", [False, True])
def test_trust_ratio_matches_reference(stacked):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 9, 5), np.float32)
    g = rng.standard_normal((3, 9, 5), np.float32) * 0.01
    g[1] = 0.0 if stacked else g[1]          # a zero-grad slice -> ratio 1
    got = tr.layer_norms(torch.from_numpy(w), torch.from_numpy(g), stacked)
    want = ref_tr.layer_norms(jnp.asarray(w), jnp.asarray(g), stacked)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    ratio = tr.lars_trust_ratio(*got, eta=0.01, weight_decay=1e-4)
    np.testing.assert_allclose(
        ratio.numpy(), np.asarray(ref_tr.lars_trust_ratio(
            *want, eta=0.01, weight_decay=1e-4)), rtol=1e-6)
    assert tr.effective_rank(torch.from_numpy(w), stacked) == \
        ref_tr.effective_rank(jnp.asarray(w), stacked)
    z, one = torch.zeros(()), torch.ones(())
    assert float(tr.lars_trust_ratio(z, one, eta=0.001,
                                     weight_decay=0.0)) == 1.0


def _zoo():
    rng = np.random.default_rng(4)
    params = {"w": rng.standard_normal((37, 19), np.float32),
              "stack": rng.standard_normal((3, 11, 13), np.float32),
              "b": np.ones((7,), np.float32)}
    return params, {"w": False, "stack": True, "b": False}


def _lenet():
    params = jax.tree_util.tree_map(np.asarray,
                                    RefLeNet().init(jax.random.key(1)))
    return params, jax.tree_util.tree_map(lambda _: False, params)


def _grads(params, step):
    rng = np.random.default_rng(100 + step)
    return jax.tree_util.tree_map(
        lambda p: (rng.standard_normal(p.shape) * 0.01).astype(np.float32),
        params)


def _make(name, lib, **extra):
    kw = dict(momentum=0.9, weight_decay=1e-4)
    if name == "lars":
        return lib.lars(0.2, trust_coefficient=0.01, **kw, **extra)
    return lib.sgd(0.2, **kw)


def _assert_close(got, want, label):
    np.testing.assert_allclose(got, want, rtol=ENGINE_RTOL, atol=ENGINE_ATOL,
                               err_msg=label)


@pytest.mark.parametrize("tree", ["zoo", "lenet"])
@pytest.mark.parametrize("name,use_kernels", [
    ("lars", "auto"), ("lars", False), ("sgd", "auto")])
def test_packed_engine_matches_reference_step_by_step(tree, name,
                                                      use_kernels):
    params, marker = {"zoo": _zoo, "lenet": _lenet}[tree]()
    ref_opt = _make(name, ref_core,
                    **({"use_pallas": False} if name == "lars" else {}))
    opt = _make(name, port_core,
                **({"use_kernels": use_kernels} if name == "lars" else {}))
    rp = jax.tree_util.tree_map(jnp.asarray, params)
    rs = ref_opt.init(rp, stacked=marker)
    tp = bridge.params_to_torch(params)
    ts = opt.init(tp, stacked=marker)
    before = dict(lk.LAUNCHES)
    for step in range(3):
        grads = _grads(params, step)
        rp, rs = ref_opt.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                rs, rp, stacked=marker)
        tp, ts = opt.update(bridge.params_to_torch(grads), ts, tp,
                            stacked=marker)
        assert ts.step == int(rs.step) == step + 1
        tree_map(lambda a, b: _assert_close(
            a.numpy(), np.asarray(b), f"params step {step}"), tp, rp)
        for k in ("momentum", packing.WEIGHT_SLOT):
            _assert_close(ts.slots[k].numpy(), np.asarray(rs.slots[k]),
                          f"{k} step {step}")
    assert lk.LAUNCHES == before          # CPU: plain versions only


def test_state_carries_across_mid_run():
    """Two reference steps, carry the packed state over, one more step on
    each side: the port continues the reference's trajectory."""
    params, marker = _lenet()
    ref_opt = ref_core.lars(0.2, trust_coefficient=0.01, use_pallas=False)
    rp = jax.tree_util.tree_map(jnp.asarray, params)
    rs = ref_opt.init(rp, stacked=marker)
    for step in range(2):
        rp, rs = ref_opt.update(jax.tree_util.tree_map(
            jnp.asarray, _grads(params, step)), rs, rp, stacked=marker)
    opt = lars(0.2, trust_coefficient=0.01)
    tp = bridge.params_to_torch(jax.tree_util.tree_map(np.asarray, rp))
    layout = packing.build_layout(tp, marker)
    ts = bridge.opt_state_to_torch(
        int(rs.step), jax.tree_util.tree_map(np.asarray, dict(rs.slots)),
        layout)
    grads = _grads(params, 2)
    rp, rs = ref_opt.update(jax.tree_util.tree_map(jnp.asarray, grads), rs,
                            rp, stacked=marker)
    tp, ts = opt.update(bridge.params_to_torch(grads), ts, tp,
                        stacked=marker)
    step, slots = bridge.opt_state_to_numpy(ts)
    assert step == int(rs.step) == 3
    for k, v in slots.items():
        _assert_close(v, np.asarray(rs.slots[k]), k)
    tree_map(lambda a, b: _assert_close(a.numpy(), np.asarray(b), "params"),
             tp, rp)


def test_unported_options_raise():
    params, marker = _zoo()
    tp = bridge.params_to_torch(params)
    with pytest.raises(NotImplementedError, match="tree engine"):
        lars(0.1).init(tp)
    with pytest.raises(NotImplementedError, match="master"):
        lars(0.1).init(tp, stacked=marker, master=True)
    with pytest.raises(NotImplementedError, match="int8"):
        sgd(0.1, slot_dtype="int8")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        get_optimizer("lamb")


def test_use_kernels_true_raises_on_cpu_buffers():
    params, marker = _zoo()
    tp = bridge.params_to_torch(params)
    opt = lars(0.1, use_kernels=True)
    state = opt.init(tp, stacked=marker)
    with pytest.raises(ValueError, match="CUDA"):
        opt.update(tp, state, tp)
    with pytest.raises(ValueError, match="must be"):
        lars(0.1, use_kernels="pallas").update(tp, state, tp)


def test_update_rejects_a_different_marker():
    params, marker = _zoo()
    tp = bridge.params_to_torch(params)
    opt = sgd(0.1)
    state = opt.init(tp, stacked=marker)
    with pytest.raises(ValueError, match="disagrees"):
        opt.update(tp, state, tp, stacked=dict(marker, stack=False))


def test_bf16_leaves_round_through_storage_like_the_reference():
    rng = np.random.default_rng(5)
    params = {"h": np.asarray(jnp.asarray(
        rng.standard_normal((9, 130), np.float32), jnp.bfloat16)),
        "w": rng.standard_normal((20, 20), np.float32)}
    marker = {"h": False, "w": False}
    grads = {k: (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
             for k, v in params.items()}
    ref_opt = ref_core.lars(0.5, trust_coefficient=0.05, use_pallas=False)
    rp = jax.tree_util.tree_map(jnp.asarray, params)
    rs = ref_opt.init(rp, stacked=marker)
    rp, rs = ref_opt.update(jax.tree_util.tree_map(jnp.asarray, grads), rs,
                            rp, stacked=marker)
    tp = bridge.params_to_torch(params)
    opt = lars(0.5, trust_coefficient=0.05)
    ts = opt.init(tp, stacked=marker)
    tp, ts = opt.update(bridge.params_to_torch(grads), ts, tp,
                        stacked=marker)
    assert tp["h"].dtype == torch.bfloat16
    np.testing.assert_allclose(tp["h"].float().numpy(),
                               np.asarray(rp["h"], np.float32),
                               rtol=2.0 ** -8, atol=ENGINE_ATOL)
    assert ts.slots[packing.WEIGHT_SLOT].numpy().tobytes() == \
        np.asarray(ref_packing.quantize_to_storage(
            rs.layout, jnp.asarray(ts.slots[packing.WEIGHT_SLOT].numpy()))
        ).tobytes()
