"""The port, as a whole, reproduces the JAX package's golden cnn pins
(``tests/golden/{sgd,lars}_b{32,128}.json`` and the int8-momentum pin
``tests/golden/lars_int8_b32.json``).

The workload is tests/test_golden.py's: ``synthetic_mnist(256, 8,
seed=0)``, ``batch_iterator`` seed 0, 20 steps at LR 0.05, trust
coefficient 0.01, weight decay 1e-4, momentum 0.9, from the reference's
``LeNet.init(jax.random.key(7))`` carried across (PyTorch cannot draw
``jax.random``'s numbers). The pins were drawn with JAX's legacy
(non-partitionable) threefry, the default before jax 0.5; the init is
drawn under that setting, so the run does not depend on the installed
jax's default. Steps go through the port's ``TrainPipeline``, as the
reference's pins do (int8: ``lars(slot_dtype="int8")``, momentum as
codes + per-block scales, one ``apply_flat_q8`` pass per step); the
final trust table is Eq. 3 on the last step's pre-update params and
gradients, as ``grad_stats.stats_hook`` computes it. Held at the pin
file's own ``RTOLS``/``TRUST_RTOLS``.

Measured drift from the pins on the CPU: b32 losses <= 2.1e-7 relative
and trust ratios <= 8.6e-7 (sgd and lars); b128 losses 5.7e-4 (sgd) and
2.6e-5 (lars), trust ratios 2.6e-2 (sgd) and 3.2e-3 (lars). The b128
runs train hard enough that f32 summation-order differences between
XLA's and PyTorch's convolutions compound, the same class of drift the
reference measures between 1 and 8 forced devices (its 5e-3 / 0.1
tolerances).

The int8 b32 pin holds only part of the way. Steps 0-13 track it as the
f32 pins do (<= 1.1e-7 relative). The gradients of the two packages
differ by 1e-7-2e-6 relative (conv sum order), and int8 turns that into
whole code steps: the first momentum code that rounds the other way
against the reference lands at step 11. A flipped code moves its value
by one step of the block scale (1/127 of the block's absmax), and where
that value becomes the block's absmax every code of the block moves.
Steps 14-17 then drift 8e-7-1.1e-5, steps 18-19 1.4e-4 and 2.8e-4, and
the final trust table 3.4e-3 — over the pin's 1e-4 / 1e-3 (the
reference meets those only against itself, where its convolutions sum
in one order). So the first ``INT8_PIN_STEPS`` losses are held at the
pin's own tolerance, and the whole trajectory and trust table at the
measured drift's bounds, ``INT8_DRIFT_RTOL`` / ``INT8_TRUST_RTOL``.
"""

import jax
import numpy as np
import pytest
import torch

from repro.models.lenet import LeNet as RefLeNet
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import lars, sgd, trust_ratio as tr
from repro_torch.data import batch_iterator, synthetic_mnist
from repro_torch.models import build_model
from repro_torch.train import TrainPipeline, train_state_from_params
from repro_torch.train.step import value_and_grad
from test_golden import (ATOL, LR, RTOLS, STEPS, TRUST_COEF, TRUST_RTOLS,
                         WEIGHT_DECAY, _compare, _load_golden)

# tests/test_golden.py: a 1e-3 LR perturbation moves the b32 lars losses
# by 1.6e-3 relative; the port's own drift must stay well below it
PERTURBATION_SHIFT = 1.6e-3
# int8 pin (see the module docstring): steps held at the pin's own rtol,
# then the measured drift's bounds (2.8e-4 losses, 3.4e-3 trust)
INT8_PIN_STEPS = 14
INT8_DRIFT_RTOL, INT8_TRUST_RTOL = 1e-3, 2e-2


def run_trajectory(opt_name: str, batch: int, *, lr: float = LR) -> dict:
    cfg = get_config("lenet-mnist")
    model = build_model(cfg)
    kw = dict(momentum=0.9, weight_decay=WEIGHT_DECAY)
    opt = sgd(lr, **kw) if opt_name == "sgd" else \
        lars(lr, trust_coefficient=TRUST_COEF, **kw,
             slot_dtype="int8" if opt_name == "lars_int8" else "f32")
    with jax.threefry_partitionable(False):
        init = RefLeNet().init(jax.random.key(7))
    step = TrainPipeline(model, opt, cfg)
    state = train_state_from_params(model, opt, bridge.params_to_torch(
        jax.tree_util.tree_map(np.asarray, init)))
    x_tr, y_tr, _, _ = synthetic_mnist(256, 8, seed=0)
    it = batch_iterator(x_tr, y_tr, batch=batch, seed=0)
    losses, trust = [], {}
    for i in range(STEPS):
        b = {k: torch.from_numpy(v) for k, v in next(it).items()}
        if i == STEPS - 1:
            _, grads, _ = value_and_grad(model, cfg, state.params, b)
            for layer, leaves in state.params.items():
                w, g = leaves["w"], grads[layer]["w"]
                ratio = tr.lars_trust_ratio(*tr.layer_norms(w, g, False),
                                            eta=TRUST_COEF,
                                            weight_decay=WEIGHT_DECAY)
                trust[f"{layer}/w"] = [float(ratio)]
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
    return {"losses": losses, "final_trust": trust}


@pytest.mark.parametrize("opt_name,batch", [("sgd", 32), ("sgd", 128),
                                            ("lars", 32), ("lars", 128)])
def test_port_reproduces_golden_pin(opt_name, batch):
    got = run_trajectory(opt_name, batch)
    golden = _load_golden("cnn", opt_name, batch)
    _compare(got, golden, rtol=RTOLS[("cnn", batch)],
             trust_rtol=TRUST_RTOLS[("cnn", batch)],
             label=f"port {opt_name}/b{batch}")
    if batch == 32:
        drift = np.max(np.abs(np.subtract(got["losses"], golden["losses"]))
                       / np.abs(golden["losses"]))
        assert drift < PERTURBATION_SHIFT / 10, drift


def _compare_int8(got, golden, steps=INT8_PIN_STEPS):
    _compare({"losses": got["losses"][:steps],
              "final_trust": got["final_trust"]},
             {"losses": golden["losses"][:steps],
              "final_trust": golden["final_trust"]},
             rtol=RTOLS[("cnn", 32)], trust_rtol=INT8_TRUST_RTOL,
             label="port lars_int8/b32")
    _compare(got, golden, rtol=INT8_DRIFT_RTOL, trust_rtol=INT8_TRUST_RTOL,
             label="port lars_int8/b32, whole trajectory")


def test_port_tracks_the_int8_golden_pin():
    """Through TrainPipeline with int8 momentum (apply_flat_q8's plain
    version on the CPU): the pin's own tolerance for the first
    INT8_PIN_STEPS losses, the measured int8 drift bound after."""
    _compare_int8(run_trajectory("lars_int8", 32),
                  _load_golden("cnn", "lars_int8", 32))


def test_lr_perturbation_breaks_the_port_pin():
    """The pin keeps its teeth on the port: lr + 1e-3 leaves the b32 lars
    tolerance, as it does for the reference."""
    _assert_perturbation_breaks("lars")


def test_lr_perturbation_breaks_the_port_int8_pin():
    """The int8 check keeps teeth too: lr + 1e-3 moves the held steps by
    up to 9.9e-4 (5x the pin's rtol and more) and the trust table by
    6.1e-2 (3x INT8_TRUST_RTOL); both parts of the check fail."""
    golden = _load_golden("cnn", "lars_int8", 32)
    got = run_trajectory("lars_int8", 32, lr=LR + 1e-3)
    rel = np.abs(np.subtract(got["losses"], golden["losses"])) \
        / np.abs(golden["losses"])
    assert rel[:INT8_PIN_STEPS].max() > 5 * RTOLS[("cnn", 32)], rel.max()
    with pytest.raises(AssertionError):
        _compare_int8(got, golden)
    with pytest.raises(AssertionError, match="trust"):
        _compare(got, golden, rtol=1.0, trust_rtol=INT8_TRUST_RTOL,
                 label="perturbed")


def _assert_perturbation_breaks(opt_name):
    golden = _load_golden("cnn", opt_name, 32)
    got = run_trajectory(opt_name, 32, lr=LR + 1e-3)
    rel = np.abs(np.subtract(got["losses"], golden["losses"])) \
        / np.abs(golden["losses"])
    assert rel.max() > 10 * RTOLS[("cnn", 32)], rel.max()
    with pytest.raises(AssertionError):
        _compare(got, golden, rtol=RTOLS[("cnn", 32)],
                 trust_rtol=TRUST_RTOLS[("cnn", 32)], label="perturbed")
    assert ATOL == 1e-6
