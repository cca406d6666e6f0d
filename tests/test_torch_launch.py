"""The port's entry point, ``repro_torch.launch.train``, end to end on
the CPU; its refusal of what it does not cover; and its LR recipe
against the JAX entry point's (rtol 1e-6: the same f32 schedule)."""

import argparse
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.train import make_lr_schedule as ref_make_lr_schedule
from repro_torch.launch import train

CPU = ["--arch", "lenet-mnist", "--device", "cpu", "--log-every", "0"]


def test_main_trains_on_the_cpu_when_asked():
    out = train.main(CPU + ["--steps", "3", "--batch", "32"])
    assert len(out["losses"]) == 3
    assert all(math.isfinite(x) for x in out["losses"])
    assert 0.0 <= out["eval_accuracy"] <= 1.0
    assert out["params"] == 107_786 and out["device"] == "cpu"
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def test_main_runs_on_cuda_unless_asked_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(["--arch", "lenet-mnist", "--steps", "1"])


@pytest.mark.parametrize("extra", [
    ["--reduced"], ["--accum-steps", "2"], ["--precision", "bf16"],
    ["--opt-state-dtype", "int8"], ["--mesh", "1x1"],
    ["--checkpoint", "ckpt.npz"], ["--resume", "ckpt.npz"],
    ["--set", "num_layers=3"], ["--optimizer", "lamb"],
    ["--arch", "smollm-135m"]])
def test_unported_options_raise(extra):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        train.main(CPU + ["--steps", "1"] + extra)


@pytest.mark.parametrize("warmup,policy", [(0, "none"), (0, "linear"),
                                           (5, "linear"), (3, "sqrt")])
def test_lr_schedule_matches_reference(warmup, policy):
    args = argparse.Namespace(lr=0.01, base_batch=32, batch=8192,
                              steps=20, warmup=warmup, lr_policy=policy)
    got, want = train.make_lr_schedule(args), ref_make_lr_schedule(args)
    for step in range(20):
        np.testing.assert_allclose(
            got(step), np.asarray(want(jnp.asarray(step, jnp.int32))),
            rtol=1e-6)
