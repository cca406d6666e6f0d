"""The port's entry point, ``repro_torch.launch.train``, end to end on
the CPU (LeNet, the reduced smollm with LAMB, AdamW and the large-batch
LARS path, and the reduced qwen3 through the memory-lean path that
``--set`` turns on); its refusal of what it does not cover; its
``--set`` parser; and its LR recipe against the JAX entry point's (rtol
1e-6: the same f32 schedule)."""

import argparse
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.train import make_lr_schedule as ref_make_lr_schedule
from repro_torch.configs import get_config
from repro_torch.launch import train
from repro_torch.launch.overrides import (apply_overrides, parse_overrides,
                                          parse_val)
from _torch_threads import one_torch_thread  # noqa: F401

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
    ["--mesh", "2x1"], ["--mesh", "1x1"],
    ["--arch", "whisper-base", "--reduced"],
    ["--arch", "smollm-135m", "--reduced", "--set", "family=encdec",
     "--set", "encoder_layers=1", "--set", "encoder_seq=8"],
    ["--arch", "paligemma-3b", "--reduced"]])
def test_unported_options_raise(extra):
    """--mesh needs the ranks of its mesh: without a process group the
    process is one rank, so 2x1 fails with the reference's message and
    1x1 trains (data parallelism over more ranks:
    tests/test_torch_zero.py). The encdec and vlm families, which raised
    here until they were ported, now train (tests/test_torch_encdec.py,
    tests/test_torch_vlm.py hold them against the reference): whisper-base
    and paligemma-3b reduced, and smollm turned into an encoder-decoder
    by ``--set``, each one step on zero stub frames or image
    embeddings."""
    if extra == ["--mesh", "2x1"]:
        with pytest.raises(SystemExit, match="needs 2 devices, have 1"):
            train.main(CPU + ["--steps", "1"] + extra)
        return
    if "--mesh" in extra:
        out = train.main(CPU + ["--steps", "1", "--zero"] + extra)
        assert out["mesh"] == {"data": 1, "model": 1} and out["zero"]
        assert math.isfinite(out["losses"][0])
        return
    out = train.main(CPU + ["--steps", "1", "--batch", "2", "--seq", "8"]
                     + extra)
    assert out["params"] > 0 and math.isfinite(out["losses"][0])


@pytest.mark.parametrize("optimizer,extra", [
    ("lamb", []), ("adamw", []),
    ("lars", ["--opt-state-dtype", "int8", "--accum-steps", "2",
              "--precision", "bf16"])])
def test_main_trains_the_reduced_lm_on_the_cpu(optimizer, extra,
                                                one_torch_thread):
    out = train.main(["--arch", "smollm-135m", "--reduced", "--device",
                      "cpu", "--log-every", "0", "--steps", "2", "--batch",
                      "4", "--seq", "16", "--optimizer", optimizer] + extra)
    assert out["arch"] == "smollm-135m-reduced" and out["optimizer"] == \
        optimizer
    assert len(out["losses"]) == 2 and all(map(math.isfinite, out["losses"]))
    assert out["eval_accuracy"] is None and out["seq"] == 16
    assert out["tokens_per_s"] == pytest.approx(out["steps_per_s"] * 64)


# the same f32 function as the stock path, sums in another order:
# measured 1.4e-7 relative over the two steps
LEAN_RTOL = 1e-6


def test_main_trains_reduced_qwen3_through_the_lean_path(one_torch_thread):
    """All four knobs through --set, applied after --reduced: the losses
    of the stock path, and remat_block=2 nests the two layers' remat."""
    flags = ["--arch", "qwen3-14b", "--reduced", "--device", "cpu",
             "--log-every", "0", "--steps", "2", "--batch", "4", "--seq",
             "16", "--optimizer", "lars"]
    lean = ["--set", "flash_vjp=true", "--set", "attn_q_chunk=8",
            "--set", "loss_chunk=4", "--set", "remat_block=2"]
    out = train.main(flags + lean)
    stock = train.main(flags)
    assert out["arch"] == "qwen3-14b-reduced"
    assert all(map(math.isfinite, out["losses"]))
    np.testing.assert_allclose(out["losses"], stock["losses"],
                               rtol=LEAN_RTOL)


def test_shared_set_parser():
    """The reference's cases (tests/test_pipeline.py) against the port's
    parser."""
    assert parse_val("true") is True and parse_val("False") is False
    assert parse_val("8") == 8 and parse_val("0.5") == 0.5
    assert parse_val("cosine") == "cosine"
    assert parse_overrides(["a=1", "b=x=y"]) == {"a": 1, "b": "x=y"}
    with pytest.raises(ValueError, match="FIELD=VALUE"):
        parse_overrides(["oops"])
    cfg = get_config("smollm-135m")
    assert apply_overrides(cfg, ["remat_block=8"]).remat_block == 8
    assert apply_overrides(cfg, []) is cfg


def test_large_batch_flags_checkpoint_and_resume(tmp_path):
    """int8 slots, 4 accumulated microbatches, bf16 compute: train,
    save the full TrainState, resume from it and go on."""
    path = str(tmp_path / "ck" / "state.npz")
    flags = CPU + ["--optimizer", "lars", "--opt-state-dtype", "int8",
                   "--accum-steps", "4", "--precision", "bf16",
                   "--batch", "64"]
    out = train.main(flags + ["--steps", "3", "--checkpoint", path])
    assert (out["accum_steps"], out["precision"], out["opt_state_dtype"],
            out["resumed_from_step"]) == (4, "bf16", "int8", 0)
    assert all(math.isfinite(x) for x in out["losses"])
    with np.load(path) as data:
        assert data[".opt_state/.slots/momentum"].dtype == np.int8
        assert ".opt_state/.slots/master" in data.files
        assert int(data[".opt_state/.step"]) == 3
    out = train.main(flags + ["--steps", "2", "--resume", path,
                              "--checkpoint", path])
    assert out["resumed_from_step"] == 3
    assert len(out["losses"]) == 2 and all(map(math.isfinite,
                                                out["losses"]))
    with np.load(path) as data:
        assert int(data[".opt_state/.step"]) == 5
    with pytest.raises(ValueError, match="cannot hold"):
        train.main(CPU + ["--steps", "1", "--resume", path])
    with pytest.raises(SystemExit):
        train.main(CPU + ["--steps", "1", "--batch", "30",
                          "--accum-steps", "4"])


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
