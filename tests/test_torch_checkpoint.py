"""The port's npz checkpoints (``repro_torch.checkpoint``): byte-identical
round trips, the JAX package's file format key for key, and resumes that
cross between the packages in both directions.

Tolerance: a reference state restored into the port continues on the
reference's trajectory as the two packages' steps agree (3 more LARS
steps; the convolutions sum in another order): measured 1.0e-7 relative
in the losses for f32 and int8 slots, and 5.6e-8 absolute in the f32
weights. With int8 slots one momentum code rounded the other way in
those steps, which moved two weights by 3.2e-6. Held at loss rtol 1e-5,
weights atol 1e-6 (f32) and 1e-4 (int8: one code step of the largest
block scale, as in tests/test_torch_quantization.py).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro.checkpoint import restore_train_state as ref_restore
from repro.checkpoint import save_train_state as ref_save
from repro.models.lenet import LeNet as RefLeNet
from repro.train import TrainPipeline as RefPipeline
from repro_torch import bridge
from repro_torch.checkpoint import (clone_checkpoint, restore_train_state,
                                    save_train_state)
from repro_torch.configs import get_config
from repro_torch.core import lars
from repro_torch.data import batch_iterator, synthetic_mnist
from repro_torch.models import build_model
from repro_torch.train import TrainPipeline, train_state_from_params
from repro_torch.treepath import tree_leaves
from _torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-5
ATOL = {"f32": 1e-6, "int8": 1e-4}
CFG = get_config("lenet-mnist")
MODEL = build_model(CFG)
POLICIES = [("f32", "f32"), ("f32", "int8"), ("bf16", "int8")]


def _batches(n, batch=32):
    x, y, _, _ = synthetic_mnist(256, 8, seed=0)
    it = batch_iterator(x, y, batch=batch, seed=0)
    return [next(it) for _ in range(n)]


def _opt(slot_dtype, ref=False):
    kw = dict(momentum=0.9, weight_decay=1e-4, trust_coefficient=0.01,
              slot_dtype=slot_dtype)
    if ref:
        return ref_core.lars(0.05, use_pallas=False, **kw)
    return lars(0.05, **kw)


def _port(precision, slot_dtype, accum=1):
    return TrainPipeline(MODEL, _opt(slot_dtype), CFG, accum_steps=accum,
                         precision=precision)


def _ref(precision, slot_dtype):
    return RefPipeline(RefLeNet(), _opt(slot_dtype, ref=True), CFG,
                       precision=precision, donate=False)


def _port_state(pipe, seed=7):
    params = jax.tree_util.tree_map(np.asarray,
                                    RefLeNet().init(jax.random.key(seed)))
    return train_state_from_params(MODEL, pipe.optimizer,
                                   bridge.params_to_torch(params),
                                   precision=pipe.precision)


def _steps(pipe, state, batches, torch_side=True):
    losses = []
    for b in batches:
        b = {k: torch.from_numpy(v) for k, v in b.items()} if torch_side \
            else {k: jnp.asarray(v) for k, v in b.items()}
        state, m = pipe(state, b)
        losses.append(float(m["loss"]))
    return state, losses


def _bytes(state):
    out = {f"p{i}": (x.dtype, x.float().numpy().tobytes())
           for i, x in enumerate(tree_leaves(state.params))}
    out.update({k: (v.dtype, v.numpy().tobytes())
                for k, v in state.opt_state.slots.items()})
    out["step"] = state.opt_state.step
    return out


@pytest.mark.parametrize("precision,slot_dtype", POLICIES)
def test_roundtrip_is_byte_identical_and_resumes_bit_for_bit(
        tmp_path, precision, slot_dtype):
    pipe = _port(precision, slot_dtype, accum=2)
    state, _ = _steps(pipe, _port_state(pipe), _batches(2, 64))
    path = str(tmp_path / "sub" / "state")
    save_train_state(path, state)
    assert sorted(os.listdir(tmp_path / "sub")) == ["state.npz"]  # no tmp
    back = restore_train_state(path, _port_state(pipe, seed=3))
    assert _bytes(back) == _bytes(state)
    assert back.opt_state.layout == state.opt_state.layout
    if slot_dtype == "int8":
        assert back.opt_state.slots["momentum"].dtype == torch.int8
    more = _batches(4, 64)[2:]
    a, la = _steps(pipe, state, more)
    b, lb = _steps(pipe, back, more)
    assert la == lb and _bytes(a) == _bytes(b)


@pytest.mark.parametrize("precision,slot_dtype", POLICIES)
def test_keys_are_the_references(tmp_path, precision, slot_dtype):
    ref_state = _ref(precision, slot_dtype).init_state(jax.random.key(7))
    ref_save(str(tmp_path / "ref.npz"), ref_state)
    save_train_state(str(tmp_path / "port.npz"),
                     _port_state(_port(precision, slot_dtype)))
    with np.load(tmp_path / "ref.npz") as r, \
            np.load(tmp_path / "port.npz") as p:
        assert p.files == r.files
        for k in r.files:
            assert (p[k].shape, p[k].dtype) == (r[k].shape, r[k].dtype), k
        assert ".opt_state/.step" in p.files
        assert ".params/conv1/w" in p.files


@pytest.mark.parametrize("slot_dtype", ["f32", "int8"])
def test_reference_checkpoint_resumes_on_the_references_trajectory(
        tmp_path, slot_dtype):
    batches = _batches(5)
    ref_pipe = _ref("f32", slot_dtype)
    ref_state, _ = _steps(ref_pipe, ref_pipe.init_state(jax.random.key(7)),
                          batches[:2], torch_side=False)
    path = str(tmp_path / "ref.npz")
    ref_save(path, ref_state)
    pipe = _port("f32", slot_dtype)
    state = restore_train_state(path, _port_state(pipe, seed=3))
    assert state.opt_state.step == 2
    with np.load(path) as data:            # codes and scales byte-equal
        for k, v in state.opt_state.slots.items():
            assert v.numpy().tobytes() == \
                data[".opt_state/.slots/" + k].tobytes(), k
    ref_state, ref_losses = _steps(ref_pipe, ref_state, batches[2:],
                                   torch_side=False)
    state, losses = _steps(pipe, state, batches[2:])
    np.testing.assert_allclose(losses, ref_losses, rtol=RTOL)
    np.testing.assert_allclose(
        state.opt_state.slots["packed_weights"].numpy(),
        np.asarray(ref_state.opt_state.slots["packed_weights"]),
        rtol=0, atol=ATOL[slot_dtype])


@pytest.mark.parametrize("precision,slot_dtype", POLICIES)
def test_port_checkpoint_restores_into_the_reference(tmp_path, precision,
                                                     slot_dtype):
    pipe = _port(precision, slot_dtype)
    state, _ = _steps(pipe, _port_state(pipe), _batches(2))
    path = str(tmp_path / "port.npz")
    save_train_state(path, state)
    template = _ref(precision, slot_dtype).init_state(jax.random.key(0))
    back = ref_restore(path, template)
    assert int(back.opt_state.step) == 2
    for k, v in state.opt_state.slots.items():
        got = np.asarray(back.opt_state.slots[k])
        assert got.dtype == v.numpy().dtype
        assert got.tobytes() == v.numpy().tobytes(), k
    for a, b in zip(tree_leaves(state.params),
                    jax.tree_util.tree_leaves(back.params)):
        assert str(np.asarray(b).dtype) == str(a.dtype).removeprefix(
            "torch.")
        assert np.asarray(b).astype(np.float32).tobytes() == \
            a.float().numpy().tobytes()


def test_restore_refuses_what_the_template_cannot_hold(tmp_path):
    bf16 = _port("bf16", "f32")
    save_train_state(str(tmp_path / "bf16"), _port_state(bf16))
    with pytest.raises(ValueError, match="cannot hold"):
        restore_train_state(str(tmp_path / "bf16"),
                            _port_state(_port("f32", "f32")))
    with pytest.raises(ValueError, match="lacks"):
        restore_train_state(str(tmp_path / "bf16"),
                            _port_state(_port("bf16", "int8")))
    f32 = _port_state(_port("f32", "f32"))
    np.savez(tmp_path / "bad.npz", **{
        k: (np.zeros((3,), np.float32) if k == ".params/fc3/b" else v)
        for k, v in np.load(_save(tmp_path, f32)).items()})
    with pytest.raises(ValueError, match="shape"):
        restore_train_state(str(tmp_path / "bad.npz"), f32)


def _save(tmp_path, state):
    path = str(tmp_path / "ok.npz")
    save_train_state(path, state)
    return path


def test_clone_checkpoint_copies_atomically(tmp_path):
    src = _save(tmp_path, _port_state(_port("f32", "int8")))
    clone_checkpoint(src, str(tmp_path / "cells" / "b"))
    assert sorted(os.listdir(tmp_path / "cells")) == ["b.npz"]
    with open(src, "rb") as a, open(tmp_path / "cells" / "b.npz", "rb") as b:
        assert a.read() == b.read()


# --------------------------------------------- every LM family, and ZeRO

FAMILIES = ["granite-moe-3b-a800m", "deepseek-v2-236b", "falcon-mamba-7b",
            "zamba2-7b", "whisper-base", "paligemma-3b"]


def _npz_members(path) -> list:
    """An npz file's members in order, each its stored bytes: the file's
    content without the zip entries' write times."""
    import zipfile
    with zipfile.ZipFile(path) as z:
        return [(n, z.read(n)) for n in z.namelist()]


def _ref_template(arch, slot_dtype, zero_shards=1):
    """The reference's fresh packed state of the reduced config."""
    from repro.configs import get_config as ref_get_config
    from repro.models import build_model as ref_build
    from repro.train import TrainState as RefTrainState
    cfg = ref_get_config(arch).reduced()
    model = ref_build(cfg)
    params = model.init(jax.random.key(0))
    opt = ref_core.lars(0.01, use_pallas=False, slot_dtype=slot_dtype)
    kw = {"zero_shards": zero_shards} if zero_shards > 1 else {}
    return RefTrainState(params, opt.init(
        params, stacked=model.stacked_marker(
            jax.eval_shape(model.init, jax.random.key(0))), **kw))


@pytest.mark.parametrize("case", [f"{a}-{d}" for a in FAMILIES
                                  for d in ("f32", "int8")]
                         + ["granite-moe-3b-a800m-zero4"])
def test_every_lm_family_checkpoint_restores_in_the_reference(
        tmp_path, case, one_torch_thread):
    """``launch.train --reduced --checkpoint`` on the CPU for each LM
    family, f32 and int8 slots: the file restores in the reference's
    ``restore_train_state`` and the reference's re-save is the same file,
    member for member. The ZeRO case trains a 4-shard layout (padded,
    no mesh: updated whole) one step through ``TrainPipeline`` and
    restores into the reference's 4-shard template."""
    from repro_torch.launch import train
    arch, _, slot_dtype = case.rpartition("-")
    path = str(tmp_path / "state.npz")
    if slot_dtype == "zero4":
        from repro_torch.models import build_model as port_build
        cfg = get_config(arch).reduced()
        model = port_build(cfg)
        opt = lars(0.01)
        pipe = TrainPipeline(model, opt, cfg)
        state = train_state_from_params(
            model, opt, model.init(torch.Generator().manual_seed(0), "cpu"),
            zero_shards=4)
        assert state.opt_state.layout.pad_rows > 0
        tokens = torch.randint(0, cfg.vocab_size, (2, 8),
                               generator=torch.Generator().manual_seed(1))
        state, m = pipe(state, {"tokens": tokens})
        assert np.isfinite(float(m["loss"]))
        save_train_state(path, state)
        template = _ref_template(arch, "f32", zero_shards=4)
    else:
        out = train.main(["--arch", arch, "--reduced", "--device", "cpu",
                          "--steps", "1", "--batch", "2", "--seq", "8",
                          "--log-every", "0", "--optimizer", "lars",
                          "--opt-state-dtype", slot_dtype, "--checkpoint",
                          path])
        assert np.isfinite(out["losses"][0])
        template = _ref_template(arch, slot_dtype)
    back = ref_restore(path, template)
    assert int(back.opt_state.step) == 1
    ref_save(str(tmp_path / "again.npz"), back)
    assert _npz_members(tmp_path / "again.npz") == _npz_members(path)
