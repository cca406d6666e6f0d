"""The port's distribution layer against ``repro.distributed`` and
``repro.launch.mesh``, and data-parallel ZeRO training on four CPU ranks.

In process: ``param_pspecs`` (every registered config at full width,
shapes from the meta device, without a mesh and on the reference tests'
16 x 16 stand-in mesh, whose divisibility guard drops axes such as
whisper's vocab), ``serve_param_pspecs``, ``batch_pspecs`` (a data axis
that divides the batch and one that does not), ``cache_pspecs`` and
``state_pspecs`` (packed f32/int8, ZeRO and tree states) equal the
reference's ``PartitionSpec``s leaf for leaf (tolerance: none, they are
names). ``mesh_from_spec`` parses as the reference does and fails with
its messages; a spec's rows on a rank are its block of dim 0.

Spawned (``tests/_torch_dist_worker.py``, four gloo ranks, one torch
thread each): every LeNet golden pin (``tests/golden/{sgd,lars}_b{32,
128}.json``, ``lars_int8_b32.json``) reproduces with ``zero=True`` on a
(4, 1) mesh at the reference's mesh tolerances ``MESH_RTOL`` /
``MESH_TRUST_RTOL`` (LeNet's 272 rows pad to 288 under four shards: 72
a rank); ``fuse_update=True`` runs on the (4, 1) mesh and tracks the
unfused replicated step at ``MESH_RTOL`` (the reference's
``_fused_zero_check``), and raises ValueError on a (2, 2) mesh.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import lars as ref_lars
from repro.distributed import sharding as ref_sharding
from repro.launch import mesh as ref_mesh
from repro.models import build_model as ref_build
from repro.models.lenet import LeNet as RefLeNet
from repro.train.state import TrainState as RefTrainState
from repro_torch.configs import ARCHS, get_config
from repro_torch.core import lars
from repro_torch.distributed import constrain, sharding
from repro_torch.launch import mesh as port_mesh
from repro_torch.models import build_model
from repro_torch.train import TrainState
from repro_torch.treepath import tree_flatten_with_path
from test_golden import (ATOL, MESH_RTOL, MESH_TRUST_RTOL, _compare,
                         _load_golden)
import _torch_dist_worker as worker
from _torch_threads import one_torch_thread  # noqa: F401

# one intra-op thread: the suite runs files in parallel workers, and
# the spawned ranks take a core each
pytestmark = pytest.mark.usefixtures("one_torch_thread")
CONFIGS = sorted(ARCHS)


class FakeMesh:
    """The reference tests' 16 x 16 stand-in (no process group has it)."""
    shape = {"data": 16, "model": 16}
    axis_names = ("data", "model")


class ThreeMesh:
    """A data axis of 3: divides no even batch."""
    shape = {"data": 3, "model": 1}
    axis_names = ("data", "model")


def _spec_paths(specs) -> dict:
    """path -> spec as a plain tuple, for either package's spec tree."""
    if isinstance(specs, sharding.PartitionSpec):
        return {(): tuple(specs)}
    is_p = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa
    flat = jax.tree_util.tree_flatten_with_path(specs, is_leaf=is_p)[0]
    if flat and is_p(flat[0][1]):
        return {tuple(str(getattr(k, "key", getattr(k, "name", k)))
                      for k in p): tuple(v) for p, v in flat}
    leaves, _ = tree_flatten_with_path(specs)
    return {tuple(p): tuple(v) for p, v in leaves}


def _assert_same(port, ref) -> None:
    got, want = _spec_paths(port), _spec_paths(ref)
    assert got.keys() == want.keys()
    diff = {p: (got[p], want[p]) for p in want if got[p] != want[p]}
    assert not diff, diff


def _shapes(arch):
    """(port meta params, reference ShapeDtypeStructs) of a full config."""
    cfg = get_config(arch)
    port = build_model(cfg).init(torch.Generator().manual_seed(0), "meta")
    ref = jax.eval_shape(ref_build(ref_get_config(arch)).init,
                         jax.random.key(0))
    return cfg, port, ref


# ------------------------------------------------------------- specs

@pytest.mark.parametrize("mesh", [None, FakeMesh()], ids=["none", "16x16"])
@pytest.mark.parametrize("arch", CONFIGS)
def test_param_pspecs_match_reference(arch, mesh):
    cfg, port, ref = _shapes(arch)
    _assert_same(sharding.param_pspecs(cfg, port, mesh),
                 ref_sharding.param_pspecs(ref_get_config(arch), ref, mesh))


@pytest.mark.parametrize("arch", CONFIGS)
def test_serve_param_pspecs_match_reference(arch):
    cfg, port, ref = _shapes(arch)
    _assert_same(sharding.serve_param_pspecs(cfg, port, FakeMesh()),
                 ref_sharding.serve_param_pspecs(ref_get_config(arch), ref,
                                                 FakeMesh()))


@pytest.mark.parametrize("batch", [48, 64, 1])
@pytest.mark.parametrize("arch", ["lenet-mnist", "smollm-135m",
                                  "whisper-base", "paligemma-3b"])
def test_batch_pspecs_match_reference(arch, batch):
    for mesh in (FakeMesh(), ThreeMesh()):
        _assert_same(sharding.batch_pspecs(get_config(arch), mesh,
                                           batch=batch),
                     ref_sharding.batch_pspecs(ref_get_config(arch), mesh,
                                               batch=batch))


@pytest.mark.parametrize("batch", [32, 3])
@pytest.mark.parametrize("arch", [a for a in CONFIGS if a != "lenet-mnist"])
def test_cache_pspecs_match_reference(arch, batch):
    cfg = get_config(arch).reduced()
    port = build_model(cfg).init_cache(batch, 64, device="meta")
    rcfg = ref_get_config(arch).reduced()
    ref = jax.eval_shape(lambda: ref_build(rcfg).init_cache(batch, 64))
    _assert_same(sharding.cache_pspecs(cfg, FakeMesh(), port, batch=batch),
                 ref_sharding.cache_pspecs(rcfg, FakeMesh(), ref,
                                           batch=batch))


@pytest.mark.parametrize("kind", ["packed-f32", "packed-int8", "zero-f32",
                                  "zero-int8", "tree-f32", "tree-int8"])
@pytest.mark.parametrize("arch", ["lenet-mnist", "smollm-135m"])
def test_state_pspecs_match_reference(arch, kind):
    layout, dtype = kind.split("-")
    cfg = get_config(arch) if arch == "lenet-mnist" \
        else get_config(arch).reduced()
    rcfg = ref_get_config(arch) if arch == "lenet-mnist" \
        else ref_get_config(arch).reduced()
    model, rmodel = build_model(cfg), ref_build(rcfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    rparams = rmodel.init(jax.random.key(0))
    shards = 16 if layout == "zero" else 1
    kw = {"zero_shards": shards} if shards > 1 else {}
    packed = layout != "tree"
    opt = lars(0.1, slot_dtype=dtype)
    ropt = ref_lars(0.1, slot_dtype=dtype, use_pallas=False)
    state = TrainState(params, opt.init(
        params, stacked=model.stacked_marker(params) if packed else None,
        **kw))
    rstate = RefTrainState(rparams, ropt.init(
        rparams, stacked=rmodel.stacked_marker(rparams) if packed else None,
        **kw))
    got = sharding.state_pspecs(cfg, state, FakeMesh())
    want = ref_sharding.state_pspecs(rcfg, jax.eval_shape(lambda: rstate),
                                     FakeMesh())
    _assert_same(got.params, want.params)
    assert tuple(got.opt_state.step) == tuple(want.opt_state.step)
    assert sorted(got.opt_state.slots) == sorted(want.opt_state.slots)
    for k in want.opt_state.slots:
        _assert_same(got.opt_state.slots[k], want.opt_state.slots[k])
    if layout == "zero":
        assert tuple(got.opt_state.slots["momentum"]) == ("data", None)


# -------------------------------------------------------------- meshes

def _exit_message(fn, *args, **kw) -> str:
    with pytest.raises(SystemExit) as e:
        fn(*args, **kw)
    return str(e.value)


@pytest.mark.parametrize("spec", ["2x1", "8x1", "1x2", "4x4"])
def test_mesh_from_spec_needs_the_ranks(spec):
    """Too few ranks: the reference's message, word for word (one JAX CPU
    device there, one rank here)."""
    assert len(jax.devices()) == 1
    assert _exit_message(port_mesh.mesh_from_spec, spec, device="cpu") == \
        _exit_message(ref_mesh.mesh_from_spec, spec)


@pytest.mark.parametrize("spec,allow_none", [
    ("bogus", False), ("2y1", True), ("x", False), ("none", False)])
def test_mesh_from_spec_bad_spec(spec, allow_none):
    assert _exit_message(port_mesh.mesh_from_spec, spec,
                         allow_none=allow_none, device="cpu") == \
        _exit_message(ref_mesh.mesh_from_spec, spec, allow_none=allow_none)


@pytest.mark.parametrize("spec", ["auto", "1x1"])
def test_mesh_from_spec_one_rank(spec):
    """Without a process group the process is one rank: auto and 1x1 give
    the reference's one-device mesh, whose collectives send nothing."""
    ref = ref_mesh.mesh_from_spec(spec)
    got = port_mesh.mesh_from_spec(spec, device="cpu")
    assert dict(got.shape) == dict(ref.shape)
    assert got.axis_names == tuple(ref.axis_names)
    assert got.coords == {"data": 0, "model": 0} and got.rank == 0
    assert got.groups == {"data": None, "model": None}
    assert port_mesh.mesh_from_spec("none", allow_none=True) is None
    assert dict(port_mesh.make_host_mesh(device="cpu").shape) == \
        dict(ref_mesh.make_host_mesh().shape)


def test_production_mesh_and_default_device():
    with pytest.raises(RuntimeError) as got:
        port_mesh.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError) as want:
        ref_mesh.make_production_mesh()
    assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError, match="pod"):
        port_mesh.make_production_mesh(multi_pod=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_mesh.mesh_from_spec("1x1")


def test_ambient_mesh_and_identity_constraints():
    mesh = port_mesh.mesh_from_spec("1x1", device="cpu")
    x = torch.arange(6.0).reshape(3, 2)
    assert constrain.current_mesh() is None
    with mesh:
        assert constrain.current_mesh() is mesh
        assert constrain.shard_batch(x, last="model") is x
        assert constrain.shard_spec(x, "data", None) is x
    assert constrain.current_mesh() is None
    assert constrain.shard_batch(x) is x


def test_row_sharding_takes_this_ranks_block():
    """A spec on rank 2 of a (4, 1) mesh (built by hand: no process group
    here) holds rows [2n/4, 3n/4) of a split batch and every row of a
    replicated one; a split past dim 0 over a larger axis (tensor
    parallelism) cuts that dim: rank (1, 1) of a (2, 2) mesh holds the
    second half of a leaf's columns."""
    mesh = port_mesh.Mesh(shape={"data": 4, "model": 1},
                          coords={"data": 2, "model": 0}, groups={},
                          device=torch.device("cpu"))
    cfg = get_config("lenet-mnist")
    for batch, split in ((32, True), (30, False)):
        specs = sharding.batch_pspecs(cfg, mesh, batch=batch)
        b = {"x": np.arange(batch * 784.0).reshape(batch, 28, 28, 1),
             "y": np.arange(batch)}
        local = sharding.shard_rows(b, sharding.tree_named(mesh, specs))
        assert local.sharded is split and local.global_rows == batch
        want = np.arange(16, 24) if split else np.arange(batch)
        np.testing.assert_array_equal(local["y"], want)
    wide = port_mesh.Mesh(shape={"data": 2, "model": 2},
                          coords={"data": 1, "model": 1}, groups={},
                          device=torch.device("cpu"))
    assert sharding.named(wide, sharding.P(("data",), None)).rows(8) == \
        slice(4, 8)
    cols = sharding.named(wide, sharding.P(None, "model"))
    leaf = torch.arange(24.0).reshape(3, 8)
    assert torch.equal(cols.shard(leaf), leaf[:, 4:])
    assert cols.split and not cols.sharded
    assert cols.whole_shape((3, 4)) == (3, 8)


def test_model_axis_refuses_the_families_not_yet_split():
    """On a model axis above 1 the ssm, hybrid, encdec and vlm families
    (every family but the dense one, the moe one, MLA included, and
    LeNet) raise naming queue 1 item 4b-ii; the mesh is built by hand
    (constructing the pipeline sends nothing). deepseek's MLA splits its
    heads: ``q_up``'s columns over the two ranks."""
    from repro_torch.train import TrainPipeline
    mesh = port_mesh.Mesh(shape={"data": 1, "model": 2},
                          coords={"data": 0, "model": 1}, groups={},
                          device=torch.device("cpu"))
    for arch in ("falcon-mamba-7b", "zamba2-7b", "whisper-base",
                 "paligemma-3b"):
        cfg = get_config(arch).reduced()
        with pytest.raises(NotImplementedError, match="4b-ii"):
            TrainPipeline(build_model(cfg), lars(0.01), cfg, mesh=mesh)
    cfg = get_config("smollm-135m").reduced()
    pipe = TrainPipeline(build_model(cfg), lars(0.01), cfg, mesh=mesh)
    assert pipe.param_shardings["embed"].parts == (2, 1)
    cfg = dataclasses.replace(get_config("deepseek-v2-236b").reduced(),
                              q_lora_rank=48)
    pipe = TrainPipeline(build_model(cfg), lars(0.01), cfg, mesh=mesh)
    attn = pipe.param_shardings["layers"]["attn"]
    assert attn["q_up"].parts == (1, 1, 2) and not attn["q_down"].split


# ------------------------------------------------------ four CPU ranks

GOLDEN_RUNS = [("sgd", 32), ("sgd", 128), ("lars", 32), ("lars", 128),
               ("lars_int8", 32)]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """One spawn of four ranks for the golden runs, one for the fuse
    rules (the same ranks' results are read by every test below)."""
    with jax.threefry_partitionable(False):
        init = jax.tree_util.tree_map(np.asarray,
                                      RefLeNet().init(jax.random.key(7)))
    tmp = tmp_path_factory.mktemp("four")
    golden = worker.spawn("golden", 4, tmp / "golden", init=init,
                          runs=GOLDEN_RUNS)
    fuse = worker.spawn("fuse_rules", 4, tmp / "fuse")
    return golden, fuse


@pytest.mark.parametrize("name,batch", GOLDEN_RUNS)
def test_golden_pins_hold_under_zero_on_four_ranks(four_ranks, name,
                                                   batch):
    golden, _ = four_ranks
    got = golden[0][f"{name}-b{batch}"]
    # 272 rows pad to 288 under 4 shards: 72 rows a rank
    assert got["rows"] == (72, 512)
    for rank in golden[1:]:             # every rank reports the same run
        assert rank[f"{name}-b{batch}"]["losses"] == got["losses"]
    _compare(got, _load_golden("cnn", name, batch), rtol=MESH_RTOL,
             trust_rtol=MESH_TRUST_RTOL,
             label=f"zero x4 {name}/b{batch}")


def test_fuse_update_true_runs_on_a_data_mesh(four_ranks):
    _, fuse = four_ranks
    losses = fuse[0]["losses"]
    assert all(np.isfinite(losses["zero_fused"]))
    np.testing.assert_allclose(
        losses["zero_fused"], losses["replicated"], rtol=MESH_RTOL,
        atol=ATOL, err_msg="fused ZeRO step drifted from the replicated "
        "mesh step")


def test_fuse_update_true_raises_on_a_model_parallel_mesh(four_ranks):
    """``True`` raises the reference's ValueError on a (2, 2) mesh;
    ``"auto"`` runs LeNet there unfused (every LeNet spec replicated),
    bit-identical to its (2, 1) run on the first two ranks."""
    _, fuse = four_ranks
    for rank in fuse:
        kind, msg = rank["raised"]["True"]
        assert kind == "ValueError" and "pure data-parallel" in msg
        assert rank["raised"]["auto"] is None
        assert rank["model_parallel"]["2x2"] == fuse[0]["model_parallel"][
            "2x1"]
    assert len(fuse[0]["model_parallel"]["2x2"]["losses"]) == 5
