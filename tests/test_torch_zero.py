"""ZeRO-sharded packed optimizer states in the port, against the
reference's ``build_layout(shards=)``, ``pack``, ``opt.update`` and
checkpoints, and on two gloo CPU ranks.

In process (the counterparts of tests/test_zero.py's in-process cases,
each held against the reference on LeNet's params and numpy-seeded
gradients): a ZeRO layout pads the reference's rows, packs byte-equal
to the reference and folds its norms bit-equal to the unpadded layout;
without a mesh a ZeRO state trains bit-identically to ``shards=1`` in
f32 and int8 and tracks the reference's own ZeRO update (engine rtol
1e-5 / atol 1e-6, f32 norms summed in another order; int8 atol 1e-4,
one code step); pad rows and int8 pad blocks (code 0, scale 1) stay
inert; checkpoints restore byte-identically across shard counts 1/4/8
and continue identically, and the file is the reference's byte for byte.
The kernels' buffer check takes row-slice views at block offsets.

Spawned (tests/_torch_dist_worker.py, two ranks): ZeRO is bit-identical
to replicated data parallelism (f32 and int8 slots, 1 and 2
microbatches: a sum of two terms commutes); each rank's slots are half
the padded rows; both track the one-process run at the reference's
``MESH_RTOL``; the mean gradient is the port's order of summation
(each rank's microbatches, then the ranks) bit for bit, within f32
rounding of the reference's order (the ranks, then the microbatches);
the two runs' checkpoints are byte-equal and restore in the reference's
``restore_train_state``; and a cut of ``zero_smoke`` (2 ranks, 1 epoch,
``n_train=256``) runs through ``GridRunner``, killed mid-grid and
resumed to the uninterrupted trajectories.

In the same spawn, the moe family on the (2, 1) mesh: reduced granite
with capacity drops (8 experts, top-2, capacity factor 0.5) for 2 LARS
steps of 2 microbatches, ``moe_groups`` 1 (a dispatch group spans both
ranks) and 2 (each rank holds one group of each microbatch), against
the reference's single-device pipeline. Each rank routes its block of
the reference's global microbatch as the reference routes the whole:
losses and params within the reference's own mesh tolerances, the aux
loss within ``MOE_AUX`` (measured below).
"""

import dataclasses
import threading

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro.checkpoint import restore_train_state as ref_restore
from repro.checkpoint import save_train_state as ref_save
from repro.configs import get_config as ref_get_config
from repro.core import packing as ref_packing
from repro.models import build_model as ref_build_model
from repro.models.lenet import LeNet as RefLeNet
from repro.train import TrainPipeline as RefPipeline
from repro.train import TrainState as RefTrainState
from repro_torch import bridge
from repro_torch.checkpoint import restore_train_state, save_train_state
from repro_torch.configs import get_config
from repro_torch.core import lars, packing, sgd
from repro_torch.experiments.record import read_trajectory
from repro_torch.kernels import lars_kernels as lk
from repro_torch.launch.mesh import mesh_from_spec
from repro_torch.models import build_model
from repro_torch.train import TrainPipeline, TrainState
from repro_torch.train.step import value_and_grad
from repro_torch.treepath import tree_flatten_with_path, tree_leaves, tree_map
from test_golden import ATOL as MESH_ATOL, MESH_RTOL
import _torch_dist_worker as worker
from _torch_threads import one_torch_thread  # noqa: F401

# one intra-op thread: the suite runs files in parallel workers, and
# the spawned ranks take a core each
pytestmark = pytest.mark.usefixtures("one_torch_thread")
SHARDS = 8
ENGINE_RTOL, ENGINE_ATOL = 1e-5, {"f32": 1e-6, "int8": 1e-4}
CFG = get_config("lenet-mnist")
MODEL = build_model(CFG)


def _params():
    """LeNet's reference init (numpy) and its all-False marker."""
    p = jax.tree_util.tree_map(np.asarray, RefLeNet().init(jax.random.key(1)))
    return p, jax.tree_util.tree_map(lambda _: False, p)


def _grads(params, step):
    rng = np.random.default_rng(100 + step)
    return jax.tree_util.tree_map(
        lambda p: (rng.standard_normal(p.shape) * 0.01).astype(np.float32),
        params)


def _opts(slot_dtype):
    kw = dict(momentum=0.9, weight_decay=1e-4, trust_coefficient=0.01,
              slot_dtype=slot_dtype)
    return lars(0.05, **kw), ref_core.lars(0.05, use_pallas=False, **kw)


def _init(opt, params, marker, shards):
    kw = {"zero_shards": shards} if shards > 1 else {}
    return opt.init(params, stacked=marker, **kw)


def _run(opt, params, marker, shards, steps, start=0, state=None):
    """The port: ``steps`` updates on numpy-seeded gradients."""
    tp = bridge.params_to_torch(params) if isinstance(
        next(iter(jax.tree_util.tree_leaves(params))), np.ndarray) \
        else params
    s = state if state is not None else _init(opt, tp, marker, shards)
    for i in range(start, start + steps):
        tp, s = opt.update(bridge.params_to_torch(_grads(params, i)), s, tp,
                           stacked=marker)
    return tp, s


def _npz(path) -> list:
    """An npz file's members in order, each its stored bytes (the .npy
    header and data): the file's content without the zip entries' write
    times."""
    import zipfile
    with zipfile.ZipFile(path) as z:
        return [(n, z.read(n)) for n in z.namelist()]


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


# ------------------------------------------------------------- layout

def test_layout_pads_rows_to_shard_multiple():
    params, marker = _params()
    ref = ref_packing.build_layout(
        jax.tree_util.tree_map(jnp.asarray, params), marker, shards=SHARDS)
    tp = bridge.params_to_torch(params)
    base = packing.build_layout(tp, marker)
    lay = packing.build_layout(tp, marker, shards=SHARDS)
    for f in ("shards", "pad_rows", "base_rows", "total_rows", "num_blocks",
              "num_slices", "buffer_shape"):
        assert getattr(lay, f) == getattr(ref, f), f
    assert lay.base_rows == base.total_rows == 272
    assert lay.total_rows % (SHARDS * lay.block_rows) == 0
    buf = packing.pack(lay, tp)
    want = np.asarray(ref_packing.pack(
        ref, jax.tree_util.tree_map(jnp.asarray, params)))
    assert buf.numpy().tobytes() == want.tobytes()
    assert not buf[lay.base_rows:].any()
    assert _same(packing.unpack(lay, buf), tp)
    np.testing.assert_array_equal(packing.row_slice_ids(lay).numpy(),
                                  np.asarray(ref_packing.row_slice_ids(ref)))
    np.testing.assert_array_equal(packing.block_slice_ids(lay).numpy(),
                                  np.asarray(ref_packing.block_slice_ids(ref)))
    # the pad rows fall out of every fold: bit-equal to the unpadded one
    assert torch.equal(packing.slice_sumsq(lay, buf),
                       packing.slice_sumsq(base, packing.pack(base, tp)))
    rows = lk.norms_flat(buf, buf)[0]
    assert torch.equal(packing.fold_rows(lay, rows),
                       packing.fold_rows(base, rows[:base.total_rows]))
    ratio = torch.arange(1.0, lay.num_slices + 1)
    assert torch.equal(packing.blocks_expand(lay, ratio)[:34],
                       packing.blocks_expand(base, ratio))


@pytest.mark.parametrize("slot_dtype", ["f32", "int8"])
def test_offmesh_zero_update_bit_identical(slot_dtype):
    """Without a mesh a ZeRO layout trains the EXACT shards=1 trajectory,
    and tracks the reference's own ZeRO update."""
    params, marker = _params()
    opt, ref_opt = _opts(slot_dtype)
    p1, s1 = _run(opt, params, marker, 1, 5)
    p8, s8 = _run(opt, params, marker, SHARDS, 5)
    assert _same(p1, p8)
    for k, v in s1.slots.items():
        assert torch.equal(s8.slots[k][:v.shape[0]], v), k
    rp = jax.tree_util.tree_map(jnp.asarray, params)
    rs = ref_opt.init(rp, stacked=marker, zero_shards=SHARDS)
    for i in range(5):
        rp, rs = ref_opt.update(jax.tree_util.tree_map(
            jnp.asarray, _grads(params, i)), rs, rp, stacked=marker)
    assert s8.step == int(rs.step)
    tree_map(lambda a, b: np.testing.assert_allclose(
        a.numpy(), np.asarray(b), rtol=ENGINE_RTOL,
        atol=ENGINE_ATOL[slot_dtype]), p8, jax.tree_util.tree_map(
        np.asarray, rp))
    np.testing.assert_allclose(
        s8.slots[packing.WEIGHT_SLOT].numpy(),
        np.asarray(rs.slots[packing.WEIGHT_SLOT]), rtol=ENGINE_RTOL,
        atol=ENGINE_ATOL[slot_dtype])


@pytest.mark.parametrize("name", ["lars", "sgd"])
def test_int8_pad_blocks_stay_inert(name):
    """Pad rows of every slot stay exactly zero, int8 pad blocks code 0
    with scale 1.0, through 20 updates (LARS's kernel path and SGD's
    dequantize-update-requantize path)."""
    params, marker = _params()
    opt = _opts("int8")[0] if name == "lars" else \
        sgd(0.05, momentum=0.9, slot_dtype="int8")
    _, s = _run(opt, params, marker, SHARDS, 20)
    lay = s.layout
    assert lay.pad_rows == 48
    assert not s.slots["momentum"][lay.base_rows:].any()
    assert torch.equal(s.slots["momentum_scale"][lay.base_rows // 8:],
                       torch.ones(lay.pad_rows // 8, 1))
    assert not s.slots[packing.WEIGHT_SLOT][lay.base_rows:].any()


# -------------------------------------------------------- checkpoints

@pytest.mark.parametrize("restore_shards", [1, 4, SHARDS])
@pytest.mark.parametrize("slot_dtype", ["f32", "int8"])
def test_checkpoint_restores_across_shard_counts(tmp_path, slot_dtype,
                                                 restore_shards):
    params, marker = _params()
    opt, _ = _opts(slot_dtype)
    p, s = _run(opt, params, marker, SHARDS, 3)
    path = str(tmp_path / "state.npz")
    save_train_state(path, TrainState(p, s))
    tp = bridge.params_to_torch(params)
    back = restore_train_state(path, TrainState(
        tp, _init(opt, tp, marker, restore_shards)))
    assert back.opt_state.layout.shards == restore_shards
    assert _same(back.params, p)
    for k, v in s.slots.items():
        rows = (s.layout.base_rows // 8 if k.endswith("_scale")
                else s.layout.base_rows)
        got = back.opt_state.slots[k]
        assert got[:rows].numpy().tobytes() == v[:rows].numpy().tobytes(), k
        assert not got[rows:].any() or k.endswith("_scale")
    # the restored state continues identically to the original
    pa, sa = _run(opt, params, marker, 0, 2, start=3, state=s)
    pb, sb = _run(opt, params, marker, 0, 2, start=3, state=back.opt_state)
    assert _same(pa, pb)
    again = str(tmp_path / "again.npz")
    save_train_state(again, back)
    assert _npz(again) == _npz(path)


@pytest.mark.parametrize("slot_dtype", ["f32", "int8"])
def test_zero_checkpoint_is_the_references_file(tmp_path, slot_dtype):
    """The reference's ZeRO state (shards=8, 3 updates) carried into the
    port by the bridge saves to the reference's file byte for byte, and
    that file restores into the reference under another shard count."""
    params, marker = _params()
    opt, ref_opt = _opts(slot_dtype)
    rp = jax.tree_util.tree_map(jnp.asarray, params)
    rs = ref_opt.init(rp, stacked=marker, zero_shards=SHARDS)
    for i in range(3):
        rp, rs = ref_opt.update(jax.tree_util.tree_map(
            jnp.asarray, _grads(params, i)), rs, rp, stacked=marker)
    ref_save(str(tmp_path / "ref.npz"), RefTrainState(rp, rs))
    tp = bridge.params_to_torch(jax.tree_util.tree_map(np.asarray, rp))
    layout = packing.build_layout(tp, marker, shards=SHARDS)
    ts = bridge.opt_state_to_torch(
        int(rs.step), jax.tree_util.tree_map(np.asarray, dict(rs.slots)),
        layout)
    save_train_state(str(tmp_path / "port.npz"), TrainState(tp, ts))
    assert _npz(tmp_path / "port.npz") == _npz(tmp_path / "ref.npz")
    template = RefTrainState(rp, ref_opt.init(rp, stacked=marker,
                                              zero_shards=4))
    back = ref_restore(str(tmp_path / "port.npz"), template)
    ref_save(str(tmp_path / "again.npz"), back)
    assert _npz(tmp_path / "again.npz") == _npz(tmp_path / "ref.npz")
    step, slots = bridge.opt_state_to_numpy(ts)
    for k, v in slots.items():
        assert v.tobytes() == np.asarray(rs.slots[k]).tobytes(), k


def test_row_shards_under_eight_ranks():
    """Rank 3 of a (8, 1) mesh (built by hand: no collective runs here)
    holds rows [120, 160) of LeNet's 320 padded rows and scale blocks
    [15, 20): a shard of 40 rows is not mistaken for the 40 per-block
    scales of the whole buffer, and a shard is cut no further."""
    from repro_torch.launch.mesh import Mesh
    params, marker = _params()
    tp = bridge.params_to_torch(params)
    lay = packing.build_layout(tp, marker, shards=8)
    assert (lay.total_rows, lay.num_blocks) == (320, 40)
    mesh = Mesh(shape={"data": 8, "model": 1},
                coords={"data": 3, "model": 0}, groups={},
                device=torch.device("cpu"))
    buf = packing.pack(lay, tp)
    scales = torch.arange(40.0)[:, None]
    with mesh:
        local = packing.constrain_rows(lay, buf)
        assert torch.equal(local, buf[120:160])
        assert packing.constrain_rows(lay, local) is local
        assert torch.equal(packing.constrain_rows(lay, scales),
                           scales[15:20])
        assert packing.shard_span(lay, 40) == (120, 160)
        assert packing.is_shard(lay, local) and \
            not packing.is_shard(lay, buf)
        q, s = packing.quantize_q8(lay, local)
        assert q.shape == (40, 512) and s.shape == (5, 1)
        assert torch.equal(packing.blocks_expand(
            lay, torch.arange(10.0), 40), packing.blocks_expand(
            lay, torch.arange(10.0))[15:20])
    # place_state cuts a whole (restored or host) ZeRO state to the shard
    from repro_torch.train import train_state_from_params
    opt = _opts("int8")[0]
    whole = train_state_from_params(MODEL, opt, tp, zero_shards=8)
    placed = TrainPipeline(MODEL, opt, CFG, mesh=mesh,
                           zero=True).place_state(whole)
    for k, v in whole.opt_state.slots.items():
        rows = slice(15, 20) if k.endswith("_scale") else slice(120, 160)
        assert torch.equal(placed.opt_state.slots[k], v[rows]), k
    assert _same(placed.params, whole.params)


def test_kernel_buffer_check_takes_block_aligned_row_views():
    """A ZeRO shard at a row offset that is a multiple of 8 is a
    contiguous view 16 KiB past the buffer's start (so as aligned as the
    buffer): the CUDA wrappers' check takes it; it refuses a row count
    off the 8-row grid."""
    buf = torch.zeros(64, 512)
    for lo, hi in ((0, 16), (8, 40), (56, 64)):
        view = buf[lo:hi]
        assert (view.data_ptr() - buf.data_ptr()) % (8 * 512 * 4) == 0
        assert lk._check_buffers(8, view, view) == (hi - lo, 512)
    with pytest.raises(ValueError, match="R % 8"):
        lk._check_buffers(8, buf[4:16])


# ----------------------------------------------------------- pipeline

def test_pipeline_on_a_one_rank_mesh_is_the_unsharded_pipeline():
    """A 1x1 mesh (no process group: one rank) with and without ZeRO runs
    the no-mesh pipeline bit for bit, with accumulation."""
    from repro_torch.data import batch_iterator, synthetic_mnist
    x, y, _, _ = synthetic_mnist(256, 8, seed=0)
    mesh = mesh_from_spec("1x1", device="cpu")
    runs = {}
    for tag, kw in (("none", {}), ("mesh", {"mesh": mesh}),
                    ("zero", {"mesh": mesh, "zero": True})):
        pipe = TrainPipeline(MODEL, _opts("int8")[0], CFG, accum_steps=2,
                             **kw)
        state = pipe.init_state(torch.Generator().manual_seed(5), "cpu")
        it = batch_iterator(x, y, batch=32, seed=0)
        losses = []
        for _ in range(4):
            b = {k: torch.from_numpy(v) for k, v in next(it).items()}
            state, m = pipe(state, b)
            losses.append(float(m["loss"]))
        runs[tag] = (losses, state)
    for tag in ("mesh", "zero"):
        assert runs[tag][0] == runs["none"][0]
        assert _same(runs[tag][1].params, runs["none"][1].params)


def test_zero_needs_a_mesh_and_the_packed_layout():
    """The reference's refusals, word for word."""
    from repro.configs import get_config as ref_get_config
    ref_kw = dict(cfg=ref_get_config("lenet-mnist"))
    for kw in ({"zero": True}, {"zero": True, "packed": False,
                                "mesh": "mesh"}):
        port_kw = dict(kw)
        if port_kw.get("mesh"):
            port_kw["mesh"] = mesh_from_spec("1x1", device="cpu")
            kw = dict(kw, mesh=jax.make_mesh((1, 1), ("data", "model")))
        with pytest.raises(ValueError) as got:
            TrainPipeline(MODEL, _opts("f32")[0], CFG, **port_kw)
        with pytest.raises(ValueError) as want:
            RefPipeline(RefLeNet(), _opts("f32")[1], **ref_kw, **kw)
        assert str(got.value) == str(want.value)
    params, _ = _params()
    with pytest.raises(ValueError) as got:
        _opts("f32")[0].init(bridge.params_to_torch(params), zero_shards=2)
    with pytest.raises(ValueError) as want:
        _opts("f32")[1].init(params, zero_shards=2)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------ two ranks

RUNS = ["f32-a1", "f32-a2", "int8-a1", "int8-a2"]
GRANITE = "granite-moe-3b-a800m"
MOE_DROP = {"num_experts": 8, "experts_per_token": 2,
            "capacity_factor": 0.5}
MOE_RUNS = [dict(tag=f"granite-2x1-g{g}", arch=GRANITE, model=f"g{g}",
                 changes=dict(MOE_DROP, moe_groups=g), mesh="2x1", accum=2)
            for g in (1, 2)]
# the reference's tolerances for its mesh pipeline against its single
# device (tests/test_pipeline.py:284-289); the moe runs measured at most
# 7.6e-8 relative on a loss, 1.2e-7 on a param and 9.0e-8 relative on
# the aux loss. Each rank routing only its own tokens (capacity from
# them), the losses were 1.9e-3 (groups 1) and 2.6e-3 (groups 2)
# relative off, the aux losses 1.5e-2 and 2.8e-2.
MOE_LOSS = dict(rtol=2e-4, atol=2e-5)
MOE_PARAMS = dict(rtol=5e-3, atol=5e-4)
MOE_AUX = dict(rtol=1e-5, atol=0)


def _moe_reference(run):
    """The reference's single-device pipeline on ``run``'s config: its
    init (numpy), the (8, 32) tokens, and 2 LARS steps' losses, aux losses
    and final params."""
    cfg = dataclasses.replace(ref_get_config(run["arch"]).reduced(),
                              **run["changes"])
    pipe = RefPipeline(ref_build_model(cfg), ref_core.lars(
        0.05, trust_coefficient=0.01, use_pallas=False), cfg,
        accum_steps=run["accum"], donate=False)
    state = pipe.init_state(jax.random.key(0))
    init = jax.tree_util.tree_map(np.asarray, state.params)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 32)).astype(np.int32)
    losses, aux = [], []
    for _ in range(2):
        state, m = pipe(state, {"tokens": jnp.asarray(tokens)})
        losses.append(float(m["loss"]))
        aux.append(float(m["aux_loss"]))
    return {"init": init, "tokens": tokens, "losses": losses,
            "aux_losses": aux,
            "params": jax.tree_util.tree_map(np.asarray, state.params)}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The two-rank spawn (LeNet's runs, then the moe runs from the
    reference's inits), and the reference's moe runs, computed in this
    process while the ranks run."""
    tmp = tmp_path_factory.mktemp("two")
    (tmp / "ckpt").mkdir()
    inits = {}
    for run in MOE_RUNS:
        cfg = dataclasses.replace(ref_get_config(GRANITE).reduced(),
                                  **run["changes"])
        inits[run["model"]] = jax.tree_util.tree_map(
            np.asarray, ref_build_model(cfg).init(jax.random.key(0)))
    tokens = np.random.default_rng(0).integers(
        0, ref_get_config(GRANITE).reduced().vocab_size,
        (8, 32)).astype(np.int32)
    got = {}
    spawn = threading.Thread(target=lambda: got.update(out=worker.spawn(
        "zero_vs_replicated", 2, tmp / "spawn", ckpt_dir=str(tmp / "ckpt"),
        moe=dict(runs=MOE_RUNS, inits=inits, tokens=tokens))))
    spawn.start()
    try:
        reference = {run["tag"]: _moe_reference(run) for run in MOE_RUNS}
    finally:
        spawn.join()
    assert "out" in got, "the spawn failed"
    for run in MOE_RUNS:
        ref = reference[run["tag"]]
        assert (ref["tokens"] == tokens).all()
        assert all(np.array_equal(a, b) for a, b in zip(
            jax.tree_util.tree_leaves(ref["init"]),
            jax.tree_util.tree_leaves(inits[run["model"]])))
    return got["out"], tmp / "ckpt", reference


@pytest.fixture(scope="module")
def two_ranks(spawned):
    return spawned[:2]


def _one_process(slot_dtype, accum, steps=6, batch=64, packed=True):
    """The same run in this process, without a mesh."""
    pipe = TrainPipeline(MODEL, worker._optimizer(
        "lars_int8" if slot_dtype == "int8" else "lars", 0.05), CFG,
        accum_steps=accum, packed=packed)
    state = pipe.init_state(torch.Generator().manual_seed(3), "cpu")
    it = worker._mnist_batches(256, batch)
    losses = []
    for _ in range(steps):
        state, m = pipe(state, {k: torch.from_numpy(v)
                                for k, v in next(it).items()})
        losses.append(float(m["loss"]))
    return losses


@pytest.mark.parametrize("run", RUNS)
def test_zero_is_bit_identical_to_replicated_at_two_ranks(two_ranks, run):
    out, _ = two_ranks
    for rank in out:
        z, r = rank[run + "-zero"], rank[run + "-repl"]
        assert z["losses"] == r["losses"]
        for a, b in zip(tree_leaves(z["params"]), tree_leaves(r["params"])):
            assert a.tobytes() == b.tobytes()
        for k, v in r["slots"].items():
            assert z["slots"][k].tobytes() == v.tobytes(), k
    assert out[0][run + "-zero"]["losses"] == out[1][run + "-zero"]["losses"]


@pytest.mark.parametrize("run", RUNS)
def test_each_rank_holds_half_the_padded_rows(two_ranks, run):
    out, _ = two_ranks
    z, r = out[1][run + "-zero"], out[1][run + "-repl"]
    total, base, shards = z["layout"]
    assert (total, base, shards) == (272, 272, 2)
    for k, (shape, nbytes) in z["local"].items():
        assert shape[0] * 2 == r["local"][k][0][0], k
        assert nbytes * 2 == r["local"][k][1], k


@pytest.mark.parametrize("run", ["f32-a1", "int8-a2"])
def test_two_ranks_track_one_process(two_ranks, run):
    out, _ = two_ranks
    slot_dtype, accum = run.split("-")
    np.testing.assert_allclose(out[0][run + "-zero"]["losses"],
                               _one_process(slot_dtype, int(accum[1:])),
                               rtol=MESH_RTOL, atol=MESH_ATOL)


def test_tree_states_train_data_parallel(two_ranks):
    """A tree-layout state (``packed=False``) on the (2, 1) mesh: every
    leaf's gradient all-reduced in one flat buffer; it tracks the same
    run alone at ``MESH_RTOL``."""
    out, _ = two_ranks
    assert out[0]["tree"]["layout"] is None
    assert out[0]["tree"]["losses"] == out[1]["tree"]["losses"]
    np.testing.assert_allclose(out[0]["tree"]["losses"],
                               _one_process("f32", 1, packed=False),
                               rtol=MESH_RTOL, atol=MESH_ATOL)


def test_accumulation_reduces_once_per_step(two_ranks):
    """With 2 microbatches on 2 ranks the mean gradient of the last step
    is (sum over ranks of (sum over a rank's microbatches) / 2) / 2 bit
    for bit; the reference's order (the ranks per microbatch, then the
    microbatches) agrees within f32 rounding."""
    out, _ = two_ranks
    got = out[0]["f32-a2-zero"]["grads"]
    it = worker._mnist_batches(256, 64)
    batches = [{k: torch.from_numpy(v) for k, v in next(it).items()}
               for _ in range(6)]
    # replay the last step in this process, rank by rank, microbatch by
    # microbatch, from the params it started from
    tp = bridge.params_to_torch(out[0]["f32-a2-zero"]["pre_params"])
    g = {}
    for r in range(2):
        for i in range(2):
            rows = slice(r * 32 + i * 16, r * 32 + (i + 1) * 16)
            _, gi, _ = value_and_grad(MODEL, CFG, tp, {
                k: v[rows] for k, v in batches[5].items()})
            g[r, i] = gi
    port = tree_map(lambda a0, a1, b0, b1: torch.div(
        (a0.float() + a1.float()) * 0.5 + (b0.float() + b1.float()) * 0.5,
        2), g[0, 0], g[0, 1], g[1, 0], g[1, 1])
    ref = tree_map(lambda a0, b0, a1, b1: (torch.div(a0 + b0, 2)
                                           + torch.div(a1 + b1, 2)) * 0.5,
                   g[0, 0], g[1, 0], g[0, 1], g[1, 1])
    for a, b, c in zip(tree_leaves(got), tree_leaves(port), tree_leaves(ref)):
        assert a.tobytes() == b.numpy().tobytes()
        np.testing.assert_allclose(a, c.numpy(), rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("run", MOE_RUNS, ids=lambda r: r["tag"])
def test_moe_on_two_data_ranks_routes_the_global_microbatch(spawned, run):
    """Reduced granite with drops on 2x1, 2 microbatches: each rank's
    losses and aux losses and the final params are the reference
    single-device pipeline's, whose routing (capacity, dropped slots,
    load-balance loss) is the global microbatch's; the ranks agree."""
    out, _, reference = spawned
    ref = reference[run["tag"]]
    ranks = [rank["moe"][run["tag"]] for rank in out]
    for got in ranks:
        np.testing.assert_allclose(got["losses"], ref["losses"], **MOE_LOSS)
        np.testing.assert_allclose(got["aux_losses"], ref["aux_losses"],
                                   **MOE_AUX)
        assert got["replicated"] == ranks[0]["replicated"]
        assert got["kernels"] == [[("norms_flat", got["rows"]),
                                   ("apply_flat", got["rows"])]] * 2
        assert got["dropped"] > 0
    mine = {"/".join(p): v for p, v in
            tree_flatten_with_path(ranks[0]["params"])[0]}
    want = {"/".join(p): np.asarray(v, np.float32) for p, v in
            tree_flatten_with_path(ref["params"])[0]}
    assert sorted(mine) == sorted(want)
    for k in want:
        np.testing.assert_allclose(mine[k], want[k], **MOE_PARAMS,
                                   err_msg=k)


def test_two_rank_checkpoints_are_one_file(two_ranks):
    """ZeRO and replicated runs write the same bytes (pad-free, gathered
    by rank 0), and the reference restores them and re-saves them
    byte for byte."""
    _, ckpt = two_ranks
    for run in RUNS:
        zero = _npz(ckpt / f"{run}-zero.npz")
        assert zero == _npz(ckpt / f"{run}-repl.npz")
        slot_dtype = run.split("-")[0]
        ref_pipe = RefPipeline(RefLeNet(), _opts(slot_dtype)[1],
                               get_config("lenet-mnist"), donate=False)
        template = ref_pipe.init_state(jax.random.key(0))
        back = ref_restore(str(ckpt / f"{run}-zero.npz"), template)
        ref_save(str(ckpt / f"{run}-again.npz"), back)
        assert _npz(ckpt / f"{run}-again.npz") == zero


# ------------------------------------------------- zero_smoke, 2 ranks

def _trajectories(out_dir):
    out = {}
    for cell in sorted(os.listdir(out_dir)):
        path = os.path.join(out_dir, cell, "trajectory.jsonl")
        if os.path.exists(path):
            out[cell] = read_trajectory(path, strip_timing=True)
    return out


def test_zero_smoke_runs_killed_and_resumed(tmp_path):
    full = worker.spawn("zero_smoke", 2, tmp_path / "a",
                        out_dir=str(tmp_path / "full"))
    assert full[0] == {"interrupted": False, "cells": full[0]["cells"]}
    assert len(full[0]["cells"]) == 4
    cut = worker.spawn("zero_smoke", 2, tmp_path / "b",
                       out_dir=str(tmp_path / "cut"), abort_after=3)
    assert cut[0]["interrupted"] and cut[1]["interrupted"]
    rest = worker.spawn("zero_smoke", 2, tmp_path / "c",
                        out_dir=str(tmp_path / "cut"), resume=True)
    assert rest[0]["cells"] == full[0]["cells"]
    assert _trajectories(tmp_path / "cut") == _trajectories(tmp_path / "full")
    import json
    rows = [json.load(open(tmp_path / d / "manifest.json"))["cells"]
            for d in ("full", "cut")]
    for cid, row in rows[0].items():
        assert {k: v for k, v in row.items() if k != "wall_s"} == \
            {k: v for k, v in rows[1][cid].items() if k != "wall_s"}
    assert not any(p.name.endswith(".npz") for p in
                   (tmp_path / "full").rglob("*"))
