"""Tensor parallelism over ``model`` for the dense LM family, and
expert parallelism for the moe family, in the port, on gloo CPU ranks
(tests/_torch_dist_worker.py), against the reference's single-device
``TrainPipeline`` and the port's own run without a mesh.

qwen3-14b, smollm-135m and qwen2-72b reduced (f32) start from the
reference's init (``bridge``) and take 2 LARS steps of 2 microbatches
on one (8, 32) token batch: on ``1x2`` (two ranks) and on ``2x2`` (four
ranks) with ZeRO on and off. Each run is held against the reference's
pipeline at the reference's own mesh tolerances (tests/test_pipeline.py:
284-289: loss rtol 2e-4 / atol 2e-5, params rtol 5e-3 / atol 5e-4) and
against the port's run alone at tighter ones measured here; the trust
ratios the update applied against the run alone's; every replicated
leaf bit-identical across the ranks; one ``norms_flat`` and one apply a
rank a step, on the global rows or the ZeRO shard. On ``1x2`` smollm
also runs bf16, int8 slots, a tree state (f32 and int8), the chunked
loss, two-level remat and 3 heads over 2 ranks (non-aligned), each
against the port's run alone; the vocab-parallel loss and non-aligned
attention blocks are held alone against the plain functions; and
checkpoints saved on ``1x2`` are the ``1x1`` files, which both packages
restore.

The moe family: reduced granite with capacity drops (8 experts, top-2,
capacity factor 0.5) the same way, on ``1x2`` (``_MOE``: 4 experts a
rank), with 5 experts and a shared expert (``_MOE_TP``: each expert's
ff split, the shared expert's too), with a shared expert whose width 511
the ranks do not divide (experts split, shared expert whole), with 5
experts at ff 511 (every expert leaf whole on both ranks), in bf16 and
with int8 slots, and on ``2x2`` with ZeRO on and off (the experts split
over ``model``, each global microbatch routed over ``data``). Beside the
gates above (the router is one of the replicated leaves), each run's aux
loss is held against the reference's, and the first MoE call's
``dropped_frac`` against the reference's ``moe_block`` on the same
input.

MLA (deepseek-v2-236b reduced: 4 heads; ``q_up``/``wq``, ``k_up`` and
``v_up`` split by columns, ``wo`` by rows, the down projections and
their norms whole): without a query rank (``wq``), and with a query rank
of 48 and granite's drop settings, on ``1x2`` and on ``2x2`` with ZeRO
on and off, in bf16 on ``1x2`` without drops (with and without the
query rank) and with int8 slots (rank 48, drops) on ``1x2``; the
same gates (the down projections among the replicated leaves), the
drops' gates for the rank-48 runs, and its checkpoint saved on ``1x2``.
3 MLA heads over 2 ranks are held alone against the plain block.

One spawn of 2 ranks and one of 4 serve every test (module fixtures).
"""

import dataclasses
import threading
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro.checkpoint import restore_train_state as ref_restore
from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.train import TrainPipeline as RefPipeline
from repro_torch.checkpoint import restore_train_state, save_train_state
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.train import TrainPipeline
from repro_torch.treepath import tree_flatten_with_path
import _torch_dist_worker as worker
from _torch_threads import one_torch_thread  # noqa: F401

ARCHS = ("qwen3-14b", "smollm-135m", "qwen2-72b")
GRANITE = "granite-moe-3b-a800m"
DEEPSEEK = "deepseek-v2-236b"
# reduced granite with capacity drops (chip_smoke.py's GRANITE_DROP)
DROP = {"num_experts": 8, "experts_per_token": 2, "capacity_factor": 0.5}
# the models by name: (arch, config changes)
MODELS = dict({a: (a, {}) for a in ARCHS}, **{
    "granite": (GRANITE, DROP),
    "granite-e5": (GRANITE, dict(DROP, num_experts=5,
                                 num_shared_experts=1)),
    "granite-shared": (GRANITE, dict(DROP, num_shared_experts=1,
                                     moe_d_ff=511)),
    "granite-oddff": (GRANITE, dict(DROP, num_experts=5, moe_d_ff=511,
                                    num_shared_experts=1)),
    # MLA: the reduced preset's wq, and a query rank with drops and
    # without them
    "deepseek": (DEEPSEEK, {}),
    "deepseek-q48": (DEEPSEEK, dict(DROP, q_lora_rank=48)),
    "deepseek-q48-nodrop": (DEEPSEEK, dict(q_lora_rank=48))})
# the moe runs whose routing drops slots (deepseek's reduced preset
# routes every token to all 4 experts)
MOE_MODELS = [m for m in MODELS if m.startswith("granite")] + \
    ["deepseek-q48"]
MLA_MODELS = ["deepseek", "deepseek-q48"]
STEPS, ACCUM, BATCH, SEQ = 2, 2, 8, 32
# the reference's own tolerances for its (4, 2)-mesh pipeline against
# its single-device pipeline (tests/test_pipeline.py:284-289)
REF_LOSS = dict(rtol=2e-4, atol=2e-5)
REF_PARAMS = dict(rtol=5e-3, atol=5e-4)
# the port's mesh runs against its run alone, f32: measured at most
# 1.2e-7 on a param (the split products re-bracket their sums: no bit
# identity), one ulp on a loss, 3.2e-7 relative on a trust ratio
PORT_LOSS = dict(rtol=1e-6, atol=0)
PORT_PARAMS = dict(rtol=1e-5, atol=1e-6)
PORT_TRUST_RTOL = 1e-5
# int8 slots: one momentum code step moves a weight by lr * scale
# (measured 2.9e-6 on a tree state, 1.4e-6 packed)
INT8_PARAMS = dict(rtol=1e-4, atol=2e-5)
# bf16: the partial products are summed over the ranks in bf16, as the
# reference's GSPMD sums them (measured 4.9e-4 on a param after 2
# steps, 1.7e-3 relative on a trust ratio, 6e-5 relative on a loss)
BF16_LOSS = dict(rtol=1e-4, atol=0)
BF16_PARAMS = dict(rtol=1e-2, atol=2e-3)
BF16_TRUST_RTOL = 1e-2
# MLA's f32 runs against the run alone: measured 7.2e-8 relative on a
# loss, 1.2e-7 on a param and 2.3e-7 relative on a trust ratio (int8
# slots: 2.3e-6 on a param)
# the moe runs, f32, against the reference's pipeline: measured at most
# 1.5e-7 relative on a loss and 1.2e-7 on a param (within REF_*), and
# against the run alone 1.5e-7 on a loss, 1.2e-7 on a param and 3.0e-7
# relative on a trust ratio (within PORT_*); the aux loss 1.9e-7
# relative off the reference's, and the first MoE call's dropped share
# equal to the reference's moe_block's on the same input
MOE_AUX = dict(rtol=1e-5, atol=0)
MOE_DROPPED = dict(rtol=1e-6, atol=0)
# moe in bf16 against the run alone: each rank's partial combine of its
# experts' slots is summed over the ranks in bf16 (measured 1.3e-4
# relative on a loss, 9.8e-4 on a param, 1.8e-2 relative on a trust
# ratio after 2 steps)
MOE_BF16_LOSS = dict(rtol=5e-4, atol=0)
MOE_BF16_TRUST_RTOL = 5e-2
# deepseek in bf16 (its MLA and its moe block, no drops: the routing
# keeps every slot) takes the moe loss limit and the dense params' and
# trust ratios' (tests/tp_bf16_gaps.py: 1.4e-4 and 6.7e-5 relative on a
# loss, 3.9e-3 and 7.8e-3 on a param, 1.7e-3 and 4.2e-3 relative on a
# trust ratio, without a query rank and at 48). With granite's drops
# bf16 flips its routing against the run alone's (10 of 16 routings keep
# other slots, up to 12.5 %; f32 flips none): the two train different
# functions (7.3e-4 on a loss), so that run stays f32 and int8.

def _moe(tag, model, mesh, **kw):
    arch, changes = MODELS[model]
    return dict(tag=tag, arch=arch, model=model, changes=changes,
                mesh=mesh, **kw)


MOE_TWO = [_moe(f"{m}-1x2", m, "1x2") for m in MODELS
           if m.startswith("granite")] + [
    _moe("granite-bf16", "granite", "1x2", precision="bf16"),
    _moe("granite-int8", "granite", "1x2", slots="int8")]
MOE_FOUR = [_moe(f"granite-2x2-{'zero' if z else 'repl'}", "granite", "2x2",
                 zero=z) for z in (True, False)]
MLA_TWO = [_moe(f"{m}-1x2", m, "1x2", ckpt=m == "deepseek-q48")
           for m in MLA_MODELS] + [
    _moe("deepseek-bf16", "deepseek", "1x2", precision="bf16"),
    _moe("deepseek-q48-bf16", "deepseek-q48-nodrop", "1x2",
         precision="bf16"),
    _moe("deepseek-int8", "deepseek-q48", "1x2", slots="int8")]
MLA_FOUR = [_moe(f"{m}-2x2-{'zero' if z else 'repl'}", m, "2x2", zero=z)
            for m in MLA_MODELS for z in (True, False)]
TWO = [dict(tag=f"{a}-1x2", arch=a, mesh="1x2",
            ckpt=a == "smollm-135m") for a in ARCHS] + MOE_TWO + MLA_TWO + [
    dict(tag="bf16", arch="smollm-135m", mesh="1x2", precision="bf16"),
    dict(tag="int8", arch="smollm-135m", mesh="1x2", slots="int8"),
    dict(tag="tree", arch="smollm-135m", mesh="1x2", packed=False,
         ckpt=True),
    dict(tag="tree-int8", arch="smollm-135m", mesh="1x2", packed=False,
         slots="int8"),
    dict(tag="loss_chunk", arch="smollm-135m", mesh="1x2",
         changes={"loss_chunk": 8}),
    dict(tag="remat_block", arch="smollm-135m", mesh="1x2",
         changes={"remat_block": 1}),
    dict(tag="heads_3", arch="smollm-135m", mesh="1x2", port_init=True,
         changes={"num_heads": 3, "num_kv_heads": 1})]
FOUR = [dict(tag=f"{a}-2x2-{'zero' if z else 'repl'}", arch=a, mesh="2x2",
             zero=z) for a in ARCHS for z in (True, False)] + MOE_FOUR \
    + MLA_FOUR
RUNS = {r["tag"]: r for r in TWO + FOUR}


def _tokens(cfg) -> np.ndarray:
    return np.random.default_rng(0).integers(
        0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)


def _leaves(tree) -> dict:
    return {"/".join(p): np.asarray(x, np.float32)
            for p, x in tree_flatten_with_path(tree)[0]}


def _model(run) -> str:
    return run.get("model", run["arch"])


def _reference_init(model):
    arch, changes = MODELS[model]
    cfg = dataclasses.replace(ref_get_config(arch).reduced(), **changes)
    pipe = RefPipeline(ref_build_model(cfg),
                       ref_core.lars(0.05, trust_coefficient=0.01,
                                     use_pallas=False),
                       cfg, accum_steps=ACCUM, donate=False)
    return pipe, pipe.init_state(jax.random.key(0)), _tokens(cfg)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Everything the tests read, made once: the two spawns (two ranks:
    TWO, the units and checkpoints; four ranks: FOUR) run in threads
    while this process runs, per arch, the reference's single-device
    pipeline (``reference``: its init, tokens, losses and final params
    after STEPS steps of ACCUM microbatches) and then the port's run
    alone of every run (``alone``: no mesh, no process group; its
    checkpoints in ``alone["_dir"]``)."""
    tmp = tmp_path_factory.mktemp("tp")
    (tmp / "ckpt").mkdir()
    setup = {m: _reference_init(m) for m in MODELS}
    inits = {m: jax.tree_util.tree_map(np.asarray, st.params)
             for m, (_, st, _) in setup.items()}
    toks = setup[ARCHS[0]][2]
    assert all((t == toks).all() for _, _, t in setup.values())
    ranks = {"ckpt": tmp / "ckpt"}
    spawns = [threading.Thread(target=lambda key, n, kw: ranks.__setitem__(
        key, worker.spawn("tensor_parallel", n, tmp / key, runs=kw.pop(
            "runs"), inits=inits, tokens=toks, **kw)), args=args)
        for args in (("two", 2, dict(runs=TWO, units=True,
                                     ckpt_dir=str(tmp / "ckpt"))),
                     ("four", 4, dict(runs=FOUR)))]
    for t in spawns:
        t.start()
    try:
        reference = {}
        for model, (pipe, state, _) in setup.items():
            losses, aux = [], []
            for _ in range(STEPS):
                state, m = pipe(state, {"tokens": jnp.asarray(toks)})
                losses.append(float(m["loss"]))
                aux.append(float(m["aux_loss"]))
            reference[model] = {"losses": losses, "aux_losses": aux,
                                "template": state, "init": inits[model],
                                "params": jax.tree_util.tree_map(
                                    np.asarray, state.params)}
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        alone, done = {"_dir": tmp / "alone"}, {}
        alone["_dir"].mkdir()
        for tag, run in RUNS.items():
            # a run's mesh and ZeRO do not change the run alone
            key = repr(sorted((k, v) for k, v in run.items()
                              if k not in ("tag", "mesh", "zero")))
            if key not in done:
                done[key] = worker.tp_run(
                    run, inits[_model(run)], toks,
                    ckpt_dir=str(alone["_dir"]) if run.get("ckpt") else "")
            alone[tag] = done[key]
        torch.set_num_threads(threads)
    finally:
        for t in spawns:
            t.join()
    assert "two" in ranks and "four" in ranks, "a spawn failed"
    return reference, alone, ranks


@pytest.fixture(scope="module")
def reference(results):
    return results[0]


@pytest.fixture(scope="module")
def alone(results):
    return results[1]


@pytest.fixture(scope="module")
def ranks(results):
    return results[2]


def _of(ranks, tag) -> list:
    return [r[tag] for r in ranks["two" if tag in
                                  {t["tag"] for t in TWO} else "four"]]


def _tolerances(tag):
    run = RUNS[tag]
    if run.get("precision") == "bf16" and run.get("model") in MOE_MODELS:
        return MOE_BF16_LOSS, BF16_PARAMS, MOE_BF16_TRUST_RTOL
    if run.get("precision") == "bf16" and run["arch"] == DEEPSEEK:
        return MOE_BF16_LOSS, BF16_PARAMS, BF16_TRUST_RTOL
    if run.get("precision") == "bf16":
        return BF16_LOSS, BF16_PARAMS, BF16_TRUST_RTOL
    if run.get("slots") == "int8":
        return PORT_LOSS, INT8_PARAMS, PORT_TRUST_RTOL
    return PORT_LOSS, PORT_PARAMS, PORT_TRUST_RTOL


MAIN = [f"{a}-1x2" for a in ARCHS] + [f"{m}-1x2" for m in MODELS
                                      if m not in ARCHS
                                      and f"{m}-1x2" in RUNS] \
    + [t["tag"] for t in FOUR]


@pytest.mark.parametrize("tag", MAIN)
def test_matches_the_references_single_device_pipeline(reference, ranks,
                                                       tag):
    ref = reference[_model(RUNS[tag])]
    got = _of(ranks, tag)[0]
    np.testing.assert_allclose(got["losses"], ref["losses"], **REF_LOSS)
    want = _leaves(ref["params"])
    mine = _leaves(got["params"])
    assert sorted(mine) == sorted(want)
    for k in want:
        np.testing.assert_allclose(mine[k], want[k], **REF_PARAMS,
                                   err_msg=f"{tag}: {k}")


@pytest.mark.parametrize("tag", sorted(RUNS))
def test_matches_the_port_alone(alone, ranks, tag):
    """Losses (every rank), final params and the trust ratios of the
    last update against the run without a mesh."""
    loss_tol, param_tol, trust_rtol = _tolerances(tag)
    base = alone[tag]
    for rank in _of(ranks, tag):
        np.testing.assert_allclose(rank["losses"], base["losses"],
                                   **loss_tol)
    got = _of(ranks, tag)[0]
    want = _leaves(base["params"])
    for k, v in _leaves(got["params"]).items():
        np.testing.assert_allclose(v, want[k], **param_tol,
                                   err_msg=f"{tag}: {k}")
    assert len(got["ratios"]) == len(base["ratios"]) > 0
    for a, b in zip(got["ratios"], base["ratios"]):
        np.testing.assert_allclose(a, b, rtol=trust_rtol, atol=0)


@pytest.mark.parametrize("tag", sorted(RUNS))
def test_replicated_leaves_are_bit_identical_across_ranks(ranks, tag):
    runs = _of(ranks, tag)
    assert runs[0]["replicated"]                     # norms at least
    for rank in runs[1:]:
        assert rank["replicated"] == runs[0]["replicated"]
        assert rank["losses"] == runs[0]["losses"]


@pytest.mark.parametrize("tag", sorted(RUNS))
def test_one_norms_and_one_apply_per_step_a_rank(alone, ranks, tag):
    """Packed: one ``norms_flat`` and one apply a step on every rank, on
    the global rows (the run alone's) or, with ZeRO over 2 data ranks,
    half of them; a tree state calls neither."""
    run = RUNS[tag]
    apply = "apply_flat_q8" if run.get("slots") == "int8" \
        else "apply_flat"
    whole = alone[tag]["rows"]
    for rank in _of(ranks, tag):
        if run.get("packed", True) is False:
            assert rank["kernels"] == [[]] * STEPS
            continue
        # ZeRO over 2 data ranks: the rows padded to 2 x 8, halved
        rows = -(-whole // 16) * 8 if run.get("zero") else whole
        assert rank["rows"] == rows
        assert rank["kernels"] == [[("norms_flat", rows),
                                    (apply, rows)]] * STEPS


def test_params_are_this_ranks_blocks(ranks):
    """smollm reduced on 1x2: heads (4 of 1 KV head: the KV projections
    split mid-head), the MLP and the tied vocabulary each split over the
    two ranks; the norms whole. Every f32 run's first state holds the
    blocks ``bridge.params_to_mesh`` cuts from the reference's init."""
    for tag, run in RUNS.items():
        if not run.get("port_init") and run.get("precision") != "bf16":
            assert all(r["bridged"] for r in _of(ranks, tag)), tag
    local = ranks["two"][1]["smollm-135m-1x2"]["local"]
    assert local["embed"] == (256, 288)
    assert local["layers/attn/wq"] == (2, 288, 144)
    assert local["layers/attn/wk"] == (2, 288, 36)
    assert local["layers/attn/wo"] == (2, 144, 288)
    assert local["layers/mlp/wi"] == (2, 288, 576)
    assert local["layers/mlp/wo"] == (2, 576, 288)
    assert local["layers/ln1/scale"] == (2, 288)
    assert ranks["two"][0]["heads_3"]["local"]["layers/attn/wq"] == \
        (2, 288, 108)


# each moe run's expert leaves on model rank 0 (layers, then the leaf)
MOE_LOCAL = {
    "granite-1x2": {"wi": (2, 4, 256, 512), "wo": (2, 4, 512, 256)},
    "granite-e5-1x2": {"wi": (2, 5, 256, 256), "wo": (2, 5, 256, 256),
                       "shared/wi": (2, 256, 256),
                       "shared/wo": (2, 256, 256)},
    "granite-shared-1x2": {"wi": (2, 4, 256, 511),
                           "shared/wi": (2, 256, 511),
                           "shared/wo": (2, 511, 256)},
    "granite-oddff-1x2": {"wi": (2, 5, 256, 511), "wo": (2, 5, 511, 256),
                          "shared/wo": (2, 511, 256)},
    "granite-2x2-zero": {"wi": (2, 4, 256, 512)}}


@pytest.mark.parametrize("tag", sorted(MOE_LOCAL))
def test_moe_leaves_are_split_as_the_tables_say(ranks, tag):
    """``_MOE`` splits the experts (8 over 2 ranks), ``_MOE_TP`` each
    expert's ff where ``model`` does not divide the experts (5), and a
    width ``model`` does not divide (511) stays whole, for the experts
    and the shared expert alike; the router and the gates' leaves whole
    on every rank."""
    for rank in _of(ranks, tag):
        local = rank["local"]
        for leaf, shape in MOE_LOCAL[tag].items():
            assert local[f"layers/moe/{leaf}"] == shape, leaf
        experts = RUNS[tag]["changes"]["num_experts"]
        assert local["layers/moe/router"] == (2, 256, experts)


# each MLA run's attention leaves on every rank: 4 heads over 2 ranks
# (q_up / wq 4 x 48 columns, k_up 4 x 32, v_up 4 x 32, wo's rows 4 x 32),
# the down projections and their norms whole
MLA_LOCAL = {
    "deepseek-1x2": {"wq": (2, 256, 96), "k_up": (2, 64, 64),
                     "v_up": (2, 64, 64), "wo": (2, 64, 256),
                     "kv_down": (2, 256, 80), "kv_norm": (2, 64)},
    "deepseek-q48-1x2": {"q_down": (2, 256, 48), "q_norm": (2, 48),
                         "q_up": (2, 48, 96), "k_up": (2, 64, 64),
                         "v_up": (2, 64, 64), "wo": (2, 64, 256),
                         "kv_down": (2, 256, 80), "kv_norm": (2, 64)},
    "deepseek-q48-2x2-zero": {"q_up": (2, 48, 96), "wo": (2, 64, 256),
                              "q_down": (2, 256, 48)}}


@pytest.mark.parametrize("tag", sorted(MLA_LOCAL))
def test_mla_leaves_are_split_as_the_tables_say(ranks, tag):
    """The reference's ``_ATTN`` rules for MLA: ``q_up``/``wq``, ``k_up``
    and ``v_up`` by columns and ``wo`` by rows, each rank whole heads;
    ``q_down``, ``kv_down`` and the norms whole, and among the leaves the
    ranks hold bit-identical."""
    for rank in _of(ranks, tag):
        local = rank["local"]
        for leaf, shape in MLA_LOCAL[tag].items():
            assert local[f"layers/attn/{leaf}"] == shape, leaf
        for leaf in ("q_down", "q_norm", "kv_down", "kv_norm"):
            if f"layers/attn/{leaf}" in local:
                assert f"layers/attn/{leaf}" in rank["replicated"], leaf


@pytest.mark.parametrize("tag", [f"{m}-1x2" for m in MOE_MODELS]
                         + [t["tag"] for t in MOE_FOUR + MLA_FOUR
                            if t["model"] in MOE_MODELS])
def test_moe_aux_loss_and_dropped_share_match_the_reference(
        reference, alone, ranks, tag):
    """Every rank's aux loss a step is the reference pipeline's; the
    first MoE call's ``dropped_frac`` (layer 0 of step 0's first
    microbatch: the global microbatch's share on every rank) is the
    reference's ``moe_block`` on the same input, which drops slots."""
    from repro.models import moe as rmoe
    model = _model(RUNS[tag])
    ref = reference[model]
    arch, changes = MODELS[model]
    rcfg = dataclasses.replace(ref_get_config(arch).reduced(), **changes)
    p0 = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]),
                                ref["init"]["layers"]["moe"])
    _, raux = rmoe.moe_block(rcfg, p0, jnp.asarray(alone[tag]["moe_x"]))
    want = float(raux["dropped_frac"])
    assert want > 0
    for rank in _of(ranks, tag):
        np.testing.assert_allclose(rank["aux_losses"], ref["aux_losses"],
                                   **MOE_AUX)
        np.testing.assert_allclose(rank["dropped"], want, **MOE_DROPPED)


def test_vocab_parallel_loss_matches_the_plain_loss(ranks):
    for rank in ranks["two"]:
        value, grad = rank["units"]["nll"]       # relative; measured
        assert value <= 1e-6 and grad <= 2e-6     # 0 and 3.6e-7


# the leaves each non-aligned unit stores split over its 2 ranks
NON_ALIGNED_SPLIT = {
    "heads_3": ["bk", "bq", "bv", "wk", "wo", "wq", "wv"],
    "heads_6_kv_3": ["wk", "wo", "wq", "wv"],
    "mla_heads_3": ["k_up", "q_up", "v_up", "wo"],
    "mla_heads_3_vd_15": ["k_up", "wq"]}


@pytest.mark.parametrize("name", sorted(NON_ALIGNED_SPLIT))
def test_non_aligned_heads_match_the_plain_block(ranks, name):
    """Heads the ranks do not split evenly: the leaves are still stored
    split; gathered for the product (the whole ones passed through
    ``copy_to_model``); output and gradients as the plain block's, GQA
    and MLA (3 heads; at a value width of 15 ``v_up`` and ``wo`` are
    whole, and each rank takes its ``tensor_split`` chunk of ``wo``'s
    rows)."""
    for rank in ranks["two"]:
        got = rank["units"][name]
        assert got["split"] == NON_ALIGNED_SPLIT[name]
        # relative to the plain block's largest magnitude; measured
        # 4.9e-7, 5.6e-7 and 8.5e-7 at most
        assert got["out"] <= 5e-6
        assert got["x_grad"] <= 5e-6
        assert got["param_grads"] <= 5e-6


def test_non_aligned_mla_decode_matches_the_plain_decode(ranks):
    """3 MLA heads over 2 ranks at decode: every head computed on every
    rank (the split leaves gathered), each rank its share of ``wo``, the
    shares summed; on the whole latent cache and on the rank's stripe of
    it (the stripes' partials merged), as the plain absorbed decode."""
    for rank in ranks["two"]:
        got = rank["units"]["mla_decode_heads_3"]
        assert got["split"] == ["k_up", "q_up", "v_up", "wo"]
        # relative to the plain output's largest magnitude; measured
        # 2.2e-7 either way
        assert got["whole"] <= 5e-6 and got["striped"] <= 5e-6


def _npz(path) -> list:
    with zipfile.ZipFile(path) as z:
        return [(n, z.read(n)) for n in z.namelist()]


@pytest.mark.parametrize("tag", ["smollm-135m-1x2", "tree",
                                 "deepseek-q48-1x2"])
def test_checkpoints_saved_on_1x2_are_the_1x1_files(alone, ranks, reference,
                                                    tmp_path, tag):
    """The initial state saved on 1x2 is byte-equal to the run alone's;
    the final state, restored without a mesh and saved again, is the
    1x2 file byte for byte; each rank restored it into its blocks; and
    the reference's ``restore_train_state`` reads it."""
    mesh_dir, one_dir = ranks["ckpt"], alone["_dir"]
    assert _npz(mesh_dir / f"{tag}-init.npz") == \
        _npz(one_dir / f"{tag}-init.npz")
    assert all(r[tag]["restored"] for r in ranks["two"])
    run = RUNS[tag]
    cfg = dataclasses.replace(get_config(run["arch"]).reduced(),
                              **run.get("changes", {}))
    from repro_torch.core import lars
    pipe = TrainPipeline(build_model(cfg),
                         lars(0.05, trust_coefficient=0.01), cfg,
                         accum_steps=ACCUM, packed=run.get("packed", True))
    template = pipe.init_state(torch.Generator().manual_seed(1), "cpu")
    state = restore_train_state(str(mesh_dir / f"{tag}.npz"), template)
    save_train_state(str(tmp_path / "again.npz"), state)
    assert _npz(tmp_path / "again.npz") == _npz(mesh_dir / f"{tag}.npz")
    got = _leaves(ranks["two"][0][tag]["params"])
    for k, v in _leaves(state.params).items():
        assert np.array_equal(v, got[k])
    template = reference[_model(run)]["template"]
    if not run.get("packed", True):
        ref_cfg = ref_get_config(run["arch"]).reduced()
        template = RefPipeline(
            ref_build_model(ref_cfg), ref_core.lars(
                0.05, trust_coefficient=0.01, use_pallas=False),
            ref_cfg, accum_steps=ACCUM, packed=False,
            donate=False).init_state(jax.random.key(0))
    back = ref_restore(str(mesh_dir / f"{tag}.npz"), template)
    for k, v in _leaves(back.params).items():
        assert np.array_equal(v, got[k])
