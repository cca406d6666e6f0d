"""The serving mesh of the port (``ServeEngine(mesh=)``, ``SlotCache``
under ``cache_pspecs``, ``launch.serve --mesh``) on gloo CPU ranks
(tests/_torch_dist_worker.py), against the reference's single-device
``ServeEngine`` and the port's engine alone; and its pieces without
ranks: ``flash_decode``'s log-sum-exp, the merge of stripes, the cache's
sharding.

The reference's own mesh test (tests/test_serve.py:
``test_eight_device_mesh_serve_matches_single_device``: reduced
qwen3-14b and falcon-mamba-7b, prompts [5, 9, 7, 6, 11, 5] drawn with
seed 13, 4 slots, capacity 64, 5 new tokens, greedy tokens identical to
one device) is re-run in the port's form: qwen3-14b on 2x2 and 1x2, at
one slot on 2x2 (context parallelism: the sequence over both axes, four
stripes), at capacity 63 (no stripes: the cache is replicated) and at
capacities whose stripes the prompts span; falcon-mamba on 2x1 (its
family splits nothing over ``model``); reduced granite with capacity
drops (8 experts, top-2, capacity factor 0.5) on 2x1 (every slot routed
over ``data`` at each tick, each admitted group prefilled whole), 1x2
(the experts split over ``model``) and 2x2; reduced deepseek-v2-236b
(MLA) with a query rank of 48 and the same drops on 2x1, 1x2 and 2x2 (its
heads split, its latent cache striped), at 3 slots on 2x2 (``data`` does
not divide them: the latent cache's sequence over both axes, four
stripes, held against the reference's engine at 3 slots, whose routing
the slot count changes) and at capacity 63 on 1x2 (no stripes: the
latent cache replicated). Tokens are held IDENTICAL to the reference's;
the stochastic sampler and the priority scheduler to the port's engine
alone. What the slice leaves out still refuses.

One spawn of 4 ranks and one of 2 serve every test (a module fixture),
in threads beside the reference's engines.
"""

import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.serve import ServeEngine as RefServeEngine
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import (CacheSharding, LocalCache,
                                              cache_pspecs)
from repro_torch.kernels import build
from repro_torch.kernels import flash_decode as fdk
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model
from repro_torch.serve import DecodeEngine, ServeEngine
import _torch_dist_worker as worker

LENS = [5, 9, 7, 6, 11, 5]
NEW = 5
# merged stripes against the whole cache, f32 (measured <= 2.4e-7)
MERGE_ATOL = 1e-6


def _prompts(vocab: int) -> list:
    """tests/test_serve.py's ``_prompts(cfg, LENS, seed=13)``."""
    rng = np.random.default_rng(13)
    return [rng.integers(0, vocab, (n,)) for n in LENS]


def _run(tag, model, mesh, **kw):
    """A run on ``mesh`` of ``model`` (a key of MODELS)."""
    arch, changes = MODELS[model]
    return dict(tag=tag, arch=arch, model=model, changes=changes, mesh=mesh,
                new=NEW, **kw)


def _eng(slots=4, capacity=64, **kw):
    return {"engine": dict(slots=slots, capacity=capacity, **kw)}


# the slots of the reference's engine each run is held against: 4, or
# the run's own where the MoE's capacity couples the slots' tokens
REF_SLOTS = 4


def _ref_key(run) -> tuple:
    return run["model"], run.get("ref_slots", REF_SLOTS)


DROP = {"num_experts": 8, "experts_per_token": 2, "capacity_factor": 0.5}
# the models: (config, changes); 3 query heads on 1 KV head do not
# divide over 2 ranks (every head computed whole on every rank)
MODELS = {"qwen3-14b": ("qwen3-14b", {}),
          "qwen3-heads3": ("qwen3-14b", {"num_heads": 3, "num_kv_heads": 1}),
          "falcon-mamba-7b": ("falcon-mamba-7b", {}),
          "granite": ("granite-moe-3b-a800m", DROP),
          "deepseek": ("deepseek-v2-236b", dict(DROP, q_lora_rank=48))}
# runs held against the reference's single-device engine (greedy)
FOUR_REF = [_run("qwen3-2x2", "qwen3-14b", "2x2", **_eng()),
            _run("qwen3-2x2-cp", "qwen3-14b", "2x2", **_eng(slots=1)),
            _run("qwen3-2x2-span", "qwen3-14b", "2x2", **_eng(capacity=16)),
            _run("qwen3-2x2-cp-span", "qwen3-14b", "2x2",
                 **_eng(slots=1, capacity=32)),
            _run("granite-2x2", "granite", "2x2", **_eng()),
            _run("deepseek-2x2", "deepseek", "2x2", **_eng()),
            _run("deepseek-2x2-cp", "deepseek", "2x2", ref_slots=3,
                 **_eng(slots=3))]
TWO_REF = [_run("qwen3-1x2", "qwen3-14b", "1x2", **_eng()),
           _run("qwen3-1x2-63", "qwen3-14b", "1x2", **_eng(capacity=63)),
           _run("heads3-1x2", "qwen3-heads3", "1x2", **_eng(capacity=16)),
           _run("falcon-2x1", "falcon-mamba-7b", "2x1", **_eng()),
           _run("granite-2x1", "granite", "2x1", **_eng()),
           _run("granite-1x2", "granite", "1x2", **_eng()),
           _run("deepseek-2x1", "deepseek", "2x1", **_eng()),
           _run("deepseek-1x2", "deepseek", "1x2", **_eng()),
           _run("deepseek-1x2-63", "deepseek", "1x2", **_eng(capacity=63))]
# runs held against the port's engine alone
TOPK = {"kind": "top_k", "top_k": 8, "temperature": 0.8}
SLOS = {0: (10.0, 60.0), 1: (30.0, 120.0)}
FOUR_ALONE = [_run("top_k-2x2", "qwen3-14b", "2x2", **_eng(sampler=TOPK)),
              _run("tiers-2x2", "qwen3-14b", "2x2", tiers=[1, 0, 1, 0, 1, 0],
                   **_eng(slots=2, slos=SLOS, preempt=False))]
# what the slice refuses: (model, engine options, the ROADMAP item its
# message names)
REFUSED = {"falcon-1x2": ("falcon-mamba-7b", {}, "4b-ii"),
           "chunk-1x2": ("qwen3-14b", {"prefill_chunk": 4}, "4c-ii"),
           "chunk-mla-1x2": ("deepseek", {"prefill_chunk": 4}, "4c-ii"),
           "prefix-1x2": ("qwen3-14b", {"prefix_entries": 2}, "4c-ii"),
           "preempt-1x2": ("qwen3-14b", {"slos": SLOS}, "4c-ii")}
TWO_REFUSE = [_run(tag, model, "1x2", refuse=True, **_eng(**kw))
              for tag, (model, kw, _) in REFUSED.items()]
CLI = ["--arch", "smollm-135m", "--reduced", "--device", "cpu",
       "--requests", "4", "--slots", "2"]
FOUR = FOUR_REF + FOUR_ALONE
TWO = TWO_REF + TWO_REFUSE
RUNS = {r["tag"]: r for r in FOUR + TWO}


def _reference(model):
    """The reference's model from ``jax.random.key(1)`` (as
    tests/test_serve.py's ``_model``), its config and params."""
    arch, changes = MODELS[model]
    cfg = dataclasses.replace(ref_get_config(arch).reduced(), **changes)
    rmodel = ref_build_model(cfg)
    return cfg, rmodel, rmodel.init(jax.random.key(1))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The two spawns (4 ranks: FOUR; 2 ranks: TWO and ``launch.serve
    --mesh 1x2``), from the reference's inits, in threads while this
    process runs the reference's single-device engines (greedy tokens
    on the prompts), then the port's runs alone (FOUR_ALONE without a
    mesh) and ``launch.serve`` without a mesh."""
    tmp = tmp_path_factory.mktemp("serve_mesh")
    ref = {model: _reference(model) for model in MODELS}
    inits = {model: jax.device_get(r[2]) for model, r in ref.items()}
    prompts = {model: _prompts(r[0].vocab_size) for model, r in ref.items()}
    ranks = {}

    def spawn(key, n, runs, cli=None):
        ranks[key] = worker.spawn("serve_mesh", n, tmp / key, runs=runs,
                                  inits=inits, prompts=prompts, cli=cli)

    threads = [threading.Thread(target=spawn, args=a) for a in (
        ("four", 4, FOUR), ("two", 2, TWO, CLI + ["--mesh", "1x2"]))]
    for t in threads:
        t.start()
    try:
        tokens = {}
        for model, slots in sorted({_ref_key(r) for r in FOUR_REF + TWO_REF}):
            cfg, rmodel, params = ref[model]
            tokens[model, slots] = [t.tolist() for t in RefServeEngine(
                rmodel, params, cfg, slots=slots, capacity=64).generate(
                    prompts[model], NEW)]
        before = torch.get_num_threads()
        torch.set_num_threads(1)
        alone = {run["tag"]: worker.serve_run(
            run, inits[run["model"]], prompts[run["model"]])
            for run in FOUR_ALONE}
        alone["cli"] = {f.request.rid: f.tokens.tolist()
                        for f in launch_serve.main(CLI)["finished"]}
        torch.set_num_threads(before)
    finally:
        for t in threads:
            t.join()
    assert "four" in ranks and "two" in ranks, "a spawn failed"
    return tokens, alone, ranks


def _of(ranks, tag) -> list:
    return [r[tag] for r in ranks["four" if any(
        t["tag"] == tag for t in FOUR) else "two"]]


# ------------------------------------------------------------ on the ranks

@pytest.mark.parametrize("tag", [r["tag"] for r in FOUR_REF + TWO_REF])
def test_tokens_match_the_references_single_device_engine(results, tag):
    """Every rank's greedy tokens are the reference's single-device
    engine's, identically (reduced qwen3-14b on 2x2, 1x2, context
    parallel, replicated and spanning stripes; 3 query heads on 1 KV
    head over 2 ranks: every head computed whole; falcon-mamba on
    2x1; granite with drops on 2x1, 1x2 and 2x2; deepseek's MLA with
    drops on 2x1, 1x2 and 2x2, over four stripes at 3 slots on 2x2, and
    replicated at capacity 63)."""
    ref, _, ranks = results
    want = ref[_ref_key(RUNS[tag])]
    for rank in _of(ranks, tag):
        assert [rank["tokens"][i] for i in range(len(LENS))] == want


@pytest.mark.parametrize("tag", [r["tag"] for r in FOUR + TWO_REF])
def test_one_decode_step_and_a_wrapper_call_a_layer_each_tick(results, tag):
    """One ``decode_step`` a tick on every rank, and ``num_layers``
    ``flash_decode`` wrapper calls in it (none outside the ticks; none
    for the SSM family or MLA, whose absorbed decode is torch ops); the
    ranks' scheduler digests agree."""
    _, _, ranks = results
    run = RUNS[tag]
    layers = get_config("qwen3-14b").reduced().num_layers
    per_tick = 0 if run["arch"] in ("falcon-mamba-7b", "deepseek-v2-236b") \
        else layers
    for rank in _of(ranks, tag):
        assert rank["decode_calls"] == rank["decode_steps"] > 0
        assert rank["wrapper_calls"] == per_tick * rank["decode_calls"]
        assert rank["agree"] is True


@pytest.mark.parametrize("tag,stripe", [
    ("qwen3-2x2", "model"), ("qwen3-2x2-cp", ("data", "model")),
    ("qwen3-1x2", "model"), ("qwen3-1x2-63", None),
    ("qwen3-2x2-span", "model"), ("falcon-2x1", None),
    ("deepseek-1x2", "model"), ("deepseek-2x2-cp", ("data", "model")),
    ("deepseek-1x2-63", None), ("deepseek-2x1", None)])
def test_the_cache_is_split_as_cache_pspecs_says(results, tag, stripe):
    """Each rank's leaves are its block of the slots and its stripe of
    the sequence: 2x2 splits 4 slots over data and 64 rows over model;
    one slot (or three: ``data`` does not divide them) on 2x2 keeps the
    slots whole and splits the rows four ways (stripe d * 2 + m);
    capacity 63 keeps every leaf whole. MLA's latent cache as a K/V
    cache. The cache reports the whole capacity on every rank."""
    _, _, ranks = results
    run = RUNS[tag]
    slots, cap = run["engine"]["slots"], run["engine"]["capacity"]
    got = _of(ranks, tag)
    for r, rank in enumerate(got):
        if stripe is None:
            assert rank["stripe"] is None
        else:
            count = 4 if isinstance(stripe, tuple) else 2
            assert rank["stripe"][1:] == (count, cap // count, stripe)
            m = r % 2
            assert rank["stripe"][0] == (r if count == 4 else m)
        if run["arch"] != "falcon-mamba-7b":
            assert rank["capacity"] == cap
            rows = cap if rank["stripe"] is None else rank["stripe"][2]
            for leaf in ("k", "ckv", "krope"):
                if leaf in rank["local"]:
                    assert rank["local"][leaf][2] == rows
        data = 2 if run["mesh"].startswith("2") else 1
        split = data > 1 and slots % data == 0
        per = slots // data if split else slots
        assert rank["local"]["pos"] == (per,)
        first = (r // (4 // data) if run["mesh"] == "2x2" else r) * per \
            if split else 0
        assert rank["slot_block"] == (first, first + per)


@pytest.mark.parametrize("tag", [r["tag"] for r in FOUR_ALONE])
def test_sampler_and_tiers_match_the_engine_alone(results, tag):
    """top_k sampling (the counter-hash keys, rows gathered over the
    vocabulary) gives the port's engine alone's tokens; the priority
    scheduler (two tiers, preemption off, 2 slots for 6 requests)
    finishes the requests in the same order with the same tokens."""
    _, alone, ranks = results
    want = alone[tag]
    for rank in _of(ranks, tag):
        assert rank["tokens"] == want["tokens"]
        assert rank["order"] == want["order"]
        assert rank["agree"] is True
    if tag.startswith("top_k"):
        assert any(len(set(t)) > 1 for t in want["tokens"].values())


@pytest.mark.parametrize("tag", list(REFUSED))
def test_what_the_slice_leaves_out_still_refuses(results, tag):
    """falcon-mamba on a model axis of 2 (the SSM family splits nothing:
    queue 1 item 4b-ii); chunked prefill (GQA and MLA's), the prefix
    store and preemption on a mesh (item 4c-ii)."""
    _, _, ranks = results
    item = REFUSED[tag][2]
    for rank in _of(ranks, tag):
        assert rank["refused"] is not None and item in rank["refused"]


def test_launch_serve_on_a_mesh_reports_the_tokens_alone(results):
    """``launch.serve --mesh 1x2`` inside the ranks: rank 0's report has
    the tokens of ``launch.serve`` without a mesh, and the ranks'
    digests agree."""
    _, alone, ranks = results
    got = [r["cli"] for r in ranks["two"]]
    assert got[0]["tokens"] == alone["cli"] and got[0]["tokens"]
    assert got[0]["mesh"] == {"data": 1, "model": 2}
    assert all(g["agree"] is True for g in got)


# ------------------------------------------------------------ no ranks

def _fd_inputs(B, S, Hkv, G, D, lengths, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, Hkv, G, D, generator=g)
    k = torch.randn(B, S, Hkv, D, generator=g)
    v = torch.randn(B, S, Hkv, D, generator=g)
    return q, k, v, torch.tensor(lengths, dtype=torch.int32)


@pytest.mark.parametrize("softcap", [0.0, 5.0])
@pytest.mark.parametrize("lengths", [[0, 3, 16, 40], [1, 0, 0, 9]])
def test_plain_lse_is_the_log_sum_exp_of_the_scores(softcap, lengths):
    """``flash_decode_plain(lse=True)`` against a direct log-sum-exp of
    the scaled, capped and masked scores: -inf and a zero output on an
    empty row, every key of a full ring (a length past S) taken; the
    output is the plain version's, in f32; the split decomposition gives
    the same (out, lse)."""
    S, D = 16, 32
    q, k, v, lens = _fd_inputs(4, S, 2, 3, D, lengths)
    scale = D ** -0.5
    out, lse = fdk.flash_decode_plain(q, k, v, lens, scale=scale,
                                      softcap=softcap, lse=True)
    s = torch.einsum("bhgd,bshd->bhgs", q, k) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    mask = torch.arange(S)[None, None, None] < lens[:, None, None, None]
    want = torch.logsumexp(torch.where(mask, s, -torch.inf), dim=-1)
    assert out.dtype == lse.dtype == torch.float32
    assert lse.shape == (4, 2, 3)
    empty = lens == 0
    assert torch.isneginf(lse[empty]).all() and (out[empty] == 0).all()
    torch.testing.assert_close(lse[~empty], want[~empty], rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(out, fdk.flash_decode_plain(
        q, k, v, lens, scale=scale, softcap=softcap), rtol=0, atol=0)
    sout, slse = fdk.flash_decode_split_plain(
        q, k, v, lens, scale=scale, splits=3, softcap=softcap, lse=True)
    torch.testing.assert_close(sout, out, rtol=1e-6, atol=1e-6)
    assert torch.isneginf(slse[empty]).all()
    torch.testing.assert_close(slse[~empty], lse[~empty], rtol=1e-6,
                               atol=1e-6)


def test_ops_wrapper_takes_the_lse():
    """The (B, H, D) front end passes ``lse`` through: (out (B, H, D)
    f32, lse (B, H))."""
    q, k, v, lens = _fd_inputs(2, 8, 2, 2, 16, [3, 8])
    out, lse = ops.flash_decode(q.reshape(2, 4, 16), k, v, lens, lse=True)
    assert out.shape == (2, 4, 16) and lse.shape == (2, 4)
    torch.testing.assert_close(out, ops.flash_decode(
        q.reshape(2, 4, 16), k, v, lens), rtol=0, atol=0)


@pytest.mark.parametrize("stripes", [2, 3, 4])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_merged_stripes_equal_the_whole_cache(stripes, softcap):
    """The cache cut into ``stripes`` stripes of its rows, each stripe's
    (out, lse) at its own valid length clamp(n - r * rows, 0, rows), and
    ``merge_stripes`` of them: the whole cache's output within
    MERGE_ATOL in f32, rows in one stripe, rows spanning several, empty
    rows (zeros) and full rows alike."""
    rows = 8
    S, D = rows * stripes, 64
    lengths = [0, 1, rows, rows + 1, S - 3, S, 2 * S]
    q, k, v, lens = _fd_inputs(len(lengths), S, 2, 4, D, lengths, seed=3)
    scale = D ** -0.5
    whole = fdk.flash_decode_plain(q, k, v, lens, scale=scale,
                                   softcap=softcap)
    outs, lses = [], []
    for r in range(stripes):
        n = torch.clamp(torch.clamp(lens, max=S) - r * rows, 0, rows)
        o, lse = fdk.flash_decode_plain(
            q, k[:, r * rows:(r + 1) * rows].contiguous(),
            v[:, r * rows:(r + 1) * rows].contiguous(), n.to(torch.int32),
            scale=scale, softcap=softcap, lse=True)
        outs.append(o)
        lses.append(lse)
    got = fdk.merge_stripes(outs, lses)
    assert got.dtype == torch.float32
    assert (got[0] == 0).all() and torch.isfinite(got).all()
    torch.testing.assert_close(got, whole, rtol=0, atol=MERGE_ATOL)


class _Mesh:
    """A stand-in mesh for the sharding rules: shape and this rank's
    coordinates (no process group)."""

    axis_names = ("data", "model")

    def __init__(self, data, model, d=0, m=0):
        self.shape = {"data": data, "model": model}
        self.coords = {"data": d, "model": m}


@pytest.mark.parametrize("data,model,slots,cap,block,stripe", [
    (2, 2, 4, 64, (2, 4), (1, 2, 32, "model")),
    (2, 2, 1, 64, (0, 1), (3, 4, 16, ("data", "model"))),
    (1, 2, 4, 63, (0, 4), None),
    (4, 1, 8, 64, (6, 8), None),
    (3, 1, 2, 60, (0, 2), (2, 3, 20, ("data", "model")))])
def test_cache_sharding_executes_cache_pspecs(data, model, slots, cap,
                                              block, stripe):
    """:class:`CacheSharding` for the last rank of each mesh: the
    reference's specs, this data rank's slot block, its stripe (index,
    count, rows, axes) and each leaf's local shape."""
    m = _Mesh(data, model, data - 1, model - 1)
    lm = build_model(get_config("qwen3-14b").reduced())
    shapes = {k: v[0] for k, v in lm.cache_shapes(slots, cap).items()}
    sh = CacheSharding(lm.cfg, m, shapes, slots=slots)
    assert sh.specs == cache_pspecs(lm.cfg, m, {
        k: torch.empty(v, device="meta") for k, v in shapes.items()},
        batch=slots)
    assert (sh.slot_block.start, sh.slot_block.stop) == block
    assert (None if sh.stripe is None else tuple(sh.stripe[:4])) == stripe
    per = block[1] - block[0]
    rows = cap if stripe is None else stripe[2]
    assert sh.local_shape("k") == (shapes["k"][0], per, rows) + \
        shapes["k"][3:]
    assert sh.local_shape("pos") == (per,)
    local = lm.init_cache(slots, cap, device="meta", sharding=sh)
    assert isinstance(local, LocalCache) and local.stripe == sh.stripe
    assert lm.cache_capacity(local) == cap


def test_ptxas_labels_name_the_lse_instances():
    """``kernels.build`` names a kernel's log-sum-exp instances apart
    from the others (a third bool template argument)."""
    base = ("_ZN38_GLOBAL__N__bafb2253_15_flash_decode_cu_9e09dc2224"
            "flash_decode_wide_kernel")
    assert build._kernel_label(base + "ILi256ELb0ELb1EEEvPK13") == \
        "flash_decode_wide_kernel<256,lse>"
    assert build._kernel_label(base + "ILi256ELb1ELb1EEEvPK13") == \
        "flash_decode_wide_kernel<256,softcap,lse>"
    assert build._kernel_label(base + "ILi256ELb1ELb0EEEvPK13") == \
        "flash_decode_wide_kernel<256,softcap>"
    assert build._kernel_label(base + "ILi256ELb0ELb0EEEvPK13") == \
        "flash_decode_wide_kernel<256>"


def test_decode_engine_refuses_a_mesh():
    """The static-batch engine on a mesh is queue 1 item 4c-ii."""
    cfg = get_config("smollm-135m").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="4c-ii"):
        DecodeEngine(model, params, cfg, mesh=object())


def test_a_mesh_of_one_rank_serves_the_engine_alones_tokens():
    """``mesh_from_spec("1x1")`` without a process group: one rank,
    every collective the identity, the engine alone's tokens."""
    from repro_torch.launch.mesh import mesh_from_spec
    cfg = get_config("qwen3-14b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(1), "cpu")
    prompts = _prompts(cfg.vocab_size)
    want = ServeEngine(model, params, cfg, slots=4,
                       capacity=64).generate(prompts, NEW)
    engine = ServeEngine(model, params, cfg, slots=4, capacity=64,
                         mesh=mesh_from_spec("1x1", device="cpu"))
    got = engine.generate(prompts, NEW)
    assert [t.tolist() for t in got] == [t.tolist() for t in want]
    assert engine.ranks_agree() and engine.cache.data.stripe is None
