"""The port's serve stack (``repro_torch.serve``, ``launch.serve``) on
the CPU against the JAX package: sampling masks, slot accounting and
FIFO admissions on one submission sequence, and the continuous-batching
engine's greedy tokens for staggered heterogeneous requests from the
same carried params. The stochastic draw uses the port's own
counter-based keys (JAX's threefry is not reproduced), so its contract
is checked on the port alone: output independent of the slot and of
the admission tick, and draws that follow the distribution.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.serve import ServeEngine as RefServeEngine
from repro.serve import SlotCache as RefSlotCache
from repro.serve import sampling as ref_sampling
from repro.serve.scheduler import Request as RefRequest
from repro.serve.scheduler import RequestScheduler as RefScheduler
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.mesh import mesh_from_spec
from repro_torch.models import build_model
from repro_torch.serve import report
from repro_torch.serve import (QueueFull, Request, RequestScheduler,
                               SamplerConfig, ServeEngine, SlotCache,
                               make_prefill_step, make_serve_step,
                               parse_sampler, sampling)

_PAIR = {}


def _pair():
    """(cfg, port model, port params, ref model, ref params), reduced
    smollm (2 layers, 4 heads over 1 kv head, vocab 512)."""
    if not _PAIR:
        rcfg = ref_get_config("smollm-135m").reduced()
        cfg = get_config("smollm-135m").reduced()
        rmodel = ref_build_model(rcfg)
        rparams = rmodel.init(jax.random.key(1))
        model = build_model(cfg)
        params = bridge.lm_params_to_torch(jax.device_get(rparams), model)
        _PAIR["v"] = (cfg, model, params, rmodel, rparams)
    return _PAIR["v"]


# ---------------------------------------------------------------- sampling

@pytest.mark.parametrize("spec", ["greedy", "temperature:0.7", "top_k:40",
                                  "top_k:5:0.8", "top_p:0.9",
                                  "top_p:0.5:1.5"])
def test_parse_sampler_matches_reference(spec):
    assert dataclasses.asdict(parse_sampler(spec)) == \
        dataclasses.asdict(ref_sampling.parse_sampler(spec))


@pytest.mark.parametrize("spec", ["bogus", "top_k:x", "top_k:0",
                                  "top_p:1.5", "greedy:1"])
def test_bad_sampler_specs_raise_like_the_reference(spec):
    with pytest.raises(ValueError):
        ref_sampling.parse_sampler(spec)
    with pytest.raises(ValueError):
        parse_sampler(spec)


def _logits(seed=0, shape=(4, 64)):
    # distinct values, spread enough that no softmax prefix sits on p
    rng = np.random.default_rng(seed)
    return (rng.permutation(shape[0] * shape[1]).reshape(shape)
            .astype(np.float32) * 0.05 - 3.0)


@pytest.mark.parametrize("k", [1, 5, 64])
def test_top_k_mask_matches_reference(k):
    x = _logits(1)
    np.testing.assert_array_equal(
        sampling._top_k_mask(torch.tensor(x), k).numpy(),
        np.asarray(ref_sampling._top_k_mask(jnp.asarray(x), k)))


@pytest.mark.parametrize("p", [0.05, 0.5, 0.9, 1.0])
def test_top_p_mask_matches_reference(p):
    x = _logits(2)
    np.testing.assert_array_equal(
        sampling._top_p_mask(torch.tensor(x), p).numpy(),
        np.asarray(ref_sampling._top_p_mask(jnp.asarray(x), p)))


def test_greedy_sample_matches_reference():
    x = _logits(3)
    got = sampling.sample(SamplerConfig(), torch.tensor(x),
                          torch.zeros(4, 2, dtype=torch.int64))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        ref_sampling.sample(ref_sampling.SamplerConfig(), jnp.asarray(x),
                            jnp.zeros((4, 2), jnp.uint32))))


def test_keys_are_pure_functions_of_seed_request_and_position():
    a = sampling.make_keys(7, [3, 11, 5])
    b = sampling.make_keys(7, [5, 3])
    assert torch.equal(a[0], b[1]) and torch.equal(a[2], b[0])
    assert not torch.equal(a[0], sampling.make_keys(8, [3])[0])
    assert int(a.min()) >= 0 and int(a.max()) < 2 ** 32
    f = sampling.fold_positions(a, torch.tensor([10, 10, 4]))
    g = sampling.fold_positions(a[[2, 0]], torch.tensor([4, 10]))
    assert torch.equal(f[[2, 0]], g)
    assert not torch.equal(f[0], sampling.fold_positions(
        a[:1], torch.tensor([11]))[0])


def test_stochastic_draw_follows_the_distribution():
    """Gumbel-max over the port's hashed uniforms: 4000 draws from one
    row of 8 logits (one key per position) against its softmax."""
    logits = torch.tensor([[2.0, 1.0, 0.5, 0.0, -0.5, -1.0, -2.0, -9.0]])
    keys = sampling.fold_positions(
        sampling.make_keys(0, [0]).expand(4000, 2),
        torch.arange(4000))
    draws = sampling.sample(SamplerConfig("temperature"),
                            logits.expand(4000, 8), keys)
    freq = torch.bincount(draws.long(), minlength=8).float() / 4000
    want = torch.softmax(logits[0], -1)
    # binomial standard error at n = 4000 is <= 0.008
    assert torch.allclose(freq, want, atol=0.03)
    top = sampling.sample(SamplerConfig("top_k", top_k=2),
                          logits.expand(4000, 8), keys)
    assert set(top.tolist()) == {0, 1}


# ------------------------------------------------- cache and scheduler

def test_slot_cache_and_fifo_admissions_match_reference():
    """One submission sequence through both packages' SlotCache and
    RequestScheduler: the same groups, slots and retirements."""
    cfg, model, _, rmodel, _ = _pair()
    cache, rcache = SlotCache(model, 3, 32), RefSlotCache(rmodel, 3, 32)
    assert cache.data["k"].shape == rcache.data["k"].shape
    sch = RequestScheduler(cache, max_queue=4, prefill_bucket=8)
    rsch = RefScheduler(rcache, max_queue=4, prefill_bucket=8)
    rng = np.random.default_rng(0)
    lens = [5, 12, 3, 9, 17, 8]
    trace, rtrace = [], []
    with pytest.raises(ValueError, match="capacity"):
        sch.submit(Request(10, np.ones(31), 4))       # pads to 32, + 4
    for i, n in enumerate(lens[:4]):
        toks = rng.integers(0, cfg.vocab_size, (n,))
        sch.submit(Request(i, toks, 2), now=float(i))
        rsch.submit(RefRequest(i, toks, 2), now=float(i))
    with pytest.raises(QueueFull):
        sch.submit(Request(9, [1], 1))

    def admit(s, out):
        groups = s.pop_admissions()
        out.append(sorted((pad, slot, req.rid) for pad, g in groups.items()
                          for slot, req, _ in g))

    for tick in range(6):
        for s, out in ((sch, trace), (rsch, rtrace)):
            admit(s, out)
            for slot in sorted(s.active):
                fin = s.record(slot, 1, now=10.0 + tick)
                if fin is not None:
                    out.append(("done", fin.request.rid,
                                fin.tokens.tolist()))
        if tick == 1:
            for i in (4, 5):
                toks = rng.integers(0, cfg.vocab_size, (lens[i],))
                sch.submit(Request(i, toks, 2), now=float(i))
                rsch.submit(RefRequest(i, toks, 2), now=float(i))
    assert trace == rtrace
    assert cache.free_slots == rcache.free_slots == 3
    assert sch.slot_accounting_ok() and not sch.has_work()


@pytest.mark.parametrize("bucket", [1, 4, 16])
def test_admission_groups_by_padded_length_match_reference(bucket):
    """Eight mixed-length prompts into five slots, then the rest as the
    first retire: the same prefill groups (one per padded length), slots
    and submit times as the reference's, for three bucket sizes."""
    _, model, _, rmodel, _ = _pair()
    lens = [3, 17, 4, 16, 9, 1, 30, 12]
    out = []
    for S, C, R, m in ((RequestScheduler, SlotCache, Request, model),
                       (RefScheduler, RefSlotCache, RefRequest, rmodel)):
        sch = S(C(m, 5, 48), prefill_bucket=bucket)
        for i, n in enumerate(lens):
            sch.submit(R(i, np.arange(n) % 7, 1 + i % 3), now=float(i))
        trace = []
        while sch.has_work():
            groups = sch.pop_admissions()
            trace.append(sorted((pad, slot, req.rid, t0)
                                for pad, g in groups.items()
                                for slot, req, t0 in g))
            assert all(pad % bucket == 0 and pad >= req.prompt_len
                       for pad, g in groups.items() for _, req, _ in g)
            for slot in sorted(sch.active):
                fin = sch.record(slot, 3, now=100.0)
                if fin is not None:
                    trace.append(("done", fin.request.rid, slot))
        assert sch.slot_accounting_ok()
        out.append(trace)
    assert out[0] == out[1]


# ------------------------------------------------------------------ engine

def _drive(engine, schedule, cfg):
    """Submit ``schedule`` [(tick, rid, prompt_len, max_new)] at its
    ticks, step until drained; -> ({rid: tokens}, [finished rids by
    tick])."""
    rng = np.random.default_rng(5)
    prompts = {rid: rng.integers(0, cfg.vocab_size, (n,))
               for _, rid, n, _ in schedule}
    tokens, order, tick, pending = {}, [], 0, list(schedule)
    while pending or engine.scheduler.has_work():
        while pending and pending[0][0] <= tick:
            _, rid, _, new = pending.pop(0)
            engine.submit(prompts[rid], new, rid=rid)
        done = engine.step()
        order.append(sorted(f.request.rid for f in done))
        tokens.update({f.request.rid: f.tokens.tolist() for f in done})
        tick += 1
    return tokens, order


SCHEDULE = [(0, 0, 5, 6), (0, 1, 13, 3), (0, 2, 7, 5), (2, 3, 20, 4),
            (3, 4, 9, 7), (3, 5, 4, 2), (8, 6, 11, 5)]


def test_engine_greedy_tokens_match_reference():
    """Staggered heterogeneous requests through 2 slots: the port's
    engine (plain flash_decode on the CPU) and the reference's (jnp
    decode) emit the same greedy tokens, finishing on the same ticks."""
    cfg, model, params, rmodel, rparams = _pair()
    kw = dict(slots=2, capacity=32, prefill_bucket=8)
    got = _drive(ServeEngine(model, params, cfg, **kw), SCHEDULE, cfg)
    want = _drive(RefServeEngine(rmodel, rparams, cfg=None, **kw),
                  SCHEDULE, cfg)
    assert got == want
    assert sorted(got[0]) == list(range(7))


def test_engine_use_flash_is_a_placement_check():
    """On CPU params the engine takes ``use_flash`` None or False (the
    kernel's plain version) and refuses True (the kernel needs the
    card)."""
    cfg, model, params, _, _ = _pair()
    a = ServeEngine(model, params, cfg, slots=3, capacity=32)
    b = ServeEngine(model, params, cfg, slots=3, capacity=32,
                    use_flash=False)
    prompts = [np.arange(4) + i for i in range(4)]
    assert [t.tolist() for t in a.generate(prompts, 5)] == \
        [t.tolist() for t in b.generate(prompts, 5)]
    assert a.logits_finite and a.stats["tokens_out"] == 20
    with pytest.raises(ValueError, match="needs CUDA"):
        ServeEngine(model, params, cfg, use_flash=True)


def test_step_factories_call_the_model():
    cfg, model, params, _, _ = _pair()
    toks = torch.tensor([[3, 1, 4, 1, 5]])
    logits, cache = make_prefill_step(model)(params, {"tokens": toks},
                                             cache_len=8)
    want, want_cache = model.prefill(params, toks, cache_len=8)
    assert torch.equal(logits, want) and cache["k"].shape[2] == 8
    step = make_serve_step(model)
    got, cache = step(params, cache, torch.tensor([[2]]))
    want, _ = model.decode_step(params, want_cache, torch.tensor([[2]]))
    assert torch.equal(got, want) and cache["pos"].tolist() == [6]


def test_stochastic_output_is_independent_of_slot_and_admission_tick():
    """The same request (rid 7) sampled top-k: alone in slot 0 from
    tick 0, and behind three others in another slot from a later tick."""
    cfg, model, params, _, _ = _pair()
    sampler = SamplerConfig("top_k", top_k=20, temperature=1.5)
    prompt = np.arange(6) * 3
    alone = ServeEngine(model, params, cfg, slots=4, capacity=48,
                        sampler=sampler, seed=3)
    alone.submit(prompt, 10, rid=7)
    first = {f.request.rid: f.tokens.tolist() for f in alone.run()}
    busy = ServeEngine(model, params, cfg, slots=4, capacity=48,
                       sampler=sampler, seed=3)
    for rid in (1, 2, 3):
        busy.submit(np.arange(rid + 4), 12, rid=rid)
    busy.step()
    busy.step()
    busy.submit(prompt, 10, rid=7)
    second = {f.request.rid: f.tokens.tolist() for f in busy.run()}
    assert second[7] == first[7]
    assert len(set(first[7])) > 1
    other = ServeEngine(model, params, cfg, slots=4, capacity=48,
                        sampler=sampler, seed=4)
    other.submit(prompt, 10, rid=7)
    assert other.run()[0].tokens.tolist() != first[7]


@pytest.mark.parametrize("kw", [{"slos": {}}, {"prefill_chunk": 4},
                                {"prefix_entries": 2}, {"mesh": object()},
                                {"min_slots": 1}])
def test_engine_refuses_unported_options(kw):
    """Each of these options raised until a slice ported it, and now
    runs: an empty ``slos`` is refused by the priority scheduler itself
    (as the reference's), a mesh that is not a ``launch.mesh.Mesh`` by
    the engine, and chunked prefill, the prefix store, slot autoscaling
    and a real (one-rank) mesh serve the same greedy tokens as the plain
    engine (4 requests through 2 slots).
    tests/test_torch_serve_{slo,prefix,mesh}.py hold them against the
    reference."""
    cfg, model, params, _, _ = _pair()
    if "mesh" in kw:
        with pytest.raises(TypeError, match="launch.mesh.Mesh"):
            ServeEngine(model, params, cfg, **kw)
        kw = {"mesh": mesh_from_spec("1x1", device="cpu")}
    if "slos" in kw:
        with pytest.raises(ValueError, match="at least one TierSLO"):
            ServeEngine(model, params, cfg, **kw)
        kw = {"slos": {0: 1.0, 1: (5.0, 60.0)}}
    prompts = [np.arange(3 + 2 * i) % cfg.vocab_size for i in range(4)]
    want = ServeEngine(model, params, cfg, slots=2,
                       capacity=32).generate(prompts, 5)
    engine = ServeEngine(model, params, cfg, slots=2, capacity=32, **kw)
    assert [t.tolist() for t in engine.generate(prompts, 5)] == \
        [t.tolist() for t in want]
    assert engine.stats["decode_calls"] == engine.stats["decode_steps"]


def test_engine_stats_and_reset():
    cfg, model, params, _, _ = _pair()
    engine = ServeEngine(model, params, cfg, slots=4, capacity=32)
    engine.generate([np.arange(5), np.arange(3)], 4)
    assert engine.stats["decode_steps"] == 3
    assert engine.stats["admit_calls"] == 2 and engine.occupancy == 0.5
    assert int(engine.cache.data["pos"][0]) == 5 + 3
    engine.reset_stats()
    assert engine.stats["decode_steps"] == 0 and engine.occupancy == 0.0


# ------------------------------------------------------------------ launch

def test_launch_serve_runs_reduced_on_the_cpu(capsys):
    rep = launch_serve.main(["--arch", "smollm-135m", "--reduced",
                             "--device", "cpu", "--requests", "5",
                             "--slots", "3", "--sampler", "top_k:8"])
    assert rep["requests"] == 5 and rep["logits_finite"]
    assert rep["tokens"] == sum(f.tokens.size for f in rep["finished"])
    assert rep["flash_decode_launches"] == 0      # the plain version
    out = capsys.readouterr().out
    assert "decode ticks" in out and "TTFT" in out


@pytest.mark.parametrize("extra", [
    ["--mesh", "2x1"], ["--scenario", "bursty"], ["--slos", "0:1"],
    ["--session", "2"], ["--prefill-chunk", "8"], ["--prefix-entries", "4"],
    ["--set", "sliding_window=8"], ["--arch", "paligemma-3b"],
    ["--set", "attn_logit_softcap=30.0"], ["--arch", "whisper-base"]])
def test_launch_serve_refuses_unported_options(extra, monkeypatch):
    """What ``launch.serve`` refuses: the vlm and encdec archs, with the
    reference's own refusal (its ``ServeEngine`` does not serve their
    families), and ``--mesh 2x1`` without the ranks of its mesh: without
    a process group the process is one rank, so it fails with the
    reference's message, as ``launch.train``'s does (the mesh on ranks:
    tests/test_torch_serve_mesh.py). The reference's other options, and
    a sliding window or the softcap set through ``--set``, raised until
    a slice ported them; each now serves its traffic (a window below the
    prompts' lengths: a ring), every request finishing with finite
    logits and one ``decode_step`` call a tick."""
    args = ["--arch", "smollm-135m", "--reduced", "--device", "cpu",
            "--requests", "3"]
    if "--arch" in extra:
        with pytest.raises(ValueError, match="ServeEngine covers"):
            launch_serve.main(args + extra)
        return
    if "--mesh" in extra:
        with pytest.raises(SystemExit, match="needs 2 devices, have 1"):
            launch_serve.main(args + extra)
        return
    if "--scenario" in extra:
        # a shrunk bursty shape keeps the CPU run short
        monkeypatch.setitem(report.SCENARIO_LIBRARY, "bursty",
                            functools.partial(report.bursty_tier_traffic,
                                              interactive=2, burst=2,
                                              burst_new=4))
        extra = extra + ["--time-scale", "0.1"]
    rep = launch_serve.main(args + extra)
    assert rep["requests"] > 0 and rep["logits_finite"]
    assert rep["stats"]["decode_calls"] == rep["decode_steps"] > 0


def test_launch_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        launch_serve.main(["--arch", "smollm-135m", "--reduced"])
