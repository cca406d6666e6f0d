"""The port's SLO scheduling (``serve/scheduler.py``), scenario library
and report (``serve/report.py``), serve grid
(``experiments/serve_grid.py``, ``launch/serve_experiment.py``) and the
engine's preemption, autoscaling and launcher flags on the CPU against
the JAX package: the reference's ``tests/test_serve_slo.py`` ported.

The scheduler-policy tests run the same submission sequences through
both packages' schedulers over a fake cache (no model) and compare what
they admit, preempt, cancel and retire; the scenario library must build
the reference's traffic from the same seed. The engine tests use reduced
qwen3-14b with the reference's params carried over by ``bridge``: greedy
tokens equal the reference engine's (tests/test_torch_serve_prefix.py's
helpers). The reference's one-jit-trace contract is, in the port, one
``decode_step`` call per decode tick and no ``flash_decode`` launch
outside the ticks (``serve_grid.decode_contract``).
"""

import functools
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from _hypothesis_compat import given, settings, st  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

from repro.serve import report as ref_report  # noqa: E402
from repro.serve import scheduler as ref_scheduler  # noqa: E402
from repro_torch.experiments import serve_grid  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import serve_experiment  # noqa: E402
from repro_torch.serve import ServeEngine, report  # noqa: E402
from repro_torch.serve.report import (_pct, SCENARIO_LIBRARY,  # noqa: E402
                                      ServeScenario, bursty_tier_traffic,
                                      diurnal_tier_traffic,
                                      format_scenarios,
                                      heavy_tail_tier_traffic, run_scenario,
                                      scenario_waves, write_serve_report)
from repro_torch.serve.scheduler import (PriorityScheduler,  # noqa: E402
                                         Request, RequestScheduler, TierSLO,
                                         normalize_slos)
from test_torch_serve_prefix import pair, ref_tokens  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PKGS = {"port": (Request, RequestScheduler, PriorityScheduler, TierSLO),
        "ref": (ref_scheduler.Request, ref_scheduler.RequestScheduler,
                ref_scheduler.PriorityScheduler, ref_scheduler.TierSLO)}


class FakeCache:
    """SlotCache stand-in: slot pool + capacity check, no device state."""

    def __init__(self, slots=4, capacity=256):
        self.slots = slots
        self.capacity = capacity
        self._free = list(range(slots))

    @property
    def free_slots(self):
        return len(self._free)

    def acquire(self):
        return self._free.pop(0) if self._free else None

    def release(self, slot):
        assert slot not in self._free
        self._free.append(slot)

    def fits(self, prompt_len, max_new_tokens):
        return prompt_len + max_new_tokens <= self.capacity


def _req(rid, tier=0, plen=8, max_new=4, pkg="port"):
    return PKGS[pkg][0](rid=rid, tokens=np.arange(1, plen + 1,
                                                  dtype=np.int32),
                        max_new_tokens=max_new, tier=tier)


def _flat(groups):
    """pop_admissions groups -> [(slot, rid)] in admission order."""
    out = []
    for _, group in sorted(groups.items()):
        out.extend((slot, req.rid) for slot, req, _ in group)
    return out


def _flat_groups(groups):
    out = []
    for _, group in sorted(groups.items()):
        out.extend(group)
    return out


def _prio(cache, pkg="port", **kw):
    slo = PKGS[pkg][3]
    kw.setdefault("slos", {0: slo(0.05, 2.0), 1: slo(5.0, 60.0)})
    return PKGS[pkg][2](cache, **kw)


# ---------------------------------------------------- admission ordering

def test_priority_admission_orders_by_tier_then_seq():
    orders = []
    for pkg in PKGS:
        sched = _prio(FakeCache(slots=4), pkg)
        for rid, tier in [(0, 1), (1, 0), (2, 1), (3, 0)]:
            sched.submit(_req(rid, tier=tier, pkg=pkg), now=0.0)
        orders.append([rid for _, rid in _flat(sched.pop_admissions(
            now=0.0))])
    assert orders[0] == orders[1] == [1, 3, 0, 2]


def test_fifo_scheduler_ignores_tiers():
    sched = RequestScheduler(FakeCache(slots=4))
    for rid, tier in [(0, 1), (1, 0), (2, 1), (3, 0)]:
        sched.submit(_req(rid, tier=tier), now=0.0)
    order = [rid for _, rid in _flat(sched.pop_admissions(now=0.0))]
    assert order == [0, 1, 2, 3]


def test_reserve_slots_blocks_low_tiers_not_tier0():
    sched = _prio(FakeCache(slots=2), reserve_slots=1)
    sched.submit(_req(0, tier=1), now=0.0)
    sched.submit(_req(1, tier=1), now=0.0)
    # tier-1 may not take the last free slot
    assert [r for _, r in _flat(sched.pop_admissions(now=0.0))] == [0]
    assert sched.cache.free_slots == 1
    sched.submit(_req(2, tier=0), now=0.0)
    # ... but tier-0 always can
    assert [r for _, r in _flat(sched.pop_admissions(now=0.0))] == [2]
    assert sched.cache.free_slots == 0
    assert sched.slot_accounting_ok()


def test_reserve_slots_validation():
    with pytest.raises(ValueError):
        _prio(FakeCache(slots=2), reserve_slots=2)
    with pytest.raises(ValueError):
        _prio(FakeCache(slots=2), reserve_slots=-1)


# ------------------------------------------------- aging anti-starvation

def _aging_run(pkg, aging_s, wave):
    cache = FakeCache(slots=1)
    sched = _prio(cache, pkg, aging_s=aging_s)
    sched.submit(_req(100, tier=1, max_new=1, pkg=pkg), now=0.0)
    rid = 0
    for w in range(3):                # 3-wave burst of tier-0s
        t = 0.6 * aging_s * w
        for _ in range(wave):
            sched.submit(_req(rid, tier=0, max_new=1, pkg=pkg), now=t)
            rid += 1
    admitted, now = [], 0.0
    while sched.queued:
        now += 0.25 * aging_s        # one admission per tick (1 slot)
        for slot, req, _ in _flat_groups(sched.pop_admissions(now=now)):
            assert sched.claim_popped(slot, req.rid)
            admitted.append(req.rid)
            sched.record(slot, 7, now)     # 1-token request: retires
    assert sched.slot_accounting_ok()
    return admitted


@settings(deadline=None, max_examples=20)
@given(aging_s=st.floats(min_value=0.2, max_value=2.0),
       wave=st.integers(min_value=2, max_value=5))
def test_aging_bounds_starvation_under_three_wave_burst(aging_s, wave):
    """A tier-1 request under a sustained 3-wave tier-0 flood still gets
    in: once it has waited ``aging_s`` its effective tier is 0 and its
    seq (the oldest) wins FIFO-within-tier, so at most ~4 flood
    requests ever precede it. The reference's scheduler admits in the
    same order."""
    admitted = _aging_run("port", aging_s, wave)
    assert 100 in admitted            # the starved request got in
    assert admitted.index(100) <= 4, admitted
    assert admitted == _aging_run("ref", aging_s, wave)


# -------------------------------------------- tombstone race + accounting

def test_cancel_popped_slot_tombstone_releases_once():
    """queued -> popped -> cancelled: the slot parks in limbo, the
    accounting invariant holds throughout, and claim_popped releases it
    exactly once."""
    cache = FakeCache(slots=2)
    sched = RequestScheduler(cache)
    sched.submit(_req(0), now=0.0)
    sched.submit(_req(1), now=0.0)
    picked = _flat(sched.pop_admissions(now=0.0))
    assert cache.free_slots == 0 and sched.slot_accounting_ok()
    kind, slot0 = sched.cancel(0)     # popped but prefill not yet issued
    assert kind == "popped" and slot0 == picked[0][0]
    assert cache.free_slots == 0      # parked, NOT yet reusable
    assert sched.slot_accounting_ok()
    assert sched.claim_popped(picked[0][0], 0) is False   # tombstone
    assert cache.free_slots == 1      # released exactly here
    assert sched.slot_accounting_ok()
    assert sched.claim_popped(picked[1][0], 1) is True
    assert sched.cancel(0) == (None, None)
    assert sched.cancel(999) == (None, None)
    for _ in range(3):
        sched.record(picked[1][0], 5, now=1.0)
    fin = sched.record(picked[1][0], 5, now=1.0)
    assert fin.request.rid == 1
    assert cache.free_slots == 2 and sched.slot_accounting_ok()


# --------------------------------------------- preemption + continuation

def test_preempt_requeues_continuation_at_front():
    """The continuation of a preempted request, its re-admission and
    the spliced FinishedRequest, the same in both packages."""
    out = []
    for pkg in PKGS:
        cache = FakeCache(slots=1)
        sched = _prio(cache, pkg)
        sched.submit(_req(0, tier=1, plen=4, max_new=5, pkg=pkg), now=0.0)
        sched.submit(_req(1, tier=1, plen=4, max_new=5, pkg=pkg), now=0.0)
        (slot, req, _), = _flat_groups(sched.pop_admissions(now=0.0))
        assert sched.claim_popped(slot, req.rid)
        sched.record(slot, 11, now=0.1)
        sched.record(slot, 12, now=0.2)
        cont = sched.preempt(slot, now=0.3)
        assert cont.rid == 0
        np.testing.assert_array_equal(cont.tokens, [1, 2, 3, 4, 11, 12])
        assert cont.max_new_tokens == 3
        assert sched.queued_requests()[0].rid == 0     # ahead of rid 1
        assert cache.free_slots == 1 and sched.slot_accounting_ok()
        (slot, req, _), = _flat_groups(sched.pop_admissions(now=0.4))
        assert req.rid == 0 and sched.claim_popped(slot, req.rid)
        for tok in (13, 14):
            assert sched.record(slot, tok, now=0.5) is None
        fin = sched.record(slot, 15, now=0.6)
        assert fin.preemptions == 1
        assert fin.request.max_new_tokens == 5         # the ORIGIN request
        assert fin.first_token_time == 0.1             # first attempt's
        out.append(fin.tokens.tolist())
    assert out[0] == out[1] == [11, 12, 13, 14, 15]


def test_preempt_before_issue_rejected():
    sched = _prio(FakeCache(slots=1))
    sched.submit(_req(0, tier=1), now=0.0)
    (slot, req, _), = _flat_groups(sched.pop_admissions(now=0.0))
    with pytest.raises(ValueError):
        sched.preempt(slot, now=0.1)    # prefill not issued yet
    assert slot in sched.active          # state restored
    assert sched.slot_accounting_ok()


def test_select_preemptions_prefers_lowest_priority_decoding_victim():
    picks = []
    for pkg in PKGS:
        slo = PKGS[pkg][3]
        cache = FakeCache(slots=2)
        sched = _prio(cache, pkg, slos={0: slo(0.05, 2.0),
                                        1: slo(5.0, 60.0),
                                        2: slo(5.0, 60.0)})
        sched.submit(_req(0, tier=1, max_new=5, pkg=pkg), now=0.0)
        sched.submit(_req(1, tier=2, max_new=5, pkg=pkg), now=0.0)
        by_rid = {req.rid: slot for slot, req, _ in
                  _flat_groups(sched.pop_admissions(now=0.0))}
        for rid, slot in by_rid.items():
            assert sched.claim_popped(slot, rid)
            sched.record(slot, 9, now=0.01)           # decoding
        sched.submit(_req(2, tier=0, pkg=pkg), now=0.1)
        # waited 0.1 >= preempt_at(0.5) * ttft(0.05): at risk
        assert sched.select_preemptions(now=0.2) == [by_rid[1]]   # tier 2
        # a mid-prefill victim is never selected
        assert sched.select_preemptions(
            now=0.2, prefilling=frozenset(by_rid.values())) == []
        picks.append(by_rid)
    assert picks[0] == picks[1]
    # equal-or-higher-priority decodes are not victims for tier-1 risk
    sched2 = _prio(FakeCache(slots=1))
    sched2.submit(_req(0, tier=1, max_new=5), now=0.0)
    (slot, req, _), = _flat_groups(sched2.pop_admissions(now=0.0))
    assert sched2.claim_popped(slot, req.rid)
    sched2.record(slot, 9, now=0.01)
    sched2.submit(_req(1, tier=1), now=0.0)
    assert sched2.select_preemptions(now=100.0) == []


def test_normalize_slos_and_validation():
    slos = normalize_slos({0: 0.05, 1: (5.0, 60.0), 2: TierSLO(1.0)})
    assert slos[0] == TierSLO(0.05)
    assert slos[1] == TierSLO(5.0, 60.0)
    assert slos[2].latency_s == float("inf")
    with pytest.raises(ValueError):
        TierSLO(0.0)
    with pytest.raises(ValueError):
        _prio(FakeCache(), slos={})


# ------------------------------------------------- empty-percentile row

def test_pct_empty_class_reports_explicit_zero_row():
    row = _pct([])
    assert row == {"count": 0, "empty": True, "p50": None, "p90": None,
                   "p99": None, "mean": None, "max": None}
    full = _pct([1.0, 2.0, 3.0])
    assert full["count"] == 3 and "empty" not in full
    assert full["p50"] == 2.0
    assert full == ref_report._pct([1.0, 2.0, 3.0])


# ------------------------------------------------------ scenario library

def test_scenario_library_shapes():
    """Every library scenario: sorted arrivals in [0, 1], two tiers,
    classes set — and the reference's traffic from the same seed."""
    assert set(SCENARIO_LIBRARY) == set(ref_report.SCENARIO_LIBRARY)
    for name in SCENARIO_LIBRARY:
        (wave,) = scenario_waves(name, vocab=512, seed=3)
        assert wave == sorted(wave, key=lambda t: t.at)
        assert {t.tier for t in wave} == {0, 1}
        assert all(0.0 <= t.at <= 1.0 for t in wave)
        assert all(t.cls for t in wave)
        (rwave,) = ref_report.scenario_waves(name, vocab=512, seed=3)
        assert [(t.tokens.tolist(), t.max_new, t.at, t.cls, t.tier)
                for t in wave] == [(t.tokens.tolist(), t.max_new, t.at,
                                    t.cls, t.tier) for t in rwave]


def test_bursty_traffic_pairs_and_burst_cluster():
    (wave,) = bursty_tier_traffic(512, seed=1)
    t0 = sorted(t.at for t in wave if t.tier == 0)
    assert all(t0[i] == t0[i + 1] for i in range(0, len(t0), 2))  # pairs
    t1 = [t.at for t in wave if t.tier == 1]
    assert max(t1) - min(t1) < 0.1        # the flash crowd clusters
    (steady,) = bursty_tier_traffic(512, steady=True, seed=1)
    s1 = sorted(t.at for t in steady if t.tier == 1)
    assert max(b - a for a, b in zip(s1, s1[1:])) < 0.2   # spread out


def test_heavy_tail_prompt_lengths_zipf():
    (wave,) = heavy_tail_tier_traffic(512, n=40, seed=5)
    lens = [len(t.tokens) for t in wave]
    assert min(lens) >= 1
    assert sorted(lens)[len(lens) // 2] < max(lens) // 2
    assert any(t.tier == 0 for t in wave)
    assert any(t.tier == 1 for t in wave)


def test_diurnal_arrivals_cluster_at_peaks():
    (wave,) = diurnal_tier_traffic(512, n=48, cycles=2, seed=7)
    ats = np.sort([t.at for t in wave])
    gaps = np.diff(ats)
    assert gaps.max() > 3 * np.median(gaps[gaps > 0])   # rate modulation


def test_scenario_waves_unknown_name():
    with pytest.raises(ValueError):
        scenario_waves("nope", 512)


def test_bursty_32_is_the_reference_bursty_mix_sized_for_32_slots():
    """The port's sized shape is the reference's bursty traffic with its
    burst and interactive counts set for a 32-slot engine: 31 tier-1
    requests of 512 tokens (128 new) landing together at the window's
    start, 8 tier-0 requests in 4 pairs."""
    (wave,) = scenario_waves("bursty_32", vocab=512, seed=3)
    (rwave,) = ref_report.bursty_tier_traffic(
        512, interactive=8, burst=31, burst_at=0.0, burst_len=512,
        burst_new=128, seed=3)
    assert [(t.tokens.tolist(), t.max_new, t.at, t.cls, t.tier)
            for t in wave] == [(t.tokens.tolist(), t.max_new, t.at, t.cls,
                                t.tier) for t in rwave]
    burst = [t for t in wave if t.tier == 1]
    assert len(burst) == 31 and max(t.at for t in burst) < 0.16
    assert {len(t.tokens) for t in burst} == {512}
    assert sum(t.tier == 0 for t in wave) == 8


# ------------------------------------------------- serve grid claim wiring

def _row(p99, preempt=0, calls=10, ticks=10, launches=0, outside=0,
         device="cpu", per_step=2):
    return {"by_class": {"tier0_interactive": {"ttft": {"p99": p99}}},
            "preemptions": preempt, "decode_calls": calls,
            "decode_steps": ticks, "flash_decode_launches": launches,
            "flash_decode_outside_ticks": outside, "device": device,
            "flash_decode_per_step": per_step}


def test_slo_claims_from_synthetic_rows():
    """The claims from synthetic rows, the reference's quartet: A1–A3 as
    the reference computes them, and the contract in the port's form
    (one decode_step call a tick; on the card per_step launches a tick;
    none outside the ticks)."""
    grid = serve_grid.get_serve_grid("serve_slo_smoke")

    def cid(scen, sched):
        return serve_grid.ServeCellSpec(grid.name, scen, sched,
                                        grid.claim_slots).cell_id

    rows = {cid("bursty", "priority"): _row(0.04, preempt=2),
            cid("steady", "priority"): _row(0.03),
            cid("bursty", "fifo"): _row(0.20),
            cid("steady", "fifo"): _row(0.03, device="cuda", launches=20)}
    claims = serve_grid.slo_claims(grid, rows)
    assert claims["A1_priority_burst_ttft_le_2x_steady"]
    assert claims["A2_fifo_burst_ttft_ge_4x_steady"]
    assert claims["A3_priority_preempts_under_burst"]
    assert claims["contract_one_decode_trace_per_cell"]
    assert claims["priority_burst_over_steady_x"] == pytest.approx(1.333,
                                                                   abs=1e-3)
    for bad in (dict(calls=11), dict(outside=1), dict(device="cuda",
                                                      launches=19)):
        rows2 = dict(rows, **{cid("steady", "fifo"): _row(0.03, **bad)})
        assert not serve_grid.slo_claims(
            grid, rows2)["contract_one_decode_trace_per_cell"]
    rows[cid("bursty", "priority")] = _row(0.08, preempt=0)
    claims = serve_grid.slo_claims(grid, rows)
    assert not claims["A1_priority_burst_ttft_le_2x_steady"]
    assert not claims["A3_priority_preempts_under_burst"]


def test_serve_grid_engine_kwargs_by_scheduler():
    """The registered grid is the reference's but for its report file;
    each cell's engine kwargs are the reference's."""
    from repro.experiments import serve_grid as ref_grid
    grid = serve_grid.get_serve_grid("serve_slo_smoke")
    rgrid = ref_grid.get_serve_grid("serve_slo_smoke")
    assert grid.report_file == "EXPERIMENTS_torch_serve.json"
    assert [c.cell_id for c in grid.cells] == \
        [c.cell_id for c in rgrid.cells]
    pri = grid.engine_kwargs(serve_grid.ServeCellSpec(grid.name, "bursty",
                                                      "priority", 4))
    assert pri["slos"][0].ttft_s == grid.slos[0][1]
    assert pri["reserve_slots"] == grid.reserve_slots
    fifo = grid.engine_kwargs(serve_grid.ServeCellSpec(grid.name, "bursty",
                                                       "fifo", 4))
    assert "slos" not in fifo and "reserve_slots" not in fifo
    with pytest.raises(ValueError):
        serve_grid.ServeCellSpec(grid.name, "bursty", "lifo", 4)
    auto = grid.engine_kwargs(serve_grid.ServeCellSpec(
        grid.name, "bursty", "priority", 4, min_slots=2))
    assert auto["min_slots"] == 2
    rpri = rgrid.engine_kwargs(ref_grid.ServeCellSpec(rgrid.name, "bursty",
                                                      "priority", 4))
    assert {k: v for k, v in pri.items() if k not in ("slos", "sampler")} \
        == {k: v for k, v in rpri.items() if k not in ("slos", "sampler")}


# ----------------------------------------------------- engine-level tests

SLOS = {0: TierSLO(1e-6, 10.0), 1: TierSLO(10.0, 60.0)}


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, (l,)).astype(np.int32)
            for l in lens]


@pytest.mark.parametrize("chunked", [False, True])
def test_engine_preemption_byte_identical_and_one_trace(chunked):
    """slots=1: a tier-0 arrival evicts the decoding tier-1 request;
    both token streams equal the reference engine's run of each prompt
    (monolithic admission, no preemption), every decode tick made one
    decode_step call, and no slot leaks — on the monolithic path and on
    the chunked one with a prefix store (the snapshot pinned, replayed
    as a one-token suffix)."""
    cfg, model, params, _, _ = pair("qwen3-14b")
    long_p, short_p = _prompts(cfg, [9, 6], seed=21)
    want_long, = ref_tokens("qwen3-14b", [long_p], 10)
    want_short, = ref_tokens("qwen3-14b", [short_p], 4)
    kw = dict(prefill_chunk=4, prefix_entries=4) if chunked else {}
    eng = ServeEngine(model, params, cfg, slots=1, capacity=64, seed=7,
                      slos=SLOS, **kw)
    e0 = eng.submit(long_p, 10, tier=1)
    for _ in range(4 if chunked else 1):
        eng.step()                    # admit + prefill tier-1
    for _ in range(3):
        eng.step()                    # a few decode tokens
    e1 = eng.submit(short_p, 4, tier=0)
    fin = eng.run([])
    by = {f.request.rid: f for f in fin}
    assert by[e0].preemptions >= 1    # tier-1 was evicted
    assert eng.stats["preemptions"] >= 1
    np.testing.assert_array_equal(by[e0].tokens, want_long)
    np.testing.assert_array_equal(by[e1].tokens, want_short)
    assert eng.stats["decode_calls"] == eng.stats["decode_steps"]
    assert eng.stats["flash_decode_outside_ticks"] == 0
    assert eng.cache.free_slots == 1
    assert eng.scheduler.slot_accounting_ok()
    if chunked:
        assert eng.stats["prefix_hits"] >= 1


def test_engine_preemption_disabled_flag():
    cfg, model, params, _, _ = pair("qwen3-14b")
    long_p, short_p = _prompts(cfg, [9, 6], seed=21)
    eng = ServeEngine(model, params, cfg, slots=1, capacity=64, seed=7,
                      slos=SLOS, preempt=False)
    e0 = eng.submit(long_p, 10, tier=1)
    eng.step()
    for _ in range(3):
        eng.step()
    eng.submit(short_p, 4, tier=0)
    fin = eng.run([])
    assert eng.stats["preemptions"] == 0
    assert {f.request.rid: f.preemptions for f in fin}[e0] == 0


def test_engine_autoscale_ramps_and_decays():
    cfg, model, params, _, _ = pair("qwen3-14b")
    eng = ServeEngine(model, params, cfg, slots=4, capacity=64, seed=7,
                      min_slots=1)
    assert eng._slot_target == 1
    ps = _prompts(cfg, [5, 5, 5, 5], seed=3)
    for p in ps:
        eng.submit(p, 6)
    eng.step()
    assert len(eng.scheduler.active) <= 2     # target ramped 1 -> 2
    ramped, finished = [], []
    while eng.scheduler.has_work():
        finished.extend(eng.step())
        ramped.append(eng._slot_target)
    assert max(ramped) > 1                    # queue pressure grew it
    for _ in range(8):
        eng.step()                            # idle: decay to the floor
    assert eng._slot_target == 1
    assert eng.stats["ticks"] > 0
    with pytest.raises(ValueError):
        ServeEngine(model, params, cfg, slots=4, capacity=64,
                    min_slots=9)


def test_engine_cancel_queued_and_unknown():
    """cancel on a queued request (it never runs) and on an unknown rid;
    the survivors' tokens equal the reference engine's."""
    cfg, model, params, _, _ = pair("qwen3-14b")
    ps = _prompts(cfg, [5, 8, 6], seed=17)
    eng = ServeEngine(model, params, cfg, slots=1, capacity=64, seed=7)
    rids = [eng.submit(p, 5) for p in ps]
    assert eng.cancel(rids[1]) and not eng.cancel(99)
    got = {f.request.rid: f.tokens for f in eng.run([])}
    assert sorted(got) == [rids[0], rids[2]]
    want = ref_tokens("qwen3-14b", [ps[0], ps[2]], 5)
    _ = [np.testing.assert_array_equal(got[r], w)
         for r, w in zip((rids[0], rids[2]), want)]


# ------------------------------------------------ report and launchers

def test_run_scenario_and_report_on_a_small_grid(tmp_path):
    """run_scenario on a shortened bursty scenario (priority, chunked,
    prefix store): its summary row carries the reference's keys and the
    port's contract counts, and the report files merge under ``serve``
    and ``serve_slo``."""
    cfg, model, params, _, _ = pair("qwen3-14b")
    grid = serve_grid.get_serve_grid("serve_slo_smoke")
    cell = serve_grid.ServeCellSpec(grid.name, "bursty", "priority", 4)
    waves = scenario_waves("bursty", cfg.vocab_size, interactive=4,
                           burst=3, burst_new=8)
    scen = ServeScenario(cell.cell_id, grid.engine_kwargs(cell), waves)
    row = run_scenario(model, params, scen, time_scale=0.2)
    assert row["requests"] == 7 and row["decode_steps"] > 0
    assert serve_grid.decode_contract(row)
    assert row["device"] == "cpu" and row["flash_decode_launches"] == 0
    assert set(row["by_class"]) == {"tier0_interactive", "tier1_batch"}
    assert "prefix" in row and "bursty" in format_scenarios({"bursty": row})
    path = str(tmp_path / "r.json")
    write_serve_report(path, {"x": 1})
    serve_grid.write_serve_experiments(str(tmp_path / "e.json"),
                                       {"cells": {}})
    import json
    assert json.load(open(path)) == {"serve": {"x": 1}}


def test_serve_experiment_lists_and_runs_on_the_cpu(capsys, monkeypatch,
                                                    tmp_path):
    """launch.serve_experiment lists the grid; run on the CPU over a
    one-cell grid (the registry patched to a short one), it writes the
    report with the contract held and exits 0; without ``--device cpu``
    it needs the card."""
    assert serve_experiment.main(["--list-grids"]) == 0
    assert serve_experiment.main(["--list-cells"]) == 0
    out = capsys.readouterr().out
    assert "serve_slo_smoke: 9 cells" in out and "bursty-fifo-s4" in out
    grid = serve_grid.get_serve_grid("serve_slo_smoke")
    small = serve_grid.ServeGridSpec(
        name="serve_slo_smoke", cells=grid.cells[:1], repeats=1,
        time_scale_s=0.05, report_name=str(tmp_path / "t.json"))
    monkeypatch.setitem(serve_grid.SERVE_GRIDS, "serve_slo_smoke", small)
    monkeypatch.setattr(serve_grid, "scenario_waves",
                        lambda name, vocab, seed=0: scenario_waves(
                            name, vocab, seed=seed, interactive=2, burst=2,
                            burst_new=4))
    assert serve_experiment.main(["--device", "cpu"]) == 0
    import json
    rep = json.load(open(tmp_path / "t.json"))["serve_slo"]
    assert rep["backend"] == "cpu" and len(rep["cells"]) == 1
    assert rep["claims"]["contract_one_decode_trace_per_cell"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            serve_experiment.main([])


@pytest.mark.parametrize("extra", [
    ["--scenario", "bursty", "--slos", "0:0.05:2,1:5:60",
     "--prefill-chunk", "8", "--prefix-entries", "8", "--reserve-slots",
     "1", "--time-scale", "0.2", "--slots", "3"],
    ["--session", "2", "--turns", "2", "--shared-prefix", "16",
     "--prefix-entries", "8", "--prefill-chunk", "8", "--min-slots", "1"]])
def test_launch_serve_scenario_and_session_on_the_cpu(extra, capsys,
                                                     monkeypatch):
    """The launcher's scenario and session modes end to end: every
    request finishes, logits finite, the decode contract held, prefix
    hits on a session's second turn. The bursty shape is shrunk (4
    interactive, a burst of 3 with 8 new tokens) to keep the CPU run
    short."""
    monkeypatch.setitem(report.SCENARIO_LIBRARY, "bursty", functools.partial(
        bursty_tier_traffic, interactive=4, burst=3, burst_new=8))
    rep = launch_serve.main(["--arch", "qwen3-14b", "--reduced", "--device",
                             "cpu", "--requests", "4"] + extra)
    assert rep["logits_finite"] and rep["requests"] > 0
    st = rep["stats"]
    assert st["decode_calls"] == st["decode_steps"] > 0
    assert st["flash_decode_outside_ticks"] == 0
    if "--session" in extra:
        assert rep["per_turn"][1]["prefix_hits"] >= 1
    else:
        assert "tier0_interactive" in capsys.readouterr().out
