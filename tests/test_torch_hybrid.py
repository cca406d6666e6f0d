"""The port's hybrid family (zamba2-7b: Mamba-2/SSD layers and one shared
attention + MLP block applied after every ``attn_every``-th layer) on
the CPU against the JAX package, through the checks of
tests/test_torch_ssm.py: reduced zamba2 in f32, the reference's params
carried across by ``bridge``.

The reduced preset has 2 layers and ``attn_every`` 2, so the shared
block runs once. The tests that read the shared block's K/V caches run
3 layers (``LAYERS``), where it runs after layers 0 and 2 and decode
reads and writes cache ``layer // attn_every``; its gradient is then
the sum over two applications.

Tolerances, each measured here (max abs differences, 3 layers): the
LM's logits within 8.1e-6 of values up to 4.2, the loss equal, gradients
within 3.8e-6 of each leaf's largest entry (held at rtol/atol 1e-5, 1e-6
relative and 1e-5 of the largest entry); 4 LARS steps' losses within
2.1e-7 relative (held at 1e-6); decode after prefill 8.1e-6, the
lengths-masked prefill 8.6e-6, ``prefill_at`` 5.0e-6 (held at rtol/atol
1e-5); the engine's greedy tokens equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import lars
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.serve import ServeEngine
from repro_torch.train import TrainPipeline
from test_torch_ssm import (LAUNCH_RUNS, check_config_and_count,
                            check_engine, check_init_cache,
                            check_init_layout, check_lars_steps_and_layout,
                            check_lengths_masked_prefill,
                            check_lm_forward_and_gradients,
                            check_prefill_at, check_prefill_then_decode)
from _torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCH = "zamba2-7b"
LAYERS = dict(num_layers=3)


def test_zamba2_config_is_the_references_and_counts_its_params():
    """At 24 layers the shared block runs 4 times (after layers 0, 6, 12
    and 18) and is counted once."""
    cfg = get_config(ARCH)
    din, N, heads = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_d_inner // 64
    dxbc = din + 2 * N
    # conv_b, the third of (A_log, dt_bias, D), norm_scale and ln1 a
    # layer; the shared block's two norms and the final norm
    params = check_config_and_count(
        ARCH, 6_749_649_120, 24, 2_305_934_592,
        dxbc + heads + din + cfg.d_model, 3 * cfg.d_model)
    assert tuple(params["shared"]["attn"]["wq"].shape) == (3584, 32 * 112)
    assert tuple(params["shared"]["mlp"]["wi"].shape) == (3584, 14336)
    s = params["layers"]["ssm"]
    assert tuple(s["in_proj"].shape) == (24, 3584, 2 * din + 2 * N + heads)
    cache = build_model(dataclasses.replace(cfg, num_layers=24)).init_cache(
        32, 4096, device="meta")
    assert tuple(cache["attn_k"].shape) == (4, 32, 4096, 32, 112)
    assert tuple(cache["h"].shape) == (24, 32, heads, 64, N)


def test_init_layout_and_distributions():
    cfg, p = check_init_layout(ARCH, **LAYERS)
    s = p["layers"]["ssm"]
    A = torch.exp(s["A_log"])
    assert 1.0 <= A.min() and A.max() <= 16.0
    assert set(p["shared"]) == {"ln1", "attn", "ln2", "mlp"}
    assert set(p["shared"]["mlp"]) == {"wi", "wg", "wo"}
    assert tuple(p["layers"]["ssm"]["norm_scale"].shape) == (
        3, cfg.ssm_d_inner)


@pytest.mark.parametrize("lean", [False, True])
def test_lm_forward_loss_and_gradients_match_the_reference(lean):
    """Two applications of the shared block: its gradient sums them."""
    check_lm_forward_and_gradients(ARCH, lean, **LAYERS)


def test_init_cache_and_capacity_match_the_reference():
    """One K/V cache per application of the shared block (3 layers: 2),
    indexed by application; ``cache_capacity`` is the K/V caches'
    sequence length, looked up by name."""
    model, cache = check_init_cache(ARCH, **LAYERS)
    assert set(cache) == {"pos", "conv", "h", "attn_k", "attn_v"}
    assert cache["attn_k"].shape[0] == 2
    assert model.cache_capacity(cache) == 20
    assert model.flash_decode_per_step() == 2


def test_decode_after_prefill_equals_the_forward():
    cache = check_prefill_then_decode(ARCH, **LAYERS)
    # the second application (after layer 2) wrote its own cache
    assert cache["attn_k"][1, :, :28].abs().amax(dim=(1, 2)).min() > 0
    assert not torch.equal(cache["attn_k"][0], cache["attn_k"][1])


def test_lengths_masked_prefill_equals_per_row_prefill():
    check_lengths_masked_prefill(ARCH, **LAYERS)


def test_prefill_at_writes_the_admitted_slots_state_only():
    model, cache = check_prefill_at(ARCH, **LAYERS)
    with pytest.raises(ValueError, match="exceeds cache capacity 24"):
        model.prefill_at(None, cache, torch.zeros(1, 25, dtype=torch.int32),
                         torch.tensor([1]))


def test_lars_steps_and_packed_layout_match_the_reference():
    layout = check_lars_steps_and_layout(ARCH, **LAYERS)
    names = [s.name for s in layout.segments]
    assert "shared/attn/wq" in names and "layers/ssm/A_log" in names


def test_zamba2_streamed_training_stays_finite():
    """The reference's NaN repro (an SSD gate that was not masked before
    its exp broke after 2 steps): 4 LARS steps on fresh batches of the
    reduced model, every loss finite."""
    cfg = get_config(ARCH).reduced()
    model = build_model(cfg)
    pipe = TrainPipeline(model, lars(0.01), cfg)
    state = pipe.init_state(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(7)
    for i in range(4):
        toks = rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
        state, m = pipe(state, {"tokens": torch.from_numpy(toks)})
        assert torch.isfinite(m["loss"]), f"NaN at step {i}"


def test_engine_greedy_tokens_match_the_reference():
    check_engine(ARCH, **LAYERS)


def test_serving_with_a_window_raises_with_its_reason():
    """No registered hybrid sets a window; one set by hand would decode
    from the reference's ring cache, which is not ported."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), sliding_window=8)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="ring cache"):
        ServeEngine(model, params, cfg, slots=1, capacity=16)


@pytest.mark.parametrize("optimizer,extra", LAUNCH_RUNS)
def test_launch_train_runs_zamba2_reduced_on_the_cpu(optimizer, extra):
    summary = launch_train.main([
        "--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "2",
        "--batch", "4", "--seq", "16", "--optimizer", optimizer,
        "--log-every", "0", "--set", "num_layers=3"] + extra)
    assert summary["arch"] == ARCH + "-reduced"
    assert len(summary["losses"]) == 2
    assert all(np.isfinite(summary["losses"]))


def test_launch_serve_runs_zamba2_reduced_on_the_cpu(capsys):
    rep = launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                             "--requests", "4", "--slots", "2", "--set",
                             "num_layers=3"])
    assert rep["requests"] == 4 and rep["logits_finite"]
    assert rep["flash_decode_launches"] == 0      # the plain version
    assert rep["flash_decode_per_tick"] == 2
    assert "2 per tick on the card" in capsys.readouterr().out
