"""The port's synthetic token-LM data (``repro_torch.data.tokens``) and
the entry point's LM batches against the JAX package's: byte-equal for
every seed, batch shape and fast-forward start (tolerance: none — both
are the same numpy code on the same seeds)."""

import numpy as np
import pytest

from repro.data import TokenTaskConfig as RefTask
from repro.data import token_batches as ref_token_batches
from repro.data import token_eval_set as ref_token_eval_set
from repro.launch.train import lm_batches as ref_lm_batches
from repro_torch.configs import get_config
from repro_torch.data import TokenTaskConfig, token_batches, token_eval_set
from repro_torch.launch.train import lm_batches


@pytest.mark.parametrize("vocab,branching,seed", [(256, 8, 0), (512, 3, 5),
                                                  (49152, 8, 2)])
@pytest.mark.parametrize("start", [0, 3])
def test_token_stream_is_byte_equal(vocab, branching, seed, start):
    kw = dict(batch=4, seq_len=9, seed=seed + 11, start=start)
    got = token_batches(TokenTaskConfig(vocab, branching, seed), **kw)
    want = ref_token_batches(RefTask(vocab, branching, seed), **kw)
    for _ in range(4):
        a, b = next(got), next(want)
        assert a.dtype == b.dtype == np.int32 and a.shape == (4, 10)
        assert a.tobytes() == b.tobytes()


def test_start_fast_forwards_to_the_same_batches():
    task = TokenTaskConfig(vocab_size=64)
    it = token_batches(task, batch=3, seq_len=5, seed=1)
    stream = [next(it) for _ in range(6)]
    resumed = token_batches(task, batch=3, seq_len=5, seed=1, start=4)
    assert next(resumed).tobytes() == stream[4].tobytes()
    assert next(resumed).tobytes() == stream[5].tobytes()


def test_eval_set_is_byte_equal_and_held_out():
    got = token_eval_set(TokenTaskConfig(256, seed=3), n=16, seq_len=12,
                         seed=4)
    want = ref_token_eval_set(RefTask(256, seed=3), n=16, seq_len=12, seed=4)
    assert got.tobytes() == want.tobytes() and got.shape == (16, 13)
    train = next(token_batches(TokenTaskConfig(256, seed=3), batch=16,
                               seq_len=12, seed=4))
    assert train.tobytes() != got.tobytes()


@pytest.mark.parametrize("reduced", [False, True])
def test_launch_lm_batches_are_the_references(reduced):
    from repro.configs import get_config as ref_get_config
    cfg, ref_cfg = get_config("smollm-135m"), ref_get_config("smollm-135m")
    if reduced:
        cfg, ref_cfg = cfg.reduced(), ref_cfg.reduced()
    got, want = lm_batches(cfg, 4, 16, 3), ref_lm_batches(ref_cfg, 4, 16, 3)
    for _ in range(3):
        a, b = next(got), next(want)
        assert set(a) == set(b) == {"tokens"}
        assert a["tokens"].dtype == np.int32 and a["tokens"].shape == (4, 16)
        assert a["tokens"].tobytes() == b["tokens"].tobytes()
        assert a["tokens"].max() < min(cfg.vocab_size, 512)
