"""``repro_torch.data.lm_stream`` is a numpy-only copy of
``repro.data.lm_stream``: the same seeds must give the same tokens and
labels, exactly (the port's training and the LM-clients example see the
batches JAX sees)."""
import itertools

import numpy as np
import pytest

from repro.data import LMStream as JStream, LMStreamConfig as JConfig
from repro_torch.data import LMStream, LMStreamConfig

CONFIGS = {"default": {},
           "lm-clients": dict(vocab_size=512, num_topics=16, topic_vocab=96)}


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("batch,seq,seed", [(2, 64, 1), (8, 33, 7),
                                            (4, 128, 12345)])
def test_sample_equals_jax(name, batch, seq, seed):
    kw = CONFIGS[name]
    for cfg_seed in (0, 1):
        j = JStream(JConfig(seed=cfg_seed, **kw))
        t = LMStream(LMStreamConfig(seed=cfg_seed, **kw))
        np.testing.assert_array_equal(t.topic_tokens, j.topic_tokens)
        np.testing.assert_array_equal(t.token_probs, j.token_probs)
        jt, jl = j.sample(batch, seq, seed)
        tt, tl = t.sample(batch, seq, seed)
        assert tt.dtype == jt.dtype == np.int32 and tt.shape == (batch, seq)
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(tt[:, 1:], tl[:, :-1])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_batches_equal_jax(name):
    kw = CONFIGS[name]
    j = JStream(JConfig(**kw)).batches(3, 16, start_seed=5)
    t = LMStream(LMStreamConfig(**kw)).batches(3, 16, start_seed=5)
    for (jt, jl), (tt, tl) in itertools.islice(zip(j, t), 4):
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_array_equal(tl, jl)


def test_config_defaults_equal_jax():
    import dataclasses
    assert dataclasses.asdict(LMStreamConfig()) == \
        dataclasses.asdict(JConfig())
