"""The port's synthetic data stream (`repro_torch.data.synthetic`) against
the JAX package's `repro.data.synthetic`, on the CPU: the same batches bit
for bit, for both generators, at several steps and seeds, for the whole
batch and for each host's slice."""
import numpy as np
import pytest
import torch

from repro.data import synthetic as jax_synthetic
from repro_torch.data import synthetic


@pytest.fixture(autouse=True)
def _one_thread():
    """These tensors are small: PyTorch's intra-op threads, next to the
    other test workers' and JAX's, only oversubscribe the cores, so each
    test runs on one (and puts the count back)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def both(**kw):
    return synthetic.DataConfig(**kw), jax_synthetic.DataConfig(**kw)


@pytest.mark.parametrize("kind", ["markov", "random"])
@pytest.mark.parametrize("seed", [0, 3])
def test_batch_at_step_equals_jax_bit_for_bit(kind, seed):
    cfg, jcfg = both(vocab_size=97, seq_len=24, global_batch=6, seed=seed,
                     kind=kind)
    for step in (0, 1, 7, 1000, 2**33 + 5):
        got, want = synthetic.batch_at_step(cfg, step), \
            jax_synthetic.batch_at_step(jcfg, step)
        assert sorted(got) == sorted(want) == ["labels", "tokens"]
        for key in want:
            assert got[key].dtype == want[key].dtype == np.int32
            np.testing.assert_array_equal(got[key], want[key])
        np.testing.assert_array_equal(got["labels"][:, :-1], got["tokens"][:, 1:])


@pytest.mark.parametrize("kind", ["markov", "random"])
def test_host_slices_equal_jax_and_partition_nothing_twice(kind):
    for host in (0, 1):
        cfg, jcfg = both(vocab_size=512, seq_len=16, global_batch=8, seed=1,
                         kind=kind, num_hosts=2, host_id=host)
        for step in (0, 5):
            got = synthetic.batch_at_step(cfg, step)
            want = jax_synthetic.batch_at_step(jcfg, step)
            assert got["tokens"].shape == (4, 16)
            for key in want:
                np.testing.assert_array_equal(got[key], want[key])
    a = synthetic.batch_at_step(both(vocab_size=512, seq_len=16, global_batch=8,
                                     seed=1, kind=kind, num_hosts=2,
                                     host_id=0)[0], 3)
    b = synthetic.batch_at_step(both(vocab_size=512, seq_len=16, global_batch=8,
                                     seed=1, kind=kind, num_hosts=2,
                                     host_id=1)[0], 3)
    assert not np.array_equal(a["tokens"], b["tokens"])


def test_stream_replays_from_any_step():
    cfg, jcfg = both(vocab_size=64, seq_len=8, global_batch=2, seed=2)
    got = synthetic.stream(cfg, start_step=4)
    want = jax_synthetic.stream(jcfg, start_step=4)
    for step in range(4, 8):
        g, w = next(got), next(want)
        np.testing.assert_array_equal(g["tokens"], w["tokens"])
        np.testing.assert_array_equal(
            g["tokens"], synthetic.batch_at_step(cfg, step)["tokens"])


def test_markov_stream_follows_its_successor_table():
    cfg, _ = both(vocab_size=50, seq_len=32, global_batch=4, seed=0)
    succ, probs = synthetic._markov_matrix(50, 0)
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-12)
    tokens = synthetic.batch_at_step(cfg, 2)["tokens"]
    for row in tokens:
        for a, b in zip(row[:-1], row[1:]):
            assert b in succ[a]
