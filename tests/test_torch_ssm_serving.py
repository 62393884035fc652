"""The port's engine serving the recurrent LMs, against the JAX engine, on
the CPU: the reduced zamba2-2.7b and xlstm-350m on the requests of
tests/test_serving.py, every token equal, then the launcher. Params and
helpers are tests/test_torch_ssm.py's.
"""
import numpy as np
import pytest
import torch

from repro.serving import engine as jax_engine
from repro_torch.launch import serve
from repro_torch.serving.engine import Request, ServeEngine
from test_torch_ssm import ARCHS, jax_prefill, setup


@pytest.fixture(autouse=True)
def _one_thread():
    """These tensors are small: PyTorch's intra-op threads, next to the
    other test workers' and JAX's, only oversubscribe the cores, so each
    test runs on one (and puts the count back)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def all_requests(cls, vocab):
    """tests/test_serving.py::test_engine_serves_all_requests's requests:
    7 prompts of 4 to 10 tokens, 6 new tokens each, over 3 slots (slots
    refill)."""
    rng = np.random.default_rng(0)
    return 3, [cls(rid=i, prompt=rng.integers(0, vocab, 4 + i),
                   max_new_tokens=6) for i in range(7)]


def sequential_requests(cls, vocab):
    """tests/test_serving.py::test_engine_matches_sequential_decode's two
    requests (6 and 9 prompt tokens, 5 new tokens each) over 2 slots."""
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, vocab, 6)
    return 2, [cls(rid=0, prompt=prompt, max_new_tokens=5),
               cls(rid=1, prompt=rng.integers(0, vocab, 9), max_new_tokens=5)]


# the JAX engine compiles a prefill per prompt length: xlstm-350m takes the
# two-request set of tests/test_serving.py to keep the file's time down
ENGINE_CASES = {"zamba2-2.7b": all_requests, "xlstm-350m": sequential_requests}


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_serves_the_jax_engines_tokens(arch, monkeypatch, capsys):
    """Requests of tests/test_serving.py through both engines: every token
    equal (the inactive slots' states advance and are overwritten at admit
    in both: zamba2-2.7b's 7 requests refill its 3 slots), and the same
    stats keys; then the launcher on the reduced config."""
    jcfg, jparams, cfg, params = setup(arch)
    # the JAX engine prefills eagerly; jit it (the same function) for speed
    monkeypatch.setattr(jax_engine.lm, "prefill", jax_prefill)
    slots, jreqs = ENGINE_CASES[arch](jax_engine.Request, cfg.vocab_size)
    _, reqs = ENGINE_CASES[arch](Request, cfg.vocab_size)
    jeng = jax_engine.ServeEngine(jcfg, jparams, slots=slots, max_seq=64)
    eng = ServeEngine(cfg, params, slots=slots, max_seq=64, device="cpu")
    for e, rs in ((jeng, jreqs), (eng, reqs)):
        for r in rs:
            e.submit(r)
        e.run(max_ticks=300)
    for r, jr in zip(reqs, jreqs):
        assert len(r.output) == r.max_new_tokens
        assert r.output == jr.output, r.rid
    assert eng.stats().keys() == jeng.stats().keys()
    assert eng.stats()["released"] == len(reqs)

    reqs = serve.main(["--arch", arch, "--requests", "3", "--slots", "2",
                       "--max-new", "4", "--device", "cpu"])
    assert [len(r.output) for r in reqs] == [4, 4, 4]
    assert "served 3 requests / 12 tokens" in capsys.readouterr().out
