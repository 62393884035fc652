"""The port's retrace guard (mirrors tests/test_analysis.py's retrace
cases): a budget of (shape, dtype, device) signatures per call site, the
port's counterpart of jit traces, and `trace_count` on the fused runner."""
import pytest
import torch

from repro_torch import random as R
from repro_torch.analysis import RetraceError, RetraceGuard
from repro_torch.analysis.retrace import signature, trace_count
from repro_torch.train.fused import fused_train_chunk

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    """These tensors are small: PyTorch's intra-op threads, next to the
    other test workers' and JAX's, only oversubscribe the cores, so each
    test runs on one (and puts the count back)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_retrace_guard_enforces_budget():
    calls = []
    step = RetraceGuard(lambda x: calls.append(x) or x * 2, budget=1,
                        name="toy.step")
    step(torch.ones(4))
    step(torch.zeros(4))                   # same signature
    assert step.traces == 1 and trace_count(step) == 1
    with pytest.raises(RetraceError) as e:
        step(torch.ones(8))                # new shape: a second signature
    assert e.value.traces == 2 and e.value.budget == 1
    assert len(calls) == 2                 # refused before it ran
    with pytest.raises(RetraceError):
        step(torch.ones(4, dtype=torch.float64))
    assert "toy.step" in str(e.value)


def test_signature_reads_tensor_leaves_only():
    a = signature((torch.ones(2), 3, {"k": torch.zeros(1, dtype=torch.int32)}),
                  {"n": 5})
    assert a == (((2,), torch.float32, CPU), ((1,), torch.int32, CPU))
    guard = RetraceGuard(lambda *a, **k: None, budget=2)
    guard(torch.ones(2), n=1)
    guard(torch.ones(2), n=2)              # a Python scalar is no signature
    guard(torch.ones(3))
    assert guard.traces == 2 and guard.check() == 2


def test_retrace_guard_rejects_non_callables():
    with pytest.raises(TypeError):
        RetraceGuard(42)


def test_trace_count_none_on_foreign_callables():
    assert trace_count(print) is None
    assert trace_count(lambda x: x) is None


def test_trace_count_of_a_fused_runner():
    """No capture before a chunk; on the CPU the runner is a plain loop and
    captures nothing."""
    run = fused_train_chunk(lambda c: (c + 1, {"v": c.sum()}))
    assert trace_count(run) == 0
    carry, metrics = run(torch.zeros(2), 3)
    assert trace_count(run) == 0 and metrics["v"].shape == (3,)
    assert torch.equal(carry, torch.full((2,), 3.0))
    assert R is not None
