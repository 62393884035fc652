"""The port's step-path audit (`repro_torch.analysis.audit`) on the CPU:
the plan covers every registry id × backend, a "vmap" and a "torch" (plain
megastep) cell run end to end with their carries written in place, a
refusal is a named row, the row gate, and the report's schema. Residency,
launch counts and the train rows need the card (chip_smoke.py, phase
audit)."""
import numpy as np
import pytest
import torch

from repro_torch.analysis.audit import (BACKENDS, CPU_BACKENDS,
                                        EXPECTED_REFUSALS, TRAIN_BACKEND,
                                        audit_cell, audit_train_cell,
                                        backends_for, plan, row_violations,
                                        run)
from repro_torch.core.registry import registered
from repro_torch.launch.graph_analysis import (host_transfer_nodes,
                                               written_in_place)
from repro_torch.pool import EnvPool

CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_thread():
    """These tensors are small: PyTorch's intra-op threads, next to the
    other test workers' and JAX's, only oversubscribe the cores, so each
    test runs on one (and puts the count back)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_plan_covers_every_registry_id_and_backend(device):
    backends = BACKENDS if device == "cuda" else CPU_BACKENDS
    assert backends_for(device) == backends
    cells = plan(backends=backends)
    ids = {c[0] for c in cells}
    assert ids == set(registered()) and len(cells) == len(ids) * len(backends)
    for env_id in ids:
        assert {b for i, b in cells if i == env_id} == set(backends)


@pytest.mark.parametrize("env_id,backend", [("CartPole-v1", "vmap"),
                                            ("CartPole-v1", "torch"),
                                            ("Pong-v0", "torch"),
                                            ("FrozenLake-v0", "vmap")])
def test_cell_end_to_end(env_id, backend):
    row = audit_cell(env_id, backend, batch=4, device=CPU)
    assert row["status"] == "ok" and row["step_backend"] == backend
    assert row["moved_leaves"] == [] and row["in_place"] == 1.0
    assert row["carry_leaves"] >= 2 and "host_copies" not in row
    assert row_violations(row) == []


def test_pool_step_writes_its_carry_in_place():
    pool = EnvPool("CartPole-v1", 4, backend="torch", device=CPU)
    pool.reset(0)
    before = [x.clone() for x in torch.utils._pytree.tree_leaves(pool._carry)]
    ptrs = [x.data_ptr() for x in torch.utils._pytree.tree_leaves(pool._carry)]
    pool.step(pool.sample_actions(0))
    after = torch.utils._pytree.tree_leaves(pool._carry)
    assert [x.data_ptr() for x in after] == ptrs
    assert any(not torch.equal(a, b) for a, b in zip(before, after))


def test_refusal_is_named():
    """A fused backend on an id without a megastep spec refuses with the
    documented class, and the refusal is not a violation."""
    row = audit_cell("Snake-px", "torch", batch=4, device=CPU)
    assert row["status"] == "refused" and row["refusal"] == "ValueError"
    assert row["refusal"] in EXPECTED_REFUSALS and row_violations(row) == []
    assert "megastep" in row["refusal_msg"]
    train = audit_train_cell("dqn/CartPole-v1", device=CPU)
    assert train["status"] == "refused" and train["refusal"] == "ValueError"
    assert train["backend"] == TRAIN_BACKEND and "CUDA" in train["refusal_msg"]


def test_row_violations_gate():
    base = {"id": "X-v0", "backend": "cuda", "status": "ok", "moved_leaves": [],
            "carry_leaves": 3, "host_copies": [], "copy_budget": 0,
            "launches": 5}
    assert row_violations(base) == []
    assert row_violations({**base, "moved_leaves": ["[0].x"]})
    assert row_violations({**base, "host_copies": ["copy_ cpu/cuda"]})
    assert row_violations({**base, "launches": 0})
    assert row_violations({**base, "backend": "async", "copy_budget": 1,
                           "host_copies": ["_to_copy cpu/cuda"]}) == []
    assert row_violations({**base, "launches_by_ready_set": {"1": 9, "4": 11}})
    assert row_violations({**base, "status": "refused", "refusal": "KeyError"})
    train = {"id": "dqn/X", "backend": TRAIN_BACKEND, "status": "ok",
             "moved_leaves": [], "carry_leaves": 9, "host_transfer_ops": [],
             "graph_nodes": 40, "leaves_written": 5}
    assert row_violations(train) == []
    assert row_violations({**train, "host_transfer_ops": ["graph_0_node_3"]})
    assert row_violations({**train, "leaves_written": 0})


def test_graph_node_gate_and_in_place():
    nodes = [{"id": 0, "type": "KERNEL", "host": False},
             {"id": 1, "type": "MEMCPY", "host": False},
             {"id": 2, "type": "MEMCPY", "host": True},
             {"id": 3, "type": "HOST", "host": True}]
    assert host_transfer_nodes(nodes) == ["MEMCPY#2", "HOST#3"]
    a, b = torch.zeros(2), torch.zeros(2)
    assert written_in_place({"x": a}, {"x": a}) == []
    assert written_in_place({"x": a}, {"x": b}) == ["['x']"]
    assert written_in_place((a, [b]), (a, [b])) == []


def test_report_schema():
    report = run(ids=["CartPole-v1", "Snake-px"], batch=4, device=CPU)
    assert set(report) == {"meta", "rows", "summary", "violations", "ok"}
    assert report["ok"] and report["violations"] == []
    assert report["meta"]["backends"] == list(CPU_BACKENDS)
    assert report["meta"]["train_cells"] == [] and report["meta"]["device"] == CPU
    s = report["summary"]
    assert (s["cells"], s["hosted"], s["refused"]) == (4, 3, 1)
    assert s["in_place"] == 3 and s["host_resident"] == 3
    assert np.isfinite(len(report["rows"]))
