"""The port's static cost model (`repro_torch.analysis.cost`): each
kernel's `cost` against a hand count at two shapes, the counts one step
logs, the regression check on in-memory baselines, the roofline, and
`StaticImpact` against the JAX package's."""
import copy

import pytest
import torch

from repro.sustainability import impact as JI
from repro_torch.analysis import cost as C
from repro_torch.kernels.attention import flash
from repro_torch.kernels.envstep import megastep
from repro_torch.kernels.raster import raster
from repro_torch.sustainability import impact as TI

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


def test_megastep_cost_by_hand():
    # CartPole with TimeLimit: 5 state rows, 4 obs rows; B 65,536, K 32
    b, k, s, o = 65536, 32, 5, 4
    c = megastep.cost("CartPole", b, k, s, o, resets=1000)
    reads = s + 4 + k                  # state, keys (4 floats' worth), act
    writes = s + 4 + k * (2 * o + 3)   # state, keys, obs, tobs, rew, done, trunc
    assert c["bytes"] == 4 * b * (reads + writes) == 4 * 65536 * 402
    assert c["int_ops"] == 79 * (2 * b * k + 1000 * 2)
    assert c["float_ops"] == 49 * b * k
    # Snake, no TimeLimit row: 1 lane, 1 step, no reset
    c = megastep.cost("Snake", 1, 1, 3, 10)
    assert c == {"bytes": 4 * (3 + 4 + 1 + 3 + 4 + 23), "int_ops": 158,
                 "float_ops": 200}


def test_raster_cost_by_hand():
    c = raster.cost(32768, 4, 84, 84, covered_pairs=1_000_000,
                    live_segments=100_000)
    rest = 32768 * 4 * 6 + 32768 * 84 * 84 * 4
    assert c["bytes"] == 4 * (32768 * 4 * 6 + 32768 * 84 * 84)
    assert c["ops"] == 1_000_000 * 25 + rest
    assert c["ops_all_pairs"] == 100_000 * 84 * 84 * 25 + rest
    c = raster.cost(1, 2, 3, 5, covered_pairs=7)
    assert c == {"bytes": 4 * (12 + 15), "ops": 7 * 25 + 12 + 60,
                 "ops_all_pairs": 2 * 15 * 25 + 12 + 60}


def test_flash_cost_by_hand():
    # causal 4 rows over 6 keys at offset 2: rows see 3, 4, 5, 6 keys
    heads = (8, 2, 16, 32)
    c = flash.cost(3, heads, 4, 6, True, 0, 2, 2)
    assert c["live_pairs"] == 18 * 3 * 8
    assert c["flops"] == 2 * 48 * 18 * 3 * 8
    assert c["bytes"] == 2 * 48 * 3 * (8 * 4 + 2 * 6)
    # MiniCPM3's absorbed decode at 3,000 over a 4,096 cache, window-free
    c = flash.cost(1, (40, 1, 288, 256), 1, 4096, True, 0, 3000, 2)
    assert c["live_pairs"] == 40 * 3001
    assert c["bytes"] == 2 * 544 * (40 + 3001)
    # a window of 2, non-causal rows cut to the window's lower edge
    c = flash.cost(1, (1, 1, 16, 16), 3, 8, False, 2, 4, 4)
    assert c["live_pairs"] == (8 - 3) + (8 - 4) + (8 - 5)


def test_a_step_logs_its_kernels_once():
    row = C.cost_cell("CartPole-v1", "torch", batch=4, device=CPU)
    assert row["status"] == "ok" and row["env_steps_per_program"] == 4
    assert row["kernels"]["megastep"]["launches"] == 1
    assert row["kernels"]["megastep"]["bytes"] == megastep.cost(
        "CartPole", 4, 1, 5, 4)["bytes"]
    assert row["kernels"]["megastep"]["int_ops"] >= 79 * 2 * 4
    assert row["bytes"] == row["kernels"]["megastep"]["bytes"] + row["aten"]["bytes"]
    assert row["flops_per_step"] == row["flops"] / 4
    assert row["roofline"]["dominant"] == "memory"
    assert row["static_impact"]["watts"] == C.POWER_LIMIT_WATTS == 700.0
    assert row["peak_live_bytes"] is None
    px = C.cost_cell("Pong-v0", "torch", batch=2, device=CPU)
    assert set(px["kernels"]) == {"megastep", "raster"}
    refused = C.cost_cell("Snake-px", "torch", batch=2, device=CPU)
    assert refused["status"] == "refused" and refused["refusal"] == "ValueError"


def test_roofline_against_the_h100():
    rl = C.roofline(989e12, 3.35e12, "bfloat16")
    assert rl["compute_s"] == pytest.approx(1.0) and rl["memory_s"] == pytest.approx(1.0)
    assert rl["balance_intensity"] == pytest.approx(989e12 / 3.35e12)
    rl = C.roofline(67e12, 1.0)
    assert rl["dominant"] == "compute" and rl["bound_s"] == pytest.approx(1.0)
    assert rl["card"] == "NVIDIA H100 SXM5 80GB" and rl["power_limit_watts"] == 700.0


def test_static_impact_matches_jax():
    for seconds, watts in ((2e-9, 700.0), (1.3e-6, 350.0), (0.0, 700.0)):
        assert TI.StaticImpact(seconds, watts).report() == JI.StaticImpact(
            seconds, watts).report()
    assert C.static_impact(1e-9) == JI.StaticImpact(1e-9, 700.0).report()
    with pytest.raises(TypeError):
        TI.StaticImpact(1e-9)


def _report():
    rows = [{"id": "CartPole-v1", "backend": "cuda", "status": "ok",
             "family": "classic", "batch": 4, "env_steps_per_program": 4,
             "flops_per_step": 100.0, "bytes_per_step": 1000.0,
             "peak_live_bytes": 5000},
            {"id": "Pong-v0", "backend": "cuda", "status": "ok",
             "family": "arcade", "batch": 4, "env_steps_per_program": 4,
             "flops_per_step": 1e5, "bytes_per_step": 1e6,
             "peak_live_bytes": None},
            {"id": "Snake-px", "backend": "cuda", "status": "refused",
             "refusal": "ValueError"}]
    return {"meta": {"device": "cuda"}, "rows": rows}


def test_check_on_in_memory_baselines():
    base = _report()
    assert C.check(copy.deepcopy(base), base) == ([], [])
    new = copy.deepcopy(base)
    new["rows"][0]["bytes_per_step"] = 1200.0          # +20% > classic 10%
    new["rows"][1]["flops_per_step"] = 1.1e5           # +10% < arcade 15%
    problems, notes = C.check(new, base)
    assert len(problems) == 1 and "bytes_per_step regressed +20.0%" in problems[0]
    new["rows"][0]["bytes_per_step"] = 500.0           # improved
    new["rows"][2] = {**base["rows"][0], "id": "Snake-px", "family": "grid"}
    problems, notes = C.check(new, base)
    assert problems == [] and any("improved" in n for n in notes)
    assert any("newly hosted" in n for n in notes)
    gone = copy.deepcopy(base)
    gone["rows"] = gone["rows"][1:]
    gone["rows"][0]["batch"] = 8
    problems, _ = C.check(gone, base)
    assert any("missing" in p for p in problems)
    assert any("batch changed" in p for p in problems)
    assert C.threshold_for("arcade") == 0.15 and C.threshold_for("x") == 0.10
    assert C.family_of("Pong-v0") == "arcade"
    assert C.family_of("dqn/CartPole-v1", C.TRAIN_BACKEND) == "train"
