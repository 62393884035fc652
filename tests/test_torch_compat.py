"""The port's drop-in surface against the JAX package, on the CPU.

  - `GymCompat` (`cairl.make`): CartPole-v1 for 50 steps on both step APIs
    beside the JAX shim from the same seed, with the actions each shim's
    `action_space.sample()` draws (equal exactly); the seed mid-episode,
    the 5-tuple's truncation, `spec`, `render_mode`, `render()` and the
    space shims' copy and pickle;
  - the registry: construction kwargs, the `TypeError` naming unknown ones,
    `register`/`specs`/`spec_of`, tags, `make_vec`'s env kwargs and the
    geometry refusal of an instance the CUDA kernel does not fit;
  - the transforms with no fusion role (`FlattenObs`, `RewardScale`) and
    `flatten_space`/`flatten_obs`, `Vec.sample_actions`, `zeros_info` and
    `terminal_timestep`;
  - the runners at B = 4 over 32 steps (`rollout`, `rollout_random`,
    `rollout_random_fast`, each also rendering) and `episode_return`;
    `PythonRunner` and `HostPool` totals; `Impact`'s arithmetic.

Floats are held to 1e-5/1e-6 (`conftest.assert_leaves_match`), rendered
frames to 1e-5 (tests/test_torch_arcade.py says why), ints, bools and keys
exactly. JAX runs in the legacy threefry layout of the goldens.
"""
import copy
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as JCORE
import repro.core.pipeline as JP
import repro.core.spaces as JS
import repro.core.wrappers as JW
import repro.envs.classic as JC
import repro_torch
import repro_torch.core as TCORE
import repro_torch.core.pipeline as TP
import repro_torch.core.spaces as TS
import repro_torch.core.wrappers as TW
import repro_torch.envs.classic as TC
from conftest import assert_leaves_match
from repro.core import runner as JR
from repro.envs import baseline_python as JB
from repro.pool import HostPool as JHostPool
from repro.sustainability import impact as JI
from repro_torch import cairl
from repro_torch import random as R
from repro_torch.core import env as TE
from repro_torch.core import runner as TR
from repro_torch.core.gym_compat import GymCompat, _SpaceShim
from repro_torch.envs import baseline_python as TB
from repro_torch.pool import HostPool, auto_backend, make_pool
from repro_torch.sustainability import impact as TI

CPU = "cpu"
FRAME_ATOL = 1e-5
legacy = lambda: jax.threefry_partitionable(False)


@pytest.fixture(autouse=True)
def _one_thread():
    """These tensors are tiny: PyTorch's intra-op threads only add
    overhead to them, so each test runs on one (and puts the count back)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tkey(jkey) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jkey).astype(np.int64))


def _match(want, got, what):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    assert_leaves_match(np.asarray(want), np.asarray(got), what)


# -- GymCompat ------------------------------------------------------------------

@pytest.mark.parametrize("new_step_api", (False, True))
def test_gym_compat_follows_the_jax_shim(new_step_api):
    """50 steps from seed 3 with the shims' own sampled actions (equal),
    resetting where an episode ends: obs at the parity contract, reward,
    done, truncation and the info keys exactly."""
    got_env = cairl.make("CartPole-v1", seed=3, new_step_api=new_step_api,
                         device=CPU)
    with legacy():
        want_env = JCORE.make_compat("CartPole-v1", seed=3,
                                     new_step_api=new_step_api)
        _match(want_env.reset(), got_env.reset(), "reset obs")
        ends = 0
        for t in range(50):
            a_want = want_env.action_space.sample()
            a_got = got_env.action_space.sample()
            assert a_got == a_want and a_got.dtype == a_want.dtype, t
            want, got = want_env.step(a_want), got_env.step(a_got)
            assert len(got) == (5 if new_step_api else 4)
            _match(want[0], got[0], f"obs {t}")
            assert got[1:-1] == want[1:-1], (t, got[1:-1], want[1:-1])
            assert sorted(got[-1]) == sorted(want[-1])
            if any(got[2:-1]):
                ends += 1
                _match(want_env.reset(), got_env.reset(), f"reset {t}")
    assert ends >= 1
    assert got_env.observation_space.shape == (4,)


def test_gym_compat_seed_mid_episode_and_truncation():
    """Reseeding drops the episode in flight (step() then asks for a
    reset), and the new seed's episode is the JAX shim's; a TimeLimit cut
    is `truncated`, not `terminated`, in the 5-tuple."""
    got_env = cairl.make("CartPole-v1", seed=3, device=CPU)
    with legacy():
        want_env = JCORE.make_compat("CartPole-v1", seed=3)
        for env in (got_env, want_env):
            env.reset()
            env.step(1)
            env.seed(7)
            with pytest.raises(RuntimeError, match="reset"):
                env.step(1)
        _match(want_env.reset(), got_env.reset(), "reset after seed(7)")
        assert got_env.action_space.sample() == want_env.action_space.sample()
    e = GymCompat(TW.TimeLimit(TC.Pendulum(), 3), new_step_api=True,
                  device=CPU)
    e.reset()
    outs = [e.step([0.0]) for _ in range(3)]
    assert [o[2:4] for o in outs] == [(False, False)] * 2 + [(False, True)]
    assert "truncated" not in outs[-1][-1]


def test_gym_compat_spec_render_and_shims():
    e = cairl.make("CartPole-v1", render_mode="rgb_array", device=CPU)
    assert e.spec is repro_torch.spec("CartPole-v1") and e.spec.max_steps == 500
    assert e.render_mode == "rgb_array"
    assert GymCompat(TW.TimeLimit(TC.CartPole(), 10), device=CPU).spec is None
    assert type(e.unwrapped) is TC.CartPole
    e.reset()
    got = e.render()   # frames against JAX's: test_rollout_random_matches_jax
    assert got.shape == (84, 84) and got.max() > 0.5
    for shim in (e.action_space, e.observation_space):
        for clone in (copy.copy(shim), copy.deepcopy(shim),
                      pickle.loads(pickle.dumps(shim))):
            assert isinstance(clone, _SpaceShim)
            assert np.shape(clone.sample()) == np.shape(shim.sample())
    assert e.action_space.n == 2
    with pytest.raises(AttributeError):
        e.action_space.__wrapped__
    e.close()
    with pytest.raises(RuntimeError, match="reset"):
        e.step(0)


def test_sampled_spaces_match_jax():
    """`space.sample(key)` per space kind, and a batch of lane keys as
    `jax.vmap(space.sample)` draws it (`Vec.sample_actions`)."""
    pairs = ((JS.Discrete(7), TS.Discrete(7)),
             (JS.MultiDiscrete((3, 5, 2)), TS.MultiDiscrete((3, 5, 2))),
             (JS.Box(-2.0, 2.0, (3,)), TS.Box(-2.0, 2.0, (3,))),
             (JS.Box((-1.0, 0.0), (1.0, 4.0), (2,)),
              TS.Box((-1.0, 0.0), (1.0, 4.0), (2,))),
             (JS.Box(-np.inf, np.inf, (4,)), TS.Box(-np.inf, np.inf, (4,))))
    with legacy():
        keys = jax.random.split(jax.random.PRNGKey(5), 6)
        # one compile for every space
        want = jax.jit(lambda k: [jax.vmap(j.sample)(k) for j, _ in pairs]
                       + [j.sample(k[0]) for j, _ in pairs]
                       + [JW.Vec(JC.CartPole(), 6).sample_actions(k[1])])(keys)
    got = ([t.sample(_tkey(keys)) for _, t in pairs]
           + [t.sample(_tkey(keys[0])) for _, t in pairs]
           + [TW.Vec(TC.CartPole(), 6).sample_actions(_tkey(keys[1]))])
    for i, (w, g) in enumerate(zip(want, got)):
        assert tuple(g.shape) == w.shape, i
        _match(w, g, repr(pairs[i % len(pairs)][1]))


# -- the registry ---------------------------------------------------------------

def test_registry_kwargs_register_and_spec_of():
    lights = repro_torch.make("LightsOut-v0", n=4)
    assert lights.observation_space.shape == (16,)
    assert lights.spec is repro_torch.spec("LightsOut-v0")
    with pytest.raises(TypeError, match=r"unknown kwargs \['bogus'\]"):
        repro_torch.make("CartPole-v1", bogus=1)
    with pytest.raises(TypeError, match="bogus"):
        cairl.make("CartPole-v1", bogus=1, device=CPU)
    # the JAX package's specs, field for field (tags, kwargs, time limits)
    got = {s.id: (s.tags, s.kwargs, s.max_steps, s.pixels)
           for s in TCORE.specs()}
    want = {s.id: (s.tags, s.kwargs, s.max_steps, s.pixels)
            for s in JCORE.specs()}
    assert got == want and len(got) == 28
    # a hand-built factory under a new id, found through wrapper layers
    spec = TCORE.register("TinyCart-v9",
                          lambda: TW.TimeLimit(TC.CartPole(), 7),
                          tags={"test"})
    try:
        env = repro_torch.make("TinyCart-v9")
        assert TCORE.spec_of(TW.Vec(TW.AutoReset(env), 2)) is spec
        assert "TinyCart-v9" in repro_torch.registered()
        assert spec.transforms == () and spec.max_steps is None
        with pytest.raises(ValueError, match="already registered"):
            TCORE.register("TinyCart-v9", TC.CartPole)
    finally:
        from repro_torch.core import registry
        registry._REGISTRY.pop("TinyCart-v9")
    assert TCORE.spec_of(TC.CartPole()) is None


def test_make_vec_env_kwargs_and_the_geometry_refusal():
    """Env kwargs reach the pool; a grid instance the compiled body does not
    fit takes "vmap" under `auto` on the card and is refused under
    "cuda", naming the mismatch; on the CPU it fuses through the plain
    megastep. `make_pool`'s "async" and "sharded" give the async pool and
    the sharded pool (over `mesh`, or the one device named)."""
    pool = repro_torch.make_vec("CliffWalk-v0", 3, device=CPU, n_rows=3,
                                n_cols=16)
    assert pool.observation_space.shape == (48,) and pool.backend == "torch"
    assert pool.reset(0).shape == (3, 48)
    assert auto_backend(pool.env, torch.device("cuda")) == "vmap"
    assert auto_backend(repro_torch.make("CliffWalk-v0"),
                        torch.device("cuda")) == "cuda"
    with pytest.raises(NotImplementedError, match="n_cols"):
        repro_torch.make_vec("CliffWalk-v0", 3, backend="cuda", device=CPU,
                             n_rows=3, n_cols=16)
    with pytest.raises(TypeError, match="bogus"):
        repro_torch.make_vec("CartPole-v1", 3, device=CPU, bogus=2)
    with pytest.raises(ValueError, match="registry id"):
        repro_torch.make_vec(TC.CartPole(), 3, device=CPU, n=2)
    with pytest.raises(ValueError, match="host=True"):
        repro_torch.make_vec("CartPole-v1", 3, host=True, n=2)
    assert make_pool("CartPole-v1", 2, step_backend="torch",
                     device=CPU).backend == "torch"
    assert isinstance(make_pool("CartPole-v1", 2, backend="host"), HostPool)
    apool = make_pool("CartPole-v1", 2, backend="async", device=CPU)
    assert type(apool).__name__ == "AsyncEnvPool"
    assert apool.device == torch.device(CPU) and apool.backend == "torch"
    spool = make_pool("CartPole-v1", 2, backend="sharded", device=CPU)
    assert type(spool).__name__ == "ShardedEnvPool"
    assert spool.mesh == (torch.device(CPU),) and spool.backend == "vmap"
    assert make_pool("CartPole-v1", 2, backend="sharded", mesh=(CPU, CPU),
                     step_backend="torch").n_shards == 2


# -- transforms with no fusion role -------------------------------------------

def test_flatten_and_reward_scale_take_vmap_and_match_jax():
    stack = (JP.TimeLimit(20), JP.FlattenObs(), JP.RewardScale(0.5))
    tstack = (TP.TimeLimit(20), TP.FlattenObs(), TP.RewardScale(0.5))
    jenv = JP.build_pipeline(JC.CartPole(), stack)
    tenv = TP.build_pipeline(TC.CartPole(), tstack)
    assert TP.declared_pipeline(tenv)[1] == tstack
    assert not TE.supports_fused_step(tenv)
    assert auto_backend(tenv, torch.device(CPU)) == "vmap"
    pool = repro_torch.make_vec(tenv, 4, device=CPU)
    assert pool.backend == "vmap"
    with legacy():
        want = JR.rollout_random(jenv, jax.random.PRNGKey(2), 32, 4)
    got = TR.rollout_random(tenv, R.PRNGKey(2), 32, 4, device=CPU)
    for w, g, what in zip(want[:2], got[:2], ("reward", "episodes")):
        _match(w, g, what)
    assert got[0].tolist() == [0.5 * 32] * 4   # CartPole pays 1 a step
    for jspace, tspace, obs in (
            (JS.Discrete(4), TS.Discrete(4), np.int32([[0, 3], [2, 1]])),
            (JS.MultiDiscrete((2, 3)), TS.MultiDiscrete((2, 3)),
             np.int32([[[1, 2], [0, 0]], [[1, 1], [0, 2]]])),
            (JS.Box(0.0, 1.0, (2, 3)), TS.Box(0.0, 1.0, (2, 3)),
             np.arange(24, dtype=np.float32).reshape(2, 2, 2, 3))):
        want = jax.vmap(jax.vmap(lambda o: JS.flatten_obs(jspace, o)))(obs)
        got = TS.flatten_obs(tspace, torch.from_numpy(obs))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        jflat, tflat = JS.flatten_space(jspace), TS.flatten_space(tspace)
        assert tflat.shape == jflat.shape
        assert (tflat.low, tflat.high) == (jflat.low, jflat.high)


def test_zeros_info_and_terminal_timestep():
    assert TE.zeros_info() == {}
    ts = TE.terminal_timestep(TC.CartPole(), None, torch.zeros(3, 4))
    assert ts.reward.shape == (3,) and bool(ts.done.all()) and ts.info == {}
    assert ts.reward.dtype == torch.float32
    one = TE.terminal_timestep(TC.CartPole(), None, torch.zeros(4))
    assert one.done.shape == () and float(one.reward) == 0.0


# -- runners, pools, impact -----------------------------------------------------

B, T = 4, 32


def _policy_jax(params, obs, key):
    """One lane: greedy on a linear score, or random with p = 0.3."""
    explore = jax.random.uniform(key) < 0.3
    greedy = (obs @ params > 0).astype(jnp.int32)
    return jnp.where(explore, jax.random.randint(key, (), 0, 2), greedy)


def _policy_torch(params, obs, keys):
    """The same policy for the lanes of `keys` (..., 2) at once."""
    explore = R.uniform(keys, ()) < 0.3
    greedy = ((obs @ params) > 0).to(torch.int32)
    return torch.where(explore, R.randint(keys, (), 0, 2), greedy)


#: an anti-balancing linear score, so episodes end inside the rollout
W = np.float32([0.3, 0.2, -1.5, -0.7])


def test_rollout_matches_jax():
    env_j, env_t = JC.CartPole(), TC.CartPole()
    with legacy():
        want = JR.rollout(env_j, _policy_jax, jnp.asarray(W), T, B,
                          jax.random.PRNGKey(4))
    got = TR.rollout(env_t, _policy_torch, torch.from_numpy(W), T, B,
                     R.PRNGKey(4), device=CPU)
    assert isinstance(got, TR.Trajectory)
    for f in TR.Trajectory._fields:
        _match(getattr(want, f), getattr(got, f), f"rollout.{f}")
    assert int(got.done.sum()) >= 1


@pytest.mark.parametrize("fast", (False, True))
def test_rollout_random_matches_jax(fast):
    env_j = JP.build_pipeline(JC.CartPole(), (JP.TimeLimit(30),))
    env_t = TP.build_pipeline(TC.CartPole(), (TP.TimeLimit(30),))
    """At B = 4 over 32 steps against JAX. Rendering every frame moves
    nothing of the trajectory and returns the last frame (the rasteriser
    is held against JAX's in tests/test_torch_raster.py and
    tests/test_torch_pool.py's render rollout)."""
    jfn = JR.rollout_random_fast if fast else JR.rollout_random
    tfn = TR.rollout_random_fast if fast else TR.rollout_random
    with legacy():
        want = jfn(env_j, jax.random.PRNGKey(6), T, B, False)
    got = tfn(env_t, R.PRNGKey(6), T, B, device=CPU)
    _match(want[0], got[0], "sum_reward")
    _match(want[1], got[1], "episodes")
    assert tuple(got[2].shape) == (B,) and int(got[1].sum()) >= 1
    rew, eps, frame = tfn(env_t, R.PRNGKey(6), T, B, render=True,
                           device=CPU)
    assert torch.equal(rew, got[0]) and torch.equal(eps, got[1])
    assert tuple(frame.shape) == (B, 84, 84) and float(frame.max()) > 0.5


def test_episode_return_matches_jax():
    """An episode the env ends before `max_steps`, as JAX's `while_loop`
    ends it; and one cut by `max_steps`."""
    with legacy():
        want = JR.episode_return(JC.CartPole(), _policy_jax, jnp.asarray(W),
                                 jax.random.PRNGKey(8), 40)
    got = TR.episode_return(TC.CartPole(), _policy_torch, torch.from_numpy(W),
                            R.PRNGKey(8), 40, device=CPU)
    _match(want[0], got[0], "return")
    _match(want[1], got[1], "steps")
    assert got[1].dtype == torch.int32 and 1 <= int(got[1]) < 40
    cut = TR.episode_return(TC.CartPole(), _policy_torch, torch.from_numpy(W),
                            R.PRNGKey(8), 3, device=CPU)
    assert (float(cut[0]), int(cut[1])) == (3.0, 3)


def test_python_runner_and_host_pool_match_jax():
    """The interpreted CartPole (each package's copy): the runners' totals
    exactly, a 1-env pool equal to the runner, and the pool's batched
    step API with its straggler telemetry."""
    want = JR.PythonRunner(JB.CartPolePy).run(300, seed=5)
    got = TR.PythonRunner(TB.CartPolePy).run(300, seed=5)
    assert got == want and got[1] >= 1
    jpool, tpool = JHostPool("CartPole-v1", 3), HostPool("CartPole-v1", 3)
    try:
        w, g = jpool.run_random(200, seed=2), tpool.run_random(200, seed=2)
        for a, b in zip(w, g):
            np.testing.assert_array_equal(b, a)
        assert tuple(g[0]) == tuple(
            np.float32(TR.PythonRunner(TB.CartPolePy).run(200, seed=2 + i)[0])
            for i in range(3))
        obs = tpool.reset(seed=1)
        np.testing.assert_array_equal(obs, jpool.reset(seed=1))
        acts = np.array([0, 1, 1])
        for t in range(40):
            out_t, out_j = tpool.step(acts), jpool.step(acts)
            for a, b in zip(out_j[:3], out_t[:3]):
                np.testing.assert_array_equal(b, a)
            np.testing.assert_array_equal(out_t[3]["terminal_obs"],
                                          out_j[3]["terminal_obs"])
        assert sorted(tpool.tracker.ewma) == [0, 1, 2]
        assert isinstance(tpool.stragglers(), list)
        with pytest.raises(RuntimeError, match="recv"):
            tpool.send(acts)
            tpool.send(acts)
        tpool.recv()
        with pytest.raises(ValueError, match="batch"):
            tpool.send(acts[:2])
    finally:
        jpool.close()
        tpool.close()


def test_impact_arithmetic_matches_jax():
    assert (TI.CPU_TDP_WATTS, TI.CARBON_INTENSITY_KG_PER_KWH) == (
        JI.CPU_TDP_WATTS, JI.CARBON_INTENSITY_KG_PER_KWH)
    for wall, cpu in ((10.0, 4.0), (3.0, 30.0), (0.0, 1.0), (7.5, 7.5)):
        got, want = TI.Impact(wall, cpu), JI.Impact(wall, cpu)
        assert got.report() == want.report()
        assert got.minus(TI.Impact(2.0, 1.0)).report() == want.minus(
            JI.Impact(2.0, 1.0)).report()
    with TI.ImpactTracker() as tracker:
        sum(i * i for i in range(20000))
    report = tracker.impact.report()
    assert report["wall_s"] > 0 and report["energy_mWh"] >= 0
    # the static model charges a power limit its caller names: no default
    assert TI.StaticImpact(2e-9, 700.0).report() == JI.StaticImpact(
        2e-9, 700.0).report()
    with pytest.raises(TypeError):
        TI.StaticImpact(2e-9)
