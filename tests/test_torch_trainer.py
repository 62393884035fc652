"""The port's LM trainer, gradient compression and training launcher
against the JAX package, on the CPU.

- `make_train_step`: 3 steps from a JAX `AdamState` carried across with
  `state_from_numpy` (the state after one JAX step, so mu and nu are not
  0) against the JAX package's jitted step: loss, grad_norm, lr, params,
  mu, nu and the step count each step; with `accum_steps=2` and with
  `compress_pod_grads=True`. The step writes params, mu and nu in place
  (the JAX launcher's donation), with `Adam.update_`, which gives
  `Adam.update`'s numbers bit for bit.
- `train/compression.py` against `repro.train.compression`: bit for bit.
- `launch/train.py` on `--device cpu`, and a `--resume` from its
  checkpoint that continues with the losses of an uninterrupted run, bit
  for bit (the JAX package's test_checkpoint_restart_training_is_exact).
Floats at f32's 1e-5: rtol, and atol times the leaf's largest entry (mu
and nu are far below 1); the step count exactly.
"""
import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import compression as jax_compression
from repro.train import trainer as jax_trainer
from repro_torch.configs.registry import get_config
from repro_torch.launch import train as launch_train
from repro_torch.models import lm
from repro_torch.train import compression
from repro_torch.train.trainer import (TrainConfig, init_train_state,
                                       make_optimizer, make_train_step,
                                       state_from_numpy)
from test_torch_lm_train import close, jax_setup, make_batch


@pytest.fixture(autouse=True)
def _one_thread():
    """These tensors are small: PyTorch's intra-op threads, next to the
    other test workers' and JAX's, only oversubscribe the cores, so each
    test runs on one (and puts the count back)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "h2o-danube-1.8b"


def jax_tc(tc):
    return jax_trainer.TrainConfig(**dataclasses.asdict(tc))


def run_both(tc, steps=3):
    """The port's and the JAX package's train steps side by side from the
    JAX state after one step, comparing every step."""
    jcfg, params = jax_setup(ARCH)
    cfg = get_config(ARCH, reduced=True)
    jstep = jax.jit(jax_trainer.make_train_step(jcfg, jax_tc(tc)))
    jparams = jax.tree.map(jnp.asarray, params)
    jopt = jax_trainer.make_optimizer(jax_tc(tc)).init(jparams)
    jparams, jopt, _ = jstep(jparams, jopt, make_batch(jcfg, 100, b=4))
    p, opt = state_from_numpy(jax.tree.map(np.asarray, jparams),
                              jax.tree.map(np.asarray, jopt), "cpu")
    step = make_train_step(cfg, tc)
    for s in range(steps):
        batch = make_batch(jcfg, s, b=4)
        jparams, jopt, jm = jstep(jparams, jopt, batch)
        p, opt, m = step(p, opt, {k: torch.from_numpy(v) for k, v in batch.items()})
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       err_msg=f"step {s} {key}", **TOL)
        assert int(opt.step) == int(jopt.step) == s + 2
        close(p, jparams, f"step {s} params", TOL, leaf_scaled=True)
        close(opt.mu, jopt.mu, f"step {s} mu", TOL, leaf_scaled=True)
        close(opt.nu, jopt.nu, f"step {s} nu", TOL, leaf_scaled=True)
    return p, opt


def test_train_steps_from_a_carried_jax_state_match_jax():
    tc = TrainConfig(lr=1e-3, warmup=2, total_steps=10)
    assert tc.remat == "dots"
    run_both(tc)


def test_the_step_updates_in_place_with_the_pure_updates_numbers():
    """`make_train_step` writes params, mu and nu in place; `Adam.update_`
    gives `Adam.update`'s numbers bit for bit, clipping and weight decay
    included."""
    jcfg, params = jax_setup(ARCH)
    cfg = get_config(ARCH, reduced=True)
    tc = TrainConfig(lr=1e-3, warmup=2, total_steps=10, clip_norm=0.5)
    p = lm.params_from_numpy(params, "cpu")
    opt = make_optimizer(tc).init(p)
    leaves = lm.tree_leaves((p, opt.mu, opt.nu))
    step = make_train_step(cfg, tc)
    for s in range(2):
        p, opt, _ = step(p, opt, make_batch(jcfg, s, b=4))
    assert all(x is y for x, y in zip(lm.tree_leaves((p, opt.mu, opt.nu)), leaves))
    grads = lm.tree_map(lambda x: torch.randn(x.shape, generator=torch.Generator()
                                              .manual_seed(x.numel())), p)
    adam = make_optimizer(tc)
    want_p, want_opt = adam.update(grads, opt, p)
    got_p, got_opt = adam.update_(grads, opt, p)
    for x, y in zip(lm.tree_leaves((want_p, want_opt)), lm.tree_leaves((got_p, got_opt))):
        torch.testing.assert_close(y, x, rtol=0, atol=0)


def test_accumulated_train_steps_match_jax():
    run_both(TrainConfig(lr=1e-3, warmup=2, total_steps=10, accum_steps=2,
                         remat="none"), steps=2)


def test_accumulation_refuses_a_batch_it_cannot_split():
    cfg = get_config(ARCH, reduced=True)
    tc = TrainConfig(accum_steps=2)
    params = lm.params_from_numpy(jax_setup(ARCH)[1], "cpu")
    with pytest.raises(ValueError, match="does not split into 2"):
        make_train_step(cfg, tc)(params, make_optimizer(tc).init(params),
                                 make_batch(cfg, 0, b=3))


def test_compressed_train_steps_match_jax():
    run_both(TrainConfig(lr=1e-3, warmup=2, total_steps=10,
                         compress_pod_grads=True, remat="full"), steps=2)


# -- compression ---------------------------------------------------------------
def grads_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((5, 7)).astype(np.float32) * 3,
            "b": [rng.standard_normal(11).astype(np.float32) * 1e-3,
                  np.zeros(4, np.float32)]}


def as_torch(tree):
    return lm.tree_map(torch.from_numpy, tree)


def equal(got, want):
    for a, b in zip(jax.tree.leaves(want), lm.tree_leaves(got)):
        assert b.dtype == getattr(torch, str(np.asarray(a).dtype))
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_compression_matches_jax_bit_for_bit():
    g, r = grads_tree(0), grads_tree(1)
    for name, x in (("a", g["a"]), ("b", g["b"][0]), ("zeros", g["b"][1])):
        q, s = compression._quantize(torch.from_numpy(x))
        jq, js = jax_compression._quantize(jnp.asarray(x))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq), err_msg=name)
        assert float(s) == float(js), name
    equal(compression.compress_decompress(as_torch(g)),
          jax_compression.compress_decompress(g))
    out, res = compression.compress_with_feedback(as_torch(g), as_torch(r))
    jout, jres = jax_compression.compress_with_feedback(g, r)
    equal(out, jout)
    equal(res, jres)
    equal(compression.residual_init(as_torch(g)), jax_compression.residual_init(g))
    # one member: the JAX package's psum over a one-long named axis
    one = jax.vmap(lambda t: jax_compression.psum_compressed(t, "pod"),
                   axis_name="pod")(jax.tree.map(lambda x: x[None], g))
    equal(compression.psum_compressed(as_torch(g)),
          jax.tree.map(lambda x: x[0], one))


def test_quantize_rounds_half_to_even():
    x = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 63.5])
    q, s = compression._quantize(x)
    assert float(s) == 1.0
    assert q.tolist() == [127, 0, 2, 2, 0, -2, 64]


# -- the launcher ---------------------------------------------------------------
ARGS = ["--device", "cpu", "--arch", ARCH, "--batch", "4", "--seq", "16",
        "--log-every", "100"]


def test_launcher_trains_on_the_cpu(capsys):
    out = launch_train.main(ARGS + ["--steps", "4", "--remat", "dots",
                                    "--accum", "2"])
    assert [h["step"] for h in out["history"]] == [0, 1, 2, 3]
    assert all(np.isfinite(h["loss"]) and h["grad_norm"] > 0
               for h in out["history"])
    assert out["device"] == torch.device("cpu")
    assert int(out["opt"].step) == 4
    assert out["tc"].remat == "dots" and out["tc"].accum_steps == 2
    assert "final loss" in capsys.readouterr().out


def test_whisper_launcher_draws_its_frames_from_the_step():
    cfg = get_config("whisper-base", reduced=True)
    dc = launch_train.DataConfig(vocab_size=cfg.vocab_size, seq_len=8,
                                 global_batch=2)
    a = launch_train.batch_at(cfg, dc, 3, "cpu")
    assert a["frames"].shape == (2, cfg.encoder_len, cfg.d_model)
    torch.testing.assert_close(launch_train.batch_at(cfg, dc, 3, "cpu")["frames"],
                               a["frames"], rtol=0, atol=0)
    assert not torch.equal(launch_train.batch_at(cfg, dc, 4, "cpu")["frames"],
                           a["frames"])
    out = launch_train.main(["--device", "cpu", "--arch", "whisper-base",
                             "--batch", "2", "--seq", "8", "--steps", "2"])
    assert all(np.isfinite(h["loss"]) for h in out["history"])


def test_resume_continues_with_the_uninterrupted_losses(tmp_path):
    run = ARGS + ["--steps", "6", "--ckpt-every", "3", "--ckpt-dir", str(tmp_path)]
    whole = launch_train.main(run)
    assert sorted(os.listdir(tmp_path)) == ["step_0000000003", "step_0000000006"]
    # preempted after the step-3 checkpoint: the last one never written
    shutil.rmtree(tmp_path / "step_0000000006")
    resumed = launch_train.main(run + ["--resume"])
    assert [h["step"] for h in resumed["history"]] == [3, 4, 5]
    assert ([h["loss"] for h in resumed["history"]]
            == [h["loss"] for h in whole["history"][3:]])
    for a, b in zip(lm.tree_leaves((whole["params"], whole["opt"])),
                    lm.tree_leaves((resumed["params"], resumed["opt"]))):
        torch.testing.assert_close(b, a, rtol=0, atol=0)


def test_init_train_state_is_fresh_adam():
    cfg = get_config(ARCH, reduced=True)
    params, opt = init_train_state(cfg, TrainConfig(),
                                   torch.Generator().manual_seed(0), "cpu")
    assert int(opt.step) == 0
    assert all(not m.any() for m in lm.tree_leaves(opt.mu))
    assert [m.shape for m in lm.tree_leaves(opt.nu)] == \
        [p.shape for p in lm.tree_leaves(params)]
