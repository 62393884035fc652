"""`lm.loss_fn` and its gradients against the JAX package's, on the CPU,
for the recurrent archs: xlstm-350m (mLSTM and sLSTM blocks, through the
GLA scan and the sLSTM's loop over time steps) and zamba2-2.7b (Mamba2, and
the shared attention site, whose weights gather gradients from every
site). Params are numpy draws in the JAX tree, carried with
`lm.params_from_numpy`. zamba2 at f32's 1e-5; the reduced xLSTM at 1e-4,
and each gradient leaf at 1e-4 of its largest entry: over its six blocks
the two packages' f32 roundings reach ~1e-5 of the hidden state
(tests/test_torch_ssm_lm.py), and its gradients differ from JAX's by
1e-5 to 3e-5 of each leaf's norm, uniformly over the leaves (JAX's own
jitted and eager gradients by up to 2.5e-5)."""
import pytest
import torch

from test_torch_lm_train import TOL, check_loss_and_grads, jax_setup, make_batch


@pytest.fixture(autouse=True)
def _one_thread():
    """These tensors are small: PyTorch's intra-op threads, next to the
    other test workers' and JAX's, only oversubscribe the cores, so each
    test runs on one (and puts the count back)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


#: the reduced xLSTM stack's known f32 noise against JAX
XLSTM_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["xlstm-350m", "zamba2-2.7b"])
def test_loss_fn_and_grads_match_jax(arch):
    xlstm = arch == "xlstm-350m"
    check_loss_and_grads(arch, make_batch(jax_setup(arch)[0], 7),
                         XLSTM_TOL if xlstm else TOL, leaf_scaled=xlstm)
