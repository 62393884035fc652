"""`lm.loss_fn` and its gradients against the JAX package's, on the CPU,
for the qk-norm archs: gemma3-27b ("swa" and "full" blocks in one segment)
and chameleon-34b (an untied head); their norm scales, the q and k ones
included, are drawn off 0 so that every (1 + scale) path counts. Params
are numpy draws in the JAX tree, carried with `lm.params_from_numpy`; f32
at 1e-5."""
import pytest
import torch

from test_torch_lm_train import check_loss_and_grads, jax_setup, make_batch


@pytest.fixture(autouse=True)
def _one_thread():
    """These tensors are small: PyTorch's intra-op threads, next to the
    other test workers' and JAX's, only oversubscribe the cores, so each
    test runs on one (and puts the count back)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("arch", ["gemma3-27b", "chameleon-34b"])
def test_loss_fn_and_grads_match_jax(arch):
    check_loss_and_grads(arch, make_batch(jax_setup(arch)[0], 7))
