"""`lm.loss_fn` and its gradients against the JAX package's, on the CPU,
for the MLA (minicpm3-4b), MoE (olmoe-1b-7b, granite-moe-1b-a400m: the
load-balance aux loss weighted in) and encoder-decoder (whisper-base: the
encoder's blocks and the decoder's cross attention) archs; the dense ones
are in tests/test_torch_lm_train.py, the recurrent ones in
tests/test_torch_ssm_grads.py, the qk-norm ones in
tests/test_torch_qk_norm_grads.py. Params are numpy draws in the JAX
tree, carried with `lm.params_from_numpy`; f32 at 1e-5."""
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


@pytest.mark.parametrize("arch", ["minicpm3-4b", "olmoe-1b-7b",
                                  "granite-moe-1b-a400m", "whisper-base"])
def test_loss_fn_and_grads_match_jax(arch):
    check_loss_and_grads(arch, make_batch(jax_setup(arch)[0], 7))
