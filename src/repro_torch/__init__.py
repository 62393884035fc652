"""CaiRL on PyTorch + CUDA: the port of the JAX package `repro`.

`repro_torch.make_vec(id, num_envs)` builds a batched env pool on the CUDA
card; `make`, `spec` and `registered` are the registry. The JAX package
stays the reference: every module here has a counterpart there under the
same path, and the tests hold each against it. The port imports no JAX.
"""
from repro_torch.core.registry import make, registered, spec
from repro_torch.pool import make_vec

__all__ = ["make", "make_vec", "registered", "spec"]
