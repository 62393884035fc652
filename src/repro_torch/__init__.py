"""CaiRL on PyTorch + CUDA: the port of the JAX package `repro`.

Drop-in entry point (paper Listing 2): `from repro_torch import cairl`.
Vectorised entry point: `repro_torch.make_vec(id, num_envs)`, a batched
env pool on the CUDA card; `make`, `make_compat`, `spec` and `registered`
are the registry. The JAX package stays the reference: every module here
has a counterpart there under the same path, and the tests hold each
against it. The port imports no JAX.

Exports resolve lazily (PEP 562), as in the JAX package, so `import
repro_torch` stays cheap and submodules import in any order.
"""

#: public surface of the bare package (the JAX package's `repro`)
__all__ = ["cairl", "make", "make_compat", "make_vec", "registered", "spec"]

_LAZY = {
    "make_vec": ("repro_torch.pool", "make_vec"),
    "make": ("repro_torch.core.registry", "make"),
    "make_compat": ("repro_torch.core.registry", "make_compat"),
    "spec": ("repro_torch.core.registry", "spec"),
    "registered": ("repro_torch.core.registry", "registered"),
}


def __getattr__(name):
    if name == "cairl":
        import importlib

        return importlib.import_module("repro_torch.cairl")
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
