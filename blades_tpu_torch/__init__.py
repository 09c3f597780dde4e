"""blades_tpu_torch: the PyTorch/CUDA port of blades_tpu.

A second package beside the JAX reference, written for one NVIDIA H100.
It imports ``torch`` and never ``jax`` or ``blades_tpu``; its hot kernels
are hand-written CUDA (``csrc/``), built on first use.  Entry points take
``device=None``, meaning ``"cuda"``: they raise when no card is present
unless the caller passes ``device="cpu"``.
"""


def __getattr__(name):
    # Lazy, so that the tools that need no torch (the lint) load none.
    if name == "resolve_device":
        from blades_tpu_torch.device import resolve_device

        return resolve_device
    raise AttributeError(f"module 'blades_tpu_torch' has no attribute {name!r}")
