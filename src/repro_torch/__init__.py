"""PyTorch + CUDA port of the TQ-DiT serving path (Hopper, sm_90a).

``repro`` (JAX/Pallas) is the reference; this package mirrors its module
paths and names and never imports ``jax`` or ``repro``. The three Pallas
kernels on the W8A8 serving path are hand-written CUDA C++ under
``csrc/`` (built with ``nvcc`` at first use, bound with ``ctypes``); every
other op is plain torch.

Entry points run on the card unless the caller asks for the CPU: a
``device`` left unset means ``"cuda"`` and raises where CUDA is absent
(:func:`repro_torch.device.resolve_device`). On CPU tensors each kernel
wrapper runs its plain PyTorch version — that is how the tests hold the
port against the JAX reference on a machine without a GPU.
"""
