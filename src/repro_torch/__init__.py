"""``repro_torch`` — the PyTorch/CUDA port of the RayFlex datapath package.

A second package beside ``repro`` (the JAX reference, which stays as it
is).  It mirrors ``repro``'s module paths, imports ``torch`` and never
``jax``, and shares no code with ``repro``: whatever it needs of the
reference's helpers it keeps as its own copy.

Entry points put tensors on ``cuda`` unless the caller passes
``device="cpu"``; without a GPU and without ``device="cpu"`` they raise.
On CUDA tensors the main path runs hand-written Hopper kernels
(``repro_torch/csrc``); on CPU tensors it runs their plain PyTorch
versions.  See ``repro_torch.api`` for the public surface.
"""
