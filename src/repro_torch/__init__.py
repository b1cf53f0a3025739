"""PyTorch/CUDA port of the k-center package ``repro``.

The layout mirrors ``repro``: ``core`` (GON, executors, MRG, metrics),
``kernels`` (hand-written Hopper kernels with their plain versions),
``data`` (point-set generators). Entry points run on the card unless the
caller passes ``device="cpu"``. The package imports ``torch`` and numpy,
never ``jax`` or ``repro``.
"""
