"""PyTorch/CUDA port of the k-center package ``repro``.

The layout mirrors ``repro``: ``core`` (GON, executors, MRG, EIM, the
objectives, the sketch, coreset selection), ``kernels`` (hand-written
Hopper kernels with their plain versions), ``data`` (point sets, sources,
the token pipeline), ``models`` (the LM, every family), ``configs`` (the
architectures), ``serve`` (the LM ``Engine`` and sampler, the k-center
service) and ``launch`` (the mesh and the multi-process runs). Entry
points run on the card unless the caller passes ``device="cpu"``. The
package imports ``torch`` and numpy, never ``jax`` or ``repro``.
"""
