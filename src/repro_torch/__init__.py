"""PyTorch/CUDA port of the STC federated-learning system.

The package mirrors ``src/repro`` (the JAX reference) module by module:
``core`` (compression, selection, codecs, wire format), ``kernels`` (the
hand-written Hopper kernels and their plain PyTorch versions, sources in
``csrc/``), ``models``, ``data`` and ``fed``.  It imports neither JAX nor
the reference package.  Entry points run on CUDA unless the caller passes
``device="cpu"``.
"""
