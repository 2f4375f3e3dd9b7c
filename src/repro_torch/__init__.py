"""PyTorch/CUDA port of the microcircuit simulator (``repro`` is the JAX
reference it is held against).

Layout mirrors ``repro``: ``core/`` (parameters, connectivity, neuron,
delivery, stimulus, engine), ``kernels/`` (hand-written Hopper kernels
under ``csrc/``, each with its plain PyTorch version), ``api/`` (the
``Simulator`` session), ``configs/``, plus ``convert`` to carry a state
between the two packages.  Nothing here imports JAX or ``repro``.
"""
