"""PyTorch/CUDA port of the microcircuit simulator (``repro`` is the JAX
reference it is held against).

Layout mirrors ``repro``: ``core/`` (parameters, connectivity, neuron,
delivery, stimulus, engine), ``kernels/`` (hand-written Hopper kernels
under ``csrc/``, each with its plain PyTorch version), ``api/`` (the
``Simulator`` session), ``models/`` (the LM attention and MLP layers,
attention through K6), ``configs/``, plus ``convert`` to carry a state
or weights between the two packages.  Nothing here imports JAX or ``repro``.
"""
