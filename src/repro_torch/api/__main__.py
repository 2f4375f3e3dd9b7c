"""The scenario CLI: ``python -m repro_torch.api scenario.json``.

Runs the scenario on the card (``--device cpu`` for the CPU) and exits
with code 4 when its validation fails.  See ``repro_torch.api.experiment``.
"""
from repro_torch.api.experiment import main

raise SystemExit(main())
