"""PyTorch/CUDA port of the SwarmIO emulator (reference: ``src/repro``).

The package mirrors the reference's module layout
(``repro/core/timing.py`` -> ``repro_torch/core/timing.py``) and imports
only ``torch`` and ``numpy``. Entry points (``core.engine.simulate``,
``init_state``, ``make_runner``) run on ``cuda`` unless the caller passes
``device="cpu"``; without a card and without an explicit device they
raise instead of falling back to the CPU.
"""
