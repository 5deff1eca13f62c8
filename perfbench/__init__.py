"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``run.py`` runs one cell; ``configs/``, ``workloads/``, ``traffic/``,
``systems/`` and ``metrics/`` hold what belongs to one configuration,
cell, traffic kind, system or metric, found by name; ``reference/`` is
the plain f32 PyTorch the outputs are held against; ``work.py`` counts
FLOPs and bytes; ``tests/`` runs on the CPU (``python -m pytest
perfbench/tests``), ``tools/`` on the card.
"""
