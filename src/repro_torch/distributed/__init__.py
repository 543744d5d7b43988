"""Distribution (port of ``repro/distributed``): the logical-axis sharding
rules, ``constrain`` and ``shard_map`` on ``torch.distributed``
(``sharding.py``), gradient compression (``compression.py``), and worlds
of spawned ranks for tests and smoke runs (``world.py``)."""
