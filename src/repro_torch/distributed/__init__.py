"""Gradient compression (port of ``repro/distributed/compression.py``);
the reference's sharding rules wait for multi-GPU training (ROADMAP A19)."""
