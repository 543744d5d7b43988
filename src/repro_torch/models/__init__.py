"""LM substrate of the port (port of ``repro/models``): dense attention
blocks; MoE, recurrent and modality blocks are not ported yet."""
