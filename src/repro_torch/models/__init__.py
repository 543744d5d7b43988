"""LM substrate of the port (port of ``repro/models``): attention, MoE,
recurrent and modality blocks; forward, loss, prefill and decode."""
