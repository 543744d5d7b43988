"""Serving on the port: paged KV, the SSD-backed KV tier and the
generation loop (port of ``repro/serving``)."""
