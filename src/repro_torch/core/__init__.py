"""Virtual-time SSD pipeline (port of ``repro/core``)."""
