"""Applications on the storage client (port of ``repro/apps``)."""
