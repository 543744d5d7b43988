"""Hand-written Hopper kernels of the port and their plain versions
(port of ``repro/kernels``). Importing this package builds nothing: the
CUDA sources compile at the first launch (``kernels/build.py``)."""
