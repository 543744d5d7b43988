"""Fig 03's SwarmIO cell at depth 512 (``benchmarks/figures.py::
fig03_frontend_plateau``: ``swarmio_cfg(transport="host",
sq_depth=1024)`` on FUTURE_40M, backend costs zeroed by
``_frontend_only_platform()``, 32 rounds) in the reference and in the
port on the CPU. Its timing core runs the three multiply-adds that the
compiled reference fuses (``timing._sorted_batch_core``), which the port
fuses as well: 39262432 virtual IOPS in both, every leaf of the final
state equal but the metrics' float sums, which XLA adds in another
order and the per-tenant sum within its recursion's bound
(``tests/test_torch_fabric.py::assert_states_agree``).

Its NVMeVirt cells (``nvmevirt_cfg(transport="host", sq_depth=1024)``, the
same platform and rounds) are rows of ``chip_smoke.FIGURES_REFERENCE``,
which the ``figures`` phase holds the card to: the cell at depth 8 is
recomputed here from the reference and from the port, every number to
the last digit and the final state leaf by leaf
(``test_torch_figures_validation.check_cells``)."""
import jax
import numpy as np

from benchmarks import common as C
from benchmarks.figures import _frontend_only_platform
from repro.core import types as jt
from repro_torch import convert
from repro_torch.core import engine as te
from repro_torch.core import types as tt
from test_torch_fabric import assert_states_agree, tconfig
from test_torch_figures_validation import check_cells
from port_threads import one_torch_thread  # noqa: F401


def test_fig03_swarmio_cell_at_depth_512():
    cfg = C.swarmio_cfg(transport="host", sq_depth=1024)
    jplat = _frontend_only_platform()
    ref = C.run_engine(cfg, C.FUTURE_40M, jt.WorkloadConfig(io_depth=512),
                       jplat, rounds=32)
    out = te.simulate(tconfig(cfg), tt.SSDConfig(**C.FUTURE_40M.__dict__),
                      tt.WorkloadConfig(io_depth=512),
                      tt.PlatformModel(**jplat.__dict__), rounds=32,
                      device="cpu")
    assert float(ref.metrics.iops()) == 39262432.0
    assert float(out.metrics.iops()) == 39262432.0
    want = {jax.tree_util.keystr(p).lstrip("."): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(ref)[0]}
    assert_states_agree(want, convert.engine_state_to_numpy(out))


def test_fig03_nvmevirt_cell_at_depth_8():
    check_cells("fig03_nvmevirt_8")
