"""Training on a mesh of 4 gloo CPU ranks, (data = 2, model = 2), with
``launch.train``'s objects (``setup(data=2, model=2)``, the loop's
``make_train_step`` under ``use_rules``), against the reference's jitted
step under ``use_rules`` on an Auto-axes mesh of 4 virtual CPU devices
(``tests/torch_mesh_reference.py``): starcoder2-3b SMOKE, float32, batch
4 x 32, three steps on ``synth_batch`` batches.

- The three steps: the losses within ``LOSS_REL`` = 1e-5 relative and
  every parameter leaf within ``PARAM_REL`` = 1e-5 of its largest |value|
  (the one-device bounds of ``tests/test_torch_train.py`` on the loss;
  the mesh sums each gradient over the ranks in another order).
- The elastic downsize: parameters and AdamW state placed by
  ``sharding_tree(model_axes)``, two steps on (2, 2), a checkpoint
  written by rank 0; the supervisor (``launch/launcher.py``) sees one of
  the two data-parallel replicas stop and answers ``elastic_downsize`` to
  one; the checkpoint is reloaded onto (data = 1, model = 2) with the
  rules' shardings (reshard-on-load) and takes the third step. Its losses
  and final parameters are the uninterrupted run's within ``LOSS_REL``
  and ``PARAM_REL``.
- The reference's checkpoint (after its three steps) loads onto the
  port's (2, 2) mesh bit for bit.
"""

import numpy as np
import pytest

from repro_torch.distributed.world import run_world

import mesh_worlds
import torch_mesh_bodies
from port_threads import one_torch_thread  # noqa: F401
from test_torch_train_grads import numpy_params
from repro import configs as jconfigs

LOSS_REL = 1e-5
PARAM_REL = 1e-5
ARCH = "starcoder2-3b"


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_train")
    jcfg = jconfigs.get_config(ARCH, smoke=True)
    inp = dict(arch=ARCH, batch=4, seq=32, steps=3, vocab=jcfg.vocab,
               params=numpy_params(jcfg), ref_ckpt=str(tmp / "ref_ckpt"),
               port_ckpt=str(tmp / "port_ckpt"), wait_s=200,
               ckpt_dir=str(tmp / "ref_ckpt"))
    inp["ref_done"] = str(tmp / "train_out.pkl")
    ref = mesh_worlds.start_reference("train", inp, tmp)
    port = run_world(torch_mesh_bodies.train_body, 4, inp,
                     timeout_s=mesh_worlds.WORLD_TIMEOUT_S,
                     store_dir=str(tmp))
    return mesh_worlds.reference_result(ref), port[0]


def test_three_steps_match_reference(results):
    ref, port = results
    assert len(port["losses"]) == 3
    for got, want in zip(port["losses"], ref["losses"]):
        assert abs(got - want) <= LOSS_REL * abs(want)
    assert set(port["params"]) == set(ref["params"])
    bad = [k for k, want in ref["params"].items()
           if not np.abs(port["params"][k] - want).max()
           <= PARAM_REL * np.abs(want).max()]
    assert not bad, bad


def test_elastic_downsize_resume(results):
    ref, port = results
    assert port["action"]["action"] == "elastic_downsize"
    assert port["action"]["new_data_parallel"] == 1
    assert port["resumed_mesh"] == (1, 2)
    assert port["sharded_leaves"] > 0
    for got, want in zip(port["elastic_losses"], port["losses"]):
        assert abs(got - want) <= LOSS_REL * abs(want)
    assert len(port["elastic_losses"]) == 3
    bad = [k for k, want in port["params"].items()
           if not np.abs(port["elastic_params"][k] - want).max()
           <= PARAM_REL * np.abs(want).max()]
    assert not bad, bad


def test_reference_checkpoint_loads_onto_port_mesh(results):
    ref, port = results
    got = port["ref_ckpt_params"]
    assert set(got) == set(ref["params"])
    for k, want in ref["params"].items():
        assert np.array_equal(got[k], want), k
