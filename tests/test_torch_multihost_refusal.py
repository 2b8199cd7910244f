"""Multi-host training without a mesh, the port against the reference.

The port's SGD learner refuses a run that ``launch.py`` started as more
than one process unless the conf sets a mesh
(difacto_tpu_torch/learners/sgd.py, ``SGDLearner.init``): without the
synchronized schedule the hosts would train independent models that never
meet. The JAX learner refuses only the dictionary store there and lets the
hashed store through (difacto_tpu/learners/sgd.py, ``SGDLearner.init``),
each host then training alone. The port keeps its refusal for both stores;
these tests hold its message and the reference's two answers, with a
two-process ``host_part()`` faked on the CPU (no process group is made).
"""

import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
RCV1 = str(REPO / "tests" / "data" / "rcv1_100.libsvm")
REFUSAL = ("multi-host training needs a mesh: set mesh_dp to a multiple "
           "of the process count 2")
STORES = {"hashed": {"hash_capacity": "1024"}, "dictionary": {}}


def _conf(store: str, **over) -> list:
    conf = {"data_in": RCV1, "V_dim": "2", "batch_size": "100",
            "max_num_epochs": "1", "report_interval": "0",
            "mesh_dp": "1", "mesh_fs": "1", **STORES[store]}
    conf.update(over)
    return list(conf.items())


@pytest.mark.parametrize("store", sorted(STORES))
def test_port_refuses_meshless_multihost(monkeypatch, store):
    from difacto_tpu_torch.learners import sgd
    monkeypatch.setattr(sgd, "host_part", lambda: (1, 2))
    ln = sgd.SGDLearner(device="cpu")
    with pytest.raises(ValueError) as e:
        ln.init(_conf(store))
    assert str(e.value) == REFUSAL


@pytest.mark.parametrize("store", sorted(STORES))
def test_port_takes_one_process_without_a_mesh(monkeypatch, store):
    """The refusal is about the mesh alone: one process without a mesh
    initializes on either store."""
    from difacto_tpu_torch.learners import sgd
    monkeypatch.setattr(sgd, "host_part", lambda: (0, 1))
    ln = sgd.SGDLearner(device="cpu")
    ln.init(_conf(store))
    assert ln.mesh is None and ln._num_hosts == 1


def test_reference_takes_meshless_multihost_hashed_only(monkeypatch):
    """The reference's answers on the same confs: the hashed store
    initializes mesh-less on two hosts, the dictionary store raises its own
    message."""
    from difacto_tpu.learners.sgd import SGDLearner
    from difacto_tpu.parallel import multihost
    monkeypatch.setattr(multihost, "host_part", lambda: (1, 2))
    ln = SGDLearner()
    ln.init(_conf("hashed"))
    assert ln.mesh is None and ln._num_hosts == 2
    with pytest.raises(ValueError, match="require the hashed store"):
        SGDLearner().init(_conf("dictionary"))
