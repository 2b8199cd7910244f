"""The port's batch learners across 2 processes on the CPU: the
counterparts of tests/test_multihost_bcd.py and
tests/test_multihost_lbfgs.py.

Each process reads its byte range of rcv1 (launch.py -n 2, unedited;
this file is the worker: ``python tests/test_torch_multihost_batch.py
<out_dir> <learner>``); the dictionaries, the group stats and the row
totals are unioned and summed over the processes, and every pass sums
the processes' partials in rank order (parallel/multihost.allreduce_np),
so both ranks run the same update. Data-parallel summation changes the
floating-point order, not the math: both learners reach the
single-process goldens the JAX package's 2-process runs are held to
(1e-4 relative), and the two ranks' trajectories are equal.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
RCV1 = str(REPO / "tests" / "data" / "rcv1_100.libsvm")

# the JAX 2-process workers' configs (tests/bcd_worker.py,
# tests/lbfgs_worker.py)
CONFS = {
    "bcd": [("l1", ".1"), ("lr", ".05"), ("block_ratio", "0.001"),
            ("tail_feature_filter", "0"), ("max_num_epochs", "10")],
    "lbfgs": [("m", "5"), ("V_dim", "0"), ("l2", "0"), ("init_alpha", "1"),
              ("tail_feature_filter", "0"), ("max_num_epochs", "19")],
}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.skipif((os.cpu_count() or 1) < 2,
                    reason="two gloo processes need >= 2 CPU cores")
@pytest.mark.parametrize("learner", ["bcd", "lbfgs"])
def test_two_process_batch_learner_matches_golden(tmp_path, learner):
    if learner == "bcd":
        from tests.test_bcd import OBJV_DIAG_NEWTON as golden
    else:
        from tests.test_lbfgs import OBJV_BASIC as golden
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run(
        [sys.executable, str(REPO / "launch.py"), "-n", "2", "--port",
         str(free_port()), "--", sys.executable, __file__, str(tmp_path),
         learner],
        cwd=str(REPO), env=env, capture_output=True, text=True,
        timeout=240)
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\n" \
                                 f"stderr:\n{proc.stderr}"
    trajs = []
    for r in (0, 1):
        with open(tmp_path / f"traj-{r}.json") as f:
            trajs.append(json.load(f))
    assert trajs[0] == trajs[1]
    if learner == "bcd":
        np.testing.assert_allclose(trajs[0], golden, rtol=1e-4)
    else:
        np.testing.assert_allclose(trajs[0], golden, rtol=1e-4, atol=1e-4)


if __name__ == "__main__":
    from difacto_tpu_torch.learners.base import Learner
    from difacto_tpu_torch.parallel.multihost import (initialize,
                                                      process_index)
    initialize()
    out_dir, name = pathlib.Path(sys.argv[1]), sys.argv[2]
    ln = Learner.create(name, device="cpu")
    ln.init([("data_in", RCV1)] + CONFS[name])
    seen = []
    ln.add_epoch_end_callback(lambda e, p: seen.append(p.objv))
    ln.run()
    with open(out_dir / f"traj-{process_index()}.json", "w") as f:
        json.dump(seen, f)
