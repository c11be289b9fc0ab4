"""Multi-PROCESS mesh correctness for P8.

All other sharding tests run single-process over 8 local devices, where
every collective stays in one address space.  Here two OS processes (4
virtual CPU devices each) join via ``jax.distributed`` and the
edge-sharded GBA runs over a ("host", "local") = (2, 4) mesh whose OUTER
axis is the process boundary — its psums serialize through the
distributed runtime exactly like traffic between two hosts
(SURVEY section 2.3 P8).
"""

import os
import socket
import subprocess
import sys

import numpy as np


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_dcn_mesh_gba(tmp_path):
    here = os.path.dirname(os.path.abspath(__file__))
    worker = os.path.join(here, "mp_gba_worker.py")
    repo_root = os.path.dirname(here)
    port = _free_port()
    out = str(tmp_path / "mp_result.npz")

    env = dict(os.environ)
    extra = env.get("PYTHONPATH", "")
    env["PYTHONPATH"] = repo_root + (os.pathsep + extra if extra else "")
    env["JAX_PLATFORMS"] = "cpu"
    # the worker sets its own device-count flags before jax init
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), str(port), out],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(2)
    ]
    outputs = []
    try:
        for p in procs:
            o, _ = p.communicate(timeout=420)
            outputs.append(o)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError("multiprocess workers timed out")
    for i, p in enumerate(procs):
        assert p.returncode == 0, (
            f"worker {i} failed:\n{outputs[i][-3000:]}"
        )
    res = np.load(out)

    # single-process single-program reference on the same seeded problem
    sys.path.insert(0, here)
    from test_ba import CAM, _make_ba_problem

    from opendlv_perception_vision_orbslam2_jax.optim.gba import (
        global_bundle_adjust,
    )

    T_gt, pts_gt, prob = _make_ba_problem(0)
    T_ref, pts_ref, _ = global_bundle_adjust(
        prob, **CAM, n_outer=8, cg_iters=30
    )
    np.testing.assert_allclose(res["T"], np.asarray(T_ref), atol=5e-3)
    valid = np.asarray(prob.pt_valid)
    np.testing.assert_allclose(
        res["pts"][valid], np.asarray(pts_ref)[valid], atol=5e-2
    )
