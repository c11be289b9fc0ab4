"""Worker process for the 2-process mesh test.

Launched (twice) by tests/test_multiprocess.py.  Each process owns 4
virtual CPU devices; ``jax.distributed`` joins them into one 8-device
cluster and the ("host", "local") mesh places the process boundary on the
outer axis — the edge-sharded GBA's psums then cross exactly what the
network between two hosts would carry (P8).
"""

import os
import sys


def main():
    pid = int(sys.argv[1])
    port = sys.argv[2]
    out_path = sys.argv[3]
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax

    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}", num_processes=2,
        process_id=pid,
    )
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_ba import CAM, _make_ba_problem

    from opendlv_perception_vision_orbslam2_jax.optim.ba import BAProblem
    from opendlv_perception_vision_orbslam2_jax.parallel.sharded_ba import (
        EDGE_FIELDS,
        make_sharded_gba,
        pad_edges_to_multiple,
    )

    assert jax.device_count() == 8, jax.device_count()
    assert jax.local_device_count() == 4
    assert jax.process_count() == 2

    # deterministic problem, identical in both processes (seeded host rng)
    T_gt, pts_gt, prob = _make_ba_problem(0)
    prob = pad_edges_to_multiple(prob, 8)

    # outer mesh axis = process boundary (jax.devices() orders by process)
    mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("host", "local"))

    def put(name, arr):
        arr = np.asarray(arr)
        spec = P(("host", "local")) if name in EDGE_FIELDS else P()
        sh = NamedSharding(mesh, spec)
        return jax.make_array_from_callback(arr.shape, sh,
                                            lambda idx: arr[idx])

    prob_s = BAProblem(
        **{n: put(n, getattr(prob, n)) for n in BAProblem._fields}
    )
    run = make_sharded_gba(mesh, ("host", "local"), **CAM, n_outer=8,
                           cg_iters=30)
    T_sh, pts_sh, cost = run(prob_s)
    # outputs replicate (out_specs P()), so shard 0 holds the full arrays
    T_np = np.asarray(T_sh.addressable_data(0))
    pts_np = np.asarray(pts_sh.addressable_data(0))
    if pid == 0:
        np.savez(out_path, T=T_np, pts=pts_np)
    print(f"[worker {pid}] ok", flush=True)


if __name__ == "__main__":
    main()
