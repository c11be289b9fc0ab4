"""Microbench: bundle_adjust wall time vs edge/point capacity on the device."""
import time
import numpy as np
import jax
import jax.numpy as jnp

from opendlv_perception_vision_orbslam2_jax.optim.ba import BAProblem, bundle_adjust

CAM = dict(fx=718.856, fy=718.856, cx=607.19, cy=185.22, bf=386.1448)
rng = np.random.default_rng(0)


def make(E_cap, P_cap, n_real_e=9000, n_real_p=1800, Ko=8, Kf=8):
    pts = np.stack([rng.uniform(-12, 12, P_cap), rng.uniform(-4, 4, P_cap),
                    rng.uniform(6, 40, P_cap)], -1).astype(np.float32)
    T = np.tile(np.eye(4, dtype=np.float32), (Ko, 1, 1))
    for k in range(Ko):
        T[k, 2, 3] = -0.5 * k
    e_kf = rng.integers(0, Ko + Kf, E_cap).astype(np.int32)
    e_pt = rng.integers(0, n_real_p, E_cap).astype(np.int32)
    Tall = np.concatenate([T, np.tile(np.eye(4, dtype=np.float32), (Kf, 1, 1))])
    p_c = np.einsum("eij,ej->ei", Tall[e_kf][:, :3, :3], pts[e_pt]) + Tall[e_kf][:, :3, 3]
    u = CAM["fx"] * p_c[:, 0] / p_c[:, 2] + CAM["cx"]
    v = CAM["fy"] * p_c[:, 1] / p_c[:, 2] + CAM["cy"]
    ur = u - CAM["bf"] / p_c[:, 2]
    valid = np.zeros(E_cap, bool)
    valid[:n_real_e] = True
    return BAProblem(
        T_opt=jnp.asarray(T), opt_valid=jnp.ones((Ko,), bool),
        T_fix=jnp.asarray(Tall[Ko:]), fix_valid=jnp.ones((Kf,), bool),
        pts=jnp.asarray(pts),
        pt_valid=jnp.asarray(np.arange(P_cap) < n_real_p),
        e_kf=jnp.asarray(e_kf), e_pt=jnp.asarray(e_pt),
        e_uv=jnp.asarray(np.stack([u, v], -1).astype(np.float32)),
        e_ur=jnp.asarray(ur.astype(np.float32)),
        e_sigma2=jnp.ones((E_cap,), jnp.float32),
        e_valid=jnp.asarray(valid),
    )


for E_cap, P_cap in [(32768, 8192), (16384, 8192), (8192, 8192),
                     (16384, 4096), (8192, 2048), (32768, 2048)]:
    prob = make(E_cap, P_cap)
    res = bundle_adjust(prob, **CAM, fix_first_pose=True)
    np.asarray(res.cost)  # compile
    t0 = time.time()
    for _ in range(3):
        res = bundle_adjust(prob, **CAM, fix_first_pose=True)
        np.asarray(res.cost)
    dt = (time.time() - t0) / 3
    print(f"E={E_cap:6d} P={P_cap:5d}: {dt*1e3:8.1f} ms")
