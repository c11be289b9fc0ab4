"""Bisect the grid-LBA cost on the device: iteration scaling + small-solve cost."""
import time
import functools
import numpy as np
import jax
import jax.numpy as jnp

from opendlv_perception_vision_orbslam2_jax.utils.compile_cache import (  # noqa: E402
    enable_compile_cache,
)

enable_compile_cache()

from opendlv_perception_vision_orbslam2_jax.models import slam as slam_mod
from opendlv_perception_vision_orbslam2_jax.models import local_mapping as lm
from opendlv_perception_vision_orbslam2_jax.optim.ba_grid import bundle_adjust_grid
from opendlv_perception_vision_orbslam2_jax.utils import synthetic
from opendlv_perception_vision_orbslam2_jax.utils.config import SystemConfig

cfg = SystemConfig()
print("backend:", jax.default_backend(), flush=True)
n = 12
lefts, rights, gt, _ = synthetic.render_stereo_sequence(
    cfg, n_frames=n, n_points=1200, seed=1, step=0.6
)
slam = slam_mod.StereoSlam(cfg, enable_loop_closing=False,
                           enable_relocalization=False)
for i in range(n):
    slam.process(jax.device_put(np.asarray(lefts[i])),
                 jax.device_put(np.asarray(rights[i])), timestamp=i / 15.0)
slam.finish()
m = slam.map
cam = cfg.camera
ext = lm.extract_local_ba_grid(m, slam.last_kf_slot, 8, 8, 4096, 1.2)
jax.block_until_ready(ext.prob.g_uv)


def bench(name, fn, reps=6):
    out = fn()
    jax.block_until_ready(jax.tree.leaves(out)[0])
    t0 = time.time()
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(jax.tree.leaves(out)[0])
    print(f"{name:<40}{(time.time()-t0)/reps*1e3:8.1f} ms", flush=True)


bench("extract_local_ba_grid",
      lambda: lm.extract_local_ba_grid(m, slam.last_kf_slot, 8, 8, 4096, 1.2))
for it in ((5, 10), (2, 3), (1, 1)):
    bench(f"bundle_adjust_grid{it}",
          lambda it=it: bundle_adjust_grid(
              ext.prob, fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
              bf=cam.bf, iters_first=it[0], iters_second=it[1]))

# isolated small solve cost
S = jnp.eye(48) * 3.0 + 0.01 * jax.random.normal(jax.random.PRNGKey(0), (48, 48))
rhs = jnp.ones((48,))


@jax.jit
def solve15(S, rhs):
    def body(c, _):
        x = jnp.linalg.solve(S + c * 1e-9 * jnp.eye(48), rhs)
        return jnp.sum(x), None
    c, _ = jax.lax.scan(body, 1.0, None, length=15)
    return c


bench("15x linalg.solve(48x48)", lambda: solve15(S, rhs))

# isolated gather+einsum pass (one iteration's landmark math)
KW, F = ext.prob.g_pt.shape
PL = ext.prob.pts.shape[0]
Jp = jnp.ones((KW, F, 3, 6))
Jl = jnp.ones((KW, F, 3, 3))
r = jnp.ones((KW, F, 3))
obs_f = jnp.clip(ext.prob.obs_table, 0, F - 1)
w_iota = jnp.arange(KW)


@jax.jit
def landmark_pass(Jp, Jl, r):
    def body(c, _):
        Jl_t = Jl[w_iota[None, :], obs_f]
        Jp_t = Jp[w_iota[None, :], obs_f]
        r_t = r[w_iota[None, :], obs_f]
        Hll = jnp.einsum("pwri,pwrj->pij", Jl_t, Jl_t)
        Hpl = jnp.einsum("pwri,pwrj->pwij", Jp_t, Jl_t)[:, :8]
        A = jnp.einsum("pkij,pjl->pkil", Hpl, Hll)
        S_off = jnp.einsum("pkil,pqml->kiqm", A, Hpl)
        return c + jnp.sum(S_off) + jnp.sum(r_t), None
    c, _ = jax.lax.scan(body, 0.0, None, length=15)
    return c


bench("15x landmark gather+einsums", lambda: landmark_pass(Jp, Jl, r))


@jax.jit
def grid_terms_pass():
    from opendlv_perception_vision_orbslam2_jax.optim.ba_grid import _grid_terms
    def body(c, _):
        r, Jp, Jl, st, bh = _grid_terms(
            ext.prob.T_all, ext.prob.pts, ext.prob,
            cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)
        return c + jnp.sum(r) + jnp.sum(Jp) + jnp.sum(Jl), None
    c, _ = jax.lax.scan(body, 0.0, None, length=15)
    return c


bench("15x _grid_terms", lambda: grid_terms_pass())
