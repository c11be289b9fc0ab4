"""Binary-search the grid-LBA normal-equation cost einsum group by group."""
import time
import numpy as np
import jax
import jax.numpy as jnp

from opendlv_perception_vision_orbslam2_jax.utils.compile_cache import (  # noqa: E402
    enable_compile_cache,
)

enable_compile_cache()

from opendlv_perception_vision_orbslam2_jax.optim.ba_grid import (
    _obs_terms, GridBAProblem, _grid_chi2, CHI2_MONO, CHI2_STEREO)
from opendlv_perception_vision_orbslam2_jax.optim.ba import _inv3x3

print("backend:", jax.default_backend(), flush=True)

PL, KW, KO, F = 4096, 16, 8, 2048
key = jax.random.PRNGKey(0)
T_all = jnp.tile(jnp.eye(4, dtype=jnp.float32), (KW, 1, 1))
T_all = T_all.at[:, :3, 3].set(0.1 * jax.random.normal(key, (KW, 3)))
pts = jax.random.normal(key, (PL, 3)) * 5.0 + jnp.array([0., 0., 20.])
o_uv = jax.random.normal(key, (PL, KW, 2)) * 100 + 300
o_ur = jnp.abs(jax.random.normal(key, (PL, KW))) * 100
o_sigma2 = jnp.ones((PL, KW))
o_valid = jnp.ones((PL, KW), bool)
prob = GridBAProblem(
    T_all=T_all, kf_valid=jnp.ones((KW,), bool),
    pose_free=jnp.ones((KO,), bool).at[0].set(False),
    pts=pts, pt_valid=jnp.ones((PL,), bool),
    g_pt=jnp.zeros((KW, F), jnp.int32), g_uv=jnp.zeros((KW, F, 2)),
    g_ur=jnp.zeros((KW, F)), g_sigma2=jnp.ones((KW, F)),
    g_valid=jnp.zeros((KW, F), bool),
    obs_table=jnp.zeros((PL, KW), jnp.int32),
    o_uv=o_uv, o_ur=o_ur, o_sigma2=o_sigma2, o_valid=o_valid,
)
fx = fy = 718.0
cx, cy, bf = 607.0, 185.0, 386.0
free_row = jnp.ones((KW,)).at[KO:].set(0.0)


def bench(name, fn, reps=8):
    out = fn()
    jax.block_until_ready(jax.tree.leaves(out)[0])
    t0 = time.time()
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(jax.tree.leaves(out)[0])
    print(f"{name:<46}{(time.time()-t0)/reps*1e3:8.2f} ms", flush=True)


def make(level):
    @jax.jit
    def run():
        def body(c, _):
            r, Jp_t, Jl_t, st, bh = _obs_terms(
                T_all, pts + c, prob, fx, fy, cx, cy, bf)
            acc = 1e-9 * jnp.sum(r)
            w = jnp.where(o_valid, 1.0 / o_sigma2, 0.0)
            w_t = jnp.stack([jnp.ones_like(w), jnp.ones_like(w),
                             jnp.where(st, 1.0, 0.0)], -1) * w[..., None]
            if level >= 1:  # pose blocks
                w_free = w_t * free_row[None, :, None]
                wJp_t = Jp_t * w_free[..., None]
                Hpp = jnp.einsum("pwri,pwrj->wij", wJp_t, Jp_t)[:KO]
                b_p = -jnp.einsum("pwri,pwr->wi", wJp_t, r)[:KO]
                acc += 1e-9 * (jnp.sum(Hpp) + jnp.sum(b_p))
            if level >= 2:  # landmark blocks
                wJl = Jl_t * w_t[..., None]
                Hll = jnp.einsum("pwri,pwrj->pij", wJl, Jl_t)
                b_l = -jnp.einsum("pwri,pwr->pi", wJl, r)
                acc += 1e-9 * (jnp.sum(Hll) + jnp.sum(b_l))
            if level >= 3:  # coupling
                Hpl = jnp.einsum("pwri,pwrj->pwij", wJp_t, Jl_t)[:, :KO]
                acc += 1e-9 * jnp.sum(Hpl)
            if level >= 4:  # schur products
                Hll_inv = _inv3x3(Hll + 1e-2 * jnp.eye(3)[None])
                A = jnp.einsum("pkij,pjl->pkil", Hpl, Hll_inv)
                S_off = jnp.einsum("pkil,pqml->kiqm", A, Hpl)
                acc += 1e-9 * jnp.sum(S_off)
            if level >= 5:  # robust_cost second eval
                r2, _, _, st2, bh2 = _obs_terms(
                    T_all, pts + c + 1e-6, prob, fx, fy, cx, cy, bf)
                chi2 = _grid_chi2(r2, prob.o_sigma2, st2)
                d2 = jnp.where(st2, CHI2_STEREO, CHI2_MONO)
                cost = jnp.where(chi2 <= d2, chi2,
                                 2.0 * jnp.sqrt(d2 * chi2) - d2)
                acc += 1e-9 * jnp.sum(cost)
            return c + acc, None
        c, _ = jax.lax.scan(body, 0.0, None, length=15)
        return c
    return run


for lv, name in ((0, "terms only"), (1, "+Hpp/b_p"), (2, "+Hll/b_l"),
                 (3, "+Hpl"), (4, "+Schur A/S_off"), (5, "+cost re-eval")):
    bench(f"15x level {lv}: {name}", make(lv))


# ---------------------------------------------------------------------------
# level 7: fully scalarized iteration — component arrays [KW, PL] only
# ---------------------------------------------------------------------------

def make_scalarized():
    o_uT = o_uv[..., 0].T          # [KW, PL]
    o_vT = o_uv[..., 1].T
    o_qT = o_ur.T
    wT = jnp.where(o_valid.T, 1.0 / o_sigma2.T, 0.0)

    @jax.jit
    def run():
        def body(c, _):
            pts_c = pts + c
            R = T_all[:, :3, :3]
            t = T_all[:, :3, 3]
            pc = jnp.einsum("wij,pj->wip", R, pts_c) + t[:, :, None]
            x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]       # [KW, PL]
            iz = 1.0 / jnp.where(z > 1e-6, z, 1e-6)
            iz2 = iz * iz
            u_hat = fx * x * iz + cx
            v_hat = fy * y * iz + cy
            q_hat = u_hat - bf * iz
            st = o_qT >= 0
            r_u = o_uT - u_hat
            r_v = o_vT - v_hat
            r_q = jnp.where(st, o_qT - q_hat, 0.0)
            w_u = wT
            w_v = wT
            w_q = jnp.where(st, wT, 0.0)

            # J_pose rows as 6 component arrays each
            Ju = [-fx * iz, jnp.zeros_like(z), fx * x * iz2,
                  fx * x * y * iz2, -fx * (1.0 + x * x * iz2), fx * y * iz]
            Jv = [jnp.zeros_like(z), -fy * iz, fy * y * iz2,
                  fy * (1.0 + y * y * iz2), -fy * x * y * iz2, -fy * x * iz]
            Jq = [Ju[0], Ju[1], Ju[2] - bf * iz2,
                  Ju[3] - bf * iz2 * y, Ju[4] + bf * iz2 * x, Ju[5]]
            # J_pt rows: jl[r][l] = -(d_pix[r] . R[:, l])
            du = [fx * iz, jnp.zeros_like(z), -fx * x * iz2]
            dv = [jnp.zeros_like(z), fy * iz, -fy * y * iz2]
            dq = [du[0], du[1], du[2] + bf * iz2]
            Rl = [[R[:, c0, l][:, None] for l in range(3)] for c0 in range(3)]
            Jl_u = [-(du[0] * Rl[0][l] + du[1] * Rl[1][l] + du[2] * Rl[2][l])
                    for l in range(3)]
            Jl_v = [-(dv[0] * Rl[0][l] + dv[1] * Rl[1][l] + dv[2] * Rl[2][l])
                    for l in range(3)]
            Jl_q = [-(dq[0] * Rl[0][l] + dq[1] * Rl[1][l] + dq[2] * Rl[2][l])
                    for l in range(3)]
            rows = ((w_u, Ju, r_u, Jl_u), (w_v, Jv, r_v, Jl_v),
                    (w_q, Jq, r_q, Jl_q))

            # Hpp [KW, 6, 6] + b_p [KW, 6]
            Hpp = jnp.stack([jnp.stack([
                sum(jnp.sum(wr * Jr[i] * Jr[j], axis=-1)
                    for (wr, Jr, rr, _) in rows)
                for j in range(6)], -1) for i in range(6)], -2)
            b_p = jnp.stack([
                -sum(jnp.sum(wr * Jr[i] * rr, axis=-1)
                     for (wr, Jr, rr, _) in rows)
                for i in range(6)], -1)

            # Hll entries [PL] (sum over w), b_l [3][PL]
            Hll = [[sum(jnp.sum(wr * Jlr[a] * Jlr[b], axis=0)
                        for (wr, _, _, Jlr) in rows)
                    for b in range(3)] for a in range(3)]
            b_l = [-sum(jnp.sum(wr * Jlr[a] * rr, axis=0)
                        for (wr, _, rr, Jlr) in rows) for a in range(3)]

            # Hpl[i][l] : [KO, PL]
            Hpl = [[sum((wr * Jr[i] * Jlr[l])[:KO]
                        for (wr, Jr, _, Jlr) in rows)
                    for l in range(3)] for i in range(6)]

            # Hll^-1 entries [PL] (3x3 analytic inverse)
            a00, a01, a02 = Hll[0][0] + 1e-2, Hll[0][1], Hll[0][2]
            a11, a12, a22 = Hll[1][1] + 1e-2, Hll[1][2], Hll[2][2] + 1e-2
            c00 = a11 * a22 - a12 * a12
            c01 = a02 * a12 - a01 * a22
            c02 = a01 * a12 - a02 * a11
            c11 = a00 * a22 - a02 * a02
            c12 = a01 * a02 - a00 * a12
            c22 = a00 * a11 - a01 * a01
            det = a00 * c00 + a01 * c01 + a02 * c02
            idet = 1.0 / jnp.where(jnp.abs(det) > 1e-12, det, 1e-12)
            Hinv = [[c00 * idet, c01 * idet, c02 * idet],
                    [c01 * idet, c11 * idet, c12 * idet],
                    [c02 * idet, c12 * idet, c22 * idet]]

            # A[i][l] = sum_j Hpl[i][j] * Hinv[j][l]  : [KO, PL]
            A = [[sum(Hpl[i][j] * Hinv[j][l][None, :] for j in range(3))
                  for l in range(3)] for i in range(6)]

            # S_off[k,i,q,m] = sum_{p,l} A[i][l][k,p] * Hpl[m][l][q,p]
            # stack per l: [6*KO, PL] @ [PL, 6*KO]
            S = 0.0
            for l in range(3):
                Al = jnp.concatenate([A[i][l] for i in range(6)], 0)   # [48,PL]
                Hl = jnp.concatenate([Hpl[m][l] for m in range(6)], 0)
                S = S + Al @ Hl.T                                      # [48,48]
            # rhs
            rhs = (b_p[:KO].T.reshape(-1)
                   - jnp.stack([jnp.sum(
                       sum(A[i][l] * b_l[l][None, :] for l in range(3)),
                       axis=-1) for i in range(6)], 0).reshape(-1))
            Hpp_flat = jax.scipy.linalg.block_diag(
                *[Hpp[k] for k in range(KO)])
            Sfull = Hpp_flat - S
            dx = jnp.linalg.solve(Sfull + 1e-6 * jnp.eye(6 * KO), rhs)
            dx6 = dx.reshape(6, KO, order="F")  # [6, KO] col-major per KF

            # back-substitute: Wt_dx[l][p] = sum_{k,i} Hpl[i][l][k,p]*dx[i,k]
            Wt = [sum(jnp.sum(Hpl[i][l] * dx6[i][:, None], axis=0)
                      for i in range(6)) for l in range(3)]
            dxl = [sum(Hinv[l][j] * (b_l[j] - Wt[j]) for j in range(3))
                   for l in range(3)]
            return c + 1e-9 * (jnp.sum(dx) + sum(jnp.sum(d) for d in dxl)), None
        c, _ = jax.lax.scan(body, 0.0, None, length=15)
        return c
    return run


bench("15x level 7: scalarized full iteration", make_scalarized())
