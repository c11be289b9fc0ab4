"""Multi-device bundle adjustment: observation-sharded Schur-CG LM.

The P8 parallelism SURVEY.md calls for: BA edges shard across the device
mesh; poses and landmark state replicate; every edge reduction (gradient
blocks, landmark Hessians, the W/W^T products inside CG) ends in ONE
``psum`` over the mesh (NVLink, all to all, on one host of GPUs).
Implementation-wise this is just optim/gba.py's ``gba_core`` with
``reduce_fn = psum`` running under ``shard_map`` — the math is identical on
one device and on many.

Scaling shape: per CG iteration each device does O(E/D) small einsums and
participates in two psums of [Ko,6]/[P,3] — KB-MB per reduction,
compute-bound until E/D gets tiny.  Multi-host: the same program with the
mesh spanning hosts (jax.distributed); the network only sees the psums.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..optim.ba import BAProblem
from ..optim.gba import gba_core

EDGE_FIELDS = ("e_kf", "e_pt", "e_uv", "e_ur", "e_sigma2", "e_valid")


def pad_edges_to_multiple(prob: BAProblem, n_shards: int) -> BAProblem:
    e = prob.e_kf.shape[0]
    rem = (-e) % n_shards
    if rem == 0:
        return prob
    pad = lambda a, fill=0: jnp.concatenate(
        [a, jnp.full((rem,) + a.shape[1:], fill, a.dtype)], axis=0
    )
    return prob._replace(
        e_kf=pad(prob.e_kf),
        e_pt=pad(prob.e_pt),
        e_uv=pad(prob.e_uv),
        e_ur=pad(prob.e_ur, -1),
        e_sigma2=pad(prob.e_sigma2, 1),
        e_valid=pad(prob.e_valid, False),
    )


def shard_problem(prob: BAProblem, mesh: Mesh, axis: str) -> BAProblem:
    """Place edge arrays sharded over ``axis``, the rest replicated."""
    edge_sharding = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())
    out = {}
    for name in BAProblem._fields:
        arr = getattr(prob, name)
        s = edge_sharding if name in EDGE_FIELDS else rep
        out[name] = jax.device_put(arr, s)
    return BAProblem(**out)


def make_sharded_gba(mesh: Mesh, axis: str, *, fx, fy, cx, cy, bf,
                     n_outer: int = 8, cg_iters: int = 30,
                     fix_first_pose: bool = True):
    """Build the jitted edge-sharded global bundle adjuster."""
    in_specs = BAProblem(
        T_opt=P(), opt_valid=P(), T_fix=P(), fix_valid=P(),
        pts=P(), pt_valid=P(),
        e_kf=P(axis), e_pt=P(axis), e_uv=P(axis), e_ur=P(axis),
        e_sigma2=P(axis), e_valid=P(axis),
    )

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(in_specs,),
        out_specs=(P(), P(), P()), check_vma=False,
    )
    def _run(prob_shard: BAProblem):
        return gba_core(
            prob_shard, fx=fx, fy=fy, cx=cx, cy=cy, bf=bf,
            n_outer=n_outer, cg_iters=cg_iters,
            fix_first_pose=fix_first_pose,
            reduce_fn=lambda x: jax.lax.psum(x, axis),
        )

    return jax.jit(_run)


def make_sharded_gba_chunk(mesh: Mesh, axis: str, *, fx, fy, cx, cy, bf,
                           n_outer: int = 1, cg_iters: int = 40,
                           fix_first_pose: bool = True):
    """Chunked variant for the production IncrementalGBA: runs ``n_outer``
    LM iterations from an explicit ``(T, pts, lam, cost)`` carry with edges
    sharded over ``axis`` — the between-frames slice of the post-loop global
    BA (the g2o solve role, reference: src/orboptimizer.cpp:463-798) on a
    multi-chip mesh.  Carry replicates; each reduction is one psum."""
    in_specs = BAProblem(
        T_opt=P(), opt_valid=P(), T_fix=P(), fix_valid=P(),
        pts=P(), pt_valid=P(),
        e_kf=P(axis), e_pt=P(axis), e_uv=P(axis), e_ur=P(axis),
        e_sigma2=P(axis), e_valid=P(axis),
    )
    carry_specs = (P(), P(), P(), P())

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(in_specs, carry_specs),
        out_specs=carry_specs, check_vma=False,
    )
    def _chunk(prob_shard: BAProblem, carry):
        return gba_core(
            prob_shard, fx=fx, fy=fy, cx=cx, cy=cy, bf=bf,
            n_outer=n_outer, cg_iters=cg_iters,
            fix_first_pose=fix_first_pose,
            reduce_fn=lambda x: jax.lax.psum(x, axis),
            init_carry=carry, return_carry=True,
        )

    return jax.jit(_chunk)
