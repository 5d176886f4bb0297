"""shard_map spatial domain decomposition of the projection step.

The load-bearing multi-chip parallelism (SURVEY.md section 2.3): the grid is
tiled over a 2D device mesh; each device owns an interior block and a 1-cell
ghost ring refreshed by `lax.ppermute` halo exchange (parallel.halo) before
every stencil pass and every red-black half-sweep; the Poisson tolerance
check and the flow statistics are `pmax`/`psum` collectives. One jitted SPMD
program per time step.

Layout: sharded state uses INTERIOR-shaped (ny, nx) global arrays (clean
divisibility by the mesh), not the padded single-device layout; the ghost
ring is reconstructed locally per device. Halo order is y-then-x: the x
exchange ships full columns including just-filled y-ghost entries, which
populates the diagonal ghost corners the MAC predictor reads (v[j-1,i+1],
u[j+1,i-1]) without any explicit corner messages.

Scope: the cavity flavor. Alongside this explicit path, `gspmd_step` wraps ANY case's
single-device step with sharding annotations and lets XLA's SPMD partitioner
insert the halo collectives automatically — the general path for the other
cases and the multigrid solver.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

try:  # jax >= 0.4.35 exposes shard_map at top level
    from jax import shard_map

    def _shard_map(f, mesh, in_specs, out_specs):
        return shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs)
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map as _esm

    def _shard_map(f, mesh, in_specs, out_specs):
        return _esm(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs)

from cfd_tpu.grid import Grid, optimal_omega
from cfd_tpu.parallel.halo import exchange_halos, global_max, global_sum, pad_local
from cfd_tpu.parallel.mesh import grid_sharding
from cfd_tpu.ops.stencil import StencilCoeffs, predictor, pressure_correction
from cfd_tpu.ops.stencil import _sh


class ShardedCavity:
    """Explicit shard_map cavity solver over a ("dy", "dx") mesh.

    Two Poisson flavors share the projection machinery:

    * ``poisson="sor"`` — cold-start red-black SOR with halo exchange per
      half-sweep (the reference behavior, cavity-01.cpp:609-690).
    * ``poisson="multigrid"`` — the explicit sharded V-cycle
      (parallel.mg_sharded: per-level halo exchange, local transfers,
      replicated coarse tail) with the extrapolated warm start used by the
      flagship single-device benchmark config; state gains a ``p_prev``
      block (step/initial_state take and return 4 field arrays).
    """

    def __init__(self, case, mesh, tol_factor: float = 1e-9,
                 max_iters: int = 10000, check_every: int = 1,
                 lid_velocity: float = 1.0, poisson: str = "sor"):
        grid: Grid = case.grid
        ny, nx = grid.ny, grid.nx
        mdy, mdx = mesh.shape["dy"], mesh.shape["dx"]
        if ny % mdy or nx % mdx:
            raise ValueError(f"grid {ny}x{nx} not divisible by mesh {mdy}x{mdx}")
        if poisson not in ("sor", "multigrid"):
            raise ValueError(f"unknown poisson flavor: {poisson}")
        self.case = case
        self.mesh = mesh
        self.grid = grid
        self.poisson = poisson
        c: StencilCoeffs = case.coeffs
        sharding = grid_sharding(mesh)
        dtype = case.dtype

        # global interior-shaped constants, sharded like the fields
        jj = np.arange(1, ny + 1)[:, None]
        ii = np.arange(1, nx + 1)[None, :]
        full = lambda a: np.ascontiguousarray(np.broadcast_to(a, (ny, nx)))
        consts = {
            "eps_e": full(ii < nx).astype(np.float64),
            "eps_w": full(ii > 1).astype(np.float64),
            "eps_n": full(jj < ny).astype(np.float64),
            "eps_s": np.ones((ny, nx)),  # reference quirk (cavity-01.cpp:647)
            "red": full((ii + jj) % 2 == 0),
            "u_valid": full(ii <= nx - 1),
            "v_valid": full(jj <= ny - 1),
        }
        self._consts = {
            k: jax.device_put(jnp.asarray(v if v.dtype == bool else v.astype(dtype)),
                              sharding)
            for k, v in consts.items()
        }
        self.sharding = sharding

        omega = optimal_omega(nx)
        h2 = grid.dx * grid.dy
        lid = lid_velocity

        def local_bc(u, v, jy, jx, mdy=mdy, mdx=mdx):
            """Cavity ghost BCs (cavity-01.cpp:523-543) on local padded
            blocks, applied only on devices touching that wall."""
            top = 2.0 * lid - u[-2, :]
            u = u.at[-1, :].set(jnp.where(jy == mdy - 1, top, u[-1, :]))
            u = u.at[0, :].set(jnp.where(jy == 0, -u[1, :], u[0, :]))
            v = v.at[:, -1].set(jnp.where(jx == mdx - 1, -v[:, -2], v[:, -1]))
            v = v.at[:, 0].set(jnp.where(jx == 0, -v[:, 1], v[:, 0]))
            return u, v

        def fill(f):
            """pad + halo-exchange a local interior block."""
            return exchange_halos(pad_local(f))

        ih2 = 1.0 / h2

        def pre_poisson(u, v, u_valid, v_valid, jy, jx):
            """BC + predictor + Poisson source on local padded blocks
            (cavity step ordering, cavity-01.cpp:387-390)."""
            uP = fill(u)
            vP = fill(v)
            uP, vP = local_bc(uP, vP, jy, jx)
            u_val = pad_local(u_valid)
            v_val = pad_local(v_valid)
            us, vs = predictor(uP, vP, c, u_val, v_val)
            # faces in the halo ring were computed from stale data; refresh
            us = exchange_halos(us)
            vs = exchange_halos(vs)
            us, vs = local_bc(us, vs, jy, jx)

            # Poisson source b = rho/dt * div(u*)
            bP = (c.density / c.dt) * (
                (us - _sh(us, 0, -1)) * c.idx + (vs - _sh(vs, -1, 0)) * c.idy)
            interior = pad_local(jnp.ones_like(u, dtype=bool))
            b = jnp.where(interior, bP, jnp.zeros_like(bP))
            return uP, vP, us, vs, u_val, v_val, interior, b

        def post_poisson(us, vs, pP, uP, vP, u_val, v_val, interior):
            """Projection + pmax/psum statistics collectives."""
            u2, v2 = pressure_correction(us, vs, pP, c, u_val, v_val,
                                         u_else=uP, v_else=vP, cavity_form=True)
            div = (u2 - _sh(u2, 0, -1)) * c.idx + (v2 - _sh(v2, -1, 0)) * c.idy
            max_div = global_max(jnp.max(jnp.abs(jnp.where(interior, div, jnp.zeros_like(div)))))
            uc = 0.5 * (_sh(u2, 0, -1) + u2)
            vc = 0.5 * (_sh(v2, -1, 0) + v2)
            ke = 0.5 * global_sum(jnp.sum(jnp.where(interior, uc * uc + vc * vc, 0.0)))
            return u2, v2, max_div, ke

        def body(u, v, p, eps_e, eps_w, eps_n, eps_s, red, u_valid, v_valid):
            jy = jax.lax.axis_index("dy")
            jx = jax.lax.axis_index("dx")
            uP, vP, us, vs, u_val, v_val, interior, b = pre_poisson(
                u, v, u_valid, v_valid, jy, jx)

            eE, eW = pad_local(eps_e), pad_local(eps_w)
            eN, eS = pad_local(eps_n), pad_local(eps_s)
            ncount = eE + eW + eN + eS
            inv_n = jnp.where(interior, 1.0 / jnp.where(ncount > 0, ncount, 1.0), 0.0)
            red_m = pad_local(red) & interior
            black_m = pad_local(~red) & interior

            tol = tol_factor * global_max(jnp.max(jnp.abs(b)))

            def half(pP, mask):
                gs = (eE * _sh(pP, 0, 1) + eW * _sh(pP, 0, -1)
                      + eN * _sh(pP, 1, 0) + eS * _sh(pP, -1, 0) - b * h2) * inv_n
                upd = (1.0 - omega) * pP + omega * gs
                return jnp.where(mask, upd.astype(pP.dtype), pP)

            def residual(pP):
                r = ih2 * (eE * (_sh(pP, 0, 1) - pP) + eW * (_sh(pP, 0, -1) - pP)
                           + eN * (_sh(pP, 1, 0) - pP) + eS * (_sh(pP, -1, 0) - pP)) - b
                return global_max(jnp.max(jnp.abs(jnp.where(interior, r, jnp.zeros_like(r)))))

            def cond(carry):
                _, res, it = carry
                return (res > tol) & (it < max_iters)

            def sweep_body(carry):
                pP, _, it = carry

                def one(_, pP):
                    pP = exchange_halos(pP)
                    pP = half(pP, red_m)
                    pP = exchange_halos(pP)
                    return half(pP, black_m)

                pP = jax.lax.fori_loop(0, check_every, one, pP)
                pP = exchange_halos(pP)
                return pP, residual(pP), it + check_every

            p0 = pad_local(jnp.zeros_like(p))  # cold start (cavity-01.cpp:610)
            init = (p0, tol + jnp.asarray(1.0, b.dtype), jnp.asarray(0, jnp.int32))
            pP, res, iters = jax.lax.while_loop(cond, sweep_body, init)

            u2, v2, max_div, ke = post_poisson(us, vs, pP, uP, vP,
                                               u_val, v_val, interior)
            strip = lambda f: f[1:-1, 1:-1]
            return (strip(u2), strip(v2), strip(pP), iters, res, max_div,
                    ke / (nx * ny))

        spec = P("dy", "dx")
        scalar = P()
        if poisson == "multigrid":
            from cfd_tpu.parallel.mg_sharded import make_local_mg_solve
            from cfd_tpu.poisson.multigrid import MGConfig, cavity_problem

            # the case's own V-cycle (sweeps, cycle cap) at this tolerance
            mg_cfg = dataclasses.replace(case.info.get("mg") or MGConfig(),
                                         tol_factor=tol_factor, abs_tol=0.0)
            mg_solve = make_local_mg_solve(
                cavity_problem(nx, ny, grid.dx, grid.dy), mg_cfg,
                (mdy, mdx), dtype)

            def body_mg(u, v, p, p_prev, u_valid, v_valid):
                jy = jax.lax.axis_index("dy")
                jx = jax.lax.axis_index("dx")
                uP, vP, us, vs, u_val, v_val, interior, b = pre_poisson(
                    u, v, u_valid, v_valid, jy, jx)
                # extrapolated warm start (the flagship single-device config)
                guess = pad_local(2.0 * p - p_prev)
                pP, iters, res = mg_solve(guess, b, jy, jx)
                u2, v2, max_div, ke = post_poisson(us, vs, pP, uP, vP,
                                                   u_val, v_val, interior)
                strip = lambda f: f[1:-1, 1:-1]
                return (strip(u2), strip(v2), strip(pP), p, iters, res,
                        max_div, ke / (nx * ny))

            self._step = jax.jit(_shard_map(
                body_mg, mesh,
                in_specs=(spec,) * 6,
                out_specs=(spec, spec, spec, spec, scalar, scalar, scalar, scalar),
            ))
        else:
            self._step = jax.jit(_shard_map(
                body, mesh,
                in_specs=(spec,) * 10,
                out_specs=(spec, spec, spec, scalar, scalar, scalar, scalar),
            ))

    def initial_state(self):
        z = jnp.zeros((self.grid.ny, self.grid.nx), dtype=self.case.dtype)
        put = partial(jax.device_put, device=self.sharding)
        if self.poisson == "multigrid":
            return put(z), put(z), put(z), put(z)
        return put(z), put(z), put(z)

    def step(self, u, v, p, p_prev=None):
        """One projection step; returns (u, v, p[, p_prev], diagnostics dict).

        The multigrid flavor carries ``p_prev`` for the extrapolated warm
        start; the SOR flavor keeps the reference's 3-field state."""
        c = self._consts
        if self.poisson == "multigrid":
            if p_prev is None:
                raise ValueError("multigrid flavor needs p_prev (warm start)")
            u2, v2, p2, pprev2, iters, res, max_div, avg_ke = self._step(
                u, v, p, p_prev, c["u_valid"], c["v_valid"])
            return u2, v2, p2, pprev2, {
                "poisson_iters": iters, "poisson_residual": res,
                "max_divergence": max_div, "avg_kinetic_energy": avg_ke,
            }
        u2, v2, p2, iters, res, max_div, avg_ke = self._step(
            u, v, p, c["eps_e"], c["eps_w"], c["eps_n"], c["eps_s"],
            c["red"], c["u_valid"], c["v_valid"])
        return u2, v2, p2, {
            "poisson_iters": iters, "poisson_residual": res,
            "max_divergence": max_div, "avg_kinetic_energy": avg_ke,
        }


def state_sharding(mesh) -> NamedSharding:
    """Sharding of padded (ny+2, nx+2) state fields over a ("dy", "dx")
    mesh. The padded sizes need not divide the mesh: XLA pads the last
    shard."""
    return NamedSharding(mesh, P("dy", "dx"))


def _constrain(state, sharding):
    return jax.tree.map(
        lambda x: jax.lax.with_sharding_constraint(x, sharding), state)


def shard_state(state, mesh):
    """The state laid out as shard_step's output is. A jitted constraint,
    not device_put: where the padded rows do not divide the mesh, JAX holds
    no uneven shards and XLA returns the nearest even layout (fewer shards,
    replicated); the step's own constraint reshards inside the program."""
    return jax.jit(partial(_constrain, sharding=state_sharding(mesh)))(state)


def shard_step(step, mesh):
    """Wrap a single-device step(state) -> (state, diag) so that XLA's SPMD
    partitioner (GSPMD) runs it over ``mesh``: the state is constrained to
    row/column shards on entry and exit, and XLA inserts the halo
    exchanges and reductions. Not jitted, so it can sit inside a scan."""
    constrain = partial(_constrain, sharding=state_sharding(mesh))

    def sharded(state):
        new, diag = step(constrain(state))
        return constrain(new), diag

    return sharded


def gspmd_step(case, mesh):
    """General path: jit ANY case's single-device step with sharding
    annotations on the padded arrays and let XLA's SPMD partitioner insert
    halo exchanges/reductions. Works for every case (including multigrid
    Poisson, whose restriction/prolongation XLA also partitions)."""
    from cfd_tpu.solver import make_step

    return jax.jit(shard_step(make_step(case), mesh))
