"""Adaptive time stepping (Courant-limited), the reference's documented
OpenFOAM workflow knob (`adjustTimeStep yes; maxCo 0.7`, README.md:112-114)
brought to the solver cases.

dt enters the jitted step as a TRACED scalar (solver.make_dt_step), so
changing it never recompiles (the same trick the vmapped ensembles use for
per-member viscosity). The controller

    dt_next = dt * min(growth, max_co / Co_n)

with the Courant number Co = dt * max(|u|/dx + |v|/dy) runs host-side
between dispatches, or on the device inside a scan of steps.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from cfd_tpu.solver import make_dt_step
from cfd_tpu.state import State


def make_adaptive_step(case) -> Callable:
    """step(state, dt) -> (state, diag, courant_per_dt) with dt traced, for
    every case (built-in orderings and custom steps alike)."""
    c0 = case.coeffs
    step_dt = make_dt_step(case)

    def step(state: State, dt):
        new, diag = step_dt(state, dt)
        return new, diag, courant_per_dt(new, c0)

    return step


def courant_per_dt(state: State, coeffs) -> jnp.ndarray:
    """Co/dt = max over faces of |u|/dx + |v|/dy (conservative bound)."""
    return (jnp.max(jnp.abs(state.u)) / coeffs.dx
            + jnp.max(jnp.abs(state.v)) / coeffs.dy)


def run_adaptive(sim, max_courant: float = 0.7, n_steps: int | None = None,
                 final_time: float | None = None, dt0: float | None = None,
                 growth: float = 1.2, state: State | None = None,
                 log=None, steps_per_call: int = 1,
                 controller: str = "exact"):
    """Advance with Courant-limited dt until ``n_steps`` or ``final_time``.

    The diffusive stability bound from the case's construction-time dt rule
    is kept as a hard ceiling (explicit diffusion does not relax as the flow
    slows). Returns (state, history rows).

    ``steps_per_call`` > 1 runs the CONTROLLER ON DEVICE: dt is a traced
    scan-carry scalar and the Courant feedback (dt' = min(dt*min(growth,
    max_co/Co), ceiling)) updates inside one jitted lax.scan of N steps —
    no host sync per step, so adaptive throughput approaches the fixed-dt
    scan-chunked rate. The controller arithmetic then runs in the case
    dtype instead of host float64, so the dt sequence matches the host loop
    to roundoff, not bitwise.

    ``controller``:

    * "exact" (default) — the Courant number of the state a step just
      produced sets the very next dt.
    * "lagged" — the feedback is one step stale: the Courant number of the
      step before sets the dt of the step after this one. This is
      OpenFOAM's adjustTimeStep semantics (CoNum of the last completed step
      sets the next dt, reference README.md:112-114); growth-limiting
      bounds the transient overshoot of a stale step to the ``growth``
      factor. Always runs on device, ``steps_per_call`` steps per chunk.

    Checkpoint/resume: when ``sim.checkpointer`` is set, the controller's
    full dynamical state (State, step, dt, t — and for "lagged" the dt that
    produced the state) is checkpointed as npz extras and resumed from
    exactly (bitwise-identical continuation for the host-loop path).

    Runs on one device: adaptive dt over a mesh is not supported yet.
    """
    case = sim.case
    log = log if log is not None else sim.log
    if controller not in ("exact", "lagged"):
        raise ValueError(f"unknown controller: {controller!r}")
    if sim.mesh is not None:
        raise ValueError("adaptive dt is not supported on a device mesh yet: "
                         "run it on one device")
    step_impl = make_adaptive_step(case)
    dt = float(dt0 if dt0 is not None else case.dt)
    dt_used = dt  # lagged: the dt that produced the current state
    t = 0.0
    k = 0
    if state is None:
        resumed = None
        if sim.checkpointer is not None:
            resumed, k0, extras = sim.checkpointer.restore_latest(
                case, with_extras=True)
        if resumed is not None and "dt" in extras:
            state, k = resumed, k0
            dt, t = extras["dt"], extras["t"]
            dt_used = extras.get("dt_used", dt)
            log(f"resumed adaptive run at step {k} (t={t:.6g}, dt={dt:.6e})")
        else:
            state = sim.initial_state()
    diffusivity = (case.adaptive_diffusivity
                   if case.adaptive_diffusivity is not None
                   else case.coeffs.viscosity)
    dt_ceiling_diffusive = 0.25 * min(case.coeffs.dx, case.coeffs.dy) ** 2 \
        / max(diffusivity, 1e-300)
    rows = []

    if controller == "lagged":
        spc = max(1, steps_per_call)
        if case.print_interval % spc:
            raise ValueError(f"steps_per_call={spc} must divide "
                             f"the print interval ({case.print_interval})")
        ckpt_iv = sim.checkpointer.interval if sim.checkpointer else 0
        if ckpt_iv and ckpt_iv % spc:
            raise ValueError(f"steps_per_call={spc} must divide "
                             f"the checkpoint interval ({ckpt_iv})")
        step_dt = make_dt_step(case)

        @jax.jit
        def chunk_lag(state, du, d, t_dev):
            def body(carry, _):
                st, du_, d_, t_ = carry
                # Courant of the step that produced st (over du_) sets the
                # dt of the step AFTER this one — one step stale by design
                co_prev = du_ * courant_per_dt(st, case.coeffs)
                scale = jnp.minimum(growth, max_courant
                                    / jnp.maximum(co_prev, 1e-12))
                d2 = jnp.minimum(d_ * scale, dt_ceiling_diffusive)
                st2, diag = step_dt(st, d_)
                return (st2, d_, d2, t_ + d_), (diag.poisson_iters,
                                                diag.poisson_residual,
                                                d_, co_prev)

            (state, du2, d2, t2), (iters, res, dts, cos) = jax.lax.scan(
                body, (state, du, d, t_dev), None, length=spc)
            # packed print/checkpoint scalars — fetched at PRINT cadence
            # only; the controller state (du, d, t) stays on the device
            # between chunks
            packed = jnp.stack([
                du2.astype(jnp.float32), d2.astype(jnp.float32),
                t2.astype(jnp.float32),
                dts[-1].astype(jnp.float32), cos[-1].astype(jnp.float32),
                iters[-1].astype(jnp.float32),
                res[-1].astype(jnp.float32)])
            return state, du2, d2, t2, packed

        du_dev = jnp.asarray(dt_used, case.dtype)
        d_dev = jnp.asarray(dt, case.dtype)
        t_dev = jnp.asarray(t, case.dtype)
        while True:
            if n_steps is not None and k >= n_steps:
                break
            if final_time is not None and t >= final_time:
                break
            state, du_dev, d_dev, t_dev, packed = \
                chunk_lag(state, du_dev, d_dev, t_dev)
            k += spc
            sync = (final_time is not None or k % case.print_interval == 0
                    or (ckpt_iv and k % ckpt_iv == 0)
                    or (n_steps is not None and k >= n_steps))
            if sync:
                du_h, d_h, t, dt_last, co_last, it_last, res_last = \
                    map(float, np.asarray(packed))
                dt_used, dt = du_h, d_h
            if k % case.print_interval == 0:
                row = sim.statistics(state)
                row.update(step=k, time=t, dt=dt_last, courant=co_last,
                           poisson_iters=int(it_last),
                           poisson_residual=res_last)
                rows.append(row)
                log(f"Step {k:6d} | t={t:8.4f} | dt={dt_last:.3e}"
                    f" | Co={co_last:.3f}"
                    f" | max(div)={row['max_divergence']:10.2e}"
                    f" | avg_KE={row['avg_kinetic_energy']:10.6f}")
            if ckpt_iv and k % ckpt_iv == 0:
                sim.checkpointer.maybe_save(
                    state, k, extras={"dt": dt, "t": t, "dt_used": dt_used})
        return state, rows

    if steps_per_call > 1:
        if case.print_interval % steps_per_call:
            raise ValueError(f"steps_per_call={steps_per_call} must divide "
                             f"the print interval ({case.print_interval})")
        ckpt_iv = sim.checkpointer.interval if sim.checkpointer else 0
        if ckpt_iv and ckpt_iv % steps_per_call:
            raise ValueError(f"steps_per_call={steps_per_call} must divide "
                             f"the checkpoint interval ({ckpt_iv})")

        @jax.jit
        def chunk(state, dt):
            def body(carry, _):
                st, d = carry
                st, diag, co_per_dt = step_impl(st, d)
                co = d * co_per_dt
                scale = jnp.minimum(growth, max_courant
                                    / jnp.maximum(co, 1e-12))
                d2 = jnp.minimum(d * scale, dt_ceiling_diffusive)
                return (st, d2), (diag.poisson_iters, diag.poisson_residual,
                                  d, co)

            (state, dt2), (iters, res, dts, cos) = jax.lax.scan(
                body, (state, jnp.asarray(dt, case.dtype)), None,
                length=steps_per_call)
            # one packed scalar vector per chunk (see the lagged branch)
            packed = jnp.stack([
                dt2.astype(jnp.float32), jnp.sum(dts).astype(jnp.float32),
                dts[-1].astype(jnp.float32), cos[-1].astype(jnp.float32),
                iters[-1].astype(jnp.float32), res[-1].astype(jnp.float32)])
            return state, packed

        while True:
            if n_steps is not None and k >= n_steps:
                break
            if final_time is not None and t >= final_time:
                break
            state, packed = chunk(state, dt)
            k += steps_per_call
            d_h, t_inc, dt_last, co_last, it_last, res_last = \
                map(float, np.asarray(packed))
            t += t_inc
            dt = d_h
            if k % case.print_interval == 0:
                row = sim.statistics(state)
                row.update(step=k, time=t, dt=dt_last, courant=co_last,
                           poisson_iters=int(it_last),
                           poisson_residual=res_last)
                rows.append(row)
                log(f"Step {k:6d} | t={t:8.4f} | dt={dt_last:.3e}"
                    f" | Co={co_last:.3f}"
                    f" | max(div)={row['max_divergence']:10.2e}"
                    f" | avg_KE={row['avg_kinetic_energy']:10.6f}")
            if sim.checkpointer is not None:
                sim.checkpointer.maybe_save(state, k,
                                            extras={"dt": dt, "t": t})
        return state, rows

    step = jax.jit(step_impl)
    while True:
        if n_steps is not None and k >= n_steps:
            break
        if final_time is not None and t >= final_time:
            break
        state, diag, co_per_dt = step(state, dt)
        k += 1
        t += dt
        co = dt * float(co_per_dt)
        if k % case.print_interval == 0:
            row = sim.statistics(state)
            row.update(step=k, time=t, dt=dt, courant=co,
                       poisson_iters=int(diag.poisson_iters),
                       poisson_residual=float(diag.poisson_residual))
            rows.append(row)
            log(f"Step {k:6d} | t={t:8.4f} | dt={dt:.3e} | Co={co:.3f}"
                f" | max(div)={row['max_divergence']:10.2e}"
                f" | avg_KE={row['avg_kinetic_energy']:10.6f}")
        # controller: approach max_courant from below, never exceed the
        # diffusive ceiling; shrink immediately when over the target
        scale = min(growth, max_courant / max(co, 1e-12))
        dt = min(dt * scale, dt_ceiling_diffusive)
        if sim.checkpointer is not None:
            # saved AFTER the controller update: the resumed run's first
            # step uses exactly the dt the uninterrupted run would
            sim.checkpointer.maybe_save(state, k, extras={"dt": dt, "t": t})
    return state, rows
