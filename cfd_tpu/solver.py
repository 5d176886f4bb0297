"""Projection-method time integration (L3 driver).

One solver core parameterized by (grid/mask, BC set, Poisson flavor, step
ordering) replaces the reference's three monolithic solver classes. Two
per-step orderings exist in the reference and both are kept for exact
behavioral parity:

* ``cavity`` ordering (cavity-01.cpp:387-390):
  BC(u,v) -> predictor -> Poisson (cold start) -> corrector.
* ``channel`` ordering (channel-01.cpp:365-386, backwards_step-01.cpp:409-430):
  predictor -> BC(u*,v*) -> source (mean removed) -> Poisson (warm start,
  ghosts refreshed per sweep) -> corrector -> BC(u,v).

The step is a pure jitted function State -> (State, StepDiagnostics); the
SOR solve runs as a device-resident while_loop, so a whole time step is one
XLA program with no host syncs.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from cfd_tpu.bc import VelocityBC
from cfd_tpu.grid import Grid
from cfd_tpu.ops.stencil import (
    StencilCoeffs,
    poisson_source,
    predictor,
    pressure_correction,
)
from cfd_tpu.ops.reductions import flow_statistics
from cfd_tpu.state import State, StepDiagnostics

PoissonSolve = Callable[[jnp.ndarray, jnp.ndarray], tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]]


@dataclasses.dataclass(frozen=True)
class Case:
    """Full static description of a simulation case (L5 config layer).

    The reference hardcodes these as ``static constexpr`` blocks
    (cavity-01.cpp:309-320, channel-01.cpp:287-300,
    backwards_step-01.cpp:319-334); here they are data.
    """

    name: str
    grid: Grid
    coeffs: StencilCoeffs
    ordering: str  # "cavity" | "channel"
    velocity_bc: VelocityBC
    poisson_solve: PoissonSolve
    remove_source_mean: bool
    cavity_corrector: bool  # rho-multiplied gradient (cavity-01.cpp:701)
    ke_divisor: int
    final_time: float
    total_steps: int
    print_interval: int
    save_interval: int
    dtype: jnp.dtype = jnp.float32
    vtk_basename: str = "flow"
    vtk_title: str = "Flow Data"
    # Extrapolated Poisson warm start (p_guess = 2 p_n - p_{n-1}): fewer
    # multigrid cycles to the same tolerance; the SOR cavity flavor ignores
    # warm starts entirely (reference cold-starts, cavity-01.cpp:610).
    extrapolate_warm_start: bool = False
    # Iteration cap of the pressure solver (SOR max_iters or multigrid
    # max_cycles); when a step's Poisson solve hits it, Simulation.run logs
    # the reference's non-convergence warning and continues
    # (cavity-01.cpp:681-684, channel-01.cpp:683-685,
    # backwards_step-01.cpp:933-935).
    poisson_max_iters: Optional[int] = None
    # Extension hook for physics beyond the plain projection step (e.g.
    # Boussinesq): custom_step(case) returns step(state, dt) -> (State,
    # StepDiagnostics), where dt may be a traced scalar (adaptive runs) —
    # the same contract as make_dt_step.
    custom_step: Optional[Callable] = None
    # Optional body-force (momentum source) arrays on the u-/v-faces,
    # applied as +dt*f in the predictor — framework extension (no reference
    # analog): gravity-style sources and MMS verification forcing
    # (cfd_tpu.validation.manufactured_solution).
    forcing: Optional[tuple] = None
    # Diffusivity for the adaptive controller's stability ceiling
    # dt <= 0.25 h^2 / D: defaults to coeffs.viscosity; cases transporting
    # additional diffusive scalars set the binding one (Rayleigh-Benard:
    # max(nu, kappa) — kappa binds at Pr < 1).
    adaptive_diffusivity: Optional[float] = None
    # Banner scalars for io.console.print_banner (the reference
    # printSimulationInfo block, cavity-01.cpp:501-518): reynolds, cfl,
    # omega, length/height, banner_title, ... — display-only.
    info: Optional[dict] = None
    extra_stats: Optional[Callable] = None  # (State) -> dict[str, scalar]
    initial_state_fn: Optional[Callable] = None  # () -> State
    vtk_extra_fields: Optional[Callable] = None  # (State) -> dict[str, array]

    @property
    def dt(self) -> float:
        return self.coeffs.dt


def make_dt_step(case: Case) -> Callable:
    """Build step(state, dt) -> (State, StepDiagnostics) for a case; ``dt``
    may be a traced scalar (adaptive runs), or None for the case's own."""
    if case.custom_step is not None:
        return case.custom_step(case)
    grid, c0 = case.grid, case.coeffs
    bc = case.velocity_bc
    if grid.has_solids:
        _consts = (jnp.asarray(grid.cell_mask), jnp.asarray(grid.u_valid_mask),
                   jnp.asarray(grid.v_valid_mask), jnp.asarray(grid.u_range_mask),
                   jnp.asarray(grid.v_range_mask))

        def masks():
            return _consts
    else:
        # rectangle grids: iota-derived masks, built INSIDE the traced step
        # so they fuse to in-register compares instead of streaming constant
        # arrays from HBM (ops.stencil.iota_masks)
        from cfd_tpu.ops.stencil import iota_masks

        def masks():
            cell, u_valid, v_valid = iota_masks(grid)
            return cell, u_valid, v_valid, u_valid, v_valid
    n_fluid = grid.n_fluid
    extrap = case.extrapolate_warm_start
    fx, fy = (jnp.asarray(case.forcing[0]), jnp.asarray(case.forcing[1])) \
        if case.forcing is not None else (None, None)

    def coeffs(dt):
        return c0 if dt is None else dataclasses.replace(c0, dt=dt)

    if case.ordering == "cavity":

        def step(state: State, dt=None) -> tuple[State, StepDiagnostics]:
            c = coeffs(dt)
            cell, u_valid, v_valid, u_range, v_range = masks()
            u, v = bc(state.u, state.v)
            us, vs = predictor(u, v, c, u_valid, v_valid, fx=fx, fy=fy)
            b = poisson_source(us, vs, c, cell, remove_mean=False, n_cells=n_fluid)
            guess = 2.0 * state.p - state.p_prev if extrap else state.p
            p, iters, res = case.poisson_solve(guess, b)
            u2, v2 = pressure_correction(
                us, vs, p, c, u_valid, v_valid, u_else=u, v_else=v, cavity_form=True
            )
            return State(u2, v2, p, state.T, state.p if extrap else None), \
                StepDiagnostics(iters, res)

    elif case.ordering == "channel":

        def step(state: State, dt=None) -> tuple[State, StepDiagnostics]:
            c = coeffs(dt)
            cell, u_valid, v_valid, u_range, v_range = masks()
            us, vs = predictor(state.u, state.v, c, u_valid, v_valid,
                               fx=fx, fy=fy)
            us, vs = bc(us, vs)
            b = poisson_source(
                us, vs, c, cell, remove_mean=case.remove_source_mean, n_cells=n_fluid
            )
            guess = 2.0 * state.p - state.p_prev if extrap else state.p
            p, iters, res = case.poisson_solve(guess, b)
            # invalid in-range faces are zeroed (backwards_step-01.cpp:956,972)
            zu = jnp.zeros_like(state.u)
            u_else = jnp.where(u_range, zu, state.u)
            v_else = jnp.where(v_range, zu, state.v)
            u2, v2 = pressure_correction(
                us, vs, p, c, u_valid, v_valid, u_else=u_else, v_else=v_else,
                cavity_form=case.cavity_corrector,
            )
            u2, v2 = bc(u2, v2)
            return State(u2, v2, p, state.T, state.p if extrap else None), \
                StepDiagnostics(iters, res)

    else:
        raise ValueError(f"unknown ordering: {case.ordering}")

    return step


def make_step(case: Case) -> Callable[[State], tuple[State, StepDiagnostics]]:
    """Build the pure per-step function for a case (not yet jitted)."""
    step = make_dt_step(case)
    return lambda state: step(state, None)


class Simulation:
    """Host-side time-loop driver with periodic diagnostics and export
    (equivalent of the reference ``run()`` loops)."""

    def __init__(self, case: Case, exporter=None, log=print, metrics=None,
                 mesh=None):
        """``mesh``: a jax.sharding.Mesh with axes ("dy", "dx") — runs the
        case over several devices: the same step, partitioned by XLA (GSPMD,
        parallel.sharded.shard_step) with the state sharded by rows and
        columns. The time loop, stats rows, VTK export and checkpointing are
        unchanged — the equivalent of the reference's OpenFOAM decomposePar
        + mpirun workflow (README.md:129-131)."""
        self.case = case
        self.exporter = exporter  # callable (state, step_idx, time) or None
        self.log = log
        self.metrics = metrics  # io.MetricsLog or None
        self.mesh = mesh
        step = make_step(case)
        if mesh is not None:
            from cfd_tpu.parallel.sharded import shard_step

            step = shard_step(step, mesh)
        self._step_fn = step
        self._step = jax.jit(step)
        self._stats = jax.jit(
            lambda u, v: flow_statistics(
                u, v, case.coeffs, jnp.asarray(case.grid.cell_mask), case.ke_divisor
            )
        )
        self._extra_stats = jax.jit(case.extra_stats) if case.extra_stats else None
        self._multi_cache: dict[int, Callable] = {}
        self.history: list[dict] = []
        self.checkpointer = None  # io.checkpoint.CheckpointManager or None
        # Failure detection (SURVEY.md section 5.3): the reference continues
        # after SOR non-convergence and has no NaN guards; here a NaN/Inf
        # or a KE blowup aborts the run with a diagnosable error.
        self.blowup_ke_threshold = 1e6

    def initial_state(self) -> State:
        if self.case.initial_state_fn is not None:
            st = self.case.initial_state_fn()
        else:
            s = State.zeros(self.case.grid.shape, dtype=self.case.dtype)
            u, v = self.case.velocity_bc(s.u, s.v)
            p_prev = s.p if self.case.extrapolate_warm_start else None
            st = State(u, v, s.p, s.T, p_prev)
        return self.place(st)

    def place(self, state: State) -> State:
        """Lay a state out as the step expects it: sharded over the mesh, if
        any (so the compiled step sees one input sharding throughout)."""
        if self.mesh is None:
            return state
        from cfd_tpu.parallel.sharded import shard_state

        return shard_state(state, self.mesh)

    def statistics(self, state: State) -> dict[str, float]:
        vals = self._stats(state.u, state.v)
        if self._extra_stats is not None:
            vals.update(self._extra_stats(state))
        # ONE device->host transfer for the whole row, not one per scalar
        keys = list(vals)
        flat = np.asarray(jnp.stack([jnp.asarray(vals[k], jnp.float32)
                                     for k in keys]))
        return dict(zip(keys, map(float, flat)))

    def _multi_step(self, spc: int):
        """jitted scan of ``spc`` steps per dispatch (amortizes host->device
        dispatch latency on large grids)."""
        if spc not in self._multi_cache:
            step = self._step_fn
            self._multi_cache[spc] = jax.jit(
                lambda s: jax.lax.scan(lambda s, _: step(s), s, None,
                                       length=spc))
        return self._multi_cache[spc]

    def run(self, state: Optional[State] = None, n_steps: Optional[int] = None,
            start_step: int = 0, steps_per_call: int = 1) -> State:
        case = self.case
        if steps_per_call > 1:
            intervals = {"print": case.print_interval, "save": case.save_interval}
            if self.checkpointer is not None:
                intervals["checkpoint"] = self.checkpointer.interval
            for name, iv in intervals.items():
                if iv % steps_per_call:
                    raise ValueError(
                        f"steps_per_call={steps_per_call} must divide the "
                        f"{name} interval ({iv})")
        if state is None:
            state = self.initial_state()
            if self.exporter is not None and start_step == 0:
                # t=0 snapshot: the reference's CHANNEL solver writes it
                # from the constructor (channel-01.cpp:351-355) while
                # cavity/step write from run(); exporting uniformly here is
                # output-identical (byte-tested in test_vtk.py) — only the
                # call site differs.
                self.exporter(state, 0, 0.0)
        else:
            state = self.place(state)
        n = case.total_steps if n_steps is None else start_step + n_steps
        n_cells = case.grid.n_fluid
        t_wall0 = time.perf_counter()
        prev_k, prev_wall = start_step, t_wall0
        cap = case.poisson_max_iters
        # Per-chunk max Poisson iteration counts, kept as lazy device scalars
        # and only pulled to host at print cadence, so the non-convergence
        # check adds no extra host syncs to the hot loop.
        pending_iter_max: list = []

        def after_step(k: int, state: State, diag: StepDiagnostics) -> None:
            nonlocal prev_k, prev_wall
            t = k * case.dt
            last = k == n
            if k % case.print_interval == 0 or last:
                now = time.perf_counter()
                row = self.statistics(state)
                interval_steps = k - prev_k
                interval_wall = max(now - prev_wall, 1e-12)
                row.update(
                    step=k, time=t,
                    poisson_iters=int(diag.poisson_iters),
                    poisson_residual=float(diag.poisson_residual),
                    wall_seconds=now - t_wall0,
                    cell_updates_per_sec=n_cells * interval_steps / interval_wall,
                )
                prev_k, prev_wall = k, now
                self.history.append(row)
                if self.metrics is not None:
                    self.metrics.append(row)
                ke = row["avg_kinetic_energy"]
                if not (ke == ke) or ke > self.blowup_ke_threshold:  # NaN or blowup
                    raise RuntimeError(
                        f"solver diverged at step {k}: avg_KE={ke} "
                        f"(max_div={row['max_divergence']}, "
                        f"poisson_residual={row['poisson_residual']}); "
                        "reduce dt/CFL or check boundary conditions")
                self.log(
                    f"Step {k:6d}/{case.total_steps} | t={t:8.3f}"
                    f" | max(div)={row['max_divergence']:10.2e}"
                    f" | avg_KE={row['avg_kinetic_energy']:10.6f}"
                    f" | PPE iters={row['poisson_iters']:4d}"
                    f" | res={row['poisson_residual']:10.2e}"
                )
                # Reference-parity non-convergence warning
                # (cavity-01.cpp:681-684): warn-and-continue when any step
                # since the last print hit the pressure-solver cap.
                if cap is not None and pending_iter_max:
                    worst = max(int(x) for x in pending_iter_max)
                    pending_iter_max.clear()
                    if worst >= cap:
                        self.log(
                            f"Warning: SOR solver did not converge in {cap} "
                            f"iterations. Final residual: "
                            f"{row['poisson_residual']:.6e}")
            if self.exporter is not None and (k % case.save_interval == 0 or last):
                self.exporter(state, k, t)
            if self.checkpointer is not None:
                self.checkpointer.maybe_save(state, k)

        multi = self._multi_step(steps_per_call) if steps_per_call > 1 else None
        # main chunked loop + single-step tail when steps_per_call does not
        # divide the range; both paths share the full diagnostics/export/
        # checkpoint bookkeeping (after_step).
        main_end = start_step + ((n - start_step) // steps_per_call) * steps_per_call
        for k in range(start_step + steps_per_call, main_end + 1, steps_per_call):
            if multi is not None:
                state, diags = multi(state)
                diag = StepDiagnostics(diags.poisson_iters[-1],
                                       diags.poisson_residual[-1])
                if cap is not None:
                    pending_iter_max.append(jnp.max(diags.poisson_iters))
            else:
                state, diag = self._step(state)
                if cap is not None:
                    pending_iter_max.append(diag.poisson_iters)
            after_step(k, state, diag)
        for k in range(main_end + 1, n + 1):
            state, diag = self._step(state)
            if cap is not None:
                pending_iter_max.append(diag.poisson_iters)
            after_step(k, state, diag)
        if self.exporter is not None and hasattr(self.exporter, "write_collection"):
            self.exporter.write_collection()
        return state
