"""Legacy-VTK STRUCTURED_POINTS time-series writer + ParaView .pvd collection.

Vectorized equivalent of the reference's L4 I/O layer (VTKWriter,
cavity-01.cpp:95-300, channel-01.cpp:100-265, masked variant
backwards_step-01.cpp:102-297). Byte-format parity with the reference output
(fixed 6-decimal formatting, field names and ordering, `base_XXXXXX.vtk`
names, `<base>_animation.pvd` collection) so ParaView pipelines built for the
reference work unchanged; verified against golden C++ outputs in
tests/test_vtk.py.

Design: the only host round-trip in the framework (SURVEY.md section 3.4).
Derived fields (center velocities, |V|, vorticity) are computed on device in
one jitted pass; the host only formats numpy arrays to text, vectorized via
numpy per-column string conversion (no per-value Python loop).
"""

from __future__ import annotations

import dataclasses
import io as _io
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from cfd_tpu import native
from cfd_tpu.grid import Grid
from cfd_tpu.ops.stencil import StencilCoeffs, interpolate_to_centers, vorticity_centers


def generate_filename(base: str, step: int) -> str:
    """`base_XXXXXX.vtk`, zero-padded to 6 digits (cavity-01.cpp:240-247)."""
    return f"{base}_{step:06d}.vtk"


def _fmt_column(a: np.ndarray) -> np.ndarray:
    """Vectorized fixed-6-decimal formatting (C++ std::fixed<<setprecision(6),
    cavity-01.cpp:123). numpy's %.6f matches C++ iostream for all finite
    values including negative zero."""
    return np.char.mod("%.6f", a)


def _scalar_section(name: str, a: np.ndarray, literal_zero: np.ndarray | None = None) -> str:
    """One SCALARS block. Where ``literal_zero`` is True the reference prints
    the bare literal ``0.0`` (a double through an unprimed stream branch,
    backwards_step-01.cpp:167-189, 215-235) instead of ``0.000000``.

    Formatting goes through the native C++ snprintf path (cfd_tpu.native)
    when available — byte-identical to the numpy fallback (both are libc
    %.6f) but 10-50x faster at benchmark grid sizes."""
    header = f"SCALARS {name} double 1\nLOOKUP_TABLE default\n"
    body = native.fmt_scalar_fixed6(a, literal_zero)
    if body is not None:
        return header + body
    rows = _fmt_column(a.ravel())
    if literal_zero is not None:
        rows = np.where(literal_zero.ravel(), "0.0", rows)
    return header + "\n".join(rows) + "\n"


def _vector_section(name: str, u: np.ndarray, v: np.ndarray,
                    literal_zero: np.ndarray | None = None) -> str:
    header = f"VECTORS {name} double\n"
    body = native.fmt_vector_fixed6(u, v, literal_zero)
    if body is not None:
        return header + body
    su = _fmt_column(u.ravel())
    sv = _fmt_column(v.ravel())
    rows = np.char.add(np.char.add(su, " "), np.char.add(sv, " 0.0"))
    if literal_zero is not None:
        rows = np.where(literal_zero.ravel(), "0.0 0.0 0.0", rows)
    return header + "\n".join(rows) + "\n"


@dataclasses.dataclass
class SnapshotFields:
    """Host-side numpy interior fields (ny, nx), row j ascending (south to
    north), matching the reference's j-outer i-inner write order
    (cavity-01.cpp:135-141)."""

    uc: np.ndarray
    vc: np.ndarray
    p: np.ndarray
    vorticity: np.ndarray
    mask: np.ndarray | None = None  # FluidMask (backwards_step-01.cpp:152-160)
    vort_computed: np.ndarray | None = None  # where masked vorticity was computable
    extra: dict[str, np.ndarray] | None = None  # extra SCALARS (e.g. temperature)


def write_structured_grid(
    path: str | Path,
    title: str,
    time_value: float,
    grid: Grid,
    fields: SnapshotFields,
) -> None:
    """Emit one legacy-VTK STRUCTURED_POINTS snapshot.

    Field order (cavity-01.cpp:121-231; mask insertion
    backwards_step-01.cpp:148-160): TimeValue, [FluidMask,] velocity,
    u_velocity, v_velocity, velocity_magnitude, pressure, vorticity.
    """
    nx, ny = grid.nx, grid.ny
    n = nx * ny
    uc, vc, p, w = fields.uc, fields.vc, fields.p, fields.vorticity
    mag = np.sqrt(uc * uc + vc * vc)

    buf = _io.StringIO()
    buf.write("# vtk DataFile Version 3.0\n")
    buf.write(f"{title} - Time: {time_value:.6f}\n")
    buf.write("ASCII\n")
    buf.write("DATASET STRUCTURED_POINTS\n")
    buf.write(f"DIMENSIONS {nx} {ny} 1\n")
    buf.write(f"ORIGIN {grid.dx / 2:.6f} {grid.dy / 2:.6f} 0.0\n")
    buf.write(f"SPACING {grid.dx:.6f} {grid.dy:.6f} 1.0\n")
    buf.write(f"POINT_DATA {n}\n")
    # The reference's masked writer is inconsistent about how it prints
    # zeros in solid cells: the vector, magnitude and vorticity sections
    # stream the literal string "0.0" (backwards_step-01.cpp:160,196,220,233)
    # while u/v/pressure stream the double 0.0 through the
    # fixed<<setprecision(6) formatter, i.e. "0.000000"
    # (backwards_step-01.cpp:172,181,205). Reproduced exactly.
    solid = None if fields.mask is None else ~fields.mask
    vort_lit = None
    if fields.vort_computed is not None:
        vort_lit = ~fields.vort_computed
    buf.write(_scalar_section("TimeValue", np.full(n, time_value)))
    if fields.mask is not None:
        buf.write(_scalar_section("FluidMask", fields.mask.astype(np.float64)))
    buf.write(_vector_section("velocity", uc, vc, solid))
    buf.write(_scalar_section("u_velocity", uc))
    buf.write(_scalar_section("v_velocity", vc))
    buf.write(_scalar_section("velocity_magnitude", mag, solid))
    buf.write(_scalar_section("pressure", p))
    buf.write(_scalar_section("vorticity", w, vort_lit))
    for name, arr in (fields.extra or {}).items():
        buf.write(_scalar_section(name, arr))
    Path(path).write_text(buf.getvalue())


def write_paraview_collection(path: str | Path, entries: list[tuple[float, str]]) -> None:
    """`.pvd` XML collection: timestep -> vtk filename
    (cavity-01.cpp:255-287)."""
    lines = [
        '<?xml version="1.0"?>',
        '<VTKFile type="Collection" version="0.1" byte_order="LittleEndian">',
        "  <Collection>",
    ]
    for t, fname in entries:
        lines.append(f'    <DataSet timestep="{t:.6f}" group="" part="0" file="{fname}"/>')
    lines += ["  </Collection>", "</VTKFile>", ""]
    Path(path).write_text("\n".join(lines))


class VTKExporter:
    """Stateful exporter: device-side derived-field computation + host text
    emit + collection bookkeeping. Usable as the ``Simulation`` exporter
    callback.

    The masked vorticity rule matches the reference writer: nonzero only
    where the cell and all four neighbors are fluid and the cell is off the
    domain border (backwards_step-01.cpp:222-235); all outputs are zeroed in
    solid cells (the interpolation/stat masking already guarantees that for
    uc/vc/p since p is never updated in solid cells' output copy — the
    reference zeroes them explicitly, backwards_step-01.cpp:176-189, which
    the cell mask reproduces).
    """

    def __init__(self, grid: Grid, coeffs: StencilCoeffs, title: str, base: str,
                 out_dir: str | Path = "vtk_output", extra_fields=None):
        self.grid = grid
        self.title = title
        self.base = base
        self._extra_fields = jax.jit(extra_fields) if extra_fields else None
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.entries: list[tuple[float, str]] = []
        self._masked = grid.has_solids

        cell = jnp.asarray(grid.cell_mask)
        if self._masked:
            f = grid.fluid
            ok = f & np.roll(f, 1, 1) & np.roll(f, -1, 1) & np.roll(f, 1, 0) & np.roll(f, -1, 0)
            jj = np.arange(grid.shape[0])[:, None]
            ii = np.arange(grid.shape[1])[None, :]
            ok &= (jj > 1) & (jj < grid.ny) & (ii > 1) & (ii < grid.nx)
            self._vort_ok_np = ok
            vort_ok = jnp.asarray(ok)
        else:
            self._vort_ok_np = None
            vort_ok = None

        def derive(u, v, p):
            uc, vc = interpolate_to_centers(u, v, cell)
            w = vorticity_centers(uc, vc, grid, coeffs)
            if vort_ok is not None:
                w = jnp.where(vort_ok, w, jnp.zeros_like(w))
            pm = jnp.where(cell, p, jnp.zeros_like(p))
            return uc, vc, pm, w

        self._derive = jax.jit(derive)

    def __call__(self, state, step: int, time_value: float) -> Path:
        g = self.grid
        uc, vc, p, w = self._derive(state.u, state.v, state.p)
        sl = np.s_[1 : g.ny + 1, 1 : g.nx + 1]
        fields = SnapshotFields(
            uc=np.asarray(uc)[sl],
            vc=np.asarray(vc)[sl],
            p=np.asarray(p)[sl],
            vorticity=np.asarray(w)[sl],
            mask=g.fluid[sl] if self._masked else None,
            vort_computed=self._vort_ok_np[sl] if self._masked else None,
            extra={k: np.asarray(a)[sl] for k, a in self._extra_fields(state).items()}
            if self._extra_fields is not None else None,
        )
        fname = generate_filename(self.base, step)
        write_structured_grid(self.out_dir / fname, self.title, time_value, g, fields)
        self.entries.append((time_value, fname))
        return self.out_dir / fname

    def write_collection(self) -> Path:
        path = self.out_dir / f"{self.base}_animation.pvd"
        write_paraview_collection(path, self.entries)
        return path


def exporter_for_case(case, out_dir: str | Path = "vtk_output") -> VTKExporter:
    """Build the exporter for a ``solver.Case`` (duck-typed to avoid an io ->
    solver import cycle)."""
    return VTKExporter(case.grid, case.coeffs, case.vtk_title, case.vtk_basename,
                       out_dir, extra_fields=case.vtk_extra_fields)
