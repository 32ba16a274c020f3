"""3-D climate training-data generation.

Port of ``universal_differential_equations_tpu/models/climate_datagen.py``,
the replacement for the reference's Oceananigans runs
(``Climate/DataGeneration/``): finite-difference stencils over the whole 3-D
grid (``torch.roll`` and elementwise updates) and an incompressible pressure
projection by FFT (``torch.fft.fftn``/``ifftn``).

Two generators, mirroring the two reference scripts:

* ``advection_diffusion_3d`` (``advection_diffusion_3d.jl``): tracer-only
  ∂c/∂t = κ∇²c + F(c), F = cos(sin c³) + sin(cos c²), horizontally periodic
  with Neumann top/bottom, Gaussian-sheet initial condition, CFL-style
  adaptive dt wizard, horizontal-average diagnostics.
* ``rayleigh_taylor_3d`` (``rayleigh_taylor_instability_3d.jl:13-43``): an
  incompressible Boussinesq solve — velocity + buoyancy tracer b, unstable
  interface ``0.05·sin(6πx)`` with b=+1 below / −1 above, ν=κ=1e-4, with a
  periodic-z default (one-FFT Leray projection) or ``bc="rigid_lid"``
  (free-slip lids, no-flux buoyancy, an image-charge FFT pressure solve on
  the mirror-doubled grid, ``_project_rigid``).

Both step in chunks of ``ni`` Heun steps: a chunk reads nothing from the
device between its steps, as the JAX package's ``lax.scan`` chunk does, and
only the CFL number (``umax``, ``fmax``) crosses to the host, once per chunk,
where the adaptive-dt wizard (``TimeStepWizard(cfl=…)``) sets the next
chunk's step.  They return horizontal averages on a regular save grid — the
training dataset of ``Climate/Training``.

Every generator takes ``device`` (default ``cuda``) and ``dtype``.  Noise
comes from an explicit ``torch.Generator`` (``key``), drawn on the CPU for
the whole grid; ``key=None`` adds none, which gives both packages identical
inputs.

``mesh=`` decomposes the field along x over the ranks of a
``parallel.Mesh`` (every rank of the mesh makes the call; ``N[0]`` must
divide by the mesh size, and one plane per rank works): each rank holds an
x-slab, the x-direction stencils take one plane from each neighbour
(``parallel.collectives.halo_x``, one exchange per evaluation for all
fields), and the Leray projection is a slab-decomposed 3-D FFT (local FFTs
over y and z, an all-to-all transpose that makes x whole and splits z, the
FFT along x; :class:`_SlabFFT`).  The CFL number is a maximum over the
ranks before its one host read per chunk, and the saved horizontal means
are summed over the ranks and returned on every rank.  These are the
collectives XLA's SPMD partitioner inserts in the JAX package; the noise is
drawn for the whole grid and sliced, so a seed gives the same field at
every world size.
"""
from __future__ import annotations

import time
from typing import Tuple

import numpy as np
import torch

from ..parallel.collectives import all_max, halo_x, psum, transpose
from ..parallel.mesh import split_sizes
__all__ = ["advection_diffusion_3d", "rayleigh_taylor_3d", "coarse_grain",
           "rt_step_seconds", "tracer_step_seconds", "load_oceananigans_averages"]


def load_oceananigans_averages(path, field: str = "b"):
    """Ingest an Oceananigans horizontal-average JLD2 output file.

    JLD2 is HDF5 underneath: profile snapshots live at
    ``timeseries/<field>/<iteration>`` with matching scalars at
    ``timeseries/t/<iteration>`` and the vertical extent under ``grid/``.
    Returns ``(t (Nt,), z (Nz,), profiles (Nt, Nz))`` as float32 numpy
    arrays sorted by time, :func:`rayleigh_taylor_3d`'s convention.

    Requires ``h5py`` (imported here); raises ImportError without it.
    """
    import h5py

    with h5py.File(path, "r") as f:
        iters = sorted(f["timeseries/t"].keys(), key=int)
        t = np.array([f[f"timeseries/t/{i}"][()] for i in iters])
        prof = np.stack([f[f"timeseries/{field}/{i}"][()] for i in iters])
        nz = int(f["grid/Nz"][()])
        lz = float(f["grid/Lz"][()])
    assert prof.shape == (len(iters), nz), prof.shape
    # npde_data.jl:60 uses grid = range(0, 1, length=N): node coordinates
    # spanning the Lz extent
    z = np.linspace(0.0, lz, nz)
    return (t.astype(np.float32), z.astype(np.float32),
            prof.astype(np.float32))


def _x_pair(c, xs):
    """``c``'s x-neighbours ``(c[i-1], c[i+1])``: ``xs`` where the caller
    has them (a decomposed field), else periodic rolls."""
    return (torch.roll(c, 1, 0), torch.roll(c, -1, 0)) if xs is None else xs


def _lap_periodic(c, dx, xs=None):
    xm, xp = _x_pair(c, xs)
    out = torch.zeros_like(c)
    out = out + (xm - 2.0 * c + xp) / dx[0] ** 2
    for ax in (1, 2):
        out = out + (torch.roll(c, 1, ax) - 2.0 * c + torch.roll(c, -1, ax)) / dx[ax] ** 2
    return out


def _lap_neumann_z(c, dx, xs=None):
    """Periodic in x, y; zero-flux (Neumann) top/bottom in z."""
    xm, xp = _x_pair(c, xs)
    out = (xm - 2.0 * c + xp) / dx[0] ** 2
    out = out + (torch.roll(c, 1, 1) - 2.0 * c + torch.roll(c, -1, 1)) / dx[1] ** 2
    up = torch.cat([c[:, :, 1:], c[:, :, -1:]], dim=2)
    dn = torch.cat([c[:, :, :1], c[:, :, :-1]], dim=2)
    return out + (up - 2.0 * c + dn) / dx[2] ** 2


def _lap_dirichlet_z(c, dx, xs=None):
    """Periodic in x, y; odd-mirror (zero at the wall faces) top/bottom in
    z — the free-slip rigid-lid Laplacian for the wall-normal velocity."""
    xm, xp = _x_pair(c, xs)
    out = (xm - 2.0 * c + xp) / dx[0] ** 2
    out = out + (torch.roll(c, 1, 1) - 2.0 * c + torch.roll(c, -1, 1)) / dx[1] ** 2
    up = torch.cat([c[:, :, 1:], -c[:, :, -1:]], dim=2)
    dn = torch.cat([-c[:, :, :1], c[:, :, :-1]], dim=2)
    return out + (up - 2.0 * c + dn) / dx[2] ** 2


def _donor(f, vel, h, fm, fp):
    """The donor-cell term ``vel·∂f`` from the neighbours ``fm``, ``fp``."""
    return torch.where(vel > 0, vel * ((f - fm) / h), vel * ((fp - f) / h))


def _adv(f, u, v, w, dx, xs=None):
    """Upwind (donor-cell) advection −(u·∇)f on the periodic grid.

    First-order upwinding is deliberately diffusive: at training-data grid
    Péclet numbers (u·Δx/ν ~ 10²–10³) centered differences ring and blow up
    under explicit stepping; donor-cell stays monotone and the horizontal
    b̄(z) averages are insensitive to the extra smoothing."""
    out = torch.zeros_like(f)
    out = out - _donor(f, u, dx[0], *_x_pair(f, xs))
    for ax, vel, h in ((1, v, dx[1]), (2, w, dx[2])):
        out = out - _donor(f, vel, h, torch.roll(f, 1, ax), torch.roll(f, -1, ax))
    return out


def _adv_bounded_z(f, u, v, w, dx, parity, xs=None):
    """Donor-cell advection −(u·∇)f: periodic in x, y; mirrored ghost cells
    in z — ``parity=+1`` (zero-gradient walls: scalars and tangential
    velocities under free slip) or ``-1`` (zero at the wall faces: the
    wall-normal velocity)."""
    out = torch.zeros_like(f)
    out = out - _donor(f, u, dx[0], *_x_pair(f, xs))
    out = out - _donor(f, v, dx[1], torch.roll(f, 1, 1), torch.roll(f, -1, 1))
    dn = torch.cat([parity * f[:, :, :1], f[:, :, :-1]], dim=2)
    up = torch.cat([f[:, :, 1:], parity * f[:, :, -1:]], dim=2)
    return out - _donor(f, w, dx[2], dn, up)


def _wavenumbers(n: int, l: float, dtype=torch.float64, device=None):
    """FFT wavenumbers with the Nyquist mode zeroed: an unpaired ±n/2
    coefficient of a real field has no well-defined spectral derivative, and
    taking ``.real`` after the inverse FFT would leave its divergence
    un-projected.  Computed in float64, then cast to ``dtype``."""
    k = torch.fft.fftfreq(n, d=l / n, dtype=torch.float64) * 2 * np.pi
    if n % 2 == 0:
        k[n // 2] = 0.0
    return k.to(dtype=dtype, device=device)


class _SlabFFT:
    """The 3-D FFT of fields split along x over a mesh's ranks.

    ``forward`` takes each rank's (nx, Ny, Nz) slabs: 2-D FFTs over (y, z)
    on the rank, an all-to-all transpose that makes x whole and splits z
    (``split_sizes(Nz, ranks)``, uneven where Nz does not divide: Ny may be
    as small as 2), then the FFT along x; the spectra are (Nx, Ny, nz).
    ``inverse`` undoes it and returns the real parts, as ``ifftn(...).real``
    does."""

    def __init__(self, mesh, nx, nz):
        self.mesh = mesh
        self.x_split = [nx] * mesh.size
        self.z_split = split_sizes(nz, mesh.size)
        lo = sum(self.z_split[:mesh.member()])
        self.z_slice = slice(lo, lo + self.z_split[mesh.index])

    def forward(self, fields):
        a = torch.fft.fft2(torch.stack(fields), dim=(-2, -1))
        a = transpose(a, self.mesh, 3, 1, split=self.z_split)
        return list(torch.fft.fft(a, dim=1).unbind(0))

    def inverse(self, spectra):
        a = torch.fft.ifft(torch.stack(spectra), dim=1)
        a = transpose(a, self.mesh, 1, 3, split=self.x_split, gathered=self.z_split)
        return list(torch.fft.ifft2(a, dim=(-2, -1)).real.unbind(0))


def _project(u, v, w, kx, ky, kz, fft=None):
    """Incompressible (Leray) projection via FFT: û ← (I − k kᵀ/|k|²) û.
    ``fft`` (a :class:`_SlabFFT`) transforms x-slabs; the wavenumbers are
    then its spectra's."""
    if fft is None:
        uh, vh, wh = torch.fft.fftn(u), torch.fft.fftn(v), torch.fft.fftn(w)
    else:
        uh, vh, wh = fft.forward([u, v, w])
    k2 = kx**2 + ky**2 + kz**2
    s = torch.where(k2 > 0,
                    (kx * uh + ky * vh + kz * wh) / torch.clamp(k2, min=1e-30),
                    torch.zeros((), dtype=uh.dtype, device=uh.device))
    out = [uh - kx * s, vh - ky * s, wh - kz * s]
    if fft is None:
        return tuple(torch.fft.ifftn(o).real for o in out)
    return tuple(fft.inverse(out))


def _ext_even(f):
    """Mirror-even extension along z (cell-centered): f_{-1-j} = f_j."""
    return torch.cat([f, torch.flip(f, (2,))], dim=2)


def _ext_odd(f):
    """Mirror-odd extension along z: f_{-1-j} = -f_j (zero at the walls)."""
    return torch.cat([f, -torch.flip(f, (2,))], dim=2)


def _project_rigid(u, v, w, kx, ky, kz, fft=None):
    """Leray projection with rigid lids in z (image-charge FFT variant).

    Extends (u, v) mirror-even and w mirror-odd along z (so w vanishes at
    both walls and p has homogeneous Neumann walls), runs the periodic
    spectral projection on the doubled domain and restricts: the DCT/DST
    mixed-basis solve of the wall-bounded pressure problem.  ``kx/ky/kz``
    must be the doubled grid's wavenumbers (``fft``'s, on x-slabs)."""
    ue, ve, we = _ext_even(u), _ext_even(v), _ext_odd(w)
    ue, ve, we = _project(ue, ve, we, kx, ky, kz, fft)
    nz = u.shape[2]
    return ue[:, :, :nz], ve[:, :, :nz], we[:, :, :nz]


def _noise(key, shape, dtype, device, scale, rows=slice(None)):
    """``scale`` × standard normal noise from the ``torch.Generator`` ``key``
    (drawn on the CPU for the whole grid ``shape``, so a seed gives the same
    field on every device and world size); ``rows`` of it along x."""
    return scale * torch.randn(shape, generator=key, dtype=torch.float64)[rows].to(
        dtype=dtype, device=device)


class _Slab:
    """The x-decomposition of an ``nx``-plane grid: on one device (``mesh``
    None) the whole grid; on a mesh this rank's planes ``rows``, the halo
    exchange (``neighbours``), the maximum and the horizontal mean over the
    ranks."""

    def __init__(self, mesh, mesh_axis, nx, device):
        self.mesh = mesh
        self.rows = slice(None)
        if mesh is not None:
            mesh.axis(mesh_axis)
            if device.type != mesh.device_type:
                raise ValueError(f"device {device} handed to a {mesh.device_type} mesh")
            if nx % mesh.size:
                raise ValueError(f"Nx={nx} not divisible by mesh axis '{mesh.axis_names[0]}' "
                                 f"size {mesh.size}")
            per = nx // mesh.size
            self.rows = slice(mesh.member() * per, (mesh.index + 1) * per)
        self.n_total = nx

    def neighbours(self, fields):
        """Each field's ``(f[i-1], f[i+1])`` along x (one exchange for all),
        or None per field on one device (the stencils roll)."""
        if self.mesh is None:
            return [None] * len(fields)
        halos = halo_x(fields, self.mesh)
        return [(torch.cat([lo, f[:-1]]), torch.cat([f[1:], hi]))
                for f, (lo, hi) in zip(fields, halos)]

    def max(self, x):
        return x if self.mesh is None else all_max(x, self.mesh)

    def hmean(self, f):
        """The horizontal mean over (x, y), a (Nz,) profile."""
        if self.mesh is None:
            return f.mean(dim=(0, 1))
        return psum(f.sum(dim=(0, 1)), self.mesh) / (self.n_total * f.shape[1])


def _tracer_chunk(N, L, kappa, ni, dtype, device, slab=None):
    """``(c0, chunk, dx)`` of the forced tracer run: ``chunk(c, dt)`` takes
    ``ni`` Heun steps and returns ``(c, max|rhs(c)|)``, both on the device;
    on a ``slab`` (:class:`_Slab`) its x-planes and the maximum over the
    ranks."""
    slab = _Slab(None, None, N, device) if slab is None else slab
    dx = (L / N,) * 3
    z = (torch.arange(N, dtype=dtype, device=device) + 0.5) * dx[2]
    c = torch.exp(-200.0 * (z - 0.75) ** 2)[None, None, :] * torch.ones(
        (N, N, 1), dtype=dtype, device=device)[slab.rows]

    def rhs(c):
        F = torch.cos(torch.sin(c**3)) + torch.sin(torch.cos(c**2))
        return kappa * _lap_neumann_z(c, dx, slab.neighbours([c])[0]) + F

    def chunk(c, dt):
        for _ in range(ni):
            # RK2 (Heun): the forcing is smooth, diffusion bounds dt
            k1 = rhs(c)
            k2 = rhs(c + dt * k1)
            c = c + 0.5 * dt * (k1 + k2)
        return c, slab.max(torch.max(torch.abs(rhs(c))))

    return c, chunk, dx


def advection_diffusion_3d(
    N: int = 64,
    L: float = 1.0,
    kappa: float = 0.05,
    end_time: float = 1.5,
    save_every: float = 0.01,
    cfl: float = 0.1,
    max_dt: float = 1e-1,
    ni: int = 20,
    key=None,
    dtype=torch.float32,
    mesh=None,
    mesh_axis: str = "x",
    device="cuda",
):
    """Forced diffusion tracer run; returns (save_ts, c_profiles (T, N)) as
    numpy arrays.  ``mesh`` decomposes the grid along its first axis over
    ``mesh_axis`` (the profiles are every rank's)."""
    device = torch.device(device)
    slab = _Slab(mesh, mesh_axis, N, device)
    c, chunk, dx = _tracer_chunk(N, L, kappa, ni, dtype, device, slab)
    if key is not None:
        c = c + _noise(key, (N, N, N), dtype, device, 1e-8, slab.rows)

    # stability-limited dt wizard: diffusive limit + forcing-CFL analogue.
    # The save-cadence cap: one save per chunk, so the chunk span must not
    # exceed save_every.
    diff_dt = cfl * dx[0] ** 2 / (6.0 * kappa)
    dt_save_cap = save_every / ni
    t, dt = 0.0, min(1e-4, diff_dt, dt_save_cap)
    save_ts, profiles = [], []
    next_save = 0.0
    while t < end_time:
        if t >= next_save:
            save_ts.append(t)
            profiles.append(slab.hmean(c).cpu().numpy())
            next_save += save_every
        c, fmax = chunk(c, torch.tensor(dt, dtype=dtype, device=device))
        t += ni * dt
        # wizard: grow toward the stability budget, cap change at 1.2×
        dt_target = min(diff_dt, cfl * 1.0 / max(float(fmax), 1e-8), max_dt)
        dt = min(dt * 1.2, dt_target, dt_save_cap)
    save_ts.append(t)
    profiles.append(slab.hmean(c).cpu().numpy())
    return np.asarray(save_ts), np.stack(profiles)


def _rt_stepper(N, L, nu, kappa, b_amp, ni, key, dtype, mesh=None, mesh_axis: str = "x",
                bc: str = "periodic", device="cuda"):
    """Initial state + ``ni``-step Heun/Leray chunk for the RT slab.

    Shared by :func:`rayleigh_taylor_3d` (the data generator's adaptive-CFL
    outer loop) and :func:`rt_step_seconds` (the step-time benchmark).
    Returns ``(state, z, chunk, dx)``: ``state = (u, v, w, b)`` on the
    device, ``chunk(state, dt) -> (state, umax)`` with ``umax`` a 0-d device
    tensor.  With ``mesh`` the state is this rank's x-slab (``N[0]`` must
    divide by the mesh size), ``umax`` the maximum over the ranks, and
    ``chunk`` exchanges halos and transposes the FFTs (every rank of the
    mesh calls it).

    ``bc="periodic"`` (default) is the one-FFT fully periodic slab;
    ``bc="rigid_lid"`` matches the reference tank's bounded z
    (``rayleigh_taylor_instability_3d.jl:23-32``): free-slip no-penetration
    lids for velocity, no-flux for buoyancy, with the wall-bounded pressure
    solve done by the image-charge FFT (:func:`_project_rigid`)."""
    assert bc in ("periodic", "rigid_lid"), bc
    device = torch.device(device)
    rigid = bc == "rigid_lid"
    Nx, Ny, Nz = N
    slab = _Slab(mesh, mesh_axis, Nx, device)
    dx = (L[0] / Nx, L[1] / max(Ny, 1), L[2] / Nz)
    kw = dict(dtype=dtype, device=device)
    x = (-L[0] / 2 + (torch.arange(Nx, **kw) + 0.5) * dx[0])[slab.rows]
    z = -L[2] / 2 + (torch.arange(Nz, **kw) + 0.5) * dx[2]
    zz = z[None, None, :]
    xx = x[:, None, None]
    interface = 0.05 * torch.sin(6 * np.pi * xx)
    # smooth tanh interface (width ~2 cells) instead of the reference's sharp
    # sign jump: a sharp jump on a centered-difference grid rings at the
    # Nyquist mode; the tanh is the grid-resolvable version of the same IC
    b = -b_amp * torch.tanh((zz - interface) / (2 * dx[2])) * torch.ones((1, Ny, 1), **kw)
    if key is not None:
        b = b + _noise(key, (Nx, Ny, Nz), dtype, device, 1e-4, slab.rows)
    u = torch.zeros_like(b)
    v = torch.zeros_like(u)
    w = torch.zeros_like(u)

    nz_sp = 2 * Nz if rigid else Nz  # doubled image grid for rigid lids
    lz_sp = 2.0 * L[2] if rigid else L[2]
    kx = _wavenumbers(Nx, L[0], dtype, device)
    ky = _wavenumbers(Ny, L[1], dtype, device)
    kz = _wavenumbers(nz_sp, lz_sp, dtype, device)
    fft = None
    if mesh is not None:  # the spectra are (Nx, Ny, this rank's z-range)
        fft = _SlabFFT(mesh, u.shape[0], nz_sp)
        kz = kz[fft.z_slice]
    shape = (Nx, Ny, kz.shape[0])
    kx = kx[:, None, None] * torch.ones((1,) + shape[1:], **kw)
    ky = ky[None, :, None] * torch.ones((shape[0], 1, shape[2]), **kw)
    kz = kz[None, None, :] * torch.ones(shape[:2] + (1,), **kw)
    project = _project_rigid if rigid else _project

    def tend(u, v, w, b):
        xu, xv, xw, xb = slab.neighbours([u, v, w, b])
        if rigid:
            du = _adv_bounded_z(u, u, v, w, dx, 1.0, xu) + nu * _lap_neumann_z(u, dx, xu)
            dv = _adv_bounded_z(v, u, v, w, dx, 1.0, xv) + nu * _lap_neumann_z(v, dx, xv)
            dw = (_adv_bounded_z(w, u, v, w, dx, -1.0, xw) + nu * _lap_dirichlet_z(w, dx, xw)
                  + b)
            db = _adv_bounded_z(b, u, v, w, dx, 1.0, xb) + kappa * _lap_neumann_z(b, dx, xb)
        else:
            du = _adv(u, u, v, w, dx, xu) + nu * _lap_periodic(u, dx, xu)
            dv = _adv(v, u, v, w, dx, xv) + nu * _lap_periodic(v, dx, xv)
            dw = _adv(w, u, v, w, dx, xw) + nu * _lap_periodic(w, dx, xw) + b
            db = _adv(b, u, v, w, dx, xb) + kappa * _lap_periodic(b, dx, xb)
        return du, dv, dw, db

    def chunk(state, dt):
        u, v, w, b = state
        for _ in range(ni):
            # Heun step + projection
            d1 = tend(u, v, w, b)
            d2 = tend(u + dt * d1[0], v + dt * d1[1], w + dt * d1[2], b + dt * d1[3])
            u2 = u + 0.5 * dt * (d1[0] + d2[0])
            v2 = v + 0.5 * dt * (d1[1] + d2[1])
            w2 = w + 0.5 * dt * (d1[2] + d2[2])
            b = b + 0.5 * dt * (d1[3] + d2[3])
            u, v, w = project(u2, v2, w2, kx, ky, kz, fft)
        umax = torch.maximum(torch.max(torch.abs(u)),
                             torch.maximum(torch.max(torch.abs(v)), torch.max(torch.abs(w))))
        return (u, v, w, b), slab.max(umax)

    return (u, v, w, b), z, chunk, dx


def _step_seconds(chunk, state, dt, ni, repeats, device):
    """Seconds per step of ``chunk``: one warm-up call, then the minimum over
    ``repeats`` timed calls (CUDA events on a card, the host clock on the
    CPU), divided by ``ni``."""
    chunk(state, dt)
    best = float("inf")
    for _ in range(repeats):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = chunk(state, dt)
            end.record()
            end.synchronize()
            secs = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            out = chunk(state, dt)
            secs = time.perf_counter() - t0
        del out
        best = min(best, secs)
    return best / ni


def tracer_step_seconds(N: int = 128, ni: int = 50, repeats: int = 5,
                        dtype=torch.float32, mesh=None, device="cuda"):
    """Steady-state seconds per forced-tracer Heun step at the reference's
    128³ grid (``advection_diffusion_3d.jl:11-16``: N=128, κ=0.05; the
    reference commits no timing for this generator).  ``mesh`` times the
    x-decomposed chunk over the mesh's axis (this rank's time)."""
    device = torch.device(device)
    slab = _Slab(mesh, None, N, device)
    c, chunk, _ = _tracer_chunk(N, 1.0, 0.05, ni, dtype, device, slab)
    return _step_seconds(chunk, c, torch.tensor(1e-4, dtype=dtype, device=device), ni,
                         repeats, device)


def rt_step_seconds(N: Tuple[int, int, int] = (128, 2, 128), ni: int = 10, repeats: int = 5,
                    dtype=torch.float32, bc: str = "periodic", mesh=None, device="cuda"):
    """Steady-state seconds per RT solver step at the reference's grid.

    Reference: ≈7-10 ms/step at 128×2×128 after warm-up
    (``Climate/DataGeneration/output.txt`` progress lines).  ``bc="rigid_lid"``
    times the image-charge-FFT wall-bounded variant instead; ``mesh`` the
    chunk x-decomposed over the mesh's axis (this rank's time)."""
    device = torch.device(device)
    state, _, chunk, _ = _rt_stepper(N, (1.0, N[1] / N[0], 1.0), 1e-4, 1e-4, 1.0, ni, None,
                                     dtype, mesh=mesh, mesh_axis=None, bc=bc, device=device)
    return _step_seconds(chunk, state, torch.tensor(1e-4, dtype=dtype, device=device), ni,
                         repeats, device)


def rayleigh_taylor_3d(
    N: Tuple[int, int, int] = (64, 4, 64),
    L: Tuple[float, float, float] = (1.0, 0.0625, 1.0),
    nu: float = 1e-4,
    kappa: float = 1e-4,
    b_amp: float = 1.0,
    end_time: float = 2.0,
    save_every: float = 0.1,
    cfl: float = 0.2,
    ni: int = 10,
    key=None,
    dtype=torch.float32,
    mesh=None,
    mesh_axis: str = "x",
    bc: str = "periodic",
    device="cuda",
):
    """Buoyancy-driven RT mixing; returns (save_ts, z, b_profiles (T, Nz)) as
    numpy arrays.

    The reference's 128×2×128 slab (``:13-15``) at configurable resolution
    on the centered domain (−L/2, L/2): interface ``0.05·sin(6πx)`` with
    b=+1 below / −1 above (``:39-43``), ν=κ=1e-4 (``:18-19``), horizontal
    b̄(z) averages on the save grid (``:60-76``).  ``bc="rigid_lid"``
    reproduces the reference tank's bounded z (``:23-32``).  ``mesh``
    decomposes the slab along x over ``mesh_axis`` (see :func:`_rt_stepper`);
    every rank returns the profiles.
    """
    state, z, chunk, dx = _rt_stepper(N, L, nu, kappa, b_amp, ni, key, dtype, mesh=mesh,
                                      mesh_axis=mesh_axis, bc=bc, device=device)
    device = z.device
    slab = _Slab(mesh, mesh_axis, N[0], device)
    Ny = N[1]
    min_dx = min(dx[0], dx[2]) if Ny <= 4 else min(dx)
    # buoyancy free-fall CFL: velocities reach ~sqrt(b·Δx) within a cell
    # before the velocity-based CFL can see them — bound dt by it up front
    buoy_dt = cfl * (min_dx / max(b_amp, 1e-12)) ** 0.5
    diff_dt = 0.2 * min_dx**2 / (6.0 * max(nu, kappa))
    # cap the chunk's span at save_every: the loop saves at most one profile
    # per chunk, so an adaptively grown dt would otherwise skip save points
    dt_save_cap = save_every / ni
    t, dt = 0.0, min(1e-4, buoy_dt, diff_dt, dt_save_cap)
    save_ts, profiles = [], []
    next_save = 0.0
    while t < end_time:
        if t >= next_save:
            save_ts.append(t)
            profiles.append(slab.hmean(state[3]).cpu().numpy())
            next_save += save_every
        state, umax = chunk(state, torch.tensor(dt, dtype=dtype, device=device))
        t += ni * dt
        adv_dt = cfl * min_dx / max(float(umax), 1e-6)
        dt = min(dt * 1.2, adv_dt, buoy_dt, diff_dt, dt_save_cap)
    save_ts.append(t)
    profiles.append(slab.hmean(state[3]).cpu().numpy())
    return np.asarray(save_ts), z.cpu().numpy(), np.stack(profiles)


def coarse_grain(profile, factor: int):
    """Block-average a vertical profile (``coarse_grain``,
    ``neural_pde_rayleigh_taylor_instability.jl:55-66``); numpy arrays or
    tensors."""
    n = profile.shape[-1]
    assert n % factor == 0
    return profile.reshape(*profile.shape[:-1], n // factor, factor).mean(-1)
