"""The replayed dycore dt: ``make_dycore_stepper(...)``'s ``run(state,
phis, 1)`` back to back, the state carried from one dt to the next (in
its own buffers where the configuration donates it).

Inputs (made here from the seed, on the device, as the repository's
``benchmark_state`` makes bench.py's state, with a large-scale
perturbation besides): the rest state on the hybrid coordinate (surface
pressure 1e5 Pa, theta from a 285 K isothermal-Exner profile, zero
winds); pt perturbed by ``pt_waves`` large-scale modes of the traffic's
``pt_wave_k`` and a unit-normal field times ``pt_noise_k``; w = 0 and
hydrostatic delz; each tracer ``tracer_max`` times (1 + modes) / 2, of
``tracer_waves`` large-scale modes of its own.  phis = 0.  The modes
keep the flow and w moving all through a run, so that a dt late in the
window changes the state by more than float32 rounding; the tracers are
smooth, as a model's are, where white noise would make every cell an
extremum of the remap's and the transport's limiters.

The check, once the window has closed and the program's peak memory has
been read: one dt of the window (or of the traced stretch after it),
drawn from the seed uniformly among all the dts issued, by reservoir
sampling as they are issued; and the first dt from the seed's state (a
replay of the same graph after the window).  Each is held against the
plain reference's dt from the same input (``compare.gaps``: ``later_*``
and ``first_*``).  The reference builds its own grid, metrics and
coefficients from the configuration.
"""

from __future__ import annotations

import gc
import math
import random

import torch

from portbench.compare import gaps
from portbench.reference import hydro as ref
from portbench.reference.geometry import cell_centers, gnomonic_grid


def scheme(cfg) -> dict:
    return {k: cfg[k] for k in ("k_split", "n_split", "hord", "kord",
                                "d2_damp", "ptop")}


def large_scale_modes(n: int, nz: int, modes: int, gen, device):
    """`modes` modes, each a plane wave over the cells' unit vectors
    (wavenumber 1 to 4 a radius, direction and phase from `gen`) times a
    vertical cosine (1 to 3 half waves over the column), summed and
    scaled to a largest magnitude of 1: [6, nz, n, n] float64."""
    r = torch.as_tensor(cell_centers(gnomonic_grid(n)), device=device)
    lev = torch.linspace(0.0, 1.0, nz, dtype=torch.float64,
                         device=device).view(1, nz, 1, 1)
    k = torch.randn((modes, 3), generator=gen, dtype=torch.float64,
                    device=device)
    k = k / k.norm(dim=1, keepdim=True) * (1.0 + 3.0 * torch.rand(
        (modes, 1), generator=gen, dtype=torch.float64, device=device))
    phase = 2 * math.pi * torch.rand((modes, 2), generator=gen,
                                     dtype=torch.float64, device=device)
    half_waves = torch.randint(1, 4, (modes,), generator=gen, device=device)
    f = torch.zeros((6, nz, n, n), dtype=torch.float64, device=device)
    for j in range(modes):
        f += (torch.sin(r @ k[j] + phase[j, 0]).unsqueeze(1)
              * torch.cos(math.pi * half_waves[j] * lev + phase[j, 1]))
    return f / f.abs().max()


def initial_state(cfg, traffic, seed: int, device, dtype=torch.float32):
    """The seed's input state (a ``reference.hydro.DycoreState``)."""
    n, nz, ptop = cfg["resolution"], cfg["nz"], cfg["ptop"]
    ak, bk = ref.hybrid_coefficients(nz, ptop)
    pe = ak + bk * 1e5  # float64 profiles of nz + 1 interfaces
    pik = (pe / ref.REFERENCE_SURFACE_PRESSURE) ** ref.KAPPA
    theta = 285.0 / (0.5 * (pik[1:] + pik[:-1]))

    def column(a):
        return (a.to(torch.float32).to(device).view(1, nz, 1, 1)
                .expand(6, nz, n, n).contiguous())

    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 63)
    delp = column(pe[1:] - pe[:-1])
    waves = large_scale_modes(n, nz, traffic["pt_waves"], gen, device)
    pt = (column(theta) + traffic["pt_wave_k"] * waves.float()
          + traffic["pt_noise_k"] * torch.randn(
              (6, nz, n, n), generator=gen, device=device))
    q = torch.stack([
        0.5 * traffic["tracer_max"] * (1.0 + large_scale_modes(
            n, nz, traffic["tracer_waves"], gen, device).float())
        for _ in range(cfg["ntracers"])])
    pe_f = ptop + torch.cat(
        [torch.zeros_like(delp[:, :1]), torch.cumsum(delp, dim=1)], dim=1)
    delz = ref.hydrostatic_dz(delp, pt, pe_f)
    zeros = torch.zeros_like(delp)
    st = ref.DycoreState(
        delp, pt, torch.zeros((6, nz, n + 1, n), device=device),
        torch.zeros((6, nz, n, n + 1), device=device), q, zeros, delz)
    return ref.DycoreState(*(x.to(dtype) for x in st))


class Entry:
    """Set-up (the stepper and the seed's state) in the constructor; the
    window calls ``prepare`` (the harness's own work) and ``step`` (the
    program's call)."""

    def __init__(self, cfg, traffic, seed: int, device):
        from fv3net_tpu_torch.dycore.hydro import (
            DycoreState, make_dycore_stepper)
        from fv3net_tpu_torch.grid.geometry import CubedSphereGrid
        from fv3net_tpu_torch.ops import advection

        self.cfg, self.traffic = cfg, traffic
        self.device = device
        self.dt_seconds = cfg["dt_atmos"]
        self.donate = cfg["donate"]
        advection.set_fused_transport(cfg["fused_transport"])
        self.run, _, _ = make_dycore_stepper(
            CubedSphereGrid.make(cfg["resolution"], halo=cfg["halo"]),
            cfg["nz"], cfg["dt_atmos"], dtype=torch.float32,
            donate=self.donate, device=device, **scheme(cfg))
        self.program_state = DycoreState
        self.phis = torch.zeros(
            (6, cfg["resolution"], cfg["resolution"]), device=device)
        self.restart(seed)
        if self.donate:
            # where the dts overwrite their input, the two states are
            # copied to the host, outside the device memory counted
            pin = device.type == "cuda"
            self.buffers = [[torch.empty(t.shape, dtype=t.dtype,
                                         pin_memory=pin)
                             for t in self.state] for _ in range(2)]

    def restart(self, seed: int):
        """The seed's state, and no dt drawn yet."""
        self.seed = seed
        self.state = self._program(initial_state(
            self.cfg, self.traffic, seed, self.device))
        # the checked dt: its input and output, drawn as the dts come
        self.draw = random.Random(seed)
        self.kept_in = self.kept_out = None
        self.pending = False

    def _program(self, st):
        return self.program_state(*st)

    def _keep(self, which):
        """The state as it stands: itself where the dts leave their input
        untouched, else a copy into a host buffer made in set-up."""
        if not self.donate:
            return self.state
        for dst, src in zip(self.buffers[which], self.state):
            dst.copy_(src, non_blocking=True)
        return self.buffers[which]

    def prepare(self, i=None):
        """Before dt `i` of the window (None in the warm-up): keep the
        output of the dt drawn before it, then draw dt `i` with chance
        1 / (i + 1), which leaves each dt issued so far drawn alike."""
        if i is None:
            return
        if self.pending:
            self.kept_out, self.pending = self._keep(1), False
        if self.draw.randrange(i + 1) == 0:
            self.kept_in, self.kept_out = self._keep(0), None
            self.pending = True

    def step(self):
        self.state = self.run(self.state, self.phis, 1)

    def outputs(self):
        """After the window: [(name, input, program's output)] of the
        drawn dt (``later``; its output is the state itself where no dt
        followed it) and of a replay of the first dt from the seed's
        state (``first``), as ``reference.hydro.DycoreState``s on the
        device."""
        if self.kept_in is None:
            raise RuntimeError("no dt of the window was drawn")

        def device_copy(st):
            return ref.DycoreState(*(t.to(self.device, copy=True)
                                     for t in st))

        later_in = device_copy(self.kept_in)
        later = device_copy(self.state if self.pending else self.kept_out)
        start = initial_state(self.cfg, self.traffic, self.seed, self.device)
        first = device_copy(self.run(self._program(start), self.phis, 1))
        return [("first", start, first), ("later", later_in, later)]

    def free(self):
        """Drop the program's stepper and state."""
        del self.run, self.state, self.kept_in, self.kept_out
        self.buffers = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """The compared numbers (module docstring)."""
        pairs = self.outputs()
        self.free()
        one_dt, _ = reference_dt(self.cfg, torch.float32, self.device)
        out = {}
        for name, x, got in pairs:
            out.update(gaps(name, got, one_dt(x, self.phis)))
        return out


def reference_dt(cfg, dtype, device):
    """The plain reference's dt in `dtype` (float32 on the card with
    TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    one_dt, m = ref.make_one_dt(
        cfg["resolution"], cfg["nz"], cfg["halo"], cfg["dt_atmos"],
        dtype=dtype, device=device, **scheme(cfg))

    def dt(state, phis):
        x = ref.DycoreState(*(t.to(dtype) for t in state))
        with torch.no_grad():
            y = one_dt(x, phis.to(dtype))
        return ref.DycoreState(*(t.to(torch.float32) for t in y))

    return dt, m
