"""fv3net's ML-corrected coupled step: ``wrapper.initialize`` with the
configuration's ``ModelConfig``, the dense corrector through
``fit.load``, and ``CompiledTimeLoop(wrapper, model).step()`` back to
back, the state carried from one step to the next in the step's own
buffers (the loop donates it).

Set-up: the corrector is fv3fit's dense model at the configuration's
depth and width, written from the seed in plain numpy in the layout
``fit.dump`` writes (``write_corrector``) under the process's temporary
directory, and read by the program through ``fit.load`` and by the
reference straight from its files (the check then removes it).  No
trained fv3net model is in the repository, and nothing the program
computes goes into the numbers both sides read.

Inputs (made here from the seed, on the device): the hybrid coordinate
at a surface pressure of 1e5 Pa; temperature falling at the traffic's
lapse rate from a surface value of ``t_surface_k`` +
``t_surface_pole_to_equator_k`` cos^2(lat), isothermal above
``tropopause_pa``, plus ``pt_waves`` large-scale modes of ``pt_wave_k``
and a unit-normal field times ``pt_noise_k`` (the dycore cell's); water
vapour at a relative humidity of ``rh_low`` below ``rh_low_top_pa``,
falling linearly in pressure to ``rh_high`` at ``rh_high_pa`` and held
above; each of the five condensate species ``hydrometeor_max`` times (1 +
large-scale modes) / 2 below ``hydrometeor_top_pa`` and 0 above; each
of the three passive tracers of FV3's field table (``passive_tracers``:
o3mr, sgs_tke, cld_amt, which the suite has no scheme for, so the
dycore transports and remaps them and physics leaves them alone) its
scale times (1 + large-scale modes) / 2; tsfc the lowest layer's
temperature plus ``tsfc_excess_k`` and ``tsfc_wave_k`` times
large-scale modes; winds at rest, w = 0,
hydrostatic delz, phis = 0.  The surface temperature is held (no land
model).

The check, once the window has closed: one step of the window (or of the
traced stretch after it), drawn from the seed uniformly among all the
steps issued, by reservoir sampling as they are issued, and the first
step from the seed's state (a replay of the same graph after the
window).  Each is held against the plain reference's coupled step
(``reference/coupled.py``) from the same state, surface temperature,
accumulated precipitation and time, field by field, by the gap

    gap = ||program - reference|| / ||reference||,

the 2-norms over the whole field (``norm_gap``): the state's fields,
each tracer on its own (``TRACERS``: the six water species ``qv``,
``ql``, ``qi``, ``qr``, ``qs``, ``qg`` and the passive three; water
vapour outweighs the condensates a hundredfold, so one norm over all
six would not see the microphysics).  A condensate species is measured
against the reference's whole condensate, ``||ql + qi + qr + qs +
qg||``, not against itself: snow comes and goes with a threshold on
ice, and where the reference holds none or a trace of it, its own norm
would read a speck of snow in one column as the whole field's error.
At dt 900 s rain and graupel, and in the first step the seeded snow,
fall out of every layer within the step, so both sides leave none in
the air, the gap reads 0 and its limit is 0.  The drawn step's snow is
not compared: what stays aloft is made from ice in the thick upper
layers, from none to 2e-4 kg/kg as the seed and step go, and its gap
swings with it (on the card, 0-2.3e-6 against the bfloat16 control's
9e-6-1.2e-2 in eight seeds), so no one limit lies between the two with
room; the snow that reaches the ground is in ``later_precip``, the ice
it comes from in ``later_qi``.  Besides the state: the
step's precipitation rate
(``first_precip``, ``later_precip``) and, of the first step, the
corrector's tendencies after the limiter (``first_dQ1``, ``first_dQ2``:
the postphysics Monitor's; the corrector moves the state by less than
the dycore's float32 rounding, so the state alone would not see it).
The drawn step's tendencies are not compared: a column whose physics
switched otherwise feeds the corrector a profile kelvins apart, and the
drawn step has flipped columns enough that its tendencies' gap (0.4-1.6%
in six seeds on the card) lies within a factor of three of the
bfloat16 control's (4.6-14%), too near to set a limit with room.  The
corrector is one part of the graph every step replays, and the first
step holds it.  The dycore cell's widest-point gap
(``compare.gap``) does not serve here: the suite switches on thresholds
(the SAS trigger and cloud top, the PBL's Richardson number, GFDL's
freezing and melting), so the dycore kernels' float32 rounding, against
the reference's plain operations, flips a switch in a few columns and
moves those columns by kelvins; the widest point then reads the flip,
which a sound program makes, and not the program.  A norm over the field
weighs a few flipped columns by their share.  The check
prints on standard error the device log's dropped entries and, of the
drawn step, the share of columns in which SAS fired and in which the
GFDL ice phases (ice, snow, graupel) exceed 1e-9 kg/kg in some layer.
"""

from __future__ import annotations

import gc
import json
import math
import os
import random
import shutil
import sys
import tempfile

import numpy as np
import torch

from portbench.compare import FIELDS
from portbench.entries.dycore import large_scale_modes
from portbench.reference import hydro as ref
from portbench.reference.coupled import (
    CoupledStep,
    pressure_layers,
    pt_from_temperature,
    temperature_from_pt,
)
from portbench.reference.geometry import CubedSphereGrid
from portbench.reference.physics import qsat
from portbench.window import synchronize

RD_GRAV = 287.05 / 9.80665  # m/K, the scale of the lapse-rate profile


def model_config(cfg) -> dict:
    """The ``wrapper.ModelConfig`` keys of the configuration."""
    return dict(
        npx=cfg["resolution"] + 1, npz=cfg["nz"], dt_atmos=cfg["dt_atmos"],
        k_split=cfg["k_split"], n_split=cfg["n_split"], hord=cfg["hord"],
        kord=cfg["kord"], ptop=cfg["ptop"], hydrostatic=False,
        physics_suite=cfg["physics_suite"],
        microphysics_scheme=cfg["microphysics_scheme"],
        prognostic_mp_tracers=True,
        convection_scheme=cfg["convection_scheme"],
        do_radiation=cfg["do_radiation"], dtype=cfg["dtype"],
        initial_time=cfg["initial_time"])


def initial_state(cfg, traffic, seed: int, device, dtype=torch.float32):
    """The seed's (state, tsfc): a ``reference.hydro.DycoreState`` whose
    q holds the six water species and then the traffic's passive tracers
    (``TRACERS``), and the surface temperature [6, n, n]."""
    n, nz, ptop = cfg["resolution"], cfg["nz"], cfg["ptop"]
    ak, bk = ref.hybrid_coefficients(nz, ptop)
    pe = (ak + bk * 1e5).to(device)  # float64 interfaces
    delp = (pe[1:] - pe[:-1]).view(1, nz, 1, 1).expand(6, nz, n, n)
    p = 0.5 * (pe[1:] + pe[:-1]).view(1, nz, 1, 1)
    g = CubedSphereGrid.make(n, halo=cfg["halo"])
    lat = torch.as_tensor(g.lat[g.interior], device=device).view(6, 1, n, n)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 63)

    def modes(levels, count):
        return large_scale_modes(n, levels, count, gen, device)

    t_sfc = (traffic["t_surface_k"]
             + traffic["t_surface_pole_to_equator_k"] * torch.cos(lat) ** 2)
    # T = T_s (p / p_s)^(R Gamma / g) for a constant lapse rate Gamma
    expo = RD_GRAV * traffic["lapse_k_per_km"] * 1e-3
    temp = t_sfc * (torch.clamp_min(p, traffic["tropopause_pa"])
                    / 1e5) ** expo
    temp = (temp + traffic["pt_wave_k"] * modes(nz, traffic["pt_waves"])
            + traffic["pt_noise_k"] * torch.randn(
                (6, nz, n, n), generator=gen, dtype=torch.float64,
                device=device))
    frac = ((traffic["rh_low_top_pa"] - p)
            / (traffic["rh_low_top_pa"] - traffic["rh_high_pa"]))
    rh = traffic["rh_low"] + (traffic["rh_high"] - traffic["rh_low"]) * (
        torch.clip(frac, 0.0, 1.0))
    qv = rh * qsat(temp, p)
    below = (p > traffic["hydrometeor_top_pa"]).to(torch.float64)
    condensate = [0.5 * traffic["hydrometeor_max"] * (1.0 + modes(
        nz, traffic["tracer_waves"])) * below for _ in range(5)]
    q = torch.stack([qv] + condensate)
    delp = delp.contiguous()
    pt = pt_from_temperature(delp, temp, qv, ptop)
    pe_full, _ = pressure_layers(delp, ptop)
    delz = ref.hydrostatic_dz(delp, pt, pe_full)
    tsfc = (temp[:, -1] + traffic["tsfc_excess_k"]
            + traffic["tsfc_wave_k"] * modes(1, traffic["pt_waves"])[:, 0])
    passive = [0.5 * scale * (1.0 + modes(nz, traffic["tracer_waves"]))
               for scale in traffic["passive_tracers"].values()]
    if passive:
        q = torch.cat([q, torch.stack(passive)])
    if q.shape[0] != cfg["ntracers"]:
        raise ValueError(f"the traffic makes {q.shape[0]} tracers, the "
                         f"configuration carries {cfg['ntracers']}")
    zeros = torch.zeros_like(delp)
    st = ref.DycoreState(
        delp, pt, torch.zeros((6, nz, n + 1, n), dtype=torch.float64,
                              device=device),
        torch.zeros((6, nz, n, n + 1), dtype=torch.float64, device=device),
        q, zeros, delz)
    return (ref.DycoreState(*(x.to(dtype).contiguous() for x in st)),
            tsfc.to(dtype).contiguous())


def write_corrector(path: str, cfg, state, seed: int) -> str:
    """fv3fit's dense model of the configuration (``cfg["corrector"]``),
    written under `path` in plain numpy in the layout ``fit.dump``
    writes (``name``, ``meta.json``, ``params.npy``, ``packer_{in,out}.
    json``, ``scaler_{in,out}.npz``):

    * the input scaler from the seed's `state`: each input level's mean
      over the columns, and one standard deviation an input over all of
      its points (a level's spread over the columns is a few kelvins, or
      nothing of humidity high up, and the run's state drifts farther);
    * the MLP's weights drawn from the seed, He's normal for the ReLU
      layers and a unit gain for the last, the biases zero;
    * the output scaler: mean zero, standard deviation ``dQ1_std`` (K/s)
      at every level and ``dQ2_std`` (1/s) times each level's mean
      humidity over the moistest level's."""
    corr, nz = cfg["corrector"], cfg["nz"]
    qv = state.q[0].double()
    fields = {"air_temperature": temperature_from_pt(
        state.delp.double(), state.pt.double(), qv, cfg["ptop"]),
        "specific_humidity": qv}
    cols = {k: torch.movedim(v, 1, -1).reshape(-1, nz).cpu().numpy()
            for k, v in fields.items()}
    ins, outs = corr["inputs"], corr["outputs"]
    mean_in = np.concatenate([cols[k].mean(axis=0) for k in ins])
    std_in = np.concatenate([np.full(nz, cols[k].std()) for k in ins])
    qv_mean = cols["specific_humidity"].mean(axis=0)
    std_out = {"dQ1": np.full(nz, corr["dQ1_std"]),
               "dQ2": corr["dQ2_std"] * qv_mean / qv_mean.max()}
    widths = [corr["width"]] * corr["depth"]
    sizes = [nz * len(ins)] + widths + [nz * len(outs)]
    rng = np.random.default_rng(seed % 2 ** 63)
    flat = []
    # flax's Dense_0, Dense_1, ...: each bias, then its kernel [in, out]
    for j, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        gain = 2.0 if j < len(widths) else 1.0
        flat += [np.zeros(b), rng.normal(0.0, math.sqrt(gain / a),
                                         (a, b)).ravel()]
    f32 = np.float32
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "name"), "w") as f:
        f.write("dense")
    np.save(os.path.join(path, "params.npy"),
            np.concatenate(flat).astype(f32))
    for which, names in (("in", ins), ("out", outs)):
        with open(os.path.join(path, f"packer_{which}.json"), "w") as f:
            json.dump({"names": names,
                       "feature_counts": {k: nz for k in names}}, f)
    np.savez(os.path.join(path, "scaler_in.npz"), mean=mean_in.astype(f32),
             std=std_in.astype(f32))
    np.savez(os.path.join(path, "scaler_out.npz"),
             mean=np.zeros(sizes[-1], f32),
             std=np.concatenate([std_out[k] for k in outs]).astype(f32))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"input_variables": ins, "output_variables": outs,
                   "widths": widths, "n_out": sizes[-1],
                   "n_in": sizes[0]}, f)
    return path


class Entry:
    """Set-up (the wrapper, the corrector, the loop and the seed's state)
    in the constructor; the window calls ``prepare`` (the harness's own
    work) and ``step`` (the program's call)."""

    def __init__(self, cfg, traffic, seed: int, device):
        from fv3net_tpu_torch import fit, wrapper
        from fv3net_tpu_torch.dycore.hydro import DycoreState
        from fv3net_tpu_torch.runtime.compiled_loop import CompiledTimeLoop

        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.dt_seconds = cfg["dt_atmos"]
        # first, so that a program without the configuration's options
        # refuses it at once
        config = wrapper.ModelConfig(**model_config(cfg))
        wrapper.initialize(config, device=device)
        self.mdl = wrapper.get_model()
        self.program_state = DycoreState
        self.t0 = self.mdl.time
        start = self.restart(seed)
        self.artifact = write_corrector(
            tempfile.mkdtemp(prefix="coupled_dense_"), cfg, start, seed)
        self.loop = CompiledTimeLoop(wrapper, fit.load(self.artifact,
                                                       device))
        # the states of the checked step are copied to the host, outside
        # the device memory counted
        pin = device.type == "cuda"
        self.buffers = [[torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
                         for t in self.mdl.state] for _ in range(2)]

    def restart(self, seed: int):
        """The seed's state at the configuration's start time, and no step
        drawn yet; returns the seed's state as ``initial_state`` made it."""
        self.seed = seed
        start, tsfc = initial_state(self.cfg, self.traffic, seed,
                                    self.device)
        self.tsfc = tsfc
        self._set(start, torch.zeros_like(tsfc), self.t0)
        if hasattr(self, "loop"):
            # the loop stages the model's tsfc once, when it is made
            self.loop._tsfc = tsfc
        self.draw = random.Random(seed)
        self.kept_in = self.kept_out = None
        self.pending = False
        return start

    def _set(self, st, total_precip, time):
        mdl = self.mdl
        mdl.state = self.program_state(*(t.clone() for t in st))
        mdl.tsfc = self.tsfc
        mdl.total_precip = total_precip
        mdl.time = time

    def _keep(self, which):
        """The state as it stands, copied into a host buffer made in
        set-up (the next step overwrites the device's)."""
        for dst, src in zip(self.buffers[which], self.mdl.state):
            dst.copy_(src, non_blocking=True)
        return self.buffers[which]

    def prepare(self, i=None):
        """Before step `i` of the window (None in the warm-up): keep the
        output of the step drawn before it, then draw step `i` with
        chance 1 / (i + 1), which leaves each step issued so far drawn
        alike."""
        if i is None:
            return
        mdl = self.mdl
        if self.pending:
            self.kept_out = self._outputs(self._keep(1))
            self.pending = False
        if self.draw.randrange(i + 1) == 0:
            self.kept_in = (self._keep(0), mdl.total_precip, mdl.time)
            self.kept_out = None
            self.pending = True

    def step(self):
        self.diags = self.loop.step()

    def _outputs(self, state) -> dict:
        """What the check compares of the step just issued: its state
        (`state`), precipitation rate and the corrector's tendencies (the
        step's own tensors, which later steps leave alone)."""
        out = {"state": state, "precip": self.mdl.precip_rate}
        out.update({k: self.diags[name].data
                    for k, name in TENDENCIES.items()})
        return out

    def outputs(self):
        """After the window: [(name, (state, total_precip, time), what
        ``compared`` takes)] of the drawn step (``later``) and of a
        replay of the first step from the seed's state (``first``), the
        states as ``reference.hydro.DycoreState``s on the device."""
        if self.kept_in is None:
            raise RuntimeError("no step of the window was drawn")
        mdl = self.mdl

        def device_copy(st):
            return ref.DycoreState(*(t.to(self.device, copy=True)
                                     for t in st))

        synchronize(self.device)
        st_in, tp_in, time_in = self.kept_in
        later_in = (device_copy(st_in), tp_in, time_in)
        later = (self._outputs(mdl.state) if self.pending
                 else self.kept_out)
        later = dict(later, state=device_copy(later["state"]))
        start, _ = initial_state(self.cfg, self.traffic, self.seed,
                                 self.device)
        tp0 = torch.zeros_like(self.tsfc)
        self._set(start, tp0, self.t0)
        self.step()
        first = self._outputs(device_copy(mdl.state))
        return [("first", (start, tp0, self.t0), first),
                ("later", later_in, later)]

    def check(self) -> dict:
        """The compared numbers (module docstring)."""
        from fv3net_tpu_torch import tracing

        pairs = self.outputs()
        print(f"coupled: device log dropped {tracing.dropped()} entries",
              file=sys.stderr)
        del self.loop, self.diags
        self.mdl.state = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        step = reference_step(self.cfg, self.artifact, torch.float32,
                              self.device)
        shutil.rmtree(self.artifact, ignore_errors=True)
        out = {}
        for name, (st, tp, time), got in pairs:
            want = step(st, self.tsfc, tp, time)
            out.update(compared(name, got, reference_outputs(want)))
            if name == "later":
                print(f"coupled: of the drawn step's columns, SAS fired in "
                      f"{share(want.diags['sas_fired'])} and ice phases "
                      f"exceed 1e-9 kg/kg in {ice_share(want.state)}",
                      file=sys.stderr)
        return out


# the corrector's tendencies as the check names them: the Monitor's
# tendencies due to the postphysics stage, dQ1 and dQ2 after the limiter
TENDENCIES = {
    "dQ1": "tendency_of_air_temperature_due_to_python",
    "dQ2": "tendency_of_specific_humidity_due_to_python",
}


def reference_outputs(y) -> dict:
    """What ``compared`` takes, of a reference step's output."""
    out = {"state": y.state, "precip": y.precip_rate}
    out.update({k: y.diags[name] for k, name in TENDENCIES.items()})
    return out


def norm_gap(got: torch.Tensor, want: torch.Tensor, of=None) -> float:
    """||got - want|| / ||of||, the 2-norms over the whole field in
    float64 (`of` the reference's field `want` unless given); infinity
    where either side is not finite."""
    got, want = got.detach().double(), want.detach().double()
    if not (bool(torch.isfinite(got).all())
            and bool(torch.isfinite(want).all())):
        return math.inf
    of = want if of is None else of.detach().double()
    scale = float(torch.linalg.vector_norm(of))
    diff = float(torch.linalg.vector_norm(got - want))
    if scale == 0.0:
        return 0.0 if diff == 0.0 else math.inf
    return diff / scale


# the tracers of the state's q, in its order: the wrapper's water species
# (sphum, liq_wat, ice_wat, rainwat, snowwat, graupel), then the passive
# tracers of the traffic (``initial_state``)
TRACERS = ("qv", "ql", "qi", "qr", "qs", "qg", "o3mr", "sgs_tke", "cld_amt")
# the condensate species, each measured against their sum
CONDENSATE = TRACERS[1:6]


def state_fields(st):
    """[(name, field)] of a state as the check compares it: the fields of
    ``compare.FIELDS``, with q split into its tracers (``TRACERS``)."""
    out = []
    for k in FIELDS:
        x = getattr(st, k)
        if k == "q":
            out += list(zip(TRACERS, x, strict=True))
        else:
            out.append((k, x))
    return out


def compared(name: str, got: dict, want: dict) -> dict:
    """The gaps of one step (``norm_gap``): ``<name>_<field>`` of each
    field of the state (``state_fields``; a condensate species against
    the reference's whole condensate; of the drawn step, no snow: module
    docstring), ``<name>_precip`` of the
    precipitation rate, and of the first step ``first_dQ1`` and
    ``first_dQ2`` of the corrector's tendencies."""
    want_fields = state_fields(want["state"])
    condensate = sum(w.double() for k, w in want_fields if k in CONDENSATE)
    out = {f"{name}_{k}": norm_gap(g, w, condensate if k in CONDENSATE
                                   else None)
           for (k, g), (_, w) in zip(state_fields(got["state"]),
                                     want_fields)
           if (name, k) != ("later", "qs")}
    numbers = ("precip",) + (tuple(TENDENCIES) if name == "first" else ())
    for k in numbers:
        out[f"{name}_{k}"] = norm_gap(got[k], want[k])
    return out


def share(mask) -> float:
    return float(mask.double().mean())


def ice_share(st) -> float:
    """The share of columns in which ice, snow or graupel exceeds 1e-9
    kg/kg in some layer."""
    ice = st.q[2] + st.q[4] + st.q[5]
    return share((ice > 1e-9).any(dim=1))


def reference_step(cfg, artifact, dtype, device):
    """The plain reference's coupled step in `dtype` (float32 on the card
    with TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return CoupledStep(cfg, artifact, dtype, device)

