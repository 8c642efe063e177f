"""The f32 spread of one eager wrapper step under 1-ulp input changes.

chip_smoke.py holds the card's f32 step against the CPU's by
fv3net_tpu_torch.parity.f32_rule: within F32_FACTOR of the CPU f32
step's distance from the float64 step.  These CPU cases measure what a
1-ulp change of every input does to the CPU's own f32 step, at the size
and from the seeded inputs of chip_smoke's phase 10 (C12 x 63, the
simple suite and Held-Suarez with the "none" suite):

- smooth winds and humidity without a cap: every perturbed f32 step
  stays within the rule, which can therefore hold the card there;
- white-noise winds and humidity clipped flat at 20 g/kg: some perturbed
  f32 step leaves the rule (a limiter or a threshold on a tie), so the
  card is held there by the spread of the perturbed steps instead.

Each case prints the spread, field by field (``pytest -s``).
"""

import numpy as np
import pytest

from fv3net_tpu_torch import parity

N, NZ = 12, 63
SUITES = {
    "simple": {},
    "held_suarez": {"do_held_suarez": True, "physics_suite": "none"},
}


def _runs(suite, noisy):
    """(f64, f32, [f32 from each 1-ulp perturbation]) of one step."""
    config = SUITES[suite]
    inputs = parity.moist_inputs(N, NZ, noisy=noisy)
    ref64, plain32 = (
        parity.wrapper_step(N, NZ, "cpu", dtype, config, inputs)
        for dtype in ("float64", "float32")
    )
    perturbed = [
        parity.wrapper_step(N, NZ, "cpu", "float32", config,
                            parity.perturb_ulp(inputs, seed))
        for seed in range(parity.SPREAD_RUNS)
    ]
    return ref64, plain32, perturbed


def _report(tag, ref64, plain32, perturbed):
    """Each perturbed step against the rule of the unperturbed f32 step:
    {field: [(max|perturbed - f64|, bound)]}, printed."""
    out, plain = {}, {}
    for run in perturbed:
        for k, (err, bound, _, errs, finite) in parity.f32_rule(
                run, [plain32], ref64).items():
            assert finite, (tag, k)
            out.setdefault(k, []).append((err, bound))
            plain[k] = errs[0]
    for k, pairs in out.items():
        print(f"{tag} {k:12s} max|cpu32-f64| {plain[k]:.3e} "
              f"max|perturbed-f64| {[f'{e:.3e}' for e, _ in pairs]} "
              f"bound {pairs[0][1]:.3e}")
    return out


@pytest.mark.parametrize("suite", sorted(SUITES))
def test_smooth_inputs_stay_within_the_f32_rule(suite):
    ref64, plain32, perturbed = _runs(suite, noisy=False)
    if suite == "simple":
        assert float(ref64["total_precip"].max()) > 0.0
    out = _report(f"{suite} smooth", ref64, plain32, perturbed)
    for k, pairs in out.items():
        for err, bound in pairs:
            assert err <= bound, (k, err, bound)


@pytest.mark.parametrize("suite", sorted(SUITES))
def test_noisy_inputs_leave_the_f32_rule(suite):
    ref64, plain32, perturbed = _runs(suite, noisy=True)
    out = _report(f"{suite} noisy", ref64, plain32, perturbed)
    outside = {k for k, pairs in out.items()
               if any(err > bound for err, bound in pairs)}
    # white-noise winds put the transport's limiter on a tie (u), the
    # flat cap or the noise the tracer's (q)
    assert {"u", "q"} <= outside, outside


def test_perturb_ulp_moves_every_value_by_one_ulp():
    inputs = parity.moist_inputs(4, 8, noisy=True)
    moved = parity.perturb_ulp(inputs, 0)
    assert moved.keys() == inputs.keys()
    for k, q in inputs.items():
        a = np.asarray(q.values, dtype=np.float32)
        b = np.asarray(moved[k].values)
        up = np.nextafter(a, np.float32(np.inf))
        down = np.nextafter(a, np.float32(-np.inf))
        assert b.dtype == np.float32, k
        assert np.all((b == up) | (b == down)), k
        assert 0.3 < np.mean(b == up) < 0.7, k
