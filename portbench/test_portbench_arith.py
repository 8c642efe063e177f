"""The benchmark's arithmetic on the CPU: the window's end-to-end numbers,
the traced intervals, the copied roofline bound and the operation
counter."""

import statistics
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import roofline  # noqa: E402
from portbench.opcount import OpCounter  # noqa: E402
from portbench.trace import Trace  # noqa: E402
from portbench.window import Window, p95, sdpd  # noqa: E402


def test_sdpd_counts_completed_steps_over_the_window():
    w = Window(steps=96, elapsed_s=4.8, step_ms=[50.0] * 96, host_ms=[])
    # 96 dts of 900 s in 4.8 s of wall time: 18,000 simulated days a day
    assert sdpd(w, 900.0) == 96 * 900.0 / 4.8 == 18000.0


def test_p95_is_over_every_step():
    values = [float(v) for v in range(1, 101)]
    assert p95(values) == statistics.quantiles(values, n=20)[-1] == 95.95
    # one slow step among many moves the tail, not the median
    assert p95([10.0] * 90 + [80.0] * 10) == 80.0


def test_union_of_device_intervals_and_idle_gaps():
    ops = [("a", 10.0, 30.0), ("b", 20.0, 40.0),  # overlapping: 10-40
           ("c", 50.0, 60.0), ("d", 55.0, 58.0),  # nested: 50-60
           ("e", 95.0, 130.0)]                    # clipped at 100
    spans = [("portbench.step", 0.0, 42.0), ("portbench.wait", 42.0, 100.0)]
    t = Trace(steps=2, window=(0.0, 100.0), ops=ops, spans=spans)
    assert t.busy_intervals() == [(10.0, 40.0), (50.0, 60.0), (95.0, 100.0)]
    assert abs(t.busy_s() - 45e-6) < 1e-15
    assert t.window_s == 100e-6
    gaps = t.idle_gaps()
    assert [name for name, _ in gaps] == [
        "portbench.step", "portbench.wait", "portbench.wait"]
    assert [round(s * 1e6, 9) for _, s in gaps] == [10.0, 10.0, 35.0]
    assert t.op_seconds()["e"] == 35e-6


def test_bound_equals_chip_smokes():
    import chip_smoke

    ins = [torch.zeros(6, 63, 54, 54) for _ in range(6)]
    ins += [torch.zeros(6, 54, 54) for _ in range(2)]
    outs = [torch.zeros(6, 63, 54, 54) for _ in range(2)]
    ops = chip_smoke.OPS_TP2D_CELL * outs[0].numel()
    want, _ = chip_smoke.bound(ins, outs, ops)
    nbytes = sum(t.numel() * t.element_size() for t in ins + outs)
    assert roofline.bound_ms(nbytes, ops) == want
    # the same launch as the K1 table entry counts it at C48x63
    cfg = {"resolution": 48, "nz": 63, "halo": 3}
    assert roofline.KERNELS["fv_tp_2d"][1](cfg) == want
    assert (roofline.HBM_BYTES_PER_S, roofline.F32_OPS_PER_S) == (
        chip_smoke.HBM_BYTES_PER_S, chip_smoke.F32_OPS_PER_S)


def test_kernel_names_follow_the_trace_names():
    import chip_smoke

    for kernel, (patterns, _) in roofline.KERNELS.items():
        assert patterns[0] == chip_smoke.TRACE_NAMES[kernel]
        assert roofline.kernel_of(f"void x::{patterns[0]}5>(Args)") == (
            kernel, True)
    assert roofline.kernel_of("void transport2<5>(Args)") == (
        "fv_tp_2d_multi5", False)
    assert roofline.kernel_of("void at::native::roll_cuda_kernel") == (
        None, False)


def test_op_counter_by_hand():
    x = torch.linspace(-1.0, 4.0, 10)
    with OpCounter() as c:
        y = (x * 2.0 + 1.0).clamp(0.0, 3.0)  # 10 + 10 + 2 x 10
        z = torch.where(y > 1.0, y, -y)      # compare 10, select 0, neg 10
        s = z.sum()                          # 10 adds
        torch.roll(s.expand(4), 1).clone()   # data movement: 0
    assert c.ops == 10 + 10 + 20 + 10 + 10 + 10
    assert not c.uncounted
