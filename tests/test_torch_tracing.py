"""fv3net_tpu_torch.tracing on the CPU: FV3's routine clocks as device
spans, the set-up's host spans and the exchange tally.

The mark kernel (csrc/mark.cu) needs the card; here a stand-in writer
for the CPU (in ``tracing.WRITERS``) appends what the kernel appends,
(id, ns) at the cursor modulo the capacity, to a log on the CPU:

- the decoder: nesting, parents and self times; a wrapped log and an
  incomplete outer span; a dt left open by a body that raised;
  ``per_step`` grouped by ``dycore.dt``;
- one C12 dt of the stepper writes 54 marks that decode to its stages
  (6 each of c_sw, d_sw, riem_solver and damping, one tracer_2d and one
  remap), whose self times tile the dt;
- a span does nothing on CPU tensors (no writer for them), under
  ``spmd_mode`` and for an unknown name, and a mark inside a capture
  before the log exists raises;
- ``attribute`` and ``align`` on synthetic traces;
- the exchange tally: each exchange's calls and bytes, one C12 dt's as
  six substeps' and the tracer transport's, and the same counts after
  one replay of a stand-in capture (``graphs.Graphed`` with a capture
  that records its body's counts once and adds them at each replay);
- ``host_span`` feeds ``tracing.HOST`` (the grid and metrics builds
  too), and ``timing_report`` reports the host spans and the log's
  device spans, without totals where the log wrapped;
- the coupled step's spans: the names before them keep their mark ids,
  they do nothing on CPU tensors without a writer, and one C12 coupled
  step (SAS, prognostic GFDL, gray radiation, a dense corrector) writes
  72 marks nested as the step nests them, whose self times tile
  ``step.coupled``, with the loop's host spans and its ``loop.h2d``
  bytes; on the card (``-m cuda``) the same of replayed steps.

The card's marks themselves: tests/test_torch_cuda.py.
"""

import time

import pytest
import torch

from fv3net_tpu_torch import graphs, tracing
from fv3net_tpu_torch.dycore import hydro, sw
from fv3net_tpu_torch.grid import CubedSphereGrid, halo
from fv3net_tpu_torch.runtime.timing import timing_report

torch.set_num_threads(1)

n, H, NZ, PTOP = 12, 3, 8, 300.0
N = n + 2 * H
F64 = 8  # bytes
MARK = "void (anonymous namespace)::marks::fv3_mark<{}>(unsigned long " \
       "long*, unsigned long long)"


def _write(log, mark_id):
    """What ``fv3_mark<mark_id>`` does, on a CPU log."""
    cap = log.shape[0] - 1
    c = int(log[0, 0])
    log[1 + c % cap, 0] = mark_id
    log[1 + c % cap, 1] = time.perf_counter_ns()
    log[0, 0] = c + 1


@pytest.fixture
def marks(monkeypatch):
    monkeypatch.setitem(tracing.WRITERS, "cpu", _write)
    monkeypatch.setattr(tracing, "_log", None)
    monkeypatch.setattr(tracing, "_decoded", None)
    return tracing


def _ids(*names_and_kinds):
    """[(id, ns)] of ("name", "b"|"e") pairs, 10 ns apart."""
    out = []
    for k, (name, kind) in enumerate(names_and_kinds):
        i = tracing.SPANS.index(name)
        out.append((2 * i + (kind == "e"), 10 * k))
    return out


def test_decode_nesting_and_self_time():
    log = [(0, 0), (2, 10), (3, 30), (4, 40), (6, 45), (7, 55), (5, 70),
           (1, 100)]
    spans = tracing.decode(log)
    assert [(s.name, s.start, s.end, s.parent, s.step) for s in spans] == [
        ("dycore.dt", 0, 100, None, 0),
        ("dycore.c_sw", 10, 30, 0, 0),
        ("dycore.d_sw", 40, 70, 0, 0),
        ("dycore.riem_solver", 45, 55, 2, 0),
    ]
    assert spans[2].ms == 30e-6
    steps = tracing.per_step(spans=spans)
    assert steps == {"dycore.dt": [50e-6], "dycore.c_sw": [20e-6],
                     "dycore.d_sw": [20e-6],
                     "dycore.riem_solver": [10e-6]}
    assert sum(v[0] for v in steps.values()) == pytest.approx(100e-6)


def test_decode_drops_incomplete_spans():
    # the log starts inside dt 0 (its begin and c_sw's begin overwritten)
    # and ends inside dt 2: only dt 1 is complete
    log = _ids(("dycore.c_sw", "e"), ("dycore.d_sw", "b"),
               ("dycore.d_sw", "e"), ("dycore.remap", "b"),
               ("dycore.remap", "e"), ("dycore.dt", "e"),
               ("dycore.dt", "b"), ("dycore.c_sw", "b"),
               ("dycore.c_sw", "e"), ("dycore.dt", "e"),
               ("dycore.dt", "b"), ("dycore.c_sw", "b"),
               ("dycore.c_sw", "e"))
    spans = tracing.decode(log)
    assert [(s.name, s.step) for s in spans] == [
        ("dycore.dt", 0), ("dycore.c_sw", 0)]
    assert spans[0].start == 60
    # a body that raised left its span open: dropped, the outer kept
    log = _ids(("dycore.dt", "b"), ("dycore.d_sw", "b"),
               ("dycore.damping", "b"), ("dycore.d_sw", "e"),
               ("dycore.dt", "e"))
    assert [s.name for s in tracing.decode(log)] == ["dycore.dt",
                                                     "dycore.d_sw"]
    with pytest.raises(ValueError, match="names no span"):
        tracing.decode([(2 * len(tracing.SPANS), 0)])


def test_decode_after_a_dt_left_open():
    # a dt whose body raised (caught, the dt run again) leaves its begin
    # and c_sw's open: the next dt's begin drops them, both later dts kept
    log = _ids(("dycore.dt", "b"), ("dycore.c_sw", "b"),
               ("dycore.dt", "b"), ("dycore.c_sw", "b"),
               ("dycore.c_sw", "e"), ("dycore.dt", "e"),
               ("dycore.dt", "b"), ("dycore.remap", "b"),
               ("dycore.remap", "e"), ("dycore.dt", "e"))
    spans = tracing.decode(log)
    assert [(s.name, s.start, s.parent, s.step) for s in spans] == [
        ("dycore.dt", 20, None, 0), ("dycore.c_sw", 30, 0, 0),
        ("dycore.dt", 60, None, 1), ("dycore.remap", 70, 2, 1)]
    assert tracing.per_step(spans=spans)["dycore.dt"] == [20e-6, 20e-6]


def test_per_step_groups_by_outer():
    log = _ids(("step.dynamics", "b"), ("dycore.dt", "b"),
               ("dycore.c_sw", "b"), ("dycore.c_sw", "e"),
               ("dycore.c_sw", "b"), ("dycore.c_sw", "e"),
               ("dycore.dt", "e"), ("step.dynamics", "e"),
               ("dycore.dt", "b"), ("dycore.remap", "b"),
               ("dycore.remap", "e"), ("dycore.dt", "e"))
    spans = tracing.decode(log)
    assert spans[0].step is None  # the coupled stage around the dt
    steps = tracing.per_step(spans=spans)
    assert set(steps) == {"dycore.dt", "dycore.c_sw", "dycore.remap"}
    assert steps["dycore.c_sw"] == [20e-6, 0.0]  # two of 10 ns in dt 0
    assert steps["dycore.remap"] == [0.0, 10e-6]
    assert steps["dycore.dt"] == [30e-6, 20e-6]
    coupled = tracing.per_step("step.dynamics", spans=tracing.decode(
        log, "step.dynamics"))
    assert coupled["step.dynamics"] == [20e-6]
    assert coupled["dycore.c_sw"] == [20e-6]


def test_wrapped_log_keeps_the_newest_entries(marks, monkeypatch):
    monkeypatch.setattr(tracing, "CAPACITY", 8)
    x = torch.zeros(2)
    for _ in range(3):  # 3 x 6 marks through a log of 8
        with tracing.span("dycore.dt", x):
            with tracing.span("dycore.c_sw", x):
                pass
            with tracing.span("dycore.remap", x):
                pass
    got = tracing.entries()
    assert [i for i, _ in got] == [3, 12, 13, 1, 0, 2, 3, 12, 13, 1][-8:]
    assert [t for _, t in got] == sorted(t for _, t in got)
    spans = tracing.device_spans()
    assert [s.name for s in spans] == ["dycore.dt", "dycore.c_sw",
                                       "dycore.remap"]
    tracing.reset()
    assert tracing.entries() == [] and tracing.device_spans() == []


def _dt_stepper():
    run, m, _ = hydro.make_dycore_stepper(
        CubedSphereGrid.make(n, halo=H), NZ, 900.0, ptop=PTOP,
        dtype=torch.float64, device="cpu")
    st = hydro.benchmark_state(n, NZ, PTOP, "cpu")
    st = type(st)(*(x.double() for x in st))
    return run, m, st, torch.zeros((6, n, n), dtype=torch.float64)


@pytest.fixture(scope="module")
def stepper():
    return _dt_stepper()


def test_dt_writes_its_stages(marks, stepper, monkeypatch):
    run, _, st, phis = stepper
    before = tracing.COUNTS.snapshot()
    run.one_dt(st, phis)
    assert len(tracing.entries()) == 54
    # of the spans, the tally counts the dts alone
    assert {k: v for k, v in tracing.COUNTS.since(before).items()
            if k[0] in tracing.SPANS} == {("dycore.dt", "cpu"): (1, 0)}
    spans = tracing.device_spans()
    names = [s.name for s in spans]
    assert {k: names.count(k) for k in set(names)} == {
        "dycore.dt": 1, "dycore.c_sw": 6, "dycore.d_sw": 6,
        "dycore.riem_solver": 6, "dycore.damping": 6,
        "dycore.tracer_2d": 1, "dycore.remap": 1}
    by_index = {i: s for i, s in enumerate(spans)}
    for s in spans[1:]:
        parent = by_index[s.parent].name
        assert parent == ("dycore.d_sw" if s.name in (
            "dycore.riem_solver", "dycore.damping") else "dycore.dt")
    steps = tracing.per_step()
    assert all(len(v) == 1 for v in steps.values())
    assert sum(v[0] for v in steps.values()) == pytest.approx(
        spans[0].ms, rel=1e-12)
    # the same state out as without the marks
    marked = run.one_dt(st, phis)
    monkeypatch.delitem(tracing.WRITERS, "cpu")
    plain = run.one_dt(st, phis)
    for a, b in zip(plain, marked):
        assert torch.equal(a, b)


def test_span_does_nothing_off_the_marked_device(marks, monkeypatch):
    x = torch.zeros(3)
    with monkeypatch.context() as m:
        m.delitem(tracing.WRITERS, "cpu")
        with tracing.span("dycore.dt", x):  # a CPU tensor
            pass
    with halo.spmd_mode(object()):  # a mesh's shard
        with tracing.span("dycore.dt", x):
            pass
    with tracing.span("dycore.dt", None):
        pass
    assert tracing._log is None and tracing.entries() == []
    with pytest.raises(ValueError, match="none of tracing.SPANS"):
        with tracing.span("d_sw", x):
            pass
    monkeypatch.setattr(tracing, "_capturing", lambda device: True)
    with pytest.raises(RuntimeError, match="before the log exists"):
        with tracing.span("dycore.dt", x):
            pass


def test_attribute_assigns_ops_to_the_innermost_span():
    ops = [
        (MARK.format(0), 0.0, 1.0), ("k1", 1.0, 5.0),
        (MARK.format(2), 5.0, 6.0), ("k2", 6.0, 10.0),
        (MARK.format(3), 10.0, 11.0), ("k1", 11.0, 13.0),
        (MARK.format(1), 13.0, 14.0), ("k3", 20.0, 21.0),
    ]
    got = tracing.attribute(ops[::-1])  # in any order
    assert got == {
        "dycore.dt": {MARK.format(0): 1e-6, "k1": 6e-6,
                      MARK.format(1): 1e-6},
        "dycore.c_sw": {MARK.format(2): 1e-6, "k2": 4e-6,
                        MARK.format(3): 1e-6},
        tracing.OUTSIDE: {"k3": 1e-6},
    }
    assert tracing.mark_of("void at::native::copy_kernel<4>") is None


def test_align_finds_the_offset_of_the_traced_marks():
    # the log: four dts of four marks, of uneven lengths; the trace holds
    # the third dt's marks on a clock 5e9 ns ahead, 0-2 ns of jitter
    ids, starts, t = [0, 2, 3, 1] * 4, [], 1_000_000
    for k in range(16):
        starts.append(t)
        t += [100, 3000, 250, 7000, 400, 90, 6000, 180][k % 8] + 13 * k
    log = list(zip(ids, starts))
    ops = [(MARK.format(i), (s + 5e9 + (k % 3)) / 1e3,
            (s + 5e9 + 500) / 1e3) for k, (i, s) in enumerate(log[8:12])]
    ops.append(("k1", 0.0, 1.0))
    assert tracing.align(ops, log) == pytest.approx(5e9 + 1, abs=2)
    with pytest.raises(ValueError, match="not in the log"):
        tracing.align([(MARK.format(4), 0.0, 1.0)], log)


def test_each_exchange_counts_its_calls_and_bytes():
    def added(fn, *args):
        snap = tracing.COUNTS.snapshot()
        fn(*args)
        return tracing.COUNTS.since(snap)

    q = torch.zeros((6, NZ, n, n), dtype=torch.float64)
    u = torch.zeros((6, NZ, n + 1, n), dtype=torch.float64)
    v = torch.zeros((6, NZ, n, n + 1), dtype=torch.float64)
    assert added(halo.halo_exchange, q, H, "x") == {
        ("halo_exchange", "cpu"): (1, 6 * NZ * N * N * F64)}
    assert added(halo.halo_exchange_dgrid, u, v, H) == {
        ("halo_exchange_dgrid", "cpu"): (1, 2 * 6 * NZ * (N + 1) * N * F64)}
    assert added(halo.halo_exchange_cgrid, v, u, H) == {
        ("halo_exchange_cgrid", "cpu"): (1, 2 * 6 * NZ * (N + 1) * N * F64)}
    assert added(halo.canonicalize_cgrid_boundary, v, u) == {
        ("canonicalize_cgrid_boundary", "cpu"): (
            1, 2 * 6 * NZ * (n + 1) * n * F64)}
    assert added(halo.average_dgrid_boundary, u, v) == {
        ("average_dgrid_boundary", "cpu"): (1, 2 * 6 * NZ * (n + 1) * n * F64)}
    # a vector exchange is two scalar ones
    q2 = q[:, 0]
    assert added(halo.halo_exchange_vector_cgrid, q2, q2, H) == {
        ("halo_exchange", "cpu"): (2, 2 * 6 * N * N * F64)}


class RecordingCapture:
    """A stand-in for ``graphs._Capture`` (``graphs.CAPTURED_DEVICE`` the
    CPU): the capture runs the body once and records what it added to
    ``tracing.COUNTS``, as the real one does; a replay runs the body with
    its counts taken back and adds the recorded ones."""

    def __init__(self, fn, args, leaves, spec, carry, donate, **opts):
        self.fn, self.spec = fn, spec
        self.static_bytes = self.pool_bytes = 0
        with tracing.recorded() as self.tally:
            fn(*args)

    def __call__(self, leaves, steps):
        out = graphs._build(self.spec, iter(leaves))
        with tracing.recorded():
            for _ in range(steps):
                out = (self.fn(out[0], *out[1:]),) + tuple(out[1:])
        tracing.COUNTS.replay(self.tally, steps)
        return out[0]


def test_dt_counts_eager_and_after_a_replay(stepper, monkeypatch):
    run, m, st, phis = stepper
    ev = st._replace(q=None)
    snap = tracing.COUNTS.snapshot()
    hydro.dyn_substep(ev, m, 150.0, PTOP, 5, 0.12, phis, None, None, None,
                      None)
    substep = tracing.COUNTS.since(snap)
    snap = tracing.COUNTS.snapshot()
    run.one_dt(st, phis)
    dt = tracing.COUNTS.since(snap)
    ntr = st.q.shape[0]
    # six substeps, then the tracer transport's x- and y-fill exchanges
    # of delp and of each tracer (no exchange in the remap)
    want = {k: (6 * c, 6 * b) for k, (c, b) in substep.items()}
    c, b = want[("halo_exchange", "cpu")]
    want[("halo_exchange", "cpu")] = (
        c + 2 + 2 * ntr, b + (2 + 2 * ntr) * 6 * NZ * N * N * F64)
    assert dt == want
    assert {k[0] for k in dt} == set(tracing.EXCHANGES)
    # a replay adds what the capture recorded: one dt's counts
    monkeypatch.setattr(graphs, "_Capture", RecordingCapture)
    monkeypatch.setattr(graphs, "CAPTURED_DEVICE", "cpu")
    g = graphs.Graphed(run.one_dt, carry="all")
    snap = tracing.COUNTS.snapshot()
    g(st, phis, steps=1)  # capture, then one replay
    assert tracing.COUNTS.since(snap) == dt
    snap = tracing.COUNTS.snapshot()
    g(st, phis, steps=2)
    assert tracing.COUNTS.since(snap) == {
        k: (2 * c, 2 * b) for k, (c, b) in dt.items()}


def test_host_span_feeds_host(monkeypatch):
    monkeypatch.setattr(tracing, "HOST", tracing.Timer())
    with tracing.host_span("graphs.capture"):
        time.sleep(0.01)
    g = CubedSphereGrid.make(6, halo=H)
    sw.SWMetrics.make(g, torch.float64, device="cpu")
    times = tracing.HOST.times
    assert set(times) == {"graphs.capture", "setup.grid", "setup.metrics"}
    assert [len(v) for v in times.values()] == [1, 1, 1]
    assert times["graphs.capture"][0] >= 0.01
    with torch.profiler.profile() as prof:
        with tracing.host_span("setup.kernels"):
            pass
    assert "setup.kernels" in {e.name for e in prof.events()}


def _dts(n=2):
    x = torch.zeros(1)
    for _ in range(n):
        with tracing.span("dycore.dt", x):
            with tracing.span("dycore.remap", x):
                pass


def test_timing_report_holds_the_host_and_device_spans(marks, monkeypatch):
    monkeypatch.setattr(tracing, "HOST", tracing.Timer())
    with tracing.host_span("setup.grid"):
        pass
    _dts()
    timer = tracing.Timer()
    with timer.clock("mainloop"):
        pass
    rep = timing_report(timer)
    assert set(rep) == {"mainloop", "host:setup.grid", "device:dycore.dt",
                        "device:dycore.remap"}
    assert rep["host:setup.grid"]["count"] == 1
    dt = rep["device:dycore.dt"]
    assert dt["count"] == 2
    assert dt["min"] <= dt["mean"] <= dt["max"]
    assert dt["total"] == pytest.approx(2 * dt["mean"])
    assert rep["device:dycore.remap"]["max"] <= dt["max"]


def test_timing_report_of_a_wrapped_log(marks, monkeypatch):
    # 2 dts of 4 marks through a log of 6: the first dt's begins lost
    monkeypatch.setattr(tracing, "CAPACITY", 6)
    _dts()
    assert tracing.dropped() == 2
    rep = timing_report(tracing.Timer())
    for name in ("device:dycore.dt", "device:dycore.remap"):
        assert "total" not in rep[name] and "count" not in rep[name]
        assert rep[name]["dropped"] == 2
        assert rep[name]["min"] == rep[name]["max"]  # the second dt's
    tracing.reset()  # a segment's start: one dt fits
    assert tracing.dropped() == 0
    _dts(1)
    assert timing_report(tracing.Timer())["device:dycore.dt"]["count"] == 1


# --- the coupled step --------------------------------------------------------

# the names before the coupled step's: their mark ids are 2i and 2i + 1
OLD_SPANS = (
    "dycore.dt", "dycore.c_sw", "dycore.d_sw", "dycore.riem_solver",
    "dycore.damping", "dycore.tracer_2d", "dycore.remap",
    "step.dynamics", "step.physics", "step.postphysics",
)
COUPLED_SPANS = ("step.coupled", "physics.radiation", "physics.pbl",
                 "physics.convection", "physics.microphysics",
                 "postphysics.ml")
# one coupled step: 54 marks of the dt and 18 of the coupled spans
COUPLED_MARKS = 72


def test_old_span_names_keep_their_mark_ids():
    assert tracing.SPANS[:len(OLD_SPANS)] == OLD_SPANS
    assert tracing.SPANS[len(OLD_SPANS):] == COUPLED_SPANS


def test_coupled_spans_do_nothing_on_cpu_tensors(monkeypatch):
    monkeypatch.setattr(tracing, "_log", None)
    monkeypatch.delitem(tracing.WRITERS, "cpu", raising=False)
    x = torch.zeros(3)
    for name in COUPLED_SPANS:
        with tracing.span(name, x):
            pass
    assert tracing._log is None and tracing.entries() == []


def _coupled_loop(device, nz, tmp_path):
    """A CompiledTimeLoop of the coupled configuration (GFS suite with SAS
    and prognostic GFDL microphysics, gray radiation, nonhydrostatic) at
    C12 x nz in float32 with a small dense corrector, from a moist state
    in which the suite's convection fires."""
    from fv3net_tpu_torch import fit, wrapper
    from fv3net_tpu_torch.runtime.compiled_loop import CompiledTimeLoop
    from fv3net_tpu_torch.runtime.coupled_bench import train_dense_artifact

    path = train_dense_artifact(str(tmp_path), nz, device, depth=1,
                                width=8)
    wrapper.initialize(wrapper.ModelConfig(
        npx=n + 1, npz=nz, physics_suite="gfs", microphysics_scheme="gfdl",
        prognostic_mp_tracers=True, convection_scheme="mass_flux",
        do_radiation=True, hydrostatic=False, hord=6, kord=10,
        ptop=64.247), device=device)
    mdl = wrapper.get_model()
    gen = torch.Generator(device="cpu").manual_seed(3)
    q = mdl.state.q.clone()
    q[0] = 5e-3 * (1.0 + torch.rand(q[0].shape, generator=gen)).to(device)
    mdl.state = mdl.state._replace(
        pt=mdl.state.pt + torch.randn(mdl.state.pt.shape,
                                      generator=gen).to(device), q=q)
    return CompiledTimeLoop(wrapper, fit.load(path, device)), mdl


def _assert_coupled_spans(spans):
    """One coupled step's spans, in order of their begin, nested as the
    step nests them."""
    names = [s.name for s in spans]
    assert names.count("step.coupled") == 1 and names[0] == "step.coupled"
    top = [s.name for s in spans if s.parent == 0]
    assert top == ["step.dynamics", "step.physics", "step.postphysics"]
    for stage, inner in (
            ("step.dynamics", ["dycore.dt"]),
            ("step.physics", ["physics.radiation", "physics.pbl",
                              "physics.convection",
                              "physics.microphysics"]),
            ("step.postphysics", ["postphysics.ml"])):
        i = names.index(stage)
        assert [s.name for s in spans if s.parent == i] == inner
    assert names.count("dycore.d_sw") == 6


def test_coupled_step_writes_its_spans(marks, monkeypatch, tmp_path):
    loop, mdl = _coupled_loop("cpu", NZ, tmp_path)
    monkeypatch.setattr(tracing, "HOST", tracing.Timer())
    before = tracing.COUNTS.snapshot()
    loop.step()
    assert len(tracing.entries()) == COUPLED_MARKS
    spans = tracing.device_spans("step.coupled")
    _assert_coupled_spans(spans)
    steps = tracing.per_step("step.coupled")
    assert all(len(v) == 1 for v in steps.values())
    assert sum(v[0] for v in steps.values()) == pytest.approx(
        spans[0].ms, rel=1e-12)
    # the loop's host work: one sample of each span, and the cos-zenith
    # field's bytes (the accumulated precipitation lives on the device)
    assert {k: len(v) for k, v in tracing.HOST.times.items()} == {
        "loop.astronomy": 1, "loop.upload": 1}
    added = tracing.COUNTS.since(before)
    assert added[("loop.h2d", "cpu")] == (1, 6 * n * n * 4)
    assert added[("dycore.dt", "cpu")] == (1, 0)


@pytest.mark.cuda
def test_replayed_coupled_step_writes_its_spans(tmp_path):
    """On the card: replayed coupled C12x63 steps write 72 marks each,
    nested as the step nests them; the stages' and the step's self times
    sum to the step's span within 0.5%; the tally counts the cos-zenith
    upload of every step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    loop, mdl = _coupled_loop(torch.device("cuda"), 63, tmp_path)
    loop.step()  # warm-up, capture, one replay
    torch.cuda.synchronize()
    tracing.reset()
    before = tracing.COUNTS.snapshot()
    for _ in range(3):
        loop.step()
    ids = [i for i, _ in tracing.entries()]
    assert len(ids) == 3 * COUPLED_MARKS
    assert ids[:COUPLED_MARKS] == ids[COUPLED_MARKS:2 * COUPLED_MARKS]
    spans = tracing.device_spans("step.coupled")
    starts = [k for k, s in enumerate(spans) if s.name == "step.coupled"]
    assert len(starts) == 3
    first = spans[:starts[1]]
    _assert_coupled_spans(first)
    steps = tracing.per_step("step.coupled")
    outer = [s.ms for s in spans if s.name == "step.coupled"]
    for k in range(3):
        assert sum(v[k] for v in steps.values()) == pytest.approx(
            outer[k], rel=5e-3)
    added = tracing.COUNTS.since(before)
    assert added[("loop.h2d", "cuda")] == (3, 3 * 6 * n * n * 4)
    assert torch.isfinite(mdl.state.pt).all()
