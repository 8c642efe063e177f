"""The JAX package's jitted training steps as the port's
``fit._shared.training_step`` (``graphs.jit`` with ``updates``), and the
reservoir's scan as a ``graphs.jit`` unit, on the CPU.

A CUDA graph needs the card: here a stand-in capture runs the step's
body at each replay, with the CPU as the captured device, so the
bookkeeping of the captured loops (warm-up steps, one capture a key,
the short last batch of an epoch a second key, CycleGAN's two steps in
turn) runs as on the card.

- each family's captured loop gives the eager loop's parameters and
  losses bit for bit, with the count of captures;
- no step body reads the host (``NoHostRead(scalars=True)`` over every
  step's loss and backward, and over the reservoir's scan; the Adam
  update is torch's ``capturable`` one on the card, whose CPU form reads
  its step count);
- CycleGAN's generator step leaves the discriminators' ``.grad`` as it
  was, and its discriminator step the generators'.

The captured loops on the card: ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` phases 14, 16 and 18.
"""

import numpy as np
import pytest
import torch

from fv3net_tpu_torch import fit, graphs
from fv3net_tpu_torch.fit import _shared
from fv3net_tpu_torch.fit import reservoir as rsv
from fv3net_tpu_torch.fit import transformed
from fv3net_tpu_torch.util.quantity import Quantity
from torch_parity import NoHostRead

torch.set_num_threads(1)

N, NZ = 6, 4  # C6 columns; the series' cubes are C8
DIMS3, DIMS2 = ("tile", "z", "y", "x"), ("tile", "y", "x")


class StandIn:
    """A capture that runs the body eagerly on each replay and not at
    its making (a CUDA graph's capture runs nothing)."""

    made = 0

    def __init__(self, fn, args, leaves, spec, carry, donate, **kw):
        StandIn.made += 1
        self.fn, self.spec = fn, spec
        self.static_bytes = self.pool_bytes = 0

    def __call__(self, leaves, steps):
        return self.fn(*graphs._build(self.spec, iter(leaves)))


@pytest.fixture
def stand_in(monkeypatch):
    """Training steps and jit units capture CPU tensors, through
    StandIn."""
    monkeypatch.setattr(graphs, "_Capture", StandIn)
    monkeypatch.setattr(graphs, "CAPTURED_DEVICE", "cpu")
    StandIn.made = 0
    return StandIn


# --- seeded data at C6 -------------------------------------------------------


def _cube(rng, nz=NZ, n=N):
    return rng.randn(6, nz, n, n).astype(np.float32)


def _pair(seed):
    rng = np.random.RandomState(seed)
    a = _cube(rng)
    return {"a": Quantity(a, DIMS3),
            "b": Quantity(2.0 * a + 0.1 * _cube(rng), DIMS3)}


def _precip(seed):
    rng = np.random.RandomState(seed)
    delp = np.full((6, NZ, N, N), 1e4, np.float32)
    dq2 = (-1e-7 * rng.rand(6, NZ, N, N)).astype(np.float32)
    return {
        "air_temperature": Quantity(250 + 30 * _cube(rng), DIMS3),
        "specific_humidity": Quantity(1e-3 * np.abs(_cube(rng)), DIMS3),
        "pressure_thickness_of_atmospheric_layer": Quantity(delp, DIMS3),
        "dQ1": Quantity(1e-5 * _cube(rng), DIMS3),
        "dQ2": Quantity(dq2, DIMS3),
        "total_precipitation_rate": Quantity(np.maximum(
            -(dq2 * delp).sum(axis=1) / 9.80665, 0.0).astype(np.float32),
            DIMS2),
    }


def _gscond(n=300, seed=0):
    rng = np.random.RandomState(seed)
    t = 240 + 50 * rng.rand(n, NZ)
    qv = 1e-3 * rng.rand(n, NZ)
    cond = np.where(t < 270.0, 0.05 * qv, 0.0)
    return {k: v.astype(np.float32) for k, v in {
        "air_temperature_input": t,
        "specific_humidity_input": qv,
        "cloud_water_mixing_ratio_input": 1e-4 * rng.rand(n, NZ),
        "air_temperature_after_gscond": t + 2.5e3 * cond,
        "specific_humidity_after_gscond": qv - cond}.items()}


def _series(T, seed=3, n=8):
    """A time series of [6, 2, n, n] states (n = 8: the autoencoder and
    the graph UNet halve it twice) with a forcing."""
    rng = np.random.RandomState(seed)
    s = _cube(rng, 2, n)
    out = []
    for t in range(T):
        f = np.cos(0.3 * t + rng.rand(6, n, n)).astype(np.float32)
        out.append({"s": Quantity(s.copy(), DIMS3),
                    "g": Quantity((0.5 * s).copy(), DIMS3),
                    "f": Quantity(f, DIMS2)})
        s = (0.9 * s + 0.1 * np.roll(s, 1, axis=-1) + 0.2 * f[:, None]
             ).astype(np.float32)
    return out


# each family's training at C6 and the captures its loop makes: a key
# seen more than graphs.WARMUP times is captured once
def _dense():
    # 216 samples in batches of 64: three full and a short one an epoch
    return fit.train_dense_model(
        fit.DenseHyperparameters(depth=2, width=8, epochs=3, batch_size=64),
        [_pair(0)], input_variables=["a"], output_variables=["b"],
        device="cpu")


def _precipitative():
    batch = _precip(1)
    return fit.train_precipitative_model(
        fit.PrecipitativeHyperparameters(depth=1, width=8, epochs=3,
                                         batch_size=100),
        [batch], input_variables=list(batch)[:3],
        output_variables=list(batch)[3:], device="cpu")


def _transformed():
    hp = transformed.TransformedParameters.from_dict(dict(
        tensor_transform=[
            {"to": "tdiff", "before": "air_temperature_input",
             "after": "air_temperature_after_gscond"},
            {"to": "qvdiff", "before": "specific_humidity_input",
             "after": "specific_humidity_after_gscond"}],
        model={"input_variables": ["air_temperature_input",
                                   "specific_humidity_input",
                                   "cloud_water_mixing_ratio_input"],
               "direct_out_variables": ["tdiff", "qvdiff"],
               "architecture": {"name": "dense", "depth": 1, "width": 8}},
        loss={"loss_variables": ["tdiff", "qvdiff"]},
        epochs=3, batch_size=128, learning_rate=1e-3))
    return transformed.train_transformed(hp, [_gscond()], device="cpu")


def _convolutional():
    return fit.train_convolutional_model(
        fit.ConvolutionalHyperparameters(filters=4, depth=1, epochs=2),
        [_pair(2), _pair(3)], input_variables=["a"], output_variables=["b"],
        device="cpu")


def _graph(arch):
    def train():
        return fit.train_graph_model(
            fit.GraphHyperparameters(architecture=arch, width=4, depth=2,
                                     epochs=3),
            _series(2)[:1], input_variables=["s"], output_variables=["g"],
            device="cpu")
    return train


def _fmr():
    return fit.train_fmr_model(
        fit.FMRHyperparameters(hidden=8, epochs=3, train_rollout=2),
        _series(5), input_variables=["f"], output_variables=["s"],
        device="cpu")


def _autoencoder():
    return fit.train_autoencoder(
        fit.AutoencoderHyperparameters(filters=4, epochs=3), _series(2),
        input_variables=["s"], device="cpu")


def _cyclegan():
    return fit.train_cyclegan(
        fit.CycleGANHyperparameters(filters=4, n_res=1, epochs=3),
        _series(2), input_variables=["s"], output_variables=["g"],
        device="cpu")


FAMILIES = {
    "dense": (_dense, 2),
    "precipitative": (_precipitative, 2),  # 216 samples in batches of 100
    "transformed": (_transformed, 2),  # 300 samples in batches of 128
    "convolutional": (_convolutional, 1),  # one cube a step, 4 steps
    "graph_mpg": (_graph("mpg"), 1),
    "graph_unet": (_graph("unet"), 1),
    "fmr": (_fmr, 1),
    "autoencoder": (_autoencoder, 1),
    "cyclegan": (_cyclegan, 2),  # the generator and discriminator steps
}


def _params(model):
    modules = ([model.gen_ab, model.gen_ba] if hasattr(model, "gen_ab")
               else [model.module])
    return [p.detach().clone() for m in modules for p in m.parameters()]


class Losses:
    """Every step's loss of the loops run within the block
    (``_shared.run_steps`` and ``run_rounds`` wrapped)."""

    def __init__(self, monkeypatch):
        self.losses = []
        for name in ("run_steps", "run_rounds"):
            real = getattr(_shared, name)
            monkeypatch.setattr(_shared, name, self._wrap(real))

    def _wrap(self, real):
        def loop(*args):
            out = real(*args)
            self.losses += out
            return out
        return loop


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_captured_loop_equals_eager(family, stand_in, monkeypatch):
    """The loop through the captured step (warm-up steps, a capture a key,
    replays) gives the eager loop's parameters and every step's loss bit
    for bit, with one capture for each key seen more than WARMUP times
    (the short last batch of an epoch a second key)."""
    train, captures = FAMILIES[family]
    losses = Losses(monkeypatch)
    with graphs.eager():
        want = _params(train())
    assert stand_in.made == 0
    want_losses, losses.losses = losses.losses, []
    got = _params(train())
    assert stand_in.made == captures
    assert len(losses.losses) == len(want_losses) > graphs.WARMUP
    for g, w in zip(losses.losses, want_losses):
        assert torch.equal(g, w)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_train_step_sequence(stand_in):
    """Every call is one step on its own batch, in order: the first
    WARMUP calls of a key real eager calls, then the capture and its
    replay; a new key warms up of its own; within eager() nothing is
    captured.  A unit of updates takes no carry."""
    seen = []

    def step(batch):
        seen.append(float(batch.sum()))
        return batch.sum()

    ts = graphs.jit(step, updates=True)
    xs = [torch.full((3,), float(i)) for i in range(6)]
    for i, x in enumerate(xs[:4]):
        ts(x)
        assert stand_in.made == (1 if i >= graphs.WARMUP else 0)
    short = torch.ones(2)
    for _ in range(graphs.WARMUP):
        ts(short)
    assert stand_in.made == 1 and ts.captures() == 1
    ts(short)
    assert stand_in.made == 2 and ts.captures() == 2
    with graphs.eager():
        ts(xs[4])
    ts(xs[5])
    assert seen == [3.0 * i for i in range(4)] + [2.0] * 3 + [12.0, 15.0]
    assert stand_in.made == 2
    with pytest.raises(ValueError, match="not differentiable"):
        ts(torch.ones(3, requires_grad=True))
    with pytest.raises(ValueError, match="no carry"):
        graphs.Graphed(step, carry="all", updates=True)


def test_static_buffers_keep_the_layout():
    """A capture's buffer of a batch tensor has the tensor's strides: a
    channels-last view (the generative families' NHWC batches made from
    NCHW host arrays) stays one, so the captured convolutions run the
    cuDNN plans, and round as, the eager ones."""
    x = torch.randn(2, 5, 4, 3).permute(0, 2, 3, 1)  # NHWC view of NCHW
    for t in (x, x.permute(0, 3, 1, 2), torch.randn(3, 4),
              torch.randn(4, 6)[:, ::2]):
        b = graphs._buffer(t)
        assert torch.equal(b, t) and b.data_ptr() != t.data_ptr()
        if graphs._dense(t):
            assert b.stride() == t.stride()
        else:  # its axes in the same order of strides, packed
            assert graphs._dense(b)


def test_reservoir_scan_captured_equals_eager(stand_in):
    """The reservoir's scan through its jit unit (one capture for a T and
    a shape) equals the eager scan bit for bit."""
    hp = fit.ReservoirHyperparameters(state_size=32)
    res = rsv.Reservoir(hp, 20, device="cpu")
    Un = torch.as_tensor(np.random.RandomState(4).randn(7, 5, 20),
                         dtype=torch.float32)
    rsv._scan.graphed.captures.clear()
    with graphs.eager():
        want = rsv.reservoir_states(res, Un)
    for _ in range(2):
        assert torch.equal(rsv.reservoir_states(res, Un), want)
    assert rsv._scan.captures() == 1 and stand_in.made == 1
    x = torch.zeros(5, 32)
    for t in range(7):
        x = res.increment_state(Un[t], x)
        assert torch.equal(want[t], x)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_no_host_read_in_a_step(family, monkeypatch):
    """Every step's loss and backward runs under NoHostRead(scalars=True)
    (the Adam update outside it: the CPU's reads its step count, the
    card's is capturable)."""
    steps = []

    def checked(module, optimizer, loss_fn, batch):
        optimizer.zero_grad(set_to_none=True)
        with NoHostRead(scalars=True):
            loss = loss_fn(module, *batch)
            loss.backward()
        optimizer.step()
        steps.append(1)
        return loss.detach()

    monkeypatch.setattr(_shared, "train_step", checked)
    FAMILIES[family][0]()
    assert len(steps) > graphs.WARMUP


def test_no_host_read_in_the_reservoir_scan():
    res = rsv.Reservoir(fit.ReservoirHyperparameters(state_size=16), 8,
                        device="cpu")
    Un = torch.randn(4, 3, 8)
    with NoHostRead(scalars=True):
        rsv._scan.eager(Un, res.W_in, res.W_res, res.hp.leakage)


@pytest.mark.parametrize("captured", [False, True])
def test_cyclegan_steps_keep_each_others_gradients(captured, monkeypatch,
                                                   request):
    """CycleGAN's generator step writes only the generators' .grad and
    its discriminator step only the discriminators' (as the JAX
    package's value_and_grad of g_params and of d_params), eager and
    through the captured steps."""
    if captured:
        request.getfixturevalue("stand_in")
    modules = []
    real_adam = _shared.adam

    def adam(module, *args, **kwargs):
        modules.append(module)
        return real_adam(module, *args, **kwargs)

    def grads(module):
        return [None if p.grad is None else p.grad.clone()
                for p in module.parameters()]

    real_step = _shared.train_step
    record = []

    def step(module, optimizer, loss_fn, batch):
        (other,) = [m for m in modules if m is not module]
        before = grads(other)
        loss = real_step(module, optimizer, loss_fn, batch)
        after = grads(other)
        assert len(before) == len(after)
        for b, a in zip(before, after):
            assert (b is None and a is None) or torch.equal(b, a)
        assert all(p.grad is not None for p in module.parameters())
        record.append((module, sum(b is not None for b in before)))
        return loss

    monkeypatch.setattr(_shared, "adam", adam)
    monkeypatch.setattr(_shared, "train_step", step)
    _cyclegan()
    gens, discs = modules
    assert [m for m, _ in record] == [gens, discs] * 3
    # from the second step on, the other module's gradients exist
    assert all(n > 0 for _, n in record[1:])
