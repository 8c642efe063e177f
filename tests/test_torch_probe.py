"""K7/K8, the port's toolchain probes (fv3net_tpu_torch.probe), on the
CPU: the plain versions against numpy x*2+1 and
x + np.roll(x, 1, 1) + np.roll(x, -1, 1), CPU tensors dispatched to them
with no launch counted, and the CUDA wrappers refusing CPU tensors.  The
reference's own kernel bodies (``kern``, ``stenc`` of
tools/probe_pallas.py, in Pallas interpret mode) hold the port in
tests/test_torch_probe_reference.py, and the kernels' launch plans are
walked in tests/test_torch_probe_plan.py."""

import numpy as np
import pytest
import torch

from fv3net_tpu_torch import probe


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("shape", [probe.SHAPE, (3, 7), (1, 2)])
def test_affine_matches_numpy(shape):
    x = _x(shape)
    got = probe.affine(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, x * np.float32(2) + np.float32(1))


@pytest.mark.parametrize("shape", [probe.SHAPE, (3, 7), (1, 2)])
def test_stencil_matches_numpy(shape):
    x = _x(shape, seed=1)
    got = probe.stencil(torch.as_tensor(x)).numpy()
    want = x + np.roll(x, 1, 1) + np.roll(x, -1, 1)
    np.testing.assert_array_equal(got, want)


def test_cpu_dispatch_is_plain_and_counts_nothing():
    x = torch.as_tensor(_x(probe.SHAPE, seed=2))
    probe.affine_cuda.launches = probe.stencil_cuda.launches = 0
    assert torch.equal(probe.affine(x), probe.affine_plain(x))
    assert torch.equal(probe.stencil(x), probe.stencil_plain(x))
    assert probe.affine_cuda.launches == probe.stencil_cuda.launches == 0


def test_wrappers_refuse_cpu_tensors():
    x = torch.zeros(probe.SHAPE)
    for fn in (probe.affine_cuda, probe.stencil_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            fn(x)


def test_main_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        probe.main()
