"""The CUDA kernel modules of fv3net_tpu_torch on a machine without nvcc,
triton or a GPU: they import, CPU tensors take the plain versions (no
launch is counted), the wrappers refuse CPU tensors, and the kernel
build fails loudly when nvcc is missing."""

import sys

import numpy as np
import pytest
import torch

from fv3net_tpu_torch import probe
from fv3net_tpu_torch.dycore import riemann, sw
from fv3net_tpu_torch.grid import halo_exchange
from fv3net_tpu_torch.ops import _build, advection, cuda_column, remap
from fv3net_tpu_torch.ops.cuda_filter import del4_filter_cuda
from fv3net_tpu_torch.ops.cuda_remap import ppm_remap_cuda
from fv3net_tpu_torch.ops.cuda_sim1 import sim1_solver_cuda
from fv3net_tpu_torch.ops.cuda_tp import fv_tp_2d_cuda, fv_tp_2d_multi5_cuda

torch.set_num_threads(1)

WRAPPERS = (
    fv_tp_2d_cuda, sim1_solver_cuda, del4_filter_cuda,
    cuda_column.column_pressures_cuda, ppm_remap_cuda, fv_tp_2d_multi5_cuda,
    probe.affine_cuda, probe.stencil_cuda,
)
n, H, NZ = 6, 3, 4
N = n + 2 * H


def test_kernel_modules_import_without_toolchain():
    assert "triton" not in sys.modules
    assert _build._lib is None  # nothing was built or loaded at import
    assert _build.CSRC.is_dir()
    assert sorted(p.name for p in _build.CSRC.glob("*.cu")) == [
        "column.cu", "filter.cu", "probe.cu", "remap.cu", "sim1.cu",
        "tp2d.cu", "tp2d_multi5.cu",
    ]
    # every C entry point the wrappers call has its argument types
    sources = "".join(p.read_text() for p in _build.CSRC.glob("*.cu"))
    for name in _build.SIGNATURES:
        assert f'extern "C" int {name}(' in sources, name


def _rand(*shape, seed=0, lo=0.0, scale=1.0):
    rng = np.random.RandomState(seed)
    return torch.as_tensor(lo + scale * rng.rand(*shape).astype(np.float32))


def test_cpu_dispatch_is_plain_and_counts_nothing():
    for w in WRAPPERS:
        w.launches = 0
    f = (6, NZ, N, N)
    args = [_rand(*f, seed=s) for s in range(6)]
    args += [_rand(6, 1, N, N, lo=1.0), _rand(6, 1, N, N, lo=1.0, seed=9)]
    for a, b in zip(advection.fv_tp_2d(*args, 5),
                    advection.fv_tp_2d_plain(*args, 5)):
        assert torch.equal(a, b)

    dp = _rand(6, NZ, N, N, lo=900.0, scale=200.0)
    for a, b in zip(cuda_column.column_pressures(dp, 300.0),
                    cuda_column.column_pressures_plain(dp, 300.0)):
        assert torch.equal(a, b)

    cols = [_rand(6, NZ, n, n, lo=1.0, seed=s) for s in range(4)]
    dz = -_rand(6, NZ, n, n, lo=50.0, seed=5)
    pem = torch.cumsum(_rand(6, NZ + 1, n, n, lo=1e3, seed=6), dim=1)
    sim1_args = (cols[0], cols[1] * 300.0, dz, cols[2], pem, cols[3] * 5e4,
                 _rand(6, n, n, seed=7))
    for a, b in zip(riemann.sim1_solve(60.0, *sim1_args),
                    riemann.sim1_solver(60.0, *sim1_args)):
        assert torch.equal(a, b)

    area = _rand(6, n, n, lo=1.0)
    m = type("M", (), dict(
        n=n, halo=H, area_px=halo_exchange(area, H, fill="x"),
        area_py=halo_exchange(area, H, fill="y"), rarea=1.0 / area,
    ))
    q = _rand(6, NZ, n, n, seed=11)
    assert torch.equal(sw.scalar_filter(q, m, 0.02),
                       sw.scalar_filter_plain(q, m, 0.02))

    pe = torch.cumsum(_rand(6, NZ + 1, n, n, lo=1e3, seed=12), dim=1)
    assert torch.equal(remap.remap_levels(q, pe, pe.flip(1).neg(), 1, 9),
                       remap.remap_levels_plain(q, pe, pe.flip(1).neg(), 1,
                                                9))
    fields = [_rand(6, NZ, N, N, lo=1.0, seed=s) for s in range(16)]
    areas = [_rand(6, N, N, lo=1.0, seed=20), _rand(6, N, N, lo=1.0, seed=21)]
    for a, b in zip(advection.fv_tp_2d_multi5(*fields, *areas, 5),
                    advection.fv_tp_2d_multi5_plain(*fields, *areas, 5)):
        assert torch.equal(a, b)
    x = _rand(8, 8, seed=22)
    assert torch.equal(probe.affine(x), probe.affine_plain(x))
    assert torch.equal(probe.stencil(x), probe.stencil_plain(x))
    assert [w.launches for w in WRAPPERS] == [0] * len(WRAPPERS)
    assert _build._lib is None


def test_wrappers_refuse_cpu_tensors():
    f = torch.zeros(6, NZ, N, N)
    a = torch.ones(6, 1, N, N)
    with pytest.raises(ValueError, match="CUDA"):
        fv_tp_2d_cuda(f, f, f, f, f, f, a, a, 5)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_column.column_pressures_cuda(f, 300.0)
    c = torch.zeros(6, NZ, n, n)
    with pytest.raises(ValueError, match="CUDA"):
        del4_filter_cuda(c, a[:, 0], a[:, 0], 0.02, H)
    with pytest.raises(ValueError, match="CUDA"):
        sim1_solver_cuda(1.0, c, c, c, c, torch.zeros(6, NZ + 1, n, n), c,
                         torch.zeros(6, n, n))
    with pytest.raises(ValueError, match="hord"):
        fv_tp_2d_cuda(f, f, f, f, f, f, a, a, 3)
    pe = torch.zeros(6, NZ + 1, N, N)
    with pytest.raises(ValueError, match="CUDA"):
        ppm_remap_cuda(f, pe, pe, 1, 9)
    with pytest.raises(ValueError, match="CUDA"):
        fv_tp_2d_multi5_cuda(*[f] * 16, a[:, 0], a[:, 0], 5)
    with pytest.raises(ValueError, match="CUDA"):
        probe.affine_cuda(f[0, 0])


def test_operand_checks():
    cpu = torch.device("cpu")
    t = torch.zeros(2, 3)
    assert _build.check(t, "t", (2, 3), cpu) == t.data_ptr()
    with pytest.raises(TypeError, match="float32"):
        _build.check(t.double(), "t", (2, 3), cpu)
    with pytest.raises(ValueError, match="shape"):
        _build.check(t, "t", (3, 2), cpu)
    with pytest.raises(ValueError, match="contiguous"):
        _build.check(torch.zeros(3, 2).t(), "t", (2, 3), cpu)
    with pytest.raises(ValueError, match="tensor on"):
        _build.check(t, "t", (2, 3), torch.device("cuda", 0))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library()
    assert not (tmp_path / "kernels").exists()


def test_build_compiles_each_source_then_links(monkeypatch, tmp_path):
    """One nvcc process per csrc/*.cu (compile only), then one link of
    the objects into the library; the objects do not outlive the build.
    A stand-in nvcc records its arguments and writes its -o file."""
    log = tmp_path / "calls.txt"
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> {log}\n'
        'while [ "$#" -gt 1 ]; do\n'
        '  if [ "$1" = "-o" ]; then echo built > "$2"; fi\n'
        "  shift\n"
        "done\n"
        "echo 'ptxas info    : Used 8 registers'\n"
    )
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(fake))
    out = _build.build()
    calls = log.read_text().splitlines()
    sources = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    compiles = [c for c in calls if " -c " in f" {c} "]
    assert sorted(c.split(" -c ")[1].split()[0].rsplit("/", 1)[1]
                  for c in compiles) == sources
    links = [c for c in calls if "-shared" in c.split()]
    assert len(links) == 1 and len(calls) == len(sources) + 1
    assert out.exists() and out.parent == tmp_path / "kernels"
    assert sorted(p.name for p in out.parent.iterdir()) == [out.name]
    assert _build.build_info["log"].count("Used 8 registers") == (
        len(sources) + 1)
    assert _build.build() == out  # an identical build is reused


def test_kernel_times_inputs():
    """kernel_times.py's seeded inputs: monotone remap edges sharing the
    column's end points, and the D stage's 16 fields and 2 areas."""
    from fv3net_tpu_torch import kernel_times

    rng = np.random.RandomState(0)
    q, pe1, pe2 = kernel_times._remap_inputs(rng, 3, 4)
    assert q.shape == (6, kernel_times.NZ, 3, 4)
    for pe in (pe1, pe2):
        assert pe.shape == (6, kernel_times.NZ + 1, 3, 4)
        assert (np.diff(pe, axis=1) > 0).all()
    np.testing.assert_array_equal(pe1[:, [0, -1]], pe2[:, [0, -1]])
    args = kernel_times._multi5_inputs(rng, 8)
    assert len(args) == 18
    assert all(a.dtype == np.float32 for a in args)
    assert [a.shape for a in args[16:]] == [(6, 8, 8)] * 2
