"""One rank of the multi-rank CPU tests of fv3net_tpu_torch.parallel
(tests/test_torch_halo_spmd.py, tests/test_torch_spmd_dycore.py):
``python torch_spmd_worker.py MODE INPUT.npz OUTDIR`` (MODE ending in
``_remat``: the dycore modes with remat=True), started by
``multihost.spawn`` (RANK, WORLD_SIZE and the FileStore come from the
environment).  Imports torch and the port only; float64 on the CPU.
Each rank writes ``OUTDIR/<MODE>_rank<r>.pt``."""

import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)

from fv3net_tpu_torch.grid import halo as halo_mod  # noqa: E402
from fv3net_tpu_torch.parallel import multihost  # noqa: E402
from fv3net_tpu_torch.parallel import halo_spmd  # noqa: E402
from fv3net_tpu_torch.parallel.mesh import make_mesh  # noqa: E402


def _t(a):
    return torch.as_tensor(np.asarray(a))


def exchanges(inp, mesh):
    """Every local exchange of this rank's face, and the vjp of each with
    the seeded cotangents."""
    f = mesh.coords()[0]
    comm = mesh.face_comm
    h = int(inp["h"])
    loc = {k: _t(inp[k])[f : f + 1] for k in (
        "q", "u", "v", "uc", "vc", "ct_q", "ct_u", "ct_v", "ct_uc", "ct_vc",
        "ct_su", "ct_sv", "ct_cu", "ct_cv",
    )}
    out = {}
    with halo_mod.spmd_mode(comm):
        for fill in ("none", "x", "y"):
            out[f"scalar_{fill}"] = halo_mod.halo_exchange(loc["q"], h, fill)
            out[f"strips_{fill}"] = halo_spmd.halo_exchange_spmd(
                loc["q"], h, mesh, fill
            )
        out["dgrid"] = halo_mod.halo_exchange_dgrid(loc["u"], loc["v"], h)
        for fill in ("x", "y"):
            out[f"cgrid_{fill}"] = halo_mod.halo_exchange_cgrid(
                loc["uc"], loc["vc"], h, fill=fill
            )
        out["canon"] = halo_mod.canonicalize_cgrid_boundary(
            loc["uc"], loc["vc"]
        )
        out["avg"] = halo_mod.average_dgrid_boundary(loc["u"], loc["v"])
        # the transposes, through torch.func.vjp as the dampers take them
        for fill in ("x", "y"):
            _, fn = torch.func.vjp(
                lambda a: halo_mod.halo_exchange(a, h, fill), loc["q"]
            )
            out[f"vjp_scalar_{fill}"] = fn(loc["ct_q"])
        _, fn = torch.func.vjp(
            lambda a, b: halo_mod.halo_exchange_dgrid(a, b, h),
            loc["u"], loc["v"],
        )
        out["vjp_dgrid"] = fn((loc["ct_u"], loc["ct_v"]))
        for fill in ("x", "y"):
            _, fn = torch.func.vjp(
                lambda a, b: halo_mod.halo_exchange_cgrid(a, b, h, fill),
                loc["uc"], loc["vc"],
            )
            out[f"vjp_cgrid_{fill}"] = fn((loc["ct_cu"], loc["ct_cv"]))
        _, fn = torch.func.vjp(
            halo_mod.canonicalize_cgrid_boundary, loc["uc"], loc["vc"]
        )
        out["vjp_canon"] = fn((loc["ct_uc"], loc["ct_vc"]))
        _, fn = torch.func.vjp(
            halo_mod.average_dgrid_boundary, loc["u"], loc["v"]
        )
        out["vjp_avg"] = fn((loc["ct_su"], loc["ct_sv"]))
    out["calls"] = comm.calls
    # the mesh's and the runtime's helpers on this rank
    from fv3net_tpu_torch.parallel.mesh import global_mean, shard_state

    mine = shard_state({"q": _t(inp["q"]), "x": torch.ones(3)}, mesh)
    out["shard_q"], out["shard_x"] = mine["q"], mine["x"]
    out["global_mean"] = global_mean(
        shard_state(_t(inp["f2d"]), mesh), shard_state(_t(inp["area"]), mesh),
        mesh,
    )
    out["global_array"] = multihost.make_global_array(
        inp["q"], multihost.global_face_mesh(), ("face",), device="cpu"
    )
    out["local_faces"] = multihost.process_local_faces(mesh)
    return out


def _state(inp):
    from fv3net_tpu_torch.dycore.hydro import DycoreState

    return DycoreState(*[
        _t(inp[k]) if k in inp else None for k in DycoreState._fields
    ]), _t(inp["phis"])


def dycore(inp, mesh, layout, remat=False):
    """One dt of the multi-rank step (its substeps checkpointed with
    `remat`); the gathered state."""
    from fv3net_tpu_torch.grid.geometry import CubedSphereGrid
    from fv3net_tpu_torch.parallel import spmd_dycore
    from fv3net_tpu_torch.parallel.tiling import TileLayout

    n, nz, h = int(inp["n"]), int(inp["nz"]), 3
    g = CubedSphereGrid.make(n, halo=h)
    kw = dict(dt_atmos=float(inp["dt"]), k_split=1,
              n_split=int(inp["n_split"]), dtype=torch.float64,
              remat=remat, device="cpu")
    state, phis = _state(inp)
    if layout is None:
        run, shard, gather = spmd_dycore.make_spmd_dycore_stepper(
            g, nz, mesh, **kw
        )
    else:
        lay = TileLayout(n, h, *layout)
        run, shard, gather = spmd_dycore.make_tiled_spmd_dycore_stepper(
            g, nz, mesh, lay, **kw
        )
    st, ph = shard(state, phis)
    out = gather(run(st, ph, 1))
    return {k: v for k, v in zip(out._fields, out) if v is not None}


def main():
    mode, path, outdir = sys.argv[1], sys.argv[2], sys.argv[3]
    rank, world = multihost.initialize()
    inp = dict(np.load(path))
    # "<mesh>_remat": the same dt with remat=True
    base, remat = mode.removesuffix("_remat"), mode.endswith("_remat")
    if mode == "exchanges":
        out = exchanges(inp, make_mesh())
    elif base == "face":
        out = dycore(inp, make_mesh(), None, remat)
    else:  # "tiled F Y X"
        F, Y, X = (int(c) for c in base.split("_")[1:])
        from fv3net_tpu_torch.parallel.mesh import CubedSphereMesh

        out = dycore(inp, CubedSphereMesh(F, 1, Y, X, rank=rank), (F, Y, X),
                     remat)
    torch.save(out, os.path.join(outdir, f"{mode}_rank{rank}.pt"))
    print(f"rank {rank}/{world}: {mode} ok", flush=True)


if __name__ == "__main__":
    main()
