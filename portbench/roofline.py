"""The yardstick of the kernels' roofline and of the step's share of peak.

BOUND_NOTE (copied from the repository's ``chip_smoke.py``): a kernel's
bound is the least time the card could take for the call: the larger of
the bytes it must move (each input read once, each output written once)
over the device memory rate and of its operations over the f32 rate
outside the tensor cores (NVIDIA H100 SXM data sheet, at the full 700 W
power limit; the card's own limit is printed beside).  Operations are
counted from the kernels' sources, each add, multiply, divide, min/max,
compare-select, power and logarithm as one, per cell (or column level)
of the call's shapes (OPS_*).

``KERNELS`` gives, for each of the port's hand-written kernels, the
names its device functions carry in a profiler trace (the port's
``TRACE_NAMES``) and the bound of one launch at a configuration's shapes.
Each launch is counted at the smallest shapes the step gives it (the
cell-centred interior where a call may take a staggered field, the
narrower area arrays, one overlapping source layer per target layer of
the remap), so the bound is never above the least time of the real
call, and a share of it never passes 100% by the counting.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F32_BYTES = 4

OPS_TP2D_CELL = 154  # hord 5: 2 inner half-updates of 54, 2 outer of 23
OPS_MULTI5_CELL = 5 * OPS_TP2D_CELL + 2  # + the air mass area * delp
OPS_SIM1_LEVEL = 60  # three level recurrences (csrc/sim1.cu)
OPS_DEL4_CELL = 30  # two flux-form Laplacians and the update
OPS_COLUMN_LEVEL = 12  # prefix sum, pow and log at the interface, pi, pm
OPS_REMAP_LEVEL = 74  # edge spline sweeps (14) and limiter walk (60)
OPS_REMAP_PAIR = 27  # one overlapping (source, target) layer pair
OPS_REMAP_TARGET = 8  # constant extensions and the division


def bound_ms(nbytes: float, ops: float) -> float:
    """The call's bound in ms (BOUND_NOTE): ``chip_smoke.bound`` on
    counts of bytes and operations."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3


def _shapes(cfg):
    n, nz, h = cfg["resolution"], cfg["nz"], cfg["halo"]
    N = n + 2 * h
    return n, nz, N


def _tp2d(cfg):
    # q (x and y fills), the Courant numbers, the mass fluxes [6, nz, N,
    # N] and the two areas [6, N, N] in; the two fluxes out
    n, nz, N = _shapes(cfg)
    lat, area = 6 * nz * N * N, 6 * N * N
    nbytes = (6 * lat + 2 * area + 2 * lat) * F32_BYTES
    return bound_ms(nbytes, OPS_TP2D_CELL * lat)


def _multi5(cfg):
    # the five transports' 16 fields and two areas in, 10 fluxes out
    n, nz, N = _shapes(cfg)
    lat, area = 6 * nz * N * N, 6 * N * N
    nbytes = (16 * lat + 2 * area + 10 * lat) * F32_BYTES
    return bound_ms(nbytes, OPS_MULTI5_CELL * lat)


def _sim1(cfg):
    # dm, pt, dz, w, pm [6, nz, n, n], pem [6, nz+1, n, n], ws [6, n, n]
    # in (the interior); w, dz [6, nz, n, n] and ppe [6, nz+1, n, n] out
    n, nz, _ = _shapes(cfg)
    lay, lev, col = 6 * nz * n * n, 6 * (nz + 1) * n * n, 6 * n * n
    nbytes = (5 * lay + lev + col + 2 * lay + lev) * F32_BYTES
    return bound_ms(nbytes, OPS_SIM1_LEVEL * lay)


def _del4(cfg):
    # q [6, nz, n, n] and the two areas [6, N, N] in, q out
    n, nz, N = _shapes(cfg)
    lay = 6 * nz * n * n
    nbytes = (2 * lay + 2 * 6 * N * N) * F32_BYTES
    return bound_ms(nbytes, OPS_DEL4_CELL * lay)


def _column(cfg):
    # dp [6, nz, N, N] in; pe [6, nz+1, N, N], pi and pm out
    n, nz, N = _shapes(cfg)
    lay, lev = 6 * nz * N * N, 6 * (nz + 1) * N * N
    nbytes = (lay + lev + 2 * lay) * F32_BYTES
    return bound_ms(nbytes, OPS_COLUMN_LEVEL * lay)


def _remap(cfg):
    # q [6, nz, n, n] and both edge sets [6, nz+1, n, n] in, q out; at
    # least one overlapping source layer for each target layer
    n, nz, _ = _shapes(cfg)
    lay, lev = 6 * nz * n * n, 6 * (nz + 1) * n * n
    nbytes = (2 * lay + 2 * lev) * F32_BYTES
    ops = (OPS_REMAP_LEVEL + OPS_REMAP_TARGET + OPS_REMAP_PAIR) * lay
    return bound_ms(nbytes, ops)


# kernel -> (names in a trace: the launch counted, then any further
# device function the same call launches; the bound of one launch)
KERNELS = {
    "fv_tp_2d": (("tp2d<",), _tp2d),
    "fv_tp_2d_multi5": (("transport3<", "transport2<"), _multi5),
    "sim1_solver": (("sim1_kernel",), _sim1),
    "del4_filter": (("del4<false>",), _del4),
    "del4_filter_pair": (("del4<true>",), _del4),
    "column_pressures": (("column_kernel",), _column),
    "ppm_remap": (("remap_kernel",), _remap),
}


def kernel_of(name: str):
    """(kernel, counts_a_launch) for a device op's name, or (None, False)
    for a device op that is none of the port's kernels."""
    for kernel, (patterns, _) in KERNELS.items():
        for i, pat in enumerate(patterns):
            if pat in name:
                return kernel, i == 0
    return None, False
