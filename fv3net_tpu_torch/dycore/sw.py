"""D-grid vector-invariant shallow-water operators on the cubed sphere.

Counterpart of the JAX package's ``dycore/sw.py``, face level only (no
within-face tiling): the metrics, the C-grid winds, and the provably
dissipative operators the 3D dycore step uses (Lin & Rood 1997
vector-invariant D-grid scheme with FV3's c_sw/d_sw split):

  * metric C-grid winds with chart-free boundary faces
    (``c_grid_winds``), canonicalised shared faces and both corner fills
    (``padded_cgrid_winds``), and the C half-stage pieces
    (``_c_half_winds_common``, ``_finish_c_half``);
  * dissipation built as exact transposes (-c * A^T W A), hence
    negative-semidefinite: metric cell-divergence damping (``div_damp``)
    and corner-divergence damping (``corner_div_damp``), whose transposes
    come from ``torch.func.vjp``; del-4 vorticity damping (``vort_damp``)
    and the del-4 conservative mass filter (``scalar_filter``), written in
    their forward-only local forms.

``scalar_filter`` runs the CUDA kernel (ops/cuda_filter.py) for CUDA
tensors and its plain local form for CPU tensors.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from ..device import default_device
from ..grid.geometry import CubedSphereGrid
from ..grid.halo import (
    canonicalize_cgrid_boundary,
    halo_exchange,
    halo_exchange_cgrid,
    halo_exchange_dgrid,
)

FILTER_COEF = 0.02
VORT_DAMP_COEF = 0.02
CORNER_DAMP_COEF = 0.02


def _shx(a, k):
    return torch.roll(a, -k, dims=-1)


def _shy(a, k):
    return torch.roll(a, -k, dims=-2)


def _lead_bc(a, lead: int):
    """Broadcast a per-face metric [6, ...] over `lead` level axes."""
    return a.reshape(a.shape[:1] + (1,) * lead + a.shape[1:])


@dataclasses.dataclass(frozen=True)
class SWMetrics:
    """Precomputed padded metric terms for the SW operators (tensors on
    one device; N = n + 2*halo)."""

    n: int
    halo: int
    area_px: torch.Tensor  # padded cell areas, corner fill x [6, N, N]
    area_py: torch.Tensor  # corner fill y
    rarea: torch.Tensor  # interior 1/area [6, n, n]
    dx_u: torch.Tensor  # edge length at u positions, padded [6, N+1, N]
    dy_v: torch.Tensor  # edge length at v positions, padded [6, N, N+1]
    dxc_f: torch.Tensor  # center-center distance at x-faces [6, N, N]
    dyc_f: torch.Tensor  # at y-faces [6, N, N]
    dy_f: torch.Tensor  # x-face edge length (for mass flux) [6, N, N]
    dx_f: torch.Tensor  # y-face edge length [6, N, N]
    f_center: torch.Tensor  # Coriolis at centers, interior [6, n, n]
    f_px: torch.Tensor  # Coriolis padded, corner fill x [6, N, N]
    f_py: torch.Tensor  # corner fill y
    area_c_int: torch.Tensor  # dual-cell areas at corners [6, n+1, n+1]
    # non-orthogonal metric: cos/sin of the angle between the local x and
    # y coordinate directions (FV3's cosa/sina family).  cosa_u/sina_u at
    # x-faces [6, N, N] (face-lattice embedding), cosa_v/sina_v at
    # y-faces, cosa_b/sina_b at corners [6, N+1, N+1].
    cosa_u: torch.Tensor
    rsin2_u: torch.Tensor  # 1/sin^2 at x-faces
    cosa_v: torch.Tensor
    rsin2_v: torch.Tensor
    cosa_b: torch.Tensor
    rsin2_b: torch.Tensor
    dy_fs: torch.Tensor  # dy * sina at x-faces (effective flux width)
    dx_fs: torch.Tensor  # dx * sina at y-faces
    sina_u: torch.Tensor  # sin(angle) at x-faces
    sina_v: torch.Tensor  # at y-faces
    # chart-free boundary-face C-wind weights [6, n, 4] (weights for
    # u1_left, u2_left, u1_right, u2_right cells), see c_grid_winds
    xbw_w: torch.Tensor  # x-faces at I = h
    xbw_e: torch.Tensor  # x-faces at I = h + n
    ybw_s: torch.Tensor  # y-faces at J = h
    ybw_n: torch.Tensor
    # cell-centered metric angle (for A-grid KE)
    cosa_c: torch.Tensor
    rsin2_c: torch.Tensor
    # measured operator norm of the metric divergence damper (div_damp)
    divdamp_scale: float = 1.0

    def to(self, device) -> "SWMetrics":
        """The same metrics with every tensor on `device`."""
        return dataclasses.replace(
            self,
            **{
                f.name: getattr(self, f.name).to(device)
                for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)
            },
        )

    @classmethod
    def make(cls, g: CubedSphereGrid, dtype=torch.float32,
             device=None) -> "SWMetrics":
        """Build the metrics on the CPU (numpy geometry, torch gathers,
        the divergence-damper power iteration), then move them to
        `device` (the CUDA device unless the caller names one)."""
        if device is None:
            device = default_device("SWMetrics.make")
        h, n = g.halo, g.n
        N = n + 2 * h
        f64 = torch.float64

        def t(a, dt=dtype):
            return torch.as_tensor(np.asarray(a), dtype=dt)

        area_int = t(g.area[g.interior])
        area_px = halo_exchange(area_int, h, fill="x")
        area_py = halo_exchange(area_int, h, fill="y")

        # distribute edge-lattice metrics with the C-grid machinery so
        # halo+corner values are the neighbors' true metrics.  Metric
        # lengths are positive scalars per edge; exchange |.| of the
        # signed C-grid transport.
        def pad_faces(x_int, y_int, fill):
            ux, vy = halo_exchange_cgrid(
                t(x_int, f64), t(y_int, f64), h, fill=fill
            )
            return torch.abs(ux).numpy(), torch.abs(vy).numpy()

        # x-face metrics: dxc (center distance across face), dy (face
        # edge length); y-face: dyc, dx.  Each padded with the corner
        # fill matching the direction of the stencils that consume it.
        dxc_int = g.dxc[:, h : h + n, h : h + n + 1]
        dyc_int = g.dyc[:, h : h + n + 1, h : h + n]
        dyf_int = g.dy[:, h : h + n, h : h + n + 1]
        dxf_int = g.dx[:, h : h + n + 1, h : h + n]
        dxc_p, _ = pad_faces(dxc_int, dyc_int, "x")
        _, dyc_p = pad_faces(dxc_int, dyc_int, "y")
        dyf_p, _ = pad_faces(dyf_int, dxf_int, "x")
        _, dxf_p = pad_faces(dyf_int, dxf_int, "y")

        # u/v-edge lengths (dgrid positions): dx at x-edges, dy at y-edges
        dxu_int = g.dx[:, h : h + n + 1, h : h + n]
        dyv_int = g.dy[:, h : h + n, h : h + n + 1]
        dxu_p, dyv_p = halo_exchange_dgrid(
            t(dxu_int, f64), t(dyv_int, f64), h
        )
        dxu_p = torch.where(torch.abs(dxu_p) > 0, torch.abs(dxu_p), 1.0)
        dyv_p = torch.where(torch.abs(dyv_p) > 0, torch.abs(dyv_p), 1.0)

        def face_embed_x(a):
            return t(np.asarray(a)[:, :, :N])

        def face_embed_y(a):
            return t(np.asarray(a)[:, :N, :])

        # --- non-orthogonality angles --------------------------------
        # at a point with unit coordinate directions e1 (x) and e2 (y),
        # cosa = e1 . e2; fluxes/KE need 1/sin^2 = 1/(1 - cosa^2)
        cor = g.corners_xyz  # padded [6, N+1, N+1, 3]
        cen = g.centers_xyz

        def unit(v):
            nrm = np.linalg.norm(v, axis=-1, keepdims=True)
            return v / np.where(nrm > 0, nrm, 1.0)

        # x-faces (j, I): e2 = corner(j+1,I)-corner(j,I) (the edge),
        # e1 = center(j,I)-center(j,I-1) (crossing direction)
        e2_u = unit(cor[:, 1:, :, :] - cor[:, :-1, :, :])  # [6, N, N+1]
        e1_u = unit(cen[:, :, 1:, :] - cen[:, :, :-1, :])  # [6, N, N-1]
        cosa_u = np.zeros((6, N, N))
        cosa_u[:, :, 1:] = np.sum(
            e1_u * e2_u[:, :, 1:-1, :], axis=-1
        )
        # y-faces (J, i): e1 = corner(J,i+1)-corner(J,i),
        # e2 = center(J,i)-center(J-1,i)
        e1_v = unit(cor[:, :, 1:, :] - cor[:, :, :-1, :])  # [6, N+1, N]
        e2_v = unit(cen[:, 1:, :, :] - cen[:, :-1, :, :])  # [6, N-1, N]
        cosa_v = np.zeros((6, N, N))
        cosa_v[:, 1:, :] = np.sum(
            e1_v[:, 1:-1, :, :] * e2_v, axis=-1
        )
        # corners (J, I): e1 along x (corner row), e2 along y
        e1_b = unit(cor[:, :, 2:, :] - cor[:, :, :-2, :])  # [6,N+1,N-1]
        e2_b = unit(cor[:, 2:, :, :] - cor[:, :-2, :, :])  # [6,N-1,N+1]
        cosa_b = np.zeros((6, N + 1, N + 1))
        cosa_b[:, 1:-1, 1:-1] = np.sum(
            e1_b[:, 1:-1, :, :] * e2_b[:, :, 1:-1, :], axis=-1
        )

        def clean_angle(c):
            c = np.where(np.isfinite(c), c, 0.0)
            c = np.clip(c, -0.8, 0.8)
            return c, 1.0 / (1.0 - c * c)

        cosa_u, rsin2_u = clean_angle(cosa_u)
        cosa_v, rsin2_v = clean_angle(cosa_v)
        cosa_b, rsin2_b = clean_angle(cosa_b)

        # --- boundary-face weights (chart-free reconstruction) -------
        def unit_np(vv):
            nn = np.linalg.norm(vv, axis=-1, keepdims=True)
            return vv / np.where(nn > 0, nn, 1.0)

        def cell_tangents(j, i):
            """Unit coordinate tangents of padded cell (j, i) from its
            own 4 edges (chart-free)."""
            tx = unit_np(
                (cor[:, j, i + 1] - cor[:, j, i])
                + (cor[:, j + 1, i + 1] - cor[:, j + 1, i])
            )
            ty = unit_np(
                (cor[:, j + 1, i] - cor[:, j, i])
                + (cor[:, j + 1, i + 1] - cor[:, j, i + 1])
            )
            return tx, ty  # [6, 3] each (vectorizable over j)

        def cell_tangents_col(i):
            # all padded rows j = 0..N-1 at column i -> [6, N, 3]
            tx = unit_np(
                (cor[:, :-1, i + 1] - cor[:, :-1, i])
                + (cor[:, 1:, i + 1] - cor[:, 1:, i])
            )
            ty = unit_np(
                (cor[:, 1:, i] - cor[:, :-1, i])
                + (cor[:, 1:, i + 1] - cor[:, :-1, i + 1])
            )
            return tx, ty

        def cell_tangents_row(j):
            tx = unit_np(
                (cor[:, j, 1:] - cor[:, j, :-1])
                + (cor[:, j + 1, 1:] - cor[:, j + 1, :-1])
            )
            ty = unit_np(
                (cor[:, 1 + j, :-1] - cor[:, j, :-1])
                + (cor[:, 1 + j, 1:] - cor[:, j, 1:])
            )
            return tx, ty

        def recon_coeffs(tx, ty):
            """C1, C2 with V = C1*u1 + C2*u2 given covariant (u1,u2)."""
            ca = np.sum(tx * ty, axis=-1, keepdims=True)
            det = np.maximum(1.0 - ca * ca, 1e-6)
            C1 = (tx - ca * ty) / det
            C2 = (ty - ca * tx) / det
            return C1, C2

        def xface_weights(I):
            """Weights for x-faces at padded column I, interior rows."""
            rows = slice(h, h + n)
            txL, tyL = cell_tangents_col(I - 1)
            txR, tyR = cell_tangents_col(I)
            C1L, C2L = recon_coeffs(txL[:, rows], tyL[:, rows])
            C1R, C2R = recon_coeffs(txR[:, rows], tyR[:, rows])
            # face normal & sina at (rows, I)
            edge = cor[:, h + 1 : h + n + 1, I] - cor[:, h : h + n, I]
            midp = unit_np(
                cor[:, h + 1 : h + n + 1, I] + cor[:, h : h + n, I]
            )
            nrm = unit_np(np.cross(edge, midp))
            sina_f = np.sqrt(
                np.maximum(1.0 - cosa_u[:, h : h + n, I] ** 2, 0.2)
            )[..., None]
            half_over_sina = 0.5 / sina_f
            w = np.stack(
                [
                    np.sum(C1L * nrm, axis=-1),
                    np.sum(C2L * nrm, axis=-1),
                    np.sum(C1R * nrm, axis=-1),
                    np.sum(C2R * nrm, axis=-1),
                ],
                axis=-1,
            ) * half_over_sina  # [6, n, 4]
            # corner-adjacent rows: one-sided from the INTERIOR cell
            # (the halo cell's covariant means contain corner-substituted
            # D-wind slots -- garbage inputs)
            interior_right = I == h  # west boundary: interior is right
            lo, hi = (2, 4) if interior_right else (0, 2)
            for r in (0, n - 1):
                w[:, r, :] = 0.0
                w[:, r, lo:hi] = (
                    np.stack(
                        [np.sum((C1R if interior_right else C1L)[:, r]
                                * nrm[:, r], -1),
                         np.sum((C2R if interior_right else C2L)[:, r]
                                * nrm[:, r], -1)], -1,
                    ) / sina_f[:, r]
                )
            return w

        def yface_weights(J):
            cols = slice(h, h + n)
            txL, tyL = cell_tangents_row(J - 1)
            txR, tyR = cell_tangents_row(J)
            C1L, C2L = recon_coeffs(txL[:, cols], tyL[:, cols])
            C1R, C2R = recon_coeffs(txR[:, cols], tyR[:, cols])
            edge = cor[:, J, h + 1 : h + n + 1] - cor[:, J, h : h + n]
            midp = unit_np(
                cor[:, J, h + 1 : h + n + 1] + cor[:, J, h : h + n]
            )
            nrm = unit_np(np.cross(midp, edge))
            sina_f = np.sqrt(
                np.maximum(1.0 - cosa_v[:, J, h : h + n] ** 2, 0.2)
            )[..., None]
            half_over_sina = 0.5 / sina_f
            w = np.stack(
                [
                    np.sum(C1L * nrm, axis=-1),
                    np.sum(C2L * nrm, axis=-1),
                    np.sum(C1R * nrm, axis=-1),
                    np.sum(C2R * nrm, axis=-1),
                ],
                axis=-1,
            ) * half_over_sina
            interior_right = J == h  # south boundary: interior is north
            lo, hi = (2, 4) if interior_right else (0, 2)
            for r in (0, n - 1):
                w[:, r, :] = 0.0
                w[:, r, lo:hi] = (
                    np.stack(
                        [np.sum((C1R if interior_right else C1L)[:, r]
                                * nrm[:, r], -1),
                         np.sum((C2R if interior_right else C2L)[:, r]
                                * nrm[:, r], -1)], -1,
                    ) / sina_f[:, r]
                )
            return w

        xbw_w = xface_weights(h)
        xbw_e = xface_weights(h + n)
        ybw_s = yface_weights(h)
        ybw_n = yface_weights(h + n)
        # boundary weights yield CONTRAVARIANT normal winds (V.n / sina,
        # the half_over_sina factor above), consistent with the interior
        # metric conversion; fluxes then use the dy*sina effective width
        # everywhere.  (Round 1 zeroed the interior cosa/sina metric --
        # the "orthogonal approximation" -- which mis-estimates interior
        # C-winds by up to cosa*|V| ~ 9 m/s on a 30 m/s jet and drove
        # the cube-corner mass pumping that xfailed the JW06 test.)
        sina_u_np = np.sqrt(np.maximum(1.0 - cosa_u ** 2, 0.2))
        sina_v_np = np.sqrt(np.maximum(1.0 - cosa_v ** 2, 0.2))

        # cell-centered coordinate angle for the A-grid KE
        e1_c = unit(cen[:, :, 2:, :] - cen[:, :, :-2, :])
        e2_c = unit(cen[:, 2:, :, :] - cen[:, :-2, :, :])
        cosa_cell = np.sum(
            e1_c[:, 1:-1, :, :] * e2_c[:, :, 1:-1, :], axis=-1
        )[:, h - 1 : h - 1 + n, h - 1 : h - 1 + n]
        cosa_cell, rsin2_cell = clean_angle(cosa_cell)


        fc = t(g.f_center[g.interior])
        self = cls(
            n=n,
            halo=h,
            area_px=area_px,
            area_py=area_py,
            rarea=1.0 / area_int,
            dx_u=dxu_p.to(dtype),
            dy_v=dyv_p.to(dtype),
            dxc_f=face_embed_x(dxc_p),
            dyc_f=face_embed_y(dyc_p),
            dy_f=face_embed_x(dyf_p),
            dx_f=face_embed_y(dxf_p),
            f_center=fc,
            f_px=halo_exchange(fc, h, fill="x"),
            f_py=halo_exchange(fc, h, fill="y"),
            area_c_int=t(g.area_c[:, h : h + n + 1, h : h + n + 1]),
            cosa_u=t(cosa_u),
            rsin2_u=t(rsin2_u),
            cosa_v=t(cosa_v),
            rsin2_v=t(rsin2_v),
            cosa_b=t(cosa_b),
            rsin2_b=t(rsin2_b),
            dy_fs=face_embed_x(dyf_p) * t(sina_u_np),
            dx_fs=face_embed_y(dxf_p) * t(sina_v_np),
            sina_u=t(sina_u_np),
            sina_v=t(sina_v_np),
            xbw_w=t(xbw_w),
            xbw_e=t(xbw_e),
            ybw_s=t(ybw_s),
            ybw_n=t(ybw_n),
            cosa_c=t(cosa_cell),
            rsin2_c=t(rsin2_cell),
        )
        # --- divergence-damper normalization --------------------------
        # power iteration for the largest eigenvalue of the symmetric
        # PSD operator T = M^T(A M .), M = linear_mass_div; div_damp
        # scales T by 8/lambda_max so d2 keeps the familiar
        # forward-Euler limit of 1/4 for a nondimensional Laplacian.
        # Same RandomState(0) start and 30 steps as the JAX package.
        area_j = t(1.0 / self.rarea.numpy())

        def T(uu, vv):
            div, vjp_fn = torch.func.vjp(
                lambda a, b: linear_mass_div(a, b, self), uu, vv
            )
            return vjp_fn(div * area_j)

        rng = np.random.RandomState(0)
        uu = t(rng.randn(6, n + 1, n))
        vv = t(rng.randn(6, n, n + 1))
        lam = torch.tensor(1.0, dtype=dtype)
        for _ in range(30):
            uu, vv = T(uu, vv)
            lam = torch.sqrt(torch.sum(uu ** 2) + torch.sum(vv ** 2))
            uu, vv = uu / lam, vv / lam
        lam = float(lam)
        if not np.isfinite(lam) or lam <= 0:
            raise RuntimeError("divergence-damper normalization failed")
        return dataclasses.replace(self, divdamp_scale=8.0 / lam).to(device)


def _masked_vertex_set(arr, idx, val):
    """arr with entry [..., cj, ci] replaced by val (a copy).

    The JAX package writes this as a one-hot select and silently does
    nothing for an index outside the array; here an out-of-range or
    negative index raises instead (torch indexing would wrap or raise
    later, far from the cause)."""
    cj, ci = idx
    A, B = arr.shape[-2], arr.shape[-1]
    if not (0 <= cj < A and 0 <= ci < B):
        raise IndexError(
            f"vertex index {(cj, ci)} outside the [{A}, {B}] lattice"
        )
    out = arr.clone()
    out[..., cj, ci] = val
    return out


def linear_mass_div(u, v, m):
    """The linear map winds -> unit-depth mass divergence per cell.

    Exactly the linearization (at rest) of the PPM mass transport:
    C-grid contravariant winds via c_grid_winds + boundary
    canonicalization + exchange, physical flux widths dy*sina, area
    divergence.  Transposed via torch.func.vjp in div_damp.
    """
    up, vp = halo_exchange_dgrid(u, v, m.halo)
    return _mass_div_from_padded(up, vp, m)


def _mass_div_from_padded(up, vp, m):
    """linear_mass_div body after the D-grid exchange."""
    h, n = m.halo, m.n
    lead = up.ndim - 3  # level axes between face and spatial dims
    uc, vc, _, _ = _cgrid_from_padded(up, vp, m)
    fx = uc * _lead_bc(m.dy_fs, lead)
    fy = vc * _lead_bc(m.dx_fs, lead)
    div = (fx - _shx(fx, 1)) + (fy - _shy(fy, 1))
    return div[..., h : h + n, h : h + n] * _lead_bc(m.rarea, lead)


def _cell_grad_op(q, m):
    """Simple cell->face difference operator (annihilates constants):
    returns (sx [6,...,n,n+1], sy [6,...,n+1,n]) interior+boundary face
    differences from fill-corner halo exchanges."""
    h, n = m.halo, m.n
    qx = halo_exchange(q, h, fill="x")
    qy = halo_exchange(q, h, fill="y")
    sx = (
        qx[..., h : h + n, h : h + n + 1]
        - qx[..., h : h + n, h - 1 : h + n]
    )
    sy = (
        qy[..., h : h + n + 1, h : h + n]
        - qy[..., h - 1 : h + n, h : h + n]
    )
    return sx, sy


def scalar_filter(q, m, c):
    """Conservative, provably dissipative del-4 filter on a cell scalar:
    q - (c/8) L(L(q)), L = (1/area) G^T(W G) with G the cell->face
    difference (symmetric negative-semidefinite in the area-weighted
    norm; G(const) = 0 makes it exactly conservative).

    Role: a tiny background 2-delta filter (c ~ 0.02) that keeps the weak
    boundary-ring mass mode of the linearized step neutral with
    negligible smoothing of resolved flow.  CUDA tensors go to the fused
    kernel (ops/cuda_filter.py: one launch that reads q through the
    x-fill and y-fill exchange tables), CPU tensors to the plain local
    form.
    """
    if c == 0.0:
        return q
    if q.is_cuda:
        from ..ops.cuda_filter import del4_filter_cuda

        squeeze = q.ndim == 3
        q4 = q[:, None] if squeeze else q
        out = del4_filter_cuda(q4.contiguous(), m.area_px, m.area_py, c,
                               m.halo)
        return out[:, 0] if squeeze else out
    return scalar_filter_plain(q, m, c)


def scalar_filter_plain(q, m, c):
    """The plain torch form of scalar_filter (any device): the
    vjp-assembled G^T(W G) written as an explicit flux-form Laplacian.
    Every face flux t = w * dq is subtracted/added to its two adjacent
    cells, and inter-face boundary faces -- computed by BOTH adjacent
    faces, once each -- carry doubled weight."""
    if c == 0.0:
        return q
    h, n = m.halo, m.n
    lead = q.ndim - 3
    # face weights = mean adjacent cell area, making (1/area) G^T(w G)
    # nondimensional with Laplacian-like eigenvalues <= ~8
    wfx = _lead_bc(0.5 * (
        m.area_px[:, h : h + n, h - 1 : h + n]
        + m.area_px[:, h : h + n, h : h + n + 1]
    ), lead)
    wfy = _lead_bc(0.5 * (
        m.area_py[:, h - 1 : h + n, h : h + n]
        + m.area_py[:, h : h + n + 1, h : h + n]
    ), lead)
    rarea = _lead_bc(m.rarea, lead)

    def L_local(qq):
        sx, sy = _cell_grad_op(qq, m)
        tx = sx * wfx
        ty = sy * wfy
        tx = torch.cat(
            [2.0 * tx[..., :1], tx[..., 1:-1], 2.0 * tx[..., -1:]], dim=-1
        )
        ty = torch.cat(
            [2.0 * ty[..., :1, :], ty[..., 1:-1, :],
             2.0 * ty[..., -1:, :]], dim=-2,
        )
        dq = (tx[..., :, :-1] - tx[..., :, 1:]) + (
            ty[..., :-1, :] - ty[..., 1:, :]
        )
        return dq * rarea

    # del-4 (L^2/8): 2-delta damped at ~8c, resolved scales (k dx)^2
    # weaker than the del-2 form; conservative and dissipative for any
    # composition of the self-adjoint PSD L
    return q - (c / 8.0) * L_local(L_local(q))


def vort_damp(u, v, m, cv):
    """Vorticity-damping wind increments: -(cv/8) (V^T V)^2 u, V the
    nondimensional cell circulation (plain edge differences, face-local,
    no halo), in its forward-only local form.  Symmetric
    negative-semidefinite; removes the boundary-ring wind-sawtooth modes
    that the Coriolis term pumps at ~f*dt*cosa."""
    if cv == 0.0:
        return torch.zeros_like(u), torch.zeros_like(v)

    def Vop_local(uu, vv):
        return (
            uu[..., :-1, :] - uu[..., 1:, :]
            + vv[..., :, 1:] - vv[..., :, :-1]
        )

    def VT_local(t):
        zj = torch.zeros_like(t[..., :1, :])
        zi = torch.zeros_like(t[..., :, :1])
        du = torch.cat([t, zj], dim=-2) - torch.cat([zj, t], dim=-2)
        dv = torch.cat([zi, t], dim=-1) - torch.cat([t, zi], dim=-1)
        return du, dv

    du1, dv1 = VT_local(Vop_local(u, v))
    du, dv = VT_local(Vop_local(du1, dv1))
    return -(cv / 8.0) * du, -(cv / 8.0) * dv


@lru_cache(maxsize=None)
def _corner_multiplicity(n: int):
    """How many faces compute each physical corner point of one face's
    own (n+1, n+1) corner lattice: 1 interior, 2 on shared edges, 3 at
    cube vertices."""
    w = np.ones((n + 1, n + 1))
    w[0, :] = w[-1, :] = 2.0
    w[:, 0] = w[:, -1] = 2.0
    w[0, 0] = w[0, -1] = w[-1, 0] = w[-1, -1] = 3.0
    return w


def _div_b_op(u, v, m):
    """B-grid (corner-lattice) computational divergence: plain
    covariant-difference 4-term form on the padded D winds, cropped to
    this face's own corners [6, ..., n+1, n+1]."""
    up, vp = halo_exchange_dgrid(u, v, m.halo)
    return _div_b_from_padded(up, vp, m)


def _div_b_from_padded(up, vp, m):
    h, n = m.halo, m.n
    u_pad = torch.nn.functional.pad(up, (1, 1))
    v_pad = torch.nn.functional.pad(vp, (0, 0, 1, 1))
    div_b = (u_pad[..., :, 1:] - u_pad[..., :, :-1]) + (
        v_pad[..., 1:, :] - v_pad[..., :-1, :]
    )
    return div_b[..., h : h + n + 1, h : h + n + 1]


def corner_div_damp(u, v, m, c):
    """Weak corner-lattice divergence damper: -c * D^T(W D u), D the
    computational (covariant-difference) corner divergence, W =
    1/multiplicity; the transpose comes from torch.func.vjp.  Covers the
    modes in the null space of the D->C interpolation that the metric
    damper (div_damp) cannot see."""
    if c == 0.0:
        return torch.zeros_like(u), torch.zeros_like(v)
    inv_mult = torch.as_tensor(
        1.0 / _corner_multiplicity(m.n), dtype=u.dtype, device=u.device
    )
    div, vjp_fn = torch.func.vjp(lambda uu, vv: _div_b_op(uu, vv, m), u, v)
    du, dv = vjp_fn(div * inv_mult)
    return -c * du, -c * dv


def div_damp(u, v, m, d2):
    """Divergence-damping wind increments: -d2*(8/lam) * M^T(A M u),
    M = linear_mass_div (the TRUE metric cell divergence), A = area,
    lam the measured largest eigenvalue (SWMetrics.divdamp_scale); the
    transpose comes from torch.func.vjp.  Symmetric negative-semidefinite
    and, because M is a metric divergence, it vanishes on smooth
    non-divergent flow including across face boundaries."""
    if d2 == 0.0:
        return torch.zeros_like(u), torch.zeros_like(v)
    area = _lead_bc(1.0 / m.rarea, u.ndim - 3)
    div, vjp_fn = torch.func.vjp(
        lambda uu, vv: linear_mass_div(uu, vv, m), u, v
    )
    du, dv = vjp_fn(div * area)
    c = d2 * m.divdamp_scale
    return -c * du, -c * dv


def c_grid_winds(up, vp, m):
    """Contravariant C-face winds from padded D-grid winds.

    Interior faces: 4-point covariant average + metric conversion.
    Tile-boundary faces: chart-free reconstruction via the precomputed
    boundary weights (see SWMetrics), because the regular stencil
    straddles the inter-face coordinate kink (up to ~40% normal-wind
    error near cube corners, which pumps mass).
    up/vp may carry leading level axes before the two spatial axes.
    """
    h, n = m.halo, m.n
    N = n + 2 * h
    lead = up.ndim - 3

    def bc(a):
        return _lead_bc(a, lead)

    u_l = up[..., :-1, :]
    u_u = up[..., 1:, :]
    uc_cov = 0.25 * (_shx(u_l, -1) + u_l + _shx(u_u, -1) + u_u)
    v_l = vp[..., :, :-1]
    v_u = vp[..., :, 1:]
    vc_cov = 0.25 * (_shy(v_l, -1) + v_l + _shy(v_u, -1) + v_u)

    uc_A = (uc_cov - bc(m.cosa_u) * vp[..., :, :N]) * bc(m.rsin2_u)
    vc_A = (vc_cov - bc(m.cosa_v) * up[..., :N, :]) * bc(m.rsin2_v)

    # --- boundary faces: V = C1*u1 + C2*u2 per adjacent cell, averaged
    # and projected on the face normal (weights precomputed) ----------
    rows = slice(h, h + n)
    u1c = 0.5 * (up[..., :-1, :] + up[..., 1:, :])  # cell mean of u
    u2c = 0.5 * (vp[..., :, :-1] + vp[..., :, 1:])  # cell mean of v

    def xpatch(I, w):
        return (
            bc(w[..., 0]) * u1c[..., rows, I - 1]
            + bc(w[..., 1]) * u2c[..., rows, I - 1]
            + bc(w[..., 2]) * u1c[..., rows, I]
            + bc(w[..., 3]) * u2c[..., rows, I]
        )

    def ypatch(J, w):
        return (
            bc(w[..., 0]) * u1c[..., J - 1, rows]
            + bc(w[..., 1]) * u2c[..., J - 1, rows]
            + bc(w[..., 2]) * u1c[..., J, rows]
            + bc(w[..., 3]) * u2c[..., J, rows]
        )

    # uc_A/vc_A are fresh tensors: the boundary columns/rows are written
    # in place (the patches read only up/vp)
    uc_A[..., rows, h] = xpatch(h, m.xbw_w)
    uc_A[..., rows, h + n] = xpatch(h + n, m.xbw_e)
    vc_A[..., h, rows] = ypatch(h, m.ybw_s)
    vc_A[..., h + n, rows] = ypatch(h + n, m.ybw_n)
    return uc_A, vc_A


def _cgrid_from_padded(up, vp, m):
    """c_grid_winds + boundary canonicalization + both C-grid exchanges:
    (uc fill x, vc fill y, vc fill x, uc fill y) on the padded lattices."""
    h, n = m.halo, m.n
    N = n + 2 * h
    uc_A, vc_A = c_grid_winds(up, vp, m)
    uc_int = uc_A[..., h : h + n, h : h + n + 1]
    vc_int = vc_A[..., h : h + n + 1, h : h + n]
    uc_int, vc_int = canonicalize_cgrid_boundary(uc_int, vc_int)
    ucx_p, vcx_p = halo_exchange_cgrid(uc_int, vc_int, h, fill="x")
    ucy_p, vcy_p = halo_exchange_cgrid(uc_int, vc_int, h, fill="y")
    return (
        ucx_p[..., :, :N],
        vcy_p[..., :N, :],
        vcx_p[..., :N, :],
        ucy_p[..., :, :N],
    )


def padded_cgrid_winds(u, v, m: "SWMetrics", up=None, vp=None):
    """Canonical contravariant C-face winds on the padded lattices.

    The c_grid_winds + boundary-canonicalization + C-grid-exchange
    chain shared by the D stage and the cheap C half-stage.  Returns
    (uc, vc, vc_on_x, uc_on_y): uc on the x-face lattice (fill='x'),
    vc on the y-face lattice (fill='y'), plus each wind's partner from
    the OTHER fill (consumed by the half-stage tangential averages).
    """
    if up is None:
        up, vp = halo_exchange_dgrid(u, v, m.halo)
    return _cgrid_from_padded(up, vp, m)


def _c_half_winds_common(uc, vc, vc_on_x, uc_on_y, up, vp, m):
    """Geometry-only pieces of the C half-stage wind update: cell-mean
    winds, cell KE, absolute vorticity (all on the padded lattice), plus
    the face-tangential winds."""
    lead = up.ndim - 3

    def bc(a):
        return _lead_bc(a, lead)

    # cell-mean contravariant winds and (orthogonal-approx) KE
    ub = 0.5 * (uc + _shx(uc, 1))
    vb = 0.5 * (vc + _shy(vc, 1))
    ke = 0.5 * (ub * ub + vb * vb)
    # absolute vorticity at cell centers (padded; circulation of the
    # covariant D winds over the padded metric lengths)
    udx = up * bc(m.dx_u)
    vdy = vp * bc(m.dy_v)
    vort = (
        udx[..., :-1, :] - udx[..., 1:, :]
        + vdy[..., :, 1:] - vdy[..., :, :-1]
    )
    rarea_p = 1.0 / bc(m.area_px)
    zeta = vort * rarea_p + bc(m.f_px)
    # face-mean absolute vorticity and tangential winds
    zf_u = 0.5 * (zeta + _shx(zeta, -1))
    zf_v = 0.5 * (zeta + _shy(zeta, -1))
    vbar_u = 0.25 * (
        vc_on_x + _shy(vc_on_x, 1)
        + _shx(vc_on_x, -1) + _shx(_shy(vc_on_x, 1), -1)
    )
    ubar_v = 0.25 * (
        uc_on_y + _shx(uc_on_y, 1)
        + _shy(uc_on_y, -1) + _shy(_shx(uc_on_y, 1), -1)
    )
    return bc, ke, rarea_p, zf_u, zf_v, vbar_u, ubar_v


def _finish_c_half(uc, vc, duc, dvc, m: "SWMetrics"):
    """Crop the updated C winds to own faces, re-canonicalize the
    shared tile-boundary copies, and redistribute both fills."""
    h, n = m.halo, m.n
    N = n + 2 * h
    uc_i = (uc + duc)[..., h : h + n, h : h + n + 1]
    vc_i = (vc + dvc)[..., h : h + n + 1, h : h + n]
    uc_i, vc_i = canonicalize_cgrid_boundary(uc_i, vc_i)
    ucx_p, _ = halo_exchange_cgrid(uc_i, vc_i, h, fill="x")
    _, vcy_p = halo_exchange_cgrid(uc_i, vc_i, h, fill="y")
    return ucx_p[..., :, :N], vcy_p[..., :N, :]
