"""Conservative PPM vertical remapping (the mappm algorithm) in torch.

A frozen copy of the plain forms of the port's
``fv3net_tpu_torch/ops/remap.py``, for the benchmark's reference dycore:
``cs_profile`` (cubic-spline edge reconstruction, kord 8-16 limiter
variants and the unlimited kord > 16, mappm.f90:132-509) with the
``cs_limiters`` it calls, ``ppm_profile`` (4th-order edges + Huynh
constraint for kord <= 7, mappm.f90:614-852) with ``ppm_limiters``, the
remap integration ``ppm_remap_plain`` and ``remap_levels``, the dycore's
entry point on the native [F, nz, Y, X] layout (level axis 1).  The
kernel dispatch, the jit unit and the diagnostics' interpolation are
left out.
"""

from __future__ import annotations

import torch


def _clamp(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def _mono_clamp(q, a, b):
    """Clamp q into [min(a,b), max(a,b)]."""
    return _clamp(q, torch.minimum(a, b), torch.maximum(a, b))


# ---------------------------------------------------------------------------
# limiters (elementwise on one layer's (a, al, ar, a6))
# ---------------------------------------------------------------------------


def _standard_ppm_constraint(a, al, ar, a6):
    """The classic PPM overshoot constraint (non-extremum branch)."""
    da1 = ar - al
    da2 = da1 * da1
    a6da = a6 * da1
    # case 1: a6da < -da2 -> left-biased parabola
    a6_1 = 3.0 * (al - a)
    ar_1 = al - a6_1
    # case 2: a6da > da2 -> right-biased
    a6_2 = 3.0 * (ar - a)
    al_2 = ar - a6_2
    lo = a6da < -da2
    hi = a6da > da2
    al_new = torch.where(hi, al_2, al)
    ar_new = torch.where(lo, ar_1, ar)
    a6_new = torch.where(lo, a6_1, torch.where(hi, a6_2, a6))
    return al_new, ar_new, a6_new


def _flatten(a, al, ar, a6, cond):
    """Replace the parabola by the constant a where cond."""
    return (
        torch.where(cond, a, al),
        torch.where(cond, a, ar),
        torch.where(cond, torch.zeros_like(a6), a6),
    )


def _positive_constraint(a, al, ar, a6, act):
    """Flatten or bias the parabola toward its lower edge where `act`
    (its interior minimum is negative); shared by cs_limiters mode 0 and
    ppm_limiters lmt 2."""
    mid_low = (a < ar) & (a < al)
    right_up = ar > al
    alf, arf, a6f = _flatten(a, al, ar, a6, act & mid_low)
    a6_l = 3.0 * (al - a)
    ar_l = al - a6_l
    a6_r = 3.0 * (ar - a)
    al_r = ar - a6_r
    use_l = act & (~mid_low) & right_up
    use_r = act & (~mid_low) & (~right_up)
    return (
        torch.where(use_r, al_r, alf),
        torch.where(use_l, ar_l, arf),
        torch.where(use_l, a6_l, torch.where(use_r, a6_r, a6f)),
    )


def _negative_minimum(a, al, ar, a6):
    """The parabola has an interior minimum below zero."""
    da1 = ar - al
    has_min = torch.abs(da1) < -a6
    safe_a6 = torch.where(a6 == 0.0, torch.ones_like(a6), a6)
    fmin = a + 0.25 * da1 * da1 / safe_a6 + a6 * (1.0 / 12.0)
    return has_min & (fmin < 0.0)


def cs_limiters(a, al, ar, a6, extm, mode: int):
    """cs_limiters (mappm.f90:535-612).

    mode 0: positive-definite constraint
    mode 1: monotone wrt the cell mean (used for top/bottom layers)
    mode 2: standard PPM constraint gated on the extremum flag
    """
    if mode == 0:
        nonpos = a <= 0.0
        al0, ar0, a60 = _flatten(a, al, ar, a6, nonpos)
        neg_min = _negative_minimum(a, al0, ar0, a60) & (~nonpos)
        return _positive_constraint(a, al0, ar0, a60, neg_min)
    if mode == 1:
        is_ext = (a - al) * (a - ar) >= 0.0
        al0, ar0, a60 = _flatten(a, al, ar, a6, is_ext)
        al1, ar1, a61 = _standard_ppm_constraint(a, al0, ar0, a60)
        return (
            torch.where(is_ext, al0, al1),
            torch.where(is_ext, ar0, ar1),
            torch.where(is_ext, a60, a61),
        )
    if mode == 2:
        al0, ar0, a60 = _flatten(a, al, ar, a6, extm)
        al1, ar1, a61 = _standard_ppm_constraint(a, al0, ar0, a60)
        return (
            torch.where(extm, al0, al1),
            torch.where(extm, ar0, ar1),
            torch.where(extm, a60, a61),
        )
    raise ValueError(f"unknown cs_limiters mode {mode}")


def ppm_limiters(dm, a, al, ar, a6, lmt: int):
    """ppm_limiters (mappm.f90:854-930).

    lmt 0: standard PPM constraint (flatten where slope dm == 0)
    lmt 1: full monotonicity (Lin 2004)
    lmt 2: positive definite
    lmt 3: no-op
    """
    if lmt == 3:
        return al, ar, a6
    if lmt == 0:
        flat = dm == 0.0
        al0, ar0, a60 = _flatten(a, al, ar, a6, flat)
        al1, ar1, a61 = _standard_ppm_constraint(a, al0, ar0, a60)
        return (
            torch.where(flat, al0, al1),
            torch.where(flat, ar0, ar1),
            torch.where(flat, a60, a61),
        )
    if lmt == 1:
        qmp = 2.0 * dm
        # Fortran sign(x, 0.) is +|x|, unlike torch.sign(0) == 0
        szero = torch.where(qmp == 0.0, torch.ones_like(qmp),
                            torch.sign(qmp))
        al1 = a - szero * torch.minimum(torch.abs(qmp), torch.abs(al - a))
        ar1 = a + szero * torch.minimum(torch.abs(qmp), torch.abs(ar - a))
        a61 = 3.0 * (2.0 * a - (al1 + ar1))
        return al1, ar1, a61
    if lmt == 2:
        act = _negative_minimum(a, al, ar, a6)
        return _positive_constraint(a, al, ar, a6, act)
    raise ValueError(f"unknown ppm_limiters lmt {lmt}")


# ---------------------------------------------------------------------------
# cs_profile: cubic-spline edge reconstruction
# ---------------------------------------------------------------------------


def _edge_spline(a, dp, iv: int, qs):
    """Tridiagonal cubic-spline solve for edge values qe[0..km].

    a, dp: [km, ...] (k leading); returns qe [km+1, ...].  iv = -2 is the
    w-wind variant closed by the prescribed surface value qs.
    """
    km = a.shape[0]
    if iv == -2:
        q = 1.5 * a[0]
        g = torch.full_like(a[0], 0.5)
        qe_fwd, gam = [q], [g]  # gam[e] multiplies qe[e+1] in qe[e]
        for e in range(1, km - 1):  # forward elimination
            grat = dp[e - 1] / dp[e]
            bet = 2.0 + grat + grat - g
            q = (3.0 * (a[e - 1] + a[e]) - q) / bet
            g = grat / bet
            qe_fwd.append(q)
            gam.append(g)
        grat_b = dp[km - 2] / dp[km - 1]
        q_next = (
            3.0 * (a[km - 2] + a[km - 1]) - grat_b * qs - q
        ) / (2.0 + grat_b + grat_b - g)
        qe = [None] * (km + 1)
        qe[km], qe[km - 1] = qs, q_next
        for e in range(km - 2, -1, -1):  # back substitution
            q_next = qe_fwd[e] - gam[e] * q_next
            qe[e] = q_next
        return torch.stack(qe)

    grat = dp[1] / dp[0]
    bet0 = grat * (grat + 0.5)
    q = ((grat + grat) * (grat + 1.0) * a[0] + a[1]) / bet0
    g = (1.0 + grat * (grat + 1.5)) / bet0
    qe_fwd, gam = [q], [g]
    for e in range(1, km):  # forward elimination
        d4 = dp[e - 1] / dp[e]
        bet = 2.0 + d4 + d4 - g
        q = (3.0 * (a[e - 1] + d4 * a[e]) - q) / bet
        g = d4 / bet
        qe_fwd.append(q)
        gam.append(g)
    d4b = dp[km - 2] / dp[km - 1]
    a_bot = 1.0 + d4b * (d4b + 1.5)
    q_next = (
        2.0 * d4b * (d4b + 1.0) * a[km - 1] + a[km - 2] - a_bot * q
    ) / (d4b * (d4b + 0.5) - a_bot * g)
    qe = [None] * (km + 1)
    qe[km] = q_next
    for e in range(km - 1, -1, -1):  # back substitution
        q_next = qe_fwd[e] - gam[e] * q_next
        qe[e] = q_next
    return torch.stack(qe)


def _huynh_edges(a, al, ar, dA, dA_p1, dA_p2, dA_m1):
    """Huynh-style pmp/lac clamping of both edges."""
    pmp_1 = a - 2.0 * dA_p1
    lac_1 = pmp_1 + 1.5 * dA_p2
    al2 = _clamp(
        al,
        torch.minimum(torch.minimum(a, pmp_1), lac_1),
        torch.maximum(torch.maximum(a, pmp_1), lac_1),
    )
    pmp_2 = a + 2.0 * dA
    lac_2 = pmp_2 - 1.5 * dA_m1
    ar2 = _clamp(
        ar,
        torch.minimum(torch.minimum(a, pmp_2), lac_2),
        torch.maximum(torch.maximum(a, pmp_2), lac_2),
    )
    return al2, ar2


def _set(x, k, val):
    """x with row k replaced by val (a copy)."""
    x = x.clone()
    x[k] = val
    return x


def _set3(al, ar, a6, k, vals):
    return _set(al, k, vals[0]), _set(ar, k, vals[1]), _set(a6, k, vals[2])


def _kidx(km, a):
    """Level index broadcastable against a [km, ...]."""
    return torch.arange(km, device=a.device).reshape(
        (-1,) + (1,) * (a.dim() - 1)
    )


def _next(x):
    """x[c+1] at row c, the last row repeated."""
    return torch.cat([x[1:], x[-1:]], dim=0)


def _interior_constraint(ak, a, al, ar, hal, har, extm, ext5, ext6):
    """(al, ar, a6) of the kord-variant interior constraint
    (mappm.f90 cs_profile, abs(kord) in 8..16)."""

    def a6_of(l, r):
        return 3.0 * (2.0 * a - (l + r))

    extm_m1, extm_p1 = torch.roll(extm, 1, dims=0), _next(extm)
    ext5_m1, ext5_p1 = torch.roll(ext5, 1, dims=0), _next(ext5)
    ext6_m1, ext6_p1 = torch.roll(ext6, 1, dims=0), _next(ext6)
    if ak < 9:
        return hal, har, a6_of(hal, har)
    if ak in (9, 12):
        a6_g = 6.0 * a - 3.0 * (al + ar)
        nonmono = torch.abs(a6_g) > torch.abs(al - ar)
        al_s = torch.where(nonmono, hal, al)
        ar_s = torch.where(nonmono, har, ar)
        a6_s = 6.0 * a - 3.0 * (al_s + ar_s)
        # kord 9 flattens 2-delta-z waves, kord 12 every extremum
        flat = (extm & extm_m1) | (extm & extm_p1) if ak == 9 else extm
        return (
            torch.where(flat, a, al_s),
            torch.where(flat, a, ar_s),
            torch.where(flat, torch.zeros_like(a6_s), a6_s),
        )
    if ak == 11:
        noisy = ext5 & (ext5_m1 | ext5_p1)
        return (
            torch.where(noisy, a, al),
            torch.where(noisy, a, ar),
            torch.where(noisy, torch.zeros_like(a), a6_of(al, ar)),
        )
    if ak == 14:
        return al, ar, a6_of(al, ar)
    nb5 = ext5_m1 | ext5_p1
    nb6 = ext6_m1 | ext6_p1
    if ak == 10:
        flat, huynh = ext5 & nb5, (ext5 & nb6) | (ext6 & nb5)
    elif ak == 13:
        flat, huynh = ext6 & ext6_m1 & ext6_p1, torch.zeros_like(ext6)
    elif ak == 15:
        flat, huynh = ext5 & nb5, ~ext5 & ext6
    else:  # 16
        flat, huynh = ext5 & nb5, ext5 & ~nb5 & nb6
    al_n = torch.where(flat, a, torch.where(huynh, hal, al))
    ar_n = torch.where(flat, a, torch.where(huynh, har, ar))
    return al_n, ar_n, a6_of(al_n, ar_n)


def cs_profile(a, dp, iv: int, kord: int, qs=None):
    """Cubic-spline PPM reconstruction (cs_profile, mappm.f90:132-509).

    Args:
        a: layer means, shape [km, ...] (k leading)
        dp: layer thicknesses, same shape
        iv: -2 vertical velocity, -1 winds, 0 positive-definite scalars,
            1 others, 2 temperature
        kord: limiter variant; abs(kord) in 8..16 selects the interior
            constraint; abs(kord) > 16 is the unlimited linear scheme
        qs: surface value, required for iv == -2 (zero if omitted)

    Returns:
        (al, ar, a6): left edge, right edge, curvature arrays [km, ...]
    """
    km = a.shape[0]
    if iv == -2 and qs is None:
        qs = torch.zeros_like(a[0])
    qe = _edge_spline(a, dp, iv, qs)

    if abs(kord) > 16:
        al = qe[:-1]
        ar = qe[1:]
        return al, ar, 3.0 * (2.0 * a - (al + ar))

    # --- large-scale constraints on edge values -------------------------
    # dA[c] = a[c] - a[c-1], defined for c = 1..km-1 (index c)
    dA = torch.cat([torch.zeros_like(a[:1]), a[1:] - a[:-1]], dim=0)

    qe = _set(qe, 1, _mono_clamp(qe[1], a[0], a[1]))
    # interior edges e = 2..km-2
    e_idx = _kidx(km + 1, a)
    interior_e = (e_idx >= 2) & (e_idx <= km - 2)
    # per-edge neighbors: for edge e, cells e-1 and e
    a_lo = torch.cat([a[:1], a], dim=0)  # a[e-1] at index e (e>=1)
    a_hi = torch.cat([a, a[-1:]], dim=0)  # a[e] at index e (e<=km-1)
    ze = torch.zeros_like(dA[:1])
    # dA_em1[e] = dA[e-1]; dA_ep1[e] = dA[e+1] (edge-indexed, len km+1)
    dA_em1 = torch.cat([ze, dA], dim=0)
    dA_ep1 = torch.cat([dA[1:], ze, ze], dim=0)
    both_pos = dA_em1 * dA_ep1 > 0.0
    clamped = _mono_clamp(qe, a_lo, a_hi)
    local_max = dA_em1 > 0.0
    qe_max = torch.maximum(qe, torch.minimum(a_lo, a_hi))
    qe_min = torch.minimum(qe, torch.maximum(a_lo, a_hi))
    if iv == 0:
        qe_min = torch.clamp_min(qe_min, 0.0)
    qe_int = torch.where(
        both_pos, clamped, torch.where(local_max, qe_max, qe_min)
    )
    qe = torch.where(interior_e, qe_int, qe)
    qe = _set(qe, km - 1, _mono_clamp(qe[km - 1], a[km - 2], a[km - 1]))

    al = qe[:-1]
    ar = qe[1:]

    # --- extremum flags -------------------------------------------------
    c_idx = _kidx(km, a)
    dA_cp1 = torch.cat([dA[1:], torch.zeros_like(dA[:1])], dim=0)
    extm_int = dA * dA_cp1 < 0.0
    extm_bnd = (al - a) * (ar - a) > 0.0
    extm = torch.where(
        (c_idx == 0) | (c_idx == km - 1), extm_bnd, extm_int
    )
    x0 = 2.0 * a - (al + ar)
    x1 = torch.abs(al - ar)
    a6 = 3.0 * x0
    ext5 = torch.abs(x0) > x1
    ext6 = torch.abs(a6) > x1

    # --- top boundary ---------------------------------------------------
    if iv == 0:
        al = _set(al, 0, torch.clamp_min(al[0], 0.0))
    elif iv == -1:
        al = _set(
            al, 0, torch.where(al[0] * a[0] <= 0.0,
                               torch.zeros_like(al[0]), al[0])
        )
    elif iv == 2:
        al, ar = _set(al, 0, a[0]), _set(ar, 0, a[0])
        a6 = _set(a6, 0, torch.zeros_like(a6[0]))
    if iv != 2:
        a6 = _set(a6, 0, 3.0 * (2.0 * a[0] - (al[0] + ar[0])))
        al, ar, a6 = _set3(
            al, ar, a6, 0,
            cs_limiters(a[0], al[0], ar[0], a6[0], extm[0], 1),
        )
    a6 = _set(a6, 1, 3.0 * (2.0 * a[1] - (al[1] + ar[1])))
    al, ar, a6 = _set3(
        al, ar, a6, 1, cs_limiters(a[1], al[1], ar[1], a6[1], extm[1], 2)
    )

    # --- interior cells c = 2..km-3: kord-variant constraints -----------
    inter = (c_idx >= 2) & (c_idx <= km - 3)
    shz = torch.zeros_like(dA[:1])
    dA_m1 = torch.roll(dA, 1, dims=0)  # dA[c-1]
    dA_p1 = torch.cat([dA[1:], shz], dim=0)  # dA[c+1]
    dA_p2 = torch.cat([dA[2:], shz, shz], dim=0)  # dA[c+2]
    hal, har = _huynh_edges(a, al, ar, dA, dA_p1, dA_p2, dA_m1)
    al_n, ar_n, a6_n = _interior_constraint(
        abs(kord), a, al, ar, hal, har, extm, ext5, ext6
    )
    al = torch.where(inter, al_n, al)
    ar = torch.where(inter, ar_n, ar)
    a6 = torch.where(inter, a6_n, a6)

    if iv == 0:
        lp = cs_limiters(a, al, ar, a6, extm, 0)
        al = torch.where(inter, lp[0], al)
        ar = torch.where(inter, lp[1], ar)
        a6 = torch.where(inter, lp[2], a6)

    # --- bottom boundary ------------------------------------------------
    if iv == 0:
        ar = _set(ar, km - 1, torch.clamp_min(ar[km - 1], 0.0))
    elif iv == -1:
        ar = _set(
            ar, km - 1,
            torch.where(ar[km - 1] * a[km - 1] <= 0.0,
                        torch.zeros_like(ar[km - 1]), ar[km - 1]),
        )
    for c, mode in ((km - 2, 2), (km - 1, 1)):
        a6 = _set(a6, c, 3.0 * (2.0 * a[c] - (al[c] + ar[c])))
        al, ar, a6 = _set3(
            al, ar, a6, c,
            cs_limiters(a[c], al[c], ar[c], a6[c], extm[c], mode),
        )
    return al, ar, a6


# ---------------------------------------------------------------------------
# ppm_profile: the kord <= 7 reconstruction
# ---------------------------------------------------------------------------


def ppm_profile(a, dp, iv: int, kord: int):
    """4th-order PPM reconstruction (ppm_profile, mappm.f90:614-852).

    a, dp: [km, ...] (k leading).  Returns (al, ar, a6).
    """
    km = a.shape[0]
    zc = torch.zeros_like(a[:1])
    delq = a[1:] - a[:-1]  # [km-1]: delq[c] = a[c+1]-a[c]
    # cell-indexed: d4_c[c] = dp[c-1]+dp[c] for c>=1
    d4_c = torch.cat([zc, dp[:-1] + dp[1:]], dim=0)
    delq_c = torch.cat([delq, zc], dim=0)  # delq_c[c] = a[c+1]-a[c]
    delq_m1 = torch.cat([zc, delq], dim=0)  # delq_m1[c] = a[c]-a[c-1]

    def pos(x):
        return torch.clamp_min(x, 1e-30)

    # monotone-limited slope dc for c = 1..km-2
    dp_m1 = torch.roll(dp, 1, dims=0)
    dp_p1 = _next(dp)
    d4_p1 = torch.cat([d4_c[1:], zc], dim=0)
    c1s = (dp_m1 + 0.5 * dp) / pos(d4_p1)
    c2s = (dp_p1 + 0.5 * dp) / pos(d4_c)
    df2 = dp * (c1s * delq_c + c2s * delq_m1) / pos(d4_c + dp_p1)
    a_m1 = torch.roll(a, 1, dims=0)
    a_p1 = _next(a)
    amax = torch.maximum(torch.maximum(a_m1, a), a_p1)
    amin = torch.minimum(torch.minimum(a_m1, a), a_p1)
    dc = torch.sign(df2) * torch.minimum(
        torch.abs(df2), torch.minimum(amax - a, a - amin)
    )
    c_idx = _kidx(km, a)
    zero = torch.zeros_like(a)
    dc = torch.where((c_idx >= 1) & (c_idx <= km - 2), dc, zero)

    # 4th-order left edges for c = 2..km-2
    dc_m1 = torch.roll(dc, 1, dims=0)
    d4_m1 = torch.roll(d4_c, 1, dims=0)
    c1e = delq_m1 * dp_m1 / pos(d4_c)
    a1e = d4_m1 / pos(d4_c + dp_m1)
    a2e = d4_p1 / pos(d4_c + dp)
    al = a_m1 + c1e + 2.0 / pos(d4_m1 + d4_p1) * (
        dp * (c1e * (a1e - a2e) + a2e * dc_m1) - dp_m1 * a1e * dc
    )
    al = torch.where((c_idx >= 2) & (c_idx <= km - 2), al, zero)

    # top boundary: area-preserving cubic with zero 2nd derivative
    d1, d2 = dp[0], dp[1]
    qm = (d2 * a[0] + d1 * a[1]) / (d1 + d2)
    dq = 2.0 * (a[1] - a[0]) / (d1 + d2)
    c1t = 4.0 * (al[2] - qm - d2 * dq) / (
        d2 * (2.0 * d2 * d2 + d1 * (d2 + 3.0 * d1))
    )
    c3t = dq - 0.5 * c1t * (d2 * (5.0 * d1 + d2) - 3.0 * d1 * d1)
    al1 = qm - 0.25 * c1t * d1 * d2 * (d2 + 3.0 * d1)
    al0 = d1 * (2.0 * c1t * d1 * d1 - c3t) + al1
    al1 = _mono_clamp(al1, a[0], a[1])
    al = _set(_set(al, 1, al1), 0, al0)
    dc = _set(dc, 0, 0.5 * (al[1] - a[0]))

    ar_top = None
    if iv == 0:
        al = _set(al, 0, torch.clamp_min(al[0], 0.0))
        al = _set(al, 1, torch.clamp_min(al[1], 0.0))
    elif iv == -1:
        al = _set(al, 0, torch.where(al[0] * a[0] <= 0.0,
                                     torch.zeros_like(al[0]), al[0]))
    elif abs(iv) == 2:
        al = _set(al, 0, a[0])
        ar_top = a[0]

    # bottom boundary
    d1, d2 = dp[km - 1], dp[km - 2]
    qm = (d2 * a[km - 1] + d1 * a[km - 2]) / (d1 + d2)
    dq = 2.0 * (a[km - 2] - a[km - 1]) / (d1 + d2)
    c1b = (al[km - 1] - qm - d2 * dq) / (
        d2 * (2.0 * d2 * d2 + d1 * (d2 + 3.0 * d1))
    )
    c3b = dq - 2.0 * c1b * (d2 * (5.0 * d1 + d2) - 3.0 * d1 * d1)
    al_km1 = qm - c1b * d1 * d2 * (d2 + 3.0 * d1)
    ar_bot = d1 * (8.0 * c1b * d1 * d1 - c3b) + al_km1
    al_km1 = _mono_clamp(al_km1, a[km - 1], a[km - 2])
    al = _set(al, km - 1, al_km1)
    dc = _set(dc, km - 1, 0.5 * (a[km - 1] - al[km - 1]))
    if iv == 0:
        al = _set(al, km - 1, torch.clamp_min(al[km - 1], 0.0))
        ar_bot = torch.clamp_min(ar_bot, 0.0)
    elif iv < 0:
        ar_bot = torch.where(a[km - 1] * ar_bot <= 0.0,
                             torch.zeros_like(ar_bot), ar_bot)

    ar = torch.cat([al[1:], ar_bot[None]], dim=0)
    if ar_top is not None:
        ar = _set(ar, 0, ar_top)

    a6 = 3.0 * (2.0 * a - (al + ar))

    # top 2 layers: standard constraint
    for c in (0, 1):
        a6 = _set(a6, c, 3.0 * (2.0 * a[c] - (al[c] + ar[c])))
        al, ar, a6 = _set3(
            al, ar, a6, c, ppm_limiters(dc[c], a[c], al[c], ar[c], a6[c], 0)
        )

    inter = (c_idx >= 2) & (c_idx <= km - 3)
    # boundary dc values were updated above; refresh the shifted views
    dc_m1 = torch.roll(dc, 1, dims=0)
    if kord >= 7:
        # Huynh's 2nd constraint via the smoothness indicator h2
        h2 = (
            2.0
            * (_next(dc) / pos(dp_p1) - dc_m1 / pos(dp_m1))
            / pos(dp + 0.5 * (dp_m1 + dp_p1))
            * dp
            * dp
        )
        h2 = torch.where((c_idx >= 1) & (c_idx <= km - 2), h2, zero)
        h2_m1 = torch.roll(h2, 1, dims=0)
        h2_p1 = _next(h2)
        fac = 1.5
        pmp = 2.0 * dc
        qmp_r = a + pmp
        lac_r = a + fac * h2_m1 + dc
        ar_n = _clamp(
            ar,
            torch.minimum(torch.minimum(a, qmp_r), lac_r),
            torch.maximum(torch.maximum(a, qmp_r), lac_r),
        )
        qmp_l = a - pmp
        lac_l = a + fac * h2_p1 - dc
        al_n = _clamp(
            al,
            torch.minimum(torch.minimum(a, qmp_l), lac_l),
            torch.maximum(torch.maximum(a, qmp_l), lac_l),
        )
        a6_n = 3.0 * (2.0 * a - (al_n + ar_n))
        al = torch.where(inter, al_n, al)
        ar = torch.where(inter, ar_n, ar)
        a6 = torch.where(inter, a6_n, a6)
        if iv == 0 and kord >= 6:
            lp = ppm_limiters(dc, a, al, ar, a6, 2)
            al = torch.where(inter, lp[0], al)
            ar = torch.where(inter, lp[1], ar)
            a6 = torch.where(inter, lp[2], a6)
    else:
        lmt = max(0, kord - 3)
        if iv == 0:
            lmt = min(2, lmt)
        if kord != 4:
            a6 = torch.where(inter, 3.0 * (2.0 * a - (al + ar)), a6)
        if kord != 6:
            lp = ppm_limiters(dc, a, al, ar, a6, lmt)
            al = torch.where(inter, lp[0], al)
            ar = torch.where(inter, lp[1], ar)
            a6 = torch.where(inter, lp[2], a6)

    for c in (km - 2, km - 1):
        a6 = _set(a6, c, 3.0 * (2.0 * a[c] - (al[c] + ar[c])))
        al, ar, a6 = _set3(
            al, ar, a6, c, ppm_limiters(dc[c], a[c], al[c], ar[c], a6[c], 0)
        )
    return al, ar, a6


# ---------------------------------------------------------------------------
# the remap itself
# ---------------------------------------------------------------------------


# 1/3 as a factor (not a division), so that the K5 kernel can round the
# integration's terms exactly as this form does on any device
THIRD = 1.0 / 3.0


def _reconstruct(q1, dp1, iv: int, kord: int, qs):
    if kord > 7:
        return cs_profile(q1, dp1, iv, kord, qs)
    return ppm_profile(q1, dp1, iv, kord)


def ppm_remap_plain(q1, pe1, pe2, iv: int = 1, kord: int = 1, qs=None,
                    exact_boundaries: bool = False):
    """Mass-flux-preserving remap q1(pe1) -> q2(pe2) (mappm,
    mappm.f90:10), in torch on the tensors' device (``ppm_remap``'s
    plain form).

    Args:
        q1: layer means on the source grid, [km, ...] (k leading)
        pe1: source layer-edge pressures, [km+1, ...], increasing in k
        pe2: target layer-edge pressures, [kn+1, ...]
        iv, kord: see cs_profile; `kord > 7` selects cs_profile,
            otherwise ppm_profile (signed, matching mappm's dispatch)
        qs: surface value for iv == -2
        exact_boundaries: keep the conservative cumulative form in every
            layer instead of mappm's out-of-range layer rules

    Returns:
        q2: layer means on the target grid, [kn, ...]

    The integral of the piecewise-parabolic profile, with constant
    extension q1[0] above and q1[km-1] below the source column, is taken
    over every target layer: each source layer k contributes its overlap
    with target layer j times the parabola's mean over that overlap,
        ov = min(pb, pe1[k+1]) - max(pa, pe1[k])   (pa, pb clipped edges)
        mean = al + (ar-al)/2 (sa+sb) + a6 ((sa+sb)/2 - (sa^2+sa sb+sb^2)/3)
    with s = clip((p - pe1[k]) / dp1[k], 0, 1) at the two edges, over a
    dense [km, kn, ...] broadcast.  This is the JAX package's dense
    cumulative integration (the difference of M(p) at the layer's two
    edges) with the difference taken per source layer before the sum
    over k: algebraically identical, but in float32 the cumulative form
    loses |M| * eps / dp2 in thin target layers (at the JAX kernel test's
    inputs every float32 form of it is 1.7e-2 from the float64 answer,
    this one 4e-6).  Fully covered layers give the layer mean, so the
    remap is conservative to roundoff, and fully-outside layers reduce
    to q1[0] / q1[km-1].  mappm's own rules (exact_boundaries=False) give
    a target layer whose top edge is at/above the source top q1[0], and
    one whose top edge is at/below the source bottom q1[km-1] -- the
    first fires even when pe2[0] == pe1[0], so that form is not exactly
    conservative.
    """
    km = q1.shape[0]
    dp1 = pe1[1:] - pe1[:-1]
    al, ar, a6 = _reconstruct(q1, dp1, iv, kord, qs)

    top, bot = pe1[0], pe1[km]
    pc = _clamp(pe2, top, bot)
    # zero-thickness source layers have no overlap (guard the 0/0)
    dp_safe = torch.where(dp1 > 0, dp1, torch.ones_like(dp1))
    s = torch.clamp((pc[None] - pe1[:-1, None]) / dp_safe[:, None], 0.0, 1.0)
    sa, sb = s[:, :-1], s[:, 1:]
    ov = torch.clamp_min(
        torch.minimum(pc[None, 1:], pe1[1:, None])
        - torch.maximum(pc[None, :-1], pe1[:-1, None]),
        0.0,
    )
    ssum = sa + sb
    mean = (
        al[:, None]
        + 0.5 * (ar - al)[:, None] * ssum
        + a6[:, None] * (0.5 * ssum - (sa * sa + sa * sb + sb * sb) * THIRD)
    )
    m = torch.sum(ov * mean, dim=0)
    m = m + q1[0] * (
        torch.minimum(pe2[1:], top) - torch.minimum(pe2[:-1], top)
    )
    m = m + q1[km - 1] * (
        torch.maximum(pe2[1:], bot) - torch.maximum(pe2[:-1], bot)
    )
    q2 = m / (pe2[1:] - pe2[:-1])
    if exact_boundaries:
        return q2
    top_edge = pe2[:-1]
    q2 = torch.where(top_edge <= top, q1[0], q2)
    return torch.where(top_edge >= bot, q1[km - 1], q2)


# the dense integration of ppm_remap_plain holds float32 temporaries of
# [km, kn] per column; rows of columns go a block at a time, so that the
# reference fits beside the program's state at C384 (every column is
# independent: the blocks give the whole call's values)
BLOCK_BYTES = 1 << 30


def remap_levels(q1, pe1, pe2, iv: int, kord: int):
    """``ppm_remap(..., exact_boundaries=True)`` on the native layout:
    q1 [F, km, Y, X], pe1 [F', km+1, Y, X], pe2 [F', kn+1, Y, X] ->
    [F, kn, Y, X], where F is a multiple of F' (a stack of fields that
    share one pressure grid, e.g. the tracers, is one call); the level
    axis is moved to the front as a view."""
    rep = q1.shape[0] // pe1.shape[0]
    if rep != 1:
        pe1 = pe1.repeat(rep, 1, 1, 1)
        pe2 = pe2.repeat(rep, 1, 1, 1)
    F, km, Y, X = q1.shape
    kn = pe2.shape[1] - 1
    rows = max(1, BLOCK_BYTES // (km * kn * F * X * q1.element_size()))
    return torch.cat([
        ppm_remap_plain(
            q1[..., y:y + rows, :].movedim(1, 0),
            pe1[..., y:y + rows, :].movedim(1, 0),
            pe2[..., y:y + rows, :].movedim(1, 0),
            iv=iv, kord=kord, exact_boundaries=True,
        ).movedim(0, 1)
        for y in range(0, Y, rows)
    ], dim=-2)
