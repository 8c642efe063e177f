"""Conservative PPM vertical remapping (the mappm algorithm) in torch.

Counterpart of the JAX package's ``ops/remap.py`` for the dycore's case
only: ``cs_profile`` (cubic-spline edge reconstruction, mappm.f90:132-509)
with the kord 9 interior constraint and the ``cs_limiters`` it calls, for
iv in {1, 0, -1}, and the exactly conservative remap integration
(``exact_boundaries=True``).  The layer axis k is leading; every k-shifted
term is a slice and the two tridiagonal sweeps are Python loops over k
with all columns batched per step.  Any other kord, iv or boundary rule
raises NotImplementedError: those are still to be ported (ROADMAP.md,
"remaining ppm_remap kords and ppm_profile").
"""

from __future__ import annotations

import torch

_TODO = (
    "still to be ported (ROADMAP.md: remaining ppm_remap kords and "
    "ppm_profile)"
)


def _clamp(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def _mono_clamp(q, a, b):
    """Clamp q into [min(a,b), max(a,b)]."""
    return _clamp(q, torch.minimum(a, b), torch.maximum(a, b))


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


def cs_limiters(a, al, ar, a6, extm, mode: int):
    """cs_limiters (mappm.f90:535-612).

    mode 0: positive-definite constraint
    mode 1: monotone wrt the cell mean (used for top/bottom layers)
    mode 2: standard PPM constraint gated on the extremum flag
    """
    if mode == 0:
        nonpos = a <= 0.0
        al0, ar0, a60 = _flatten(a, al, ar, a6, nonpos)
        # interior minimum check for the positive branch
        da1 = ar0 - al0
        has_min = torch.abs(da1) < -a60
        safe_a6 = torch.where(a60 == 0.0, torch.ones_like(a60), a60)
        fmin = a + 0.25 * da1 * da1 / safe_a6 + a60 * (1.0 / 12.0)
        neg_min = has_min & (fmin < 0.0) & (~nonpos)
        mid_low = (a < ar0) & (a < al0)
        right_up = ar0 > al0
        # flatten if the mean is below both edges
        alf, arf, a6f = _flatten(a, al0, ar0, a60, neg_min & mid_low)
        # else bias toward the lower edge
        a6_l = 3.0 * (al0 - a)
        ar_l = al0 - a6_l
        a6_r = 3.0 * (ar0 - a)
        al_r = ar0 - a6_r
        use_l = neg_min & (~mid_low) & right_up
        use_r = neg_min & (~mid_low) & (~right_up)
        al_new = torch.where(use_r, al_r, alf)
        ar_new = torch.where(use_l, ar_l, arf)
        a6_new = torch.where(use_l, a6_l, torch.where(use_r, a6_r, a6f))
        return al_new, ar_new, a6_new
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


def _edge_spline(a, dp):
    """Tridiagonal cubic-spline solve for edge values qe[0..km] (the
    standard variant, iv != -2).

    a, dp: [km, ...] (k leading); returns qe [km+1, ...].
    """
    km = a.shape[0]
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


def cs_profile(a, dp, iv: int, kord: int):
    """Cubic-spline PPM reconstruction (cs_profile, mappm.f90:132-509),
    kord 9 and iv in {1, 0, -1}.

    Args:
        a: layer means, shape [km, ...] (k leading)
        dp: layer thicknesses, same shape
        iv: -1 winds, 0 positive-definite scalars, 1 others
        kord: limiter variant (9)

    Returns:
        (al, ar, a6): left edge, right edge, curvature arrays [km, ...]
    """
    if abs(kord) != 9 or iv not in (1, 0, -1):
        raise NotImplementedError(
            f"cs_profile kord={kord} iv={iv}: {_TODO}"
        )
    km = a.shape[0]
    qe = _edge_spline(a, dp)

    def col(idx):  # k-index column broadcastable against a
        return idx.reshape((-1,) + (1,) * (a.dim() - 1))

    # --- large-scale constraints on edge values -------------------------
    # dA[c] = a[c] - a[c-1], defined for c = 1..km-1 (index c)
    dA = torch.cat([torch.zeros_like(a[:1]), a[1:] - a[:-1]], dim=0)

    qe = _set(qe, 1, _mono_clamp(qe[1], a[0], a[1]))
    # interior edges e = 2..km-2
    e_idx = col(torch.arange(km + 1, device=a.device))
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
    c_idx = col(torch.arange(km, device=a.device))
    dA_cp1 = torch.cat([dA[1:], torch.zeros_like(dA[:1])], dim=0)
    extm_int = dA * dA_cp1 < 0.0
    extm_bnd = (al - a) * (ar - a) > 0.0
    extm = torch.where(
        (c_idx == 0) | (c_idx == km - 1), extm_bnd, extm_int
    )
    a6 = 3.0 * (2.0 * a - (al + ar))

    # --- top boundary ---------------------------------------------------
    if iv == 0:
        al = _set(al, 0, torch.clamp_min(al[0], 0.0))
    elif iv == -1:
        al = _set(
            al, 0, torch.where(al[0] * a[0] <= 0.0,
                               torch.zeros_like(al[0]), al[0])
        )
    a6 = _set(a6, 0, 3.0 * (2.0 * a[0] - (al[0] + ar[0])))
    al, ar, a6 = _set3(
        al, ar, a6, 0, cs_limiters(a[0], al[0], ar[0], a6[0], extm[0], 1)
    )
    a6 = _set(a6, 1, 3.0 * (2.0 * a[1] - (al[1] + ar[1])))
    al, ar, a6 = _set3(
        al, ar, a6, 1, cs_limiters(a[1], al[1], ar[1], a6[1], extm[1], 2)
    )

    # --- interior cells c = 2..km-3: the kord 9 constraint --------------
    inter = (c_idx >= 2) & (c_idx <= km - 3)
    shz = torch.zeros_like(dA[:1])
    dA_m1 = torch.roll(dA, 1, dims=0)  # dA[c-1]
    dA_p1 = torch.cat([dA[1:], shz], dim=0)  # dA[c+1]
    dA_p2 = torch.cat([dA[2:], shz, shz], dim=0)  # dA[c+2]
    extm_m1 = torch.roll(extm, 1, dims=0)
    extm_p1 = torch.cat([extm[1:], extm[-1:]], dim=0)

    hal, har = _huynh_edges(a, al, ar, dA, dA_p1, dA_p2, dA_m1)
    wave = (extm & extm_m1) | (extm & extm_p1)
    a6_g = 6.0 * a - 3.0 * (al + ar)
    nonmono = torch.abs(a6_g) > torch.abs(al - ar)
    al_s = torch.where(nonmono, hal, al)
    ar_s = torch.where(nonmono, har, ar)
    a6_s = 6.0 * a - 3.0 * (al_s + ar_s)
    al_n = torch.where(wave, a, al_s)  # 2-delta-z flattening
    ar_n = torch.where(wave, a, ar_s)
    a6_n = torch.where(wave, torch.zeros_like(a6_s), a6_s)

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


def ppm_remap(q1, pe1, pe2, iv: int = 1, kord: int = 9,
              exact_boundaries: bool = True):
    """Mass-flux-preserving remap q1(pe1) -> q2(pe2) (mappm,
    mappm.f90:10), exactly conservative form.

    Args:
        q1: layer means on the source grid, [km, ...] (k leading)
        pe1: source layer-edge pressures, [km+1, ...], increasing in k
        pe2: target layer-edge pressures, [kn+1, ...]
        iv, kord: see cs_profile (kord 9, iv in {1, 0, -1})

    Returns:
        q2: layer means on the target grid, [kn, ...]

    The piecewise-parabolic cumulative mass function M(p), with constant
    extension beyond the source column, is evaluated at every target edge
    and differenced; fully covered layers telescope, so the remap is
    conservative to roundoff and fully-outside layers reduce to q1[0] /
    q1[km-1].
    """
    if not exact_boundaries:
        raise NotImplementedError(f"ppm_remap exact_boundaries=False: {_TODO}")
    km = q1.shape[0]
    dp1 = pe1[1:] - pe1[:-1]
    al, ar, a6 = cs_profile(q1, dp1, iv, kord)

    # M(p) = sum_k dp1[k] * [al s + (ar-al)/2 s^2 + a6 (s^2/2 - s^3/3)]
    # with s_k(p) = clip((p - pe1[k]) / dp1[k], 0, 1), over a
    # [km, kn+1, ...] broadcast; zero-thickness layers contribute nothing.
    pc = _clamp(pe2, pe1[0], pe1[km])
    dp_safe = torch.where(dp1 > 0, dp1, torch.ones_like(dp1))
    s = (pc[None] - pe1[:-1, None]) / dp_safe[:, None]
    s = torch.clamp(s, 0.0, 1.0)
    dal = ar - al
    poly = (
        al[:, None] * s
        + 0.5 * dal[:, None] * s * s
        + a6[:, None] * (0.5 * s * s - s * s * s / 3.0)
    )
    m = torch.sum(dp1[:, None] * poly, dim=0)
    m = m + q1[0] * torch.clamp_max(pe2 - pe1[0], 0.0)
    m = m + q1[km - 1] * torch.clamp_min(pe2 - pe1[km], 0.0)
    return (m[1:] - m[:-1]) / (pe2[1:] - pe2[:-1])
