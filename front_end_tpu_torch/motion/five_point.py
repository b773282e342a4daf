"""Nister's 5-point essential-matrix solver by the hidden-variable
resultant (counterpart of `front_end_tpu/motion/five_point.py`).

1. null space: the 5×9 epipolar design matrix's last four right singular
   vectors, E = x·X + y·Y + z·Z + W (`nullspace_basis`);
2. the 10 cubic constraints (det E = 0, 2·E·Eᵀ·E − tr(E·Eᵀ)·E = 0),
   expanded by the polynomial arithmetic below into Q(z)·m(x, y) = 0, Q a
   10×10 matrix of cubics in z;
3. real roots of det Q(z) located by sign changes of batched determinants
   over a grid of θ (z = tan θ, rows scaled by cos³θ so entries stay
   bounded), then a fixed 36-step bisection;
4. per root, (x, y) from the null vector of Q(z*).

Up to `MAX_ROOTS` candidates per minimal set, with validity masks.  The
four null vectors are defined only up to a 4×4 orthogonal transform, so
two LAPACKs can give two bases and, from them, the same essential matrices
in another order; `candidates_from_basis` is the part that is a function
of the basis alone.  Every batched step keeps the JAX package's order of
operations: the θ grid is JAX's float32 array (`linspace_f32`), the top-k
of sign changes keeps the lower index first among equals, `slogdet`'s
sign (not `det`, which underflows near θ → ±π/2) with 0 counted as +1.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from front_end_tpu_torch.motion.essential import _epipolar_rows, sampson_error
from front_end_tpu_torch.ops.grid import _stable_topk
from front_end_tpu_torch.utils.precision import f32_precision, linspace_f32

MAX_ROOTS = 10
N_SCAN = 128          # θ samples of the sign-change scan
N_BISECT = 36         # bisection steps (θ space)
SCAN_EPS = 1e-3
# the θ grid over (−π/2, π/2), float32 as JAX computes it
THETAS = linspace_f32(-np.pi / 2 + SCAN_EPS, np.pi / 2 - SCAN_EPS, N_SCAN)

# x,y-monomial groups of the cubic system, fixed column order
_XY_GROUPS = ((3, 0), (2, 1), (1, 2), (0, 3), (2, 0), (1, 1), (0, 2),
              (1, 0), (0, 1), (0, 0))
_IDX_X = _XY_GROUPS.index((1, 0))
_IDX_Y = _XY_GROUPS.index((0, 1))
_IDX_1 = _XY_GROUPS.index((0, 0))


# --- polynomial arithmetic over (x, y, z), entries tensors or None --------

def _pzero(d):
    return [[[None] * (d + 1) for _ in range(d + 1)] for _ in range(d + 1)]


def _padd(a, b):
    d = len(a) - 1
    out = _pzero(d)
    for i in range(d + 1):
        for j in range(d + 1):
            for k in range(d + 1):
                u, v = a[i][j][k], b[i][j][k]
                out[i][j][k] = (u if v is None else
                                v if u is None else u + v)
    return out


def _pmul(a, b, da, db):
    """Multiply degree-da by degree-db polynomial tables."""
    out = _pzero(da + db)
    for i1 in range(da + 1):
        for j1 in range(da + 1):
            for k1 in range(da + 1):
                u = a[i1][j1][k1]
                if u is None:
                    continue
                for i2 in range(db + 1):
                    for j2 in range(db + 1):
                        for k2 in range(db + 1):
                            v = b[i2][j2][k2]
                            if v is None:
                                continue
                            i, j, k = i1 + i2, j1 + j2, k1 + k2
                            w = u * v
                            cur = out[i][j][k]
                            out[i][j][k] = w if cur is None else cur + w
    return out


def _pneg(p, d):
    out = _pzero(d)
    for i in range(d + 1):
        for j in range(d + 1):
            for k in range(d + 1):
                if p[i][j][k] is not None:
                    out[i][j][k] = -p[i][j][k]
    return out


def _e_entry_poly(X, Y, Z, W, r, c):
    """E[r, c] = x·X + y·Y + z·Z + W as a degree-1 table."""
    p = _pzero(1)
    p[1][0][0] = X[..., r, c]
    p[0][1][0] = Y[..., r, c]
    p[0][0][1] = Z[..., r, c]
    p[0][0][0] = W[..., r, c]
    return p


def _constraint_tensor(X, Y, Z, W):
    """The 10 cubic constraints as Qc[..., constraint, xy-group, z-power]:
    a (..., 10, 10, 4) tensor."""
    E = [[_e_entry_poly(X, Y, Z, W, r, c) for c in range(3)]
         for r in range(3)]

    def mul(a, b):
        return _pmul(a, b, 1, 1)          # deg1 x deg1 -> deg2

    def mul21(a, b):
        return _pmul(a, b, 2, 1)          # deg2 x deg1 -> deg3

    cubics = []
    m00 = _padd(mul(E[1][1], E[2][2]), _pneg(mul(E[1][2], E[2][1]), 2))
    m01 = _padd(mul(E[1][0], E[2][2]), _pneg(mul(E[1][2], E[2][0]), 2))
    m02 = _padd(mul(E[1][0], E[2][1]), _pneg(mul(E[1][1], E[2][0]), 2))
    cubics.append(_padd(_padd(mul21(m00, E[0][0]),
                              _pneg(mul21(m01, E[0][1]), 3)),
                        mul21(m02, E[0][2])))               # det(E)

    EEt = [[None] * 3 for _ in range(3)]
    for r in range(3):
        for c in range(3):
            s = mul(E[r][0], E[c][0])
            s = _padd(s, mul(E[r][1], E[c][1]))
            EEt[r][c] = _padd(s, mul(E[r][2], E[c][2]))
    tr = _padd(_padd(EEt[0][0], EEt[1][1]), EEt[2][2])

    for r in range(3):                     # 2·EEt·E − tr·E
        for c in range(3):
            s = mul21(EEt[r][0], E[0][c])
            s = _padd(s, mul21(EEt[r][1], E[1][c]))
            s = _padd(s, mul21(EEt[r][2], E[2][c]))
            two_s = _pzero(3)
            for i in range(4):
                for j in range(4):
                    for k in range(4):
                        if s[i][j][k] is not None:
                            two_s[i][j][k] = 2.0 * s[i][j][k]
            cubics.append(_padd(two_s, _pneg(mul21(tr, E[r][c]), 3)))

    zero = torch.zeros_like(X[..., 0, 0])
    rows = []
    for p in cubics:
        row = []
        for gi, gj in _XY_GROUPS:
            row.append(torch.stack([
                p[gi][gj][k] if gi + gj + k <= 3 and p[gi][gj][k] is not None
                else zero for k in range(4)], -1))
        rows.append(torch.stack(row, -2))
    return torch.stack(rows, -3)


# --- root finding -------------------------------------------------------

def _theta_weights(theta):
    """z-power weights [c³, s·c², s²·c, s³] of z = tan θ, (..., 4)."""
    s, c = torch.sin(theta), torch.cos(theta)
    return torch.stack([c ** 3, s * c * c, s * s * c, s ** 3], -1)


def _sign_at(qc, theta):
    """Sign of det Q(tan θ) for (..., T) angles and (..., 10, 10, 4)
    constraints -> (..., T); an exactly singular sample counts +1, so the
    neighbouring interval still registers the crossing."""
    w = _theta_weights(theta)
    w = w.expand(qc.shape[:-3] + w.shape[-2:])
    Q = torch.einsum("...cgk,...tk->...tcg", qc, w)
    sign = torch.linalg.slogdet(Q)[0]
    return torch.where(sign == 0, torch.ones_like(sign), sign)


class FivePointResult(NamedTuple):
    E: torch.Tensor          # (..., MAX_ROOTS, 3, 3), Frobenius-normed
    valid: torch.Tensor      # (..., MAX_ROOTS) bool


def nullspace_basis(xa, xb):
    """(X, Y, Z, W), each (..., 3, 3): the null space of the 5×9 system of
    (..., 5, 2) normalised correspondences (rows 5-8 of the full Vᵀ; the
    system is padded with zero rows to 9×9)."""
    A = F.pad(_epipolar_rows(xa, xb), (0, 0, 0, 4))
    Vt = torch.linalg.svd(A, full_matrices=False)[2]
    shape = Vt.shape[:-2] + (3, 3)
    return tuple(Vt[..., i, :].reshape(shape) for i in (5, 6, 7, 8))


def candidates_from_basis(X, Y, Z, W) -> FivePointResult:
    """Every essential matrix x·X + y·Y + z·Z + W of a (..., 3, 3) basis."""
    qc = _constraint_tensor(X, Y, Z, W)
    thetas = torch.as_tensor(THETAS, device=X.device)
    sign = _sign_at(qc, thetas)                             # (..., N_SCAN)
    flip = (sign[..., :-1] * sign[..., 1:]) < 0

    # the earliest MAX_ROOTS sign changes
    rank = (N_SCAN - torch.arange(N_SCAN - 1, device=X.device)).to(
        torch.float32)
    v, pos = _stable_topk(torch.where(flip, rank, torch.zeros_like(rank)),
                          MAX_ROOTS)
    has_root = v > 0.0
    lo = thetas[pos]
    hi = thetas[(pos + 1).clamp(max=N_SCAN - 1)]
    s_lo = sign.gather(-1, pos)
    for _ in range(N_BISECT):
        mid = 0.5 * (lo + hi)
        s_mid = _sign_at(qc, mid)
        same = s_mid == s_lo
        lo = torch.where(same, mid, lo)
        s_lo = torch.where(same, s_mid, s_lo)
        hi = torch.where(same, hi, mid)
    theta_r = 0.5 * (lo + hi)
    z = torch.tan(theta_r)                                  # (..., R)

    # null vector of Q(z*) -> x, y
    w = _theta_weights(theta_r)
    Q = torch.einsum("...cgk,...rk->...rcg", qc, w)
    m = torch.linalg.svd(Q)[2][..., -1, :]                  # (..., R, 10)
    denom = m[..., _IDX_1]
    ok = denom.abs() > 1e-9
    denom = torch.where(ok, denom, torch.ones_like(denom))
    x = m[..., _IDX_X] / denom
    y = m[..., _IDX_Y] / denom

    def b(P):
        return P[..., None, :, :]

    E = (x[..., None, None] * b(X) + y[..., None, None] * b(Y)
         + z[..., None, None] * b(Z) + b(W))
    flat = E.reshape(E.shape[:-2] + (9,))
    nrm = torch.linalg.norm(flat, dim=-1)
    E = E / nrm.clamp(min=1e-12)[..., None, None]
    finite = torch.isfinite(E.reshape(flat.shape)).all(-1)
    return FivePointResult(E=E, valid=has_root & ok & finite)


@f32_precision
def five_point_candidates(xa, xb) -> FivePointResult:
    """All essential matrices through (..., 5, 2) normalised
    correspondences (K removed)."""
    return candidates_from_basis(*nullspace_basis(xa, xb))


def ransac_five_point(sampler: Callable, xa, xb, valid, *, n_hyps: int = 64,
                      threshold: float = 1e-3):
    """Batched 5-point RANSAC over normalised correspondences: each of the
    `n_hyps` minimal sets from `sampler(valid, n_hyps, 5)` gives up to
    MAX_ROOTS candidates, all scored by Sampson consensus in one batch ->
    (E_best, inliers, n_inliers, scores); the first best among equals."""
    idx = sampler(valid, n_hyps, 5)
    cands = five_point_candidates(xa[idx], xb[idx])        # (B, R, 3, 3)
    Es = cands.E.reshape(-1, 3, 3)
    ok = cands.valid.reshape(-1)
    inl = (sampson_error(Es, xa, xb) < threshold) & valid
    scores = inl.sum(-1) * ok.to(torch.int64)
    E = Es[scores.argmax()]
    inliers = (sampson_error(E, xa, xb) < threshold) & valid
    return E, inliers, inliers.sum(), scores
