"""ROCK2/ROCK4: stabilized explicit solvers on orthogonal polynomials.

Port of ``universal_differential_equations_tpu/solvers/rock.py``; the
coefficient derivation below is a copy of its numpy-only code (the port
imports nothing of the JAX package), and the step is the same arithmetic on
tensors.  The reference drives its climate neural PDEs with ROCK2/ROCK4 plus
a user-supplied spectral-radius hook (``Climate/NeuralPDE/npde.jl:61,82,122``;
``npde_data.jl:78``); ``rkc.py`` holds the closed-form Chebyshev family.  The
construction is Abdulle & Medovikov's (Numer. Math. 90, 2001; Abdulle, SISC
23, 2002): the stability polynomial is

    R_s(z) = w(z) · P_{s-d}(z),

with ``w`` of degree d (= the method order, 2 or 4) and ``P_{s-d}`` the
member of the family orthogonal w.r.t. ``w(z)² / sqrt(1-x²)`` on the mapped
interval, the choice that makes |R| nearly equioscillate, giving stability
intervals ``l_s ≈ 0.80·s²`` (ROCK2; RKC2 gives 0.653·s²) and
``l_s ≈ 0.35·s²`` (ROCK4).

Every coefficient is derived on the host (float64 numpy) by the Stieltjes
procedure with Gauss-Chebyshev quadrature:

* ROCK2: (σ, τ) of ``w(z) = 1 + 2σz + τz²`` solve the order-2 conditions
  ``R'(0) = R''(0) = 1`` by damped Newton.
* ROCK4: the 10 coefficients of a 4-stage explicit finishing block solve the
  eight composite rooted-tree order-4 conditions by min-norm Gauss-Newton,
  while ``w`` (degree 4) is fixed-pointed to the finishing block's own
  stability polynomial.  An embedded order-3 weight vector gives the error
  estimate.

In both the interval length ``l`` is maximized by bisection under the
damping requirement max|R| ≤ 0.95 on the oscillatory region.  Derivations
are cached per stage count (ROCK2 takes seconds at s ≥ 8 on one CPU core);
the step is a three-term recurrence plus the finishing stages, with the
coefficients as Python floats.

The reference's ``eigen_est`` hook maps to the ``rho`` argument;
``.for_problem(rho, tspan, n_steps_hint)`` picks the stage count, and the
adaptive drivers cap every attempt at ``dt_stab``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np

__all__ = ["ROCK2", "ROCK4"]

_DAMPING = 0.95  # max|R| on the oscillatory region (ROCK2's standard choice)
_MIN_STAGES = 3
_MAX_STAGES = 200


def _orthopoly_at_one(s_int: int, sigma: float, tau: float, l: float, N: int = 1024):
    """Monic orthogonal polynomials w.r.t. w(z(x))²/√(1-x²) on x ∈ [-1, 1].

    Returns (alpha, beta, P1, dP1, ddP1): Stieltjes recurrence coefficients
    for π_{j+1} = (x - α_j)π_j - β_jπ_{j-1}, and (π_j(1), π_j'(1), π_j''(1))
    arrays for j = 0..s_int.  Gauss-Chebyshev quadrature is exact for the
    polynomial part up to degree 2N-1 (we need ≤ 2·s_int + 4).
    """
    i = np.arange(1, N + 1)
    x = np.cos((2 * i - 1) * np.pi / (2 * N))  # Chebyshev nodes
    z = (x - 1.0) * (l / 2.0)
    W = (1.0 + 2.0 * sigma * z + tau * z * z) ** 2  # quadrature weight × π/N

    alpha = np.zeros(s_int)
    beta = np.zeros(s_int)
    p_prev = np.zeros_like(x)  # π_{-1}
    p = np.ones_like(x)  # π_0
    nrm_prev = 1.0
    P1 = np.ones(s_int + 1)
    dP1 = np.zeros(s_int + 1)
    ddP1 = np.zeros(s_int + 1)
    v_prev = (0.0, 0.0, 0.0)  # (π, π', π'') at x=1 for j-1
    v = (1.0, 0.0, 0.0)
    for j in range(s_int):
        nrm = float(np.mean(W * p * p))
        alpha[j] = float(np.mean(W * x * p * p)) / nrm
        beta[j] = nrm / nrm_prev if j > 0 else 0.0
        p_next = (x - alpha[j]) * p - beta[j] * p_prev
        p_prev, p, nrm_prev = p, p_next, nrm
        # value/derivative recurrences at x = 1
        pj, dpj, ddpj = v
        pm, dpm, ddpm = v_prev
        v_next = (
            (1.0 - alpha[j]) * pj - beta[j] * pm,
            (1.0 - alpha[j]) * dpj + pj - beta[j] * dpm,
            (1.0 - alpha[j]) * ddpj + 2.0 * dpj - beta[j] * ddpm,
        )
        v_prev, v = v, v_next
        P1[j + 1], dP1[j + 1], ddP1[j + 1] = v_next
    return alpha, beta, P1, dP1, ddP1


def _order_residual(s_int: int, l: float, sigma: float, tau: float):
    _, _, P1, dP1, ddP1 = _orthopoly_at_one(s_int, sigma, tau, l)
    Qp = (dP1[s_int] / P1[s_int]) * (2.0 / l)
    Qpp = (ddP1[s_int] / P1[s_int]) * (4.0 / (l * l))
    return np.array([
        2.0 * sigma + Qp - 1.0,
        2.0 * tau + 4.0 * sigma * Qp + Qpp - 1.0,
    ])


def _fit_sigma_tau(s_int: int, l: float, iters: int = 60):
    """Solve the order-2 conditions for (σ, τ) at interval length l.

    Damped Newton with finite-difference Jacobian — the plain fixed-point
    form is unstable for s ≳ 10 because the weight feeds back into Q'(0).
    """
    sigma, tau = 0.37, 0.29  # near the large-s limit; exact for any start
    h = 1e-7
    for _ in range(iters):
        r = _order_residual(s_int, l, sigma, tau)
        if np.abs(r).max() < 1e-13:
            break
        rs = _order_residual(s_int, l, sigma + h, tau)
        rt = _order_residual(s_int, l, sigma, tau + h)
        J = np.column_stack([(rs - r) / h, (rt - r) / h])
        try:
            step = np.linalg.solve(J, r)
        except np.linalg.LinAlgError:
            break
        nrm = np.abs(step).max()
        if nrm > 0.25:  # trust region: the residual is locally smooth only
            step = step * (0.25 / nrm)
        sigma, tau = sigma - step[0], tau - step[1]
    return sigma, tau


def _stability_max(s_int: int, sigma: float, tau: float, l: float, n_grid: int = 4000):
    """max |R(z)| over the oscillatory region [-l, z_d], where z_d is where
    |R| first dips below the damping level coming from 0."""
    alpha, beta, P1, _, _ = _orthopoly_at_one(s_int, sigma, tau, l)
    zg = np.linspace(-l, 0.0, n_grid)
    xg = 1.0 + 2.0 * zg / l
    p_prev = np.zeros_like(xg)
    p = np.ones_like(xg)
    for j in range(s_int):
        p_next = (xg - alpha[j]) * p - beta[j] * p_prev
        p_prev, p = p, p_next
    Q = p / P1[s_int]
    R = (1.0 + 2.0 * sigma * zg + tau * zg * zg) * Q
    absR = np.abs(R)
    below = np.nonzero(absR <= _DAMPING)[0]
    if below.size == 0:
        return float(absR.max())
    return float(absR[: below[-1] + 1].max())


@functools.lru_cache(maxsize=None)
def _derive_rock2(s: int):
    """Derive ROCK2 coefficients for total stage count ``s`` (host, f64).

    Returns (mu, nu, kappa, c, sigma, tau, l): recurrence coefficients for
    the s-2 internal stages (mu[0] is the first-stage increment), internal
    stage times c (length s-1, c[j] is the time fraction of g_j), the
    finishing parameters, and the stability interval length.
    """
    s_int = s - 2
    # bisect the largest l with damped |R|; bracket from RKC/ROCK asymptotics
    lo, hi = 0.25 * s * s, 0.90 * s * s
    # ensure lo is feasible and hi infeasible
    for _ in range(60):
        sig, ta = _fit_sigma_tau(s_int, lo)
        if _stability_max(s_int, sig, ta, lo) <= _DAMPING + 1e-9:
            break
        lo *= 0.8
    l = lo
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        sig, ta = _fit_sigma_tau(s_int, mid)
        if _stability_max(s_int, sig, ta, mid) <= _DAMPING + 1e-9:
            lo = mid
        else:
            hi = mid
        if hi - lo < 1e-6 * s * s:
            break
    l = lo
    sigma, tau = _fit_sigma_tau(s_int, l)
    alpha, beta, P1, _, _ = _orthopoly_at_one(s_int, sigma, tau, l)

    mu = np.zeros(s_int)
    nu = np.zeros(s_int)
    kappa = np.zeros(s_int)
    c = np.zeros(s_int + 1)
    for j in range(s_int):
        ratio1 = P1[j] / P1[j + 1]
        mu[j] = (2.0 / l) * ratio1
        nu[j] = (1.0 - alpha[j]) * ratio1
        kappa[j] = -beta[j] * (P1[j - 1] / P1[j + 1]) if j > 0 else 0.0
        if j == 0:
            c[1] = mu[0]
        else:
            c[j + 1] = nu[j] * c[j] + kappa[j] * c[j - 1] + mu[j]
        # consistency check: p_j(0) = 1  ⇔  ν + κ = 1
        if j > 0:
            assert abs(nu[j] + kappa[j] - 1.0) < 1e-9, (s, j, nu[j] + kappa[j])
    # plain Python floats, as every other solver's tableau: a float32 state
    # stays float32
    return (tuple(map(float, mu)), tuple(map(float, nu)),
            tuple(map(float, kappa)), tuple(map(float, c)),
            float(sigma), float(tau), float(l))


@dataclasses.dataclass(frozen=True)
class ROCK2:
    """Abdulle's 2nd-order orthogonal-polynomial stabilized method, ``s``
    total stages (s-2 recurrence + 2-stage finishing).

    ``dt_stab = l_s / rho`` with l_s ≈ 0.81·s² (derived, not tabulated).
    The finishing correction term is the embedded error estimate (as in the
    original ROCK2); the adaptive driver caps steps at ``dt_stab``.
    """

    stages: int = 16
    rho: Optional[float] = None  # spectral-radius bound (the eigen_est hook)

    order: int = dataclasses.field(default=2, init=False)
    error_order: int = dataclasses.field(default=3, init=False)

    def __post_init__(self):
        if not _MIN_STAGES <= self.stages <= _MAX_STAGES:
            raise ValueError(
                f"ROCK2 stages must be {_MIN_STAGES}..{_MAX_STAGES}, got {self.stages}"
            )

    @property
    def name(self):
        return f"ROCK2(s={self.stages})"

    @property
    def interval(self) -> float:
        """Derived stability interval length l_s."""
        return _derive_rock2(self.stages)[6]

    @property
    def dt_stab(self):
        if self.rho is None:
            return None
        return self.interval / self.rho

    @staticmethod
    def for_problem(rho: float, tspan: Tuple[float, float], n_steps_hint: int = 50,
                    max_stages: int = _MAX_STAGES) -> "ROCK2":
        """Pick a stage count so one stability-limited step covers roughly
        ``(t1-t0)/n_steps_hint`` (ROCK adapts s per step; the stage count is
        fixed per solver, so it is sized up front)."""
        dt_target = abs(tspan[1] - tspan[0]) / n_steps_hint
        s = max(_MIN_STAGES, math.ceil(math.sqrt(dt_target * rho / 0.81)) + 1)
        return ROCK2(stages=min(s, max_stages), rho=rho)

    def step(self, f, t, y, f0, dt, args):
        s = self.stages
        mu, nu, kappa, c, sigma, tau, _ = _derive_rock2(s)

        g_prev2 = y
        g_prev = y + dt * mu[0] * f0
        for j in range(1, s - 2):
            f_prev = f(t + c[j] * dt, g_prev, args)
            g = nu[j] * g_prev + kappa[j] * g_prev2 + dt * mu[j] * f_prev
            g_prev2, g_prev = g_prev, g
        c_int = c[s - 2]

        # two-stage finishing: stability factor w(z) = 1 + 2σz + τz²
        fG = f(t + c_int * dt, g_prev, args)
        g1 = g_prev + dt * sigma * fG
        f1 = f(t + (c_int + sigma) * dt, g1, args)
        g2 = g1 + dt * sigma * f1
        corr = -dt * sigma * (1.0 - tau / (sigma * sigma)) * (f1 - fG)
        y1 = g2 + corr
        f_end = f(t + dt, y1, args)
        # Sommeijer-Shampine asymptotically-correct O(h³) LTE estimate (the
        # finishing correction itself is only O(h²) — it measures the
        # first-order embedded method, which over-throttles stiff steps)
        y_err = 0.8 * (y - y1) + 0.4 * dt * (f0 + f_end)
        nfe = s  # (s-3) recurrence evals + fG + f1 + f_end
        return y1, y_err, f_end, nfe


# --------------------------------------------------------------------- ROCK4


def _orthopoly4(m: int, wcoef, l: float, N: int = 1024):
    """Monic orthopolys w.r.t. w(z(x))²/√(1-x²), w of degree 4.

    Returns (alpha, beta, P1) — Stieltjes coefficients and π_j(1) values."""
    i = np.arange(1, N + 1)
    x = np.cos((2 * i - 1) * np.pi / (2 * N))
    z = (x - 1.0) * (l / 2.0)
    w = 1.0 + wcoef[0] * z + wcoef[1] * z**2 + wcoef[2] * z**3 + wcoef[3] * z**4
    W = w * w
    alpha = np.zeros(m)
    beta = np.zeros(m)
    p_prev = np.zeros_like(x)
    p = np.ones_like(x)
    nrm_prev = 1.0
    P1 = np.ones(m + 1)
    v_prev, v = 0.0, 1.0
    for j in range(m):
        nrm = float(np.mean(W * p * p))
        alpha[j] = float(np.mean(W * x * p * p)) / nrm
        beta[j] = nrm / nrm_prev if j > 0 else 0.0
        p_prev, p = p, (x - alpha[j]) * p - beta[j] * p_prev
        nrm_prev = nrm
        v_prev, v = v, (1.0 - alpha[j]) * v - beta[j] * v_prev
        P1[j + 1] = v
    return alpha, beta, P1


def _internal_coeffs4(m, alpha, beta, P1, l):
    mu = np.zeros(m)
    nu = np.zeros(m)
    kap = np.zeros(m)
    for j in range(m):
        r1 = P1[j] / P1[j + 1]
        mu[j] = (2.0 / l) * r1
        nu[j] = (1.0 - alpha[j]) * r1
        kap[j] = -beta[j] * (P1[j - 1] / P1[j + 1]) if j > 0 else 0.0
    return mu, nu, kap


def _internal_tableau4(m, mu, nu, kap):
    """Composite-tableau rows of the internal stages g_0..g_m over the m+4
    f-evaluation nodes (g_0..g_{m-1}, then the 4 finishing nodes)."""
    rows = np.zeros((m + 1, m + 4))
    for j in range(1, m + 1):
        rows[j] = nu[j - 1] * rows[j - 1] + (kap[j - 1] * rows[j - 2] if j >= 2 else 0.0)
        rows[j, j - 1] += mu[j - 1]
    return rows


_TREES4 = [  # rooted trees to order 4 with their density γ
    ("t", 1.0), ("[t]", 2.0), ("[tt]", 3.0), ("[[t]]", 6.0),
    ("[ttt]", 4.0), ("[t[t]]", 8.0), ("[[tt]]", 12.0), ("[[[t]]]", 24.0),
]


def _phi_vectors4(A):
    c = A.sum(1)
    Ac = A @ c
    return {
        "t": np.ones_like(c), "[t]": c, "[tt]": c * c, "[[t]]": Ac,
        "[ttt]": c**3, "[t[t]]": c * Ac, "[[tt]]": A @ (c * c),
        "[[[t]]]": A @ Ac,
    }


def _build_composite4(m, rows_int, x):
    a21, a31, a32, a41, a42, a43, b1, b2, b3, b4 = x
    A = np.zeros((m + 4, m + 4))
    A[:m, :] = rows_int[:m]
    am = rows_int[m]
    A[m] = am
    A[m + 1] = am; A[m + 1, m] += a21
    A[m + 2] = am; A[m + 2, m] += a31; A[m + 2, m + 1] += a32
    A[m + 3] = am; A[m + 3, m] += a41; A[m + 3, m + 1] += a42; A[m + 3, m + 2] += a43
    b = am.copy()
    b[m] += b1; b[m + 1] += b2; b[m + 2] += b3; b[m + 3] += b4
    return A, b


def _order_residual4(m, rows_int, x):
    A, b = _build_composite4(m, rows_int, x)
    ph = _phi_vectors4(A)
    return np.array([b @ ph[t] - 1.0 / g for t, g in _TREES4])


def _solve_finishing4(m, rows_int, x0, iters=60):
    """Min-norm Gauss-Newton on the 8 composite order-4 conditions (10 dof)."""
    x = x0.copy()
    h = 1e-7
    for _ in range(iters):
        r = _order_residual4(m, rows_int, x)
        if np.abs(r).max() < 1e-13:
            break
        J = np.zeros((8, 10))
        for k in range(10):
            xp = x.copy()
            xp[k] += h
            J[:, k] = (_order_residual4(m, rows_int, xp) - r) / h
        dx, *_ = np.linalg.lstsq(J, r, rcond=None)
        nrm = np.abs(dx).max()
        if nrm > 0.5:
            dx *= 0.5 / nrm
        x = x - dx
    return x, np.abs(_order_residual4(m, rows_int, x)).max()


def _finishing_stab_poly4(x):
    a21, a31, a32, a41, a42, a43, b1, b2, b3, b4 = x
    Af = np.array([[0.0, 0, 0, 0], [a21, 0, 0, 0], [a31, a32, 0, 0],
                   [a41, a42, a43, 0]])
    bf = np.array([b1, b2, b3, b4])
    one = np.ones(4)
    return np.array([bf @ one, bf @ (Af @ one), bf @ (Af @ Af @ one),
                     bf @ (Af @ Af @ Af @ one)])


def _stab_max4(m, wcoef, l, n_grid=4000):
    alpha, beta, P1 = _orthopoly4(m, wcoef, l)
    zg = np.linspace(-l, 0.0, n_grid)
    xg = 1.0 + 2.0 * zg / l
    p_prev = np.zeros_like(xg)
    p = np.ones_like(xg)
    for j in range(m):
        p_prev, p = p, (xg - alpha[j]) * p - beta[j] * p_prev
    R = (1.0 + wcoef[0] * zg + wcoef[1] * zg**2 + wcoef[2] * zg**3
         + wcoef[3] * zg**4) * (p / P1[m])
    absR = np.abs(R)
    below = np.nonzero(absR <= _DAMPING)[0]
    if below.size == 0:
        return float(absR.max())
    return float(absR[: below[-1] + 1].max())


def _derive_rock4_at(s, l, x0, wc0, fp_iters=40):
    """Inner derivation at fixed interval length l (warm-startable)."""
    m = s - 4
    wc = wc0.copy()
    x = x0.copy()
    mu = nu = kap = None
    res = np.inf
    for _ in range(fp_iters):
        alpha, beta, P1 = _orthopoly4(m, wc, l)
        mu, nu, kap = _internal_coeffs4(m, alpha, beta, P1, l)
        rows = _internal_tableau4(m, mu, nu, kap)
        x, res = _solve_finishing4(m, rows, x)
        v = _finishing_stab_poly4(x)
        if np.abs(v - wc).max() < 1e-12 and res < 1e-11:
            wc = v
            break
        wc = wc + 0.7 * (v - wc)
    return dict(m=m, l=l, wc=wc, x=x, mu=mu, nu=nu, kap=kap, res=res)


@functools.lru_cache(maxsize=None)
def _derive_rock4(s: int):
    """Derive ROCK4 coefficients for total stage count ``s`` (host, f64).

    Returns (mu, nu, kappa, c, x_fin, bhat, l): internal recurrence
    coefficients and stage times, the 10 finishing coefficients, the
    embedded order-3 weights, and the stability interval length.
    """
    theta = 0.4
    x = np.array([theta / 2, 0, theta / 2, 0, 0, theta,
                  theta / 6, theta / 3, theta / 3, theta / 6])
    wc = np.array([1.0, 0.5, 1.0 / 6.0, 1.0 / 24.0])
    # descending warm-chained scan for the damped/undamped boundary
    feas = None
    infeas_l = None
    for frac in np.arange(0.34, 0.10, -0.02):
        l = frac * s * s
        d = _derive_rock4_at(s, l, x, wc)
        if d["res"] < 1e-9:
            x, wc = d["x"], d["wc"]
            if _stab_max4(d["m"], d["wc"], l) <= _DAMPING + 1e-9:
                feas = d
                break
            infeas_l = l
    if feas is None:
        raise RuntimeError(f"ROCK4 derivation found no damped interval for s={s}")
    lo, best = feas["l"], feas
    hi = infeas_l if infeas_l is not None else 0.40 * s * s
    for _ in range(20):
        mid = 0.5 * (lo + hi)
        d = _derive_rock4_at(s, mid, best["x"], best["wc"])
        ok = d["res"] < 1e-9 and _stab_max4(d["m"], d["wc"], mid) <= _DAMPING + 1e-9
        if ok:
            lo, best = mid, d
        else:
            hi = mid
        if hi - lo < 3e-4 * s * s:
            break
    m = best["m"]
    rows = _internal_tableau4(m, best["mu"], best["nu"], best["kap"])
    A, _ = _build_composite4(m, rows, best["x"])
    ph = _phi_vectors4(A)
    # Embedded order-3 companion: over the four finishing nodes alone the
    # order-3 conditions pin the weights to b itself (zero estimate), so the
    # support is widened to the already-computed f(g_{m-1}) node.  The
    # 4x5 order-3 condition matrix then has a 1-dim null space n; the pair
    # difference b - b̂ = n (unit norm; its order-4 residuals ≈ 0.003-0.03
    # set the error constant), giving a genuine O(h⁴) estimate.
    nodes = [m - 1, m, m + 1, m + 2, m + 3]
    M = np.zeros((4, 5))
    for i, t in enumerate(["t", "[t]", "[tt]", "[[t]]"]):
        M[i] = ph[t][nodes]
    n = np.linalg.svd(M)[2][-1]
    c = rows.sum(1)
    # plain Python floats (see _derive_rock2's return note)
    return (tuple(map(float, best["mu"])), tuple(map(float, best["nu"])),
            tuple(map(float, best["kap"])), tuple(map(float, c)),
            tuple(map(float, best["x"])), tuple(map(float, n)),
            float(best["l"]))


@dataclasses.dataclass(frozen=True)
class ROCK4:
    """Abdulle's 4th-order orthogonal-polynomial stabilized method, ``s``
    total stages (s-4 recurrence + 4-stage order-correcting finishing).

    ``dt_stab = l_s / rho`` with l_s ≈ 0.35·s² (derived, not tabulated;
    matches the published ROCK4 interval).  The embedded order-3 weights
    give an O(h⁴) error estimate.
    """

    stages: int = 9
    rho: Optional[float] = None  # spectral-radius bound (the eigen_est hook)

    order: int = dataclasses.field(default=4, init=False)
    error_order: int = dataclasses.field(default=4, init=False)

    def __post_init__(self):
        if not 6 <= self.stages <= _MAX_STAGES:
            raise ValueError(f"ROCK4 stages must be 6..{_MAX_STAGES}, got {self.stages}")

    @property
    def name(self):
        return f"ROCK4(s={self.stages})"

    @property
    def interval(self) -> float:
        return _derive_rock4(self.stages)[6]

    @property
    def dt_stab(self):
        if self.rho is None:
            return None
        return self.interval / self.rho

    @staticmethod
    def for_problem(rho: float, tspan: Tuple[float, float], n_steps_hint: int = 50,
                    max_stages: int = 64) -> "ROCK4":
        dt_target = abs(tspan[1] - tspan[0]) / n_steps_hint
        s = max(6, math.ceil(math.sqrt(dt_target * rho / 0.33)) + 1)
        return ROCK4(stages=min(s, max_stages), rho=rho)

    def step(self, f, t, y, f0, dt, args):
        s = self.stages
        mu, nu, kap, c, x, n_emb, _ = _derive_rock4(s)
        m = s - 4

        g_prev2 = y
        g_prev = y + dt * mu[0] * f0
        f_last = f0  # f at g_{m-1} (g_0 when the loop is empty)
        for j in range(1, m):
            f_last = f(t + c[j] * dt, g_prev, args)
            g = nu[j] * g_prev + kap[j] * g_prev2 + dt * mu[j] * f_last
            g_prev2, g_prev = g_prev, g
        G = g_prev
        cA = c[m]

        a21, a31, a32, a41, a42, a43, b1, b2, b3, b4 = x
        F1 = f(t + cA * dt, G, args)
        s2 = G + dt * a21 * F1
        F2 = f(t + (cA + a21) * dt, s2, args)
        s3 = G + dt * (a31 * F1 + a32 * F2)
        F3 = f(t + (cA + a31 + a32) * dt, s3, args)
        s4 = G + dt * (a41 * F1 + a42 * F2 + a43 * F3)
        F4 = f(t + (cA + a41 + a42 + a43) * dt, s4, args)
        y1 = G + dt * (b1 * F1 + b2 * F2 + b3 * F3 + b4 * F4)
        y_err = dt * (n_emb[0] * f_last + n_emb[1] * F1 + n_emb[2] * F2
                      + n_emb[3] * F3 + n_emb[4] * F4)
        f_end = f(t + dt, y1, args)
        nfe = s  # (m-1) recurrence evals (g_1 reuses f0) + 4 finishing + f_end
        return y1, y_err, f_end, nfe
