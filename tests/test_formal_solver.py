import jax.numpy as jnp
import numpy as np
import pytest

from lightweaver_tpu.ops.formal_solver import (SOLVER_NAMES_1D, formal_sol_1d,
                                               w2)


def np_w2(dtau):
    if dtau < 5e-4:
        return dtau * (1 - 0.5 * dtau), dtau**2 * (0.5 - dtau / 3.0)
    if dtau > 50.0:
        return 1.0, 1.0
    e = np.exp(-dtau)
    return 1.0 - e, 1.0 - e - dtau * e


def np_piecewise_linear(chi, S, height, mu, I_start, to_obs):
    """Independent sequential transcription of the linear solver recurrence."""
    N = len(chi)
    I = np.zeros(N)
    Psi = np.zeros(N)
    if to_obs:
        dk, k_start, k_end = -1, N - 1, 0
    else:
        dk, k_start, k_end = 1, 0, N - 1
    zmu = 0.5 / mu
    dtau_uw = zmu * (chi[k_start] + chi[k_start + dk]) * abs(
        height[k_start] - height[k_start + dk])
    dS_uw = (S[k_start] - S[k_start + dk]) / dtau_uw
    I[k_start] = I_start
    Iu = I_start
    k = k_start + dk
    while True:
        w0, w1 = np_w2(dtau_uw)
        I[k] = (1 - w0) * Iu + w0 * S[k] + w1 * dS_uw
        Psi[k] = w0 - w1 / dtau_uw
        if k == k_end:
            break
        dtau_dw = zmu * (chi[k] + chi[k + dk]) * abs(height[k] - height[k + dk])
        dS_uw = (S[k] - S[k + dk]) / dtau_dw
        dtau_uw = dtau_dw
        Iu = I[k]
        k += dk
    return I, Psi / chi


def make_problem(N=82, B=6, seed=0):
    rng = np.random.default_rng(seed)
    height = np.linspace(2.2e6, 0.0, N)  # decreasing, k=0 top
    chi = 10.0 ** rng.uniform(-9, -3, size=(B, N))
    chi = np.sort(chi, axis=1)  # increasing with depth, smooth enough
    S = 10.0 ** rng.uniform(-10, -8, size=(B, N))
    muz = rng.uniform(0.05, 1.0, size=B)
    I0 = rng.uniform(0.0, 1e-8, size=B)
    return chi, S, height, muz, I0


@pytest.mark.parametrize('to_obs', [True, False])
def test_linear_matches_sequential_reference(to_obs):
    chi, S, height, muz, I0 = make_problem()
    I, Psi, _ = formal_sol_1d(jnp.asarray(chi), jnp.asarray(S),
                           jnp.asarray(height), jnp.asarray(muz),
                           jnp.asarray(I0), to_obs=to_obs,
                           method='piecewise_linear_1d')
    for b in range(chi.shape[0]):
        I_ref, Psi_ref = np_piecewise_linear(chi[b], S[b], height, muz[b],
                                             I0[b], to_obs)
        np.testing.assert_allclose(np.asarray(I[b]), I_ref, rtol=1e-9)
        np.testing.assert_allclose(np.asarray(Psi[b]), Psi_ref, rtol=1e-9)


@pytest.mark.parametrize('method', SOLVER_NAMES_1D)
def test_constant_source_function(method):
    # For S = const and zero incident intensity, I -> S (1 - exp(-tau)).
    N, B = 160, 3
    height = np.linspace(1e6, 0.0, N)
    chi = np.full((B, N), 1e-5)
    S = np.full((B, N), 7.3e-9)
    muz = np.array([1.0, 0.5, 0.3])
    I0 = np.zeros(B)
    I, Psi, _ = formal_sol_1d(jnp.asarray(chi), jnp.asarray(S),
                           jnp.asarray(height), jnp.asarray(muz),
                           jnp.asarray(I0), to_obs=False, method=method)
    # tau at depth k measured from the top along the ray
    tau = chi[:, 0][:, None] * (height[0] - height)[None, :] / muz[:, None]
    expected = S * (1.0 - np.exp(-tau))
    np.testing.assert_allclose(np.asarray(I), expected, rtol=1e-6, atol=1e-18)


@pytest.mark.parametrize('method', SOLVER_NAMES_1D)
def test_optically_thick_saturates_to_S(method):
    N, B = 120, 1
    height = np.linspace(1e6, 0.0, N)
    chi = np.full((B, N), 1.0)   # enormous optical depth
    S = np.full((B, N), 4.2e-9)
    muz = np.array([0.9])
    I, Psi, _ = formal_sol_1d(jnp.asarray(chi), jnp.asarray(S),
                           jnp.asarray(height), jnp.asarray(muz),
                           jnp.asarray([0.0]), to_obs=True, method=method)
    # emergent intensity (k=0) should equal S
    np.testing.assert_allclose(float(I[0, 0]), 4.2e-9, rtol=1e-10)
    # deep Psi* ~ 1/chi
    np.testing.assert_allclose(float(Psi[0, N // 2]), 1.0, rtol=1e-2)


@pytest.mark.parametrize('mode', ['parallel', 'blocked'])
@pytest.mark.parametrize('method', SOLVER_NAMES_1D)
def test_parallel_recurrence_matches_scan(method, mode):
    chi, S, height, muz, I0 = make_problem(N=97, B=4, seed=3)
    args = (jnp.asarray(chi), jnp.asarray(S), jnp.asarray(height),
            jnp.asarray(muz), jnp.asarray(I0))
    I_a, Psi_a, _ = formal_sol_1d(*args, to_obs=True, method=method, mode='scan')
    I_b, Psi_b, _ = formal_sol_1d(*args, to_obs=True, method=method,
                               mode=mode)
    np.testing.assert_allclose(np.asarray(I_a), np.asarray(I_b), rtol=1e-10)


@pytest.mark.parametrize('method', ['piecewise_bezier3_1d',
                                    'piecewise_besser_1d'])
def test_higher_order_close_to_linear_on_fine_grid(method):
    # On a very fine grid all solvers converge to the same transfer solution.
    N = 1500
    height = np.linspace(1e6, 0.0, N)
    x = np.linspace(0, 1, N)
    chi = (1e-6 * (1 + 10 * x**3))[None, :]
    S = (1e-9 * (1 + 5 * x**2))[None, :]
    muz = np.array([0.7])
    I0 = np.array([0.0])
    args = (jnp.asarray(chi), jnp.asarray(S), jnp.asarray(height),
            jnp.asarray(muz), jnp.asarray(I0))
    I_lin, _, _ = formal_sol_1d(*args, to_obs=True,
                             method='piecewise_linear_1d')
    I_ho, _, _ = formal_sol_1d(*args, to_obs=True, method=method)
    np.testing.assert_allclose(np.asarray(I_ho), np.asarray(I_lin),
                               rtol=2e-4, atol=1e-16)


def test_w2_branches_continuous():
    for dtau in [4.9e-4, 5.1e-4, 49.9, 50.1]:
        w0a, w1a = w2(jnp.asarray(dtau * 0.999))
        w0b, w1b = w2(jnp.asarray(dtau * 1.001))
        assert abs(float(w0a) - float(w0b)) < 1e-5
        assert abs(float(w1a) - float(w1b)) < 1e-5


def _bezier3_exact(t):
    """(alpha, beta, gamma, delta, exp(-t)) of the closed forms in
    40-digit decimal arithmetic."""
    from decimal import Decimal, localcontext
    with localcontext() as ctx:
        ctx.prec = 40
        t = Decimal(float(t))
        E = (-t).exp()
        t3 = t ** 3
        out = ((6 - E * (6 + 6 * t + 3 * t ** 2 + t3)) / t3,
               (6 * E - 6 + 6 * t - 3 * t ** 2 + t3) / t3,
               3 * (2 * t - 6 + E * (6 + 4 * t + t ** 2)) / t3,
               3 * (6 - 4 * t + t ** 2 - 2 * E * (3 + t)) / t3, E)
        return [float(x) for x in out]


@pytest.mark.parametrize('dtype', ['float64', 'float32'])
@pytest.mark.parametrize('lo,hi', [(5e-2, 1.0), (1.0, 2.5), (2.5, 30.0)])
def test_bezier3_coeffs_error_bounded_by_cancellation(dtype, lo, hi):
    """Above the reference's Taylor threshold (5e-2) the mid-branch
    closed forms cancel ~dt^4/4 out of O(6) terms, so their relative
    error grows as eps/dt^4 below dt = 1 (1e-9 in f64 at 5e-2) and stays
    a few eps above it."""
    from lightweaver_tpu.ops.formal_solver import bezier3_coeffs

    ts = np.geomspace(lo, hi, 60)
    got = bezier3_coeffs(jnp.asarray(ts, dtype))
    ref = np.array([_bezier3_exact(t) for t in ts]).T
    bound = 300 * np.finfo(dtype).eps * np.maximum(1.0, ts ** -4)
    for name, a, b in zip('abgde', got, ref):
        err = np.abs(np.asarray(a, np.float64) - b) / np.abs(b)
        assert np.all(err < bound), (name, float(np.max(err / bound)))
