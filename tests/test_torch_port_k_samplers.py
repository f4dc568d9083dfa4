"""PyTorch port: the k-diffusion / EDM sampler family and the thresholding
combine functions (diffusion/k_samplers.py, thresholding.py) held against
the JAX package, mirroring tests/test_k_samplers.py. The samplers that
draw get JAX's own draws: per step key, k = split(key), normal(k, shape).

Tolerances: 1e-5 relative + absolute on the samplers (f32 elementwise
work; the JAX scan compiles each step's arithmetic, the port runs it
eagerly, so an FMA or an order may move the last bits), 1e-5 relative +
1e-6 absolute on the thresholding functions (f32 statistics), exact on
the host-side f64 coefficient tables."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import assert_close, fast_compiles
from _torch_port_helpers import fast_jax_compiles  # noqa: F401 (autouse)
from landiff_tpu.diffusion import k_samplers as jks
from landiff_tpu.diffusion import thresholding as jth
from landiff_tpu_torch.diffusion import k_samplers as tks
from landiff_tpu_torch.diffusion import thresholding as tth

torch.set_num_threads(2)   # tier-1 runs six xdist workers

SHAPE = (2, 3, 4, 5)
T = torch.from_numpy


def _sigmas(n=8):
    ramp = np.linspace(0, 1, n)
    lo, hi = 0.03 ** (1 / 7.0), 10.0 ** (1 / 7.0)
    return tks.append_zero((hi + ramp * (lo - hi)) ** 7.0)


def _x0(seed=0):
    return np.random.default_rng(seed).standard_normal(SHAPE).astype(
        np.float32)


def jax_draws(key, n, shape):
    """The unit normals the JAX scans draw, one per step."""
    out = []
    for _ in range(n):
        key, k = jax.random.split(key)
        out.append(T(np.array(jax.random.normal(k, shape, jnp.float32))))
    return out


# name -> (JAX sampler, port sampler, keyword arguments, draws per step)
CASES = {
    "euler_edm": (jks.euler_edm_sample, tks.euler_edm_sample, {}, True),
    "euler_edm_churn": (jks.euler_edm_sample, tks.euler_edm_sample,
                        {"s_churn": 4.0, "s_noise": 1.003}, True),
    "heun_edm_churn": (jks.heun_edm_sample, tks.heun_edm_sample,
                       {"s_churn": 2.0, "s_tmin": 0.1, "s_tmax": 5.0}, True),
    "ddim": (jks.ddim_sample, tks.ddim_sample, {"s_noise": 0.1}, True),
    "euler_ancestral": (jks.euler_ancestral_sample,
                        tks.euler_ancestral_sample, {"eta": 1.0}, True),
    "dpmpp2s_ancestral": (jks.dpmpp2s_ancestral_sample,
                          tks.dpmpp2s_ancestral_sample, {"eta": 0.7}, True),
    "dpmpp2m": (jks.dpmpp2m_sample, tks.dpmpp2m_sample, {}, False),
    "sde_dpmpp2m": (jks.sde_dpmpp2m_sample, tks.sde_dpmpp2m_sample, {},
                    True),
    "lms": (jks.linear_multistep_sample, tks.linear_multistep_sample,
            {"order": 4}, None),
}


def _denoisers():
    w = np.random.default_rng(5).standard_normal(SHAPE).astype(
        np.float32) * 0.3

    def jden(x, sigma):
        return jnp.tanh(x / (1.0 + sigma) + w)

    tw = T(w)

    def tden(x, sigma):
        return torch.tanh(x / (1.0 + sigma) + tw)

    return jden, tden


@pytest.mark.parametrize("name", sorted(CASES))
def test_sampler_matches_jax(name):
    jfn, tfn, kw, draws = CASES[name]
    sig = _sigmas()
    jden, tden = _denoisers()
    key = jax.random.PRNGKey(7)
    jkw = dict(kw) if draws is None else dict(kw, key=key)
    with fast_compiles():
        want = jfn(jden, jnp.asarray(_x0()), sig, **jkw)
    tkw = dict(kw)
    if draws is not None:
        tkw["noises"] = jax_draws(key, len(sig) - 1, SHAPE)
    got = tfn(tden, T(_x0()), sig, **tkw)
    assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert np.isfinite(got.numpy()).all()


def test_sdedit_matches_jax():
    sig = _sigmas()
    rng = np.random.default_rng(3)
    image, randn = (rng.standard_normal(SHAPE).astype(np.float32)
                    for _ in range(2))
    jden, tden = _denoisers()
    key = jax.random.PRNGKey(9)
    with fast_compiles():
        want = jks.sdedit_edm_sample(jden, jnp.asarray(image),
                                     jnp.asarray(randn), sig, key=key,
                                     edit_ratio=0.5, s_churn=3.0)
    got = tks.sdedit_edm_sample(tden, T(image), T(randn), sig,
                                noises=jax_draws(key, 4, SHAPE),
                                edit_ratio=0.5, s_churn=3.0)
    assert_close(got, want, atol=1e-5, rtol=1e-5)
    # nothing left to run: the image itself
    same = tks.sdedit_edm_sample(tden, T(image), T(randn), sig,
                                 edit_ratio=1.0)
    assert torch.equal(same, T(image))


def test_generator_draws_and_churn():
    """Without noises the draws come from the generator: a seed repeats,
    churn changes the result, and the output stays finite."""
    sig = _sigmas()
    _, tden = _denoisers()
    run = lambda seed, **kw: tks.euler_edm_sample(
        tden, T(_x0()), sig, generator=torch.Generator().manual_seed(seed),
        **kw)
    base = run(1)
    assert torch.equal(base, run(2))            # no churn: no draw
    churned = run(1, s_churn=4.0)
    assert torch.equal(churned, run(1, s_churn=4.0))
    assert not torch.equal(churned, run(2, s_churn=4.0))
    assert torch.isfinite(churned).all() and not torch.equal(base, churned)


def test_host_tables_equal_jax():
    sig = _sigmas(10)
    np.testing.assert_array_equal(tks.append_zero(sig[:-1]),
                                  jks.append_zero(sig[:-1]))
    for eta in (0.0, 0.5, 1.0):
        for a, b in zip(tks.get_ancestral_step(sig[:-1], sig[1:], eta),
                        jks.get_ancestral_step(sig[:-1], sig[1:], eta)):
            np.testing.assert_array_equal(a, b)
    for order in (1, 2, 3, 4):
        for i in range(order - 1, 9):
            for j in range(order):
                assert tks.linear_multistep_coeff(order, sig, i, j) == \
                    jks.linear_multistep_coeff(order, sig, i, j)
    with pytest.raises(ValueError):
        tks.linear_multistep_coeff(3, sig, 1, 0)


def test_lms_coeff_matches_scipy_quad():
    from scipy import integrate

    sig = _sigmas(10)
    for order in (2, 4):
        for i in range(order - 1, 9):
            for j in range(order):
                def fn(tau, i=i, j=j, order=order):
                    prod = 1.0
                    for k in range(order):
                        if j != k:
                            prod *= (tau - sig[i - k]) / (sig[i - j]
                                                          - sig[i - k])
                    return prod
                want = integrate.quad(fn, sig[i], sig[i + 1], epsrel=1e-4)[0]
                np.testing.assert_allclose(
                    tks.linear_multistep_coeff(order, sig, i, j), want,
                    rtol=1e-5, atol=1e-10)


# ---------------------------------------------------------------------------
# thresholding


VSHAPE = (2, 3, 4, 5, 6)   # (B, T, C, H, W)


def _pair(ties=False):
    rng = np.random.default_rng(11)
    u = rng.standard_normal(VSHAPE) * 1.7
    c = rng.standard_normal(VSHAPE) * 1.3
    if ties:   # few distinct values: the quantiles fall on and between ties
        u, c = np.round(u * 2) / 2, np.round(c * 2) / 2
    return u.astype(np.float32), c.astype(np.float32)


COMBINE = {
    "none": (jth.no_dynamic_thresholding, tth.no_dynamic_thresholding, {}),
    "static": (jth.static_thresholding, tth.static_thresholding, {}),
    "dynamic": (jth.dynamic_thresholding, tth.dynamic_thresholding, {}),
    "v1": (jth.dynamic_thresholding_v1, tth.dynamic_thresholding_v1,
           {"scale_factor": 1.152}),
    "v2": (jth.dynamic_thresholding_v2, tth.dynamic_thresholding_v2, {}),
}


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("name", sorted(COMBINE))
def test_combine_matches_jax(name, ties):
    jfn, tfn, kw = COMBINE[name]
    u, c = _pair(ties)
    want = jfn(jnp.asarray(u), jnp.asarray(c), 5.0, **kw)
    got = tfn(T(u), T(c), 5.0, **kw)
    assert_close(got, want, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("ties", [False, True])
def test_quantile_thresholds_match_jax(ties):
    """torch.quantile's linear interpolation is jnp.quantile's, also on
    ties; each threshold bites (the data's spread passes 1)."""
    x = _pair(ties)[0] * 3.0
    for jfn, tfn, p in (
            (jth.dynamic_threshold, tth.dynamic_threshold, 0.95),
            (jth.dynamic_thresholding2, tth.dynamic_thresholding2, 0.995)):
        want = np.asarray(jfn(jnp.asarray(x), p))
        got = tfn(T(x), p)
        assert_close(got, want, atol=1e-6, rtol=1e-5)
        assert not np.array_equal(want, x)
    x3 = x.reshape(x.shape[0], x.shape[2], -1)
    assert_close(tth.latent_dynamic_thresholding(T(x3)),
                 jth.latent_dynamic_thresholding(jnp.asarray(x3)),
                 atol=1e-6, rtol=1e-5)
    flat = T(x).abs().reshape(2, -1)
    for q in (0.1, 0.5, 0.995):
        np.testing.assert_allclose(
            torch.quantile(flat, q, dim=1).numpy(),
            np.asarray(jnp.quantile(jnp.asarray(flat.numpy()), q, axis=1)),
            rtol=1e-6)


def test_combine_keeps_the_input_dtype():
    u, c = _pair()
    ub, cb = T(u).bfloat16(), T(c).bfloat16()
    for name, (_, tfn, kw) in COMBINE.items():
        if name in ("none", "static"):
            continue
        assert tfn(ub, cb, 5.0, **kw).dtype == torch.bfloat16
    assert tth.dynamic_thresholding2(ub).dtype == torch.bfloat16
