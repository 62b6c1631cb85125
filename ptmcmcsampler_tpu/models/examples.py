"""JAX-native versions of the reference's example posteriors.

These are the de-facto benchmark workloads of the reference (SURVEY.md §6):
  * ``CorrelatedGaussian`` — examples/simple.py:17-44 (20-D random correlated
    Gaussian likelihood with a uniform box prior);
  * ``CurvedLikelihood`` — examples/curved_likelihood.ipynb cell 1 (the 2-D
    curved/banana likelihood, the north-star benchmark workload);
  * ``IntervalTransformedGaussian`` — tests/test_nuts.py:13-162 (standard
    normal restricted to a box via the logit reparameterization, used to
    exercise the gradient jumps).

All log-densities are pure jnp functions of a single parameter vector;
gradients come from ``jax.value_and_grad`` instead of the reference's
hand-derived expressions.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


class CorrelatedGaussian:
    """Reference examples/simple.py model (correlated Gaussian + box prior)."""

    def __init__(self, ndim=20, pmin=0.0, pmax=10.0, seed=0):
        self.ndim = int(ndim)
        rng = np.random.default_rng(seed)
        self.a = np.ones(ndim) * pmin
        self.b = np.ones(ndim) * pmax
        self.mu = rng.uniform(pmin, pmax, ndim)
        cov = 0.5 - rng.random(ndim**2).reshape((ndim, ndim))
        cov = np.triu(cov)
        cov += cov.T - np.diag(cov.diagonal())
        self.cov = np.dot(cov, cov)
        self.icov = np.linalg.inv(self.cov)
        self._icov_j = jnp.asarray(self.icov, jnp.float32)
        self._mu_j = jnp.asarray(self.mu, jnp.float32)

    def lnlikefn(self, x):
        diff = x - self._mu_j
        hi = lax.Precision.HIGHEST
        return -jnp.dot(diff, jnp.matmul(self._icov_j, diff, precision=hi), precision=hi) / 2.0

    def lnpriorfn(self, x):
        inside = jnp.all(jnp.asarray(self.a) <= x) & jnp.all(jnp.asarray(self.b) >= x)
        return jnp.where(inside, 0.0, -jnp.inf)

    def lnlikefn_grad(self, x):
        return jax.value_and_grad(self.lnlikefn)(x)

    def lnpriorfn_grad(self, x):
        return self.lnpriorfn(x), jnp.zeros_like(x)


class CurvedLikelihood:
    """The 2-D curved/banana likelihood (curved_likelihood.ipynb cell 1):

        ll = log[ exp(-x^2 - (9 + 4x^2 + 9y)^2) + 0.5 exp(-8x^2 - 8(y-2)^2) ]

    with a uniform prior on (-10, 10)^2.
    """

    ndim = 2

    def __init__(self):
        self.pmin = np.array([-10.0, -10.0])
        self.pmax = np.array([10.0, 10.0])

    def lnlikefn(self, x):
        e0 = -x[0] ** 2 - (9 + 4 * x[0] ** 2 + 9 * x[1]) ** 2
        e1 = -8 * x[0] ** 2 - 8 * (x[1] - 2) ** 2
        # logaddexp form: numerically safe where the reference's
        # log(exp(e0) + 0.5 exp(e1)) underflows to log(0), and PURE
        # elementwise (no stack + reduce): a cross-lane reduce op inside the
        # vmapped gradient splits every leapfrog step into extra fusions,
        # each a full HBM round-trip of the [T, C] batch.
        return jnp.logaddexp(e0, jnp.log(jnp.asarray(0.5, x.dtype)) + e1)

    def lnpriorfn(self, x):
        inside = jnp.all(jnp.asarray(self.pmin) < x) & jnp.all(jnp.asarray(self.pmax) > x)
        return jnp.where(inside, 0.0, -jnp.inf)

    def lnlikefn_grad(self, x):
        return jax.value_and_grad(self.lnlikefn)(x)

    def lnpriorfn_grad(self, x):
        return self.lnpriorfn(x), jnp.zeros_like(x)

    def posterior_moments(self, n=2001):
        """Posterior mean and covariance by 2-D quadrature (f64).

        The density is closed-form and 2-D, so brute-force quadrature gives a
        ground truth the bench's statistical QA can assert against — this is
        a bimodal target, so a correct mean requires the PT ladder to get the
        mass ratio between the two modes right. The grid covers
        [-6, 6] x [-9, 5]; outside, the log-density is below -17 (checked in
        tests by grid-refinement agreement), so the truncation error is
        negligible against the banana ridge's ~0.08 y-width resolved at
        dy ~ 0.007.
        """
        xs = np.linspace(-6.0, 6.0, n)
        ys = np.linspace(-9.0, 5.0, n)
        X, Y = np.meshgrid(xs, ys, indexing="ij")
        e0 = -(X**2) - (9 + 4 * X**2 + 9 * Y) ** 2
        e1 = -8 * X**2 - 8 * (Y - 2) ** 2
        ll = np.logaddexp(e0, np.log(0.5) + e1)
        w = np.exp(ll - ll.max())
        z = w.sum()
        mx = float((w * X).sum() / z)
        my = float((w * Y).sum() / z)
        cxx = float((w * (X - mx) ** 2).sum() / z)
        cyy = float((w * (Y - my) ** 2).sum() / z)
        cxy = float((w * (X - mx) * (Y - my)).sum() / z)
        return np.array([mx, my]), np.array([[cxx, cxy], [cxy, cyy]])


class HierarchicalGaussian:
    """Linear-Gaussian hierarchy, 50-D by default (BASELINE.json config 4:
    "custom jump proposals + prior-draw jumps with weighted jump cycle, 50D
    hierarchical Gaussian").

        mu       ~ N(0, s_mu^2)                      (hyper-parameter)
        theta_i  ~ N(mu, s_t^2),  i = 1..ngroups     (group effects)
        y_i      ~ N(theta_i, s_y^2)                 (data, fixed at init)

    Parameter vector x = (mu, theta_1..theta_ngroups). Everything is
    Gaussian, so the posterior mean/covariance have closed forms
    (:meth:`posterior_moments`) that tests assert against. The hierarchical
    prior is exactly samplable (:meth:`draw_prior`), which is what the
    prior-draw jump needs.
    """

    def __init__(self, ngroups=49, s_mu=3.0, s_t=1.0, s_y=0.5, seed=0):
        self.ngroups = int(ngroups)
        self.ndim = self.ngroups + 1
        self.s_mu, self.s_t, self.s_y = float(s_mu), float(s_t), float(s_y)
        rng = np.random.default_rng(seed)
        true_mu = rng.normal(0.0, s_mu)
        true_theta = true_mu + rng.normal(0.0, s_t, self.ngroups)
        self.y = true_theta + rng.normal(0.0, s_y, self.ngroups)
        self._y_j = jnp.asarray(self.y, jnp.float32)

    def lnpriorfn(self, x):
        """Hierarchical prior p(mu) * prod_i p(theta_i | mu), up to an
        additive constant (constants cancel in MH ratios and in the
        prior-draw Hastings correction logp(x) - logp(q))."""
        mu = x[0]
        th = x[1:]
        return (
            -0.5 * (mu / self.s_mu) ** 2
            - 0.5 * jnp.sum(((th - mu) / self.s_t) ** 2)
        )

    def lnlikefn(self, x):
        th = x[1:]
        return -0.5 * jnp.sum(((self._y_j - th) / self.s_y) ** 2)

    def lnlikefn_grad(self, x):
        return jax.value_and_grad(self.lnlikefn)(x)

    def lnpriorfn_grad(self, x):
        return jax.value_and_grad(self.lnpriorfn)(x)

    def draw_prior(self, key):
        """Exact ancestral sample from the hierarchical prior."""
        kmu, kth = jax.random.split(key)
        mu = self.s_mu * jax.random.normal(kmu, (), jnp.float32)
        th = mu + self.s_t * jax.random.normal(kth, (self.ngroups,), jnp.float32)
        return jnp.concatenate([mu[None], th])

    def posterior_moments(self):
        """Closed-form posterior mean and covariance of (mu, theta)."""
        g = self.ngroups
        prec = np.zeros((self.ndim, self.ndim))
        prec[0, 0] = 1.0 / self.s_mu**2 + g / self.s_t**2
        prec[0, 1:] = prec[1:, 0] = -1.0 / self.s_t**2
        np.fill_diagonal(prec[1:, 1:], 1.0 / self.s_t**2 + 1.0 / self.s_y**2)
        b = np.zeros(self.ndim)
        b[1:] = self.y / self.s_y**2
        cov = np.linalg.inv(prec)
        return cov @ b, cov


class IntervalTransformedGaussian:
    """Standard normal on a box, logit-transformed to R^n
    (reference tests/test_nuts.py:50-162)."""

    def __init__(self, ndim=40, pmin=0.0, pmax=10.0):
        self.ndim = ndim
        self.a = jnp.full((ndim,), float(pmin))
        self.b = jnp.full((ndim,), float(pmax))

    def backward(self, p):
        return (self.b - self.a) * jax.nn.sigmoid(p) + self.a

    def _log_jacobian(self, p):
        return jnp.sum(jnp.log(self.b - self.a) + p - 2 * jnp.log1p(jnp.exp(p)))

    def _base_lnlike(self, x):
        return -0.5 * jnp.sum(x**2) - self.ndim * 0.5 * jnp.log(2 * jnp.pi)

    def lnlikefn(self, p):
        x = self.backward(p)
        return self._base_lnlike(x) + self._log_jacobian(p)

    def lnpriorfn(self, p):
        return jnp.zeros(())

    def lnlikefn_grad(self, p):
        return jax.value_and_grad(self.lnlikefn)(p)

    def lnpriorfn_grad(self, p):
        return self.lnpriorfn(p), jnp.zeros_like(p)

    def posterior_moments(self, n=2_000_001):
        """Posterior mean and covariance of the sampled (logit-space) vector.

        Dimensions are independent and identical: x ~ N(0,1) truncated to
        (a, b), p = logit((x-a)/(b-a)). Moments of p come from midpoint
        quadrature in x-space (E[g(p)] = int g(p(x)) phi(x) dx / Z), giving
        the bench a ground-truth mean for the 40-D gradient-jump workload.
        """
        a, b = float(self.a[0]), float(self.b[0])
        h = (b - a) / n
        xs = a + (np.arange(n) + 0.5) * h
        w = np.exp(-0.5 * xs**2)
        p = np.log(xs - a) - np.log(b - xs)
        z = w.sum()
        mean = float((w * p).sum() / z)
        var = float((w * (p - mean) ** 2).sum() / z)
        d = int(self.ndim)
        return np.full(d, mean), np.eye(d) * var
