"""The port's L-BFGS (ngsf_hmm_tpu_torch.models.lbfgsb) against
ngsf_hmm_tpu.models.lbfgsb.lbfgsb_minimize_host -- the numpy/Python-loop
backend of the same core -- in float64 on the objectives of
tests/test_lbfgsb.py: outer-iteration counts equal, endpoints, values and
curvature memory equal to 1e-12 (the same update rules in the same order
on IEEE doubles)."""

import numpy as np
import pytest
import torch

from ngsf_hmm_tpu.models.lbfgsb import lbfgsb_minimize_host
from ngsf_hmm_tpu_torch.models.lbfgsb import lbfgsb_minimize

# the suite runs several workers side by side: keep torch to one thread
torch.set_num_threads(1)

TOL = 1e-12


def _stack(cols, like):
    if isinstance(like, torch.Tensor):
        return torch.stack(cols, dim=-1)
    return np.stack(cols, axis=-1)


def _quadratics():
    rng = np.random.default_rng(0)
    B = 16
    mu = rng.uniform(-2, 2, size=(B, 2))
    c = rng.uniform(0.5, 4.0, size=(B, 2))

    def vag(x):
        m, cc = (torch.as_tensor(mu), torch.as_tensor(c)) if isinstance(
            x, torch.Tensor) else (mu, c)
        d = x - m
        return (cc * d * d).sum(-1), 2.0 * cc * d

    return vag, np.zeros((B, 2)), np.full((B, 2), -1.0), np.full((B, 2), 1.0)


def _rosenbrock():
    rng = np.random.default_rng(1)
    B = 8
    x0 = rng.uniform(-1.5, 1.5, size=(B, 2))

    def vag(x):
        a, b = x[:, 0], x[:, 1]
        f = (1 - a) ** 2 + 100 * (b - a**2) ** 2
        ga = -2 * (1 - a) - 400 * a * (b - a**2)
        gb = 200 * (b - a**2)
        return f, _stack([ga, gb], x)

    return vag, x0, np.full((B, 2), -2.0), np.full((B, 2), 2.0)


def _pinned():
    B = 4

    def vag(x):
        return ((x - 3.0) ** 2).sum(-1), 2.0 * (x - 3.0)

    lower = np.stack([np.full(B, 0.7), np.full(B, -10.0)], axis=-1)
    upper = np.stack([np.full(B, 0.7), np.full(B, 10.0)], axis=-1)
    return vag, np.full((B, 2), 0.7), lower, upper


def _corner_trap():
    def vag(x):
        a, b = x[:, 0], x[:, 1]
        f = 100.0 * (b - 0.05) ** 2 + 40.0 * (a - 0.6) ** 2
        return f, _stack([80.0 * (a - 0.6), 200.0 * (b - 0.05)], x)

    B = 3
    return (vag, np.tile([[0.1, 0.9]], (B, 1)), np.zeros((B, 2)),
            np.ones((B, 2)))


def _below_breakpoint():
    def vag(x):
        a, b = x[:, 0], x[:, 1]
        f = 2000.0 * (b - 0.01) ** 2 + 0.5 * (a - 0.5) ** 2
        return f, _stack([1.0 * (a - 0.5), 4000.0 * (b - 0.01)], x)

    B = 2
    return (vag, np.tile([[0.1, 0.2]], (B, 1)), np.full((B, 2), 1e-15),
            np.tile([[1.0, 10.0]], (B, 1)))


def _bound_seeking():
    def vag(x):
        f = 3.0 * x[:, 0] - 2.0 * x[:, 1]
        g = _stack([3.0 + 0.0 * x[:, 0], -2.0 + 0.0 * x[:, 1]], x)
        return f, g

    B = 2
    return (vag, np.full((B, 2), 0.5), np.zeros((B, 2)), np.ones((B, 2)))


PROBLEMS = {
    "quadratics": (_quadratics, 60),
    "rosenbrock": (_rosenbrock, 300),
    "pinned": (_pinned, 60),
    "corner_trap": (_corner_trap, 60),
    "below_breakpoint": (_below_breakpoint, 60),
    "bound_seeking": (_bound_seeking, 60),
}


def _both(vag, x0, lo, hi, max_iters=60, warm_np=None, f0g0=False):
    kw = dict(max_iters=max_iters, return_memory=True)
    seed_np = seed_t = None
    if f0g0:
        xc = np.clip(x0, lo, hi)
        seed_np = vag(xc)
        seed_t = vag(torch.as_tensor(xc))
    host = lbfgsb_minimize_host(None, x0, lo, hi, value_and_grad=vag,
                                warm=warm_np, f0g0=seed_np, **kw)
    warm_t = None if warm_np is None else tuple(
        torch.as_tensor(np.asarray(a)) for a in warm_np)
    port = lbfgsb_minimize(None, torch.as_tensor(x0), torch.as_tensor(lo),
                           torch.as_tensor(hi), value_and_grad=vag,
                           warm=warm_t, f0g0=seed_t, **kw)
    return host, port


def _assert_same(host, port):
    xh, fh, ith, memh = host
    xp, fp, itp, memp = port
    assert int(ith) == int(itp)
    np.testing.assert_allclose(xp.numpy(), xh, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(fp.numpy(), fh, rtol=TOL, atol=TOL)
    for a, b in zip(memp, memh):
        if a.dtype == torch.bool:
            assert np.array_equal(a.numpy(), np.asarray(b))
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                       atol=TOL)


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_lbfgsb_matches_host_core(name):
    make, max_iters = PROBLEMS[name]
    vag, x0, lo, hi = make()
    host, port = _both(vag, x0, lo, hi, max_iters=max_iters)
    _assert_same(host, port)
    assert int(port[2]) > 0


def test_warm_memory_round_trip_and_f0g0():
    """The curvature memory of one solve warm-starts the next (a nearby
    objective) identically in both packages, through numpy and back; a
    precomputed first evaluation leaves the trajectory unchanged."""
    rng = np.random.default_rng(7)
    B = 32
    mu = rng.uniform(-2, 2, size=(B, 2))
    c = rng.uniform(0.5, 4.0, size=(B, 2))

    def make(mu_):
        def vag(x):
            m, cc = (torch.as_tensor(mu_), torch.as_tensor(c)) if isinstance(
                x, torch.Tensor) else (mu_, c)
            d = x - m
            f = (cc * d * d).sum(-1) + 0.3 * d[:, 0] * d[:, 1]
            g = 2.0 * cc * d + 0.3 * _stack([d[:, 1], d[:, 0]], x)
            return f, g
        return vag

    lo, hi = np.full((B, 2), -10.0), np.full((B, 2), 10.0)
    host1, port1 = _both(make(mu), np.zeros((B, 2)), lo, hi)
    _assert_same(host1, port1)
    mem_np = tuple(t.numpy() for t in port1[3])  # device -> host
    mu2 = mu + rng.normal(0, 0.01, mu.shape)  # the "next EM iteration"
    host2, port2 = _both(make(mu2), host1[0], lo, hi, warm_np=mem_np,
                         f0g0=True)
    _assert_same(host2, port2)
    cold = lbfgsb_minimize(None, torch.as_tensor(host1[0]),
                           torch.as_tensor(lo), torch.as_tensor(hi),
                           value_and_grad=make(mu2))
    assert int(port2[2]) <= int(cold[2]) and int(port2[2]) <= 3
    np.testing.assert_allclose(port2[0].numpy(), cold[0].numpy(), atol=2e-3)


def test_autograd_gradient_path():
    """Without value_and_grad the gradient comes from torch.autograd."""
    vag, x0, lo, hi = _quadratics()
    a = lbfgsb_minimize(lambda x: vag(x)[0], torch.as_tensor(x0),
                        torch.as_tensor(lo), torch.as_tensor(hi))
    b = lbfgsb_minimize(None, torch.as_tensor(x0), torch.as_tensor(lo),
                        torch.as_tensor(hi), value_and_grad=vag)
    assert a[2] == b[2]
    np.testing.assert_allclose(a[0].numpy(), b[0].numpy(), rtol=1e-10,
                               atol=1e-12)
