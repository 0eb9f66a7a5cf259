"""Distance-dependent two-state transition model.

The IBD process switches between states {0 = non-IBD, 1 = IBD} with a
stationary distribution ``q = [1-F, F]`` and a distance-decay mixing rate:

    T_d[k, l] = (1 - exp(-alpha * d)) * q[l] + delta_{kl} * exp(-alpha * d)

with ``d`` the inter-site distance in megabases (reference:
shared/HMM.cpp:130-139). ``d = +inf`` (chromosome break) collapses the row
to the stationary ``q``.
"""

import torch


def log_q(F):
    """Stationary log-distribution [..., 2] from inbreeding F (EM.cpp:415)."""
    return torch.log(torch.stack([1.0 - F, F], dim=-1))


def trans(F, alpha, dist):
    """Linear-space transition matrices [..., 2, 2]; [k, l] = from k to l."""
    F, alpha = torch.broadcast_tensors(F, alpha)
    x = torch.exp(-alpha * dist)
    q = torch.stack([1.0 - F, F], dim=-1)
    stay = torch.eye(2, dtype=q.dtype, device=q.device)
    return (1.0 - x)[..., None, None] * q[..., None, :] + x[..., None, None] * stay


def log_trans(F, alpha, dist):
    """Log transition matrices [..., 2, 2]."""
    return torch.log(trans(F, alpha, dist))
