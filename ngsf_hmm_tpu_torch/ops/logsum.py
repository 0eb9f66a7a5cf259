"""Max-shifted log-sum-exp, in the reference's operation order.

The reference computes ``log(sum_i exp(a_i))`` by shifting by the maximum
and summing in index order (reference: shared/gen_func.cpp:135-151). The
functions here keep that order; they are shape-polymorphic torch ops.
"""

import torch


def _guard(out, m):
    # exp(-inf - m) == 0 for finite m; only the all--inf case needs a guard
    return torch.where(torch.isneginf(m), torch.full_like(out, -torch.inf), out)


def logsum2(a, b):
    """log(exp(a) + exp(b)), elementwise. Matches gen_func.cpp:155-160."""
    m = torch.maximum(a, b)
    s = torch.exp(a - m) + torch.exp(b - m)
    return _guard(torch.log(s) + m, m)


def logsum3(a, b, c):
    """log(exp(a)+exp(b)+exp(c)) summed in index order (gen_func.cpp:164-169)."""
    m = torch.maximum(torch.maximum(a, b), c)
    s = (torch.exp(a - m) + torch.exp(b - m)) + torch.exp(c - m)
    return _guard(torch.log(s) + m, m)


def logsum(a, dim=-1):
    """log-sum-exp over ``dim`` (gen_func.cpp:135-151 for any n)."""
    m = torch.amax(a, dim=dim, keepdim=True)
    s = torch.sum(torch.exp(a - m), dim=dim)
    m = m.squeeze(dim)
    return _guard(torch.log(s) + m, m)
