"""State carried across: the JAX package's arrays <-> this package's.

Both packages keep the same fields in the same layouts, so a state moves
between them as a dict of numpy arrays. The tests start both engines from
one state through these functions. The same functions carry the stacked
states of the multi-restart protocol (every field with a leading [R]
axis, as both packages' stack_restart_states build them) and the
flattened replicates' L-BFGS memory ([m, R*N, 2], n_cols = R*N). With
dtype None a state or memory keeps its arrays' own float type: float64
for the scan tier (the JAX package with x64), float32 for the fused one.
"""

import numpy as np
import torch

from .models.em import EMState, _device, restore_opt_memory

STATE_FIELDS = ("freq", "indF", "alpha", "e_prob", "p_ibd", "ind_lkl")


def state_from_jax(arrays, device="cuda", dtype=None) -> EMState:
    """dict of numpy arrays (freq [S], indF [N], alpha [N], e_prob
    [S, N, 2], p_ibd [S, N], ind_lkl [N]; or each with a leading [R]
    replicate axis) -> EMState on `device` (in `dtype`, or None: each
    array's own)."""
    dev = _device(device)
    return EMState(*(
        torch.as_tensor(np.array(arrays[k])).to(device=dev, dtype=dtype)
        for k in STATE_FIELDS
    ))


def state_to_jax(state: EMState) -> dict:
    """EMState -> dict of numpy arrays (the inverse of state_from_jax)."""
    return {k: getattr(state, k).detach().cpu().numpy() for k in STATE_FIELDS}


def opt_memory_from_jax(raw, n_cols, device="cuda", dtype=None):
    """The L-BFGS memory tuple (S [m, B, 2], Y, valid [m, B], head [B]) as
    host arrays -> device tensors (S and Y in `dtype`, or None: their
    own); None if it does not fit n_cols rows (the shape contract of
    restore_opt_memory)."""
    if dtype is None and raw is not None:
        dtype = torch.as_tensor(np.asarray(raw[0])).dtype
    return restore_opt_memory(raw, n_cols, dtype, device=device)


def opt_memory_to_jax(mem):
    """Device L-BFGS memory -> tuple of numpy arrays (None passes)."""
    if mem is None:
        return None
    return tuple(t.detach().cpu().numpy() for t in mem)
