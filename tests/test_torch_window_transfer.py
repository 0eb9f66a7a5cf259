"""The virtual window of the freq M-step and the transfer stream's
candidates, on the CPU.

On the card maf_window (csrc/maf_window.cu) runs a thread a site, reads
no gradients for a site inactive at entry and hoists the trip-budget test
out of its step loop; the transfer kernel (csrc/transfer_stream.cuh,
exported by csrc/block_transfer.cu) runs a group of candidates from one
staged tile (models/hmm_kernels.py transfer_candidates). Both are bit-equal
to their plain versions there (chip_smoke.py). Here:
- the plain window (ops/maf_kernels.py _virtual_window_plain, through the
  wrapper) against the JAX package's maf_pallas._virtual_window on a state
  that mixes sites inactive at entry and sites that stop at different
  steps, in windows inside, up to, across and past the ITER_MAX budget,
  and a window of no steps;
- the plain transfer at B = 3 on float32 and bfloat16 gl slabs and on
  emission slabs, each candidate bit-equal to the B = 1 run on its own
  parameters, the transfer-and-tangent kernel's primal rows equal to its
  output at B = 1 on those two slab types, and its log-likelihoods
  against the JAX package's float64
  sequential tier; the Pallas transfer kernel itself (interpret mode, ~10
  s a shape) is held in tests/test_torch_hmm_kernels.py;
- transfer_candidates against its rule and the CUDA source's constants.
No jitted em_iteration and no Pallas interpret shape: seconds in all.

Tolerances, with their reasons:
- window rows: 2e-5 of max(|x|, 1), `active` equal on every site, as
  tests/test_torch_maf_kernels.py holds the window (the JAX side runs the
  same operations under XLA, which may fuse them).
- log-likelihoods rtol 2e-6 against float64: float32 chains
  (tests/test_torch_hmm_kernels.py).
"""

import pathlib
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import oracle
from ngsf_hmm_tpu.models import hmm as j_hmm
from ngsf_hmm_tpu.ops import maf_pallas as j_mp
from ngsf_hmm_tpu_torch.models import hmm_kernels as hk
from ngsf_hmm_tpu_torch.models import hmm_kernels_v1 as h1
from ngsf_hmm_tpu_torch.ops import maf_kernels as mk
from ngsf_hmm_tpu_torch.utils.constants import ITER_MAX
from test_torch_maf import realistic_gls, scaled_diff

# the suite runs several workers side by side: keep torch to one thread
torch.set_num_threads(1)

ROWS = ("freq", "num", "den", "active")


def _source(name):
    return (pathlib.Path(hk.__file__).parents[1] / "csrc" / name).read_text()


# ---------------------------------------------------------------------------
# the virtual window
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def window_state():
    """(st, grads) [4, bs, nb] from kernel A's plain version after K0 = 8
    real passes at 600 sites x 40 individuals, with every seventh site set
    inactive at entry (on top of those kernel A's passes stopped)."""
    rng = np.random.default_rng(2024)
    S, N = 600, 40
    gl = torch.as_tensor(realistic_gls(rng, S, N).astype(np.float32))
    p = torch.as_tensor((rng.random((S, N)) * 0.9).astype(np.float32))
    tp = hk.prepare_gl_inputs(gl, torch.zeros(S))
    a = mk._k_maf_state_grad(tp["g0"], tp["g2"], hk.pack_sites2(p, tp, 0.5),
                             8)
    st, grads = a[:4].clone(), a[4:].contiguous()
    st[3].view(-1)[::7] = 0.0
    return st, grads


def _steps(st, grads, passes0, M):
    """Per-site steps taken while active (the plain version's loop)."""
    s, f0 = tuple(st), st[0]
    steps = torch.zeros_like(f0)
    for k in range(M):
        steps += s[3]
        df = s[0] - f0
        s = mk._advance_plain(s, grads[0] + grads[2] * df,
                              grads[1] + grads[3] * df,
                              passes0 + k + 1 <= ITER_MAX)
    return steps


@pytest.mark.parametrize(
    "passes0, M", [(8, 40), (60, 40), (60, 45), (ITER_MAX - 1, 3),
                   (ITER_MAX, 5)],
    ids=["inside", "ends_at_budget", "crosses", "one_inside", "past"])
def test_window_plain_matches_jax(window_state, passes0, M):
    """The window's plain version (the CPU route of _k_maf_window) against
    maf_pallas._virtual_window from the same state and model: a window
    inside the trip budget, one whose last step is the budget's last (no
    step past it), one whose step 39 is the first past ITER_MAX, one with
    a single step inside, and one that starts past the budget (each
    active site takes one step and stops). The state mixes sites inactive
    at entry and sites that stop at different steps; 2e-5 of
    max(|x|, 1), `active` equal."""
    st, grads = window_state
    steps = _steps(st, grads, passes0, M)
    active0 = st[3] != 0
    assert int((~active0).sum()) >= 80  # inactive at entry
    if passes0 == ITER_MAX:
        assert torch.equal(steps, st[3])
    elif M > 3:
        assert len(torch.unique(steps[active0])) >= 5  # stop at many steps
    out = mk._k_maf_window(st, grads, passes0, M)
    assert out.shape == st.shape
    want = j_mp._virtual_window(
        tuple(jnp.asarray(x.numpy()) for x in st),
        tuple(jnp.asarray(x.numpy()) for x in grads), passes0, M)
    for k, name in enumerate(ROWS):
        got, w = out[k].numpy(), np.asarray(want[k])
        if name == "active":
            assert np.array_equal(got, w)
        else:
            d = scaled_diff(got, w)
            print(f"observed window {name} (passes0 {passes0}, M {M}): "
                  f"scaled diff {d:.3g}")
            assert d <= 2e-5, name
    # inactive at entry: the state passes through unchanged
    assert torch.equal(out[:, ~active0], st[:, ~active0])
    if passes0 + M > ITER_MAX:
        assert not out[3].any()
    else:  # sites still moving after the last step stay active
        assert out[3].any()


def test_window_without_steps_is_the_state(window_state):
    """A window of no steps, and any window of a state with every site
    inactive, returns the state bit for bit (the kernel copies it)."""
    st, grads = window_state
    assert torch.equal(mk._k_maf_window(st, grads, 8, 0), st)
    idle = st.clone()
    idle[3] = 0.0
    assert torch.equal(mk._k_maf_window(idle, grads, 8, 40), idle)


# ---------------------------------------------------------------------------
# the transfer stream's candidates
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def transfer_case():
    rng = np.random.default_rng(4242)
    S, N = 333, 6
    gl, freq, dist, F, alpha, e = oracle.random_case(
        rng, S=S, N=N, chrom_break_every=101)
    gl_lin = torch.as_tensor(np.exp(np.transpose(gl, (1, 0, 2))))
    F, alpha = torch.as_tensor(F).float(), torch.as_tensor(alpha).float()
    Fs = torch.stack([F, F * 0.7, torch.clamp(F * 1.2, 0, 0.99)])
    As = torch.stack([alpha, alpha * 2.0, alpha * 0.5])
    return dict(gl_lin=gl_lin.float(), freq=torch.as_tensor(freq).float(),
                dist=torch.as_tensor(dist).float(), e=e, dist64=dist,
                Fs=Fs.contiguous(), As=As.contiguous(), S=S, N=N)


def _slabs(c, source):
    """The transfer wrapper and its slab arguments for one source."""
    if source == "v1":
        prep = h1.prepare_inputs(torch.as_tensor(c["e"]).float(), c["dist"])
        return h1._k_block_transfer_v1, (prep["e0"], prep["e1"], prep["dc"])
    dt = torch.bfloat16 if source == "bf16" else torch.float32
    prep = hk.prepare_gl_inputs(c["gl_lin"], c["dist"], gl_dtype=dt)
    return hk._k_block_transfer, (prep["g0"], prep["g2"],
                                  hk.freq_compact(c["freq"], prep),
                                  prep["dc"])


@pytest.mark.parametrize("source", ["f32", "bf16", "v1"])
def test_transfer_candidates_equal_single_runs(transfer_case, source):
    """The transfer's plain version at B = 3 (two CTA groups on the card,
    the second ragged): each candidate's products and offsets equal the
    B = 1 run on that candidate's own (F, alpha) bit for bit."""
    c = transfer_case
    kern, sl = _slabs(c, source)
    out = kern(*sl, c["Fs"], c["As"])
    assert out.shape == (5, 3) + sl[0].shape[1:]
    assert torch.isfinite(out).all()
    for b in range(3):
        one = kern(*sl, c["Fs"][b:b + 1].contiguous(),
                   c["As"][b:b + 1].contiguous())
        assert torch.equal(out[:, b:b + 1], one), b


@pytest.mark.parametrize("source", ["bf16", "v1"])
def test_grad_primal_rows_equal_transfer(transfer_case, source):
    """The transfer-and-tangent kernel's primal rows and offset (its
    plain version) equal the transfer kernel's output at B = 1 bit for bit
    on bfloat16 gl slabs and on emission slabs too (the E-step / f0 merge
    relies on it; on the card both kernels run one primal step,
    csrc/transfer_stream.cuh). tests/test_torch_hmm_kernels.py holds it on
    float32 gl slabs."""
    c = transfer_case
    kern, sl = _slabs(c, source)
    grad = (h1._k_block_transfer_grad_v1 if source == "v1"
            else hk._k_block_transfer_grad)
    F, a = c["Fs"][0].contiguous(), c["As"][0].contiguous()
    g = grad(*sl, F, a)
    assert g.shape == (13,) + sl[0].shape[1:]
    assert torch.equal(torch.cat([g[:4], g[12:]])[:, None],
                       kern(*sl, F[None], a[None]))


def test_transfer_candidates_loglik_matches_jax_sequential(transfer_case):
    """forward_loglik_fused at B = 3 (the transfer kernel, then the
    combine) against the JAX package's float64 sequential tier on each
    candidate, rtol 2e-6."""
    c = transfer_case
    prep = hk.prepare_gl_inputs(c["gl_lin"], c["dist"])
    ll = hk.forward_loglik_fused(c["Fs"], c["As"], prep,
                                 hk.freq_compact(c["freq"], prep))
    for b in range(3):
        want = np.asarray(j_hmm.forward_loglik(
            jnp.asarray(c["Fs"][b].double().numpy()),
            jnp.asarray(c["As"][b].double().numpy()), jnp.asarray(c["e"]),
            jnp.asarray(c["dist64"])))
        np.testing.assert_allclose(ll[b].numpy(), want, rtol=2e-6)


def test_transfer_candidates_rule_and_source():
    """transfer_candidates: one candidate a CTA group for B = 1, else
    TRANSFER_CANDS, ceil(B / bc) groups; B < 1 refused. TRANSFER_CANDS is
    csrc/transfer_stream.cuh's NGSF_BT_CANDS, and csrc/block_transfer.cu's
    launch takes exactly the group sizes the chooser gives."""
    for B in range(1, 10):
        bc, groups = hk.transfer_candidates(B)
        assert bc == (1 if B == 1 else hk.TRANSFER_CANDS)
        assert groups == -(-B // bc) and (groups - 1) * bc < B <= groups * bc
    for bad in (0, -2):
        with pytest.raises(ValueError):
            hk.transfer_candidates(bad)
    cands = re.search(r"#define NGSF_BT_CANDS (\d+)",
                      _source("transfer_stream.cuh"))
    assert int(cands.group(1)) == hk.TRANSFER_CANDS
    taken = {int(v) if v.isdigit() else hk.TRANSFER_CANDS
             for v in re.findall(r"if \(bc == (\w+)\)",
                                 _source("block_transfer.cu"))}
    assert taken == {hk.transfer_candidates(B)[0] for B in range(1, 10)}
