"""Package-level contracts of the port: it imports neither jax nor the
JAX package, its writers and readers are byte-compatible with the JAX
package's, its CLI runs end to end on the CPU and refuses what is not
ported, and asking for the card without one raises."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from ngsf_hmm_tpu.io import readers as j_readers
from ngsf_hmm_tpu.io import writers as j_writers
from ngsf_hmm_tpu.io.gsl_rng import GslTaus as JGslTaus
from ngsf_hmm_tpu.io.init import init_freq as j_init_freq
from ngsf_hmm_tpu.io.init import init_indF_alpha as j_init_indF_alpha
from ngsf_hmm_tpu_torch.io import readers as t_readers
from ngsf_hmm_tpu_torch.io import writers as t_writers
from ngsf_hmm_tpu_torch.io.gsl_rng import GslTaus
from ngsf_hmm_tpu_torch.io.init import init_freq, init_indF_alpha
from ngsf_hmm_tpu_torch.models import em as t_em

# the suite runs several workers side by side: keep torch to one thread
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]


def _run(code_or_args, module=False):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    cmd = [sys.executable] + (
        ["-m", "ngsf_hmm_tpu_torch", *code_or_args] if module
        else ["-c", code_or_args])
    return subprocess.run(cmd, env=env, cwd=REPO, capture_output=True,
                          text=True, timeout=120)


def test_import_pulls_no_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "import ngsf_hmm_tpu_torch as p\n"
        "import ngsf_hmm_tpu_torch.cli, ngsf_hmm_tpu_torch.convert\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'ngsf_hmm_tpu' or m.startswith('ngsf_hmm_tpu.')]\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
        "print('clean', len(sys.modules))\n"
    )
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("clean")


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(3)
    S, N = 50, 4
    gl = np.log(rng.dirichlet(np.ones(3), size=(S, N)))
    return dict(
        gl=gl, freq=rng.uniform(0.01, 0.49, S),
        indF=rng.uniform(0, 1, N), alpha=rng.uniform(0, 1, N),
        lkl=-rng.uniform(10, 100, N),
        path=rng.integers(0, 2, size=(S, N)).astype(np.int8),
        p_ibd=rng.uniform(0, 1, size=(S, N)),
    )


def test_writers_bytes_equal_jax_package(arrays, tmp_path):
    a = arrays
    for mod, tag in ((j_writers, "j"), (t_writers, "t")):
        mod.write_indF(str(tmp_path / f"{tag}.indF"), -123.456, a["indF"],
                       a["alpha"], a["freq"])
        mod.write_ibd(str(tmp_path / f"{tag}.ibd"), a["lkl"], a["path"],
                      a["p_ibd"])
        mod.write_geno(str(tmp_path / f"{tag}.geno"), a["gl"], a["freq"],
                       a["path"])
    for ext in ("indF", "ibd", "geno"):
        jb = (tmp_path / f"j.{ext}").read_bytes()
        assert jb and jb == (tmp_path / f"t.{ext}").read_bytes(), ext
    with pytest.raises(NotImplementedError):
        t_writers.write_geno(str(tmp_path / "x.geno"), a["gl"], a["freq"],
                             a["path"], exact_libm=True)


def test_readers_and_init_equal_jax_package(arrays, tmp_path):
    S, N = arrays["path"].shape
    geno = tmp_path / "in.geno"
    np.exp(arrays["gl"]).astype("<f8").tofile(geno)
    pos = tmp_path / "in.pos"
    pos.write_text("".join(
        f"chr{1 + (s >= 30)}\t{1000 * (s + 1)}\n" for s in range(S)))
    gj = j_readers.read_geno(str(geno), N, S, binary=True)
    gt = t_readers.read_geno(str(geno), N, S, binary=True)
    # the JAX package may read through its C++ loader, whose libm log can
    # differ from numpy's in the last place
    np.testing.assert_allclose(gt, gj, rtol=1e-14, atol=0)
    dj = j_readers.read_pos_dist(str(pos), S)
    dt = t_readers.read_pos_dist(str(pos), S)
    assert np.array_equal(dj, dt) and np.isinf(dt[30])
    assert t_readers.sniff_binary(str(geno), N, S)
    rj, rt = JGslTaus(383), GslTaus(383)
    for x, y in zip(j_init_indF_alpha("r", N, rj), init_indF_alpha("r", N, rt)):
        assert np.array_equal(x, y)
    assert np.array_equal(j_init_freq("r", S, rj), init_freq("r", S, rt))
    assert np.array_equal(j_init_freq("0.2", S, rj), init_freq("0.2", S, rt))
    with pytest.raises(NotImplementedError):
        init_freq("e", S, rt, gl=arrays["gl"])


def test_cuda_without_a_card_raises(arrays):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    a = arrays
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_em.init_state(a["gl"], a["freq"], a["indF"], a["alpha"])  # default
    st = t_em.init_state(a["gl"], a["freq"], a["indF"], a["alpha"],
                         device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_em.run_em(a["gl"], np.ones(50), st, t_em.EMOptions())


def test_cli_end_to_end_on_cpu(arrays, tmp_path):
    S, N = arrays["path"].shape
    geno = tmp_path / "in.geno"
    np.exp(arrays["gl"]).astype("<f8").tofile(geno)
    pos = tmp_path / "in.pos"
    pos.write_text("".join(f"chr1\t{5000 * (s + 1)}\n" for s in range(S)))
    base = ["--geno", str(geno), "--pos", str(pos), "--n_ind", str(N),
            "--n_sites", str(S), "--freq", "0.2", "--indF", "0.1-0.05",
            "--min_iters", "2", "--max_iters", "3",
            "--out", str(tmp_path / "run")]
    ok = _run(base + ["--freq_est", "0", "--device", "cpu"], module=True)
    assert ok.returncode == 0, ok.stderr
    assert "Final logLkl" in ok.stdout
    assert (tmp_path / "run.geno").stat().st_size == S * N * 3 * 8
    assert len((tmp_path / "run.indF").read_text().splitlines()) == 1 + N + S
    assert len((tmp_path / "run.ibd").read_text().splitlines()) > 0
    # the default device is the card: without one the CLI errors out
    if not torch.cuda.is_available():
        r = _run(base + ["--freq_est", "0"], module=True)
        assert r.returncode != 0 and "no CUDA device" in r.stderr


@pytest.mark.parametrize("extra", [
    ["--freq_est", "1"], ["--freq_est", "0", "--mesh", "ind=2"],
    ["--freq_est", "0", "--kernel", "scan"], ["--freq_est", "0", "--n_rep", "2"],
    ["--freq_est", "0", "--opt", "compat"],
    ["--freq_est", "0", "--stream_chunk", "10"],
    ["--freq_est", "0", "--dtype", "float64"], ["--freq_est", "0", "--freq", "e"],
], ids=lambda e: "".join(e[-2:]).lstrip("-"))
def test_cli_refuses_unported_flags(extra, capsys):
    """Flags of later slices are parsed and refused before any input is
    read (in-process: the refusal comes before the files are opened)."""
    from ngsf_hmm_tpu_torch.cli import main

    base = ["--geno", "none.geno", "--pos", "none.pos", "--n_ind", "4",
            "--n_sites", "50", "--out", "none", "--verbose", "0",
            "--device", "cpu"]
    with pytest.raises(SystemExit) as exc:
        main(base + extra)
    assert exc.value.code != 0
    assert "not ported yet" in capsys.readouterr().err
