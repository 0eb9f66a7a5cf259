"""Command-line interface with reference flag/stdout parity.

Accepts the same 22 options as the reference binary (reference:
parse_args.cpp:43-68), with getopt_long_only semantics: options work with
one or two leading dashes and unambiguous prefixes, values via "--opt v"
or "--opt=v". Verbose levels 1-3 reproduce the reference's progress lines.

This package carries one tier: the fused float32 chain kernels on a
single device with allele frequencies held fixed (--freq_est 0). It is the
default for --kernel / --dtype here; the flags of tiers still to be ported
(--freq_est 1/2, --e_prob 2, --mesh, --stream_chunk, --checkpoint,
--n_rep > 1, --opt compat, other --kernel / --dtype values, --gl_bf16 1,
--profile) are parsed and refused with an error.

Example:
    python -m ngsf_hmm_tpu_torch --geno data.glf.gz --loglkl --n_ind 20 \
        --n_sites 100000 --pos data.pos.gz --freq_est 0 --freq 0.2 \
        --out run1 [--device cuda|cpu]
"""

import os
import sys

import numpy as np

from .utils.constants import VERSION

# (long_name, has_arg, short_char)
_OPTIONS = [
    ("geno", True, "g"),
    ("pos", True, "Z"),
    ("lkl", False, "l"),
    ("loglkl", False, "L"),
    ("n_ind", True, "n"),
    ("n_sites", True, "s"),
    ("call_geno", False, "G"),
    ("freq", True, "f"),
    ("freq_est", True, "F"),
    ("e_prob", True, "e"),
    ("indF", True, "i"),
    ("indF_fixed", False, "I"),
    ("alpha_fixed", False, "A"),
    ("out", True, "o"),
    ("log", True, "X"),
    # --log_bin N sets log=N and a log_bin flag that NOTHING in the
    # reference ever reads (parse_args.cpp:119-121 stores it, print_iter
    # writes text regardless); parsed + echoed here for exact parity
    ("log_bin", True, "b"),
    ("min_iters", True, "m"),
    ("max_iters", True, "M"),
    ("min_epsilon", True, "E"),
    ("n_threads", True, "x"),
    ("verbose", True, "V"),
    ("seed", True, "S"),
    # engine-only extensions (not in the reference):
    ("dtype", True, None),  # float32 (the only tier ported so far)
    ("device", True, None),  # cuda (default) | cpu
    ("kernel", True, None),  # pallas = the fused kernel tier (only one ported)
    # The flags below belong to tiers this package does not carry yet;
    # they are parsed (same names as the JAX package's CLI) and refused
    # in main() unless left at their defaults.
    ("opt", True, None),  # speed (default) | compat
    ("gl_bf16", True, None),  # 0 | 1 | auto
    ("n_rep", True, None),  # multi-restart replicates
    ("checkpoint", True, None),
    ("checkpoint_every", True, None),
    ("resume", False, None),
    ("stream_chunk", True, None),
    ("stream_file", False, None),
    ("mesh", True, None),
    ("coordinator", True, None),
    ("n_procs", True, None),
    ("proc_id", True, None),
    ("profile", True, None),
]


def error(func, msg):
    sys.stdout.flush()
    sys.stderr.write(f"\n=====\nERROR: [{func}] {msg}\n=====\n\n")
    sys.stderr.flush()
    sys.exit(1)


def warn(func, msg):
    sys.stdout.flush()
    sys.stderr.write(f"\n=======\nWARNING: [{func}] {msg}\n=======\n\n")
    sys.stderr.flush()


def _atoi(v):
    """C atoi semantics (parse_args.cpp:87-137 uses atoi for every int
    flag): leading integer if any, else 0 -- garbage then trips the
    reference-style validation errors instead of a Python traceback."""
    import re

    m = re.match(r"\s*([-+]?\d+)", v or "")
    return int(m.group(1)) if m else 0


def _atof(v):
    import re

    m = re.match(r"\s*([-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?)", v or "")
    return float(m.group(1)) if m else 0.0


def _apply_opt(pars, opt, val):
    """Store one parsed option value (shared by short/long paths)."""
    if opt == "lkl":
        pars["lkl"] = True
    elif opt == "resume":
        pars["resume"] = True
    elif opt == "loglkl":
        pars["lkl"] = True
        pars["loglkl"] = True
    elif opt in ("call_geno", "indF_fixed", "alpha_fixed", "stream_file"):
        pars[opt] = True
    elif opt == "log_bin":
        pars["log"] = _atoi(val)
        pars["log_bin"] = True
    elif opt in ("n_ind", "n_sites", "freq_est", "e_prob", "log",
                 "min_iters", "max_iters", "n_threads", "verbose", "seed",
                 "n_rep", "stream_chunk", "checkpoint_every", "n_procs",
                 "proc_id"):
        pars[opt] = _atoi(val)
    elif opt == "min_epsilon":
        pars[opt] = _atof(val)
    else:
        pars[opt] = val


def parse_args(argv):
    """getopt_long_only-style parser over _OPTIONS."""
    pars = {
        "geno": None,
        "pos": None,
        "lkl": False,
        "loglkl": False,
        "n_ind": 0,
        "n_sites": 0,
        "call_geno": False,
        "freq": None,
        "freq_est": 1,
        "e_prob": 1,
        "indF": None,
        "indF_fixed": False,
        "alpha_fixed": False,
        "out": None,
        "log": 0,
        "log_bin": False,
        "min_iters": 10,
        "max_iters": 100,
        "min_epsilon": 1e-5,
        "n_threads": 1,
        "verbose": 1,
        # the reference defaults to rand()%1000 from an unseeded glibc
        # rand(), i.e. deterministically 1804289383 % 1000 = 383
        # (parse_args.cpp:30)
        "seed": 383,
        "dtype": "float32",
        "device": "cuda",
        "kernel": "pallas",
        "opt": "speed",
        "gl_bf16": "auto",
        "n_rep": 1,
        "checkpoint": None,
        "checkpoint_every": 1,
        "resume": False,
        "profile": None,
        "stream_chunk": 0,
        "stream_file": False,
        "mesh": None,
        "coordinator": None,
        "n_procs": 1,
        "proc_id": 0,
    }
    short_map = {s: (name, has) for name, has, s in _OPTIONS if s}
    longs = [(name, has) for name, has, _ in _OPTIONS]

    i = 0
    while i < len(argv):
        tok = argv[i]
        if not tok.startswith("-") or tok == "-":
            error("parse_cmd_args", f"unexpected argument: {tok}")
        name = tok.lstrip("-")
        val = None
        if "=" in name:
            name, val = name.split("=", 1)

        # glibc getopt_long_only: a single-dash token whose FIRST char is
        # a valid short option is parsed as short option(s) -- long
        # matching only happens for "--" tokens or unknown first chars
        # (reference optstring at parse_args.cpp:71). Handles bundling
        # (-lL) and glued arguments (-s1000) like getopt does.
        if (
            not tok.startswith("--")
            and val is None
            and name
            and name[0] in short_map
        ):
            j = 0
            while j < len(name):
                opt, has_arg = short_map.get(name[j], (None, None))
                if opt is None:
                    error("parse_cmd_args", f"unrecognized option: -{name[j]}")
                if has_arg:
                    if j + 1 < len(name):
                        sval = name[j + 1 :]  # glued: -s1000
                    else:
                        i += 1
                        if i >= len(argv):
                            error(
                                "parse_cmd_args",
                                f"option -{name[j]} requires an argument",
                            )
                        sval = argv[i]
                    _apply_opt(pars, opt, sval)
                    break
                _apply_opt(pars, opt, None)
                j += 1
            i += 1
            continue

        matches = [(n, h) for n, h in longs if n == name]
        if not matches:
            matches = [(n, h) for n, h in longs if n.startswith(name)]
        if len(matches) > 1:
            error("parse_cmd_args", f"ambiguous option: {tok}")
        if not matches:
            error("parse_cmd_args", f"unrecognized option: {tok}")
        opt, has_arg = matches[0]
        if has_arg and val is None:
            i += 1
            if i >= len(argv):
                error("parse_cmd_args", f"option {tok} requires an argument")
            val = argv[i]
        i += 1
        _apply_opt(pars, opt, val)

    # default init strings (parse_args.cpp:150-157)
    if pars["freq"] is None:
        pars["freq"] = "r"
    if pars["indF"] is None:
        pars["indF"] = "0.01-0.001"
    return pars


def _echo_args(p):
    print("==> Input Arguments:")
    print(
        f"\tgeno: {p['geno']}\n\tpos: {p['pos']}\n"
        f"\tlkl: {'true' if p['lkl'] else 'false'}\n"
        f"\tloglkl: {'true' if p['loglkl'] else 'false'}\n"
        f"\tn_ind: {p['n_ind']}\n\tn_sites: {p['n_sites']}\n"
        f"\tcall_geno: {'true' if p['call_geno'] else 'false'}\n"
        f"\tfreq: {p['freq']}\n\tfreq_est: {p['freq_est']}\n"
        f"\te_prob: {p['e_prob']}\n\tindF: {p['indF']}\n"
        f"\tindF_fixed: {'true' if p['indF_fixed'] else 'false'}\n"
        f"\talpha_fixed: {'true' if p['alpha_fixed'] else 'false'}\n"
        f"\tout: {p['out']}\n\tlog: {p['log']}\n"
        f"\tlog_bin: {'true' if p['log_bin'] else 'false'}\n"
        f"\tmin_iters: {p['min_iters']}\n\tmax_iters: {p['max_iters']}\n"
        f"\tmin_epsilon: {p['min_epsilon']:.10f}\n"
        f"\tn_threads: {p['n_threads']}\n\tverbose: {p['verbose']}\n"
        f"\tseed: {p['seed']}\n\tversion: {VERSION} (torch)\n"
    )


def validate(p):
    if p["geno"] is None:
        error("parse_cmd_args", "genotype input file (--geno) missing!")
    if p["pos"] is None:
        error("parse_cmd_args", "positions input file (--pos) missing!")
    if p["n_ind"] == 0:
        error("parse_cmd_args", "number of individuals (--n_ind) missing!")
    if p["n_sites"] == 0:
        error("parse_cmd_args", "number of sites (--n_sites) missing!")
    if p["call_geno"] and not p["lkl"]:
        error("parse_cmd_args", "can only call genotypes from likelihoods!")
    if p["freq_est"] < 0 or p["freq_est"] > 2:
        error("parse_cmd_args", "invalid MAF estimation method!")
    if p["e_prob"] < 0 or p["e_prob"] > 2:
        error("parse_cmd_args", "invalid emission probability calculation method!")
    if p["e_prob"] > 1:
        warn(
            "parse_cmd_args",
            "calculation of emission probabilities accounting for LD is "
            "still under development!",
        )
    if p["out"] is None:
        error("parse_cmd_args", "output prefix (--out) missing!")
    if p["log"] < 0:
        error("parse_cmd_args", "invalid LOG (--log) option!")
    if (
        p["min_iters"] < 1
        or p["max_iters"] < 1
        or p["min_iters"] >= p["max_iters"]
    ):
        error("parse_cmd_args", "invalid number of iterations!")
    if p["n_threads"] < 1:
        error("parse_cmd_args", "invalid number of threads!")




def _refuse_unported(p):
    """Errors for the flags of tiers still to be ported."""
    if p["dtype"] != "float32":
        error("main", f"--dtype {p['dtype']} is not ported yet: this "
                      "package runs the fused float32 tier only")
    if p["kernel"] != "pallas":
        error("main", f"--kernel {p['kernel']} is not ported yet: this "
                      "package runs the fused kernel tier ('pallas') only")
    if p["freq_est"] != 0:
        error("main", f"--freq_est {p['freq_est']} is not ported yet "
                      "(the est_maf kernels): run with --freq_est 0 and "
                      "--freq <value|file>")
    if p["e_prob"] != 1:
        error("main", "--e_prob 2 (the LD path) is not ported yet")
    if p["opt"] != "speed":
        error("main", "--opt compat is not ported yet")
    if p["gl_bf16"] not in ("0", "auto"):
        error("main", "--gl_bf16 1 is not ported yet")
    if p["n_rep"] != 1:
        error("main", "--n_rep > 1 (multi-restart) is not ported yet")
    for flag in ("checkpoint", "mesh", "coordinator", "profile"):
        if p[flag] is not None:
            error("main", f"--{flag} is not ported yet")
    if p["resume"] or p["stream_chunk"] or p["stream_file"]:
        error("main", "--resume / --stream_chunk / --stream_file are not "
                      "ported yet")
    if p["freq"] == "e":
        error("main", "--freq e needs est_maf, which is not ported yet")
    if p["device"] not in ("cuda", "cpu") and not str(
            p["device"]).startswith("cuda:"):
        error("main", f"invalid --device {p['device']!r} (cuda|cpu)")


def main(argv=None):
    if argv is None:
        argv = sys.argv[1:]
    p = parse_args(argv)
    if p["verbose"] >= 1:
        _echo_args(p)
    if p["verbose"] >= 4:
        print(
            "==> Verbose values greater than 4 for debugging purpose only. "
            "Expect large amounts of info on screen"
        )
    validate(p)
    _refuse_unported(p)

    if p["n_threads"] > p["n_ind"]:
        warn("main", "adjusting threads (--n_threads) to match number of individuals!")
        p["n_threads"] = p["n_ind"]

    import torch

    from .io import readers
    from .io.gsl_rng import GslTaus
    from .io.init import init_freq, init_indF_alpha
    from .io.writers import write_geno, write_ibd, write_indF
    from .models.em import EMOptions, _device, init_state, run_em
    from .ops.hwe import call_geno as call_geno_op
    from .ops.hwe import post_prob
    from .utils.signals import catch_sig

    try:
        dev = _device(p["device"])
    except RuntimeError as e:
        error("main", str(e))
    dtype = torch.float32
    catch_sig()

    # ---- sniff input format (ngsF-HMM.cpp:47-63)
    try:
        in_bin = readers.sniff_binary(p["geno"], p["n_ind"], p["n_sites"])
    except (ValueError, OSError) as e:
        error("main", str(e))
    if p["verbose"] >= 1:
        print("==> GZIP input file (not BINARY)" if not in_bin
              else "==> BINARY input file (always lkl)")
    if in_bin:
        p["lkl"] = True

    # ---- read data (ngsF-HMM.cpp:70-117)
    if p["verbose"] >= 1:
        print("==> Reading data")
        print("> Sites coordinates")
    try:
        dist_bp = readers.read_pos_dist(p["pos"], p["n_sites"])
    except ValueError as e:
        error("read_dist", str(e))
    dist = dist_bp / 1e6  # Mb (ngsF-HMM.cpp:84-86)
    if p["verbose"] >= 7:
        for s in range(min(10, p["n_sites"])):
            print(f"{dist[s]:.6f}")

    if p["verbose"] >= 1:
        print("> GENO data")
    try:
        gl = readers.read_geno(
            p["geno"], p["n_ind"], p["n_sites"], binary=in_bin,
            probs=p["lkl"], log_scale=p["loglkl"],
        )
    except ValueError as e:
        error("read_geno", str(e))
    gl_t = torch.as_tensor(gl).to(device=dev, dtype=dtype)
    if p["call_geno"]:
        gl_t = call_geno_op(gl_t)
    # always re-normalise (ngsF-HMM.cpp:116)
    gl_t = post_prob(gl_t, None)
    dist_t = torch.as_tensor(dist).to(device=dev, dtype=dtype)

    # ---- init output values (parse_args.cpp:229-419)
    if p["verbose"] >= 6:
        print("> Init output")
    rng = GslTaus(p["seed"])
    spec = p["indF"]
    if p["verbose"] >= 1:
        if spec == "r":
            print("==> Using random initial inbreeding values.")
        elif os.path.isfile(spec):
            print(f'==> Reading initial inbreeding values from file "{spec}".')
        else:
            print(f"==> Setting initial inbreeding values to: {spec}")
    try:
        indF0, alpha0 = init_indF_alpha(spec, p["n_ind"], rng)
    except ValueError as e:
        error("init_output", str(e))

    fspec = p["freq"]
    if p["verbose"] >= 1:
        if fspec == "r":
            print("==> Using random initial frequency values.")
        elif os.path.isfile(fspec):
            print(f'==> Reading initial frequency values from file "{fspec}".')
        else:
            print(f"==> Setting initial frequency values to: {fspec}")
    try:
        freq0 = init_freq(fspec, p["n_sites"], rng, freq_est=p["freq_est"])
    except ValueError as e:
        error("init_output", str(e))
    if p["verbose"] >= 1:
        print("==> Calculating initial emission probabilities")
    state = init_state(gl_t, freq0, indF0, alpha0, e_prob_calc=p["e_prob"],
                       device=dev, dtype=dtype)

    # ---- EM (EM.cpp:27-135)
    opts = EMOptions(
        freq_est=p["freq_est"],
        e_prob_calc=p["e_prob"],
        indF_fixed=p["indF_fixed"],
        alpha_fixed=p["alpha_fixed"],
        min_iters=p["min_iters"],
        max_iters=p["max_iters"],
        min_epsilon=p["min_epsilon"],
        verbose=p["verbose"],
        log_every=p["log"],
    )

    if p["verbose"] >= 5:
        print("==> Initial parameters:")
        for i in range(p["n_ind"]):
            print(f"\t{indF0[i]:.10f}\t{alpha0[i]:.6f}")
        print("".join(f"\t{f:.6f}" for f in freq0))

    def _np(t):
        return t.detach().cpu().numpy()

    def write_outputs(st, tot, path_states):
        S, N = p["n_sites"], p["n_ind"]
        if path_states is None:
            path_states = np.zeros((S, N), dtype=np.int8)
        write_indF(p["out"] + ".indF", tot, _np(st.indF), _np(st.alpha),
                   _np(st.freq))
        write_ibd(p["out"] + ".ibd", _np(st.ind_lkl), path_states,
                  _np(st.p_ibd))
        write_geno(p["out"] + ".geno", _np(gl_t).astype(np.float64),
                   _np(st.freq).astype(np.float64), path_states)

    def log_cb(n_iter, st, tot):
        if p["log"] and (n_iter == 1 or n_iter % p["log"] == 0):
            if p["verbose"] >= 1:
                print("==> Printing current iteration parameters")
            write_outputs(st, tot, None)

    def trace(event, **kw):
        v = p["verbose"]
        if v < 1:
            return
        if event == "iter_start":
            print(f"\nIteration {kw['n_iter']}:")
            print("==> Forward Recursion")
            print("==> Backward Recursion")
            print("==> Marginal probabilities")
            if p["indF_fixed"] and p["alpha_fixed"]:
                print("==> Inbreeding and transition parameter not estimated!")
            else:
                print("==> Update inbreeding and transition parameter")
            print("==> Alelle frequencies not estimated!")
        elif event == "iter_done":
            if v >= 4:
                st = kw["state"]
                for i in range(p["n_ind"]):
                    print(f"\t{float(st.indF[i]):.10f}"
                          f"\t{float(st.alpha[i]):.6f}")
            if v >= 3:
                # per-phase timer block (EM.cpp:277-284): the iteration
                # is not split into host-visible phases here, so the
                # whole step's wall time is reported on the Fw line
                print(
                    f"\nFw: {kw['dt']:.1f}\nBw: 0.0\nMP: 0.0\n"
                    "indF: 0.0\nfreqs: 0.0"
                )
            print(
                f"\tLogLkl: {kw['tot_lkl']:.15f}\t max lkl epsilon: "
                f"{kw['max_eps']:.15f}\ttime: {kw['dt']:.0f} (s)"
            )
            if v >= 3:
                for i in range(p["n_ind"]):
                    tag = " (max)" if i == kw["imax"] else ""
                    print(
                        f"\tInd {i + 1}: {kw['ind_lkl'][i]:.15f}\t "
                        f"lkl epsilon: {kw['ind_eps'][i]:.15f}{tag}"
                    )
            sys.stdout.flush()

    try:
        result = run_em(gl_t, dist_t, state, opts, log_callback=log_cb,
                        trace=trace, device=dev)
    except (RuntimeError, ValueError, NotImplementedError) as e:
        error("EM", str(e))

    if not result.converged:
        print(
            "WARN: Maximum number of iterations reached! Check if analysis "
            "converged... "
        )
    if p["verbose"] >= 1:
        print("\n==> Decoding most probable path (Viterbi)")
        print(f"Final logLkl: {result.tot_lkl:.6f}")
        print("Printing final results")
    write_outputs(result.state, result.tot_lkl, result.path)

    if p["verbose"] >= 1:
        print("Freeing memory...")
        print("Done!")
    return 0


if __name__ == "__main__":
    sys.exit(main())
