"""Command-line interface with reference flag/stdout parity.

Accepts the same 22 options as the reference binary (reference:
parse_args.cpp:43-68), with getopt_long_only semantics: options work with
one or two leading dashes and unambiguous prefixes, values via "--opt v"
or "--opt=v". Verbose levels 1-3 reproduce the reference's progress lines.

This package carries two tiers on a single device, as the JAX package's
CLI names them: the float64 scan tier (--dtype float64 --kernel scan, the
default, as in the JAX package) and the fused float32 kernels (--dtype
float32 --kernel pallas). Both estimate the allele frequencies every
iteration (--freq_est 1, the default as in the reference) or hold them
fixed (--freq_est 0), for one run or for --n_rep R lockstep restarts (the
ngsF-HMM.sh protocol; the best replicate's files are written). One run
also takes the LD path (--freq_est 2, --e_prob 2), in the corrected form
of the JAX package (a warning says so). --gl_bf16 1 (fused tier only)
stores the gl slabs in bfloat16 (auto keeps float32, as the JAX package
does for runs held in memory). The flags of tiers still to be ported
(--freq_est 2 or --e_prob other than 1 with --n_rep, --mesh,
--stream_chunk, --checkpoint, --opt compat, --kernel blocked / linear,
--dtype float32 with --kernel scan and float64 with --kernel pallas,
--profile) are parsed and refused with an error.

Example:
    python -m ngsf_hmm_tpu_torch --geno data.glf.gz --loglkl --n_ind 20 \
        --n_sites 100000 --pos data.pos.gz --freq e --out run1 \
        [--device cuda|cpu]
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
    ("dtype", True, None),  # float64 (default, scan) | float32 (pallas)
    ("device", True, None),  # cuda (default) | cpu
    ("kernel", True, None),  # scan (default) | pallas (| blocked | linear)
    ("n_rep", True, None),  # multi-restart replicates (ngsF-HMM.sh N_REP)
    ("gl_bf16", True, None),  # 0 | 1 | auto: bfloat16 gl slabs
    # The flags below belong to tiers this package does not carry yet;
    # they are parsed (same names as the JAX package's CLI) and refused
    # in main() unless left at their defaults.
    ("opt", True, None),  # speed (default) | compat
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


def _np(t):
    return t.detach().cpu().numpy()


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
        "dtype": "float64",
        "device": "cuda",
        "kernel": "scan",
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
    """Errors for invalid flags and for those of tiers still to be ported;
    each refusal names the ROADMAP item that will lift it."""
    kernel, dtype = p["kernel"], p["dtype"]
    if kernel not in ("scan", "blocked", "linear", "pallas"):
        error("main", f"invalid --kernel {kernel!r} "
                      "(scan|blocked|linear|pallas)")
    if dtype not in ("float32", "float64"):
        error("main", f"invalid --dtype {dtype!r} (float64|float32)")
    if p["gl_bf16"] not in ("0", "1", "auto"):
        error("main", f"invalid --gl_bf16 {p['gl_bf16']!r} (0|1|auto)")
    if p["gl_bf16"] == "1" and kernel != "pallas":
        error("main", "--gl_bf16 1 requires --kernel pallas (the bf16 "
                      "slabs exist only in the fused tier)")
    if kernel in ("blocked", "linear"):
        error("main", f"--kernel {kernel} is not ported yet (ROADMAP queue "
                      "1: 'models/hmm_blocked.py'); --kernel scan and "
                      "--kernel pallas are")
    import torch

    from .models.em import _refuse

    try:  # each tier's float types (models/em.TIER_DTYPES) and modes
        _refuse(freq_est=p["freq_est"], e_prob_calc=p["e_prob"],
                n_rep=max(p["n_rep"], 1),
                numerics="log" if kernel == "scan" else "pallas",
                dtype=getattr(torch, dtype))
    except (NotImplementedError, TypeError) as e:
        error("main", f"--dtype {dtype} --kernel {kernel} --freq_est "
                      f"{p['freq_est']} --e_prob {p['e_prob']} --n_rep "
                      f"{p['n_rep']} is not ported yet: {e}")
    if p["opt"] != "speed":
        error("main", "--opt compat is not ported yet (ROADMAP queue 1: "
                      "'--opt compat')")
    if p["n_rep"] < 1:
        error("main", "invalid number of replicates (--n_rep)!")
    for flag, item in (("checkpoint", "Checkpoints, for both tiers"),
                       ("mesh", "parallel/"), ("coordinator", "parallel/"),
                       ("profile", "The rest")):
        if p[flag] is not None:
            error("main", f"--{flag} is not ported yet (ROADMAP queue 1: "
                          f"'{item}')")
    if p["resume"]:
        error("main", "--resume is not ported yet (ROADMAP queue 1: "
                      "'Checkpoints, for both tiers')")
    if p["stream_chunk"] or p["stream_file"]:
        error("main", "--stream_chunk / --stream_file are not ported yet "
                      "(ROADMAP queue 1: 'Streaming')")
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
    from .models.restart import (run_em_restarts, stack_restart_states,
                                 take_replicate)
    from .ops.hwe import call_geno as call_geno_op
    from .ops.hwe import post_prob
    from .utils.signals import catch_sig

    try:
        dev = _device(p["device"])
    except RuntimeError as e:
        error("main", str(e))
    dtype = torch.float64 if p["dtype"] == "float64" else torch.float32
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
        elif fspec == "e":
            print("==> Estimating initial frequency values assuming HWE.")
        elif os.path.isfile(fspec):
            print(f'==> Reading initial frequency values from file "{fspec}".')
        else:
            print(f"==> Setting initial frequency values to: {fspec}")
    if p["freq_est"] == 2 or p["e_prob"] == 2:
        warn(
            "main",
            "the LD path (--freq_est 2 / --e_prob 2) is non-functional in "
            "the reference (NaN haplotype frequencies; gen_func.cpp:1160); "
            "running the CORRECTED two-site haplotype EM instead -- at init "
            "too (parse_args.cpp:316-321,373-386) -- results will not "
            "match the (broken) reference. See ngsf_hmm_tpu_torch/ops/"
            "haplo.py.",
        )
    # ngsF-HMM.sh multi-restart protocol: replicate r resolves its random
    # inits with GslTaus(seed + r), so the single-run init is not built;
    # replicate 0 draws what it would have drawn. The stacked states sit
    # in a box that run_em_restarts empties, so that only its flattened
    # copy stays alive.
    state, restart_box = None, []
    try:
        if p["n_rep"] > 1:
            restart_box.append(stack_restart_states(
                gl_t, p["n_rep"], p["seed"], indF_spec=spec,
                freq_spec=fspec, freq_est=p["freq_est"],
                e_prob_calc=p["e_prob"], device=dev, dtype=dtype))
            freq0 = _np(restart_box[0].freq[0])
        else:
            freq0 = init_freq(fspec, p["n_sites"], rng, gl=gl_t,
                              freq_est=p["freq_est"], device=dev)
    except ValueError as e:
        error("init_output", str(e))
    if p["n_rep"] == 1:
        # the JAX CLI prints this line only where it builds a single-run
        # init: n_rep == 1, or streamed restarts with a non-random freq
        # (ngsf_hmm_tpu/cli.py:695); the port has no streaming, so only
        # the first clause can hold
        if p["verbose"] >= 1:
            print("==> Calculating initial emission probabilities")
        state = init_state(gl_t, freq0, indF0, alpha0,
                           e_prob_calc=p["e_prob"], device=dev, dtype=dtype)

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
        numerics="log" if p["kernel"] == "scan" else "pallas",
        log_every=p["log"],
        # runs held in memory: bfloat16 gl slabs only when asked for
        # ("auto" keeps float32, as the JAX CLI does there)
        gl_bf16=p["gl_bf16"] == "1",
    )

    if p["verbose"] >= 5:
        print("==> Initial parameters:")
        for i in range(p["n_ind"]):
            print(f"\t{indF0[i]:.10f}\t{alpha0[i]:.6f}")
        print("".join(f"\t{f:.6f}" for f in freq0))

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
            if p["freq_est"] == 0:
                print("==> Alelle frequencies not estimated!")
            else:
                print(
                    "==> Estimating allele frequencies and calculating "
                    "emission probabilities"
                )
        elif event == "iter_done":
            if v >= 4:
                st = kw["state"]
                for i in range(p["n_ind"]):
                    print(f"\t{float(st.indF[i]):.10f}"
                          f"\t{float(st.alpha[i]):.6f}")
            if v >= 7 and p["freq_est"] != 0:
                # per-site freq/emission dump (EM.cpp:265-270), printed
                # once per iteration from the updated state
                st = kw["state"]
                freq = _np(st.freq).astype(np.float64)
                em = np.exp(_np(st.e_prob).astype(np.float64))
                for s in range(p["n_sites"]):
                    row = "".join(
                        f"\t{em[s, i, 0]:f}/{em[s, i, 1]:f}"
                        for i in range(p["n_ind"])
                    )
                    print(f"Site {s + 1}; freq: {freq[s]:f}; emission: {row}")
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

    def multi_trace(event, **kw):
        # lockstep analog of the single-run trace: one iteration advances
        # every replicate, so the per-iteration line reports the current
        # best replicate (verbose >= 3 adds the per-replicate table)
        v = p["verbose"]
        if v < 1:
            return
        if event == "iter_start":
            trace(event, **kw)
            return
        tots = np.asarray(kw["tot_lkl"], np.float64)
        eps = np.asarray(kw["max_eps"], np.float64)
        best = int(np.argmax(tots))
        print(f"\tLogLkl (best replicate {best + 1}): {tots[best]:.15f}"
              f"\t max lkl epsilon: {eps[best]:.15f}"
              f"\ttime: {kw['dt']:.0f} (s)")
        if v >= 3:
            active = kw["active"]
            for r in range(len(tots)):
                tag = " (best)" if r == best else ""
                if not active[r]:
                    tag += " [converged]"
                print(f"\tReplicate {r + 1}: {tots[r]:.15f}\t "
                      f"lkl epsilon: {eps[r]:.15f}{tag}")
        sys.stdout.flush()

    def multi_log_cb(n_iter, flat, tots):
        # --log N with replicates dumps the CURRENT BEST replicate's state
        # (the single-run semantics, EM.cpp:59-63, applied to the leader)
        if p["log"] and n_iter > 0 and (n_iter == 1 or n_iter % p["log"] == 0):
            best = int(np.argmax(tots))
            if p["verbose"] >= 1:
                print("==> Printing current iteration parameters "
                      f"(best replicate {best + 1})")
            write_outputs(take_replicate(flat, best), float(tots[best]), None)

    try:
        if p["n_rep"] > 1:
            rres = run_em_restarts(
                gl_t, dist_t, restart_box.pop(), opts,
                log_callback=multi_log_cb, trace=multi_trace, device=dev)
            result = rres.best
        else:
            result = run_em(gl_t, dist_t, state, opts, log_callback=log_cb,
                            trace=trace, device=dev)
    except (RuntimeError, ValueError, NotImplementedError) as e:
        error("EM", str(e))
    if p["n_rep"] > 1 and p["verbose"] >= 1:
        for r, (lk, it) in enumerate(zip(rres.rep_lkl, rres.rep_iters)):
            tag = "  <== best" if r == rres.best_rep else ""
            print(f"Replicate {r + 1}: logLkl {lk:.6f} ({it} iters){tag}")

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
