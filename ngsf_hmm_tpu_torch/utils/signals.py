"""Graceful-stop signal handling (reference: gen_func.cpp:21-52).

SIGINT/SIGTERM/SIGQUIT/SIGPIPE flip a stop flag that the EM host loop
checks at each iteration boundary (EM.cpp:56's SIG_COND gate) so the run
exits cleanly and still writes outputs; three signals force an unclean
exit (the reference's really_kill counter)."""

import signal
import sys

_stop = False
_really_kill = 3
_installed = False


def stop_requested():
    return _stop


def reset():
    global _stop, _really_kill
    _stop = False
    _really_kill = 3


def _handler(signum, frame):
    global _stop, _really_kill
    name = signal.Signals(signum).name
    if not _stop:
        sys.stderr.write(
            f'\n"{name}" signal caught! Will try to exit nicely (finishing '
            "the current EM iteration and writing outputs).\n"
        )
    _really_kill -= 1
    if _really_kill > 0:
        sys.stderr.write(
            f"\t-> If you really want to force an unclean exit Ctr+C "
            f"{_really_kill} more times\n"
        )
    sys.stderr.flush()
    if _really_kill <= 0:
        sys.exit(0)
    _stop = True


def catch_sig():
    """Install the handlers (call from the CLI, not at import)."""
    global _installed
    reset()
    for s in (signal.SIGINT, signal.SIGTERM, signal.SIGQUIT):
        signal.signal(s, _handler)
    try:
        signal.signal(signal.SIGPIPE, _handler)
    except (OSError, ValueError, AttributeError):
        pass  # not available on all platforms
    _installed = True
