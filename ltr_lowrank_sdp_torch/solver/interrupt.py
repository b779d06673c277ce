"""Graceful SIGINT handling for long solves.

Mirrors the reference's Ctrl-C behavior (``lorads_utils.c:488-505``): the
first SIGINT sets a flag that the host-side phase loops poll at their chunk
boundaries; the solve then stops early and returns the best iterate with
metrics/status computed normally.  A second SIGINT falls through to Python's
default KeyboardInterrupt (hard abort).

The handler is only installed by entry points (``cli.py``); library callers
are never surprised by a hijacked signal disposition.
"""

from __future__ import annotations

import signal

_state = {"installed": False, "hit": False}


def interrupted() -> bool:
    """True once SIGINT has been received (and the handler is installed)."""
    return _state["hit"]


def clear() -> None:
    _state["hit"] = False


def install_sigint_handler() -> None:
    """Install the graceful handler (idempotent). First Ctrl-C requests a
    clean stop; the second restores the default handler, so a stuck solve
    can still be killed interactively."""
    if _state["installed"]:
        return

    def _handler(signum, frame):
        _state["hit"] = True
        print("\n*Receive Ctrl-C: stopping after the current segment "
              "(press again to abort)*", flush=True)
        signal.signal(signal.SIGINT, signal.default_int_handler)

    signal.signal(signal.SIGINT, _handler)
    _state["installed"] = True
