"""What the server and the fleet's router share around their HTTP front
ends: quiet client disconnects and the wait for SIGTERM / SIGINT.
Standard library only: the router imports it and no torch."""

from __future__ import annotations

import signal
import sys
import time
from typing import Callable, Optional


class QuietDisconnects:
    """A client dropping its keep-alive connection is normal, not a server
    error: no traceback for exactly that (mixed into the HTTP servers)."""

    def handle_error(self, request, client_address):
        if isinstance(sys.exc_info()[1], (ConnectionResetError, BrokenPipeError, TimeoutError)):
            return
        super().handle_error(request, client_address)


def wait_for_signal(done: Optional[Callable[[], Optional[int]]] = None,
                    poll_s: float = 0.2) -> Optional[int]:
    """Block the main thread until SIGTERM or SIGINT (returns None) or
    until `done()`, polled every `poll_s`, returns a value (returned).
    The handlers are restored on the way out, so a second signal acts as
    usual. The handler only appends to a list: it runs on the main
    thread between two bytecodes, and a `threading.Event.set()` there
    deadlocks when the main thread holds the Event's lock in its own
    `wait()`."""
    got, prev = [], {}

    def on_signal(signum, frame):
        got.append(signum)

    for s in (signal.SIGTERM, signal.SIGINT):
        prev[s] = signal.signal(s, on_signal)
    try:
        while not got:
            time.sleep(poll_s)
            rc = done() if done is not None else None
            if rc is not None:
                return rc
        return None
    finally:
        for s, h in prev.items():
            signal.signal(s, h)
