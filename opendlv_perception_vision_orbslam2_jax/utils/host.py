"""Host<->device transfer helpers for the asynchronous scheduler."""

from __future__ import annotations

import threading
from concurrent.futures import Future


def bg_fetch(fn, *args, ready=None) -> Future:
    """Run a blocking device->host fetch on a DAEMON thread; returns a
    Future.

    ``ready``: optional no-arg callable (e.g. ``some_array.is_ready``);
    the worker POLLS it before calling ``fn``, sleeping GIL-free until the
    value exists, so that the eventual fetch only covers the transfer
    itself and never blocks inside the runtime while the main thread
    dispatches.

    Why not ThreadPoolExecutor: its workers are non-daemon and joined at
    interpreter exit — a fetch still in flight when the process ends then
    joins against a torn-down device runtime (an abort in the XLA client
    destructor).  Daemon threads die with the process instead; the
    consumers only ever read futures that are ``done()``, and
    ``StereoSlam.finish()`` drains every in-flight fetch while the runtime
    is alive."""
    import time

    import jax

    fut: Future = Future()

    if jax.default_backend() == "cpu":
        # The XLA:CPU runtime ABORTS under a concurrent device_get
        # (worker thread) + dispatch (main thread) — observed as fatal
        # SIGABRT/SIGSEGV deep in test suites.  There is no device latency
        # to hide on the CPU, so fetch synchronously: deterministic and
        # crash-free.
        try:
            fut.set_result(fn(*args))
        except BaseException as e:
            fut.set_exception(e)
        return fut

    def run():
        try:
            if ready is not None:
                while not ready():
                    time.sleep(0.002)
            fut.set_result(fn(*args))
        except BaseException as e:  # surfaced at .result()
            fut.set_exception(e)

    threading.Thread(target=run, daemon=True, name="bg-fetch").start()
    return fut


def prefetch_to_host(*arrays):
    """Start asynchronous device->host copies.

    A copy started at dispatch time makes the later ``np.asarray`` a local
    read instead of a blocking device round trip.  Best-effort: backends
    without the API just pay the round trip at read time."""
    for a in arrays:
        try:
            a.copy_to_host_async()
        except Exception:
            pass
