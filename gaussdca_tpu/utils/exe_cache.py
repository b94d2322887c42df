"""In-process compiled-executable cache keyed by shape class.

Batch mode (SURVEY.md section 7): in 100+-family batches every new
shape class pays its compile (or its load from the persistent XLA
cache) at dispatch. jit's own in-memory dispatch cache hides repeats
WITHIN a class, but the first family of each class pays while the
device sits idle after the previous family. This cache

- compiles ahead of time (``jit.lower(...).compile()``) on a background
  thread while the previous family computes (XLA compilation releases
  the GIL), and
- hands back the AOT executable to be CALLED directly, so the
  dispatch-time compile never happens for a warmed class.

Opt-in from the CLI via ``--warm-compile``; its gain on the card is not
yet measured (ROADMAP.md). Correctness does not depend on it: the
executable is the same program jit would have dispatched, and tests
assert identical outputs with the cache on and off.
"""

from __future__ import annotations

import concurrent.futures
import threading


class ExecutableCache:
    """Map a hashable shape-class key to a compiled executable.

    ``warm(key, thunk)`` schedules ``thunk()`` (which must return the
    compiled executable) on a single background thread if the key is
    new; ``get(key, thunk)`` returns the cached/in-flight executable,
    compiling inline in the caller's thread on a miss. A thunk that
    raises poisons only its own entry, and the entry is dropped so a
    later ``get`` can retry (a transient runtime error during warming
    must not wedge the class forever).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: dict = {}
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="gdca-warm")

    def warm(self, key, compile_thunk) -> None:
        with self._lock:
            if key in self._entries:
                return
            fut: concurrent.futures.Future = concurrent.futures.Future()
            self._entries[key] = fut
        self._pool.submit(self._fill, key, fut, compile_thunk)

    def _fill(self, key, fut, compile_thunk) -> None:
        try:
            fut.set_result(compile_thunk())
        except BaseException as e:  # noqa: BLE001 — recorded in the future
            with self._lock:
                self._entries.pop(key, None)
            fut.set_exception(e)

    def get(self, key, compile_thunk):
        with self._lock:
            fut = self._entries.get(key)
            mine = fut is None
            if mine:
                fut = concurrent.futures.Future()
                self._entries[key] = fut
        if mine:
            self._fill(key, fut, compile_thunk)
        return fut.result()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def shutdown(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)
