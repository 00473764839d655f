"""Background output writer.

The reference overlaps ECL/VTK output with computation by handing write
jobs to a dedicated thread (ThreadHandle,
opm/simulators/ThreadHandle.hpp:37-220: worker thread + mutex-protected
object queue, used by BlackoilOutputWriter's asyncOutput_). Same capability
here: a daemon worker draining a queue of (fn, args) closures; ``sync()``
blocks until everything queued so far is on disk.

The worker gets host data only: ``submit`` refuses a torch tensor among the
arguments, so the thread never touches a CUDA tensor or a stream. A failed
write is raised at ``sync()`` and again at ``close()``; no error is dropped.
"""

from __future__ import annotations

import queue
import threading
import traceback

import torch


def _check_host(value, where):
    if isinstance(value, torch.Tensor):
        raise TypeError(f"ThreadHandle.submit: {where} is a torch tensor; "
                        "pull it to numpy before queueing the write")
    if isinstance(value, dict):
        for k, v in value.items():
            _check_host(v, f"{where}[{k!r}]")
    elif isinstance(value, (list, tuple)):
        for i, v in enumerate(value):
            _check_host(v, f"{where}[{i}]")


class ThreadHandle:
    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self._errors: list = []
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        self._closed = False

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            fn, args, kwargs = item
            try:
                fn(*args, **kwargs)
            except Exception:  # raised at sync()/close()
                self._errors.append(traceback.format_exc())
            finally:
                self._q.task_done()

    def submit(self, fn, *args, **kwargs):
        """Queue a write job on host (numpy) data."""
        if self._closed:
            raise RuntimeError("ThreadHandle.submit after close()")
        _check_host(args, "an argument")
        _check_host(kwargs, "a keyword argument")
        self._q.put((fn, args, kwargs))

    def sync(self):
        """Block until all queued jobs finished; raise the worker's
        errors."""
        self._q.join()
        if self._errors:
            errs, self._errors = self._errors, []
            raise RuntimeError("async output failed:\n" + "\n".join(errs))

    def close(self):
        """Finish the queued jobs, stop the worker, then raise any write
        error."""
        if self._closed:
            return
        self._closed = True
        self._q.join()
        self._q.put(None)
        self._worker.join()
        self.sync()
