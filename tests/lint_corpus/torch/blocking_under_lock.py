"""Seeded-bad corpus, the port's spelling of ../blocking_under_lock.py:
blocking calls under a HOT lock (a bucket's program lock), direct and
one level down, plus an escape hatch with an empty reason (itself a
finding) and a valid escape hatch (suppressed). Scanned under the
pretend path gordo_components_tpu_torch/server/engine.py, where
``_template_lock`` is engine.template. Parsed, never imported."""

import subprocess
import threading
import time

import numpy as np
import torch

from ..ops import _kernels
from ..utils import http


class BadBucket:
    def __init__(self):
        self._template_lock = threading.Lock()
        self._collector = None
        self._session = http.Session()

    def fetch_under_lock(self, outputs):
        with self._template_lock:
            torch.cuda.synchronize()  # BAD: waits for the device under a hot lock
            return outputs

    def event_under_lock(self, done):
        with self._template_lock:
            done.synchronize()  # BAD: an Event's wait under a hot lock

    def item_under_lock(self, t):
        with self._template_lock:
            return t.item()  # BAD: a tensor read on the host under a hot lock

    def resolve_under_lock(self, names):
        with self._template_lock:
            return _kernels.resolve(names)  # BAD: a library's build or load

    def nvcc_under_lock(self, source):
        with self._template_lock:
            subprocess.run(["nvcc", "-c", source])  # BAD: an nvcc compile

    def sleep_under_lock(self):
        with self._template_lock:
            time.sleep(0.1)  # BAD: sleep under a hot lock

    def join_via_helper(self):
        with self._template_lock:
            self._stop_collector()  # BAD: hides a join one level down

    def _stop_collector(self):
        if self._collector is not None:
            self._collector.join()

    def http_as_context_manager(self, url):
        # blocking call spelled as a with-item: evaluates under the
        # hot lock acquired by the first item
        with self._template_lock, self._session.post(url) as response:  # BAD
            return response

    def pool_under_lock(self, url):
        with self._template_lock:
            return http.get(url)  # BAD: the port's HTTP pool under a hot lock

    def numpy_is_not_a_device(self, array):
        with self._template_lock:
            return np.asarray(array).tolist()  # GOOD: a host array

    def empty_reason(self):
        with self._template_lock:
            torch.cuda.synchronize()  # lint: allow-blocking()

    def good_reason(self):
        with self._template_lock:
            torch.cuda.synchronize()  # lint: allow-blocking(corpus: deliberate, reason given)
