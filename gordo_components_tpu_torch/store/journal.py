"""Build journal: a write-ahead log that makes fleet builds resumable (the
port's copy of ``gordo_components_tpu/store/journal.py:1-115``).

One JSON object per line, fsync'd per append::

    {"machine": "m-1", "event": "started",   "cache_key": "…", "t": "…"}
    {"machine": "m-1", "event": "committed", "model_dir": "…", "t": "…"}

:func:`replay` folds the log to each machine's LAST event. A torn final
line (the append a crash interrupted) is ignored. Several processes write
``build_journal.jsonl`` and ``.p<i>`` siblings; :func:`replay` unions
them.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import time
from typing import Any, Dict

logger = logging.getLogger(__name__)

JOURNAL_FILE = "build_journal.jsonl"

EVENT_STARTED = "started"
EVENT_COMMITTED = "committed"
EVENT_FAILED = "failed"


def journal_path(output_dir: str, process_index: int = 0) -> str:
    """This process's journal file (process i > 0 writes ``.p<i>``)."""
    path = os.path.join(output_dir, JOURNAL_FILE)
    return path if process_index == 0 else f"{path}.p{process_index}"


class BuildJournal:
    """Append-only, fsync-per-record writer of one process's journal."""

    def __init__(self, path: str):
        self.path = path

    def record(self, machine: str, event: str, **fields: Any) -> None:
        payload = {"machine": machine, "event": event,
                   "t": time.strftime("%Y-%m-%d %H:%M:%S%z"), **fields}
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        with open(self.path, "a") as fh:
            fh.write(json.dumps(payload, sort_keys=True) + "\n")
            fh.flush()
            os.fsync(fh.fileno())


def replay(output_dir_or_path: str) -> Dict[str, Dict[str, Any]]:
    """``{machine: last record}`` over the journal and its siblings. An
    unreadable file or a torn line means less resume, never an error."""
    path = output_dir_or_path
    if os.path.isdir(path):
        path = os.path.join(path, JOURNAL_FILE)
    states: Dict[str, Dict[str, Any]] = {}
    for journal_file in [path] + sorted(glob.glob(path + ".p*")):
        if not os.path.isfile(journal_file):
            continue
        try:
            with open(journal_file) as fh:
                lines = fh.readlines()
        except OSError as exc:
            logger.warning("Build journal %s unreadable: %s", journal_file, exc)
            continue
        for i, line in enumerate(lines):
            line = line.strip()
            if not line:
                continue
            try:
                record = json.loads(line)
            except ValueError:
                if i == len(lines) - 1:
                    logger.info("Build journal %s: torn final line ignored", journal_file)
                else:
                    logger.warning("Build journal %s: unparseable line %d ignored",
                                   journal_file, i + 1)
                continue
            machine = record.get("machine")
            if isinstance(machine, str) and isinstance(record.get("event"), str):
                states[machine] = record
    return states


def summarize(states: Dict[str, Dict[str, Any]]) -> Dict[str, int]:
    counts = {EVENT_STARTED: 0, EVENT_COMMITTED: 0, EVENT_FAILED: 0}
    for record in states.values():
        event = record.get("event")
        if event in counts:
            counts[event] += 1
    return counts
