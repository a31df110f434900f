"""Unified file IO + console progress bar.

The port's copy of det3d_tpu/utils/fileio.py, kept line for line (host code
in both packages, no torch), so that both give the same results.

Parity: det3d/torchie/fileio/io.py (load/dump with json/yaml/pickle handler
dispatch by extension), det3d/torchie/utils/progressbar.py (ProgressBar,
track_progress, track_iter_progress) and torchie/utils/timer.py (Timer) —
one module instead of the reference's three, same call signatures for the
surfaces the tools use.
"""

from __future__ import annotations

import json
import pickle
import sys
import time
from pathlib import Path
from shutil import get_terminal_size

try:
    import yaml
    _HAS_YAML = True
except ImportError:                                           # pragma: no cover
    _HAS_YAML = False


# ---------------------------------------------------------------------------
# load / dump
# ---------------------------------------------------------------------------

def _fmt(file, file_format):
    if isinstance(file, Path):
        file = str(file)
    if file_format is None and isinstance(file, str):
        file_format = file.split(".")[-1]
    if file_format in ("yaml", "yml") and not _HAS_YAML:
        raise TypeError("yaml not available in this environment")
    if file_format not in ("json", "yaml", "yml", "pickle", "pkl"):
        raise TypeError(f"Unsupported format: {file_format}")
    return file, file_format


def load(file, file_format=None, **kwargs):
    """Load json/yaml/pickle by extension or explicit format."""
    file, file_format = _fmt(file, file_format)
    binary = file_format in ("pickle", "pkl")
    if isinstance(file, str):
        with open(file, "rb" if binary else "r") as f:
            return _load_fh(f, file_format, **kwargs)
    return _load_fh(file, file_format, **kwargs)


def _load_fh(f, file_format, **kwargs):
    if file_format == "json":
        return json.load(f, **kwargs)
    if file_format in ("yaml", "yml"):
        kwargs.setdefault("Loader", yaml.SafeLoader)
        return yaml.load(f, **kwargs)
    return pickle.load(f, **kwargs)


def dump(obj, file=None, file_format=None, **kwargs):
    """Dump to json/yaml/pickle; returns the string when file is None."""
    if file is None:
        if file_format is None:
            raise ValueError("file_format must be given when file is None")
        _, file_format = _fmt("x." + file_format, None)
        if file_format == "json":
            return json.dumps(obj, **kwargs)
        if file_format in ("yaml", "yml"):
            return yaml.dump(obj, **kwargs)
        return pickle.dumps(obj, **kwargs)
    file, file_format = _fmt(file, file_format)
    binary = file_format in ("pickle", "pkl")
    if isinstance(file, str):
        with open(file, "wb" if binary else "w") as f:
            _dump_fh(obj, f, file_format, **kwargs)
    else:
        _dump_fh(obj, file, file_format, **kwargs)


def _dump_fh(obj, f, file_format, **kwargs):
    if file_format == "json":
        json.dump(obj, f, **kwargs)
    elif file_format in ("yaml", "yml"):
        yaml.dump(obj, f, **kwargs)
    else:
        pickle.dump(obj, f, **kwargs)


# ---------------------------------------------------------------------------
# Timer + ProgressBar
# ---------------------------------------------------------------------------

class Timer:
    """Minimal torchie Timer: since_start / since_last_check."""

    def __init__(self, start: bool = True):
        self._start = self._last = None
        if start:
            self.start()

    def start(self):
        self._start = self._last = time.perf_counter()

    def since_start(self) -> float:
        return time.perf_counter() - self._start

    def since_last_check(self) -> float:
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        return dt


class ProgressBar:
    """Console progress bar (torchie progressbar.py:8-83 behavior)."""

    def __init__(self, task_num: int = 0, bar_width: int = 50,
                 start: bool = True, file=None):
        self.task_num = task_num
        self.file = file or sys.stdout
        term_w = get_terminal_size().columns
        self.bar_width = max(min(bar_width, int(term_w * 0.6), term_w - 50),
                             10)
        self.completed = 0
        if start:
            self.start()

    def start(self):
        if self.task_num > 0:
            self.file.write(f"[{' ' * self.bar_width}] 0/{self.task_num}, "
                            "elapsed: 0s, ETA:")
        else:
            self.file.write("completed: 0, elapsed: 0s")
        self.file.flush()
        self.timer = Timer()

    def update(self):
        self.completed += 1
        elapsed = max(self.timer.since_start(), 1e-9)
        fps = self.completed / elapsed
        if self.task_num > 0:
            pct = self.completed / float(self.task_num)
            eta = int(elapsed * (1 - pct) / pct + 0.5)
            marks = int(self.bar_width * pct)
            bar = ">" * marks + " " * (self.bar_width - marks)
            self.file.write(
                f"\r[{bar}] {self.completed}/{self.task_num}, "
                f"{fps:.1f} task/s, elapsed: {int(elapsed)}s, ETA: {eta:5}s")
            if self.completed == self.task_num:
                self.file.write("\n")
        else:
            self.file.write(
                f"\rcompleted: {self.completed}, elapsed: {int(elapsed)}s, "
                f"{fps:.1f} tasks/s")
        self.file.flush()


def track_progress(func, tasks, bar_width: int = 50, **kwargs):
    """Apply func to each task with a progress bar (progressbar.py:86-118)."""
    if isinstance(tasks, tuple) and len(tasks) == 2:
        tasks, task_num = tasks[0], tasks[1]
    else:
        task_num = len(tasks)
    bar = ProgressBar(task_num, bar_width)
    results = []
    for task in tasks:
        results.append(func(task, **kwargs))
        bar.update()
    return results


def track_iter_progress(tasks, bar_width: int = 50):
    """Yield tasks while drawing a progress bar (progressbar.py:152-186)."""
    if isinstance(tasks, tuple) and len(tasks) == 2:
        tasks, task_num = tasks[0], tasks[1]
    else:
        task_num = len(tasks)
    bar = ProgressBar(task_num, bar_width)
    for task in tasks:
        yield task
        bar.update()
