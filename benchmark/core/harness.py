"""The harness: one cell of BENCHMARK.json, found by name, run once.

Everything a cell needs is found by name: ``configs`` entries name their
file (a JSON dict with the model, voxelizer, assigner, test and optimizer
sections, and ``reference``, the module of benchmark/reference/ that
computes it plainly); a workload's ``traffic`` is benchmark/traffic/
<name>.json, read by core/traffic.py; a per-layer metric is
benchmark/metrics/<name>.py (``read(ctx) -> number or None``); the limits
of the numbers compared are benchmark/limits/<workload>.json. The mix's
``mode`` picks the runner: core/serve.py or core/train.py.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

BANNED = ("jax", "jaxlib", "flax", "optax", "det3d_tpu")
PROGRAM = "det3d_tpu_torch"
HERE = Path(__file__).resolve().parent.parent          # benchmark/


class Failure(Exception):
    """A run that cannot give a result: exit code 2, nothing on stdout."""


def banned_modules(names=None) -> List[str]:
    """The banned top-level names among the loaded modules' (or
    ``names``'): the part before the first dot, compared whole."""
    tops = {m.split(".", 1)[0] for m in list(
        sys.modules if names is None else names)}
    return sorted(tops & set(BANNED))


def set_environment(root: Path):
    """Caches inside the checkout at fixed paths; no JAX from libraries."""
    cache = root / "benchmark" / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise Failure(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A workload of the manifest with its configuration, mix, metrics
    and limits, all found by name under ``root``."""

    def __init__(self, root: Path, name: str, trace: bool):
        mpath = root / "BENCHMARK.json"
        if not mpath.exists():
            raise Failure(f"no {mpath}")
        self.manifest = json.loads(mpath.read_text())
        cells = {w["name"]: w for w in self.manifest["workloads"]}
        if name not in cells:
            raise Failure(f"no workload {name!r} in BENCHMARK.json")
        self.workload = cells[name]
        self.name = name
        confs = {c["name"]: c for c in self.manifest["configs"]}
        centry = confs[self.workload["config"]]
        self.cfg = json.loads((root / centry["file"]).read_text())
        bench = root / "benchmark"
        self.mix = json.loads((bench / "traffic" /
                               f"{self.workload['traffic']}.json")
                              .read_text())
        from benchmark.core import traffic
        try:
            traffic.check(self.mix)
        except ValueError as e:
            raise Failure(f"traffic {self.workload['traffic']}: {e}")
        lim = bench / "limits" / f"{name}.json"
        self.limits = json.loads(lim.read_text()) if lim.exists() else {}
        self.reference = importlib.import_module(
            f"benchmark.reference.{self.cfg['reference']}")
        self.chips = int(self.workload.get("chips", 1))
        key = "per_layer" if trace else "end_to_end"
        self.metrics = [m for m in self.manifest[key]
                        if name in m.get("workloads", [name])]
        self.readers = {}
        if trace:
            for m in self.metrics:
                self.readers[m["name"]] = load_module(
                    bench / "metrics" / f"{m['name']}.py",
                    "bench_metric_" + m["name"].replace(".", "_"))


def parse(argv):
    ap = argparse.ArgumentParser(description="Run one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def device_info(torch, device) -> Dict:
    if device.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device),
                "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                    device))}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def judge(cell: Cell, numbers: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}) over the numbers the cell's
    limits file names: every one at or under its limit (one the run did
    not read fails, and so does a cell with no limits). The numbers it
    does not name are printed as readings."""
    for k, v in numbers.items():
        if k not in cell.limits:
            print(f"reading {k} {v!r}", file=sys.stderr)
    out, ok = {}, bool(cell.limits)
    for k, spec in cell.limits.items():
        v = numbers.get(k)
        out[k] = {"value": v, "limit": spec["limit"]}
        if v is None or not (v <= spec["limit"]):
            ok = False
    return ok, out


def main(argv, t0: Optional[float] = None, root: Optional[Path] = None,
         require_cuda: bool = True) -> int:
    """Run a cell and print its result line; the exit code. With
    ``require_cuda=False`` (the tests' rehearsal on the CPU) the run
    takes the CPU and its device numbers say so."""
    t0 = time.perf_counter() if t0 is None else t0
    root = Path(root) if root is not None else HERE.parent
    args = parse(argv)
    set_environment(root)
    try:
        cell = Cell(root, args.workload, bool(args.trace))
        import torch
        if require_cuda:
            if not torch.cuda.is_available():
                raise Failure("torch.cuda.is_available() is false: the "
                              "benchmark runs only on the card")
            if torch.cuda.device_count() < cell.chips:
                raise Failure(f"{torch.cuda.device_count()} cards, the cell "
                              f"asks for {cell.chips}")
            device = torch.device("cuda", 0)
            torch.cuda.set_device(device)
        else:
            device = torch.device("cpu")
        # one process, one intra-op thread: the host's share of a request
        # (staging the batch, launching the graph) jitters less
        torch.set_num_threads(1)
        torch.backends.cuda.matmul.allow_tf32 = bool(cell.cfg.get("tf32",
                                                                  False))
        torch.backends.cudnn.allow_tf32 = bool(cell.cfg.get("tf32", False))
        try:
            importlib.import_module(PROGRAM)
        except ImportError as e:
            raise Failure(f"the program {PROGRAM} is not here: {e}")
        from benchmark.core import common, serve, train
        if device.type == "cuda":
            common.load_kernels(PROGRAM)
        cell.t0 = t0
        common.progress(cell, "torch, the program and its kernels loaded")
        runner = serve if cell.mix["mode"] == "serve" else train
        res = runner.run(cell, args, device, t0)
    except Failure as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    found = banned_modules()
    if found:
        print(f"benchmark: banned modules loaded: {found}", file=sys.stderr)
        return 3
    correct, compared = judge(cell, res.pop("numbers"))
    for k, v in compared.items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    line = {"correct": correct, "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": res["device"]}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["compared"] = compared
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
