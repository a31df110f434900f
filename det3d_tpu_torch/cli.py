"""Command-line entry points: train, test, create_data and flops.

Port of det3d_tpu/cli.py (its ``det3d-tpu-*`` console scripts). Parity:
reference setup.py + tools/train.py:56-147, tools/test.py,
tools/create_data.py; ``flops`` is the counterpart of tools/get_flops.py
and tools/mfu.py. Installed as the console scripts
``det3d-tpu-torch-train``, ``det3d-tpu-torch-test``,
``det3d-tpu-torch-create-data`` and ``det3d-tpu-torch-flops``, and run
from a checkout as

    python -m det3d_tpu_torch.cli train CONFIG [--work_dir DIR] ...
    python -m det3d_tpu_torch.cli test CONFIG WORK_DIR [--split val] ...
    python -m det3d_tpu_torch.cli create_data nuscenes_data_prep \\
        --root_path ROOT [--version v1.0-trainval] [--nsweeps 10]
    python -m det3d_tpu_torch.cli flops CONFIG [--batch 1] [--points 20000]
        [--train] [--time] [--device cuda|cpu]

``flops`` counts one predict step (and with ``--train`` one train step)
of the config's model at random weights on structured scans
(utils/flops.py): GFLOPs, GB and parameters by stage, and the GFLOPs
inside the port's own kernels; ``--time`` (on the card) times the
captured steps with CUDA events and prints their share of the card's
peak and of its HBM rate (TF32 off, as the fp32 peak assumes).

``train`` and ``test`` take ``--device``: ``cuda`` (the default) runs on
the card and raises where there is none; ``--device cpu`` runs on the CPU.
The JAX package's mains call ``utils/env.py::setup_jax_from_env``, which
picks a JAX platform from the environment; the explicit device does that
job here. ``create_data`` runs on the host alone and takes no device.

``train`` and ``test`` run as ranks when launched once a rank with
``--coordinator HOST:PORT --num_processes W --process_id R`` (the three
together; rank 0 listens on the port), as the JAX package's mains do:
``parallel/dist_utils.py::initialize_distributed`` over NCCL with the
default ``--device cuda`` (one card a rank), over gloo with ``--device
cpu``. ``train`` is then the global step over the ranks' batches, and
``test`` shards the split and gathers the detections (apis/train.py).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

from det3d_tpu_torch.apis.train import (_device, build_stack, eval_detector,
                                        example_width, init_state,
                                        train_detector)
from det3d_tpu_torch.parallel import dist_utils


def _add_device(parser):
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")


def _add_ranks(parser):
    parser.add_argument("--coordinator", default=None,
                        help="HOST:PORT of rank 0, for a run over ranks")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)


def _join_ranks(parser, args):
    """Join the run's ranks when the flags name them (all three or none),
    over the backend of ``--device``: NCCL on the card, gloo on the CPU."""
    flags = (args.coordinator, args.num_processes, args.process_id)
    if any(f is not None for f in flags) and None in flags:
        parser.error("--coordinator, --num_processes and --process_id go "
                     "together")
    dist_utils.initialize_distributed(
        args.coordinator, args.num_processes, args.process_id,
        backend="gloo" if args.device == "cpu" else "nccl")


def _leave_ranks():
    if dist_utils.active():
        torch.distributed.destroy_process_group()


def _load_config(path):
    """The config file as a dict of its globals, and its text under
    ``_text`` (the checkpoints' metadata keep it)."""
    from det3d_tpu_torch.utils.config import Config
    cfg = Config.fromfile(path)
    out = {k: cfg[k] for k in cfg.keys()}
    out["_text"] = Path(path).read_text()
    return out


def train_main(argv=None):
    parser = argparse.ArgumentParser(description="Train a detector")
    parser.add_argument("config", help="config file path")
    parser.add_argument("--work_dir", default=None)
    parser.add_argument("--resume_from", default=None)
    parser.add_argument("--seed", type=int, default=0)
    _add_ranks(parser)
    _add_device(parser)
    args = parser.parse_args(argv)
    _device(args.device)
    _join_ranks(parser, args)
    try:
        cfg = _load_config(args.config)
        work_dir = args.work_dir or f"work_dirs/{Path(args.config).stem}"
        trainer = train_detector(cfg, work_dir=work_dir,
                                 resume_from=args.resume_from,
                                 seed=args.seed, device=args.device)
    finally:
        _leave_ranks()
    print(f"trained to epoch {trainer.epoch}, iter {trainer.iter}; "
          f"checkpoints in {Path(work_dir) / 'ckpt'}")
    return 0


def test_main(argv=None):
    parser = argparse.ArgumentParser(description="Evaluate a detector")
    parser.add_argument("config")
    parser.add_argument("checkpoint", help="work_dir containing ckpt/")
    parser.add_argument("--work_dir", default=None)
    parser.add_argument("--split", default="val")
    parser.add_argument("--epoch", type=int, default=None)
    _add_ranks(parser)
    _add_device(parser)
    args = parser.parse_args(argv)
    _device(args.device)
    from det3d_tpu_torch.runtime.checkpoint import CheckpointManager

    _join_ranks(parser, args)
    try:
        cfg = _load_config(args.config)
        # the state is built as wide as an example of the split, then the
        # checkpoint written into it
        device = dist_utils.rank_device(args.device)
        model = build_stack(cfg, device, point_width=example_width(
            cfg["data"][args.split]))[0]
        state, _ = init_state(cfg, model, total_steps=1)
        mgr = CheckpointManager(str(Path(args.checkpoint) / "ckpt"))
        state, epoch = mgr.restore(state, epoch=args.epoch)
        print(f"restored checkpoint @ epoch {epoch}")

        results, _ = eval_detector(cfg, state,
                                   work_dir=args.work_dir or args.checkpoint,
                                   split=args.split, device=args.device)
    finally:
        _leave_ranks()
    for text in results["results"].values():
        print(text)
    return 0


def _kitti_data_prep(root_path):
    from det3d_tpu_torch.datasets.kitti.kitti_common import (
        create_kitti_info_file, create_reduced_point_cloud)
    from det3d_tpu_torch.datasets.utils.create_gt_database import (
        create_groundtruth_database)
    create_kitti_info_file(root_path)
    for split in ("train", "val", "test"):
        info = Path(root_path) / f"kitti_infos_{split}.pkl"
        if info.exists():
            create_reduced_point_cloud(root_path, str(info))
    create_groundtruth_database(
        "KittiDataset", root_path,
        str(Path(root_path) / "kitti_infos_train.pkl"))


def _nuscenes_data_prep(root_path, version="v1.0-trainval", nsweeps=10):
    from det3d_tpu_torch.datasets.nuscenes.nusc_common import (
        create_nuscenes_infos)
    from det3d_tpu_torch.datasets.utils.create_gt_database import (
        create_groundtruth_database)
    create_nuscenes_infos(root_path, version=version, nsweeps=nsweeps)
    if "test" not in version:
        create_groundtruth_database(
            "NuScenesDataset", root_path,
            str(Path(root_path)
                / f"infos_train_{nsweeps:02d}sweeps_withvelo.pkl"),
            dbinfo_path=str(Path(root_path)
                            / f"dbinfos_train_{nsweeps:02d}sweeps.pkl"),
            nsweeps=nsweeps)


def _lyft_data_prep(root_path, version="v1.0-trainval", nsweeps=10):
    from det3d_tpu_torch.datasets.lyft.lyft import create_lyft_infos
    create_lyft_infos(root_path, version=version, nsweeps=nsweeps)


def create_data_main(argv=None):
    parser = argparse.ArgumentParser(description="Dataset preparation")
    sub = parser.add_subparsers(dest="cmd", required=True)

    k = sub.add_parser("kitti_data_prep")
    k.add_argument("--root_path", required=True)

    n = sub.add_parser("nuscenes_data_prep")
    n.add_argument("--root_path", required=True)
    n.add_argument("--version", default="v1.0-trainval")
    n.add_argument("--nsweeps", type=int, default=10)

    ly = sub.add_parser("lyft_data_prep")
    ly.add_argument("--root_path", required=True)
    ly.add_argument("--version", default="v1.0-trainval")
    ly.add_argument("--nsweeps", type=int, default=10)

    args = parser.parse_args(argv)
    if args.cmd == "kitti_data_prep":
        _kitti_data_prep(args.root_path)
    elif args.cmd == "nuscenes_data_prep":
        _nuscenes_data_prep(args.root_path, args.version, args.nsweeps)
    elif args.cmd == "lyft_data_prep":
        _lyft_data_prep(args.root_path, args.version, args.nsweeps)
    return 0


def _train_batch(cfg, batch, points, seed):
    """Structured scans with seeded ground-truth boxes (the first class)
    for one train step."""
    import numpy as np

    from det3d_tpu_torch.utils.synth import structured_batch
    pc = cfg["voxel_generator"]["range"]
    data = structured_batch(batch, points, pc, seed=seed)
    rng = np.random.RandomState(seed)
    gt = np.zeros((batch, 16, 7), np.float32)
    gt[:, :6, 0] = rng.uniform(pc[0] + 3, pc[3] - 3, (batch, 6))
    gt[:, :6, 1] = rng.uniform(pc[1] + 3, pc[4] - 3, (batch, 6))
    gt[:, :6, 2:6] = [-1.0, 1.6, 3.9, 1.56]
    gt[:, :6, 6] = rng.uniform(-np.pi, np.pi, (batch, 6))
    valid = np.zeros((batch, 16), bool)
    valid[:, :6] = True
    return dict(data, gt_boxes=gt, gt_classes=valid.astype(np.int32),
                gt_valid=valid)


def _card():
    """The card's name and power limit as nvidia-smi gives them."""
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return f"{torch.cuda.get_device_name(0)}, power limit not read"


def _step_ms(step, batch, warmup=3, repeat=10):
    """Median ms of ``step(batch)`` with CUDA events, after warm-ups."""
    import statistics
    for _ in range(warmup):
        step(batch)
    times = []
    for _ in range(repeat):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(batch)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def flops_main(argv=None):
    """Count (and with ``--time`` time) the config's predict step and, with
    ``--train``, its train step; print by stage."""
    from det3d_tpu_torch.models.builder import init_weights
    from det3d_tpu_torch.parallel.predict import make_predict_step
    from det3d_tpu_torch.parallel.train import make_train_step
    from det3d_tpu_torch.utils import flops
    from det3d_tpu_torch.utils.synth import structured_batch

    parser = argparse.ArgumentParser(description="FLOPs, bytes and share "
                                     "of peak of a config's steps")
    parser.add_argument("config")
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--points", type=int, default=20000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--train", action="store_true",
                        help="also count one train step")
    parser.add_argument("--time", action="store_true",
                        help="time the captured steps (the card only)")
    _add_device(parser)
    args = parser.parse_args(argv)
    dev = _device(args.device)
    if args.time and dev.type != "cuda":
        parser.error("--time measures the card: run with --device cuda")
    # fp32 runs at the fp32 peak the shares divide by: TF32 off
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _load_config(args.config)
    model, vg, asg, cids, test_cfg = build_stack(cfg, dev)
    init_weights(model, torch.Generator().manual_seed(args.seed))
    pc = cfg["voxel_generator"]["range"]
    batch = {k: torch.as_tensor(v, device=dev) for k, v in structured_batch(
        args.batch, args.points, pc, seed=args.seed).items()}
    step = make_predict_step(model, vg, asg, cids, test_cfg)
    counter = flops.count_step(lambda: step.eager(batch), model)
    params = flops.stage_params(model)
    where = (f"{dev.type} ({_card()})" if dev.type == "cuda" else "cpu")
    print(f"config:  {args.config}")
    print(f"input:   batch={args.batch} points={args.points}, random "
          f"weights (seed {args.seed}), on {where}")
    print(f"params:  {sum(params.values()) / 1e6:.3f} M")
    print(f"{'stage':<11} {'GFLOPs':>11} {'%':>6} {'GB':>9} "
          f"{'params (M)':>11} {'kernel GFLOPs':>14}")
    tot = counter.totals()
    for name, st in counter.stages.items():
        print(f"{name:<11} {st['flops'] / 1e9:>11.4f} "
              f"{100 * st['flops'] / max(tot['flops'], 1.0):>5.1f}% "
              f"{st['bytes'] / 1e9:>9.4f} "
              f"{params.get(name, 0) / 1e6:>11.3f} "
              f"{st['kernel_flops'] / 1e9:>14.4f}")
    print(f"{'predict':<11} {tot['flops'] / 1e9:>11.4f} {100.0:>5.1f}% "
          f"{tot['bytes'] / 1e9:>9.4f} {sum(params.values()) / 1e6:>11.3f} "
          f"{tot['kernel_flops'] / 1e9:>14.4f}")
    if args.time:
        ms = _step_ms(step, batch)
        peak, hbm = flops.share(counter, ms)
        print(f"predict captured: {ms:.3f} ms/step, {ms / args.batch:.3f} "
              f"ms/scan; {peak:.4f} of peak, {hbm:.4f} of HBM "
              f"[{_card()}]")
    if args.train:
        state, _ = init_state(cfg, model, total_steps=100)
        train = make_train_step(state, vg, asg, cids)
        tb = {k: torch.as_tensor(v, device=dev) for k, v in _train_batch(
            cfg, args.batch, args.points, args.seed).items()}
        tc = flops.count_step(lambda: train.eager(tb))
        t = tc.totals()
        print(f"{'train':<11} {t['flops'] / 1e9:>11.4f} {'':>6} "
              f"{t['bytes'] / 1e9:>9.4f} {sum(params.values()) / 1e6:>11.3f}"
              f" {t['kernel_flops'] / 1e9:>14.4f}")
        if args.time:
            ms = _step_ms(train, tb)
            peak, hbm = flops.share(tc, ms)
            print(f"train captured: {ms:.3f} ms/step; {peak:.4f} of peak, "
                  f"{hbm:.4f} of HBM [{_card()}]")
    return 0


MAINS = {"train": train_main, "test": test_main,
         "create_data": create_data_main, "flops": flops_main}


def main(argv=None):
    """``python -m det3d_tpu_torch.cli {train,test,create_data,flops}
    ...``."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in MAINS:
        print(f"usage: python -m det3d_tpu_torch.cli "
              f"{{{','.join(MAINS)}}} ...", file=sys.stderr)
        return 2
    return MAINS[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
