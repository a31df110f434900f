"""Command-line entry points: train, test and create_data.

Port of det3d_tpu/cli.py (its ``det3d-tpu-*`` console scripts). Parity:
reference setup.py + tools/train.py:56-147, tools/test.py,
tools/create_data.py. Installed as the console scripts
``det3d-tpu-torch-train``, ``det3d-tpu-torch-test`` and
``det3d-tpu-torch-create-data``, and run from a checkout as

    python -m det3d_tpu_torch.cli train CONFIG [--work_dir DIR] ...
    python -m det3d_tpu_torch.cli test CONFIG WORK_DIR [--split val] ...
    python -m det3d_tpu_torch.cli create_data nuscenes_data_prep \\
        --root_path ROOT [--version v1.0-trainval] [--nsweeps 10]

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


MAINS = {"train": train_main, "test": test_main,
         "create_data": create_data_main}


def main(argv=None):
    """``python -m det3d_tpu_torch.cli {train,test,create_data} ...``."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in MAINS:
        print(f"usage: python -m det3d_tpu_torch.cli "
              f"{{{','.join(MAINS)}}} ...", file=sys.stderr)
        return 2
    return MAINS[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
