"""Ranks over torch.distributed on the CPU (gloo): the port's global step,
synced BatchNorm, the sharded loader and evaluation, and the CLI's ranks.

The module spawns its ranks once: two processes of
tests/torch_dist_worker.py (one gloo group over localhost), then two
ranks of ``python -m det3d_tpu_torch.cli train`` and of ``... test``
(``--device cpu --coordinator localhost:P --num_processes 2
--process_id r``), each writing what it computed under ``tmp_path``, as
tests/test_multiprocess.py runs the JAX package's processes. Held:

- A 2-rank train step (each rank one of the two scans) of the small
  flagship and of SECOND cut to +-6.4 m (widths as shipped, host training
  plans), from the same weights, against the port's one-process step on
  the two scans: the loss within LOSS_REL, every rank's reduced gradient
  within GRAD_REL relative L2 (SECOND's below its head within FLIP_REL:
  a ReLU at its kink), the running statistics within STATS_TOL,
  the parameters after the update within PARAM_TOL where the gradient is
  clear of zero (the constants of tests/test_torch_train_step.py); both
  ranks' gradients and parameters bit-equal; neither step draws from
  torch's default generator (no assigner subsamples).
- The same 2-rank step against JAX's ``make_train_step(mesh=None)`` on
  the global batch (the mesh's step computes the same program,
  tests/test_multiprocess.py): the flagship as
  tests/test_torch_train_step.py holds the one-process step, its
  gradients by ``jax.grad`` op by op, at that file's tolerances; SECOND
  at tests/test_torch_sparse_train.py's (whose docstring says why XLA's
  fp32 sums put the gradients below the head further from the port's),
  its gradients jitted (``second_grads``).
- Synced ``MaskedBatchNorm`` with a mask, forward and backward, 2 ranks
  against one; positive_fraction draws of rank r's example i equal to
  the global batch's example r + i's; reduce_dict, all_gather_objects
  and synchronize as tests/multiproc_worker.py checks the JAX package's.
- ``DistributedGroupSampler`` equal to the JAX package's for every rank
  over 3 epochs at world sizes 2 and 3; ``build_dataloader(dist=True)``.
- ``eval_detector`` over 2 ranks equal to one process on a mini-KITTI
  tree (detections token by token, the official result); the CLI's
  ``train`` over 2 ranks exits 0 on both, rank 0 alone writing the
  checkpoint and logs, and its ``test`` prints the one-process result.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke as cs
from __graft_entry__ import _build_flagship
from det3d_tpu.datasets.loader.sampler import (
    DistributedGroupSampler as JDistributedGroupSampler)
from det3d_tpu.parallel.train import build_example as jbuild_example
from det3d_tpu.parallel.train import make_train_step as jtrain_step
from det3d_tpu_torch.apis.flagship import flagship_config
from det3d_tpu_torch.apis.train import (build_stack, eval_detector,
                                        example_width, init_state)
from det3d_tpu_torch.datasets.loader import (DistributedGroupSampler,
                                             build_dataloader)
from det3d_tpu_torch.models.norm import MaskedBatchNorm
from det3d_tpu_torch.parallel import dist_utils, graph
from det3d_tpu_torch.parallel.train import make_train_step
from det3d_tpu_torch.runtime.checkpoint import CheckpointManager
from det3d_tpu_torch.utils import mini_kitti as mk
from det3d_tpu_torch.utils.convert import from_jax
from tests import test_torch_sparse_train as sparse
from tests.test_torch_modules import PC, SMALL
from tests.test_torch_train_step import (CLEAR_OF_ZERO, GRAD_REL, LOSS_REL,
                                         OPT_CFG, PARAM_TOL, STATS_TOL,
                                         TOTAL_STEPS, Pair, init_vars,
                                         jax_grads, rel_l2)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
WORLD = 2
CASES = ("flagship", "second")
RANK_TIMEOUT = 300
POSITIVE_FRACTION = 0.25
# SECOND, 2 ranks against one process, below the head: a ReLU whose input
# lies within a few 1e-6 of zero may take the other side when the sums
# run in another order (here the BN statistics summed a rank at a time and
# the convs over one scan, not two). On this input one element of the
# RPN's first block does (block0_conv0's BN output -4.6e-6 in one process,
# +1.5e-6 over the ranks, of 262144; found by hooks on the CPU), and it
# moves every gradient below it by up to 5.5e-3 relative L2 and grad_norm
# by 2.5e-5; the head's gradients stay within 4e-6. Every other
# comparison (loss, head, statistics, the flagship's every gradient)
# keeps tests/test_torch_train_step.py's constants.
FLIP_REL = 1e-2


def free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn(argv_of_rank, log):
    """Start WORLD processes, argv_of_rank(rank) each, from the repo root
    with two torch threads; returns them."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    procs = []
    for r in range(WORLD):
        with open(f"{log}.{r}", "w") as f:
            procs.append(subprocess.Popen(argv_of_rank(r), cwd=str(REPO),
                                          env=env, stdout=f,
                                          stderr=subprocess.STDOUT))
    return procs


def wait(procs, log):
    try:
        for p in procs:
            p.wait(timeout=RANK_TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, Path(f"{log}.{r}").read_text()[-4000:]


def port_step(cfg, weights, batch, total_steps):
    """The port's one-process step: metrics, the gradients its optimizer
    got, the state after."""
    model, vg, asg, cids, _ = build_stack(cfg, device="cpu")
    model.load_state_dict(weights)
    state, _ = init_state(cfg, model, total_steps)
    seen = cs.spy_grads(state)
    metrics = make_train_step(state, vg, asg, cids)(batch)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": dict(zip([n for n, _ in model.named_parameters()],
                              seen[0])),
            "state": {k: v.clone() for k, v in model.state_dict().items()}}


def jax_step(pair, batch, grads_fn):
    """JAX's make_train_step(mesh=None) on the global batch: its metrics
    and state after as the port's names, and its gradients at the initial
    weights (``grads_fn``)."""
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jstate, jm = jtrain_step(pair.jmodel, pair.jvg, pair.jasg,
                             pair.jcids)(pair.jax_state(), jbatch)
    return {"metrics": {k: float(v) for k, v in jm.items()},
            "state": from_jax(jax.tree.map(np.asarray, jstate.params),
                              jax.tree.map(np.asarray, jstate.batch_stats)),
            "grads": from_jax(jax.tree.map(np.asarray, grads_fn()), {})}


def second_grads(pair):
    """JAX's gradients of SECOND's loss at the initial weights, jitted:
    on this input within 8.5e-6 (the head) and 1.5e-3 (elsewhere,
    relative L2) of its op-by-op ones (measured on the CPU), far inside
    tests/test_torch_sparse_train.py's tolerances, and ~55 s quicker."""
    jb = {k: jnp.asarray(v) for k, v in pair.batch.items()}
    plan = {k[5:]: v for k, v in jb.items() if k.startswith("plan_")}
    jm, stats = pair.jmodel, pair.var["batch_stats"]

    def loss_fn(p, b):
        ex = jbuild_example(b, pair.jvg, pair.jasg, pair.jcids,
                            with_targets=True)
        preds, _ = jm.apply({"params": p, "batch_stats": stats},
                            ex["voxels"], ex["num_points_per_voxel"],
                            ex["coordinates"], train=True,
                            mutable=["batch_stats"], plan=plan)
        return sum(jm.loss(ex, preds)["loss"])
    return jax.jit(jax.grad(loss_fn))(pair.var["params"], jb)


def train_cases():
    """{case: (port config, weights, global batch, total steps, JAX
    pair, JAX's gradient function)}."""
    jstack = _build_flagship(small=True, **SMALL)
    scans = cs.train_scene(2, 1500, PC, seed=1)
    cfg = dict(flagship_config(small=True, **SMALL), **OPT_CFG)
    flag = Pair(cfg, jstack, init_vars(*jstack, scans, 1), scans)
    flag.total_steps = TOTAL_STEPS
    sec = sparse.SparsePair("second", 5)
    sec.total_steps = sparse.TOTAL_STEPS
    weights = {k: from_jax(p.var["params"], p.var["batch_stats"])
               for k, p in (("flagship", flag), ("second", sec))}
    return {
        "flagship": (cfg, weights["flagship"], scans, flag, lambda: jax_grads(
            flag.jmodel, flag.var["params"], flag.var["batch_stats"],
            flag.jax_example(), jit=False)[1]),
        "second": (sec.cfg, weights["second"], sec.batch, sec,
                   lambda: second_grads(sec))}


def bn_case():
    rng = np.random.RandomState(3)
    x = (rng.randn(4, 50, 8) * 3 + 5).astype(np.float32)
    mask = rng.rand(4, 50) > 0.3
    bn = MaskedBatchNorm(8)
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(rng.rand(8).astype(np.float32) + .5))
        bn.bias.copy_(torch.from_numpy(rng.randn(8).astype(np.float32)))
        bn.mean.copy_(torch.from_numpy(rng.randn(8).astype(np.float32)))
    return {"x": torch.from_numpy(x), "mask": torch.from_numpy(mask),
            "cot": torch.from_numpy(rng.randn(4, 50, 8).astype(np.float32)),
            "weights": {k: v.clone() for k, v in bn.state_dict().items()}}


def draws_case(cfg):
    scans = cs.train_scene(4, 200, PC, seed=4)
    return {"cfg": cfg, "positive_fraction": POSITIVE_FRACTION, "seed": 11,
            **{k: scans[k] for k in ("gt_boxes", "gt_classes", "gt_valid")}}


def mini(root):
    cfg = mk.mini_config(str(root), total_epochs=1)
    cfg["tensorboard"] = True
    return cfg


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Everything the ranks computed, and the one-process references."""
    tmp = tmp_path_factory.mktemp("dist")
    root = tmp / "kitti"
    mk.make_tree(root, n_scenes=8)
    conf = tmp / "mini.json"
    conf.write_text(json.dumps(mini(root)))
    works = [tmp / f"work{r}" for r in range(WORLD)]
    cli = [sys.executable, "-m", "det3d_tpu_torch.cli"]
    port = free_port()
    trained = spawn(lambda r: cli + [
        "train", str(conf), "--work_dir", str(works[r]), "--device", "cpu",
        "--coordinator", f"localhost:{port}", "--num_processes",
        str(WORLD), "--process_id", str(r)], tmp / "train.log")

    cases = train_cases()
    steps = {key: {"cfg": cfg, "weights": weights, "batch": batch,
                   "total_steps": pair.total_steps}
             for key, (cfg, weights, batch, pair, _) in cases.items()}
    bn = bn_case()
    draws = draws_case(cases["flagship"][0])
    wait(trained, tmp / "train.log")

    inputs = tmp / "inputs.pt"
    torch.save({"steps": steps, "bn": bn, "draws": draws,
                "eval": {"cfg": mini(root),
                         "ckpt": str(works[0] / "ckpt")}}, inputs)
    out = tmp / "rank"
    port, port2 = free_port(), free_port()
    workers = spawn(lambda r: [
        sys.executable, str(REPO / "tests" / "torch_dist_worker.py"),
        str(port), str(r), str(WORLD), str(inputs), str(out)],
        tmp / "worker.log")
    tested = spawn(lambda r: cli + [
        "test", str(conf), str(works[0]), "--device", "cpu",
        "--coordinator", f"localhost:{port2}", "--num_processes",
        str(WORLD), "--process_id", str(r)], tmp / "test.log")
    # the references while the ranks run: the one-process step, JAX's
    ref = {k: port_step(c["cfg"], c["weights"], c["batch"],
                        c["total_steps"]) for k, c in steps.items()}
    jref = {k: jax_step(pair, c["batch"], grads_fn)
            for (k, c), (_, _, _, pair, grads_fn) in zip(
                steps.items(), cases.values())}
    # the one-process evaluation of rank 0's checkpoint
    cfg = mini(root)
    model = build_stack(cfg, "cpu", point_width=example_width(
        cfg["data"]["val"]))[0]
    state, _ = init_state(cfg, model, total_steps=1)
    CheckpointManager(str(works[0] / "ckpt")).restore(state)
    results, dets = eval_detector(cfg, state, device="cpu")
    wait(workers, tmp / "worker.log")
    wait(tested, tmp / "test.log")
    return {"ranks": [torch.load(f"{out}.{r}", weights_only=False)
                      for r in range(WORLD)],
            "ref": ref, "jax": jref, "bn": bn, "draws": draws,
            "eval": (results["results"], dets), "works": works,
            "logs": {k: [Path(f"{tmp / k}.log.{r}").read_text()
                         for r in range(WORLD)] for k in ("train", "test")}}


def assert_metrics(got, want, rel, grad_norm_rel=None):
    """Counts equal; the losses within ``rel`` relative, ``grad_norm``
    within ``grad_norm_rel`` (``rel`` by default)."""
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if k.startswith(("num_pos", "num_neg", "num_voxels")):
            assert got[k] == v, k
        else:
            tol = grad_norm_rel if k == "grad_norm" and grad_norm_rel else rel
            assert abs(got[k] - v) <= tol * max(abs(v), 1e-3), (k, got[k], v)


def assert_grads(grads, ref, rel):
    """Each gradient within ``rel(name)`` relative L2 of ``ref``'s; the conv
    biases before a training BN (zero in exact arithmetic: rounding on
    both sides) below 1e-4 of their weight's gradient instead."""
    assert sorted(grads) == sorted(ref)
    zero = cs.zero_grad_bias(list(grads))
    for n, g in grads.items():
        if n in zero:
            w = grads[n.rsplit(".", 1)[0] + ".weight"].norm()
            assert float(g.norm()) <= 1e-4 * float(w), n
        else:
            err = rel_l2(g.numpy(), ref[n].numpy())
            assert err <= rel(n), (n, err)


def assert_params(state, ref, grads, ref_grads, clear_of_zero=CLEAR_OF_ZERO,
                  clear_abs=0.0):
    """The parameters after the step where both gradients are clear of
    zero (``clear_of_zero`` of the tensor's largest and ``clear_abs``) and
    of one sign: Adam's first step is the gradient's sign."""
    zero = cs.zero_grad_bias(list(grads))
    checked = 0
    for k, a in grads.items():
        if k in zero:
            continue
        b = ref_grads[k]
        clear = ((a.abs() > clear_of_zero * float(a.abs().max()))
                 & (b.abs() > clear_of_zero * float(b.abs().max()))
                 & (a.abs() > clear_abs) & (b.abs() > clear_abs)
                 & (torch.sign(a) == torch.sign(b)))
        checked += int(clear.sum())
        torch.testing.assert_close(state[k][clear], ref[k][clear],
                                   **PARAM_TOL)
    assert checked > 0.5 * sum(g.numel() for g in grads.values())


def assert_stats(state, ref, tol):
    stats = [k for k in ref if k.endswith((".mean", ".var"))]
    assert stats
    for k in stats:
        torch.testing.assert_close(state[k], ref[k], **tol)


@pytest.mark.parametrize("case", CASES)
def test_step_equals_one_process(run, case):
    """SECOND's gradients below its head are held at FLIP_REL: see there."""
    ref = run["ref"][case]
    rel = (lambda n: GRAD_REL) if case == "flagship" else (
        lambda n: GRAD_REL if n.startswith("bbox_head") else FLIP_REL)
    clear = ((CLEAR_OF_ZERO, 0.0) if case == "flagship" else
             (sparse.CLEAR_OF_ZERO, sparse.CLEAR_ABS))
    for rank in run["ranks"]:
        got = rank["steps"][case]
        grads = dict(zip(got["names"], got["grads"]))
        assert_metrics(got["metrics"], ref["metrics"], LOSS_REL,
                       None if case == "flagship" else FLIP_REL)
        assert_grads(grads, ref["grads"], rel)
        assert_stats(got["state"], ref["state"], STATS_TOL)
        assert_params(got["state"], ref["state"], grads, ref["grads"],
                      *clear)


@pytest.mark.parametrize("case", CASES)
def test_ranks_apply_one_update(run, case):
    """Every rank hands its optimizer the same gradients and ends with the
    same parameters and statistics, to the bit."""
    a, b = (r["steps"][case] for r in run["ranks"])
    assert a["metrics"] == b["metrics"]
    for ga, gb in zip(a["grads"], b["grads"]):
        assert torch.equal(ga, gb)
    for k in a["state"]:
        assert torch.equal(a["state"][k], b["state"][k]), k


@pytest.mark.parametrize("case", CASES)
def test_step_equals_jax(run, case):
    jref = run["jax"][case]
    got = run["ranks"][0]["steps"][case]
    grads = dict(zip(got["names"], got["grads"]))
    if case == "flagship":
        assert_metrics(got["metrics"], jref["metrics"], LOSS_REL)
        assert_grads(grads, jref["grads"], lambda n: GRAD_REL)
        assert_stats(got["state"], jref["state"], STATS_TOL)
        assert_params(got["state"], jref["state"], grads, jref["grads"])
    else:
        assert_metrics(got["metrics"], jref["metrics"], sparse.LOSS_REL,
                       sparse.STEP_GRAD_REL)
        assert_grads(grads, jref["grads"], lambda n: (
            sparse.HEAD_GRAD_REL if n.startswith("bbox_head")
            else sparse.STEP_GRAD_REL))
        assert_stats(got["state"], jref["state"], sparse.STATS_TOL)
        assert_params(got["state"], jref["state"], grads, jref["grads"],
                      sparse.CLEAR_OF_ZERO, sparse.CLEAR_ABS)


@pytest.mark.parametrize("case", CASES)
def test_shipped_assigners_draw_nothing(run, case):
    assert not any(r["steps"][case]["drew"] for r in run["ranks"])


def test_positive_fraction_draws_as_the_global_batch(run):
    """Rank r's example i subsamples as the global batch's example
    r * B + i does, from generators in one state."""
    case = run["draws"]
    _, _, asg, cids, _ = build_stack(case["cfg"], device="cpu")
    a = asg[0]
    a.positive_fraction = case["positive_fraction"]
    labels, _, _ = a.assign(*(torch.as_tensor(case[k]) for k in (
        "gt_boxes", "gt_classes", "gt_valid")), class_ids=tuple(cids[0]),
        generator=torch.Generator().manual_seed(case["seed"]))
    b = labels.shape[0] // WORLD
    assert int((labels == -1).sum()) > 0       # the subsampling ran
    for r, rank in enumerate(run["ranks"]):
        assert torch.equal(rank["draws"], labels[r * b:(r + 1) * b])


def test_synced_batchnorm_equals_one_process(run):
    case = run["bn"]
    bn = MaskedBatchNorm(8).train()
    bn.load_state_dict(case["weights"])
    x = case["x"].clone().requires_grad_(True)
    y = bn(x, case["mask"])
    (y * case["cot"]).sum().backward()
    n = x.shape[0] // WORLD
    ranks = [r["bn"] for r in run["ranks"]]
    tol = dict(rtol=1e-5, atol=1e-5)
    for r, got in enumerate(ranks):
        part = slice(r * n, (r + 1) * n)
        torch.testing.assert_close(got["y"], y[part].detach(), **tol)
        torch.testing.assert_close(got["dx"], x.grad[part], **tol)
        torch.testing.assert_close(got["mean"], bn.mean, **STATS_TOL)
        torch.testing.assert_close(got["var"], bn.var, **STATS_TOL)
    # each rank's parameter gradient is its rows' share of the total
    for k, want in (("dscale", bn.scale.grad), ("dbias", bn.bias.grad)):
        torch.testing.assert_close(sum(g[k] for g in ranks), want, **tol)


def test_dist_utils_over_ranks(run):
    expect = {f"tok{r}_{i}": r * 10 + i for r in range(WORLD)
              for i in range(3)}
    for r, rank in enumerate(run["ranks"]):
        u = rank["utils"]
        assert u["info"] == (r, WORLD)
        assert u["mean"] == pytest.approx({"rank": 0.5, "loss": 2.0})
        assert u["sum"] == pytest.approx({"rank": 1.0})
        merged = {k: v for d in u["gathered"] for k, v in d.items()}
        assert sorted(merged) == sorted(expect)
        for k, v in merged.items():
            assert (v == expect[k]).all()


def test_dist_utils_without_a_group():
    assert not dist_utils.active()
    assert dist_utils.get_dist_info() == (0, 1)
    assert dist_utils.reduce_dict({"a": torch.tensor(2.0)}) == {"a": 2.0}
    assert dist_utils.all_gather_objects({"x": 1}) == [{"x": 1}]
    dist_utils.synchronize()
    dist_utils.initialize_distributed(None, 1, 0)
    dist_utils.initialize_distributed("localhost:1", None, None)
    assert not dist_utils.active()
    with pytest.raises(ValueError, match="coordinator"):
        dist_utils.initialize_distributed(None, 2, 0)
    assert dist_utils.master_only(lambda: 7)() == 7


class FlagDataset:
    """A dataset of group flags alone: two groups of 11 and 12."""

    def __init__(self, n=23):
        self.flag = (np.arange(n) % 2).astype(np.uint8)

    def group_flag(self):
        return self.flag

    def __len__(self):
        return len(self.flag)


@pytest.mark.parametrize("world,rank", [(2, 0), (2, 1), (3, 0), (3, 1),
                                        (3, 2)])
def test_distributed_sampler_equals_jax(world, rank):
    ds = FlagDataset()
    ours = DistributedGroupSampler(ds, 2, num_replicas=world, rank=rank,
                                   seed=5)
    ref = JDistributedGroupSampler(ds, 2, num_replicas=world, rank=rank,
                                   seed=5)
    assert len(ours) == len(ref)
    for epoch in range(3):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        assert list(ours) == list(ref)


def test_build_dataloader_dist_takes_the_ranks():
    loader = build_dataloader(FlagDataset(), 2, dist=True, seed=5)
    s = loader.sampler
    assert isinstance(s, DistributedGroupSampler)
    assert (s.rank, s.num_replicas, s.seed) == (0, 1, 5)
    assert build_dataloader(FlagDataset(), 2, dist=True,
                            shuffle=False).sampler is None


def test_stepper_follows_the_backend(monkeypatch):
    """A step with collectives on the card: eager under gloo, captured
    under NCCL; without collectives captured whatever the backend."""
    captured = []
    monkeypatch.setattr(graph, "CapturedStep",
                        lambda *a: captured.append(a) or "captured")
    cuda = torch.device("cuda", 0)
    monkeypatch.setattr(graph, "backend", lambda: "gloo")
    step = graph.stepper(lambda b: b, cuda, collective=True)
    assert callable(step) and step.eager is step and not captured
    assert graph.stepper(lambda b: b, cuda) == "captured"
    monkeypatch.setattr(graph, "backend", lambda: "nccl")
    assert graph.stepper(lambda b: b, cuda, collective=True) == "captured"


def test_eval_over_ranks_equals_one_process(run):
    results, dets = run["eval"]
    for rank in run["ranks"]:
        got = rank["eval"]
        assert got["results"] == results
        assert list(got["detections"]) == list(dets)
        for tok, d in dets.items():
            g = got["detections"][tok]
            for k in ("box3d_lidar", "scores", "label_preds"):
                np.testing.assert_array_equal(g[k], d[k], err_msg=k)
            assert g["metadata"]["token"] == d["metadata"]["token"] == tok


def test_cli_train_over_ranks_writes_from_rank_zero(run):
    """Both ranks train to the end; rank 0 alone writes the checkpoint, the
    logs and the tfevents (rank 1 was given a work dir of its own, and
    writes nothing there)."""
    w0, w1 = run["works"]
    for log in run["logs"]["train"]:
        assert "trained to epoch 1" in log
    assert [p.name for p in (w0 / "ckpt").glob("*.pt")] == ["epoch_1.pt"]
    assert list(w0.glob("*.log")) and list(w0.glob("*.log.json"))
    assert list((w0 / "tf_logs").iterdir())
    written = [p for p in w1.rglob("*") if p.is_file()]
    assert written == []
    blob = torch.load(w0 / "ckpt" / "epoch_1.pt", weights_only=True)
    assert all(torch.isfinite(v.float()).all() for v in blob.values())


def test_cli_test_over_ranks_prints_the_one_process_result(run):
    results, _ = run["eval"]
    for log in run["logs"]["test"]:
        assert "restored checkpoint @ epoch 1" in log
        assert results["official"] in log
