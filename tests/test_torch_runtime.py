"""The port's runtime against the JAX package's: the log buffer, hook
priorities, torch.save checkpoints written back in place, resume against
an uninterrupted run, weights carried over from a JAX ``.npz``, the
tfevents writer and the profiler hook.

Training runs on the CPU (``device="cpu"``) on the mini PointPillars
config, in fp32 where it is compared with JAX (its bf16 reader and neck
round differently under ``jax.jit``; tests/test_torch_pointpillars.py
holds the bf16 layers)."""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from det3d_tpu.apis.train import batch_to_device as jbatch_to_device
from det3d_tpu.apis.train import build_stack as jbuild_stack
from det3d_tpu.apis.train import init_state as jinit_state
from det3d_tpu.parallel.train import build_example as jbuild_example
from det3d_tpu.runtime import hooks as jhooks
from det3d_tpu.runtime.checkpoint import save_weights_npz
from det3d_tpu.runtime.log_buffer import LogBuffer as JLogBuffer
from det3d_tpu.runtime.trainer import Trainer as JTrainer
from det3d_tpu_torch.apis.train import build_stack, init_state, step_batch
from det3d_tpu_torch.datasets import build_dataloader, build_dataset
from det3d_tpu_torch.models.builder import init_weights
from det3d_tpu_torch.parallel.train import build_example, make_train_step
from det3d_tpu_torch.runtime import hooks
from det3d_tpu_torch.runtime.checkpoint import (CheckpointManager,
                                                load_weights, state_tensors)
from det3d_tpu_torch.runtime.log_buffer import LogBuffer
from det3d_tpu_torch.runtime.trainer import Trainer
from det3d_tpu_torch.utils import mini_kitti as mk
from det3d_tpu_torch.utils.convert import from_jax
from det3d_tpu_torch.utils.tfevents import TfEventWriter, _crc32c

HEAD_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("rt_kitti")
    mk.make_tree(root, n_scenes=8)
    return root


def fp32_config(root, **kw):
    cfg = mk.mini_config(str(root), **kw)
    cfg["model"]["reader"]["precision"] = "fp32"
    cfg["model"]["neck"]["precision"] = "fp32"
    return cfg


# ---------------------------------------------------------------------------
# log buffer and hooks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 3])
def test_log_buffer_equals_jax(n):
    """Count-weighted averages of the last n values; the port's values may
    be 0-d tensors, read back only here."""
    ours, ref = LogBuffer(), JLogBuffer()
    rng = np.random.RandomState(n)
    for i in range(5):
        vals = {"loss": float(rng.uniform()), "num_pos": float(i)}
        count = int(rng.randint(1, 4))
        ours.update({k: torch.tensor(v) for k, v in vals.items()}, count)
        ref.update(vals, count)
    ours.average(n)
    ref.average(n)
    assert ours.ready and list(ours.output) == list(ref.output)
    for k in ref.output:
        assert ours.output[k] == pytest.approx(ref.output[k], rel=1e-6)
    ours.clear_output()
    assert not ours.ready and not ours.output and ours.val_history


def test_hook_priorities_equal_jax():
    """Hooks run in priority order, ties in registration order."""
    regs = [("IterTimerHook", "LOW"), ("CheckpointHook", "NORMAL"),
            ("TextLoggerHook", "VERY_LOW"), ("IterTimerHook", 10),
            ("CheckpointHook", "NORMAL"), ("TextLoggerHook", 0)]
    ours = Trainer(None, lambda b: {})
    ref = JTrainer(None, lambda s, b: (s, {}))
    for name, prio in regs:
        ours.register_hook(getattr(hooks, name)(), prio)
        ref.register_hook(getattr(jhooks, name)(), prio)
    assert [type(h).__name__ for h in ours.hooks] == \
        [type(h).__name__ for h in ref.hooks]
    assert [p for p, _ in ours._hooks] == [p for p, _ in ref._hooks]
    for bad, err in ((101, ValueError), (1.5, TypeError),
                     ("URGENT", KeyError)):
        with pytest.raises(err):
            hooks.get_priority(bad)


# ---------------------------------------------------------------------------
# checkpoints and resume
# ---------------------------------------------------------------------------

class EpochBatches:
    """A loader of fixed batches, one list per epoch."""

    def __init__(self, batches):
        self.batches, self.epoch = batches, 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return len(self.batches[0])

    def __iter__(self):
        return iter(self.batches[self.epoch])


@pytest.fixture(scope="module")
def batches(tree):
    """Three epochs of two train batches from the loader, seed 0."""
    cfg = fp32_config(tree)
    np.random.seed(0)
    loader = build_dataloader(build_dataset(cfg["data"]["train"]), 2)
    out = []
    for e in range(3):
        loader.set_epoch(e)
        out.append([step_batch(b) for b in loader])
    return out


def fresh(tree, steps):
    cfg = fp32_config(tree)
    model, vg, asg, cids, _ = build_stack(cfg, device="cpu")
    init_weights(model, torch.Generator().manual_seed(0))
    state, lr_fn = init_state(cfg, model, steps, steps_per_epoch=2)
    return state, make_train_step(state, vg, asg, cids), lr_fn


def trainer_for(state, step, lr_fn, work_dir=None):
    tr = Trainer(state, step, work_dir=work_dir, lr_fn=lr_fn,
                 meta={"classes": [["Car"]]})
    if work_dir:
        tr.register_hook(hooks.CheckpointHook(interval=1))
    return tr


def test_checkpoint_round_trip_writes_in_place(tree, batches, tmp_path):
    state, step, _ = fresh(tree, 6)
    for b in batches[0]:
        step(b)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    for epoch in (1, 2, 3):
        mgr.save(epoch, state, meta={"iter": 2 * epoch})
    assert mgr.epochs() == [2, 3] and mgr.latest_epoch() == 3
    assert mgr.load_meta() == {"iter": 6, "epoch": 3}
    tensors = state_tensors(state)
    saved = {k: v.clone() for k, v in tensors.items()}
    ptrs = {k: v.data_ptr() for k, v in tensors.items()}
    assert any(k.startswith("tx/mu/") for k in tensors)
    assert int(saved["tx/count"]) == 2
    with torch.no_grad():
        for v in tensors.values():
            v.add_(1)
    _, epoch = mgr.restore(state)
    assert epoch == 3
    after = state_tensors(state)
    for k, v in after.items():
        assert v.data_ptr() == ptrs[k], k
        assert torch.equal(v, saved[k]), k
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(state)


def test_resume_equals_an_uninterrupted_run(tree, batches, tmp_path):
    """3 epochs straight against 2 epochs, a checkpoint, a fresh state
    resumed from it (written in place) and the third epoch: every
    parameter, BN statistic and optimizer tensor equal to the bit, and the
    trainer's step count the optimizer's."""
    state, step, lr_fn = fresh(tree, 6)
    trainer_for(state, step, lr_fn).run([EpochBatches(batches)],
                                        [("train", 1)], 3)
    work = str(tmp_path / "work")
    state_b, step_b, lr_b = fresh(tree, 6)
    first = trainer_for(state_b, step_b, lr_b, work)
    first.run([EpochBatches(batches)], [("train", 1)], 2)
    assert first.iter == 4 and int(state_b.step) == 4
    state_c, step_c, lr_c = fresh(tree, 6)
    ptrs = {k: v.data_ptr() for k, v in state_tensors(state_c).items()}
    second = trainer_for(state_c, step_c, lr_c, work)
    second.resume(work)
    assert second.epoch == 2 and second.iter == 4
    assert {k: v.data_ptr() for k, v in state_tensors(state_c).items()} \
        == ptrs
    second.run([EpochBatches(batches)], [("train", 1)], 3)
    assert second.iter == int(state_c.step) == 6
    ref = state_tensors(state)
    for k, v in state_tensors(state_c).items():
        assert torch.equal(v, ref[k]), k
    meta = json.load(open(os.path.join(work, "ckpt",
                                       "det3d_tpu_meta.json")))
    assert meta["epoch"] == 3 and meta["iter"] == 6 and \
        meta["classes"] == [["Car"]]


def test_load_weights_from_a_checkpoint_leaves_the_optimizer(tree, batches,
                                                             tmp_path):
    state, step, _ = fresh(tree, 6)
    for b in batches[0]:
        step(b)
    CheckpointManager(str(tmp_path)).save(1, state)
    other, _, _ = fresh(tree, 6)
    load_weights(other, str(tmp_path))
    for (k, v), w in zip(state.model.state_dict().items(),
                         other.model.state_dict().values()):
        assert torch.equal(v, w), k
    assert int(other.step) == 0
    assert all(not m.any() for m in other.tx.mu)


@pytest.fixture(scope="module")
def jax_weights(tree, tmp_path_factory):
    """A JAX state of the mini config (fp32), its BN statistics and biases
    drawn at random, saved by the JAX package's save_weights_npz; and a
    val batch."""
    cfg = fp32_config(tree)
    jmodel, jvg = jbuild_stack(copy.deepcopy(cfg))[:2]
    ds = build_dataset(cfg["data"]["val"])
    batch = build_dataloader(ds, 2, shuffle=False).__iter__().__next__()
    state, _ = jinit_state(cfg, jmodel, jvg, jbatch_to_device(batch), 10)
    rng = np.random.RandomState(0)

    def draw(path, x):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "var":
            return jnp.asarray(rng.uniform(0.5, 2.0, x.shape), x.dtype)
        if name in ("mean", "bias"):
            return jnp.asarray(rng.normal(0, 0.1, x.shape), x.dtype)
        return x
    state = state.replace(
        params=jax.tree_util.tree_map_with_path(draw, state.params),
        batch_stats=jax.tree_util.tree_map_with_path(draw,
                                                     state.batch_stats))
    path = str(tmp_path_factory.mktemp("npz") / "weights.npz")
    save_weights_npz(state, path)
    return cfg, jmodel, jvg, state, batch, path


def test_load_weights_from_jax_npz_predicts_as_jax(jax_weights):
    """The port's model loaded from JAX's .npz gives JAX's heads on the
    same val batch within 1e-5 (both from the same voxels), and holds
    from_jax's conversion of JAX's variables exactly."""
    cfg, jmodel, jvg, jstate, batch, path = jax_weights
    state, vg = fresh_with(cfg)
    ptrs = [p.data_ptr() for p in state.model.parameters()]
    load_weights(state, path)
    assert [p.data_ptr() for p in state.model.parameters()] == ptrs
    sd = from_jax(jax.tree.map(np.asarray, jstate.params),
                  jax.tree.map(np.asarray, jstate.batch_stats))
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    jex = jbuild_example(jbatch_to_device(batch), jvg, [], [],
                         with_targets=False)
    args = (jex["voxels"], jex["num_points_per_voxel"], jex["coordinates"])
    jheads = jax.jit(lambda v, *a: jmodel.apply(v, *a, train=False))(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}, *args)
    ex = build_example({k: torch.as_tensor(v) for k, v in
                        step_batch(batch, ("points", "num_points")).items()},
                       vg, [])
    for k in ("voxels", "num_points_per_voxel", "coordinates"):
        np.testing.assert_array_equal(ex[k].numpy(), np.asarray(jex[k]))
    with torch.no_grad():
        heads = state.model(ex["voxels"], ex["num_points_per_voxel"],
                            ex["coordinates"])
    for h, jh in zip(heads, jheads):
        assert sorted(h) == sorted(jh)
        for k in jh:
            np.testing.assert_allclose(h[k].numpy(), np.asarray(jh[k]),
                                       err_msg=k, **HEAD_TOL)


def fresh_with(cfg):
    model, vg, asg, cids, _ = build_stack(copy.deepcopy(cfg), device="cpu")
    return init_state(cfg, model, 10)[0], vg


def test_load_weights_names_a_missing_tensor(jax_weights, tmp_path):
    cfg, _, _, _, _, path = jax_weights
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files if "conv_cls" not in k}
    np.savez(tmp_path / "cut.npz", **flat)
    state, _ = fresh_with(cfg)
    with pytest.raises(KeyError, match="conv_cls"):
        load_weights(state, str(tmp_path / "cut.npz"))


# ---------------------------------------------------------------------------
# tfevents and the profiler
# ---------------------------------------------------------------------------

def test_tfevents_reads_back(tmp_path):
    """The writer's files parse with TensorBoard's own reader."""
    assert _crc32c(b"123456789") == 0xE3069283
    w = TfEventWriter(str(tmp_path))
    for step in range(5):
        w.add_scalar("train/loss", 10.0 - step, step)
        w.add_scalar("train/lr", 1e-3 * (step + 1), step)
    w.close()
    from tensorboard.backend.event_processing import event_accumulator
    acc = event_accumulator.EventAccumulator(
        str(next(tmp_path.glob("events.out.tfevents.*"))))
    acc.Reload()
    assert set(acc.Tags()["scalars"]) == {"train/loss", "train/lr"}
    loss = acc.Scalars("train/loss")
    assert [e.step for e in loss] == list(range(5))
    assert abs(loss[4].value - 6.0) < 1e-6
    assert abs(acc.Scalars("train/lr")[2].value - 3e-3) < 1e-9


def test_logger_hooks_and_profiler_hook(tmp_path):
    """A 6-iteration run of a trivial step: the text logger's JSON lines,
    the tensorboard hook's file, and the profiler's trace of iterations
    2 and 3."""
    x = torch.zeros(())

    def step(batch):
        x.add_(batch["v"].sum())
        return {"loss": x.clone()}

    tr = Trainer(None, step, work_dir=str(tmp_path))
    prof = hooks.ProfilerHook(start=2, steps=2)
    tr.register_hook(hooks.IterTimerHook())
    tr.register_hook(prof)
    tr.register_hook(hooks.TextLoggerHook(interval=2), "VERY_LOW")
    tr.register_hook(hooks.TensorboardLoggerHook(interval=2), "VERY_LOW")
    data = [{"v": torch.ones(3)} for _ in range(3)]
    tr.run([EpochBatches([data, data])], [("train", 1)], 2)
    assert tr.iter == 6 and float(x) == 18
    log = [json.loads(line) for line in
           open(tmp_path / f"{tr.timestamp}.log.json")]
    assert [r["loss"] for r in log if r["iter"] == 2] == [4.5, 13.5]
    assert list((tmp_path / "tf_logs").glob("events.out.tfevents.*"))
    assert (tmp_path / "profile" / "trace_2.json").is_file()
    names = {e.key for e in prof.profile.key_averages()}
    assert "aten::add_" in names
