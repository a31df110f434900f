"""One rank of tests/test_torch_dist.py: a gloo process group on the CPU
over localhost, driving the port (det3d_tpu_torch) alone.

    python tests/torch_dist_worker.py PORT RANK WORLD INPUTS OUT

INPUTS is a torch.save'd dict the test wrote; OUT.<rank> gets this rank's
results:

- "steps": for each train case (the small flagship, a cut SECOND) one
  make_train_step call on this rank's examples of the global batch (rank
  r takes rows r*b .. r*b+b-1) from the given weights: the metrics, the
  gradients handed to the optimizer, the state dict after the update,
  and whether the step drew from torch's default generator;
- "bn": a training-mode MaskedBatchNorm's output, input gradient,
  parameter gradients and running statistics on this rank's rows of a
  masked input, for a fixed cotangent;
- "draws": the flagship assigner with positive_fraction set, on this
  rank's gt from a seeded generator: its labels;
- "utils": reduce_dict (mean and sum), all_gather_objects, and the
  barrier passed;
- "eval": eval_detector over the ranks on the given checkpoint: the
  merged detections and the result text.
"""

import os
import sys

port, rank, world, inputs, out = sys.argv[1:6]
rank, world = int(rank), int(world)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from det3d_tpu_torch.parallel import dist_utils  # noqa: E402

torch.set_num_threads(2)


def rows(batch, b):
    return {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}


def train_case(case):
    import chip_smoke as cs
    from det3d_tpu_torch.apis.train import build_stack, init_state
    from det3d_tpu_torch.parallel.train import make_train_step
    model, vg, asg, cids, _ = build_stack(case["cfg"], device="cpu")
    model.load_state_dict(case["weights"])
    state, _ = init_state(case["cfg"], model, case["total_steps"])
    seen = cs.spy_grads(state)
    step = make_train_step(state, vg, asg, cids)
    b = case["batch"]["points"].shape[0] // world
    rng = torch.random.get_rng_state()
    metrics = step(rows(case["batch"], b))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": seen[0],
            "names": [n for n, _ in model.named_parameters()],
            "state": {k: v.clone() for k, v in model.state_dict().items()},
            "drew": not torch.equal(rng, torch.random.get_rng_state())}


def bn_case(case):
    from det3d_tpu_torch.models.norm import MaskedBatchNorm
    n = case["x"].shape[0] // world
    part = rows({k: case[k] for k in ("x", "mask", "cot")}, n)
    bn = MaskedBatchNorm(case["x"].shape[-1]).train()
    bn.load_state_dict(case["weights"])
    x = part["x"].clone().requires_grad_(True)
    y = bn(x, part["mask"])
    (y * part["cot"]).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "dscale": bn.scale.grad,
            "dbias": bn.bias.grad, "mean": bn.mean, "var": bn.var}


def draws_case(case):
    from det3d_tpu_torch.apis.train import build_stack
    _, _, asg, cids, _ = build_stack(case["cfg"], device="cpu")
    a = asg[0]
    a.positive_fraction = case["positive_fraction"]
    b = case["gt_boxes"].shape[0] // world
    part = rows({k: torch.as_tensor(case[k]) for k in (
        "gt_boxes", "gt_classes", "gt_valid")}, b)
    labels, _, _ = a.assign(part["gt_boxes"], part["gt_classes"],
                            part["gt_valid"], class_ids=tuple(cids[0]),
                            generator=torch.Generator().manual_seed(
                                case["seed"]))
    return labels


def utils_case():
    red = dist_utils.reduce_dict({"rank": float(rank),
                                  "loss": torch.tensor(2.0 * rank + 1)})
    summed = dist_utils.reduce_dict({"rank": float(rank)}, average=False)
    gathered = dist_utils.all_gather_objects(
        {f"tok{rank}_{i}": np.full((2,), rank * 10 + i, np.float32)
         for i in range(3)})
    dist_utils.synchronize()
    return {"info": dist_utils.get_dist_info(), "mean": red,
            "sum": summed, "gathered": gathered}


def eval_case(case):
    from det3d_tpu_torch.apis.train import (build_stack, eval_detector,
                                            example_width, init_state)
    from det3d_tpu_torch.runtime.checkpoint import CheckpointManager
    cfg = case["cfg"]
    model = build_stack(cfg, "cpu", point_width=example_width(
        cfg["data"]["val"]))[0]
    state, _ = init_state(cfg, model, total_steps=1)
    CheckpointManager(case["ckpt"]).restore(state)
    results, dets = eval_detector(cfg, state, device="cpu")
    return {"results": results["results"], "detections": dets}


def main():
    dist_utils.initialize_distributed(f"localhost:{port}", world, rank,
                                      backend="gloo")
    case = torch.load(inputs, weights_only=False)
    res = {"steps": {k: train_case(v) for k, v in case["steps"].items()},
           "bn": bn_case(case["bn"]), "draws": draws_case(case["draws"]),
           "utils": utils_case()}
    if "eval" in case:
        res["eval"] = eval_case(case["eval"])
    torch.save(res, f"{out}.{rank}")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
