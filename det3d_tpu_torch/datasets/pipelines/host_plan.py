"""HostPlan pipeline stage: build packed sparse-conv rulebooks in the
loader workers.

Port of det3d_tpu/datasets/pipelines/host_plan.py. Runs after Reformat
(the example dict already holds the padded cloud) and adds ``point_lin``,
``point_perm`` and the packed ``plan_*`` arrays of
ops/sparse_host.py::build_plan (the C++ builders of csrc/hostplan.cc;
``train=True`` adds each strided conv's inverse rulebook). The train and
predict steps pass the ``plan_*`` keys to the sparse middle, which then
builds no rulebook on the device; the builds move into the loader's
workers, ahead of the step.

apis/train.py::train_detector and eval_detector inject this stage for
sparse-middle configs whose voxelizer order has a host twin
(``host_plan = False`` in the config opts out); it can also be listed
explicitly in a pipeline with the same kwargs.
"""

from __future__ import annotations

from det3d_tpu_torch.datasets.registry import PIPELINES
from det3d_tpu_torch.ops import sparse_host as sph


@PIPELINES.register_module
class HostPlan:
    def __init__(self, voxel=None, spec=None, train=True):
        self.voxel = dict(voxel or {})
        self.spec = spec
        self.train = bool(train)

    def __call__(self, example, info):
        plan = sph.build_plan(
            example["points"], example["num_points"],
            voxel_size=self.voxel["voxel_size"],
            pc_range=self.voxel["pc_range"],
            grid_size=tuple(self.voxel["grid_size"]),
            max_voxels=int(self.voxel["max_voxels"]),
            order=self.voxel["order"],
            spec=self.spec, train=self.train)
        example.update(plan)
        return example, info
