"""The CBGS train step against the JAX package, on the CPU: the checks of
tests/test_torch_sparse_train.py on configs/nusc_cbgs_voxelnet.py as
shipped (SpMiddleResNetFHD, dense from stage 2, six tasks, 9-dim boxes),
cut to +-6.4 m and 512 voxels with every width as shipped, fed host
training plans (the points-fed step runs the same code as SECOND's, held
in tests/test_torch_sparse_train.py; the middle is also held alone from
the plan it builds on the device). Its residual
blocks' conv biases feed a training BN: their gradient is zero in exact
arithmetic and rounding-sized on both sides (measured at most 6e-8 of
their weight gradient's norm), so they are held by size, not against
JAX's.
"""

import pytest
import torch

from tests.test_torch_sparse_train import (SparsePair, check_gradients,
                                           check_loss_eval, check_metrics,
                                           check_middle, check_state,
                                           run_steps)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def cbgs():
    return SparsePair("cbgs", 2)


@pytest.fixture(scope="module")
def cbgs_run(cbgs):
    return run_steps(cbgs, cbgs.batch)


def test_metrics_equal_jax(cbgs_run):
    check_metrics(cbgs_run)


def test_gradients_equal_jax(cbgs_run):
    check_gradients(cbgs_run)


def test_state_after_steps_equal_jax(cbgs_run):
    check_state(cbgs_run)


@pytest.mark.parametrize("host", [True, False])
def test_middle_gradients_equal_jax(cbgs, host):
    check_middle(cbgs, host)


def test_loss_eval_step_equals_jax(cbgs):
    check_loss_eval(cbgs)
