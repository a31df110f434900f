"""A sparse middle on a grid deeper than 64, the port against the JAX
package on the CPU: SpMiddleFHD at depth 81 (SECOND's 0.1 m z voxels
halved) on a 16 x 16 BEV, from the device plan (flat rulebooks at res0
and into stage 1, windows after, the dense tail from stage 3), forward
and backward in training. Output and running statistics within 1e-4
(rtol, atol 1e-4 of the largest), gradients within 1e-4 relative L2.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from det3d_tpu.models import backbones as jbb
from det3d_tpu_torch.models import backbones as bb
from det3d_tpu_torch.utils.convert import from_jax
from tests.test_torch_deep_grid import DEEP, DEEP_GRID, TOL, voxel_batch
from tests.test_torch_variants import close, jax_vars, load, rel_l2

torch.set_num_threads(2)



def test_deep_middle_forward_and_backward_match_jax(rng):
    """SpMiddleFHD (dense tail from stage 3) on a depth-81 grid in
    training: the device plan's flat rulebooks at res0 and into stage 1,
    windows after; the output (64 channels x 4 depths), the running
    statistics and every parameter's gradient of sum(out^2) against
    JAX's plan=None middle."""
    feats, co = voxel_batch(rng, 2, 70, 72, 4, DEEP)
    jf, jc = jnp.asarray(feats), jnp.asarray(co)
    jm = jbb.SpMiddleFHD(num_input_features=4)
    v = jax_vars(jm, jf, jc, static=(DEEP_GRID,), seed=9)

    def jloss(p):
        out, upd = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                            jf, jc, DEEP_GRID, train=True,
                            mutable=["batch_stats"])
        return jnp.sum(out * out), (out, upd)

    (_, (ref, upd)), jgrad = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(v["params"])
    m = load(bb.SpMiddleFHD(num_input_features=4), v["params"],
             v["batch_stats"]).train()
    out = m(torch.from_numpy(feats), torch.from_numpy(co), DEEP_GRID)
    assert out.shape == (2, 2, 2, 256) == ref.shape
    close(out.detach().numpy(), ref, TOL)
    (out * out).sum().backward()
    gsd = from_jax({"backbone": jgrad}, {})
    stats = from_jax({"backbone": {}}, {"backbone": upd["batch_stats"]})
    for name, p in m.named_parameters():
        g = gsd["backbone." + name].numpy()
        if name.endswith("norm.bias") or np.linalg.norm(g) > 1e-6:
            assert rel_l2(p.grad.numpy(), g) <= TOL, name
    for name, buf in m.named_buffers():
        close(buf.numpy(), stats["backbone." + name].numpy(), TOL, name)
