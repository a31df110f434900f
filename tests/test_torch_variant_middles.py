"""The sparse middles no shipped config names, the port against the JAX
package on the CPU: SpMiddleFHDNobn and RCNNSpMiddleFHD
(tests/test_model_variants.py:17, :28), JAX's weights carried over by
``utils/convert.py::from_jax``, on the JAX tests' (16, 16, 40) grid from
the device plan. Outputs within 1e-4 (rtol, atol 1e-4 of the largest);
gradients within 1e-4 relative L2; running statistics within 1e-5.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from det3d_tpu.models import backbones as jbb
from det3d_tpu_torch.models import backbones as bb
from det3d_tpu_torch.utils.convert import from_jax
from tests.test_torch_variants import (ELT_REL, GRAD_REL, GRID, MID_TOL,
                                       close, jax_vars, load, rel_l2,
                                       sparse_inputs)

torch.set_num_threads(2)



def test_nobn_middle_has_no_batch_stats_and_matches_jax(rng):
    """SpMiddleFHDNobn: no BN anywhere, every conv biased, sparse and
    dense tail; (1, 2, 2, 128) as JAX's, within MID_TOL of it."""
    feats, co = sparse_inputs(rng)
    jf, jc = jnp.asarray(feats), jnp.asarray(co)
    jm = jbb.SpMiddleFHDNobn(num_input_features=4)
    v = jax_vars(jm, jf, jc, static=(GRID,), seed=3)
    assert not v["batch_stats"]
    ref = np.asarray(jax.jit(lambda v_, f, c: jm.apply(
        v_, f, c, GRID, train=False))(v, jf, jc))
    m = load(bb.SpMiddleFHDNobn(num_input_features=4), v["params"]).eval()
    assert not any(isinstance(x, torch.nn.BatchNorm1d) or "norm" in n
                   for n, x in m.named_modules())
    assert all(getattr(m, n).bias is not None
               for n in m._sparse + m._dense)
    out = m(torch.from_numpy(feats), torch.from_numpy(co), GRID)
    assert out.shape == (1, 2, 2, 128) == ref.shape
    close(out.detach().numpy(), ref, MID_TOL, "Nobn middle")


def test_rcnn_middle_matches_jax_forward_and_backward(rng):
    """RCNNSpMiddleFHD in training (BN on batch statistics, the device
    training plan, the strided convs' inverse-rulebook dX): the output,
    the running statistics and every parameter's gradient of sum(out^2)
    against JAX's; fewer parameters than SpMiddleFHD."""
    feats, co = sparse_inputs(rng, b=2)
    jf, jc = jnp.asarray(feats), jnp.asarray(co)
    jm = jbb.RCNNSpMiddleFHD(num_input_features=4)
    v = jax_vars(jm, jf, jc, static=(GRID,), seed=5)

    def jloss(p):
        out, upd = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                            jf, jc, GRID, train=True,
                            mutable=["batch_stats"])
        return jnp.sum(out * out), (out, upd)

    (_, (ref, upd)), jgrad = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(v["params"])
    m = load(bb.RCNNSpMiddleFHD(num_input_features=4), v["params"],
             v["batch_stats"]).train()
    out = m(torch.from_numpy(feats), torch.from_numpy(co), GRID)
    assert out.shape == (2, 2, 2, 128) == ref.shape
    close(out.detach().numpy(), ref, MID_TOL, "RCNN middle")
    (out * out).sum().backward()
    gsd = from_jax({"backbone": jgrad}, {})
    stats = from_jax({"backbone": {}}, {"backbone": upd["batch_stats"]})
    for name, p in m.named_parameters():
        g = gsd["backbone." + name].numpy()
        if name.endswith("norm.bias") or np.linalg.norm(g) > 1e-6:
            assert rel_l2(p.grad.numpy(), g) <= GRAD_REL, name
    for name, buf in m.named_buffers():
        close(buf.numpy(), stats["backbone." + name].numpy(), ELT_REL, name)
    full = bb.SpMiddleFHD(num_input_features=4)
    assert (sum(p.numel() for p in m.parameters())
            < sum(p.numel() for p in full.parameters()))
