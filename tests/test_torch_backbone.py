"""PanoSwin backbone of the PyTorch port vs JAX, stage by stage.

Even-depth tiny configuration (embed 6, depths 2-2-2-2, heads 1-1-1-2,
window 4, absolute encoder) with the JAX init of the tiny detector's
backbone (`torch_port_common.tiny_detector`, the same configuration)
carried across by `from_jax_backbone`; every mode has the same parameters,
so one init serves the pano and the planar backbone.  A 32 x 96 input gives widths 24, 12, 6,
3, so the last stage runs the odd-width pad of the pano transition and the
planar stages pad 2 x 6 and 1 x 3 up to whole windows.  float32: atol 1e-4
(flax and torch LayerNorm take the variance differently, about 1e-6 apart,
and sums run in another order).  bfloat16: atol 0.05 on the f32 out-norms,
about three bf16 units at their largest values (2 to 4): the two frameworks
round at different places in eight blocks.

The port's fused route (kernel K2's twin) is held against the same JAX
references as its plain route, in f32: the JAX package's own test shows its
fused and plain backbones agree to 3e-5 (`tests/test_fused_attention.py`),
so no interpret-mode JAX backbone is needed.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from panoswintransformerobjectdetection_tpu.models.panoswin import (
    PanoSwinTransformer as JaxBackbone)
from panoswintransformerobjectdetection_torch.models.panoswin import PanoSwinTransformer
from panoswintransformerobjectdetection_torch.runtime.checkpoint import from_jax_backbone
from torch_port_common import quick_jit, single_torch_thread, tiny_detector  # noqa: F401

CFG = {"embed_dim": 6, "depths": (2, 2, 2, 2), "num_heads": (1, 1, 1, 2),
       "window_size": 4, "ape": True}


@pytest.fixture(scope="module")
def jax_backbone():
    """(variables, x, reference(pano_mode, dtype)): each JAX backbone is
    applied once per mode and dtype."""
    x = np.random.default_rng(0).random((2, 32, 96, 3)).astype(np.float32)
    detector = tiny_detector()["variables"]
    variables = {"params": detector["params"]["backbone_m"],
                 "batch_stats": detector["batch_stats"]["backbone_m"]}
    refs = {}

    def reference(pano_mode, dtype):
        if (pano_mode, dtype) not in refs:
            jmod = JaxBackbone(**CFG, drop_path_rate=0.0, pano_mode=pano_mode,
                               dtype=jnp.dtype(dtype))
            refs[pano_mode, dtype] = quick_jit(jmod.apply, variables, jnp.asarray(x))
        return refs[pano_mode, dtype]

    return variables, x, reference


@pytest.mark.parametrize("pano_mode,fused,dtype", [
    pytest.param(True, False, "float32", id="float32"),
    pytest.param(True, False, "bfloat16", id="bfloat16"),
    pytest.param(False, False, "float32", id="planar-float32"),
    pytest.param(False, False, "bfloat16", id="planar-bfloat16"),
    pytest.param(True, True, "float32", id="fused-float32"),
    pytest.param(False, True, "float32", id="fused-planar-float32"),
])
def test_stages_match_jax(jax_backbone, pano_mode, fused, dtype):
    variables, x, reference = jax_backbone
    ref = reference(pano_mode, dtype)
    port = PanoSwinTransformer(**CFG, pano_mode=pano_mode, fused_attention=fused,
                               dtype=getattr(torch, dtype)).eval()
    port.load_state_dict(from_jax_backbone(jax.tree.map(np.asarray, variables["params"]),
                                           jax.tree.map(np.asarray, variables["batch_stats"])))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert len(got) == len(ref) == 4
    tol = 1e-4 if dtype == "float32" else 0.05
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == torch.float32 and tuple(g.shape) == r.shape, i
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=tol, err_msg=f"stage {i}")


def test_odd_depth_not_ported():
    """Odd depths were not ported before PitchAttention came: a stage of odd
    depth now ends with a PitchAttention block (held against JAX in
    `test_torch_pitch_attention.py`), and activation checkpointing builds
    (its gradients are held against the plain path's in
    `test_torch_train_loop.py`)."""
    from panoswintransformerobjectdetection_torch.models.panoswin import PitchAttention
    port = PanoSwinTransformer(embed_dim=6, depths=(1, 2, 3, 2), num_heads=(1, 1, 1, 2),
                               window_size=4)
    kinds = [[type(b).__name__ for b in layer.blocks] for layer in port.layers]
    assert kinds == [["PitchAttention"], ["PanoSwinBlock"] * 2,
                     ["PanoSwinBlock"] * 2 + ["PitchAttention"], ["PanoSwinBlock"] * 2]
    assert isinstance(port.layers[2].blocks[2], PitchAttention)
    checkpointed = PanoSwinTransformer(embed_dim=6, depths=(1, 2, 2, 2), num_heads=(1, 1, 1, 2),
                                       window_size=4, use_checkpoint=True)
    assert all(layer.use_checkpoint for layer in checkpointed.layers)
