"""PanoSwin backbone of the PyTorch port vs JAX, stage by stage.

Even-depth tiny configuration (embed 6, depths 2-2-2-2, heads 1-1-1-2,
window 4, absolute encoder) with the JAX init carried across by
`from_jax_backbone`; every mode has the same parameters, so one init serves
the pano and the planar backbone.  A 32 x 96 input gives widths 24, 12, 6,
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

CFG = {"embed_dim": 6, "depths": (2, 2, 2, 2), "num_heads": (1, 1, 1, 2),
       "window_size": 4, "ape": True}


@pytest.fixture(scope="module")
def jax_backbone():
    """(variables, x, reference(pano_mode, dtype)): each JAX backbone is
    applied once per mode and dtype."""
    x = np.random.default_rng(0).random((2, 32, 96, 3)).astype(np.float32)
    mod = JaxBackbone(**CFG, drop_path_rate=0.0)
    variables = jax.jit(mod.init)(jax.random.PRNGKey(0), jnp.asarray(x[:1]))
    refs = {}

    def reference(pano_mode, dtype):
        if (pano_mode, dtype) not in refs:
            jmod = JaxBackbone(**CFG, drop_path_rate=0.0, pano_mode=pano_mode,
                               dtype=jnp.dtype(dtype))
            refs[pano_mode, dtype] = jax.jit(jmod.apply)(variables, jnp.asarray(x))
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
    with pytest.raises(NotImplementedError, match="PitchAttention"):
        PanoSwinTransformer(embed_dim=6, depths=(1, 2, 2, 2), num_heads=(1, 1, 1, 2),
                            window_size=4)
