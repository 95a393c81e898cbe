"""PyTorch port vs JAX: uv grid, haversine, window layout, the pano and
planar window transitions, odd widths included, and the planar shift mask.  Layout ops must match exactly;
trigonometry (haversine) within 1e-6, since XLA and PyTorch may differ in
the last bit of sin/cos/arcsin."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from panoswintransformerobjectdetection_tpu.geometry import sphere as jsphere
from panoswintransformerobjectdetection_tpu.geometry import axis as jaxis
from panoswintransformerobjectdetection_tpu.ops import windows as jwin
from panoswintransformerobjectdetection_torch.geometry import axis as taxis
from panoswintransformerobjectdetection_torch.geometry import sphere as tsphere
from panoswintransformerobjectdetection_torch.ops import windows as twin
from torch_port_common import single_torch_thread  # noqa: F401


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("hw", [(4, 8), (7, 14), (16, 32), (5, 9)])
def test_make_uv_grid_exact(hw):
    np.testing.assert_array_equal(tsphere.make_uv_grid(*hw).numpy(),
                                  np.asarray(jsphere.make_uv_grid(*hw)))


def test_haversine():
    uv1 = _rand((3, 10, 2), 1)
    uv2 = _rand((3, 12, 2), 2)
    np.testing.assert_allclose(
        tsphere.haversine(torch.from_numpy(uv1), torch.from_numpy(uv2)).numpy(),
        np.asarray(jsphere.haversine(jnp.asarray(uv1), jnp.asarray(uv2))), atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 4, 8, 3), (1, 6, 5, 2), (1, 3, 7, 4)])
def test_ew2ns_ns2we_exact(shape):
    x = _rand(shape)
    if shape[2] % 2 == 0:
        np.testing.assert_array_equal(taxis.ew2ns(torch.from_numpy(x)).numpy(),
                                      np.asarray(jaxis.ew2ns(jnp.asarray(x))))
    if shape[1] % 2 == 0:
        np.testing.assert_array_equal(taxis.ns2we(torch.from_numpy(x)).numpy(),
                                      np.asarray(jaxis.ns2we(jnp.asarray(x))))


@pytest.mark.parametrize("ws", [2, 4, 7])
def test_window_partition_reverse_exact(ws):
    x = _rand((2, 2 * ws, 3 * ws, 5))
    got = twin.window_partition(torch.from_numpy(x), ws)
    ref = jwin.window_partition(jnp.asarray(x), ws)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    back = twin.window_reverse(got, ws, 2 * ws, 3 * ws)
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("ws", [4, 7])
def test_relative_position_index_exact(ws):
    np.testing.assert_array_equal(twin.make_relative_position_index(ws),
                                  jwin.make_relative_position_index(ws))


@pytest.mark.parametrize("shape,shift", [
    ((2, 4, 8, 3), 0), ((2, 4, 8, 3), 2), ((1, 2, 3, 2), 0), ((1, 2, 3, 2), 2),
    ((1, 8, 13, 4), 3), ((1, 16, 32, 2), 3)])
def test_window_transition_roundtrip_exact(shape, shift):
    """Forward shift matches JAX; the reverse matches JAX and undoes it."""
    x = _rand(shape)
    got = twin.window_transition(torch.from_numpy(x), shift, True)
    ref = jwin.window_transition(jnp.asarray(x), shift, True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    odd = bool(shape[2] % 2)
    back = twin.window_transition_reverse(got, shift, True, width_was_odd=odd)
    ref_back = jwin.window_transition_reverse(ref, shift, True, width_was_odd=odd)
    np.testing.assert_array_equal(back.numpy(), np.asarray(ref_back))
    np.testing.assert_array_equal(back.numpy(), x)


def test_window_transition_unbatched_uv():
    """The uv side-band rides through the transition without a batch dim."""
    uv = tsphere.make_uv_grid(6, 9)
    got = twin.window_transition(uv, 2, True)
    ref = jwin.window_transition(jsphere.make_uv_grid(6, 9), 2, True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("shape,shift", [((2, 8, 8, 3), 2), ((1, 14, 21, 2), 3)])
def test_planar_window_transition_exact(shape, shift):
    x = _rand(shape)
    got = twin.window_transition(torch.from_numpy(x), shift, False)
    ref = jwin.window_transition(jnp.asarray(x), shift, False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    back = twin.window_transition_reverse(got, shift, False)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        jwin.window_transition_reverse(ref, shift, False)))
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("args", [(8, 8, 4, 2), (8, 24, 4, 2), (4, 4, 4, 2), (14, 21, 7, 3)])
def test_swin_attention_mask_exact(args):
    got = twin.swin_attention_mask(*args)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), jwin.swin_attention_mask(*args))
