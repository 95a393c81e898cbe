"""The PyTorch port's tiny flagship detector vs JAX, stage by stage, in f32.

The JAX `PanoFasterRCNN` (even-depth tiny configuration) is initialised,
its variables are carried across with `from_jax_variables`, and one jitted
JAX function returns every stage of `simple_test`.  Each port stage is fed
the JAX stage before it, so that one NMS decision near a threshold cannot
cascade into the next comparison.  Tolerances: dense stages atol 1e-4;
proposals and detections must keep the same slots (`mask` equal, labels
equal) with boxes within 1e-3 pixels and scores within 1e-5.  The port's
fused-attention detector (kernel K2's twin in every block) is held to the
same JAX reference with the same tolerances.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from panoswintransformerobjectdetection_tpu.models import DETECTORS, build
from panoswintransformerobjectdetection_tpu.models.detectors import default_test_cfg
from panoswintransformerobjectdetection_tpu.models.roi_head import bbox_head_detections
from panoswintransformerobjectdetection_tpu.models.rpn_head import rpn_proposals
from panoswintransformerobjectdetection_tpu.runtime.checkpoint import convert_detector
from panoswintransformerobjectdetection_torch.flagship import flagship_config
from panoswintransformerobjectdetection_torch.models import roi_head as troi
from panoswintransformerobjectdetection_torch.models import rpn_head as trpn
from panoswintransformerobjectdetection_torch.models.detectors import STAGES, PanoFasterRCNN
from panoswintransformerobjectdetection_torch.runtime.checkpoint import from_jax_variables

B, H, W = 2, 32, 64


def _jax_detector():
    cfg = flagship_config(tiny=True)
    backbone = dict(cfg["backbone"], type="PanoSwinTransformer", drop_path_rate=0.0)
    neck = dict(cfg["neck"], type="FPN")
    return build(DETECTORS, {"type": "PanoFasterRCNN", "backbone": backbone, "neck": neck,
                             "num_classes": cfg["num_classes"]})


def _stages(m, images, img_shapes):
    cfg = default_test_cfg()
    feats = m.extract_feat(images)
    cls, reg = m.rpn_m(feats)
    level_anchors, _ = m._anchors(cls)
    props = rpn_proposals(cls, reg, level_anchors, img_shapes,
                          target_stds=m.rpn_target_stds, **cfg["rpn"])
    P = props.boxes.shape[1]
    bidx = jnp.broadcast_to(jnp.arange(B, dtype=images.dtype)[:, None], (B, P))
    rois = jnp.concatenate([bidx[..., None], props.boxes], axis=-1)
    roi_feats = m._roi_extract(feats, rois.reshape(B * P, 5))
    c, r = m.bbox_head_m(roi_feats)
    dets = bbox_head_detections(c.reshape(B, P, -1), r.reshape(B, P, -1), rois, img_shapes,
                                m.num_classes, target_stds=m.rcnn_target_stds,
                                roi_mask=props.mask, **cfg["rcnn"])
    return {"feats": feats, "cls": cls, "reg": reg, "props": props, "rois": rois,
            "roi_feats": roi_feats, "head_cls": c, "head_reg": r, "dets": dets}


@pytest.fixture(scope="module")
def setup():
    det = _jax_detector()
    images = np.random.default_rng(0).random((B, H, W, 3)).astype(np.float32)
    img_shapes = np.array([[H, W]] * B, np.float32)
    variables = jax.jit(det.init)(jax.random.PRNGKey(0), jnp.asarray(images[:1]))
    ref = jax.jit(lambda v, x, s: det.apply(v, x, s, method=_stages))(
        variables, jnp.asarray(images), jnp.asarray(img_shapes))
    ref = jax.tree.map(lambda a: torch.tensor(np.asarray(a)), ref)
    port = PanoFasterRCNN(**flagship_config(tiny=True)).eval()
    port.load_state_dict(from_jax_variables(jax.tree.map(np.asarray, variables["params"]),
                                            jax.tree.map(np.asarray, variables["batch_stats"])))
    return {"variables": variables, "images": torch.from_numpy(images),
            "img_shapes": torch.from_numpy(img_shapes), "ref": ref, "port": port}


def _close(got, ref, atol=1e-4):
    assert tuple(got.shape) == tuple(ref.shape)
    np.testing.assert_allclose(got.detach().numpy(), ref.numpy(), atol=atol)


def _same_slots(got, ref):
    """Masked slots of a DetResult / Proposals: same slots, close values."""
    assert torch.equal(got.mask, ref.mask)
    m = ref.mask
    _close(got.boxes[m], ref.boxes[m], atol=1e-3)
    _close(got.scores[m], ref.scores[m], atol=1e-5)
    if hasattr(ref, "labels"):
        assert torch.equal(got.labels.int(), ref.labels.int())


def test_fpn_maps(setup):
    with torch.no_grad():
        feats = setup["port"].extract_feat(setup["images"])
    assert len(feats) == 5
    for g, r in zip(feats, setup["ref"]["feats"]):
        _close(g, r)


def test_rpn_logits(setup):
    with torch.no_grad():
        cls, reg = setup["port"].rpn_head(setup["ref"]["feats"])
    for g, r in zip(cls + reg, setup["ref"]["cls"] + setup["ref"]["reg"]):
        _close(g, r)


def test_proposals(setup):
    ref, port = setup["ref"], setup["port"]
    anchors = port.anchor_gen.grid_anchors([tuple(c.shape[1:3]) for c in ref["cls"]])
    got = trpn.rpn_proposals(ref["cls"], ref["reg"], anchors, setup["img_shapes"],
                             **port.test_cfg["rpn"])
    assert got.mask.any()
    _same_slots(got, ref["props"])


def test_roi_features(setup):
    ref = setup["ref"]
    with torch.no_grad():
        got = setup["port"].roi_features(ref["feats"], ref["rois"].reshape(-1, 5))
    _close(got, ref["roi_feats"])


def test_head_logits(setup):
    ref = setup["ref"]
    with torch.no_grad():
        c, r = setup["port"].roi_head.bbox_head(ref["roi_feats"])
    _close(c, ref["head_cls"])
    _close(r, ref["head_reg"])


def test_detections(setup):
    ref = setup["ref"]
    P = ref["rois"].shape[1]
    got = troi.bbox_head_detections(ref["head_cls"].reshape(B, P, -1),
                                    ref["head_reg"].reshape(B, P, -1), ref["rois"],
                                    setup["img_shapes"], roi_mask=ref["props"].mask,
                                    **setup["port"].test_cfg["rcnn"])
    assert got.mask.any()
    _same_slots(got, ref["dets"])


def test_simple_test_end_to_end(setup):
    got = setup["port"].simple_test(setup["images"], setup["img_shapes"])
    _same_slots(got, setup["ref"]["dets"])
    assert torch.all(got.scores[~got.mask] == -1e10)
    assert torch.all(got.labels[~got.mask] == -1)


def test_simple_test_fused_attention(setup):
    """`fused_attention=True` with the same weights: the JAX package's fused
    and plain backbones agree to 3e-5 (`tests/test_fused_attention.py`), so
    the plain JAX reference serves."""
    port = PanoFasterRCNN(**flagship_config(tiny=True, fused_attention=True)).eval()
    port.load_state_dict(setup["port"].state_dict())
    assert all(blk.attn.fused for layer in port.backbone.layers for blk in layer.blocks)
    got = port.simple_test(setup["images"], setup["img_shapes"])
    _same_slots(got, setup["ref"]["dets"])


def test_simple_test_stage_hook(setup):
    """Each stage runs once through the hook, in `STAGES` order, and the
    hook changes nothing in the result."""
    seen = []

    def stage(name, fn):
        seen.append(name)
        return fn()

    port = setup["port"]
    got = port.simple_test(setup["images"], setup["img_shapes"], stage=stage)
    ref = port.simple_test(setup["images"], setup["img_shapes"])
    assert tuple(seen) == STAGES
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_convert_detector_rebuilds_jax_tree(setup):
    """The port's state dict is in the reference layout: the JAX converter
    turns it back into the JAX init tree, key for key and shape for shape."""
    sd = {k: v.numpy() for k, v in setup["port"].state_dict().items()}
    params, stats = convert_detector(sd, depths=(2, 2, 2, 2), window_size=4)
    shapes = lambda t: jax.tree.map(np.shape, t)    # noqa: E731
    assert shapes(params) == shapes(jax.tree.map(np.asarray, setup["variables"]["params"]))
    assert shapes(stats) == shapes(
        jax.tree.map(np.asarray, setup["variables"]["batch_stats"]))
    np.testing.assert_array_equal(
        params["bbox_head_m"]["shared_fc0"]["kernel"],
        np.asarray(setup["variables"]["params"]["bbox_head_m"]["shared_fc0"]["kernel"]))
