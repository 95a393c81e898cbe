"""Guards of the PyTorch port: it imports no JAX, nothing of the JAX
package and no OpenCV, and its entry points run on the card unless told
otherwise."""

import importlib
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import panoswintransformerobjectdetection_torch as port
from panoswintransformerobjectdetection_torch.apis.inference import init_detector
from panoswintransformerobjectdetection_torch.apis.test import single_device_test
from panoswintransformerobjectdetection_torch.flagship import build_flagship
from panoswintransformerobjectdetection_torch.ops import fused_attention, roi_align, stem_conv
from panoswintransformerobjectdetection_torch.tools import image_demo
from panoswintransformerobjectdetection_torch.tools import test as test_cli
from panoswintransformerobjectdetection_torch.tools import train as train_cli

ROOT = Path(__file__).resolve().parent.parent
PORT_DIR = Path(port.__file__).resolve().parent


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PORT_DIR)], port.__name__ + "."))


def test_every_module_imports_without_jax():
    """Importing every module of the port loads neither JAX nor OpenCV (the
    card's machine has no OpenCV; reading an image file imports it then)."""
    names = _modules()
    assert len(names) >= 30
    code = ("import sys, importlib\nsys.modules['jax'] = None\nsys.modules['cv2'] = None\n"
            f"for n in {names!r}:\n    importlib.import_module(n)\n"
            "assert not any(k in ('jax', 'cv2') or k.startswith(('jax.', 'cv2.', "
            "'panoswintransformerobjectdetection_tpu'))"
            " for k, v in sys.modules.items() if v is not None)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in
                                        [*PORT_DIR.rglob("*.py"), *PORT_DIR.rglob("*.cu"),
                                         ROOT / "chip_smoke.py"]))
def test_sources_import_no_jax(path):
    """File:line references to the JAX package are fine; imports are not."""
    text = (ROOT / path).read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|flax|panoswintransformerobjectdetection_tpu)\b",
                         text, re.M)
    assert not re.search(r"import_module\(\s*['\"](jax|flax|panoswintransformerobjectdetection_tpu)",
                         text)


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_flagship(tiny=True)
    nano = str(ROOT / "configs" / "panoswin" / "faster_rcnn_panoswin_nano_demo.py")
    mask = str(ROOT / "configs" / "swin" / "mask_rcnn_swin_tiny_patch4_window7_coco.py")
    for config in (nano, mask):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_detector(config)
    model = build_flagship(tiny=True, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        single_device_test(model, [])
    for main in (test_cli.main, train_cli.main,
                 lambda args: image_demo.main(["frame.jpg", *args])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([nano])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        test_cli.main([mask, "--eval", "bbox", "segm"])


def test_cpu_tensors_take_the_twins():
    """On the CPU a wrapper runs its plain twin and counts no launch."""
    wa = fused_attention.window_attention
    counted = (stem_conv.stem_conv, roi_align.roi_align, roi_align.roi_align_backward,
               roi_align.dense_crop, wa)
    before = [fn.launches for fn in counted]
    entries = [fn.last_entry for fn in counted if hasattr(fn, "last_entry")]
    args = (torch.rand(1, 8, 8, 3), torch.rand(2, 3, 3, 3), torch.rand(2),
            torch.rand(4, 2, 3, 3), torch.rand(4))
    packed = stem_conv.stem_weights(*args[1:], torch.float32)
    assert torch.equal(stem_conv.stem_conv(args[0], packed), stem_conv.stem_conv_plain(*args))
    feats = [torch.rand(1, 8 // s, 16 // s, 4) for s in (1, 2, 4, 8)]
    rois = torch.tensor([[0.0, 1.0, 2.0, 20.0, 12.0]])
    by_entry = dict(roi_align.roi_align.launches_by_entry)
    out = roi_align.roi_align(feats, rois, (4, 8, 16, 32))
    assert out.shape == (1, 7, 7, 4)
    mask_out = roi_align.roi_align(feats, rois, (4, 8, 16, 32), 14)
    assert torch.equal(mask_out, roi_align.roi_align_plain(feats, rois, (4, 8, 16, 32), 14))
    assert mask_out.shape == (1, 14, 14, 4) and roi_align.roi_align.launches_by_entry == by_entry
    grads = roi_align.roi_align_backward(torch.ones_like(out), rois, [f.shape for f in feats],
                                         torch.float32, (4, 8, 16, 32))
    assert [g.shape for g in grads] == [f.shape for f in feats] and grads[0].any()
    dense = roi_align.multilevel_roi_align_dense(feats, rois, (4, 8, 16, 32))
    assert torch.allclose(dense, out, atol=1e-5)
    crop_args = (feats[0], torch.rand(1, 2, 7, 8), torch.rand(1, 2, 7, 16))
    assert torch.equal(roi_align.dense_crop(*crop_args), roi_align.dense_crop_plain(*crop_args))
    q, k, v = (torch.rand(4, 2, 9, 8) for _ in range(3))
    bias = torch.rand(2, 2, 9, 9)
    plain = fused_attention.window_attention_plain(q, k, v, bias, 0.5)
    for entry in (wa, fused_attention.fused_window_attention,
                  fused_attention.packed_window_attention):
        assert torch.equal(entry(q, k, v, bias, 0.5), plain)
    assert [fn.launches for fn in counted] == before
    assert [fn.last_entry for fn in counted if hasattr(fn, "last_entry")] == entries


def test_modules_list_covers_the_slice():
    names = set(_modules())
    for sub in ("geometry.sphere", "ops.windows", "ops.stem_conv", "ops.roi_align",
                "ops.fused_attention", "ops.nms", "ops.autograd",
                "models.panoswin", "models.fpn", "models.rpn_head", "models.roi_head",
                "models.detectors", "core.anchors", "core.bbox", "core.assigner",
                "core.sampler", "core.losses", "runtime.checkpoint", "runtime.optim",
                "runtime.train", "flagship", "profile_flagship", "geometry.rotate",
                "geometry.resample", "runtime.config", "data.transforms", "apis.inference",
                "apis.tta", "core.rle", "core.cocoeval", "core.evaluation", "core.class_names",
                "native", "geometry.projection", "data.datasets", "data.wrappers",
                "data.builder", "data.loader", "apis.test", "utils.visualize", "tools.test",
                "tools.eval_metric", "tools.image_demo", "runtime.hooks", "apis.train",
                "tools.train", "models.layers", "models.swin", "models.mask_head",
                "data.fill_poly", "parallel", "parallel.dist", "parallel.spatial"):
        assert f"{port.__name__}.{sub}" in names
        importlib.import_module(f"{port.__name__}.{sub}")


def test_init_distributed_never_picks_gloo_on_its_own(monkeypatch):
    """`device=None` means the card: NCCL there, and without a card it
    raises rather than falling back to gloo; gloo only for `device="cpu"` or
    when named."""
    from panoswintransformerobjectdetection_torch.parallel import dist as pdist
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": "29999"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = []
    monkeypatch.setattr(pdist.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(pdist.dist, "init_process_group",
                        lambda backend, **kw: calls.append(backend))
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: calls.append(f"card {i}"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pdist.init_distributed("pytorch")
    assert calls == []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert pdist.init_distributed("pytorch") == (0, 1)
    assert calls == ["card 0", "nccl"]
    pdist.init_distributed("pytorch", backend="gloo")
    pdist.init_distributed("pytorch", device="cpu")
    assert calls[2:] == ["card 0", "gloo", "gloo"]


def test_no_wrapper_gives_way_to_its_twin():
    """A wrapper reaches its plain version only under a test of the tensor's
    device, never from an exception handler; and every kernel source is
    built from `csrc/` into `build/torch_kernels/`."""
    from panoswintransformerobjectdetection_torch.ops import cuda_build
    for module in (stem_conv, roi_align, fused_attention, cuda_build):
        text = Path(module.__file__).read_text()
        assert not re.search(r"^\s*(try|except)\b", text, re.M), module.__name__
    assert set(cuda_build.SOURCES) == {p.stem for p in cuda_build.CSRC_DIR.glob("*.cu")}
    assert "dense_crop" in cuda_build.SOURCES
    assert cuda_build.BUILD_DIR == ROOT / "build" / "torch_kernels"
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "build/" in ignored and "*.so" in ignored
    for name in ("roi_align_launch", "roi_align_backward_launch"):
        assert f'extern "C" int {name}(' in (cuda_build.CSRC_DIR / "roi_align.cu").read_text()
    # K3's backward: one entry a type, the bf16 one with no atomics
    source = (cuda_build.CSRC_DIR / "roi_align.cu").read_text()
    assert set(roi_align.BACKWARD_ENTRIES) == {torch.float32, torch.bfloat16}
    for symbol in roi_align.BACKWARD_ENTRIES.values():
        assert f'extern "C" int {symbol}(' in source
    owner = source[source.index("namespace owner {"):source.index("}  // namespace owner")]
    assert "atomic" not in owner
    # K1, K2, K3's forward and K4: one entry a type in one source, each
    # declared there; the tensor-core sources issue `mma` and `ldmatrix`, and
    # no source calls a library
    for name, entries, tensor_cores in (("stem_conv", stem_conv.ENTRIES, True),
                                        ("dense_crop", roi_align.CROP_ENTRIES, True),
                                        ("window_attention", fused_attention.ENTRIES, True),
                                        ("roi_align", roi_align.ENTRIES, False)):
        source = (cuda_build.CSRC_DIR / f"{name}.cu").read_text()
        assert set(entries) == {torch.float32, torch.bfloat16}
        assert len(set(entries.values())) == 2
        for symbol in entries.values():
            assert f'extern "C" int {symbol}(' in source
        if tensor_cores:
            assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in source
            assert "ldmatrix" in source
        assert not re.search(r"cublas|cudnn|cutlass::gemm|#include\s*<torch", source, re.I)
