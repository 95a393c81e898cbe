"""Guards of the PyTorch port: it imports no JAX and nothing of the JAX
package, and its entry points run on the card unless told otherwise."""

import importlib
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import panoswintransformerobjectdetection_torch as port
from panoswintransformerobjectdetection_torch.flagship import build_flagship
from panoswintransformerobjectdetection_torch.ops import fused_attention, roi_align, stem_conv

ROOT = Path(__file__).resolve().parent.parent
PORT_DIR = Path(port.__file__).resolve().parent


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PORT_DIR)], port.__name__ + "."))


def test_every_module_imports_without_jax():
    names = _modules()
    assert len(names) >= 15
    code = ("import sys, importlib\nsys.modules['jax'] = None\n"
            f"for n in {names!r}:\n    importlib.import_module(n)\n"
            "assert not any(k == 'jax' or k.startswith(('jax.', 'panoswintransformerobjectdetection_tpu'))"
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


def test_cpu_tensors_take_the_twins():
    """On the CPU a wrapper runs its plain twin and counts no launch."""
    wa = fused_attention.window_attention
    s0, r0, a0 = stem_conv.stem_conv.launches, roi_align.roi_align.launches, wa.launches
    args = (torch.rand(1, 8, 8, 3), torch.rand(2, 3, 3, 3), torch.rand(2),
            torch.rand(4, 2, 3, 3), torch.rand(4))
    packed = stem_conv.stem_weights(*args[1:], torch.float32)
    assert torch.equal(stem_conv.stem_conv(args[0], packed), stem_conv.stem_conv_plain(*args))
    feats = [torch.rand(1, 8 // s, 16 // s, 4) for s in (1, 2, 4, 8)]
    rois = torch.tensor([[0.0, 1.0, 2.0, 20.0, 12.0]])
    out = roi_align.roi_align(feats, rois, (4, 8, 16, 32))
    assert out.shape == (1, 7, 7, 4)
    q, k, v = (torch.rand(4, 2, 9, 8) for _ in range(3))
    bias = torch.rand(2, 2, 9, 9)
    plain = fused_attention.window_attention_plain(q, k, v, bias, 0.5)
    for entry in (wa, fused_attention.fused_window_attention,
                  fused_attention.packed_window_attention):
        assert torch.equal(entry(q, k, v, bias, 0.5), plain)
    assert (stem_conv.stem_conv.launches, roi_align.roi_align.launches, wa.launches) == (
        s0, r0, a0)


def test_modules_list_covers_the_slice():
    names = set(_modules())
    for sub in ("geometry.sphere", "ops.windows", "ops.stem_conv", "ops.roi_align",
                "ops.fused_attention", "ops.nms",
                "models.panoswin", "models.fpn", "models.rpn_head", "models.roi_head",
                "models.detectors", "core.anchors", "core.bbox", "runtime.checkpoint",
                "flagship"):
        assert f"{port.__name__}.{sub}" in names
        importlib.import_module(f"{port.__name__}.{sub}")
