"""Convert a Detectron (caffe2) ResNet `.pkl` to a reference-key `.pth`.

    python -m panoswintransformerobjectdetection_torch.tools.detectron2pytorch \\
        <src.pkl> <dst.pth> {50,101}

Counterpart of the JAX package's `tools/model_converters/detectron2jax.py`
(the reference's `tools/model_converters/detectron2pytorch.py`): the
caffe2 blobs `conv1_w`, `res_conv1_bn_{s,b}`, `res{i}_{j}_branch2{a,b,c}_w`,
`..._bn_{s,b}` and `res{i}_{j}_branch1[_bn]` become torchvision's keys
(`conv1`, `bn1`, `layer{i - 1}.{j}.conv{1,2,3}`, `bn{1,2,3}`,
`downsample.{0,1}`); an affine-channel layer becomes a BatchNorm of that
scale and bias with mean 0 and variance 1.  The classifier's blobs are left
out.  Writes `{"state_dict": ...}` with `torch.save`, which
`apis/train.apply_init_weights` takes as a ResNet `pretrained`.  Host
only: touches no device.
"""

import argparse
import pickle
import sys
from typing import Dict

import numpy as np
import torch

DEPTHS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


def load_blobs(path: str) -> Dict[str, np.ndarray]:
    """The blobs of a Detectron `.pkl` (a dict, under `blobs` or bare)."""
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    return data.get("blobs", data)


def detectron_to_reference(blobs: Dict[str, np.ndarray], depth: int) -> Dict[str, torch.Tensor]:
    """caffe2 blob names -> the reference's (torchvision's) state dict."""
    sd: Dict[str, torch.Tensor] = {}

    def conv(caffe, name):
        sd[name + ".weight"] = torch.from_numpy(np.array(blobs[caffe + "_w"], np.float32))
        if caffe + "_b" in blobs:
            sd[name + ".bias"] = torch.from_numpy(np.array(blobs[caffe + "_b"], np.float32))

    def affine(caffe, name):
        scale = torch.from_numpy(np.array(blobs[caffe + "_s"], np.float32))
        sd[name + ".weight"] = scale
        sd[name + ".bias"] = torch.from_numpy(np.array(blobs[caffe + "_b"], np.float32))
        sd[name + ".running_mean"] = torch.zeros_like(scale)
        sd[name + ".running_var"] = torch.ones_like(scale)

    conv("conv1", "conv1")
    affine("res_conv1_bn", "bn1")
    for i, blocks in enumerate(DEPTHS[depth]):
        for j in range(blocks):
            caffe, name = f"res{i + 2}_{j}", f"layer{i + 1}.{j}"
            if j == 0:
                conv(f"{caffe}_branch1", f"{name}.downsample.0")
                affine(f"{caffe}_branch1_bn", f"{name}.downsample.1")
            for n, sub in ((1, "a"), (2, "b"), (3, "c")):
                conv(f"{caffe}_branch2{sub}", f"{name}.conv{n}")
                affine(f"{caffe}_branch2{sub}_bn", f"{name}.bn{n}")
    return sd


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("src", help="Detectron .pkl weight file")
    p.add_argument("dst", help="output .pth")
    p.add_argument("depth", type=int, choices=sorted(DEPTHS))
    args = p.parse_args(argv)
    sd = detectron_to_reference(load_blobs(args.src), args.depth)
    torch.save({"state_dict": sd}, args.dst)
    print(f"converted {len(sd)} tensors -> {args.dst}")


if __name__ == "__main__":
    main(sys.argv[1:])
