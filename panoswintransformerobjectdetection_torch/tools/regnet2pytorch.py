"""Convert a pycls RegNet checkpoint to a reference-key `.pth`.

    python -m panoswintransformerobjectdetection_torch.tools.regnet2pytorch \\
        <src.pyth> <dst.pth>

Counterpart of the JAX package's `tools/model_converters/regnet2jax.py`
(the reference's `tools/model_converters/regnet2mmdet.py`): the file's
`model_state` through `runtime/checkpoint.regnet_from_pycls` (`stem.conv`,
`stem.bn` -> `conv1`, `bn1`; `s{i}.b{j}.f.{a,b,c}[_bn]` ->
`layer{i}.{j - 1}.conv{1,2,3}`, `bn{1,2,3}`; `proj`, `bn` ->
`downsample.0`, `.1`; the head left out), written as `{"state_dict": ...}`
with `torch.save`.  `apis/train.apply_init_weights` takes either file as a
RegNet `pretrained`.  Host only: touches no device.
"""

import argparse
import sys


def main(argv=None):
    from ..runtime.checkpoint import load_torch_state_dict, regnet_from_pycls
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("src", help="pycls .pyth/.pth checkpoint")
    p.add_argument("dst", help="output .pth")
    args = p.parse_args(argv)
    import torch
    sd = load_torch_state_dict(args.src)
    sd = regnet_from_pycls(sd.get("model_state", sd))
    torch.save({"state_dict": sd}, args.dst)
    print(f"converted {len(sd)} tensors -> {args.dst}")


if __name__ == "__main__":
    main(sys.argv[1:])
