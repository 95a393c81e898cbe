"""One process of `test_torch_distributed.py`'s two-process gloo run.

    RANK=r WORLD_SIZE=2 LOCAL_RANK=r MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_distributed_worker.py <inputs.pkl> <out_dir>

It joins the process group as torchrun's workers do
(`parallel/dist.init_distributed`), runs every case of the test module on
its rows of the global batches in `inputs.pkl` (written by the test), and
writes what each case gives to `<out_dir>/rank{r}.pt`.  Both processes run
the cases in one order, so that their collectives pair up.  It imports
PyTorch and the port, never JAX.
"""

import os
import pickle
import sys

sys.modules["jax"] = None          # the port's distributed path must not need it

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.nn.parallel import DistributedDataParallel  # noqa: E402

from panoswintransformerobjectdetection_torch.apis import test as tapi_test  # noqa: E402
from panoswintransformerobjectdetection_torch.apis import train as tapi  # noqa: E402
from panoswintransformerobjectdetection_torch.apis.inference import (  # noqa: E402
    build_detector_from_cfg)
from panoswintransformerobjectdetection_torch.data.builder import build_dataset  # noqa: E402
from panoswintransformerobjectdetection_torch.flagship import (build_flagship,  # noqa: E402
                                                               flagship_config, init_weights)
from panoswintransformerobjectdetection_torch.models import mask_head  # noqa: E402
from panoswintransformerobjectdetection_torch.models.detectors import PanoFasterRCNN  # noqa: E402
from panoswintransformerobjectdetection_torch.models.layers import (DropPath,  # noqa: E402
                                                                    batch_norm_train)
from panoswintransformerobjectdetection_torch.parallel import dist as pdist  # noqa: E402
from panoswintransformerobjectdetection_torch.parallel.spatial import sharded_roll  # noqa: E402
from panoswintransformerobjectdetection_torch.runtime import optim, train  # noqa: E402
from panoswintransformerobjectdetection_torch.tools import test as test_cli  # noqa: E402
from panoswintransformerobjectdetection_torch.tools import train as train_cli  # noqa: E402


def rows(t, r, b):
    return t[r * b:(r + 1) * b]


def batch_norm(inp, r):
    """`batch_norm_train` on this process's half of each seeded batch; the
    affine parameters' gradients summed over the processes, as DDP would."""
    out = {}
    for name, case in inp.items():
        x = rows(torch.from_numpy(case["x"]), r, 2).requires_grad_(True)
        bn = torch.nn.BatchNorm2d(x.shape[1], eps=case["eps"], momentum=case["momentum"])
        bn = bn.to(x.dtype if x.dtype == torch.float64 else torch.float32)
        with torch.no_grad():
            for k in ("weight", "bias", "running_mean", "running_var"):
                getattr(bn, k).copy_(torch.from_numpy(case[k]))
        y = batch_norm_train(bn, x)
        (y * rows(torch.from_numpy(case["g"]), r, 2)).sum().backward()
        for p in (bn.weight, bn.bias):
            dist.all_reduce(p.grad)
        out[name] = {"y": y.detach(), "dx": x.grad, "dweight": bn.weight.grad,
                     "dbias": bn.bias.grad, "running_mean": bn.running_mean.clone(),
                     "running_var": bn.running_var.clone()}
    return out


def roll(inp, r, world):
    x = torch.from_numpy(inp["x"])
    w = x.shape[2] // world
    return {shift: sharded_roll(x[:, :, r * w:(r + 1) * w], shift) for shift in inp["shifts"]}


def flagship_steps(inp, r):
    """The tiny flagship's two steps on this process's image of each global
    batch of 2, with its rows of JAX's sampler noise."""
    model = PanoFasterRCNN(**flagship_config(tiny=True), train_cfg=inp["train_cfg"]).train()
    model.load_state_dict(inp["state_dict"])
    optimizer, scheduler = optim.make_optimizer(model, base_lr=inp["lr"], warmup_iters=0)
    step = train.make_train_step(model, optimizer, scheduler)
    metrics = []
    for noise in inp["noise"]:
        batch = {k: rows(torch.from_numpy(v), r, 1) for k, v in inp["batch"].items()}
        local = {k: tuple(rows(t, r, 1) for t in v) for k, v in noise.items()}
        metrics.append({k: float(v) for k, v in step(batch, noise=local).items()})
    return {"metrics": metrics, "state": model.state_dict(),
            "ddp": isinstance(step.ddp, DistributedDataParallel)}


def mask_step(inp, r):
    """The tiny Mask R-CNN's step on this process's image; before it, the
    same forward with the mask loss's normaliser left local (each process's
    own positives) and, after it, a plain DDP's gradient (the mean)."""
    def build():
        model = build_detector_from_cfg({"model": inp["cfg"]})
        init_weights(model, inp["seed"])
        return model.train()

    batch = {k: rows(torch.from_numpy(v), r, 1) for k, v in inp["batch"].items()}
    args = [batch[k] for k in ("images", "img_shapes", "gt_boxes", "gt_labels", "gt_valid",
                               "gt_masks")]
    model = build()
    counts = []
    loss = mask_head.mask_head_loss

    def local_loss(logits, targets, labels, weights):
        counts.append(float(weights.sum()))
        return loss(logits, targets, labels, weights)

    detectors = sys.modules[PanoFasterRCNN.__module__]
    with torch.no_grad():
        detectors.mask_head_loss, summed = local_loss, mask_head.all_reduce_sum
        mask_head.all_reduce_sum = lambda t: t
        try:
            local = model.forward_train(*args, generator=torch.Generator().manual_seed(7))
        finally:
            detectors.mask_head_loss, mask_head.all_reduce_sum = loss, summed
    optimizer, scheduler = optim.make_optimizer(model, base_lr=1e-2, warmup_iters=0)
    step = train.make_train_step(model, optimizer, scheduler)
    metrics = step(batch, generator=torch.Generator().manual_seed(7))
    grads = {n: None if p.grad is None else p.grad.clone() for n, p in model.named_parameters()}
    plain = build()
    ddp = DistributedDataParallel(plain, find_unused_parameters=True)
    out = ddp(*args, generator=torch.Generator().manual_seed(7))
    sum(v for k, v in out.items() if "loss" in k).backward()
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": grads,
            "state": model.state_dict(), "local_loss_mask": float(local["loss_mask"]),
            "positives": counts[0],
            "plain_ddp_grads": {n: p.grad for n, p in plain.named_parameters()
                                if p.grad is not None}}


def drop_path(r, world):
    """DropPath's keep mask for 2 rows a process against the global draw."""
    m = DropPath(0.5).train()
    m.generator = torch.Generator().manual_seed(3)
    got = m.keep_mask(torch.zeros(2, 4, 4, 3))
    return {"got": got, "global": torch.rand((2 * world, 1, 1, 1),
                                             generator=torch.Generator().manual_seed(3)) < 0.5}


def loops(inp, r):
    """`train_detector` over the loader shards: two epochs, the same run
    resumed from `epoch_1`, and one epoch with `accumulate_steps=2`."""
    saves = []
    save = tapi.save_checkpoint

    def recording(path, *args, **kwargs):
        saves.append(os.path.basename(path))
        return save(path, *args, **kwargs)

    tapi.save_checkpoint = recording
    out = {}
    try:
        for name, extra in (("full", {}), ("resumed", {"resume_from": "full/epoch_1"}),
                            ("accumulated", {"accumulate_steps": 2, "total_epochs": 1})):
            model = build_flagship(tiny=True, device="cpu", train=True,
                                   drop_path_rate=inp["drop_path_rate"])
            kwargs = dict(inp["loop"], **extra)
            if "resume_from" in kwargs:
                kwargs["resume_from"] = os.path.join(inp["root"], kwargs["resume_from"])
            saves.clear()
            tapi.train_detector(model, build_dataset(dict(inp["dataset"])),
                                work_dir=os.path.join(inp["root"], name), device="cpu", **kwargs)
            out[name] = {"state": model.state_dict(), "saves": list(saves)}
    finally:
        tapi.save_checkpoint = save
    return out


def multi_host(inp):
    model = build_flagship(tiny=True, device="cpu", seed=inp["seed"])
    return tapi_test.multi_host_test(model, build_dataset(dict(inp["dataset"])), device="cpu")


def clis(inp):
    """`tools.train` and `tools.test` with `--launcher pytorch` on the nano
    config."""
    work = os.path.join(inp["root"], "cli_train")
    train_cli.main([inp["config"], "--work-dir", work, "--launcher", "pytorch", "--device",
                    "cpu", "--pad-to", *map(str, inp["pad_to"]), "--cfg-options",
                    *inp["options"]])
    ckpt = torch.load(os.path.join(work, "latest"), weights_only=True)
    pth = os.path.join(inp["root"], "cli.pth")
    if dist.get_rank() == 0:
        torch.save({"state_dict": ckpt["state_dict"]}, pth)
    dist.barrier()
    metrics = test_cli.main([inp["config"], pth, "--launcher", "pytorch", "--device", "cpu"])
    return {"state": ckpt["state_dict"], "metrics": metrics}


def main(inputs_path, out_dir):
    torch.set_num_threads(1)
    with open(inputs_path, "rb") as f:
        inp = pickle.load(f)
    r, world = pdist.init_distributed("pytorch", device="cpu")
    out = {"world": pdist.world(), "rank": pdist.rank(), "backend": dist.get_backend()}
    out["batch_norm"] = batch_norm(inp["batch_norm"], r)
    out["roll"] = roll(inp["roll"], r, world)
    out["drop_path"] = drop_path(r, world)
    out["flagship"] = flagship_steps(inp["flagship"], r)
    out["mask"] = mask_step(inp["mask"], r)
    out["loops"] = loops(inp["loops"], r)
    out["multi_host"] = multi_host(inp["multi_host"])
    out["cli"] = clis(inp["cli"])
    torch.save(out, os.path.join(out_dir, f"rank{r}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    print("WORKER_OK", r, flush=True)


if __name__ == "__main__":
    main(*sys.argv[1:3])
