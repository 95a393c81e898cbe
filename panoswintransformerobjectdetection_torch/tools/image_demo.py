"""Detect objects in one image and draw them (the reference's
`demo/image_demo.py`).

    python -m panoswintransformerobjectdetection_torch.tools.image_demo <img> <config> \\
        [<checkpoint>] [--score-thr 0.3] [--out-file out.jpg] [--dump-json dets.json]

Counterpart of the JAX package's `demo/image_demo.py`: `init_detector`,
`inference_detector` on the image through the default test pipeline, then
every detection above `--score-thr` drawn with OpenCV and written to
`--out-file`; `--dump-json` writes them as [{bbox, score, label}], highest
score first.  Runs on the card unless `--device cpu` is given.  Reading and
writing images needs OpenCV, which the card's machine lacks.
"""

import argparse
import json
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("img")
    p.add_argument("config")
    p.add_argument("checkpoint", nargs="?", default=None)
    p.add_argument("--checkpoint", dest="checkpoint_opt", default=None,
                   help="alias for the positional checkpoint argument")
    p.add_argument("--score-thr", type=float, default=0.3)
    p.add_argument("--out-file", default="demo_out.jpg")
    p.add_argument("--dump-json", default=None,
                   help="write [{bbox, score, label}] (detections above --score-thr) to this "
                        "path")
    p.add_argument("--device", default=None,
                   help="the detector's device: the CUDA card unless given (e.g. cpu)")
    args = p.parse_args(argv)
    if args.checkpoint_opt is not None:
        args.checkpoint = args.checkpoint_opt

    import cv2
    from ..apis.inference import inference_detector, init_detector
    from ..runtime.config import load_config

    cfg = load_config(args.config)
    model = init_detector(cfg, args.checkpoint, device=args.device)
    per_class = inference_detector(model, args.img)

    img = cv2.imread(args.img)
    classes = cfg.get("classes")
    records = []
    for c, dets in enumerate(per_class):
        for x1, y1, x2, y2, score in dets:
            if score < args.score_thr:
                continue
            records.append({"bbox": [float(x1), float(y1), float(x2), float(y2)],
                            "score": float(score), "label": int(c)})
            cv2.rectangle(img, (int(x1), int(y1)), (int(x2), int(y2)), (0, 255, 0), 2)
            name = classes[c] if classes else str(c)
            cv2.putText(img, f"{name} {score:.2f}", (int(x1), int(y1) - 4),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 255, 0), 1)
    cv2.imwrite(args.out_file, img)
    print(f"saved {args.out_file}")
    if args.dump_json:
        records.sort(key=lambda r: -r["score"])
        with open(args.dump_json, "w") as f:
            json.dump(records, f, indent=1)
        print(f"saved {args.dump_json} ({len(records)} detections)")
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
