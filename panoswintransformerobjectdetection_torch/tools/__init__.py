"""Command-line tools of the PyTorch port: `test` (evaluate a checkpoint),
`eval_metric` (evaluate saved results) and `image_demo` (draw one image's
detections).  Run each with `python -m panoswintransformerobjectdetection_torch.tools.<name>`."""
