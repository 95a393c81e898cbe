"""Command-line tools of the PyTorch port: `test` (evaluate a checkpoint),
`eval_metric` (evaluate saved results), `image_demo` (draw one image's
detections), `train`, `config_census`, and the backbone converters
`detectron2pytorch` and `regnet2pytorch`.  Run each with `python -m panoswintransformerobjectdetection_torch.tools.<name>`."""
