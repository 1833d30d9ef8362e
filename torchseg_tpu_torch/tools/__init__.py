"""Command-line tools (counterpart of torchseg_tpu/tools/):
``eval_speed`` (the evaluation protocols' ms an image), ``make_manifest``
(the datasets' manifest files), ``speed`` (FPS), ``train_speed`` (ms a
training step), ``stats`` (parameters, FLOPs, bytes), ``roofline`` (the
H100 bound of a graph, and ``bound``, the kernels' yardstick) and
``profile`` (torch.profiler traces and op tables)."""
