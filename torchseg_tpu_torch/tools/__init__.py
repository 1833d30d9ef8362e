"""Command-line tools (counterpart of torchseg_tpu/tools/):
``eval_speed`` (the evaluation protocols' ms an image) and
``make_manifest`` (the datasets' manifest files)."""
