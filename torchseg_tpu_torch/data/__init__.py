"""Datasets and host-side transforms (counterpart of torchseg_tpu/data/)."""
