"""Command-line tools of the port (``python -m mxnet_tpu_torch.tools.launch``,
``python -m mxnet_tpu_torch.tools.ckpt_fsck``)."""
