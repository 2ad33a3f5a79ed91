"""fluid.incubate.fleet, an alias over paddle_tpu_torch.distributed."""
