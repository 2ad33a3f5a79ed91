"""fluid.incubate: the incubating distributed API (incubate/fleet), which
graduated into paddle_tpu_torch.distributed; these module paths keep
incubate-era imports working (paddle_tpu/incubate/)."""
