"""fluid.inferencer parity: the reference moved Inferencer to
fluid.contrib (inferencer.py:15 "NOTE: inferencer is moved into
fluid.contrib.inferencer"); the live API here is
paddle_tpu_torch.inference.Predictor (counterpart of
paddle_tpu/inferencer.py)."""
__all__ = []
