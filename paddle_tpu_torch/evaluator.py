"""fluid.evaluator source-compat (evaluator.py:45): the pre-metrics
Evaluator API. Counterpart of paddle_tpu/evaluator.py: the reference
deprecated it in favor of fluid.metrics; these wrappers keep old
scripts running over utils/metrics."""
from paddle_tpu_torch.utils import metrics as _m


class Evaluator:
    """evaluator.py:45 base: reset/eval over accumulated states."""

    def __init__(self, name=None, **kwargs):
        self._name = name

    def reset(self, executor=None, reset_program=None):
        raise NotImplementedError

    def eval(self, executor=None, eval_program=None):
        raise NotImplementedError


class ChunkEvaluator(Evaluator):
    """evaluator.py:127 → utils.metrics.ChunkEvaluator."""

    def __init__(self, input=None, label=None, chunk_scheme=None,
                 num_chunk_types=None, excluded_chunk_types=None,
                 name=None):
        super().__init__(name)
        self._metric = _m.ChunkEvaluator(name=name)

    def update(self, num_infer_chunks, num_label_chunks,
               num_correct_chunks):
        self._metric.update(num_infer_chunks, num_label_chunks,
                            num_correct_chunks)

    def reset(self, executor=None, reset_program=None):
        self._metric.reset()

    def eval(self, executor=None, eval_program=None):
        return self._metric.eval()


class EditDistance(Evaluator):
    """evaluator.py:218 → utils.metrics.EditDistance."""

    def __init__(self, input=None, label=None, ignored_tokens=None,
                 name=None):
        super().__init__(name)
        self._metric = _m.EditDistance(name=name)

    def update(self, distances, seq_num):
        self._metric.update(distances, seq_num)

    def reset(self, executor=None, reset_program=None):
        self._metric.reset()

    def eval(self, executor=None, eval_program=None):
        return self._metric.eval()


class DetectionMAP(Evaluator):
    """evaluator.py:299 → utils.metrics.DetectionMAP."""

    def __init__(self, input=None, gt_label=None, gt_box=None,
                 gt_difficult=None, class_num=None,
                 background_label=0, overlap_threshold=0.5,
                 evaluate_difficult=True, ap_version="integral",
                 name=None, device=None):
        super().__init__(name)
        self._metric = _m.DetectionMAP(
            name=name, class_num=class_num,
            overlap_threshold=overlap_threshold,
            evaluate_difficult=evaluate_difficult,
            ap_version=ap_version, background_label=background_label,
            device=device)

    def update(self, value, weight=1):
        self._metric.update(value, weight)

    def reset(self, executor=None, reset_program=None):
        self._metric.reset()

    def eval(self, executor=None, eval_program=None):
        return self._metric.eval()
