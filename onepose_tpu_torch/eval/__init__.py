"""Evaluation: cm-degree recall accumulation and result recording."""

from onepose_tpu_torch.eval.evaluator import Evaluator, record_eval_result

__all__ = ["Evaluator", "record_eval_result"]
