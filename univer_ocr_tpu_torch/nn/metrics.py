"""Classification metrics (univer_ocr_tpu/nn/metrics.py, numpy on the
host): `multiclass_accuracy` is the Char model's per-column accuracy in
the trainer's validation sweep."""

from collections import namedtuple

import numpy as np


def binary_classification_metrics(prediction, ground_truth, f1beta=1):
    true = (prediction == ground_truth).astype(int)
    false = (prediction != ground_truth).astype(int)
    positives = prediction
    negatives = 1 - prediction
    tp = (true * positives).sum()
    tn = (true * negatives).sum()
    fp = (false * positives).sum()
    fn = (false * negatives).sum()
    accuracy = (tp + tn) / (tp + tn + fp + fn)
    precision = tp / (tp + fp)
    recall = tp / (tp + fn)
    beta2 = f1beta * f1beta
    f1 = (1 + beta2) * precision * recall / (beta2 * precision + recall)
    result = namedtuple(
        'BinaryClassificationMetrics',
        ['accuracy', 'precision', 'recall', 'f1'])
    return result(accuracy, precision, recall, f1)


def multiclass_accuracy(prediction, ground_truth):
    """Fraction of samples whose argmax class matches.

    Accepts (B, n_classes) scores/one-hots or (B,) class ids for either arg.
    """
    prediction = np.asarray(prediction)
    ground_truth = np.asarray(ground_truth)
    if prediction.ndim > 1:
        prediction = np.argmax(prediction, axis=-1)
    if ground_truth.ndim > 1:
        ground_truth = np.argmax(ground_truth, axis=-1)
    if prediction.size == 0:
        return 0.0
    return float(np.mean(prediction == ground_truth))
