"""Learned models (port of heimdall_tpu/models): the defect classifier, the
anomaly autoencoder, the segmentation U-Net and its int8 form, and
training-data capture.  Inference runs on the card; training belongs to a
later slice (its entry points raise NotImplementedError)."""

from heimdall_tpu_torch.models.defect_classifier import (
    DefectClassifier,
    ClassifierTrainer,
    make_sharded_train_step,
    extract_blob_patches,
)
from heimdall_tpu_torch.models.anomaly import AnomalyDetector
from heimdall_tpu_torch.models.segmentation import (DefectSegmenter,
                                                    SegmentationDetector)
from heimdall_tpu_torch.models.capture import TrainingDataCapture
from heimdall_tpu_torch.models.quantized import QuantizedSegmenter
