"""Learned models (port of heimdall_tpu/models): the defect classifier and
its trainers (one process, or data-parallel over a mesh), the anomaly
autoencoder, the segmentation U-Net and its int8 form, and training-data
capture.  Training and inference run on the card; models/optim.py holds
the port's optax.adam."""

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
