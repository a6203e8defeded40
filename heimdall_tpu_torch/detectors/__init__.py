"""Defect model and detectors (port of heimdall_tpu/detectors)."""

from heimdall_tpu_torch.detectors.base import Defect, DefectDetector
from heimdall_tpu_torch.detectors.contamination_detector import (
    ContaminationDetector)
