from heimdall_tpu_torch.core.config import Config
from heimdall_tpu_torch.core.acquisition import ImageSource, ImageSourceFactory
from heimdall_tpu_torch.core.pipeline import (Pipeline, PipelineFactory,
                                              ProcessingStage)
from heimdall_tpu_torch.core.system import System, InspectionStation
