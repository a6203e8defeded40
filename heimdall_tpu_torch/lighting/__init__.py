from heimdall_tpu_torch.lighting.controller import (
    LightingController,
    LightingControllerFactory,
    LightingType,
    LightingSyncMode,
    ChannelState,
    SimulatedLightingController,
    SerialLightingController,
    EthernetLightingController,
)
from heimdall_tpu_torch.lighting.sync import LightingSynchronizer, SyncEvent
from heimdall_tpu_torch.lighting.calibration import (
    AutoIntensityAdjuster,
    AdvancedAutoIntensityAdjuster,
    IntensityAlgorithm,
    PIDController,
    UniformityCalibrator,
)
from heimdall_tpu_torch.lighting.monitoring import LightingMonitor, AlertManager
