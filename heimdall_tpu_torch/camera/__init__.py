from heimdall_tpu_torch.camera.hal import (
    Camera,
    CameraError,
    CameraFactory,
    CameraInfo,
    PixelFormat,
    TriggerMode,
)
from heimdall_tpu_torch.camera.gige import (
    Frame,
    FrameSet,
    GigESystem,
    SyncManager,
    SyncMode,
)
