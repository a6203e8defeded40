from heimdall_tpu_torch.camera.hal import (
    Camera,
    CameraError,
    CameraFactory,
    CameraInfo,
    PixelFormat,
    TriggerMode,
)
