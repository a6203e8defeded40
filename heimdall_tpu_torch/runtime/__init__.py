from heimdall_tpu_torch.runtime.feeder import (DeviceFeeder, FrameRing,
                                               HostFetcher,
                                               NativeCameraFeeder,
                                               PinnedUploader)
from heimdall_tpu_torch.runtime.recovery import (
    ErrorCategory,
    RecoveryAction,
    RecoveryStrategy,
    HeimdallError,
    with_recovery,
)
from heimdall_tpu_torch.runtime.diagnostics import (DiagnosticReport,
                                                    run_diagnostics)
from heimdall_tpu_torch.runtime.plc import PLCClient, RejectionController
