from heimdall_tpu_torch.runtime.diagnostics import (DiagnosticReport,
                                                    run_diagnostics)
from heimdall_tpu_torch.runtime.plc import PLCClient, RejectionController
