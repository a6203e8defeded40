from heimdall_tpu_torch.inspection.base_inspector import (Inspector,
                                                          InspectionResult)
from heimdall_tpu_torch.inspection.contamination_inspector import (
    ContaminationInspector)
