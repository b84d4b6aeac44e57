from repro_torch.data.stream import (
    RateSchedule,
    constant_rate,
    diurnal_rate,
    ctr_rate,
    WorkloadRecording,
    record_workload,
    EventStream,
)
from repro_torch.data.pipeline import StreamingBatcher, PipelineCursor

__all__ = [
    "RateSchedule",
    "constant_rate",
    "diurnal_rate",
    "ctr_rate",
    "WorkloadRecording",
    "record_workload",
    "EventStream",
    "StreamingBatcher",
    "PipelineCursor",
]
