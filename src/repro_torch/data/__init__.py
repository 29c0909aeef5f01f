from repro_torch.data.pipeline import (
    DataConfig,
    SyntheticLMDataset,
    TraceRequest,
    make_request_stream,
    make_request_trace,
)

__all__ = ["DataConfig", "SyntheticLMDataset", "TraceRequest", "make_request_stream",
           "make_request_trace"]
