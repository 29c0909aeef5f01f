from repro_torch.data.pipeline import (
    DataConfig,
    SyntheticLMDataset,
    TraceRequest,
    make_request_stream,
    make_request_trace,
    sharded_batches,
)

__all__ = ["DataConfig", "SyntheticLMDataset", "TraceRequest", "make_request_stream",
           "make_request_trace", "sharded_batches"]
