from repro_torch.data.pipeline import TraceRequest, make_request_stream, make_request_trace

__all__ = ["TraceRequest", "make_request_stream", "make_request_trace"]
