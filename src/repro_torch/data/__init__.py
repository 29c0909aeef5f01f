from repro_torch.data.pipeline import make_request_stream

__all__ = ["make_request_stream"]
