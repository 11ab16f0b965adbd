"""Tracing and dispatch accounting (tpu3d/utils)."""
from tpu3d_torch.utils.trace import Tracer, get_tracer, trace_span

__all__ = ["Tracer", "trace_span", "get_tracer"]
