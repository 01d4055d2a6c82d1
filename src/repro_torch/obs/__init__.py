"""`repro_torch.obs` — span tracing for the port (a copy of the JAX
package's framework-free ``repro.obs.trace``)."""
from repro_torch.obs import trace
from repro_torch.obs.trace import Tracer, get_tracer, is_enabled, span

__all__ = ["trace", "Tracer", "get_tracer", "is_enabled", "span"]
