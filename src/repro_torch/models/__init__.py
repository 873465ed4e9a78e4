"""Model families of the port: every family of the JAX package."""
from repro_torch.models.api import build_model  # noqa: F401
