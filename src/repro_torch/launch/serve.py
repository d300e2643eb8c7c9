"""Deprecated import shim: the LLM token-serving driver moved to
``repro_torch.launch.model_serve`` so that ``repro_torch.serve`` unambiguously names
the scheduling-solve service."""
import warnings

from .model_serve import serve_main  # noqa: F401

warnings.warn(
    "repro_torch.launch.serve moved to repro_torch.launch.model_serve; this shim "
    "will be removed in a future release",
    DeprecationWarning,
    stacklevel=2,
)

if __name__ == "__main__":
    serve_main()
