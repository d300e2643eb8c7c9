"""Step factories of the port (serving only; training comes later)."""
from .serve import make_prefill_step, make_serve_step, next_token

__all__ = ["make_prefill_step", "make_serve_step", "next_token"]
