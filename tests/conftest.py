"""Shared pytest set-up.

``jax.experimental.enable_x64`` moved to ``jax.enable_x64`` in newer JAX
releases; code written against the old name (the schedule-DP parity tests,
``repro.core.device_search``) fails at import on such an installation.  When
JAX is importable and the old name is gone, point it at the new one.  Nothing
else about JAX is touched.
"""
try:
    import jax
    import jax.experimental
except Exception:  # JAX is optional: the NumPy-only tests run without it
    jax = None

if jax is not None and not hasattr(jax.experimental, "enable_x64") \
        and hasattr(jax, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64
