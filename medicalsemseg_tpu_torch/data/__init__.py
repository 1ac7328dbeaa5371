"""Host-side loading and preprocessing, free of jax."""
