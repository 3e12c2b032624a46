"""The port's copies of the JAX package's host-side program compiler and
codec (numpy only)."""
