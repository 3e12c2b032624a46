"""The port's copies of the JAX package's host-side program compiler,
codec, preprocessing (GQA question JSON -> programs) and validation (numpy
and the standard library only)."""
