"""Model code of the port: layers, attention, the decoder stack and the
weight bridge from the JAX package."""
