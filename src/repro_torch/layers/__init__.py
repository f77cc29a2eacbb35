"""Layers of the port (functional, explicit parameters as in the JAX
package; parameters are plain dicts of tensors)."""
