"""Metadata, splits and training batches of the port (copies of the JAX
package's ``data`` modules)."""
