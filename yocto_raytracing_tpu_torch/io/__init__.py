"""Host-side I/O: scene file parsing and image codecs (copies of the JAX
package's numpy-only ``io`` modules)."""
