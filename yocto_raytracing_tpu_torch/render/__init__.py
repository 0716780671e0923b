"""Camera rays, texture, shading and the frame renderer."""
