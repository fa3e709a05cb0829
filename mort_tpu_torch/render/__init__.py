"""The port's render path: intersection, shading and the wavefront loop."""
