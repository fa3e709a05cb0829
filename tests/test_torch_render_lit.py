"""Port parity, whole images: the quad scenes — plain quads (5), the
Cornell box with a quad and a sphere light (6) and the Cornell box with two
smoke media (7) — at the golden config (48 px, 4 spp, depth 8), the port's
wavefront on the CPU against the JAX package's, by the image rule.
"""

import pytest

from conftest import assert_images_close
from test_torch_render_textured import render_both


@pytest.mark.parametrize("idx", [5, 6, 7])
def test_golden_config_matches_jax(idx):
    got, want = render_both(idx)
    assert want.mean() > 0.01
    assert_images_close(got, want, msg=f"scene {idx} port vs jax")
