"""Port parity for stage "multi-image-condition" of StoryGenSampler.sample:
one zero-row group and N ref groups in one reference pass of (N+1)B rows,
the zero context tiled N times along kv, JAX package against the port on
the same inputs and weights (5e-4), 2 steps with 2 refs, under PNDM
(n+1 UNet steps, the second timestep twice) and Euler (sigma-space
latents and scaled model inputs)."""
import pytest

from tests.torch_port_util import assert_close, sample_both, serving_models


@pytest.fixture(scope="module")
def models():
    return serving_models()


@pytest.mark.parametrize("sampler", ["pndm", "euler"])
def test_multi_image_condition_sample_matches_jax(models, sampler):
    out_j, out_t = sample_both(models, sampler=sampler,
                               stage="multi-image-condition", steps=2)
    assert_close(out_j, out_t, atol=5e-4, rtol=5e-4, msg=sampler)
