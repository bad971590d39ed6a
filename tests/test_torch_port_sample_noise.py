"""Port parity for the samplers that take fresh noise at every step, fed
the JAX sampler's own per-step draws (normal(fold_in(sample_rng, i))) as
`step_noise`, JAX package against the port on the same inputs and weights
(5e-4): euler_a in stage "no" (2 steps), and DDIM with eta 0.5 in the
auto-regressive stage with ref_feature_interval 2 (3 steps: the
reference pass runs at steps 0 and 2, its context is reused at step 1)."""
from tests.torch_port_util import assert_close, sample_both, serving_models


def test_stochastic_samplers_match_jax():
    models = serving_models()
    out_j, out_t = sample_both(models, sampler="euler_a", stage="no",
                               steps=2)
    assert_close(out_j, out_t, atol=5e-4, rtol=5e-4, msg="euler_a")
    out_j, out_t = sample_both(models, sampler="ddim", eta=0.5, rfi=2,
                               stage="auto-regressive", steps=3)
    assert_close(out_j, out_t, atol=5e-4, rtol=5e-4, msg="ddim eta 0.5")
