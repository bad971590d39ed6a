"""Port parity: the 8-bit AdamW (storygen_tpu_torch/training/optim8bit.py)
against the JAX package's `make_optimizer(use_8bit_adam=True)` (clip ->
adamw_8bit -> MultiSteps) on the constant schedule: parameters, the int8 /
uint8 codes and the per-block scales after every micro-step. The port
evaluates the schedule at the count before each update, as AdamW and
optax's adamw do; the JAX 8-bit transform evaluates it one step later, so
under a warmup the two differ and the test pins the port's count instead.
Also: the block quantizers, make_optimizer and the optimizers' state
round trips."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from storygen_tpu.configs import TrainConfig as JTrainConfig
from storygen_tpu.training import optim as j_optim
from storygen_tpu.training import optim8bit as j8
from storygen_tpu_torch.configs import TrainConfig
from storygen_tpu_torch.training import optim, optim8bit
from tests.torch_port_util import assert_close, rand, t

# 300 elements: two blocks, the second padded
SHAPES = {"a": (20, 15), "b": (7,), "c": (2, 3, 4)}


def _codes_close(jq, tq, what):
    """Equal codes, or within 1 where the two sides' fp32 arithmetic puts
    a value on the other side of a rounding tie."""
    diff = np.abs(np.asarray(jq.q, np.int32) - tq.q.numpy().astype(np.int32))
    assert diff.max() <= 1, what
    assert (diff > 0).mean() < 0.01, what
    np.testing.assert_allclose(tq.scale.numpy(), np.asarray(jq.scale),
                               rtol=1e-6, atol=0, err_msg=what)


def _inner_8bit_state(opt_state):
    """The Adam8bitState of chain(clip, adamw_8bit), inside MultiSteps
    when it accumulates."""
    chain = getattr(opt_state, "inner_opt_state", opt_state)
    return next(s for s in chain if isinstance(s, j8.Adam8bitState))


@pytest.mark.parametrize("accum", [1, 2])
def test_adamw8bit_matches_jax(accum):
    """Five optimizer steps of `accum` micro-steps, with grads large enough
    to be clipped on some steps."""
    base = dict(learning_rate=1e-2, gradient_accumulation_steps=accum,
                adam_weight_decay=0.1, max_grad_norm=1.0, use_8bit_adam=True)
    init = {k: rand(30 + i, s) for i, (k, s) in enumerate(SHAPES.items())}
    tx = j_optim.make_optimizer(JTrainConfig(**base))
    j_params = {k: jnp.asarray(v) for k, v in init.items()}
    j_state = tx.init(j_params)
    params = {k: t(v) for k, v in init.items()}
    opt = optim.make_optimizer(TrainConfig(**base), params)
    assert isinstance(opt, optim8bit.AdamW8bit)
    for micro in range(5 * accum):
        scale = 3.0 if micro % 3 == 0 else 0.05  # clipped, then not
        grads = {k: rand(50 + 10 * micro + i, s, scale)
                 for i, (k, s) in enumerate(SHAPES.items())}
        upd, j_state = tx.update({k: jnp.asarray(v)
                                  for k, v in grads.items()},
                                 j_state, j_params)
        j_params = {k: j_params[k] + upd[k] for k in j_params}
        applied = opt.update({k: t(v) for k, v in grads.items()})
        assert applied == ((micro + 1) % accum == 0)
        for k in SHAPES:
            assert_close(j_params[k], params[k], atol=1e-6, rtol=1e-5,
                         msg=f"{k} after micro-step {micro}")
        s8 = _inner_8bit_state(j_state)
        for k in SHAPES:
            _codes_close(s8.mu[k], opt.mu[k], f"mu {k} micro {micro}")
            _codes_close(s8.nu[k], opt.nu[k], f"nu {k} micro {micro}")
    assert opt.count == 5


def test_quantizers_match_jax():
    rs = np.random.RandomState(0)
    x = rs.randn(3, 250).astype(np.float32)  # blocks straddle the rows
    # the first block's absmax is 1, and some of its values land exactly
    # half-way between two codes
    x[0, :8] = [0.0, 1.0, -1.0, 0.5 / 127, 1.5 / 127, 2.5 / 127, -0.5 / 127,
                -1.5 / 127]
    x[0, 8:] = np.clip(x[0, 8:], -0.9, 0.9)
    x[1, :6] = np.clip(x[1, :6], -0.9, 0.9)
    for q, jq in ((optim8bit.quantize_signed, j8.quantize_signed),
                  (optim8bit.quantize_unsigned, j8.quantize_unsigned)):
        v = np.abs(x) if q is optim8bit.quantize_unsigned else x
        got, ref = q(t(v)), jq(jnp.asarray(v))
        assert got.q.dtype == {np.int8: torch.int8, np.uint8: torch.uint8}[
            np.asarray(ref.q).dtype.type]
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
        np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    deq = optim8bit.dequantize_signed(optim8bit.quantize_signed(t(x)),
                                      torch.Size(x.shape))
    ref = j8.dequantize_signed(j8.quantize_signed(jnp.asarray(x)), x.shape)
    np.testing.assert_array_equal(deq.numpy(), np.asarray(ref))
    # round half to even, as jnp.round
    assert optim8bit.quantize_signed(t(x)).q[0, :8].tolist() == \
        [0, 127, -127, 0, 2, 2, 0, -2]


@pytest.mark.parametrize("eightbit", [False, True])
def test_schedule_is_read_at_the_count_before_the_update(eightbit):
    """Under a 2-step warmup the first update has lr 0 (the parameters do
    not move), the second lr / 2, then lr: the count before each update,
    for AdamW and AdamW8bit alike."""
    cfg = TrainConfig(learning_rate=1e-2, lr_warmup_steps=2,
                      gradient_accumulation_steps=1, use_8bit_adam=eightbit)
    params = {"w": t(rand(1, (300,)))}
    opt = optim.make_optimizer(cfg, params)
    seen = []
    schedule = opt.schedule
    opt.schedule = lambda count: seen.append(count) or schedule(count)
    before = params["w"].clone()
    opt.update({"w": t(rand(2, (300,)))})
    assert torch.equal(params["w"], before)
    for i in range(3):
        opt.update({"w": t(rand(3 + i, (300,)))})
    assert seen == [0, 1, 2, 3]
    assert [schedule(c) for c in seen] == [0.0, 5e-3, 1e-2, 1e-2]


@pytest.mark.parametrize("eightbit", [False, True])
def test_state_dict_round_trips(eightbit):
    cfg = TrainConfig(learning_rate=1e-2, gradient_accumulation_steps=2,
                      use_8bit_adam=eightbit)
    grads = [{k: t(rand(70 + 3 * i + j, s)) for j, (k, s)
              in enumerate(SHAPES.items())} for i in range(7)]

    def fresh():
        p = {k: t(rand(60 + i, s)) for i, (k, s) in enumerate(SHAPES.items())}
        return p, optim.make_optimizer(cfg, p)

    p_a, a = fresh()
    for g in grads:
        a.update(g)
    p_b, b = fresh()
    for g in grads[:3]:  # mid-accumulation
        b.update(g)
    p_c, c = fresh()
    with torch.no_grad():
        for k in p_c:
            p_c[k].copy_(p_b[k])
    c.load_state_dict(b.state_dict())
    assert (c.count, c.mini_step) == (b.count, b.mini_step) == (1, 1)
    for g in grads[3:]:
        c.update(g)
    for k in SHAPES:
        assert torch.equal(p_a[k], p_c[k]), k
    with pytest.raises(KeyError):
        c.load_state_dict({**a.state_dict(), "acc": {"x": torch.zeros(1)}})
