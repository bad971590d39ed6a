"""Shared helpers of the port's parity tests (tests/test_torch_port_*.py):
seeded numpy inputs, JAX params carried into the port's modules through
storygen_tpu_torch/checkpoint/convert.py, and fp32 comparisons."""
import jax
import numpy as np
import torch
from flax.core import unfreeze

from storygen_tpu_torch.checkpoint.convert import jax_to_state_dict

# test_torch_golden.py's fp32 standard
ATOL = 1e-4
RTOL = 1e-4


def rand(seed: int, shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def np_tree(params):
    """A flax variable tree as nested dicts of numpy arrays."""
    return jax.tree_util.tree_map(np.asarray, unfreeze(params))


def load(module: torch.nn.Module, params, **convert_kw) -> torch.nn.Module:
    """Carry JAX params into a port module (strict key and shape match)."""
    module.load_state_dict(jax_to_state_dict(np_tree(params), **convert_kw),
                           strict=True)
    return module.eval()


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def assert_close(jax_out, torch_out, atol: float = ATOL, rtol: float = RTOL,
                 msg: str = ""):
    ref = np.asarray(jax_out, dtype=np.float32)
    got = torch_out.detach().float().numpy() if torch.is_tensor(torch_out) \
        else np.asarray(torch_out, dtype=np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape, msg)
    np.testing.assert_allclose(got, ref, atol=atol, rtol=rtol, err_msg=msg)
