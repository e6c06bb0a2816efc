"""GAE and the value normaliser of the port against the JAX package.

The same numpy inputs go through `mupe_tpu.learning.gae.compute_gae` (an
associative scan) and the port's reverse loop, and through a sequence of
`ValueNorm1` updates.  Both are f32 arithmetic in another order: rtol 1e-5
(atol 1e-5 on values of order 10).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mupe_tpu.learning.gae import compute_gae as jgae
from mupe_tpu.learning.valuenorm import ValueNorm1 as JNorm
from mupe_tpu_torch import bridge
from mupe_tpu_torch.learning import ValueNorm1, compute_gae


@pytest.mark.parametrize("shape", [(64, 96), (8, 5, 3)])
def test_compute_gae_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    reward = rng.normal(0, 3, shape).astype(np.float32)
    value = rng.normal(0, 5, shape).astype(np.float32)
    next_value = rng.normal(0, 5, shape[1:]).astype(np.float32)
    done = rng.random(shape) < 0.1
    ja, jr = jgae(jnp.asarray(reward), jnp.asarray(done), jnp.asarray(value),
                  jnp.asarray(next_value), 0.995, 0.95)
    ta, tr = compute_gae(torch.as_tensor(reward), torch.as_tensor(done), torch.as_tensor(value),
                         torch.as_tensor(next_value), 0.995, 0.95)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5, atol=1e-5)


def test_value_norm_sequence_matches_jax():
    rng = np.random.default_rng(0)
    jn = JNorm.create((1,), beta=0.995)
    tn = ValueNorm1.create((1,), beta=0.995)
    for i in range(5):
        batch = rng.normal(3.0 * i, 1.0 + i, (64, 96, 1)).astype(np.float32)
        x = rng.normal(0, 10, (17,)).astype(np.float32)
        jn = jn.update(jnp.asarray(batch))
        tn = tn.update(torch.as_tensor(batch))
        for name in ("running_mean", "running_mean_sq", "debiasing_term"):
            np.testing.assert_allclose(getattr(tn, name).numpy(), np.asarray(getattr(jn, name)),
                                       rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(tn.normalize(torch.as_tensor(x)).numpy(),
                                   np.asarray(jn.normalize(jnp.asarray(x))), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tn.denormalize(torch.as_tensor(x)).numpy(),
                                   np.asarray(jn.denormalize(jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    conv = bridge.value_norm({k: np.asarray(getattr(jn, k)) for k in
                              ("running_mean", "running_mean_sq", "debiasing_term")})
    np.testing.assert_allclose(conv.normalize(torch.as_tensor(x)).numpy(),
                               np.asarray(jn.normalize(jnp.asarray(x))), rtol=1e-5, atol=1e-5)


def test_fresh_value_norm_is_identity_up_to_its_variance_floor():
    """Before any update the debiasing term is 0 (clamped to eps), mean 0
    and variance clamped to 1e-2, as in the JAX package."""
    x = torch.linspace(-3, 3, 7)
    jx = np.asarray(JNorm.create((1,)).denormalize(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(ValueNorm1.create((1,)).denormalize(x).numpy(), jx, rtol=1e-6)
