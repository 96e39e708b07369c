"""The port's copies of two small helpers against the JAX package's:
``utils/commons.py::get_loadable_checkpoint`` and
``utils/tensor.py::concat_complex``, from numpy seeds."""

import jax

jax.config.update('jax_platforms', 'cpu')

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pytorch_sound_tpu.utils import commons as jax_commons  # noqa: E402
from pytorch_sound_tpu.utils import tensor as jax_tensor  # noqa: E402
from pytorch_sound_tpu_torch.utils import commons, tensor  # noqa: E402


def test_get_loadable_checkpoint_matches_jax():
    """``module.`` prefixes go, once per key, and nothing else changes
    (tests/test_misc_utils.py:62-65 holds JAX's)."""
    ckpt = {'module.layer.weight': 1, 'plain': 2, 'module.module.x': 3, 'a.module.b': 4}
    got = commons.get_loadable_checkpoint(ckpt)
    assert got == jax_commons.get_loadable_checkpoint(ckpt)
    assert got == {'layer.weight': 1, 'plain': 2, 'module.x': 3, 'a.module.b': 4}


@pytest.mark.parametrize('shape_a,shape_b,dim', [((2, 6, 5), (2, 4, 5), 1),
                                                 ((3, 4), (3, 8), -1)])
def test_concat_complex_matches_jax(shape_a, shape_b, dim):
    """[a_real, b_real, a_imag, b_imag] along ``dim``, equal to JAX's; an odd
    size raises in both packages."""
    rng = np.random.default_rng(len(shape_a) + dim)
    a = rng.standard_normal(shape_a).astype(np.float32)
    b = rng.standard_normal(shape_b).astype(np.float32)
    got = tensor.concat_complex(torch.from_numpy(a), torch.from_numpy(b), dim=dim).numpy()
    want = np.asarray(jax_tensor.concat_complex(jnp.asarray(a), jnp.asarray(b), dim=dim))
    np.testing.assert_array_equal(got, want)
    odd = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError):
        tensor.concat_complex(torch.from_numpy(odd), torch.from_numpy(odd), dim=dim)
    with pytest.raises(ValueError):
        jax_tensor.concat_complex(jnp.asarray(odd), jnp.asarray(odd), dim=dim)
