"""The port's pure-Python flax checkpoint reader and JAX -> torch weight
loading, against flax itself."""

import jax

jax.config.update('jax_platforms', 'cpu')

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from flax import serialization  # noqa: E402

from pytorch_sound_tpu.interface.hifi_gan import CHECKPOINTS  # noqa: E402
from pytorch_sound_tpu.models import build_model as jax_build_model  # noqa: E402
from pytorch_sound_tpu.models.vocoders import hifi_gan as jax_hg  # noqa: E402
from pytorch_sound_tpu_torch.models import build_model  # noqa: E402
from pytorch_sound_tpu_torch.models.vocoders import hifi_gan as torch_hg  # noqa: E402
from pytorch_sound_tpu_torch.utils import checkpoint  # noqa: E402

V2 = CHECKPOINTS['hifi_gan_v2']


def _flat(tree, prefix=''):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + '.'))
        else:
            out[prefix + k] = v
    return out


def test_reader_matches_flax_on_bundled_checkpoint():
    with open(V2, 'rb') as f:
        data = f.read()
    ours = _flat(checkpoint.msgpack_restore(data))
    ref = _flat(serialization.msgpack_restore(data))
    assert ours.keys() == ref.keys() and len(ours) == 156
    for key, val in ref.items():
        assert ours[key].dtype == val.dtype == np.float32, key
        np.testing.assert_array_equal(ours[key], val, err_msg=key)
    assert sum(v.size for v in ours.values()) == 925985


def test_reader_round_trips_flax_scalars_and_nesting():
    tree = {'a': {'b': np.arange(6, dtype=np.int32).reshape(2, 3),
                  'c': np.float64(2.5), 'empty': {}},
            'w': np.ones((1, 2, 3), np.float32) * 1.5, 'n': 7, 'neg': -3,
            'big': 2 ** 40, 'f': 0.25, 's': 'text', 'none': None, 't': True,
            'list': [1, 'x', None]}
    data = serialization.msgpack_serialize(tree)
    ours = checkpoint.msgpack_restore(data)
    ref = serialization.msgpack_restore(data)
    assert ours.keys() == ref.keys()
    np.testing.assert_array_equal(ours['a']['b'], ref['a']['b'])
    assert ours['a']['c'] == ref['a']['c'] and ours['a']['empty'] == {}
    np.testing.assert_array_equal(ours['w'], ref['w'])
    for key in ('n', 'neg', 'big', 'f', 's', 'none', 't', 'list'):
        assert ours[key] == ref[key], key
    with pytest.raises(ValueError):
        checkpoint.msgpack_restore(data[:-3])


def _init_tree(arch, extra, seed):
    """The (g, v) parameter tree the JAX ``Generator.init`` makes (names and
    shapes from ``jax.eval_shape``, which compiles nothing), filled with
    seeded numpy values."""
    gen = jax_build_model(arch, extra_kwargs=extra)
    shapes = jax.eval_shape(gen.init, jax.random.PRNGKey(0), jnp.zeros((1, 80, 8)))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.1).astype(np.float32), shapes)


@pytest.mark.parametrize('arch', ['hifi_gan_v2', 'hifi_gan_v3'])
def test_load_jax_params_round_trips_folded_and_weight_norm_trees(arch):
    """Both the folded tree and Generator.init's (g, v) tree load into the
    torch Generator, under the same keys, with the JAX fold's values."""
    extra = {'upsample_initial_channel': 32}
    params = _init_tree(arch, extra, seed=len(arch))
    assert 'g' in params['params']['conv_pre'] and 'v' in params['params']['conv_pre']
    folded = jax.tree_util.tree_map(np.asarray, jax_hg.fold_weight_norm_params(params))

    model = build_model(arch, extra_kwargs=dict(extra, use_weight_norm=False))
    for tree in (params, folded):
        state = torch_hg.load_jax_params(tree)
        model.load_state_dict(state)                 # strict: same key set
        got = {k: v.numpy() for k, v in model.state_dict().items()}
        want = _flat(folded['params'])
        assert got.keys() == want.keys()
        for key, val in want.items():
            np.testing.assert_allclose(got[key], val, rtol=1e-6, atol=1e-7, err_msg=key)


def test_state_dict_keys_are_jax_paths():
    model = build_model('hifi_gan_v2', extra_kwargs={'use_weight_norm': False})
    keys = set(model.state_dict())
    assert {'conv_pre.weight', 'ups_0.weight', 'resblocks_3.convs1_0.weight',
            'resblocks_11.convs2_2.bias', 'conv_post.bias'} <= keys
    with open(V2, 'rb') as f:
        ref = _flat(serialization.msgpack_restore(f.read())['params'])
    assert keys == set(ref)
    for key, val in model.state_dict().items():
        assert tuple(val.shape) == ref[key].shape, key
    assert isinstance(model, torch.nn.Module)
