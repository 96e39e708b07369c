"""The port's separation path against the JAX package's on the CPU.

The cases of ``tests/test_separation_maestro.py`` for DSD100 (shapes, the
recipe end to end, ``separate``, ``main``) and the MedleyDB cases of
``tests/test_medleydb_zeroth.py`` on the port, and parity with the flax
models at their weights carried over by ``load_jax_params``:

- the loader's 2-D conv, transposed conv and GroupNorm mapping on
  asymmetric kernels (the axis-reversing mapping it replaced fails there);
- ``SpectrogramUNet`` masks within 1e-5 absolute (small and base, odd and
  even F x T);
- one ``DSD100Trainer.forward`` loss within 1e-5 relative and its gradients
  within 1e-4 relative per parameter, against ``jax.value_and_grad`` of the
  JAX ``forward``, with and without the background column (MUSDB18);
- ``separate`` within 1e-4 of JAX's;
- the YAML reader against ``yaml.safe_load`` on every bundled MedleyDB
  metafile; the MUSDB18 command.
"""

import glob
import os

import jax

jax.config.update('jax_platforms', 'cpu')

import flax.linen as fnn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import yaml  # noqa: E402

from pytorch_sound_tpu.examples import dsd100 as jax_recipe  # noqa: E402
from pytorch_sound_tpu.models import build_model as jax_build_model  # noqa: E402
import pytorch_sound_tpu.models.separation  # noqa: E402,F401
from pytorch_sound_tpu_torch.data.meta import read_table_json  # noqa: E402
from pytorch_sound_tpu_torch.data.meta.dsd100 import DSD100Meta  # noqa: E402
from pytorch_sound_tpu_torch.data.meta.dsd100 import get_datasets as dsd_datasets  # noqa: E402
from pytorch_sound_tpu_torch.data.meta.medleydb import (  # noqa: E402
    MEDLEYDB_META_DIR, get_datasets as medley_datasets, parse_yaml)
from pytorch_sound_tpu_torch.data.meta.musdb18 import get_datasets as musdb_datasets  # noqa: E402
from pytorch_sound_tpu_torch.examples import dsd100 as recipe  # noqa: E402
from pytorch_sound_tpu_torch.models import build_model  # noqa: E402
from pytorch_sound_tpu_torch.models.modules import load_jax_params  # noqa: E402
from pytorch_sound_tpu_torch.scripts.preprocess import Processor  # noqa: E402
from pytorch_sound_tpu_torch.trainer import adam  # noqa: E402
from pytorch_sound_tpu_torch.utils.wavio import write_wav  # noqa: E402

MASK_TOL = 1e-5            # U-Net masks, absolute
LOSS_RTOL = 1e-5           # one step's loss, relative
GRAD_RTOL = 1e-4           # ||g_port - g_jax|| / ||g_jax|| per parameter
SEPARATE_TOL = 1e-4        # separate's waveforms, absolute


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def random_params(jm, x, seed):
    """Seeded random weights in a flax model's parameter shapes (found
    without running its init): kernels at 1 / sqrt(fan-in), biases around 0
    and norm scales around 1, so that every kernel is asymmetric and every
    bias counts."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == 'kernel':
            return (rng.standard_normal(leaf.shape)
                    / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        return ((1.0 if name == 'scale' else 0.0)
                + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        draw, jax.eval_shape(jm.init, jax.random.PRNGKey(0), x))


@pytest.fixture(scope='module')
def unets():
    """spec_unet_small and spec_unet_base at seeded random weights: the flax
    model with its jitted apply, the port's model with the weights loaded."""
    out = {}
    for i, arch in enumerate(('spec_unet_small', 'spec_unet_base')):
        jm = jax_build_model(arch)
        params = random_params(jm, jnp.ones((1, 513, 16)), i)
        out[arch] = (jm, params, load_jax_params(build_model(arch), _tree(params)),
                     jax.jit(jm.apply))
    return out


def test_spec_unet_shapes():
    model = build_model('spec_unet_small')
    mag = torch.from_numpy(np.abs(np.random.default_rng(0).standard_normal(
        (2, 513, 40))).astype(np.float32))
    with torch.no_grad():
        mask = model(mag).numpy()
    assert mask.shape == (2, 513, 40)
    assert (mask >= 0).all() and (mask <= 1).all()


def _reversed_axes(kernel):
    """The mapping the loader used for every kernel before it knew 2-D convs:
    all axes reversed."""
    arr = torch.from_numpy(np.asarray(kernel, np.float32))
    return arr.permute(*range(arr.ndim - 1, -1, -1)).contiguous()


def test_load_jax_params_maps_2d_conv_transpose_and_groupnorm():
    """A 4 x 4 strided conv, a 4 x 4 strided transposed conv ('SAME', as the
    U-Net's) and a GroupNorm with asymmetric random weights: the loaded
    torch layers compute flax's outputs. Reversing every axis of the 2-D
    kernels instead transposes the conv's in space, which misses by far more
    than the tolerance, and gives the transposed conv's as (out, in), which
    does not load."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 12, 10, 3)).astype(np.float32)     # NHWC
    cases = (
        (fnn.Conv(5, (4, 4), strides=(2, 2), padding='SAME'),
         lambda: torch.nn.Conv2d(3, 5, 4, stride=2, padding=1)),
        (fnn.ConvTranspose(5, (4, 4), strides=(2, 2), padding='SAME'),
         lambda: torch.nn.ConvTranspose2d(3, 5, 4, stride=2, padding=1)),
        (fnn.GroupNorm(num_groups=3, epsilon=1e-6),
         lambda: torch.nn.GroupNorm(3, 3, eps=1e-6)),
    )
    for jm, make in cases:
        params = _tree(jm.init(jax.random.PRNGKey(0), x))['params']
        params = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
        ref = np.asarray(jm.apply({'params': params}, x)).transpose(0, 3, 1, 2)
        holder = torch.nn.Module()
        holder.layer = make()
        load_jax_params(holder, {'params': {'layer': params}})
        with torch.no_grad():
            out = holder.layer(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, atol=1e-5)
        if 'kernel' in params:
            old = make()
            try:
                old.load_state_dict({'weight': _reversed_axes(params['kernel']),
                                     'bias': torch.from_numpy(params['bias'])})
            except RuntimeError:            # in != out: (out, in) where torch wants (in, out)
                assert isinstance(old, torch.nn.ConvTranspose2d)
                continue
            with torch.no_grad():
                miss = np.abs(old(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
                              - ref).max()
            assert miss > 0.1, miss


@pytest.mark.parametrize('arch,f,t', [('spec_unet_small', 513, 37),
                                      ('spec_unet_small', 513, 40),
                                      ('spec_unet_base', 513, 37),
                                      ('spec_unet_base', 513, 40)])
def test_spec_unet_matches_jax(unets, arch, f, t):
    """Odd and even F x T: the pad to the stride pyramid and the slice back."""
    _, params, model, apply = unets[arch]
    mag = np.abs(np.random.default_rng(t).standard_normal((2, f, t))).astype(np.float32)
    ref = np.asarray(apply(params, jnp.asarray(mag)))
    with torch.no_grad():
        out = model(torch.from_numpy(mag)).numpy()
    assert out.shape == ref.shape == (2, f, t)
    err = np.abs(out - ref).max()
    print('achieved: %s %dx%d mask max abs %.3g' % (arch, f, t, err))
    assert err <= MASK_TOL


def _sources(seed, n=2, t=8192):
    rng = np.random.default_rng(seed)
    tt = np.arange(t) / 44100
    voice = (0.3 * np.sin(2 * np.pi * rng.uniform(200, 600, (n, 1)) * tt)).astype(np.float32)
    background = (0.1 * rng.standard_normal((n, t))).astype(np.float32)
    return voice + background, voice, background


@pytest.mark.parametrize('with_background', [True, False])
def test_dsd100_loss_and_gradients_match_jax(unets, with_background):
    """One batch through ``DSD100Trainer.forward`` (with the logged meta)
    against ``jax.value_and_grad`` of the JAX forward, at the same weights;
    without the background column the target is mixture - voice (MUSDB18)."""
    jm, params, _, _ = unets['spec_unet_small']
    batch = _sources(11)[:3 if with_background else 2]
    ref = object.__new__(jax_recipe.DSD100Trainer)     # forward reads self.model only
    ref.model = jm

    def loss_fn(p, *b):
        loss, meta = ref.forward(p, *b, is_logging=True)
        return loss, {k: v for k, (v, _) in meta.items()}     # values, not LogTypes

    (ref_loss, ref_meta), ref_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, *map(jnp.asarray, batch))

    model = load_jax_params(build_model('spec_unet_small'), _tree(params))
    port = object.__new__(recipe.DSD100Trainer)
    port.model = model
    loss, meta = port.forward(*map(torch.from_numpy, batch), is_logging=True)
    loss.backward()
    loss = loss.detach()
    loss_rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    assert loss_rel <= LOSS_RTOL
    for key in ('voice_l1', 'background_l1'):
        assert abs(float(meta[key][0].detach()) - float(ref_meta[key])) <= \
            LOSS_RTOL * abs(float(ref_meta[key]))
    np.testing.assert_allclose(meta['est_voice'][0].detach().numpy(),
                               np.asarray(ref_meta['est_voice']), atol=1e-5)
    want = load_jax_params(build_model('spec_unet_small'), _tree(ref_grads)).state_dict()
    total = float(torch.sqrt(sum(torch.sum(g ** 2) for g in want.values())))
    worst = 0.0
    for name, p in model.named_parameters():
        block = name.rsplit('.', 2)[0]
        norm = getattr(model, block).GroupNorm_0 if 'Block' in block else None
        if (name.endswith('Conv_0.bias') or name.endswith('ConvTranspose_0.bias')) \
                and norm is not None and norm.num_groups == norm.num_channels:
            # a per-channel bias under a GroupNorm of one channel a group
            # cancels: its gradient is zero, both packages' round-off
            assert float(p.grad.abs().max()) <= 1e-6 * total, name
            assert float(want[name].abs().max()) <= 1e-6 * total, name
            continue
        rel = float(torch.linalg.norm(p.grad - want[name]) / torch.linalg.norm(want[name]))
        assert rel <= GRAD_RTOL, (name, rel)
        worst = max(worst, rel)
    print('achieved: dsd100 background=%s loss rel %.3g, worst gradient rel %.3g'
          % (with_background, loss_rel, worst))


def test_separate_matches_jax(unets):
    """``separate`` against JAX's on the same weights and mixture; the two
    masks are complementary, so the sources rebuild the mixture."""
    jm, params, model, _ = unets['spec_unet_small']
    mix = (0.2 * np.random.default_rng(9).standard_normal((2, 16384))).astype(np.float32)
    ref_v, ref_b = jax.jit(lambda p, m: jax_recipe.separate(jm, p, m))(params, jnp.asarray(mix))
    voice, background = recipe.separate(model, torch.from_numpy(mix))
    assert voice.shape == background.shape == (2, 16384)
    err = max(np.abs(voice.numpy() - np.asarray(ref_v)).max(),
              np.abs(background.numpy() - np.asarray(ref_b)).max())
    print('achieved: separate max abs %.3g' % err)
    assert err <= SEPARATE_TOL
    rec = (voice + background).numpy()
    np.testing.assert_allclose(rec[:, 1024:-1024], mix[:, 1024:-1024], atol=1e-3)


def write_dsd_tree(root, meta, songs):
    """``songs`` songs of 4 one-second chunks each (a 440 Hz voice and a
    seeded noise background) under ``root``, and their meta in ``meta``,
    written by the port."""
    rng = np.random.default_rng(3)
    mixtures, vocals, backgrounds = [], [], []
    for song in range(songs):
        d = os.path.join(root, 'song%d' % song)
        os.makedirs(d)
        for i in range(4):
            v = (0.2 * np.sin(2 * np.pi * 440 * np.arange(44100) / 44100
                              + song)).astype(np.float32)
            b = (0.1 * rng.standard_normal(44100)).astype(np.float32)
            np.save(os.path.join(d, 'mixture.%d.npy' % i), v + b)
            np.save(os.path.join(d, 'voice.%d.npy' % i), v)
            np.save(os.path.join(d, 'background.%d.npy' % i), b)
        mixtures.append(os.path.join(d, 'mixture.npy'))
        vocals.append(os.path.join(d, 'voice.npy'))
        backgrounds.append(os.path.join(d, 'background.npy'))
    DSD100Meta(meta).make_meta(mixtures, vocals, backgrounds)
    return meta


@pytest.fixture(scope='module')
def dsd_meta_dir(tmp_path_factory):
    """The synthetic DSD100 chunk tree of tests/test_separation_maestro.py
    (3 songs: 11 training rows, 1 validation row) and its meta."""
    return write_dsd_tree(str(tmp_path_factory.mktemp('dsd_sep')),
                          str(tmp_path_factory.mktemp('dsd_sep_meta')), 3)


def _trainer(meta_dir, save_dir, max_step, prefix, seed):
    train_loader, valid_loader = dsd_datasets(meta_dir, batch_size=2, num_workers=0,
                                              fix_len=16384, pad_multiple=16384)
    model = build_model('spec_unet_small')
    return recipe.DSD100Trainer(
        model, adam(model.parameters(), 1e-3), train_loader, valid_loader,
        max_step=max_step, valid_max_step=2 if max_step > 2 else 1,
        save_interval=max_step, log_interval=2, save_dir=save_dir, save_prefix=prefix,
        sr=44100, grad_norm=5.0, seed=seed, device='cpu')


def test_dsd100_separation_end_to_end(dsd_meta_dir, tmp_path):
    """Four steps of the recipe, a checkpoint, then ``separate`` on the
    trained net rebuilds a mixture from its two sources."""
    t = _trainer(dsd_meta_dir, str(tmp_path), 4, 'sep', 5)
    assert np.isfinite(t.run()) and t.step == 4
    assert os.path.exists(os.path.join(
        str(tmp_path), 'models', 'sep', 'SpectrogramUNet', 'step_000004.chkpt'))
    mix = torch.from_numpy((np.random.default_rng(9).standard_normal((1, 16384))
                            * 0.2).astype(np.float32))
    voice, background = recipe.separate(t.model, mix)
    assert voice.shape == background.shape == (1, 16384)
    rec = (voice + background).numpy()
    np.testing.assert_allclose(rec[0, 1024:-1024], mix.numpy()[0, 1024:-1024], atol=1e-3)


def test_dsd100_main_entrypoint(dsd_meta_dir, tmp_path):
    best = recipe.main(dsd_meta_dir, str(tmp_path), batch_size=2, num_workers=0,
                       fix_len=16384, max_step=2, valid_max_step=1, save_interval=2,
                       log_interval=2, arch='spec_unet_small', device='cpu')
    assert np.isfinite(best)
    assert os.path.exists(os.path.join(str(tmp_path), 'models', 'dsd100', 'SpectrogramUNet',
                                       'step_000002.chkpt'))


def test_dsd100_use_mesh_raises(dsd_meta_dir, tmp_path, monkeypatch):
    """``use_mesh`` over 2 ranks raises on a global batch of 3, with both
    numbers; the mesh run itself is tests/test_torch_parallel.py's."""
    from pytorch_sound_tpu_torch.parallel import mesh
    monkeypatch.setattr(mesh, 'init_distributed', lambda device: (0, 2, torch.device(device)))
    with pytest.raises(ValueError, match='batch_size 3 does not divide over 2 ranks'):
        recipe.main(dsd_meta_dir, str(tmp_path), batch_size=3, use_mesh=True, device='cpu')


def test_dsd100_meta_with_fewer_rows_than_ranks_raises(dsd_meta_dir):
    """A rank's shard of a meta with fewer rows than ranks would be empty:
    the loaders refuse it, naming both numbers (the fixture's one
    validation row over 2 ranks)."""
    with pytest.raises(ValueError, match='val_meta.json has 1 rows for 2 ranks'):
        dsd_datasets(dsd_meta_dir, batch_size=1, num_workers=0, fix_len=16384, shard=(1, 2))


def test_medleydb_yaml_reader_matches_safe_load():
    """Every bundled MedleyDB metafile: the same dicts (keys in order),
    lists and scalars, of the same types, as ``yaml.safe_load``."""
    def same(a, b):
        if type(a) is not type(b):
            return False
        if isinstance(a, dict):
            return list(a) == list(b) and all(same(a[k], b[k]) for k in a)
        if isinstance(a, list):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        return a == b

    files = sorted(glob.glob(os.path.join(MEDLEYDB_META_DIR, '*.yaml')))
    assert len(files) == 330
    for path in files:
        with open(path, encoding='utf-8') as f:
            text = f.read()
        assert same(parse_yaml(text), yaml.safe_load(text)), path


@pytest.mark.parametrize('text', [
    'a: 1\nb: \'2\'\nc: yes\nd: 1.5\ne:\n- x\n- \'y\'\nf:\n  g: null\n  h: ~\n  i: []\n'
    'j: "q\\u00e9"\nk:\nl: 0x1f\nm: 017\nn: .inf\no: +.5\np: On\nq: oN\nr: 1_000\n',
    'top:\n  - a\n  -\n    b: 2\n  - \'\'\nnext: {}\n',
])
def test_yaml_reader_scalars(text):
    """YAML 1.1's resolution of plain scalars and the block nesting, as
    ``yaml.safe_load`` gives them."""
    assert parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize('text', ['k: &a 1\n', 'k: 2014-01-02\n', 'k: [1, 2]\n',
                                  'k: |\n  x\n', 'top:\n- c: 3\n'])
def test_yaml_reader_refuses_what_it_does_not_read(text):
    """Anchors, timestamps, non-empty flow collections, block scalars and
    compact nested mappings are outside the subset: they raise."""
    with pytest.raises(ValueError):
        parse_yaml(text)


def _tone(sr, seconds, freq, seed=0):
    t = np.arange(int(sr * seconds)) / sr
    rng = np.random.default_rng(seed)
    return (0.4 * np.sin(2 * np.pi * freq * t)
            + 0.01 * rng.standard_normal(len(t))).astype(np.float32)


def _write_song(root, artist, song, stem_names, sr=44100, seconds=2.5):
    """Mix + the named stems at the MedleyDB on-disk layout."""
    song_dir = os.path.join(root, artist, song)
    stem_dir = os.path.join(song_dir, song + '_STEMS')
    os.makedirs(stem_dir, exist_ok=True)
    write_wav(os.path.join(song_dir, song + '_MIX.wav'), _tone(sr, seconds, 220.0), sr)
    for i, name in enumerate(stem_names):
        write_wav(os.path.join(stem_dir, name), _tone(sr, seconds, 330.0 + 50 * i), sr)


@pytest.fixture(scope='module')
def medleydb_root(tmp_path_factory):
    """Two songs of the bundled metadata (one with two vocal stems, one with
    one), through the port's ``Processor.medleydb``."""
    root = str(tmp_path_factory.mktemp('medleydb'))
    _write_song(root, 'AimeeNorwich', 'AimeeNorwich_Child',
                ['AimeeNorwich_Child_STEM_04.wav', 'AimeeNorwich_Child_STEM_05.wav'])
    _write_song(root, 'AHa', 'AHa_TakeOnMe', ['AHa_TakeOnMe_STEM_02.wav'])
    Processor.medleydb(root, wav_subset_seconds=1)
    return root


def test_medleydb_pipeline_end_to_end(medleydb_root):
    meta_dir = os.path.join(medleydb_root, 'meta')
    tables = [read_table_json(os.path.join(meta_dir, name))
              for name in ('train_meta.json', 'val_meta.json')]
    rows = [(t['mixture_filename'][i], t['voice_filename'][i])
            for t in tables for i in range(len(t))]
    assert len(rows) >= 4   # 2 songs x 2.5 s -> 2 one-second partials each
    for mix_path, voice_path in rows:
        assert np.load(mix_path).shape == np.load(voice_path).shape == (44100,)
    assert all(os.path.exists(os.path.join(meta_dir, name))
               for name in ('train_meta_backup.json', 'val_meta_backup.json'))


def test_medleydb_multivocal_merge(medleydb_root):
    """Two vocal stems are summed into one _voice.npy."""
    stem_dir = os.path.join(medleydb_root, 'AimeeNorwich', 'AimeeNorwich_Child',
                            'AimeeNorwich_Child_STEMS')
    merged = np.load(os.path.join(stem_dir, 'AimeeNorwich_Child_STEM_voice.npy'))
    s4 = np.load(os.path.join(stem_dir, 'AimeeNorwich_Child_STEM_04.npy'))
    s5 = np.load(os.path.join(stem_dir, 'AimeeNorwich_Child_STEM_05.npy'))
    np.testing.assert_allclose(merged.squeeze(), s4 + s5, atol=1e-6)


def test_medleydb_loader(medleydb_root):
    train, _ = medley_datasets(os.path.join(medleydb_root, 'meta'), batch_size=2,
                               num_workers=0)
    mix, voice = next(iter(train))[:2]
    assert mix.shape[0] == 2 and mix.shape == voice.shape


def test_musdb18_command_and_loader(tmp_path):
    """``Processor.musdb18``: each song's mixture and vocals wavs chunked into
    npy shards beside them, a meta of (mixture, voice) pairs, batches of
    both columns."""
    rng = np.random.default_rng(4)
    for subset, songs in (('train', 3), ('test', 2)):
        for s in range(songs):
            d = tmp_path / subset / ('song%d' % s)
            d.mkdir(parents=True)
            v = (0.2 * rng.standard_normal(3 * 8192)).astype(np.float32)
            write_wav(str(d / 'vocals.wav'), v, 44100)
            write_wav(str(d / 'mixture.wav'), v + 0.1, 44100)
    Processor.musdb18(str(tmp_path), wav_subset_len=8192)
    table = read_table_json(str(tmp_path / 'meta' / 'all_meta.json'))
    assert table.columns == ['mixture_filename', 'voice_filename'] and len(table) == 10
    for mix_path, voice_path in zip(table['mixture_filename'], table['voice_filename']):
        assert os.path.dirname(mix_path) == os.path.dirname(voice_path)
        np.testing.assert_allclose(np.load(mix_path), np.load(voice_path) + 0.1, atol=1e-6)
    train, _ = musdb_datasets(str(tmp_path / 'meta'), batch_size=2, num_workers=0)
    batch = next(iter(train))
    assert len(batch) == 2 and batch[0].shape == batch[1].shape == (2, 8192)
