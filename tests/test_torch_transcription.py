"""The port's transcription path against the JAX package's on the CPU.

The Maestro cases of ``tests/test_separation_maestro.py`` (shapes, the meta
and its loader, the recipe end to end, ``main``; the mesh case runs over 2
ranks in tests/test_torch_parallel.py, and here a batch that does not divide
over the ranks raises) on the port, and parity with JAX:

- ``FramePitchNet`` logits at carried-over flax weights within 1e-4 of
  their peak (small, and base at T = 64);
- the roll's frame index (``roll_index``) exactly JAX's ``_align_roll``
  over n = 1 ... 2000 frames, float32 rounding included;
- one ``MaestroTrainer.forward`` (its log-mel by the log-mel kernel's plain
  version on the CPU) loss within 1e-5 relative, gradients within 1e-4
  relative per parameter, against ``jax.value_and_grad``;
- the Maestro meta read from the released records ``.json``, a
  column-oriented ``.json`` and the ``.csv`` as pandas reads them, the
  frames ``make_meta`` writes byte-identical to the JAX package's, and the
  loader's batches (audio, the piano roll from the MIDI column) bit-identical
  to JAX's after the same seed.
"""

import json
import os
import random
import struct

import jax

jax.config.update('jax_platforms', 'cpu')

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pytorch_sound_tpu.data.meta.maestro import MaestroMeta as JaxMaestroMeta  # noqa: E402
from pytorch_sound_tpu.data.meta.maestro import get_datasets as jax_datasets  # noqa: E402
from pytorch_sound_tpu.examples import maestro as jax_recipe  # noqa: E402
from pytorch_sound_tpu.models import build_model as jax_build_model  # noqa: E402
import pytorch_sound_tpu.models.transcription  # noqa: E402,F401
from pytorch_sound_tpu_torch.data.meta.maestro import MaestroMeta, get_datasets  # noqa: E402
from pytorch_sound_tpu_torch.examples import maestro as recipe  # noqa: E402
from pytorch_sound_tpu_torch.models import build_model  # noqa: E402
from pytorch_sound_tpu_torch.models.modules import load_jax_params  # noqa: E402
from pytorch_sound_tpu_torch.trainer import adamw  # noqa: E402
from pytorch_sound_tpu_torch.utils.wavio import write_wav  # noqa: E402

LOGIT_RTOL = 1e-4          # logits, max abs error over the reference's peak
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4           # ||g_port - g_jax|| / ||g_jax|| per parameter


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def random_params(jm, x, seed):
    """Seeded random weights in a flax model's parameter shapes (found
    without running its init): kernels at 1 / sqrt(fan-in), biases around 0
    and norm scales around 1."""
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
def pitch_nets():
    """frame_pitch_small and frame_pitch_base at seeded random weights: the
    flax model with its jitted apply, the port's model with the weights
    loaded."""
    out = {}
    for i, arch in enumerate(('frame_pitch_small', 'frame_pitch_base')):
        jm = jax_build_model(arch)
        params = random_params(jm, jnp.ones((1, 80, 8)), i)
        out[arch] = (jm, params, load_jax_params(build_model(arch), _tree(params)),
                     jax.jit(jm.apply))
    return out


def test_frame_pitch_shapes():
    model = build_model('frame_pitch_small')
    mel = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 80, 64))
                           .astype(np.float32))
    with torch.no_grad():
        assert model(mel).shape == (2, 128, 64)


@pytest.mark.parametrize('arch,t', [('frame_pitch_small', 64), ('frame_pitch_small', 37),
                                    ('frame_pitch_base', 64)])
def test_frame_pitch_matches_jax(pitch_nets, arch, t):
    """The dilated 'SAME' convs (kernel 3 at dilation 2^i pads 2^i a side),
    flax's LayerNorm eps and tanh GELU, the Dense head."""
    _, params, model, apply = pitch_nets[arch]
    mel = np.random.default_rng(t).standard_normal((2, 80, t)).astype(np.float32)
    ref = np.asarray(apply(params, jnp.asarray(mel)))
    with torch.no_grad():
        out = model(torch.from_numpy(mel)).numpy()
    assert out.shape == ref.shape == (2, 128, t)
    rel = np.abs(out - ref).max() / np.abs(ref).max()
    print('achieved: %s T=%d logits max abs / peak %.3g' % (arch, t, rel))
    assert rel <= LOGIT_RTOL


def test_roll_index_is_jax_exactly():
    """frame * 256 / 44100 * 100 truncated, in float32 as JAX computes it:
    for every n = 1 ... 2000 the port's index is JAX's. JAX's result is
    elementwise in the frame, so its n = 2000 vector holds every shorter n's
    as a prefix (checked at n = 442 and 1765, just past frames where the
    exact value is an integer, multiples of 441); a roll shorter than the
    frames is clipped to its last column."""
    t_roll = 1200                     # past frame 1999's 1160: no clip
    roll = jnp.arange(t_roll, dtype=jnp.float32)[None, None, :]
    ref = {n: np.asarray(jax_recipe.MaestroTrainer._align_roll(None, roll, n))[0, 0]
           .astype(np.int64) for n in (2000, 442, 1765)}
    for n, idx in ref.items():
        np.testing.assert_array_equal(idx, ref[2000][:n])
    for n in range(1, 2001):
        np.testing.assert_array_equal(recipe.roll_index(n, t_roll), ref[2000][:n])
    # the float32 rounding decides these (exact values 256, 512, 768, 1024)
    print('frames 441k ->', [int(ref[2000][k]) for k in (441, 882, 1323, 1764)])
    short = np.asarray(jax_recipe.MaestroTrainer._align_roll(None, roll[..., :300], 513))
    np.testing.assert_array_equal(recipe.roll_index(513, 300), short[0, 0].astype(np.int64))
    rolls = np.random.default_rng(2).integers(0, 100, (2, 128, 300)).astype(np.float32)
    np.testing.assert_array_equal(
        recipe.align_roll(torch.from_numpy(rolls), 513).numpy(),
        np.asarray(jax_recipe.MaestroTrainer._align_roll(None, jnp.asarray(rolls), 513)))


def test_maestro_loss_and_gradients_match_jax(pitch_nets):
    """One batch through ``MaestroTrainer.forward`` (the log-mel, the
    aligned roll, the BCE, precision and recall) against
    ``jax.value_and_grad`` of the JAX forward, at the same weights."""
    jm, params, _, _ = pitch_nets['frame_pitch_small']
    rng = np.random.default_rng(12)
    audio = (0.1 * rng.standard_normal((2, 32768))).astype(np.float32)
    roll = (rng.random((2, 128, 150)) < 0.05).astype(np.float32) * 90
    ref = object.__new__(jax_recipe.MaestroTrainer)       # forward reads self.model only
    ref.model = jm

    def loss_fn(p, a, r):
        loss, meta = ref.forward(p, a, r, is_logging=True)
        return loss, {k: v for k, (v, _) in meta.items()}     # values, not LogTypes

    (ref_loss, ref_meta), ref_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, jnp.asarray(audio), jnp.asarray(roll))

    model = load_jax_params(build_model('frame_pitch_small'), _tree(params))
    port = object.__new__(recipe.MaestroTrainer)
    port.model = model
    loss, meta = port.forward(torch.from_numpy(audio), torch.from_numpy(roll), is_logging=True)
    loss.backward()
    loss_rel = abs(float(loss.detach()) - float(ref_loss)) / abs(float(ref_loss))
    assert loss_rel <= LOSS_RTOL
    np.testing.assert_allclose(meta['mel'][0].numpy(), np.asarray(ref_meta['mel']), atol=1e-4)
    for key in ('precision', 'recall'):
        assert abs(float(meta[key][0]) - float(ref_meta[key])) <= 1e-6, key
    want = load_jax_params(build_model('frame_pitch_small'), _tree(ref_grads)).state_dict()
    worst = 0.0
    for name, p in model.named_parameters():
        rel = float(torch.linalg.norm(p.grad - want[name]) / torch.linalg.norm(want[name]))
        assert rel <= GRAD_RTOL, (name, rel)
        worst = max(worst, rel)
    print('achieved: maestro loss rel %.3g, worst gradient rel %.3g, mel max abs %.3g'
          % (loss_rel, worst, np.abs(meta['mel'][0].numpy() - np.asarray(ref_meta['mel'])).max()))


def _write_tiny_midi(path, pitches=(60, 64, 67)):
    track = b'\x00' + bytes([0xFF, 0x51, 0x03]) + (500000).to_bytes(3, 'big')
    for p in pitches:
        track += b'\x00' + bytes([0x90, p, 90])
    # delta 192 ticks (2 beats) as a proper varlen: 0x81 0x40
    track += bytes([0x81, 0x40]) + bytes([0x80, pitches[0], 0])
    for p in pitches[1:]:
        track += b'\x00' + bytes([0x80, p, 0])
    track += b'\x00' + bytes([0xFF, 0x2F, 0x00])
    data = b'MThd' + struct.pack('>IHHH', 6, 0, 1, 96)
    data += b'MTrk' + struct.pack('>I', len(track)) + track
    with open(path, 'wb') as f:
        f.write(data)


def _maestro_tree(root, n=12):
    """The tree of tests/test_separation_maestro.py: 2 s noise wavs at 44.1
    kHz, a tiny MIDI file each, the official metadata's rows."""
    rng = np.random.default_rng(4)
    rows = {'canonical_composer': [], 'canonical_title': [], 'split': [], 'year': [],
            'midi_filename': [], 'audio_filename': [], 'duration': []}
    os.makedirs(os.path.join(root, 'data'))
    for i in range(n):
        wav_rel, mid_rel = 'data/perf%d.wav' % i, 'data/perf%d.midi' % i
        write_wav(os.path.join(root, wav_rel),
                  (0.1 * rng.standard_normal(44100 * 2)).astype(np.float32), 44100)
        _write_tiny_midi(os.path.join(root, mid_rel), pitches=(60 + i, 64, 67))
        rows['canonical_composer'].append('Composer %d' % (i % 3))
        rows['canonical_title'].append('Sonata No. %d, "Op. %d"' % (i, 10 + i))
        rows['split'].append('train')
        rows['year'].append(2004 + i % 5)
        rows['midi_filename'].append(mid_rel)
        rows['audio_filename'].append(wav_rel)
        rows['duration'].append(2.0 + i * 0.123456789)
    return rows


def write_maestro_meta(root, n=12):
    """The Maestro tree of ``n`` performances under ``root`` with its
    metadata as the released .json (records), and the frames the port's
    ``make_meta`` writes from it."""
    rows = _maestro_tree(root, n)
    records = [dict(zip(rows, vals)) for vals in zip(*rows.values())]
    with open(os.path.join(root, 'maestro-v1.0.0.json'), 'w') as f:
        json.dump(records, f)
    random.seed(0)
    MaestroMeta(os.path.join(root, 'maestro-v1.0.0.json')).make_meta()
    return root


@pytest.fixture(scope='module')
def maestro_meta_dir(tmp_path_factory):
    """The 12-performance tree (11 training rows, 1 validation row)."""
    return write_maestro_meta(str(tmp_path_factory.mktemp('maestro')))


def _same_table(table, frame):
    assert table.columns == list(frame.columns)
    assert list(table.index) == list(frame.index)
    for name in table.columns:
        for got, want in zip(table[name], frame[name]):
            assert type(got) is type(want.item() if hasattr(want, 'item') else want), \
                (name, got, want)
            assert got == want, (name, got, want)


@pytest.mark.parametrize('form', ['records', 'columns', 'csv'])
def test_maestro_meta_forms_read_as_pandas(tmp_path, form):
    """The official metadata in each form the meta takes, against the JAX
    meta's reading of the same file (pandas'); another extension raises in
    both packages."""
    rows = _maestro_tree(str(tmp_path), n=5)
    path = str(tmp_path / ('meta.csv' if form == 'csv' else 'meta.json'))
    if form == 'records':
        with open(path, 'w') as f:
            json.dump([dict(zip(rows, vals)) for vals in zip(*rows.values())], f)
    elif form == 'columns':
        pd.DataFrame(rows).to_json(path)
    else:
        pd.DataFrame(rows).to_csv(path, index=False)
    _same_table(MaestroMeta(path).meta, JaxMaestroMeta(path).meta)
    other = str(tmp_path / 'meta.parquet')
    open(other, 'w').close()
    for cls in (MaestroMeta, JaxMaestroMeta):
        with pytest.raises(RuntimeError, match='unsupported meta format'):
            cls(other)


def test_maestro_make_meta_writes_the_jax_bytes(tmp_path):
    """``make_meta`` of both packages from the same official file after the
    same seed: the three frames byte-identical."""
    written = []
    for name, cls in (('port', MaestroMeta), ('jax', JaxMaestroMeta)):
        root = str(tmp_path / name)
        os.makedirs(root)
        rows = _maestro_tree(root, n=12)
        # the same rows under both roots once the paths are absolutised
        pd.DataFrame(rows).to_json(os.path.join(root, 'maestro-v1.0.0.json'))
        random.seed(3)
        cls(os.path.join(root, 'maestro-v1.0.0.json')).make_meta()
        escaped = root.replace('/', '\\/')                  # as JSON writes it
        written.append({f: open(os.path.join(root, f)).read().replace(escaped, 'ROOT')
                        for f in MaestroMeta.frame_file_names})
    assert written[0] == written[1]


def test_maestro_loader_batches_are_jax_batches(maestro_meta_dir):
    """The meta the port wrote, through both packages' loaders after the same
    numpy seed: the same crops and the same piano rolls (the MIDI column,
    not cropped with the audio; the roll's time axis padded to a multiple
    of 32)."""
    batches = []
    for make in (get_datasets, jax_datasets):
        np.random.seed(7)
        train_loader, _ = make(maestro_meta_dir, batch_size=2, num_workers=0,
                               fix_len=32768, pad_multiple=32768)
        batches.append(next(iter(train_loader)))
    (audio, roll), (jax_audio, jax_roll) = batches[0][:2], batches[1][:2]
    assert audio.shape == (2, 32768) and roll.shape[:2] == (2, 128)
    assert roll.shape[2] % 32 == 0 and roll.max() == 90
    np.testing.assert_array_equal(audio, jax_audio)
    np.testing.assert_array_equal(roll, jax_roll)


def test_maestro_end_to_end(maestro_meta_dir, tmp_path):
    train_loader, valid_loader = get_datasets(maestro_meta_dir, batch_size=2, num_workers=0,
                                              fix_len=32768, pad_multiple=32768)
    model = build_model('frame_pitch_small')
    t = recipe.MaestroTrainer(
        model, adamw(model.parameters(), 1e-3), train_loader, valid_loader, max_step=3,
        valid_max_step=1, save_interval=3, log_interval=2, save_dir=str(tmp_path),
        save_prefix='maestro', sr=44100, grad_norm=3.0, seed=6, device='cpu')
    assert np.isfinite(t.run()) and t.step == 3


def test_maestro_main_entrypoint(maestro_meta_dir, tmp_path):
    """``main`` with its default ``use_mesh=True``: on the CPU (or one
    visible card) it runs without a mesh, as JAX does on one device."""
    best = recipe.main(maestro_meta_dir, str(tmp_path), batch_size=2, num_workers=0,
                       fix_len=32768, max_step=2, valid_max_step=1, save_interval=2,
                       log_interval=2, arch='frame_pitch_small', device='cpu')
    assert np.isfinite(best)
    assert os.path.exists(os.path.join(str(tmp_path), 'models', 'maestro', 'FramePitchNet',
                                       'step_000002.chkpt'))


def test_maestro_main_refuses_several_cards(maestro_meta_dir, tmp_path, monkeypatch):
    """Over several cards (8 ranks, as torchrun would give them) the recipe
    goes data parallel by default, as JAX does over several devices, and
    refuses a global batch that does not divide over them, with both
    numbers; the mesh run itself is tests/test_torch_parallel.py's."""
    from pytorch_sound_tpu_torch.parallel import mesh
    monkeypatch.setattr(mesh, 'init_distributed', lambda device: (0, 8, torch.device(device)))
    with pytest.raises(ValueError, match='batch_size 4 does not divide over 8 ranks'):
        recipe.main(maestro_meta_dir, str(tmp_path), batch_size=4, num_workers=0,
                    fix_len=32768, max_step=2, arch='frame_pitch_small', device='cpu')
