"""The port's multi-rank layer (``pytorch_sound_tpu_torch.parallel``) on the
CPU: ranks are processes over gloo (``spawn_ranks``), held against the JAX
package's ``parallel`` on the 8-device virtual mesh of ``conftest.py``.
Mirrors tests/test_trainer.py::test_multihost_data_helpers and
::test_prefetch_straggler_batch_replicates,
tests/test_attention.py::test_ring_attention_matches_dense_on_mesh,
tests/test_e2e_voicebank.py::test_voicebank_end_to_end_mesh,
tests/test_separation_maestro.py::test_maestro_main_entrypoint_on_mesh, the
JAX multi-chip dry run and its ``extract_features`` sharded per host."""

import functools
import os
import warnings

import jax

jax.config.update('jax_platforms', 'cpu')

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pytorch_sound_tpu.data.meta.vctk import VCTKMeta as JaxVCTKMeta  # noqa: E402
from pytorch_sound_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from pytorch_sound_tpu.parallel.data import process_shard_indices as jax_shard  # noqa: E402
from pytorch_sound_tpu.parallel.ring_attention import (  # noqa: E402
    ring_attention as jax_ring_attention)
from pytorch_sound_tpu_torch.data.meta import MetaTable  # noqa: E402
from pytorch_sound_tpu_torch.data.meta.vctk import VCTKMeta  # noqa: E402
from pytorch_sound_tpu_torch.examples import dsd100, maestro, voice_bank  # noqa: E402
from pytorch_sound_tpu_torch.parallel import (process_shard_indices,  # noqa: E402
                                              shard_meta_frame, spawn_ranks)
from pytorch_sound_tpu_torch.parallel.dryrun import dryrun_multigpu  # noqa: E402
from pytorch_sound_tpu_torch.parallel import mesh  # noqa: E402
from pytorch_sound_tpu_torch.scripts.preprocess import Processor  # noqa: E402
from pytorch_sound_tpu_torch.utils.wavio import write_wav  # noqa: E402
from test_torch_enhancement import vb_meta_dir  # noqa: E402,F401 (fixture)
from test_torch_separation import write_dsd_tree  # noqa: E402
from test_torch_transcription import write_maestro_meta  # noqa: E402
import torch_dp_ranks as ranks  # noqa: E402

RING_TOL = 1e-5         # tests/test_attention.py:157


def gloo(fn, world, *args):
    return spawn_ranks(fn, world, 'gloo', 'cpu', *args)


def test_process_shard_indices_match_jax():
    """The strided split, bit for bit, and it covers every row once."""
    for n in (0, 1, 10, 33):
        for count in (1, 2, 3, 4, 8):
            parts = [process_shard_indices(n, i, count) for i in range(count)]
            for i, part in enumerate(parts):
                np.testing.assert_array_equal(part, jax_shard(n, i, count))
            assert sorted(int(j) for p in parts for j in p) == list(range(n))
    np.testing.assert_array_equal(process_shard_indices(7), np.arange(7))   # no group


def test_shard_meta_frame_matches_jax():
    """A rank keeps the same rows of a MetaFrame as a JAX host keeps of its
    pandas frame."""
    rows = {'audio_filename': ['f%02d.wav' % i for i in range(11)],
            'duration': [1.0 + 0.1 * i for i in range(11)], 'speaker': list('abcabcabcab')}
    for rank in range(3):
        ours, theirs = VCTKMeta(), JaxVCTKMeta()
        ours._meta, theirs._meta = MetaTable(dict(rows)), pd.DataFrame(rows)
        assert shard_meta_frame(ours, rank, 3) is ours
        shard_meta_frame(theirs, rank, 3)
        assert list(ours.meta.index) == list(theirs.meta.index)
        for name in rows:
            assert list(ours.meta[name]) == list(theirs.meta[name])


def test_spawn_ranks_forms_a_failed_group_again_and_raises_a_ranks_error(monkeypatch):
    """A group that does not form (here NCCL, which this torch lacks) is
    started again on a fresh store, ``RENDEZVOUS_ATTEMPTS`` times in all,
    then raises with the rank's traceback; an error in ``fn`` raises at
    once, with no second try."""
    monkeypatch.setattr(mesh, 'RENDEZVOUS_ATTEMPTS', 2)
    with pytest.warns(UserWarning, match='attempt 1 of 2') as seen:
        with pytest.raises(RuntimeError, match='rank 0 failed'):
            spawn_ranks(ranks.call, 1, 'nccl', 'cpu')
    assert len([w for w in seen if 'spawn_ranks' in str(w.message)]) == 1
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        with pytest.raises(RuntimeError, match="invalid literal for int"):
            spawn_ranks(ranks.call, 1, 'gloo', 'cpu', functools.partial(int, 'x'))


def test_prefetch_straggler_batch_is_kept_whole():
    """Each rank prefetches its rows [r B / W, (r + 1) B / W) of a batch that
    divides over the ranks, and the whole of one that does not (JAX
    replicates it)."""
    batches = [[np.arange(8 * 16, dtype=np.float32).reshape(8, 16), np.arange(8)],
               [np.arange(3 * 16, dtype=np.float32).reshape(3, 16), np.arange(3)]]
    out = gloo(ranks.prefetch_rows, 2, batches)
    for rank, (full, strag) in enumerate(out):
        for got, want in zip(full, batches[0]):
            np.testing.assert_array_equal(got, want[4 * rank:4 * (rank + 1)])
        for got, want in zip(strag, batches[1]):
            np.testing.assert_array_equal(got, want)


@pytest.fixture(scope='module')
def ring_case():
    """(q, k, v, ring attention on 4 gloo ranks: ``ranks.ring``)."""
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((2, 2, 128, 16)).astype(np.float32) for _ in range(3))
    return q, k, v, gloo(ranks.ring, 4, q, k, v)


@pytest.mark.parametrize('size', [1, 2, 4])
def test_ring_attention_matches_jax_and_dense(ring_case, size):
    """Every local strategy (dense, blockwise, auto) over rings of 1, 2 and 4
    ranks against JAX's ring attention over its 8 devices and dense
    attention, within 1e-5; every ring of a size gives the same output."""
    q, k, v, out = ring_case
    mesh = jax_make_mesh(axis_names=('seq',))
    theirs = np.asarray(jax_ring_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           mesh, axis='seq'))
    s = np.einsum('nhqd,nhkd->nhqk', q.astype(np.float64), k) / 4.0
    p = np.exp(s - s.max(-1, keepdims=True))
    dense = np.einsum('nhqk,nhkd->nhqd', p / p.sum(-1, keepdims=True), v)
    for local in ('auto', 'dense', 'blockwise'):
        rings = [np.concatenate([out[r][size, local] for r in range(start, start + size)],
                                axis=2) for start in range(0, 4, size)]
        for got in rings:
            np.testing.assert_array_equal(got, rings[0])
        np.testing.assert_allclose(rings[0], theirs, atol=RING_TOL, err_msg=local)
        np.testing.assert_allclose(rings[0], dense, atol=RING_TOL, err_msg=local)


def test_dryrun_multigpu_on_cpu_ranks(capsys):
    """The dry run over 2 gloo ranks: the VoiceBank and HiFi-GAN steps give
    finite losses every rank agrees on, ring attention matches dense."""
    out = dryrun_multigpu(2, 'cpu')
    assert np.isfinite(out['loss']) and np.isfinite(out['gan_loss'])
    assert out['ring_max_abs_err'] <= RING_TOL
    assert 'dryrun_multigpu OK: 2 ranks on cpu' in capsys.readouterr().out


@pytest.fixture(scope='module')
def dsd_two_rank_meta_dir(tmp_path_factory):
    """tests/test_torch_separation.py's DSD100 tree at 5 songs: 18 training
    rows and 2 validation rows, one a rank."""
    return write_dsd_tree(str(tmp_path_factory.mktemp('dsd_dp')),
                          str(tmp_path_factory.mktemp('dsd_dp_meta')), 5)


@pytest.fixture(scope='module')
def maestro_two_rank_meta_dir(tmp_path_factory):
    """tests/test_torch_transcription.py's Maestro tree at 20 performances:
    18 training rows and 2 validation rows, one a rank."""
    return write_maestro_meta(str(tmp_path_factory.mktemp('maestro_dp')), 20)


@pytest.fixture(scope='module')
def recipe_runs(vb_meta_dir, dsd_two_rank_meta_dir, maestro_two_rank_meta_dir,
                tmp_path_factory):
    """{recipe: (save_dir, each rank's best validation loss)}: the three
    recipes' ``main(use_mesh=True)`` for one step and a validation, as
    torchrun would run them on 2 ranks (one spawn for the three)."""
    common = dict(num_workers=0, max_step=1, valid_max_step=1, save_interval=1,
                  log_interval=1, use_mesh=True, device='cpu')
    jobs = {'voice_bank': (voice_bank.main, vb_meta_dir,
                           dict(batch_size=4, fix_len=8192, arch='spec_masker_small')),
            'dsd100': (dsd100.main, dsd_two_rank_meta_dir,
                       dict(batch_size=2, fix_len=16384, arch='spec_unet_small')),
            'maestro': (maestro.main, maestro_two_rank_meta_dir,
                        dict(batch_size=4, fix_len=32768, arch='frame_pitch_small'))}
    dirs = {name: str(tmp_path_factory.mktemp(name)) for name in jobs}
    fns = [functools.partial(main, meta, dirs[name], **common, **kw)
           for name, (main, meta, kw) in jobs.items()]
    out = gloo(ranks.call, 2, *fns)
    return {name: (dirs[name], [r[i] for r in out]) for i, name in enumerate(jobs)}


@pytest.mark.parametrize('recipe, model', [('voice_bank', 'SpectrogramMaskNet'),
                                           ('dsd100', 'SpectrogramUNet'),
                                           ('maestro', 'FramePitchNet')])
def test_recipe_main_on_two_ranks(recipe_runs, recipe, model):
    """``main(use_mesh=True)`` over 2 ranks (the VoiceBank batch of 4 as 2
    rows a rank of each rank's meta shard; DSD100's two validation rows,
    one a rank; Maestro, on the mesh by default, its log-mel per rank):
    every rank ends with the same finite best validation loss, and rank 0
    wrote the checkpoint."""
    save_dir, best = recipe_runs[recipe]
    assert np.isfinite(best[0]) and best[0] == best[1], best
    assert os.path.exists(os.path.join(save_dir, 'models', recipe, model, 'step_000001.chkpt'))


def test_extract_features_over_two_ranks(tmp_path):
    """Each rank extracts its strided shard of the sorted wav list: the
    shards are disjoint, the counts are the rank's, and their union is the
    1-rank output bit for bit."""
    rng = np.random.default_rng(0)
    src = tmp_path / 'in'
    (src / 'spk').mkdir(parents=True)
    for i, (sr, sec) in enumerate(((48000, 1.0), (48000, 0.5), (22050, 1.2), (48000, 1.37),
                                   (44100, 0.7), (22050, 0.4), (48000, 0.9))):
        write_wav(str(src / 'spk' / ('u%d.wav' % i)),
                  (0.1 * rng.standard_normal(int(sr * sec))).astype(np.float32), sr,
                  dtype='int16')
    kw = dict(batch_size=2, pad_seconds=1.5, device='cpu')
    whole = Processor.extract_features(str(src), str(tmp_path / 'one'), **kw)
    extract = functools.partial(Processor.extract_features, str(src), str(tmp_path / 'two'),
                                **kw)
    stats = [s[0] for s in gloo(ranks.call, 2, extract)]
    names = sorted(os.listdir(tmp_path / 'one'))
    assert len(names) == whole['utterances'] == 7
    assert [s['utterances'] for s in stats] == [4, 3]
    assert sorted(os.listdir(tmp_path / 'two')) == names
    for name in names:
        np.testing.assert_array_equal(np.load(str(tmp_path / 'two' / name)),
                                      np.load(str(tmp_path / 'one' / name)), err_msg=name)
