"""The port's Transformer-TTS against the JAX package's on the CPU: the cases
of tests/test_tts.py (shapes, causality, text padding, the teacher-forced
recipe, synthesis, the text -> mel -> wav paths through HiFi-GAN v2 and
Griffin-Lim) on the port, and parity with the flax model at its weights
carried over by ``load_jax_params``: ``forward``'s mel and stop logits within
1e-4, ``decode_step`` against ``decode_mel``'s column t within 1e-5,
``synthesize``'s frame count exactly and its mel within 1e-4, and
``TTSTrainer.forward``'s loss on one batch within 1e-5 relative."""

import jax

jax.config.update('jax_platforms', 'cpu')

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pytorch_sound_tpu.examples import ljspeech_tts as jax_recipe  # noqa: E402
from pytorch_sound_tpu.models import build_model as jax_build_model  # noqa: E402
from pytorch_sound_tpu.models.tts import synthesize as jax_synthesize  # noqa: E402
from pytorch_sound_tpu_torch import settings  # noqa: E402
from pytorch_sound_tpu_torch.examples.ljspeech_tts import TTSTrainer  # noqa: E402
from pytorch_sound_tpu_torch.models import build_model  # noqa: E402
from pytorch_sound_tpu_torch.models.modules import load_jax_params  # noqa: E402
from pytorch_sound_tpu_torch.models.tts import STOP_CHECK_FRAMES, synthesize  # noqa: E402
from pytorch_sound_tpu_torch.ops.mel import db_to_log  # noqa: E402
from pytorch_sound_tpu_torch.trainer import adamw  # noqa: E402

FWD_TOL = 1e-4
STEP_TOL = 1e-5
SYNTH_TOL = 1e-4
LOSS_RTOL = 1e-5


@pytest.fixture(scope='module')
def small_tts():
    """transformer_tts_small in both packages at the flax initialisation,
    a text batch whose second row ends in padding, a mel batch."""
    jm = jax_build_model('transformer_tts_small')
    text = np.random.default_rng(0).integers(1, 60, (2, 12))
    text[1, 9:] = 0
    mel = np.random.default_rng(1).standard_normal((2, 80, 20)).astype(np.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), text, mel)
    model = load_jax_params(build_model('transformer_tts_small'),
                            jax.tree_util.tree_map(np.asarray, params)).eval()
    return model, jm, params, text, mel


def _run(model, text, mel):
    with torch.no_grad():
        out, stop = model(torch.from_numpy(np.asarray(text)), torch.from_numpy(mel))
    return out.numpy(), stop.numpy()


def test_tts_shapes(small_tts):
    model, _, _, text, mel = small_tts
    mel_out, stop = _run(model, text, mel)
    assert mel_out.shape == (2, 80, 20)
    assert stop.shape == (2, 20)


def test_tts_decoder_is_causal(small_tts):
    """Changing future mel frames must not change earlier predictions."""
    model, _, _, text, mel = small_tts
    out1, _ = _run(model, text, mel)
    mel2 = mel.copy()
    mel2[:, :, 10:] = 99.0
    out2, _ = _run(model, text, mel2)
    np.testing.assert_allclose(out1[:, :, :10], out2[:, :, :10], atol=1e-5)
    assert np.abs(out1[:, :, 10:] - out2[:, :, 10:]).max() > 1e-3


def test_tts_text_padding_is_masked(small_tts):
    """Extra padding ids (0) in the text must leave the output unchanged."""
    model, _, _, _, mel = small_tts
    out1, _ = _run(model, np.array([[5, 6, 7, 0, 0, 0]]), mel[:1])
    out2, _ = _run(model, np.array([[5, 6, 7, 0, 0, 0, 0, 0]]), mel[:1])
    np.testing.assert_allclose(out1, out2, atol=1e-5)


def test_forward_matches_jax(small_tts):
    model, jm, params, text, mel = small_tts
    out, stop = _run(model, text, mel)
    j_out, j_stop = jax.jit(jm.apply)(params, text, mel)
    assert float(np.abs(out - np.asarray(j_out)).max()) <= FWD_TOL
    assert float(np.abs(stop - np.asarray(j_stop)).max()) <= FWD_TOL


def test_decode_step_matches_decode_mel(small_tts):
    """Frame by frame through the KV caches, each step is decode_mel's column
    t, and the JAX decode_step's."""
    model, jm, params, text, mel = small_tts
    tt = torch.from_numpy(text)
    mel_t = torch.from_numpy(mel)
    t_max = mel.shape[2]
    with torch.no_grad():
        memory, pad_mask = model.encode_text(tt)
        full_out, full_stop = model.decode_mel(memory, pad_mask, mel_t)
        mem_k, mem_v = model.precompute_cross_kv(memory)
        shape = (model.dec_layers, 2, t_max, model.heads, model.hidden_dim // model.heads)
        self_k, self_v = torch.zeros(shape), torch.zeros(shape)
        steps = []
        for t in range(t_max):
            out, stop, self_k, self_v = model.decode_step(mem_k, mem_v, pad_mask, mel_t[:, :, t],
                                                          t, self_k, self_v)
            steps.append((out.numpy(), stop.numpy()))
    step_out = np.stack([o for o, _ in steps], axis=2)
    step_stop = np.stack([s for _, s in steps], axis=1)
    assert float(np.abs(step_out - full_out.numpy()).max()) <= STEP_TOL
    assert float(np.abs(step_stop - full_stop.numpy()).max()) <= STEP_TOL

    j_mem, j_mask = jm.apply(params, text, method=type(jm).encode_text)
    j_k, j_v = jm.apply(params, j_mem, method=type(jm).precompute_cross_kv)
    j_sk = j_sv = np.zeros(shape, np.float32)
    j_step = jax.jit(lambda *args: jm.apply(params, *args, method=type(jm).decode_step))
    for t in range(t_max):
        j_out, j_stop, j_sk, j_sv = j_step(j_k, j_v, j_mask, mel[:, :, t], t, j_sk, j_sv)
        assert float(np.abs(steps[t][0] - np.asarray(j_out)).max()) <= STEP_TOL, t
        assert float(np.abs(steps[t][1] - np.asarray(j_stop)).max()) <= STEP_TOL, t


def _stopping_at(model, jm, params, text, frames, stops):
    """Both models with a stop head that rows n cross at step ``stops[n]``:
    its weights solve, by least squares, logit = 4 (t - stops[n] + 0.5) on
    the decoder states of the never-stopping run (the stop head feeds
    nothing back, so the frames stay those of that run)."""
    mel = synthesize(model, text, max_frames=frames, stop_threshold=1.0)
    states = []
    hook = model.stop_head.register_forward_hook(lambda m, i, o: states.append(i[0]))
    with torch.no_grad():
        go = torch.full((2, 80, 1), db_to_log(-50.0))
        model(torch.from_numpy(text), torch.cat([go, mel], dim=2))
    hook.remove()
    y = states[0].double().numpy()                         # (N, frames, C)
    t = np.arange(y.shape[1])
    target = np.stack([4.0 * (t - s + 0.5) for s in stops])
    a = np.concatenate([y, np.ones(y.shape[:2] + (1,))], axis=2).reshape(-1, y.shape[2] + 1)
    w = np.linalg.lstsq(a, target.ravel(), rcond=None)[0].astype(np.float32)
    tree = jax.tree_util.tree_map(np.asarray, params)
    tree['params']['stop_head'] = {'kernel': w[:-1, None], 'bias': w[-1:]}
    port = load_jax_params(build_model('transformer_tts_small'), tree).eval()
    return port, tree


@pytest.mark.parametrize('case', ['immediate', 'checked', 'trimmed', 'never'])
def test_synthesize_matches_jax(small_tts, case):
    """The frame count exactly and the mel within 1e-4: at a threshold every
    row passes at its first step; with a stop head the last row crosses at
    step 20 (the loop sees it at its check after step 32 and trims to 21
    frames) or at step 24 of 30 (the loop runs out, the output is trimmed
    to 25); and at 1.0, which no row passes."""
    model, jm, params, text, _ = small_tts
    frames, thr, expected = {'immediate': (30, 0.0, 1), 'never': (30, 1.0, 29),
                             'checked': (40, 0.5, 21), 'trimmed': (30, 0.5, 25)}[case]
    if thr == 0.5:
        model, params = _stopping_at(model, jm, params, text, frames - 1,
                                     (7, expected - 1))
    mel = synthesize(model, text, max_frames=frames, stop_threshold=thr).numpy()
    j_mel = np.asarray(jax_synthesize(jm, params, text, max_frames=frames, stop_threshold=thr))
    assert mel.shape == j_mel.shape == (2, 80, expected), (mel.shape, j_mel.shape)
    assert float(np.abs(mel - j_mel).max()) <= SYNTH_TOL
    assert np.isfinite(mel).all()
    if case == 'checked':
        assert STOP_CHECK_FRAMES < expected < 2 * STOP_CHECK_FRAMES < frames


def test_tts_synthesize(small_tts):
    model, _, _, text, _ = small_tts
    mel = synthesize(model, text, max_frames=12)
    assert mel.shape[0] == 2 and mel.shape[1] == 80
    assert 1 <= mel.shape[2] <= 11
    assert bool(torch.isfinite(mel).all())


def _tts_batch(seed):
    rng = np.random.default_rng(seed)
    wav = (rng.standard_normal((2, 8192)) * 0.2).astype(np.float32)
    text = rng.integers(1, 60, (2, 16)).astype(np.int64)
    mask = np.ones_like(wav)
    mask[:, 6000:] = 0
    return [wav, text, mask]


def test_tts_trainer_loss_matches_jax(small_tts):
    """TTSTrainer.forward on one batch (log-mel targets, the frame mask, the
    go frame, masked L1 + stop BCE) against the JAX recipe's forward."""
    model, jm, params, _, _ = small_tts
    wav, text, mask = _tts_batch(3)
    port = object.__new__(TTSTrainer)          # forward reads self.model only
    port.model = model
    with torch.no_grad():
        loss, meta = port.forward(*(torch.from_numpy(x) for x in (wav, text, mask)),
                                  is_logging=True)
    ref = object.__new__(jax_recipe.TTSTrainer)
    ref.model = jm
    j_meta = jax.jit(lambda *args: {k: v for k, (v, _) in ref.forward(
        *args, is_logging=True)[1].items() if k in ('loss', 'mel_l1', 'stop_bce')})(
        params, wav, text, mask)
    for key in ('loss', 'mel_l1', 'stop_bce'):
        got, want = float(meta[key][0]), float(j_meta[key])
        assert abs(got - want) <= LOSS_RTOL * abs(want), (key, got, want)
    assert tuple(meta['mel_pred'][0].shape) == (80, 33)


def test_tts_training_smoke(tmp_path):
    rng_batches = [_tts_batch(10 + i) for i in range(3)]
    torch.manual_seed(0)
    model = build_model('transformer_tts_small')
    t = TTSTrainer(model, adamw(model.parameters(), 1e-3), rng_batches, rng_batches,
                   max_step=3, valid_max_step=1, save_interval=3, log_interval=2,
                   save_dir=str(tmp_path), save_prefix='tts', seed=4, device='cpu')
    best = t.run()
    assert np.isfinite(best)


def test_tts_to_vocoder_pipeline(small_tts):
    """Text -> mel -> waveform through the bundled HiFi-GAN v2 on the CPU."""
    from pytorch_sound_tpu_torch.interface.hifi_gan import InterfaceHifiGAN
    model, _, _, text, _ = small_tts
    mel = synthesize(model, text[:1], max_frames=16)
    wav = InterfaceHifiGAN('hifi_gan_v2', device='cpu').decode(mel)
    assert tuple(wav.shape) == (1, 1, mel.shape[2] * 256)
    assert bool(torch.isfinite(wav).all())


def test_tts_griffin_lim_no_checkpoint_pipeline(small_tts):
    """Text -> mel -> waveform with no vocoder checkpoint: the mel's
    pseudo-inverse magnitude and Griffin-Lim phase recovery."""
    from pytorch_sound_tpu_torch.ops.griffin_lim import griffin_lim
    from pytorch_sound_tpu_torch.ops.mel import cached_mel_filter

    model, _, _, text, _ = small_tts
    mel = synthesize(model, text[:1], max_frames=12).numpy()
    mel = np.tile(mel, (1, 1, int(np.ceil(16 / mel.shape[2]))))
    frames = mel.shape[2]
    fb = cached_mel_filter(settings.SAMPLE_RATE, settings.N_FFT, settings.MEL_SIZE, 0.0,
                           float(settings.MEL_MAX))
    mag = np.maximum(np.linalg.pinv(fb) @ np.exp(mel[0]), 0.0)
    wav = griffin_lim(torch.from_numpy(mag[None].astype(np.float32)), settings.N_FFT,
                      settings.HOP_LENGTH, settings.WIN_LENGTH, n_iter=8, momentum=0.9)
    assert wav.ndim == 2 and wav.shape[0] == 1
    assert wav.shape[1] >= (frames - 1) * settings.HOP_LENGTH
    assert bool(torch.isfinite(wav).all())
