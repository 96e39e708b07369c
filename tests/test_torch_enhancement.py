"""The VoiceBank enhancement recipe of the port against the JAX package's on
the CPU: the cases of ``tests/test_e2e_voicebank.py`` (the mesh case runs over
2 ranks in tests/test_torch_parallel.py; here a batch that does not divide
over the ranks raises), and ``spec_masker`` at carried-over weights
(``spec_masker_small`` at 4 x 8192): the mask net's forward, the trainer's
loss, the parameters after one Adam step, and ``enhance``."""

import os

import jax

jax.config.update('jax_platforms', 'cpu')

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pytorch_sound_tpu.examples import voice_bank as jax_vb  # noqa: E402
from pytorch_sound_tpu.models import build_model as jax_build_model  # noqa: E402
from pytorch_sound_tpu.models.enhancement import SpectrogramMaskNet as JaxMaskNet  # noqa: E402
from pytorch_sound_tpu_torch.data.meta.voice_bank import VoiceBankMeta, get_datasets  # noqa: E402
from pytorch_sound_tpu_torch.examples import voice_bank as vb  # noqa: E402
from pytorch_sound_tpu_torch.models import build_model  # noqa: E402
from pytorch_sound_tpu_torch.models.enhancement import spec_masker_from_jax  # noqa: E402
from pytorch_sound_tpu_torch.trainer import adam  # noqa: E402
from pytorch_sound_tpu_torch.utils.wavio import write_wav  # noqa: E402

SR = 22050
FIX_LEN = 8192
LR = 1e-3
MODEL_RTOL = 1e-5          # outputs and losses, relative to the reference's peak
PARAM_TOL = 1e-6           # one Adam step, where the gradient is clear of zero


@pytest.fixture(scope='module')
def vb_meta_dir(tmp_path_factory):
    """The synthetic VoiceBank tree of tests/test_e2e_voicebank.py: tones plus
    white noise, 8 utterances per split, and its metas."""
    rng = np.random.default_rng(5)
    root = str(tmp_path_factory.mktemp('vb_raw'))
    meta = str(tmp_path_factory.mktemp('vb_meta'))
    txt_dir = os.path.join(root, 'txt')
    os.makedirs(txt_dir)
    for phase, spk in (('trainset', 'p280'), ('validset', 'p281')):
        for kind in ('clean', 'noisy'):
            os.makedirs(os.path.join(root, '%s_%s_wav' % (phase, kind)))
        for u in range(8):
            key = '%s_%03d' % (spk, u)
            n = int(SR * rng.uniform(2.5, 3.5))
            t = np.arange(n) / SR
            clean = (0.3 * np.sin(2 * np.pi * rng.uniform(100, 400) * t)).astype(np.float32)
            noisy = clean + 0.1 * rng.standard_normal(n).astype(np.float32)
            write_wav(os.path.join(root, '%s_clean_wav' % phase, key + '.wav'), clean, SR)
            write_wav(os.path.join(root, '%s_noisy_wav' % phase, key + '.wav'), noisy, SR)
            with open(os.path.join(txt_dir, key + '.txt'), 'w') as w:
                w.write('synthetic utterance %d.' % u)
    VoiceBankMeta(meta).make_meta(root, 2, 15, 0)
    return meta


def _run(meta_dir, save_dir, max_step=6):
    train_loader, valid_loader = get_datasets(meta_dir, batch_size=4, num_workers=0,
                                              fix_len=FIX_LEN, pad_multiple=FIX_LEN)
    model = build_model('spec_masker_small')
    t = vb.VoiceBankTrainer(
        model, adam(model.parameters(), LR), train_loader, valid_loader,
        max_step=max_step, valid_max_step=2, save_interval=max_step, log_interval=2,
        save_dir=save_dir, save_prefix='vb_test', grad_norm=5.0, seed=7, device='cpu')
    return t, t.run()


def test_voicebank_end_to_end(vb_meta_dir, tmp_path):
    t, best = _run(vb_meta_dir, str(tmp_path))
    assert np.isfinite(best) and t.step == 6
    assert os.path.exists(os.path.join(str(tmp_path), 'models', 'vb_test',
                                       'SpectrogramMaskNet', 'step_%06d.chkpt' % t.step))


def test_use_mesh_raises(vb_meta_dir, tmp_path, monkeypatch):
    """``use_mesh`` over ranks (here 2, as torchrun would give them) raises,
    with both numbers, on a global batch that does not divide over them; the
    mesh run itself is tests/test_torch_parallel.py's."""
    from pytorch_sound_tpu_torch.parallel import mesh
    monkeypatch.setattr(mesh, 'init_distributed', lambda device: (0, 2, torch.device(device)))
    with pytest.raises(ValueError, match='batch_size 5 does not divide over 2 ranks'):
        vb.main(vb_meta_dir, str(tmp_path), batch_size=5, use_mesh=True, device='cpu')


def test_enhance_inference(vb_meta_dir, tmp_path):
    """Train briefly, enhance, and with an identity mask the pipeline is the
    STFT round trip away from the edges."""
    t, _ = _run(vb_meta_dir, str(tmp_path), max_step=3)
    rng = np.random.default_rng(7)
    tt = np.arange(FIX_LEN) / SR
    clean = (0.3 * np.sin(2 * np.pi * 220 * tt)).astype(np.float32)
    noisy = torch.from_numpy(clean + 0.1 * rng.standard_normal(FIX_LEN).astype(np.float32))
    out = vb.enhance(t.model, noisy[None]).numpy()
    assert out.shape == (1, FIX_LEN) and np.isfinite(out).all()
    out_id = vb.enhance(torch.ones_like, noisy[None]).numpy()
    np.testing.assert_allclose(out_id[0, 512:-512], noisy.numpy()[512:-512], atol=1e-4)


def test_main_resumed_run_is_the_uninterrupted_run(vb_meta_dir, tmp_path):
    """main() 4 steps at once, and 2 steps then a resume to 4: the step-4
    checkpoints are equal bit for bit (the loaders' positions replay)."""
    kw = dict(batch_size=4, num_workers=0, fix_len=FIX_LEN, valid_max_step=1,
              save_interval=2, log_interval=1, arch='spec_masker_small', device='cpu')
    states = []
    for name, runs in (('whole', (4,)), ('resumed', (2, 4))):
        for max_step in runs:
            np.random.seed(0)
            torch.manual_seed(0)
            assert np.isfinite(vb.main(vb_meta_dir, str(tmp_path / name), max_step=max_step, **kw))
        states.append(torch.load(str(tmp_path / name / 'models' / 'voice_bank' /
                                     'SpectrogramMaskNet' / 'step_000004.chkpt'),
                                 weights_only=True))
    assert states[0]['data'] and states[0]['optim']['optimizer']['state']
    assert _same(states[0], states[1])


def _same(a, b):
    """Two checkpoint states equal bit for bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def _batch(seed=3, n=4):
    rng = np.random.default_rng(seed)
    tt = np.arange(FIX_LEN) / SR
    clean = (0.3 * np.sin(2 * np.pi * rng.uniform(100, 400, (n, 1)) * tt)).astype(np.float32)
    noisy = (clean + 0.1 * rng.standard_normal((n, FIX_LEN))).astype(np.float32)
    return noisy, clean


CONFIGS = {
    'spec_masker_small': None,
    'even_kernel': {'spec_size': 513, 'hidden_dim': 32, 'n_blocks': 1, 'kernel_size': 4},
}


@pytest.fixture(scope='module', params=sorted(CONFIGS))
def jax_reference(request, tmp_path_factory):
    """A JAX VoiceBankTrainer at its own initial weights: the mask of the
    noisy magnitude, the logged losses, and the weights after one training
    step (grad norm 5, optax.adam), on one seeded 4 x 8192 batch."""
    cfg = CONFIGS[request.param]
    model = (jax_build_model(request.param) if cfg is None else JaxMaskNet(**cfg))
    jt = jax_vb.VoiceBankTrainer(
        model, optax.adam(LR), None, None, max_step=1, valid_max_step=1,
        save_interval=10 ** 9, log_interval=10 ** 9,
        save_dir=str(tmp_path_factory.mktemp('jax_vb')), save_prefix='vb', grad_norm=5.0,
        seed=7)
    noisy, clean = _batch()
    batch = [jnp.asarray(noisy), jnp.asarray(clean)]
    p0 = jax.tree_util.tree_map(np.array, jax.jit(lambda x: model.init(
        jax.random.PRNGKey(7), jt._magnitude(x)))(batch[0]))
    mask = np.asarray(jax.jit(lambda p, x: model.apply(p, jt._magnitude(x)))(p0, batch[0]))
    loss, meta = jax.jit(lambda p, n, c: (lambda out: (out[0], {
        k: v for k, (v, _) in out[1].items()}))(jt.forward(p, n, c, is_logging=True)))(
            p0, *batch)
    grads = jax.jit(jax.grad(lambda p, n, c: jt.forward(p, n, c)[0]))(p0, *batch)
    p1, _, _, _ = jt._get_train_step()(jax.tree_util.tree_map(jnp.asarray, p0),
                                        jt.optimizer.init(p0), batch, is_logging=False)
    enhanced = np.asarray(jax.jit(lambda p, x: jax_vb.enhance(model, p, x))(p0, batch[0]))
    return dict(p0=p0, p1=jax.tree_util.tree_map(np.array, p1), mask=mask,
                grads=jax.tree_util.tree_map(np.array, grads), enhanced=enhanced,
                meta={k: np.asarray(v) for k, v in meta.items()}, loss=float(loss),
                noisy=noisy, clean=clean)


def _flat(tree):
    """flax tree -> {torch state_dict name: array in the port's layout}."""
    out = {}
    for layer, leaves in tree['params'].items():
        for name, v in leaves.items():
            key = '%s.%s' % (layer, 'weight' if name in ('kernel', 'scale') else name)
            out[key] = v.transpose(*range(v.ndim - 1, -1, -1)) if name == 'kernel' else v
    return out


def _rel(got, ref):
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max()) / max(
        float(np.abs(np.asarray(ref)).max()), 1e-30)


def test_mask_net_forward_matches_jax(jax_reference):
    """The carried-over weights give JAX's mask: tanh gelu, LayerNorm eps
    1e-6, 'SAME' padding (also for an even kernel), the (N, T, F) layout."""
    r = jax_reference
    model = spec_masker_from_jax(r['p0'])
    assert model.ln_0.eps == 1e-6
    mag = vb.magnitude(torch.from_numpy(r['noisy']))
    with torch.no_grad():
        mask = model(mag).numpy()
    assert mask.shape == r['mask'].shape == (4, 513, FIX_LEN // 256 + 1)
    assert _rel(mask, r['mask']) <= MODEL_RTOL


def test_trainer_loss_and_one_adam_step_match_jax(jax_reference, tmp_path):
    """The port's trainer from the same weights and batch: the logged losses,
    the gradients, and the weights after one step (global-norm clip 5, Adam
    with optax's formula). Adam's first step moves an entry by ~lr whatever
    the size of its gradient, so an entry whose gradient is within rounding
    of zero may move either way: those are held to 2 lr."""
    r = jax_reference
    model = spec_masker_from_jax(r['p0'])
    t = vb.VoiceBankTrainer(model, adam(model.parameters(), LR), None, None, max_step=1,
                            valid_max_step=1, save_interval=10 ** 9, log_interval=10 ** 9,
                            save_dir=str(tmp_path), grad_norm=5.0, seed=7, device='cpu')
    batch = t.to_device([r['noisy'], r['clean']])
    loss, meta = t.forward(*batch, is_logging=True)
    assert abs(float(loss.detach()) - r['loss']) <= MODEL_RTOL * abs(r['loss'])
    for key in ('loss', 'mag_l1', 'log_l1'):
        assert abs(float(meta[key][0].detach()) - float(r['meta'][key])) <= \
            MODEL_RTOL * abs(float(r['meta'][key])), key
    assert _rel(meta['est_mag'][0].detach(), r['meta']['est_mag']) <= MODEL_RTOL
    assert meta['est_mag'][1].name == 'IMAGE'

    loss.backward()
    port_grads = {k: p.grad.numpy().copy() for k, p in model.named_parameters()}
    t._train_step(batch, is_logging=False)
    grads = _flat(r['grads'])
    after, want = {k: p.detach().numpy() for k, p in model.named_parameters()}, _flat(r['p1'])
    assert after.keys() == want.keys() == grads.keys() == port_grads.keys()
    for key, ref in want.items():
        g = grads[key]
        assert _rel(port_grads[key], g) <= 1e-4, key
        live = np.abs(g) > 1e-6          # 100 x Adam's eps: the update is ~lr sign(g)
        diff = np.abs(after[key] - ref)
        assert float(diff[live].max(initial=0.0)) <= PARAM_TOL, key
        assert float(diff.max()) <= 2 * LR + 1e-7, key


def test_enhance_matches_jax(jax_reference):
    r = jax_reference
    out = vb.enhance(spec_masker_from_jax(r['p0']), torch.from_numpy(r['noisy'])).numpy()
    assert out.shape == r['enhanced'].shape == (4, FIX_LEN)
    np.testing.assert_allclose(out, r['enhanced'], atol=MODEL_RTOL * float(
        np.abs(r['enhanced']).max()))
