"""The port's HiFiGANTrainer on the CPU: one split step against the JAX
package's ``HiFiGANTrainer(split_step=True)`` from the same converted
parameters and batch, the run loop's checkpoint layout, the generator warm
start and the per-phase NaN guard (mirrors tests/test_hifigan_training.py)."""

import itertools
import os

import jax

jax.config.update('jax_platforms', 'cpu')

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from pytorch_sound_tpu.examples.hifi_gan import HiFiGANTrainer as JaxHiFiGANTrainer  # noqa: E402
from pytorch_sound_tpu.models import build_model as jax_build_model  # noqa: E402
import pytorch_sound_tpu.models.vocoders.discriminators  # noqa: E402,F401
import pytorch_sound_tpu.models.vocoders.hifi_gan  # noqa: E402,F401
from pytorch_sound_tpu.ops import mel as jax_mel  # noqa: E402
from pytorch_sound_tpu_torch.examples.hifi_gan import HiFiGANTrainer  # noqa: E402
from pytorch_sound_tpu_torch.interface.hifi_gan import CHECKPOINTS  # noqa: E402
from pytorch_sound_tpu_torch.models import build_model  # noqa: E402
from pytorch_sound_tpu_torch.models.vocoders.hifi_gan import (  # noqa: E402
    load_jax_trainer_params)
from pytorch_sound_tpu_torch.trainer import adamw  # noqa: E402
from pytorch_sound_tpu_torch.utils.checkpoint import load_msgpack  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)

LR = 2e-4
TINY_GEN = ('hifi_gan_v3', {'upsample_initial_channel': 32})
LOSS_TOL = 1e-4        # relative, each of the five logged losses
PARAM_TOL = 1e-5       # params after the step where |JAX grad| > 1e-6
LOSSES = ('loss', 'disc_loss', 'adv', 'feature_matching', 'mel_l1')


def port_trainer(tmp_path, gen=None, train=None, valid=None, route='cudnn', **kw):
    """A tiny HiFiGANTrainer on the CPU; ``route='cuda'`` puts the critics'
    convs and the generator's upsamples on the grouped-conv functions."""
    gen = gen if gen is not None else build_model(
        TINY_GEN[0], extra_kwargs=dict(TINY_GEN[1], ups_backend=route))
    mpd, msd = (build_model(arch, extra_kwargs={'backends': (route,) * 8})
                for arch in ('hifi_gan_mpd_small', 'hifi_gan_msd_small'))
    kw.setdefault('max_step', 1)
    return HiFiGANTrainer(
        gen, mpd, msd, adamw(gen.parameters(), LR, 0.8, 0.99),
        adamw(itertools.chain(mpd.parameters(), msd.parameters()), LR, 0.8, 0.99),
        train, valid, valid_max_step=1, save_interval=kw.pop('save_interval', 10),
        log_interval=1, save_dir=str(tmp_path), save_prefix='gan_test', seed=13,
        device='cpu', **kw)


def flat(tree, prefix=''):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(flat(val, prefix + key + '.'))
        else:
            out[prefix + key] = np.asarray(val)
    return out


def params_of(t):
    return {key: {k: v.detach().clone() for k, v in sd.items()}
            for key, sd in t.model_state().items()}


def test_split_step_matches_jax(tmp_path):
    rng = np.random.default_rng(11)
    batch = (rng.standard_normal((2, 2048)) * 0.2).astype(np.float32)

    jt = JaxHiFiGANTrainer(
        jax_build_model(TINY_GEN[0], extra_kwargs=TINY_GEN[1]),
        jax_build_model('hifi_gan_mpd_small'), jax_build_model('hifi_gan_msd_small'),
        optax.adamw(LR, b1=0.8, b2=0.99), optax.adamw(LR, b1=0.8, b2=0.99), None, None,
        max_step=1, valid_max_step=1, save_interval=10 ** 9, log_interval=10 ** 9,
        save_dir=str(tmp_path / 'jax'), save_prefix='s', seed=13, split_step=True)
    jt._ensure_initialized([jnp.asarray(batch)])
    p0 = jax.tree_util.tree_map(np.array, jt.params)

    # the JAX step and its two phases' gradients (the generator's against the
    # updated critics, as the split step takes them)
    p1, _, _, meta = jt._get_train_step()(
        jax.tree_util.tree_map(jnp.asarray, p0), jt.opt_state, [jnp.asarray(batch)],
        is_logging=True)
    ref_losses = {k: float(meta[k].value) for k in LOSSES}
    p1 = jax.tree_util.tree_map(np.array, p1)
    wav = jnp.asarray(batch)
    real, mel_real = wav[:, None, :], jax_mel.hifigan_mel_spectrogram(wav)
    fake = jt.generator.apply(p0['gen'], mel_real)
    d_grads = jax.jit(jax.grad(lambda dp: jt._disc_loss(dp, real, fake)))(
        {'mpd': p0['mpd'], 'msd': p0['msd']})
    g_grads = jax.jit(jax.grad(lambda gp: jt._gen_loss(
        gp, {'mpd': p1['mpd'], 'msd': p1['msd']}, real, mel_real)[0]))(p0['gen'])
    ref_grads = {'gen': flat(g_grads['params']), 'mpd': flat(d_grads['mpd']['params']),
                 'msd': flat(d_grads['msd']['params'])}

    t = port_trainer(tmp_path / 'port')
    for key, sd in load_jax_trainer_params(p0).items():
        getattr(t, {'gen': 'generator'}.get(key, key)).load_state_dict(sd)
    _, meta = t._train_step(t.to_device([batch]), is_logging=True)
    for key in LOSSES:
        got = float(meta[key][0])
        assert abs(got - ref_losses[key]) <= LOSS_TOL * abs(ref_losses[key]), (
            key, got, ref_losses[key])
    assert all(p.requires_grad for m in (t.mpd, t.msd) for p in m.parameters())

    got, want = params_of(t), load_jax_trainer_params(p1)
    for family in ('gen', 'mpd', 'msd'):
        assert got[family].keys() == want[family].keys() == ref_grads[family].keys()
        for key, ref in want[family].items():
            diff = np.abs(got[family][key].numpy() - ref.numpy())
            live = np.abs(ref_grads[family][key]) > 1e-6
            assert float(diff[live].max(initial=0.0)) <= PARAM_TOL, (family, key)
            assert float(diff.max()) <= 2 * LR + 1e-7, (family, key)


def route_steps_against_fp64(tmp_path, seed):
    """One split step of the cuDNN route and of the kernel route in fp32 and
    of the cuDNN route in fp64, from the same models (drawn after
    ``torch.manual_seed(seed)``) and batch. Returns, per route, the five
    losses' relative errors against the fp64 step's, each gradient's error
    relative to the fp64 gradient's norm, and each updated parameter's
    largest difference from the fp64 step's where the fp64 gradient is clear
    of zero and everywhere."""
    batch = (np.random.default_rng(12).standard_normal((2, 2048)) * 0.2).astype(np.float32)
    torch.manual_seed(seed)
    trainers = [port_trainer(tmp_path / name, route=route)
                for name, route in (('cudnn', 'cudnn'), ('cuda', 'cuda'), ('fp64', 'cudnn'))]
    for t in trainers[1:]:
        t.load_model_state(trainers[0].model_state())
    for m in (trainers[2].generator, trainers[2].mpd, trainers[2].msd):
        m.double()
    assert trainers[1].generator.ups_0.backend == 'cuda'
    assert {m.backend for m in trainers[1].msd.modules() if hasattr(m, 'backend')} == {'cuda'}
    results = []
    for t, wav in zip(trainers, (batch, batch, batch.astype(np.float64))):
        _, meta = t._train_step(t.to_device([wav]), is_logging=True)
        grads = {'%s.%s' % (f, k): p.grad.detach().double()
                 for f, m in (('gen', t.generator), ('mpd', t.mpd), ('msd', t.msd))
                 for k, p in m.named_parameters()}
        results.append(({k: float(meta[k][0]) for k in LOSSES}, grads, params_of(t)))
    loss_x, grad_x, after_x = results[2]
    out = []
    for losses, grads, after in results[:2]:
        params = {}
        for family, sd in after_x.items():
            for k, v in sd.items():
                diff = (after[family][k].double() - v).abs()
                live = grad_x['%s.%s' % (family, k)].abs() > 1e-6
                params['%s.%s' % (family, k)] = (float(torch.where(live, diff, 0.0).max()),
                                                  float(diff.max()))
        out.append(({k: abs(losses[k] - loss_x[k]) / abs(loss_x[k]) for k in LOSSES},
                    {k: float((grads[k] - g).norm()) / max(float(g.norm()), 1e-30)
                     for k, g in grad_x.items()}, params))
    return out


def test_kernel_route_step_matches_cudnn_route(tmp_path):
    """One split step with every critic conv and generator upsample on the
    grouped-conv functions (their plain forward, dx and dw on the CPU) is as
    close to the exact step as the cuDNN route's: both fp32 routes are held to
    one fp64 run of the cuDNN route from the same parameters and batch.

    The five losses within 1e-5 of the fp64 step's. Each gradient within 1e-5
    of the fp64 gradient, relative to its norm, or, where fp32 rounding puts
    the cuDNN route itself farther than that, no more than twice as far as
    the cuDNN route: a gradient that is a small sum of large terms (a weight
    norm's g at ~1e-9, a conv_post bias) carries up to ~5e-5 of rounding in
    either route (``PYTHONPATH=. python tests/test_torch_hifigan_training.py
    SEED ...`` prints both routes' worst errors per seed). Each updated
    parameter within 1e-5 of the fp64 step's where the fp64 gradient is
    clear of zero (|g| > 1e-6) and within 2 lr everywhere, since Adam's first
    step moves an entry with a near-zero gradient by up to lr whichever way a
    route rounds it. The models are drawn from a fixed seed, so the step
    does not depend on the RNG state earlier tests left."""
    (loss_a, grad_a, _), (loss_b, grad_b, _) = route = route_steps_against_fp64(tmp_path, 0)
    for k in LOSSES:
        assert loss_a[k] <= 1e-5 and loss_b[k] <= 1e-5, (k, loss_a[k], loss_b[k])
    for k, err_a in grad_a.items():
        assert grad_b[k] <= max(1e-5, 2 * err_a), (k, err_a, grad_b[k])
    for _, _, params in route:
        for k, (live_diff, diff) in params.items():
            assert live_diff <= PARAM_TOL and diff <= 2 * LR + 1e-7, (k, live_diff, diff)


def tones(seed, n=4, samples=2048):
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / 22050
    return [[np.stack([0.4 * np.sin(2 * np.pi * rng.uniform(100, 300) * t)] * 2)
             .astype(np.float32)] for _ in range(n)]


def test_run_writes_checkpoint_at_jax_layout(tmp_path):
    t = port_trainer(tmp_path, train=tones(2), valid=tones(3), max_step=2, save_interval=2)
    best = t.run()
    assert np.isfinite(best) and t.step == 2
    ckpt_dir = os.path.join(str(tmp_path), 'models', 'gan_test', 'Generator')
    path = os.path.join(ckpt_dir, 'step_000002.chkpt')
    assert os.path.exists(path)
    assert os.path.exists(os.path.join(str(tmp_path), 'models', 'gan_test',
                                       'Generator.best.chkpt'))
    state = torch.load(path, weights_only=True)
    assert set(state['model']) == {'gen', 'mpd', 'msd'} and state['step'] == 2
    assert set(state['optim']) == {'optimizer', 'scheduler', 'disc'}


def test_generator_warm_start(tmp_path):
    """Fine-tuning from the bundled (folded) v2 checkpoint."""
    rng = np.random.default_rng(3)
    batch = [(rng.standard_normal((2, 2048)) * 0.2).astype(np.float32)]
    gen = build_model('hifi_gan_v2', extra_kwargs={'use_weight_norm': False})
    t = port_trainer(tmp_path, gen=gen, train=[batch],
                     generator_warm_start=CHECKPOINTS['hifi_gan_v2'])
    t._ensure_initialized(batch)
    ref = load_msgpack(CHECKPOINTS['hifi_gan_v2'])['params']
    np.testing.assert_array_equal(t.generator.conv_pre.weight.detach().numpy(),
                                  ref['conv_pre']['weight'])
    np.testing.assert_array_equal(t.generator.resblocks_7.convs2_1.bias.detach().numpy(),
                                  ref['resblocks_7']['convs2_1']['bias'])


def test_nan_batch_leaves_parameters_unchanged(tmp_path):
    """A non-finite loss skips each phase's update: the critics, the
    generator and both optimizers' states stay as they were."""
    t = port_trainer(tmp_path)
    before = params_of(t)
    nan = np.full((2, 2048), np.nan, dtype=np.float32)
    loss, _ = t._train_step(t.to_device([nan]), is_logging=False)
    assert not bool(torch.isfinite(loss))
    after = params_of(t)
    for family, sd in before.items():
        for key, val in sd.items():
            assert torch.equal(val, after[family][key]), (family, key)
    assert not t.gen_optimizer.state and not t.disc_optimizer.state


if __name__ == '__main__':
    # PYTHONPATH=. python tests/test_torch_hifigan_training.py SEED ...: both
    # routes' worst errors against the fp64 step, per seed of the models
    import sys
    import tempfile
    from pathlib import Path
    for seed in map(int, sys.argv[1:]):
        routes = route_steps_against_fp64(Path(tempfile.mkdtemp()), seed)
        print('seed %d threads %d' % (seed, torch.get_num_threads()), ' '.join(
            '%s: loss %.3g grad %.3g (%s) param %.3g' % (
                name, max(loss.values()), max(grads.values()), max(grads, key=grads.get),
                max(d for d, _ in params.values()))
            for name, (loss, grads, params) in zip(('cudnn', 'cuda'), routes)), flush=True)


def _recipe_on_a_vctk_tree(tmp_path, monkeypatch):
    """A VCTK tree of 3 speakers x 12 utterances (2.05 - 2.6 s, 33 train and
    3 validation rows), its metas made by the port, and the recipe module
    with tiny models in place of v2 and the base critics."""
    import random
    from pytorch_sound_tpu_torch.data.meta.vctk import VCTKMeta
    from pytorch_sound_tpu_torch.examples import hifi_gan as recipe
    from pytorch_sound_tpu_torch.utils.wavio import write_wav

    rng = np.random.default_rng(31)
    root = tmp_path / 'raw'
    for s in range(3):
        spk = 'p%03d' % (225 + s)
        for sub in ('wav', 'txt'):
            os.makedirs(root / spk / sub)
        for u in range(12):
            key = '%s_%03d' % (spk, u)
            n = int(22050 * rng.uniform(2.05, 2.6))
            write_wav(str(root / spk / 'wav' / (key + '.wav')),
                      np.sin(np.arange(n) * rng.uniform(0.02, 0.1)) * 0.3, 22050, dtype='int16')
            (root / spk / 'txt' / (key + '.txt')).write_text('utterance %d.' % u)
    random.seed(0)
    VCTKMeta(str(tmp_path / 'meta')).make_meta(str(root))
    monkeypatch.setattr(recipe, 'build_model', lambda arch, extra_kwargs=None: build_model(
        TINY_GEN[0], extra_kwargs=dict(TINY_GEN[1], **(extra_kwargs or {}))))
    monkeypatch.setattr(recipe, 'build_critics', lambda msd_kernel, mpd_kernel, **mode: tuple(
        build_model(a, extra_kwargs=mode) for a in ('hifi_gan_mpd_small', 'hifi_gan_msd_small')))
    return recipe, str(tmp_path / 'meta')


RECIPE = dict(batch_size=2, num_workers=0, fix_len=2048, valid_max_step=1, log_interval=1,
              device='cpu')


def test_main_trains_from_a_meta_dir(tmp_path, monkeypatch):
    """The recipe's ``main`` from wav files on disk on the CPU: ``vctk``
    loaders at batch 2 and fix_len 2048, two steps, one validation batch,
    checkpoints at the JAX layout holding the loaders' positions (tiny
    models; the recipe at full width runs on the card in
    ``chip_smoke.py``); and two steps with the critics' fast modes, the
    MSD folded and the critics on bf16 activations in precision 'default'."""
    recipe, meta = _recipe_on_a_vctk_tree(tmp_path, monkeypatch)
    np.random.seed(0)
    torch.manual_seed(0)
    best = recipe.main('vctk', meta, str(tmp_path / 'fast'), max_step=2, save_interval=2,
                       msd_folded=True, disc_bf16=True, disc_precision='default', **RECIPE)
    assert np.isfinite(best)
    state = torch.load(tmp_path / 'fast' / 'models' / 'hifi_gan' / 'Generator' /
                       'step_000002.chkpt', weights_only=True)
    assert all(v.dtype == torch.float32 and bool(torch.isfinite(v).all())
               for key in ('mpd', 'msd') for v in state['model'][key].values())
    np.random.seed(0)
    torch.manual_seed(0)
    best = recipe.main('vctk', meta, str(tmp_path / 'save'), max_step=2, save_interval=2,
                       **RECIPE)
    assert np.isfinite(best)
    ckpt_dir = tmp_path / 'save' / 'models' / 'hifi_gan' / 'Generator'
    assert sorted(os.listdir(ckpt_dir)) == ['step_000002.chkpt']
    assert os.path.exists(tmp_path / 'save' / 'models' / 'hifi_gan' / 'Generator.best.chkpt')
    state = torch.load(ckpt_dir / 'step_000002.chkpt', weights_only=True)
    assert state['step'] == 2 and set(state['model']) == {'gen', 'mpd', 'msd'}
    assert all(bool(torch.isfinite(v).all()) for sd in state['model'].values()
               for v in sd.values())
    # the train loader's bucket epoch, less the two batches drawn
    assert sum(map(len, state['data']['train']['buckets'])) == 30 - 2 * 2
    assert state['data']['valid'] == {'batches': [[2]]}


def test_main_resumed_run_is_the_uninterrupted_run(tmp_path, monkeypatch):
    """Four steps in one run, and two steps then a resume to four: the
    step-4 checkpoints are equal bit for bit, because the checkpoint holds
    the loaders' positions beside the numpy state (crops, bucket choices and
    the validation batch replay)."""
    recipe, meta = _recipe_on_a_vctk_tree(tmp_path, monkeypatch)
    for save_dir, stops in (('a', (4,)), ('b', (2, 4))):
        for max_step in stops:
            np.random.seed(0)
            torch.manual_seed(0)
            recipe.main('vctk', meta, str(tmp_path / save_dir), max_step=max_step,
                        save_interval=2, **RECIPE)
    a, b = (torch.load(tmp_path / d / 'models' / 'hifi_gan' / 'Generator' / 'step_000004.chkpt',
                       weights_only=True) for d in 'ab')

    def same(x, y):
        if isinstance(x, dict):
            return x.keys() == y.keys() and all(same(x[k], y[k]) for k in x)
        if isinstance(x, (list, tuple)):
            return len(x) == len(y) and all(same(u, v) for u, v in zip(x, y))
        if isinstance(x, torch.Tensor):
            return torch.equal(x, y)
        return x == y
    assert same(a, b)
