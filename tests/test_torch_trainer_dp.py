"""The port's data-parallel Trainer and HiFi-GAN split step on the CPU over 2
gloo ranks (``spawn_ranks``), against the JAX package's mesh step on 2 of
the virtual devices of ``conftest.py``: the same global batches and
converted weights. Mirrors tests/test_trainer.py::test_trainer_mesh_data_parallel
and the split step of tests/test_torch_hifigan_training.py; then the NaN
guard on one rank's rows, ranks with unequal rows and a straggler batch
against one process, and a 2-rank resume against the uninterrupted run.
The reduced gradients themselves are held to JAX's gradient of the global
batch: the optimizers are Adam and AdamW, whose steps hardly change when
every gradient is scaled alike, so only the gradients show a reduction
that is right in direction and wrong in size."""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax

jax.config.update('jax_platforms', 'cpu')

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import pytest  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from pytorch_sound_tpu.examples.hifi_gan import HiFiGANTrainer as JaxHiFiGANTrainer  # noqa: E402
from pytorch_sound_tpu.models import build_model as jax_build_model  # noqa: E402
from pytorch_sound_tpu.ops import mel as jax_mel  # noqa: E402
from pytorch_sound_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from pytorch_sound_tpu_torch.models.vocoders.hifi_gan import (  # noqa: E402
    load_jax_trainer_params)
from pytorch_sound_tpu_torch.parallel import spawn_ranks  # noqa: E402
from test_trainer import RegressionTrainer as JaxRegressionTrainer  # noqa: E402
from test_trainer import TinyNet as JaxTinyNet  # noqa: E402
from test_trainer import make_loader  # noqa: E402
import torch_dp_ranks as ranks  # noqa: E402

STEP_TOL = 1e-5        # TinyNet's parameters and losses over 10 steps (tests/test_trainer.py:226)
LOSS_TOL = 1e-4        # the GAN step's losses, relative (test_torch_hifigan_training.py)
PARAM_TOL = 1e-5       # the GAN step's parameters where |JAX grad| > 1e-6 (the same)
GRAD_TOL = 1e-5       # TinyNet's reduced gradient, relative to JAX's gradient's norm
GAN_GRAD_TOL = 1e-4   # the GAN step's reduced gradients, the same (its loss tolerance)
LOSSES = ('loss', 'disc_loss', 'adv', 'feature_matching', 'mel_l1')


def gloo(fn, *args):
    return spawn_ranks(fn, 2, 'gloo', 'cpu', *args)


def rel_err(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def flat(tree, prefix=''):
    """A nested parameter tree as {'a.b.c': array}: the port's state dict keys."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(flat(val, prefix + key + '.'))
        else:
            out[prefix + key] = np.asarray(val)
    return out


def jax_mesh():
    return jax_make_mesh(shape=(2,), devices=jax.devices()[:2])


def tiny_state(params):
    """A flax TinyNet's parameters as the torch TinyNet's state dict."""
    p = params['params']
    return {'l1.weight': np.asarray(p['Dense_0']['kernel']).T.copy(),
            'l1.bias': np.asarray(p['Dense_0']['bias']),
            'l2.weight': np.asarray(p['Dense_1']['kernel']).T.copy(),
            'l2.bias': np.asarray(p['Dense_1']['bias'])}


class JaxRecorder(JaxRegressionTrainer):
    def console_log(self, tag, meta, step):
        self.logged.append((tag, step, float(np.asarray(meta['loss'][0]))))


def _nan_case():
    x, y = make_loader(n_batches=1)[0]
    x[8:] = np.nan                         # rank 1's rows
    wav = (np.random.default_rng(3).standard_normal((4, 2048)) * 0.2).astype(np.float32)
    wav[2:] = np.nan
    return x, y, wav


def _uneven_case():
    x, y = make_loader(n_batches=1, batch=4)[0]
    xs, ys = make_loader(n_batches=1, batch=3, seed=1)[0]
    return [[x, y], [xs, ys]]


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The JAX mesh trainer's 10 steps, and in one spawn of 2 gloo ranks the
    port's runs of the tests below: {name: (reference, each rank's result)}."""
    tmp = tmp_path_factory.mktemp('dp')
    jt = JaxRecorder(JaxTinyNet(), optax.adam(3e-2), make_loader(), make_loader(n_batches=2),
                     max_step=10, valid_max_step=2, save_interval=5, log_interval=1,
                     save_dir=str(tmp / 'jax'), save_prefix='reg', seed=11, mesh=jax_mesh())
    jt.logged = []
    jt._ensure_initialized([jnp.asarray(a) for a in make_loader()[0]])
    p0 = jax.tree_util.tree_map(np.array, jt.params)
    state = tiny_state(p0)
    x0, y0 = make_loader(n_batches=1)[0]
    grad = tiny_state(jax.grad(lambda p: jnp.mean(
        (JaxTinyNet().apply(p, x0)[..., 0] - y0) ** 2))(p0))
    best = jt.run()
    x, y, wav = _nan_case()
    jobs = {
        'jax': functools.partial(ranks.regression_run, str(tmp / 'port'), state,
                                 make_loader(), make_loader(n_batches=2), 10),
        'nan': functools.partial(ranks.nan_rows, str(tmp / 'nan'), state, x, y, None, wav),
        'uneven': functools.partial(ranks.uneven_rows, str(tmp / 'two'), state,
                                    _uneven_case()),
        'resume': functools.partial(ranks.resume, str(tmp / 'resume')),
        'grads': functools.partial(ranks.regression_grads, str(tmp / 'grads'), state,
                                   [x0, y0]),
    }
    out = gloo(ranks.call, *jobs.values())
    refs = {'jax': (tiny_state(jax.tree_util.tree_map(np.array, jt.params)), jt.logged, best),
            'uneven': state, 'grads': grad}
    return {name: (refs.get(name), [r[i] for r in out]) for i, name in enumerate(jobs)}


def test_trainer_mesh_data_parallel_matches_jax(runs):
    """10 steps of 16 rows (8 a rank) with validations and checkpoints at 5
    and 10: the logged losses, the best validation loss and the parameters
    against the JAX trainer on a 2-device mesh; both ranks hold the same
    parameters, bit for bit."""
    (want, jax_logged, best), out = runs['jax']
    for params, logged, port_best in out:
        for key, ref in want.items():
            np.testing.assert_array_equal(params[key], out[0][0][key])
            np.testing.assert_allclose(params[key], ref, atol=STEP_TOL, err_msg=key)
        got = [(tag, step, m['loss']) for tag, step, m in logged]
        assert [g[:2] for g in got] == [r[:2] for r in jax_logged]
        np.testing.assert_allclose([g[2] for g in got], [r[2] for r in jax_logged],
                                   rtol=STEP_TOL)
        assert abs(port_best - best) <= STEP_TOL * abs(best), (port_best, best)


def test_reduced_gradient_is_the_global_batch_gradient(runs):
    """The gradient one step takes after the reduction, with 8 rows a rank
    and with 12 and 4: JAX's gradient of the mean loss over all 16 rows
    from the same parameters, within 1e-5 of its norm, on both ranks."""
    want, out = runs['grads']
    for rank_grads in out:
        for split, grads in rank_grads.items():
            assert grads.keys() == want.keys()
            for key, ref in want.items():
                assert rel_err(grads[key], ref) <= GRAD_TOL, (split, key, rel_err(grads[key], ref))


def test_hifigan_split_step_on_two_ranks_matches_jax(tmp_path):
    """One split step of the tiny HiFi-GAN on a global batch of 4 x 2048 (2
    rows a rank) against JAX's split step on a 2-device mesh from the same
    converted parameters: the five losses within 1e-4, the parameters within
    1e-5 where the gradient is clear of zero and 2 lr everywhere, and each
    reduced gradient (the critics' of the critic phase, the generator's
    against the updated critics) within 1e-4 of JAX's gradient of the
    global batch's loss, relative to its norm."""
    lr = ranks.GAN_LR
    wav = (np.random.default_rng(11).standard_normal((4, 2048)) * 0.2).astype(np.float32)
    mesh = jax_mesh()
    jt = JaxHiFiGANTrainer(
        jax_build_model(ranks.TINY_GEN[0], extra_kwargs=ranks.TINY_GEN[1]),
        jax_build_model('hifi_gan_mpd_small'), jax_build_model('hifi_gan_msd_small'),
        optax.adamw(lr, b1=0.8, b2=0.99), optax.adamw(lr, b1=0.8, b2=0.99), None, None,
        max_step=1, valid_max_step=1, save_interval=10 ** 9, log_interval=10 ** 9,
        save_dir=str(tmp_path / 'jax'), save_prefix='s', seed=13, split_step=True, mesh=mesh)
    sharded = [jax.device_put(wav, NamedSharding(mesh, P('data')))]
    jt._ensure_initialized(sharded)
    p0 = jax.tree_util.tree_map(np.array, jt.params)
    state = {f: {k: v.numpy() for k, v in sd.items()}
             for f, sd in load_jax_trainer_params(p0).items()}
    with ThreadPoolExecutor(1) as pool:      # the ranks step while JAX compiles
        port = pool.submit(gloo, ranks.gan_step, str(tmp_path / 'port'), state, wav)
        p1, _, _, meta = jt._get_train_step()(jt.params, jt.opt_state, sharded,
                                              is_logging=True)
        ref_losses = {k: float(meta[k].value) for k in LOSSES}
        p1 = jax.tree_util.tree_map(np.array, p1)
        real, mel_real = wav[:, None, :], jax_mel.hifigan_mel_spectrogram(jnp.asarray(wav))
        fake = jt.generator.apply(p0['gen'], mel_real)
        d_grads = jax.jit(jax.grad(lambda dp: jt._disc_loss(dp, real, fake)))(
            {'mpd': p0['mpd'], 'msd': p0['msd']})
        g_grads = jax.jit(jax.grad(lambda gp: jt._gen_loss(
            gp, {'mpd': p1['mpd'], 'msd': p1['msd']}, real, mel_real)[0]))(p0['gen'])
        ref_grads = {'gen': flat(g_grads['params']), 'mpd': flat(d_grads['mpd']['params']),
                     'msd': flat(d_grads['msd']['params'])}
        out = port.result()
    want = {f: {k: v.numpy() for k, v in sd.items()}
            for f, sd in load_jax_trainer_params(p1).items()}
    for params, losses, grads in out:
        for key in LOSSES:
            assert abs(losses[key] - ref_losses[key]) <= LOSS_TOL * abs(ref_losses[key]), (
                key, losses[key], ref_losses[key])
        for family in ('gen', 'mpd', 'msd'):
            assert params[family].keys() == want[family].keys() == grads[family].keys()
            for key, ref in want[family].items():
                np.testing.assert_array_equal(params[family][key], out[0][0][family][key])
                diff = np.abs(params[family][key] - ref)
                # entries the step moved by their gradient (the mean over
                # ranks, which the step took), not by Adam's +-lr alone
                live = np.abs(grads[family][key]) > 1e-6
                assert float(diff[live].max(initial=0.0)) <= PARAM_TOL, (family, key)
                assert float(diff.max()) <= 2 * lr + 1e-7, (family, key)
                err = rel_err(grads[family][key], ref_grads[family][key])
                assert err <= GAN_GRAD_TOL, (family, key, err)


def test_nan_on_one_rank_skips_the_update_on_every_rank(runs):
    """NaN rows on rank 1 alone: the mean loss is NaN on both ranks, so
    both skip the update (the regression step, and each phase of the GAN
    step); the parameters and optimizer states stay as they were."""
    for regression, gan in runs['nan'][1]:
        for loss, unchanged in (regression, gan):
            assert not np.isfinite(loss) and unchanged


def test_unequal_rows_and_straggler_match_one_process(runs, tmp_path):
    """Step 1: rank 0 holds 3 rows, rank 1 one; step 2: a batch of 3 rows
    kept whole on both ranks. The row-weighted mean gives the step one
    process takes on the 4 and the 3 rows: the same losses and parameters."""
    state, out = runs['uneven']
    one = ranks.regression_trainer(str(tmp_path), _uneven_case(), None, state=state,
                                   max_step=2)
    one.run()
    want = ranks.numpy_state(one.model.state_dict())
    for params, losses in out:
        np.testing.assert_allclose(losses, [m['loss'] for _, _, m in one.logged], rtol=1e-6)
        for key, ref in want.items():
            np.testing.assert_allclose(params[key], ref, atol=1e-6, err_msg=key)


def test_two_rank_resume_is_the_uninterrupted_run(runs):
    """2 ranks, 6 steps with checkpoints at 3 and 6 and a prefetch of 2,
    each rank's numpy stream its own; then fresh ranks from the step-3
    checkpoint alone: steps 4-6 log the same losses and end at the same
    parameters, bit for bit, and the step-6 checkpoints hold the same
    model and both ranks' same streams, which differ from each other."""
    for rank, (resumed, same) in enumerate(runs['resume'][1]):
        (params1, logged1), (params2, logged2) = resumed
        start = [e[:2] for e in logged1].index(('train', 4))
        assert logged1[start:] == logged2
        for key in params1:
            np.testing.assert_array_equal(params1[key], params2[key], err_msg=key)
        assert same is (True if rank == 0 else None)
