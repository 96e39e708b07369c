"""The port imports torch and never jax, flax or the JAX package; its CUDA
modules import without nvcc (the kernels build at their first CUDA launch).
The serving path (with its fast modes), the training path, the data layer, the enhancement path,
the preprocess path, the TTS path and the separation and transcription
recipes, and the multi-rank layer with a recipe's ``use_mesh`` path, each
run in a fresh interpreter; the data layer, the preprocess path, the TTS
path, the separation and transcription recipes and the multi-rank layer
also load none of pandas, tqdm or joblib (nor, on the TTS path, matplotlib,
nor, on the separation and transcription recipes, PyYAML)."""

import functools
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r'''
import sys
import numpy as np
from pytorch_sound_tpu_torch.interface.hifi_gan import InterfaceHifiGAN
from pytorch_sound_tpu_torch.ops.cuda import _build, gen_stage, logmel  # noqa: F401
import pytorch_sound_tpu_torch
assert pytorch_sound_tpu_torch.build_model is not None
iface = InterfaceHifiGAN('hifi_gan_v2', device='cpu')
mel = iface.encode(np.zeros((1, 4096), np.float32) + 0.01)
wav = iface.decode(mel)
assert tuple(wav.shape) == (1, 1, 16 * 256), wav.shape
for kw in (dict(precision='bf16x3'), dict(precision='default'), dict(dtype='bfloat16')):
    fast = InterfaceHifiGAN('hifi_gan_v2', device='cpu', **kw).decode(mel)
    assert fast.dtype == wav.dtype and fast.shape == wav.shape and bool(fast.isfinite().all())
assert _build._lib is None, 'the kernel library must not load on the CPU path'
loaded = sorted(m for m in sys.modules
                if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'pytorch_sound_tpu'))
print('LOADED', loaded)
assert not loaded, loaded
'''


TRAIN_SCRIPT = r'''
import itertools, sys, tempfile
import numpy as np
import torch
from pytorch_sound_tpu_torch.examples.hifi_gan import HiFiGANTrainer
from pytorch_sound_tpu_torch.models import build_model
from pytorch_sound_tpu_torch.models.vocoders import discriminators  # noqa: F401
from pytorch_sound_tpu_torch.ops.cuda import _build, grouped_conv
from pytorch_sound_tpu_torch.trainer import Trainer, adamw  # noqa: F401
wav = (np.random.default_rng(0).standard_normal((2, 2048)) * 0.1).astype(np.float32)


def step(route, critics, gen_kw=None, **kw):
    # one step and a validation of tiny models on the CPU: route 'cudnn', or
    # 'cuda' (the critics' convs and the upsamples on the grouped-conv
    # functions); critics / gen_kw: the critics' / the generator's extra keywords
    gen = build_model('hifi_gan_v3', extra_kwargs=dict(gen_kw or {},
                                                       upsample_initial_channel=16,
                                                       ups_backend=route))
    mpd, msd = (build_model(arch, extra_kwargs=dict(critics, backends=(route,) * 8))
                for arch in ('hifi_gan_mpd_small', 'hifi_gan_msd_small'))
    with tempfile.TemporaryDirectory() as tmp:
        t = HiFiGANTrainer(gen, mpd, msd, adamw(gen.parameters(), 2e-4, 0.8, 0.99),
                           adamw(itertools.chain(mpd.parameters(), msd.parameters()), 2e-4),
                           [[wav]], [[wav]], max_step=1, valid_max_step=1, save_interval=1,
                           log_interval=1, save_dir=tmp, seed=1, device='cpu', **kw)
        assert np.isfinite(t.run()) and t.step == 1
    print('STEP', route, sorted(critics), flush=True)


for route in sys.argv[1:]:
    step(route, {})
    if route == 'cuda':
        # the fast modes: the critics on bf16 activations in precision
        # 'default', the MSD folded (discriminators.msd_apply_folded), the
        # generator in 'default' with every conv on the grouped-conv
        # functions, the log-mels in 'bf16x3'
        step(route, {'precision': 'default', 'compute_dtype': 'bf16'},
             {'precision': 'default', 'backend': 'cuda'}, msd_folded=True,
             mel_precision='bf16x3')
assert _build._lib is None, 'the kernel library must not load on the CPU path'
assert (grouped_conv.conv1d_forward.launches, grouped_conv.conv1d_input_grad.launches,
        grouped_conv.conv1d_weight_grad.launches) == (0, 0, 0)
loaded = sorted(m for m in sys.modules
                if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'pytorch_sound_tpu'))
print('LOADED', loaded)
assert not loaded, loaded
'''


V1_SCRIPT = r'''
import sys
import numpy as np
import torch
from pytorch_sound_tpu_torch.interface.hifi_gan import InterfaceHifiGAN
from pytorch_sound_tpu_torch.models import build_model
from pytorch_sound_tpu_torch.models.vocoders.hifi_gan import generator_apply_fused, init_params
from pytorch_sound_tpu_torch.ops.cuda import _build, gen_stage
gen = init_params(build_model('hifi_gan_v1', extra_kwargs={'use_weight_norm': False}),
                  torch.Generator().manual_seed(0))
tree = {}
for key, val in gen.state_dict().items():
    *path, leaf = key.split('.')
    node = tree
    for p in path:
        node = node.setdefault(p, {})
    node[leaf] = val.numpy()
iface = InterfaceHifiGAN('hifi_gan_v1', params=tree, device='cpu')
mel = iface.encode(np.zeros((1, 1024), np.float32) + 0.01)
wav = iface.decode(mel)
split = generator_apply_fused(iface.decoder, mel, full_stage=False)
assert tuple(wav.shape) == tuple(split.shape) == (1, 1, 4 * 256), wav.shape
assert float((wav - split).abs().max()) <= 1e-6
assert _build._lib is None, 'the kernel library must not load on the CPU path'
assert (gen_stage.launch_count(gen_stage.generator_stage),
        gen_stage.launch_count(gen_stage.resblock_stage)) == (0, 0)
loaded = sorted(m for m in sys.modules
                if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'pytorch_sound_tpu'))
print('LOADED', loaded)
assert not loaded, loaded
'''


ATTENTION_SCRIPT = r'''
import sys
import torch
from pytorch_sound_tpu_torch.models.modules import MultiHeadAttention
from pytorch_sound_tpu_torch.ops.attention import blockwise_attention
from pytorch_sound_tpu_torch.ops.cuda import _build, flash_attention as fa
torch.manual_seed(0)
mha = MultiHeadAttention(32, 4, auto_threshold=64)
x = torch.randn(2, 32, 80, requires_grad=True)
mask = torch.arange(80)[None, :] >= torch.tensor([[80], [61]])
out, att = mha(x, mask)
assert att is None and tuple(out.shape) == (2, 32, 80)
out.sum().backward()
q, k, v = (torch.randn(2, 4, 50, 16, requires_grad=True) for _ in range(3))
blockwise_attention(q, k, v, mask=mask[:, :50], backend='cuda').square().sum().backward()
assert all(torch.isfinite(t.grad).all() for t in (x, q, k, v))
assert _build._lib is None, 'the kernel library must not load on the CPU path'
assert (fa.attention_forward.launches, fa.attention_dkv.launches,
        fa.attention_dq.launches) == (0, 0, 0)
loaded = sorted(m for m in sys.modules
                if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'pytorch_sound_tpu'))
print('LOADED', loaded)
assert not loaded, loaded
'''


DATA_SCRIPT = r'''
import os, random, sys, tempfile


class Absent:
    """The port runs where none of these is installed: importing one fails
    here too (torch.hub, which tries tqdm, then takes its own fallback)."""
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('pandas', 'tqdm', 'joblib'):
            raise ModuleNotFoundError('No module named %r' % name)


sys.meta_path.insert(0, Absent())
import numpy as np
import pytorch_sound_tpu_torch.examples.hifi_gan  # noqa: F401
from pytorch_sound_tpu_torch import settings  # noqa: F401
from pytorch_sound_tpu_torch.data.meta import ljspeech, libri_tts, voice_bank  # noqa: F401
from pytorch_sound_tpu_torch.data.meta.vctk import VCTKMeta, get_datasets
from pytorch_sound_tpu_torch.utils import cli, text  # noqa: F401
from pytorch_sound_tpu_torch.utils.wavio import write_wav
root = tempfile.mkdtemp()
rng = np.random.default_rng(0)
for s in range(2):
    spk = 'p%03d' % (225 + s)
    for sub in ('wav', 'txt'):
        os.makedirs(os.path.join(root, 'raw', spk, sub))
    for u in range(12):
        key = '%s_%03d' % (spk, u)
        write_wav(os.path.join(root, 'raw', spk, 'wav', key + '.wav'),
                  rng.standard_normal(int(22050 * 2.2)) * 0.1, 22050, dtype='int16')
        with open(os.path.join(root, 'raw', spk, 'txt', key + '.txt'), 'w') as f:
            f.write('utterance %d.' % u)
random.seed(0)
VCTKMeta(os.path.join(root, 'meta')).make_meta(os.path.join(root, 'raw'))
train, valid = get_datasets(os.path.join(root, 'meta'), 2, 2, fix_len=4096, pad_multiple=4096)
wav, speaker, ids = next(iter(train))
assert wav.shape == (2, 4096) and speaker.dtype == np.int64, (wav.shape, speaker.dtype)
assert len(list(valid)) == 1
forbidden = ('jax', 'jaxlib', 'flax', 'pytorch_sound_tpu', 'pandas', 'tqdm', 'joblib')
loaded = sorted(m for m in sys.modules if m.split('.')[0] in forbidden)
print('LOADED', loaded)
assert not loaded, loaded
'''


ENHANCE_SCRIPT = r'''
import sys, tempfile
import numpy as np
import torch
from pytorch_sound_tpu_torch.examples.voice_bank import VoiceBankTrainer, enhance
from pytorch_sound_tpu_torch.models import build_model, sound, transforms as T
from pytorch_sound_tpu_torch.ops.cuda import _build, logmel
from pytorch_sound_tpu_torch.trainer import adam
rng = np.random.default_rng(0)
wav = torch.from_numpy((rng.standard_normal((2, 4096)) * 0.1).astype(np.float32))
assert T.LogMelSpectrogram(16000, 40, 400, 400, 100)(wav[:, None]).shape == (2, 1, 40, 41)
assert T.MFCC(22050, 80, 1024, 1024, 40, 256, -50, 30)(wav[:, None]).shape == (2, 1, 40, 17)
mag, phase = T.STFT(1024, 256).transform(wav)
assert T.STFT(1024, 256).inverse(mag, phase).shape == (2, 4096)
assert T.PQMF().synthesis(T.PQMF().analysis(wav[:, None])).shape == (2, 1, 4096)
assert T.LearnableSTFT(512, 128)(wav)[0].shape == (2, 257, 33)
assert sound.InversePreEmphasis()(sound.PreEmphasis()(wav[:, None])).shape == (2, 1, 4096)
model = build_model('spec_masker_small')
with tempfile.TemporaryDirectory() as tmp:
    t = VoiceBankTrainer(model, adam(model.parameters(), 1e-3), [[wav, wav]], [[wav, wav]],
                         max_step=1, valid_max_step=1, save_interval=1, log_interval=1,
                         save_dir=tmp, grad_norm=5.0, seed=1, device='cpu')
    assert np.isfinite(t.run()) and t.step == 1
assert enhance(model, wav).shape == (2, 4096)
assert _build._lib is None, 'the kernel library must not load on the CPU path'
assert logmel.fused_log_mel.launches == 0
loaded = sorted(m for m in sys.modules
                if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'pytorch_sound_tpu'))
print('LOADED', loaded)
assert not loaded, loaded
'''


PREPROCESS_SCRIPT = r'''
import os, sys, tempfile


class Absent:
    """As where the port runs: pandas, tqdm and joblib do not import."""
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('pandas', 'tqdm', 'joblib'):
            raise ModuleNotFoundError('No module named %r' % name)


sys.meta_path.insert(0, Absent())
import numpy as np
import torch
from pytorch_sound_tpu_torch import native
from pytorch_sound_tpu_torch.ops.cuda import _build, logmel
from pytorch_sound_tpu_torch.ops.resample import resample_poly
from pytorch_sound_tpu_torch.parallel import prefetch_to_device
from pytorch_sound_tpu_torch.scripts.preprocess import Processor
from pytorch_sound_tpu_torch.utils.wavio import write_wav
root = tempfile.mkdtemp()
os.makedirs(os.path.join(root, 'in'))
rng = np.random.default_rng(0)
for i, sr in enumerate((48000, 22050)):
    write_wav(os.path.join(root, 'in', 'u%d.wav' % i),
              (0.1 * rng.standard_normal(sr)).astype(np.float32), sr, dtype='int16')
stats = Processor.extract_features(os.path.join(root, 'in'), os.path.join(root, 'out'),
                                   batch_size=2, pad_seconds=1.5, device='cpu')
assert stats['utterances'] == 2, stats
assert np.load(os.path.join(root, 'out', 'u0.mel.npy')).shape == (80, 87)
assert resample_poly(torch.zeros(2, 480), 48000, 22050).shape == (2, 221)
assert len(list(prefetch_to_device([[np.zeros(3)]] * 3, size=2, device='cpu'))) == 3
assert native.load_library() is not None
assert _build._lib is None and logmel.fused_log_mel.launches == 0
forbidden = ('jax', 'jaxlib', 'flax', 'pytorch_sound_tpu', 'pandas', 'tqdm', 'joblib')
loaded = sorted(m for m in sys.modules if m.split('.')[0] in forbidden)
print('LOADED', loaded)
assert not loaded, loaded
'''


TTS_SCRIPT = r'''
import json, os, random, sys, tempfile


class Absent:
    """As where the port runs: pandas, tqdm, joblib and matplotlib do not import."""
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('pandas', 'tqdm', 'joblib', 'matplotlib'):
            raise ModuleNotFoundError('No module named %r' % name)


# torch's compiler probes for pandas with find_spec as it loads and imports
# tqdm where it is installed: load it first and count only what comes after
import torch._dynamo  # noqa: F401
torch_loaded = set(sys.modules)
sys.meta_path.insert(0, Absent())
import numpy as np
import torch
from pytorch_sound_tpu_torch.data.korean.g2p import KoG2P
from pytorch_sound_tpu_torch.examples.ljspeech_tts import TTSTrainer
from pytorch_sound_tpu_torch.models import build_model
from pytorch_sound_tpu_torch.models.tts import synthesize
from pytorch_sound_tpu_torch.ops.cuda import _build, logmel
from pytorch_sound_tpu_torch.ops.griffin_lim import griffin_lim
from pytorch_sound_tpu_torch.scripts.preprocess import Processor
from pytorch_sound_tpu_torch.trainer import adamw
from pytorch_sound_tpu_torch.utils import text
from pytorch_sound_tpu_torch.utils.wavio import write_wav
rng = np.random.default_rng(0)
wav = (rng.standard_normal((2, 8192)) * 0.1).astype(np.float32)
mask = np.ones_like(wav)
mask[1, 5000:] = 0
batch = [wav, rng.integers(1, 60, (2, 9)), mask]
torch.manual_seed(0)
model = build_model('transformer_tts_small')
with tempfile.TemporaryDirectory() as tmp:
    t = TTSTrainer(model, adamw(model.parameters(), 1e-3), [batch], [batch], max_step=1,
                   valid_max_step=1, save_interval=1, log_interval=1, save_dir=tmp, seed=1,
                   device='cpu', remat=True, profile_dir=os.path.join(tmp, 'prof'),
                   profile_steps=(1, 2))
    assert np.isfinite(t.run()) and os.path.exists(t.profile_trace)
mel = synthesize(model.eval(), text.eng_t2i('Hello there.')[None], max_frames=8)
assert mel.shape[:2] == (1, 80) and 1 <= mel.shape[2] <= 7, mel.shape
assert griffin_lim(torch.ones(1, 513, 6), 1024, 256, n_iter=2).shape == (1, 1280)
assert KoG2P().g2p('학교에 갑니다') == 'h0 aa kf kk yo ee k0 aa mf nn ii t0 aa'
assert text.kor_i2p(text.kor_p2i('k0 aa')) == ['k0', 'aa']
root = tempfile.mkdtemp()
d = os.path.join(root, 'zeroth', 'train_data_01', '103', '103_001')
os.makedirs(d)
for u in range(2):
    write_wav(os.path.join(d, '103_001_%04d.wav' % u), 0.1 * np.ones(22050 * 3), 22050)
with open(os.path.join(d, '103_001.trans.txt'), 'w', encoding='utf-8') as f:
    f.write('103_001_0000 안녕하세요\n103_001_0001 물고기\n')
random.seed(0)
Processor.zeroth_korean(os.path.join(root, 'zeroth'), os.path.join(root, 'zeroth_out'))
d = os.path.join(root, 'light', '10', 'book')
os.makedirs(d)
write_wav(os.path.join(d, 'f.wav'), 0.1 * np.ones(22050 * 2), 22050)
with open(os.path.join(d, 'f.json'), 'w') as f:
    json.dump({'speaker': '10', 'voice_activity': [[0.0, 1.0], [1.0, 2.0]]}, f)
Processor.libri_light(os.path.join(root, 'light'), os.path.join(root, 'light_out'))
Processor.libri_light2(os.path.join(root, 'light_out', 'meta', 'all_meta.json'),
                       os.path.join(root, 'light_out2'), max_duration=0.5)
assert _build._lib is None and logmel.fused_log_mel.launches == 0
forbidden = ('jax', 'jaxlib', 'flax', 'optax', 'pytorch_sound_tpu', 'pandas', 'tqdm',
             'joblib', 'matplotlib')
loaded = sorted(m for m in set(sys.modules) - torch_loaded if m.split('.')[0] in forbidden)
print('LOADED', loaded)
assert not loaded, loaded
'''


SEPARATION_SCRIPT = r'''
import sys


class Absent:
    """As where the port runs: pandas, tqdm, joblib and PyYAML do not import."""
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('pandas', 'tqdm', 'joblib', 'yaml'):
            raise ModuleNotFoundError('No module named %r' % name)


sys.meta_path.insert(0, Absent())
import numpy as np
import torch
from pytorch_sound_tpu_torch.data.meta.medleydb import MEDLEYDB_META_DIR, load_meta
from pytorch_sound_tpu_torch.examples import dsd100, maestro
from pytorch_sound_tpu_torch.models import build_model
from pytorch_sound_tpu_torch.ops.cuda import _build, logmel
from pytorch_sound_tpu_torch.utils import calculate, iterer, midi, sound  # noqa: F401
assert len(load_meta(MEDLEYDB_META_DIR)) == 330
rng = np.random.default_rng(0)
wav = torch.from_numpy((rng.standard_normal((2, 8192)) * 0.1).astype(np.float32))
sep = dsd100.DSD100Trainer.__new__(dsd100.DSD100Trainer)
sep.model = build_model('spec_unet_small')
loss, _ = sep.forward(wav, wav * 0.5, wav * 0.5, is_logging=True)
loss.backward()
voice, background = dsd100.separate(sep.model, wav)
assert voice.shape == background.shape == (2, 8192)
tr = maestro.MaestroTrainer.__new__(maestro.MaestroTrainer)
tr.model = build_model('frame_pitch_small')
loss, _ = tr.forward(wav, torch.zeros(2, 128, 20), is_logging=True)
loss.backward()
assert np.isfinite(float(loss.detach()))
assert _build._lib is None and logmel.fused_log_mel.launches == 0
forbidden = ('jax', 'jaxlib', 'flax', 'optax', 'pytorch_sound_tpu', 'pandas', 'tqdm',
             'joblib', 'yaml')
loaded = sorted(m for m in sys.modules if m.split('.')[0] in forbidden)
print('LOADED', loaded)
assert not loaded, loaded
'''


PARALLEL_SCRIPT = r'''
import functools, os, sys, tempfile


class Absent:
    """As where the port runs: pandas, tqdm and joblib do not import."""
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('pandas', 'tqdm', 'joblib'):
            raise ModuleNotFoundError('No module named %r' % name)


sys.meta_path.insert(0, Absent())
import numpy as np
import torch
from pytorch_sound_tpu_torch.data.meta.voice_bank import VoiceBankMeta
from pytorch_sound_tpu_torch.examples import voice_bank
from pytorch_sound_tpu_torch.ops.cuda import _build
from pytorch_sound_tpu_torch.parallel import init_distributed, spawn_ranks
from pytorch_sound_tpu_torch.parallel import dryrun, ring_attention  # noqa: F401
from pytorch_sound_tpu_torch.utils.wavio import write_wav
assert init_distributed('cpu') == (0, 1, torch.device('cpu'))
root, meta, save = tempfile.mkdtemp(), tempfile.mkdtemp(), tempfile.mkdtemp()
rng = np.random.default_rng(0)
os.makedirs(os.path.join(root, 'txt'))
for phase, spk in (('trainset', 'p280'), ('validset', 'p281')):
    for kind in ('clean', 'noisy'):
        os.makedirs(os.path.join(root, '%s_%s_wav' % (phase, kind)))
    for u in range(4):
        key = '%s_%03d' % (spk, u)
        clean = (0.3 * np.sin(np.arange(55000) * 0.05)).astype(np.float32)
        write_wav(os.path.join(root, '%s_clean_wav' % phase, key + '.wav'), clean, 22050)
        write_wav(os.path.join(root, '%s_noisy_wav' % phase, key + '.wav'),
                  clean + 0.1 * rng.standard_normal(55000).astype(np.float32), 22050)
        with open(os.path.join(root, 'txt', key + '.txt'), 'w') as w:
            w.write('an utterance.')
VoiceBankMeta(meta).make_meta(root, 2, 15, 0)
main = functools.partial(voice_bank.main, meta, save, batch_size=2, num_workers=0,
                         fix_len=8192, max_step=1, valid_max_step=1, save_interval=1,
                         log_interval=1, arch='spec_masker_small', use_mesh=True,
                         device='cpu')
best = spawn_ranks(main, 2, 'gloo', 'cpu')
assert len(best) == 2 and np.isfinite(best[0]) and best[0] == best[1], best
assert os.path.exists(os.path.join(save, 'models', 'voice_bank', 'SpectrogramMaskNet',
                                   'step_000001.chkpt'))
assert _build._lib is None
forbidden = ('jax', 'jaxlib', 'flax', 'optax', 'pytorch_sound_tpu', 'pandas', 'tqdm',
             'joblib')
loaded = sorted(m for m in sys.modules if m.split('.')[0] in forbidden)
print('LOADED', loaded)
assert not loaded, loaded
'''


def _run(script, *args):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in os.environ.get('PYTHONPATH', '').split(os.pathsep) if p]))
    proc = subprocess.run([sys.executable, '-c', script, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'LOADED []' in proc.stdout
    return proc.stdout


@functools.lru_cache(maxsize=None)
def _training_run():
    """The training path on both routes in one fresh interpreter, shared by
    the two cases below (most of each one's time was the interpreter's
    start and imports); its output."""
    return _run(TRAIN_SCRIPT, 'cudnn', 'cuda')


def test_port_loads_neither_jax_nor_the_jax_package():
    _run(SCRIPT)


def test_v1_serving_loads_neither_jax_nor_the_jax_package():
    """HiFi-GAN v1 from seeded weights handed over as a parameter tree:
    encode, the full-stage decode (conv_pre folded into stage 0) and the
    resblock-stage route, on the CPU."""
    _run(V1_SCRIPT)


def test_training_path_loads_neither_jax_nor_the_jax_package():
    """The trainer, the critics and HiFiGANTrainer: one CPU step with tiny
    models, a validation and a checkpoint."""
    assert 'STEP cudnn []' in _training_run()


def test_kernel_route_loads_neither_jax_nor_the_jax_package():
    """The same step with the critics' convs and the generator's upsamples
    on the grouped-conv functions: their module loads without JAX, and on
    the CPU they build no kernel and count no launch; then a step with the
    critics' fast modes (bf16, 'default', the MSD folded)."""
    out = _training_run()
    assert 'STEP cuda []' in out and "STEP cuda ['compute_dtype', 'precision']" in out


def test_attention_path_loads_neither_jax_nor_the_jax_package():
    """MultiHeadAttention's blockwise route and blockwise_attention on the
    kernels' backend, forward and backward on the CPU: the plain versions,
    no kernel library, no launch."""
    _run(ATTENTION_SCRIPT)


def test_data_layer_loads_neither_jax_nor_pandas():
    """The data layer and the recipe's module, with pandas, tqdm and joblib
    made unimportable, as where the port runs: a VCTK meta made from wav
    files and its loaders (with worker threads) draw batches, and none of
    those, jax, flax or the JAX package is loaded."""
    _run(DATA_SCRIPT)


def test_enhancement_path_loads_neither_jax_nor_the_jax_package():
    """The transforms (LogMelSpectrogram at 400 / 100 on (N, 1, T), MFCC, the
    conv STFT, PQMF, LearnableSTFT, the pre-emphasis pair) and the VoiceBank
    recipe (one CPU step of spec_masker_small, a validation, a checkpoint,
    enhance): no kernel library, no launch, and none of jax, flax, optax or
    the JAX package loaded."""
    _run(ENHANCE_SCRIPT)


def test_preprocess_path_loads_neither_jax_nor_pandas():
    """The feature pipeline (scripts.preprocess with extract_features on the
    CPU, the native runtime, the tensor resampler, the prefetch), with
    pandas, tqdm and joblib made unimportable: no kernel library, no launch,
    and none of those, jax, flax or the JAX package loaded."""
    _run(PREPROCESS_SCRIPT)


def test_tts_path_loads_neither_jax_nor_pandas():
    """The TTS recipe (one CPU step of transformer_tts_small with remat and
    the profiler window, a validation, a checkpoint), synthesize,
    griffin_lim, the Korean G2P and codecs, and the Processor's
    zeroth_korean, libri_light and libri_light2 on tiny trees, with pandas,
    tqdm, joblib and matplotlib made unimportable: no kernel library, no
    launch, and none of those, jax, flax, optax or the JAX package loaded."""
    _run(TTS_SCRIPT)


def test_separation_and_transcription_load_neither_jax_nor_pandas_nor_yaml():
    """The DSD100 and Maestro recipes (a loss and its gradient each,
    ``separate``) and the MedleyDB meta's reader of the bundled metafiles,
    with pandas, tqdm, joblib and PyYAML made unimportable, as on the card
    machine, which lacks them."""
    _run(SEPARATION_SCRIPT)


def test_parallel_path_loads_neither_jax_nor_pandas():
    """The multi-rank layer (``parallel``: the mesh, per-rank data, ring
    attention, the dry run) and the VoiceBank recipe's ``use_mesh`` path
    over 2 gloo ranks (``spawn_ranks``, a step, a validation, rank 0's
    checkpoint), with pandas, tqdm and joblib made unimportable: no kernel
    library, and none of those, jax, flax, optax or the JAX package loaded."""
    _run(PARALLEL_SCRIPT)
