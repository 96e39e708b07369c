"""The port imports torch and never jax, flax or the JAX package; its CUDA
modules import without nvcc (the kernels build at their first CUDA launch).
The serving path, the training path, the data layer and the enhancement path
each run in a fresh interpreter; the data layer and the preprocess path also
load none of pandas, tqdm or joblib."""

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
route = sys.argv[1]          # 'cudnn', or 'cuda': the grouped-conv functions
gen = build_model('hifi_gan_v3', extra_kwargs={'upsample_initial_channel': 16,
                                               'ups_backend': route})
mpd, msd = (build_model(arch, extra_kwargs={'backends': (route,) * 8})
            for arch in ('hifi_gan_mpd_small', 'hifi_gan_msd_small'))
wav = (np.random.default_rng(0).standard_normal((2, 2048)) * 0.1).astype(np.float32)
with tempfile.TemporaryDirectory() as tmp:
    t = HiFiGANTrainer(gen, mpd, msd, adamw(gen.parameters(), 2e-4, 0.8, 0.99),
                       adamw(itertools.chain(mpd.parameters(), msd.parameters()), 2e-4),
                       [[wav]], [[wav]], max_step=1, valid_max_step=1, save_interval=1,
                       log_interval=1, save_dir=tmp, seed=1, device='cpu')
    assert np.isfinite(t.run()) and t.step == 1
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
assert (gen_stage.generator_stage.launches, gen_stage.resblock_stage.launches) == (0, 0)
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


def _run(script, *args):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in os.environ.get('PYTHONPATH', '').split(os.pathsep) if p]))
    proc = subprocess.run([sys.executable, '-c', script, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'LOADED []' in proc.stdout


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
    _run(TRAIN_SCRIPT, 'cudnn')


def test_kernel_route_loads_neither_jax_nor_the_jax_package():
    """The same step with the critics' convs and the generator's upsamples
    on the grouped-conv functions: their module loads without JAX, and on
    the CPU they build no kernel and count no launch."""
    _run(TRAIN_SCRIPT, 'cuda')


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
