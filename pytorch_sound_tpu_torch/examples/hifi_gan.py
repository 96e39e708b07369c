"""HiFi-GAN vocoder training: the full adversarial recipe on one card, or
data parallel over several (``HiFiGANTrainer(..., mesh=make_mesh())``).

Counterpart of ``pytorch_sound_tpu/examples/hifi_gan.py`` with the semantics
of its split step: a discriminator phase, then a generator phase against the
updated critics, each with its own NaN/Inf guard. The objective is the
paper's (arXiv 2010.05646): LSGAN adversarial (MPD + MSD), feature matching
(x2) and L1 mel reconstruction (x45). The reconstruction mel of the fake runs
through K4, :func:`~pytorch_sound_tpu_torch.ops.cuda.logmel.fused_hifigan_mel_trainable`
(the log-mel kernel forward, the composite's VJP backward); the real mel
through the log-mel kernel itself.

:func:`main` is the recipe from a meta directory on disk, as the JAX
package's: ``python -m pytorch_sound_tpu_torch.examples.hifi_gan vctk META_DIR
SAVE_DIR [--batch_size 16 ...]`` reads the dataset's meta files
(``data.meta.<dataset>.get_datasets``: vctk, ljspeech, libri_tts), crops
``fix_len``-sample segments and trains on the card. :class:`HiFiGANTrainer`
also takes any iterables of ``(wav (N, T),)`` batches.
:func:`build_critics` builds the recipe's critics on its conv routes
(``main(msd_pallas=..., mpd_pallas=...)``): cuDNN by default, the
grouped-conv kernels (K6) on request, in the critics' precision
(``main(disc_precision=...)``: 'highest', the port's default, or 'default',
the JAX recipe's) and, with ``main(disc_bf16=True)``, on bfloat16
activations. ``main(msd_folded=True)`` applies the MSD as one block-diagonal
grouped stack over its scales (``discriminators.msd_apply_folded``). The
generator takes its precision and conv route from ``main(gen_precision=...,
gen_kernel=...)``, the log-mels theirs from ``main(mel_precision=...)``
(``HiFiGANTrainer(mel_precision=...)``).
"""

import importlib
import itertools
from typing import List, Optional, Tuple

import torch

from pytorch_sound_tpu_torch.models import build_model
from pytorch_sound_tpu_torch.models.vocoders import discriminators
from pytorch_sound_tpu_torch.models.vocoders.discriminators import msd_apply_folded
from pytorch_sound_tpu_torch.models.vocoders.hifi_gan import load_jax_params
from pytorch_sound_tpu_torch.ops import gan as gan_ops
from pytorch_sound_tpu_torch.ops.cuda.logmel import (PRECISIONS, fused_hifigan_mel,
                                                     fused_hifigan_mel_trainable)
from pytorch_sound_tpu_torch.trainer import LogType, Trainer, adamw, clip_grads
from pytorch_sound_tpu_torch.utils.checkpoint import load_msgpack
from pytorch_sound_tpu_torch.utils.commons import log

LAMBDA_FM = 2.0
LAMBDA_MEL = 45.0


def build_critics(msd_kernel: int = -1, mpd_kernel: bool = False,
                  precision: str = 'highest', compute_dtype: Optional[str] = None
                  ) -> Tuple[discriminators.MultiPeriodDiscriminator,
                             discriminators.MultiScaleDiscriminator]:
    """(MPD base, MSD base) as the JAX recipe's ``main`` builds them
    (``pytorch_sound_tpu/examples/hifi_gan.py:383-394``). ``msd_kernel=N >= 0``
    puts the first N of the MSD's 8 conv layers on the grouped-conv kernels
    (``'cuda'``), the rest on cuDNN; ``mpd_kernel=True`` puts all 6 MPD layers
    there. -1 / False keep every conv on cuDNN. Every critic conv runs in
    ``precision`` and ``compute_dtype`` (None or 'bf16')."""
    n = max(msd_kernel, 0)
    mpd_backends = ('cuda' if mpd_kernel else 'cudnn',) * discriminators.PERIOD_LAYERS
    msd_backends = ('cuda',) * n + ('cudnn',) * (discriminators.SCALE_LAYERS - n)
    mode = {'precision': precision, 'compute_dtype': compute_dtype}
    return (build_model('hifi_gan_mpd_base', extra_kwargs=dict(mode, backends=mpd_backends)),
            build_model('hifi_gan_msd_base', extra_kwargs=dict(mode, backends=msd_backends)))


def _params(optimizer: torch.optim.Optimizer) -> List[torch.nn.Parameter]:
    """The parameters an optimizer updates."""
    return [p for group in optimizer.param_groups for p in group['params']]


class HiFiGANTrainer(Trainer):
    """Adversarial trainer over a generator and the MPD / MSD critics.

    ``gen_optimizer`` updates the generator (and is the base trainer's
    ``optimizer``: a ``scheduler`` and ``grad_clip`` / ``grad_norm`` apply to
    it), ``disc_optimizer`` both critics, e.g.
    ``adamw(chain(mpd.parameters(), msd.parameters()), 2e-4, 0.8, 0.99)``.
    Checkpoints hold the three state dicts under 'gen', 'mpd' and 'msd'.

    ``generator_warm_start``: path to a folded generator msgpack (such as the
    bundled checkpoint) to fine-tune from; the generator must be built with
    ``use_weight_norm=False``.

    ``msd_folded``: every critic pass applies the MSD through
    :func:`~pytorch_sound_tpu_torch.models.vocoders.discriminators.msd_apply_folded`
    (one block-diagonal grouped stack over the scales; the same function and
    parameters), as JAX's ``_apply_disc`` does.

    ``mel_precision``: the precision of the real mel (K2,
    :func:`~pytorch_sound_tpu_torch.ops.cuda.logmel.fused_hifigan_mel`) and
    of the fake's (K4), 'highest' (the port's default), 'bf16x3' (the JAX
    split step's K4 default) or 'default'; the kernels compute each in fp64.

    ``mesh`` (the base trainer's, as JAX's constructor takes it; ``main``
    takes none, as JAX's does not): each phase takes its loss and its
    gradient as means over the ranks, weighted by rows, before its optimizer
    step, and its NaN guard decides on the mean loss. Every loss of the
    recipe is a plain mean over rows, so this is the global batch's step.
    In the generator phase the critics are frozen and only the generator's
    gradient is reduced.
    """

    def __init__(self, generator: torch.nn.Module, mpd: torch.nn.Module,
                 msd: torch.nn.Module, gen_optimizer: torch.optim.Optimizer,
                 disc_optimizer: torch.optim.Optimizer, *args,
                 generator_warm_start: str = None, msd_folded: bool = False,
                 mel_precision: str = 'highest', **kwargs):
        super().__init__(generator, gen_optimizer, *args, **kwargs)
        self.generator = self.model
        self.mpd = mpd.to(self.device)
        self.msd = msd.to(self.device)
        self.gen_optimizer = gen_optimizer
        self.disc_optimizer = disc_optimizer
        self.generator_warm_start = generator_warm_start
        self.msd_folded = msd_folded
        if mel_precision not in PRECISIONS:
            raise ValueError('mel_precision is one of %s, got %r' % (PRECISIONS, mel_precision))
        self.mel_precision = mel_precision

    def replicated_modules(self):
        return [self.generator, self.mpd, self.msd]

    def init_params(self, batch):
        n = sum(p.numel() for m in (self.generator, self.mpd, self.msd)
                for p in m.parameters())
        log('HiFi-GAN gen+mpd+msd initialized. Total {} params.'.format(n))
        if self.generator_warm_start:
            self.generator.load_state_dict(
                load_jax_params(load_msgpack(self.generator_warm_start)))
            log('generator warm-started from {}'.format(self.generator_warm_start))

    # -- checkpoints ----------------------------------------------------------

    def model_state(self):
        return {'gen': self.generator.state_dict(), 'mpd': self.mpd.state_dict(),
                'msd': self.msd.state_dict()}

    def load_model_state(self, state):
        for key, module in (('gen', self.generator), ('mpd', self.mpd), ('msd', self.msd)):
            module.load_state_dict(state[key])

    def optim_state(self):
        return dict(super().optim_state(), disc=self.disc_optimizer.state_dict())

    def load_optim_state(self, state):
        super().load_optim_state(state)
        self.disc_optimizer.load_state_dict(state['disc'])

    # -- losses ---------------------------------------------------------------

    def apply_disc(self, disc: torch.nn.Module, x: torch.Tensor) -> gan_ops.DiscOut:
        """One critic family's outputs on x, the MSD folded with
        ``msd_folded`` (JAX ``_apply_disc``)."""
        if disc is self.msd and self.msd_folded:
            return msd_apply_folded(disc, x)
        return disc(x)

    @staticmethod
    def _apply_both(disc, real: torch.Tensor, fake: torch.Tensor
                    ) -> Tuple[gan_ops.DiscOut, gan_ops.DiscOut]:
        """One critic pass over cat([real, fake]) instead of two (the critics
        have no cross-batch ops); ``disc`` a module or a function of the
        batch. Returns (real_outs, fake_outs)."""
        n = real.shape[0]
        both = disc(torch.cat([real, fake], dim=0))
        real_outs = [(s[:n], [f[:n] for f in feats]) for s, feats in both]
        fake_outs = [(s[n:], [f[n:] for f in feats]) for s, feats in both]
        return real_outs, fake_outs

    def disc_loss(self, real: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
        mpd_real, mpd_fake = self._apply_both(self.mpd, real, fake)
        msd_real, msd_fake = self._apply_both(lambda x: self.apply_disc(self.msd, x),
                                              real, fake)
        return (gan_ops.discriminator_loss(mpd_real, mpd_fake)
                + gan_ops.discriminator_loss(msd_real, msd_fake))

    def gen_loss(self, real: torch.Tensor, mel_real: torch.Tensor
                 ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """(loss, [adv, fm, mel_l1, fake]); the real audio's critic passes
        carry no gradient (feature-matching targets only)."""
        fake = self.generator(mel_real)
        mel_fake = fused_hifigan_mel_trainable(fake[:, 0], self.mel_precision)
        mel_l1 = torch.mean(torch.abs(mel_fake - mel_real))
        with torch.no_grad():
            mpd_real = self.mpd(real)
            msd_real = self.apply_disc(self.msd, real)
        mpd_fake = self.mpd(fake)
        msd_fake = self.apply_disc(self.msd, fake)
        adv = (gan_ops.generator_adversarial_loss(mpd_fake)
               + gan_ops.generator_adversarial_loss(msd_fake))
        fm = (gan_ops.feature_matching_loss(mpd_real, mpd_fake)
              + gan_ops.feature_matching_loss(msd_real, msd_fake))
        return adv + LAMBDA_FM * fm + LAMBDA_MEL * mel_l1, [adv, fm, mel_l1, fake]

    # -- the split step -------------------------------------------------------

    def disc_phase(self, real: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Critics against a fake made without gradient; returns
        (d_loss, mel_real). A non-finite loss leaves the critics and their
        optimizer state as they were."""
        with torch.no_grad():
            mel_real = fused_hifigan_mel(real[:, 0], precision=self.mel_precision)
            fake = self.generator(mel_real)
        self.disc_optimizer.zero_grad(set_to_none=True)
        d_loss = self.disc_loss(real, fake)
        d_all, weight = self.reduce_loss(d_loss, real.shape[0])
        if bool(torch.isfinite(d_all)):
            d_loss.backward()
            self.reduce_grads(_params(self.disc_optimizer), weight)
            self.disc_optimizer.step()
        return d_all.detach(), mel_real

    def gen_phase(self, real: torch.Tensor, mel_real: torch.Tensor):
        """Generator against the updated critics, which compute no weight
        gradient here; returns (g_loss, [adv, fm, mel_l1, fake]). A
        non-finite loss leaves the generator and its optimizer state as they
        were."""
        critics = (self.mpd, self.msd)
        for m in critics:
            m.requires_grad_(False)
        try:
            self.gen_optimizer.zero_grad(set_to_none=True)
            g_loss, parts = self.gen_loss(real, mel_real)
            g_all, weight = self.reduce_loss(g_loss, real.shape[0])
            if bool(torch.isfinite(g_all)):
                g_loss.backward()
                self.reduce_grads(_params(self.gen_optimizer), weight)
                clip_grads(self.generator.parameters(), self.grad_clip, self.grad_norm)
                self.gen_optimizer.step()
                if self.scheduler is not None:
                    self.scheduler.step()
        finally:
            for m in critics:
                m.requires_grad_(True)
        return g_all.detach(), [p.detach() for p in parts]

    def _train_step(self, batch, is_logging: bool):
        real = batch[0][:, None, :]
        d_loss, mel_real = self.disc_phase(real)
        g_loss, (adv, fm, mel_l1, fake) = self.gen_phase(real, mel_real)
        meta = {}
        if is_logging:
            meta = {
                'loss': (g_loss, LogType.SCALAR),
                'disc_loss': (d_loss, LogType.SCALAR),
                'adv': (adv, LogType.SCALAR),
                'feature_matching': (fm, LogType.SCALAR),
                'mel_l1': (mel_l1, LogType.SCALAR),
                'fake_audio': (fake[0, 0], LogType.AUDIO),
            }
        return g_loss, meta

    @torch.no_grad()
    def _eval_step(self, batch):
        real = batch[0][:, None, :]
        mel_real = fused_hifigan_mel(real[:, 0], precision=self.mel_precision)
        fake = self.generator(mel_real)
        mel_l1 = torch.mean(torch.abs(
            fused_hifigan_mel_trainable(fake[:, 0], self.mel_precision) - mel_real))
        return mel_l1, {'loss': (mel_l1, LogType.SCALAR),
                        'mel_l1': (mel_l1, LogType.SCALAR)}


def main(dataset: str, meta_dir: str, save_dir: str, batch_size: int = 16,
         num_workers: int = 2, fix_len: int = 8192, max_step: int = 500000,
         valid_max_step: int = 20, save_interval: int = 5000,
         log_interval: int = 100, lr: float = 2e-4, arch: str = 'hifi_gan_v2',
         msd_pallas: int = -1, mpd_pallas: bool = False,
         msd_folded: bool = False, disc_bf16: bool = False,
         disc_precision: str = 'highest', gen_precision: str = 'highest',
         gen_kernel: bool = False, mel_precision: str = 'highest', device: str = 'cuda'):
    """Train a HiFi-GAN on a wave-first dataset (vctk, ljspeech, libri_tts)
    from its meta directory, as the JAX recipe's ``main`` does: crops of
    ``fix_len`` samples (shorter clips zero-padded to it), AdamW 2e-4 with
    betas (0.8, 0.99) for the generator and for both critics, no gradient
    clip, checkpoints under ``save_dir/models/hifi_gan/``; returns the best
    validation loss.

    ``arch``: the generator, on its registered conv route. ``msd_pallas``:
    -1 keeps every critic conv on cuDNN; N >= 0 puts the MSD's first N conv
    layers on the grouped-conv kernels (K6). ``mpd_pallas``: all of the
    MPD's conv layers on K6. ``msd_folded``: the MSD as one block-diagonal
    grouped stack (``HiFiGANTrainer(msd_folded=True)``). ``disc_bf16``: both
    critics on bfloat16 activations and weights (``compute_dtype='bf16'``;
    fp32 master parameters), as JAX's ``main``. ``disc_precision``: the
    critics' precision, 'highest' (the port's default) or 'default' (the
    JAX critics' default: bf16 products, fp32 sums). ``gen_precision``: the
    generator's, 'highest' or 'default' (every conv's operands rounded to
    bf16, fp32 sums). ``gen_kernel``: every generator conv (conv_pre, the
    upsamples, the resblock convs, conv_post) on the grouped-conv kernels
    (K6) instead of cuDNN. ``mel_precision``: K2's and K4's, 'highest',
    'bf16x3' or 'default' (``HiFiGANTrainer(mel_precision=)``). JAX's recipe
    on a TPU runs the generator in 'default' (its NTC generator at
    ``precision='auto'``), the critics in 'default' and K4 in 'bf16x3':
    ``gen_precision='default', disc_precision='default',
    mel_precision='bf16x3'``. The port's defaults are 'highest' throughout.
    ``device``: 'cuda' (the default; raises without a card) or 'cpu'.
    """
    data_mod = importlib.import_module('pytorch_sound_tpu_torch.data.meta.' + dataset)
    train_loader, valid_loader = data_mod.get_datasets(
        meta_dir, batch_size=batch_size, num_workers=num_workers,
        fix_len=fix_len, pad_multiple=fix_len)

    mpd, msd = build_critics(msd_kernel=msd_pallas, mpd_kernel=mpd_pallas,
                             precision=disc_precision,
                             compute_dtype='bf16' if disc_bf16 else None)
    route = {'backend': 'cuda', 'ups_backend': 'cuda'} if gen_kernel else {}
    generator = build_model(arch, extra_kwargs=dict(route, precision=gen_precision))
    gen_opt = adamw(generator.parameters(), lr, 0.8, 0.99)
    disc_opt = adamw(itertools.chain(mpd.parameters(), msd.parameters()), lr, 0.8, 0.99)

    trainer = HiFiGANTrainer(
        generator, mpd, msd, gen_opt, disc_opt,
        train_loader, valid_loader,
        max_step=max_step, valid_max_step=valid_max_step,
        save_interval=save_interval, log_interval=log_interval,
        save_dir=save_dir, save_prefix='hifi_gan', grad_norm=0.0, device=device,
        msd_folded=msd_folded, mel_precision=mel_precision)
    return trainer.run()


if __name__ == '__main__':
    from pytorch_sound_tpu_torch.utils.cli import fire_like
    fire_like(main)
