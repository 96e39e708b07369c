"""A data-parallel dry run over ``world`` ranks: the port's counterpart of
the JAX package's multi-chip dry run (``__graft_entry__.py:34-160``).

    python -m pytorch_sound_tpu_torch.parallel.dryrun WORLD [cuda|cpu]

Each rank is a fresh process (:func:`~pytorch_sound_tpu_torch.parallel.mesh.spawn_ranks`:
NCCL over cards, gloo on the CPU) that runs, on its rows of global batches
made from seeds:

- one data-parallel VoiceBank step (``spec_masker_small``, 2 rows a rank x
  4096 samples) through ``VoiceBankTrainer(mesh=...)``;
- ring attention over all ranks at (1, 2, 16 x world, 16), against dense
  attention of the whole sequence;
- one data-parallel HiFi-GAN split step (``hifi_gan_v3`` at 32 channels,
  ``hifi_gan_mpd_small``, ``hifi_gan_msd_small``; 2 rows a rank x 2048).

Every loss must be finite and agree on every rank. JAX's dry run also puts
the mask net's ``conv_a`` kernels on a 'model' axis from 4 devices on
(tensor parallelism); that waits in ``ROADMAP.md`` section 1.
"""

import itertools
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from pytorch_sound_tpu_torch.parallel.data import local_batch
from pytorch_sound_tpu_torch.parallel.mesh import make_mesh, spawn_ranks

RING_TOL = 1e-5


def _rank(device_type: str):
    """One rank's dry run: (VoiceBank loss, ring attention's max error
    against dense, GAN loss), each loss the mean over ranks."""
    world, rank = dist.get_world_size(), dist.get_rank()
    device = torch.device(device_type, torch.cuda.current_device()) \
        if device_type == 'cuda' else torch.device('cpu')
    mesh = make_mesh(device_type=device_type)
    with tempfile.TemporaryDirectory(prefix='dryrun_multigpu_') as tmp:
        return _steps(device, mesh, rank, world, tmp)


def _steps(device, mesh, rank, world, tmp):
    from pytorch_sound_tpu_torch.examples.hifi_gan import HiFiGANTrainer
    from pytorch_sound_tpu_torch.examples.voice_bank import VoiceBankTrainer
    from pytorch_sound_tpu_torch.models import build_model
    from pytorch_sound_tpu_torch.parallel.ring_attention import ring_attention
    from pytorch_sound_tpu_torch.trainer import adam, adamw

    torch.manual_seed(rank)       # the trainers broadcast rank 0's weights
    rng = np.random.default_rng(0)

    model = build_model('spec_masker_small')
    trainer = VoiceBankTrainer(model, adam(model.parameters(), 1e-3), None, None,
                               max_step=1, valid_max_step=1, save_interval=10,
                               log_interval=10, save_dir=tmp, save_prefix='dryrun', seed=1,
                               device=device, mesh=mesh)
    noisy = rng.standard_normal((world * 2, 4096)).astype(np.float32)
    clean = noisy - 0.1 * rng.standard_normal((world * 2, 4096)).astype(np.float32)
    batch = trainer.to_device(local_batch([noisy, clean], mesh))
    trainer._ensure_initialized(batch)
    loss, _ = trainer._train_step(batch, is_logging=False)

    seq_mesh = make_mesh(axis_names=('seq',), device_type=device.type)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 16 * world, 16))
                                .astype(np.float32)).to(device) for _ in range(3))
    shard = slice(16 * rank, 16 * (rank + 1))
    out = ring_attention(q[:, :, shard].contiguous(), k[:, :, shard].contiguous(),
                         v[:, :, shard].contiguous(), seq_mesh, axis='seq')
    dense = torch.softmax(q @ k.transpose(-1, -2) / 4.0, dim=-1) @ v
    ring_err = float((out - dense[:, :, shard]).abs().max())

    gen = build_model('hifi_gan_v3', extra_kwargs={'upsample_initial_channel': 32})
    mpd, msd = build_model('hifi_gan_mpd_small'), build_model('hifi_gan_msd_small')
    gan = HiFiGANTrainer(gen, mpd, msd, adamw(gen.parameters(), 2e-4, 0.8, 0.99),
                         adamw(itertools.chain(mpd.parameters(), msd.parameters()),
                               2e-4, 0.8, 0.99),
                         None, None, max_step=1, valid_max_step=1, save_interval=10,
                         log_interval=10, save_dir=tmp, save_prefix='gan_dryrun', seed=1,
                         device=device, mesh=mesh)
    wav = (0.1 * rng.standard_normal((world * 2, 2048))).astype(np.float32)
    gan_batch = gan.to_device(local_batch([wav], mesh))
    gan._ensure_initialized(gan_batch)
    gan_loss, _ = gan._train_step(gan_batch, is_logging=False)
    return float(loss), ring_err, float(gan_loss)


def dryrun_multigpu(world: int, device_type: str = 'cuda') -> dict:
    """Run the dry run on ``world`` ranks (cards, or CPU processes), check
    it and print one line; returns the losses and ring attention's error."""
    backend = 'nccl' if device_type == 'cuda' else 'gloo'
    results = spawn_ranks(_rank, world, backend, device_type, device_type)
    loss, ring_err, gan_loss = results[0]
    if any(r[0] != loss or r[2] != gan_loss for r in results):
        raise RuntimeError('the ranks disagree on the mean losses: %s' % results)
    worst = max(r[1] for r in results)
    if not (np.isfinite(loss) and np.isfinite(gan_loss) and worst <= RING_TOL):
        raise RuntimeError('dry run failed: loss %r, ring attention error %r, gan loss %r'
                           % (loss, worst, gan_loss))
    print('dryrun_multigpu OK: {} ranks on {} (dp{} VoiceBank step; sp{} ring attention; '
          'dp{} GAN step), loss={:.4f}, ring_max_abs_err={:.3g}, gan_loss={:.4f}'.format(
              world, device_type, world, world, world, loss, worst, gan_loss), flush=True)
    return {'loss': loss, 'ring_max_abs_err': worst, 'gan_loss': gan_loss}


if __name__ == '__main__':
    dryrun_multigpu(int(sys.argv[1]) if len(sys.argv) > 1 else 2,
                    sys.argv[2] if len(sys.argv) > 2 else 'cuda')
