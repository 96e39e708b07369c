"""GAN losses for vocoder training (LSGAN + feature matching).

Counterpart of ``pytorch_sound_tpu/ops/gan.py``: the HiFi-GAN (arXiv
2010.05646) objective as functions over lists of ``(score, [features])``, as
the MPD / MSD modules return them. Every reduction runs in float32.
"""

from typing import List, Tuple

import torch

DiscOut = List[Tuple[torch.Tensor, List[torch.Tensor]]]


def discriminator_loss(real_outs: DiscOut, fake_outs: DiscOut) -> torch.Tensor:
    """LSGAN: sum over sub-discriminators of E[(1-D(y))^2] + E[D(y_hat)^2]."""
    loss = 0.0
    for (real_score, _), (fake_score, _) in zip(real_outs, fake_outs):
        loss = (loss + torch.mean((1.0 - real_score.float()) ** 2)
                + torch.mean(fake_score.float() ** 2))
    return loss


def generator_adversarial_loss(fake_outs: DiscOut) -> torch.Tensor:
    """LSGAN generator term: sum of E[(1-D(y_hat))^2]."""
    loss = 0.0
    for fake_score, _ in fake_outs:
        loss = loss + torch.mean((1.0 - fake_score.float()) ** 2)
    return loss


def feature_matching_loss(real_outs: DiscOut, fake_outs: DiscOut) -> torch.Tensor:
    """L1 between real/fake discriminator feature maps, summed over layers."""
    loss = 0.0
    for (_, real_feats), (_, fake_feats) in zip(real_outs, fake_outs):
        for rf, ff in zip(real_feats, fake_feats):
            loss = loss + torch.mean(torch.abs(rf.float() - ff.float()))
    return loss
