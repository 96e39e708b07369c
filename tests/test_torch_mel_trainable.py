"""K4, the port's trainable HiFi-GAN mel, against the JAX package's
``fused_hifigan_mel_trainable`` (its Pallas forward in interpret mode on the
CPU), mirroring tests/test_pallas.py:286-306. On the CPU the port's forward
is the plain version; its backward is autograd of the composite in both
packages."""

import jax

jax.config.update('jax_platforms', 'cpu')

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pytorch_sound_tpu.ops import mel as jax_mel  # noqa: E402
from pytorch_sound_tpu.ops.pallas.logmel import \
    fused_hifigan_mel_trainable as jax_trainable  # noqa: E402
from pytorch_sound_tpu_torch.ops import mel as mel_ops  # noqa: E402
from pytorch_sound_tpu_torch.ops.cuda import logmel as lm  # noqa: E402

TOL = 1e-4       # values and gradients (tests/test_pallas.py:300,305)


def test_trainable_mel_matches_jax():
    rng = np.random.default_rng(12)
    wav = (rng.standard_normal((2, 9000)) * 0.2).astype(np.float32)

    def jax_loss(w):
        return jnp.sum(jnp.sin(jax_trainable(w, 'highest')))

    ref = np.asarray(jax_trainable(jnp.asarray(wav), 'highest'))
    ref_grad = np.asarray(jax.grad(jax_loss)(jnp.asarray(wav)))

    before = (lm.fused_log_mel.launches, lm.fused_hifigan_mel_trainable.launches)
    w = torch.from_numpy(wav).requires_grad_(True)
    out = lm.fused_hifigan_mel_trainable(w)
    torch.sum(torch.sin(out)).backward()
    assert tuple(out.shape) == ref.shape == (2, 80, 35)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=TOL, rtol=0)
    np.testing.assert_allclose(w.grad.numpy(), ref_grad, atol=TOL, rtol=0)
    # the CPU path runs the plain version and launches nothing
    assert (lm.fused_log_mel.launches, lm.fused_hifigan_mel_trainable.launches) == before


def test_trainable_mel_grad_is_the_composite_vjp():
    """The backward is the VJP of ops.mel.hifigan_mel_spectrogram at the
    saved waveform, for any cotangent."""
    rng = np.random.default_rng(3)
    wav = torch.from_numpy((rng.standard_normal((3, 4096)) * 0.1).astype(np.float32))
    cot = torch.from_numpy(rng.standard_normal((3, 80, 16)).astype(np.float32))
    a = wav.clone().requires_grad_(True)
    b = wav.clone().requires_grad_(True)
    (lm.fused_hifigan_mel_trainable(a) * cot).sum().backward()
    (mel_ops.hifigan_mel_spectrogram(b) * cot).sum().backward()
    torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0)


def test_trainable_mel_precision_guard():
    """JAX's three modes are taken (tests/test_torch_gen_modes.py holds them
    against JAX's); anything else raises, naming them."""
    for mode in lm.PRECISIONS:
        assert lm.fused_hifigan_mel_trainable(torch.zeros((1, 4096)), precision=mode).shape \
            == (1, 80, 16)
    with pytest.raises(ValueError, match='highest'):
        lm.fused_hifigan_mel_trainable(torch.zeros((1, 4096)), precision='fp8')


@pytest.mark.parametrize('t', [300, 384, 255])
def test_trainable_mel_short_inputs_match_jax_grad(t):
    """Inputs the HiFi-GAN pad (384) exceeds: K4's value and gradient
    against JAX's K4 and ``jax.grad`` of the JAX composite (loss
    sum(sin(mel))) at TOL; below one frame (t = 255) the mel is (1, 80, 0)
    and the gradient zero, in both packages."""
    rng = np.random.default_rng(t)
    wav = (rng.standard_normal((2, t)) * 0.2).astype(np.float32)
    ref = np.asarray(jax_trainable(jnp.asarray(wav), 'highest'))
    ref_grad = np.asarray(jax.grad(lambda w: jnp.sum(jnp.sin(jax_mel.hifigan_mel_spectrogram(w))))(
        jnp.asarray(wav)))
    w = torch.from_numpy(wav).requires_grad_(True)
    out = lm.fused_hifigan_mel_trainable(w)
    torch.sum(torch.sin(out)).backward()
    assert tuple(out.shape) == ref.shape == (2, 80, max(0, 1 + (t - 256) // 256))
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=TOL, rtol=0)
    np.testing.assert_allclose(w.grad.numpy(), ref_grad, atol=TOL, rtol=0)
    assert (ref_grad == 0).all() == (w.grad.numpy() == 0).all() == (t < 256)
