"""VGG-style 128x128 discriminator of SRGAN/ESRGAN (NCHW), the counterpart
of ``edvr_tpu/archs/discriminator_arch.py`` (reference:
basicsr/models/archs/discriminator_arch.py).

Its BatchNorm layers keep flax's running statistics
(``arch_util.BatchNorm2d``): in training mode they normalise by the batch's
mean and biased variance as torch does, but move the running variance by
the biased variance, as ``flax.linen.BatchNorm`` does (torch's
``BatchNorm2d`` uses the unbiased one), with flax's momentum 0.9 (torch's
0.1) and eps 1e-5.
"""

from __future__ import annotations

import contextlib

from torch import nn

from edvr_tpu_torch.archs.arch_util import BatchNorm2d, FlaxBatchNorm, lrelu
from edvr_tpu_torch.utils.registry import ARCH_REGISTRY


@contextlib.contextmanager
def frozen_running_stats(net):
    """Within the block, ``net``'s :class:`FlaxBatchNorm` layers normalise
    by the batch in training mode but leave their running statistics as
    they are (the JAX GAN step discards such a forward's updates)."""
    bns = [m for m in net.modules() if isinstance(m, FlaxBatchNorm)]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m in bns:
            m.update_stats = True


@ARCH_REGISTRY.register()
class VGGStyleDiscriminator128(nn.Module):
    """Ten convs with BatchNorm and LeakyReLU(0.2) down to 4x4, flattened in
    NCHW order into linear1 (100) and linear2 (1 logit)."""

    def __init__(self, num_in_ch=3, num_feat=64):
        super().__init__()
        nf = num_feat
        self.conv0_0 = nn.Conv2d(num_in_ch, nf, 3, 1, 1, bias=True)
        self.conv0_1 = nn.Conv2d(nf, nf, 4, 2, 1, bias=False)
        self.bn0_1 = BatchNorm2d(nf)
        cin = nf
        for i, ch in enumerate((nf * 2, nf * 4, nf * 8, nf * 8), start=1):
            setattr(self, f'conv{i}_0', nn.Conv2d(cin, ch, 3, 1, 1,
                                                 bias=False))
            setattr(self, f'bn{i}_0', BatchNorm2d(ch))
            setattr(self, f'conv{i}_1', nn.Conv2d(ch, ch, 4, 2, 1,
                                                 bias=False))
            setattr(self, f'bn{i}_1', BatchNorm2d(ch))
            cin = ch
        self.linear1 = nn.Linear(nf * 8 * 4 * 4, 100)
        self.linear2 = nn.Linear(100, 1)

    def forward(self, x):
        if x.shape[2:] != (128, 128):
            raise ValueError('Input spatial size must be 128x128, but '
                             f'received {tuple(x.shape)}.')
        act = lambda v: lrelu(v, 0.2)  # noqa: E731
        feat = act(self.conv0_0(x))
        feat = act(self.bn0_1(self.conv0_1(feat)))
        for i in range(1, 5):
            for j in (0, 1):
                conv = getattr(self, f'conv{i}_{j}')
                feat = act(getattr(self, f'bn{i}_{j}')(conv(feat)))
        feat = act(self.linear1(feat.flatten(1)))
        return self.linear2(feat)
