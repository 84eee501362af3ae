"""ResNet-50 feature-pyramid backbone (counterpart of
duoformer_tcga_tpu/models/resnet.py: ResNetBackbone, fold_bn).

torchvision v1.5 bottlenecks (stride on the 3x3 conv2), the default 7x7
stem (the JAX package's space-to-depth stem is an opt-in TPU transform
and is not ported), BN in inference mode. Module names follow the JAX
param tree (conv1/bn1/layer1..4/[i]/conv{1,2,3}/bn{1,2,3}/downsample), so
utils/convert.py maps one onto the other by name.

Runs NCHW; on the card the conv weights and activations are channels_last,
which is the NHWC layout of the JAX package in memory.
"""

from __future__ import annotations

from torch import nn

from ..ops import nn as ops

# (stage block counts, expansion) — only the bottleneck R50 is ported
RESNET_SPECS = {50: ([3, 4, 6, 3], 4)}


def _conv(kh, kw, cin, cout, generator):
    """torchvision ResNet conv: kaiming fan_out / relu, no bias."""
    return ops.Conv2d(kh, kw, cin, cout, bias=False,
                      scheme="kaiming_fan_out", generator=generator)


class Downsample(nn.Module):
    def __init__(self, cin, cout, generator):
        super().__init__()
        self.conv = _conv(1, 1, cin, cout, generator)
        self.bn = ops.BatchNorm(cout)


class Bottleneck(nn.Module):
    def __init__(self, cin, width, cout, stride, generator):
        super().__init__()
        self.stride = stride
        self.conv1 = _conv(1, 1, cin, width, generator)
        self.bn1 = ops.BatchNorm(width)
        self.conv2 = _conv(3, 3, width, width, generator)
        self.bn2 = ops.BatchNorm(width)
        self.conv3 = _conv(1, 1, width, cout, generator)
        self.bn3 = ops.BatchNorm(cout)
        self.downsample = (Downsample(cin, cout, generator)
                           if stride != 1 or cin != cout else None)

    def forward(self, x):
        y = ops.relu(self.bn1(self.conv1(x, 1, "VALID")))
        y = ops.relu(self.bn2(self.conv2(y, self.stride, 1)))
        y = self.bn3(self.conv3(y, 1, "VALID"))
        idn = x
        if self.downsample is not None:
            idn = self.downsample.bn(
                self.downsample.conv(x, self.stride, "VALID"))
        return ops.relu(y + idn)


class ResNetBackbone(nn.Module):
    """forward(x [B, 3, 224, 224]) -> {"0": 56^2x256, "1": 28^2x512,
    "2": 14^2x1024, "3": 7^2x2048} NCHW stage features."""

    def __init__(self, depth=50, generator=None):
        super().__init__()
        if depth not in RESNET_SPECS:
            raise NotImplementedError(
                f"ResNet-{depth}: only the ResNet-50 backbone is ported")
        blocks, expansion = RESNET_SPECS[depth]
        widths = [64 * 2 ** i for i in range(4)]
        self.stage_out = [w * expansion for w in widths]
        self.conv1 = _conv(7, 7, 3, 64, generator)
        self.bn1 = ops.BatchNorm(64)
        cin = 64
        for si, (n, width, cout) in enumerate(zip(blocks, widths,
                                                  self.stage_out)):
            layer = []
            for bi in range(n):
                stride = 2 if (si > 0 and bi == 0) else 1
                layer.append(Bottleneck(cin, width, cout, stride, generator))
                cin = cout
            setattr(self, f"layer{si + 1}", nn.ModuleList(layer))

    def forward(self, x):
        y = ops.relu(self.bn1(self.conv1(x, 2, 3)))
        y = ops.maxpool2d(y, window=3, stride=2, padding=1)
        features = {}
        for si in range(4):
            for blk in getattr(self, f"layer{si + 1}"):
                y = blk(y)
            features[str(si)] = y
        return features


def fold_bn(module: nn.Module) -> nn.Module:
    """Fold every BatchNorm under `module` into its float32 affine, in
    place (exact for the frozen eval-mode backbone)."""
    for m in module.modules():
        if isinstance(m, ops.BatchNorm):
            m.fold()
    return module
