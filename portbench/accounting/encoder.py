"""Operations of the ResNet ``SpatialEncoder`` (the mathematics of
``models/encoder.py`` and ``models/resnet.py``): the stem's 7x7 stride-2
convolution, the stages' 3x3 convolutions and 1x1 projections up to
``num_layers``, as products (two operations a multiply-add). The batch
norms, pooling, upsampling and concatenation are elementwise and not
counted."""
from __future__ import annotations

STAGE_BLOCKS = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3)}
STAGE_WIDTHS = (64, 128, 256, 512)


def _out(size: int, kernel: int, stride: int) -> int:
    return (size + 2 * (kernel // 2) - kernel) // stride + 1


def conv_layers(backbone: str, num_layers: int, height: int, width: int):
    """(cin, cout, kernel, out_h, out_w) of every convolution the truncated
    trunk runs on one (height, width) image."""
    layers = []
    h, w = _out(height, 7, 2), _out(width, 7, 2)
    layers.append((3, 64, 7, h, w))
    h, w = _out(h, 3, 2), _out(w, 3, 2)            # the stem's max pool
    cin = 64
    for k in range(1, min(num_layers, 5)):
        cout = STAGE_WIDTHS[k - 1]
        for b in range(STAGE_BLOCKS[backbone][k - 1]):
            stride = 2 if (b == 0 and k > 1) else 1
            ho, wo = _out(h, 3, stride), _out(w, 3, stride)
            layers.append((cin, cout, 3, ho, wo))
            layers.append((cout, cout, 3, ho, wo))
            if stride != 1 or cin != cout:
                layers.append((cin, cout, 1, ho, wo))
            h, w, cin = ho, wo, cout
    return layers


def encoder_image_flops(encoder: dict, height: int, width: int) -> int:
    """Forward operations of the encoder on one image."""
    return sum(2 * cin * cout * k * k * h * w
               for cin, cout, k, h, w in conv_layers(encoder["backbone"], encoder["num_layers"], height, width))


def encoder_image_train_flops(encoder: dict, height: int, width: int) -> int:
    """Forward and backward operations on one image: the backward of every
    convolution takes the gradient of its weight and of its input, but the
    stem needs none for the image."""
    layers = conv_layers(encoder["backbone"], encoder["num_layers"], height, width)
    fwd = [2 * cin * cout * k * k * h * w for cin, cout, k, h, w in layers]
    return 3 * sum(fwd) - fwd[0]
