"""The first stage of ResNet-20 for CIFAR-10 in plain float32 PyTorch: the
reference the encrypted stage (`runtime/workloads.make_resnet20_stage`)
is held to.

He et al., CVPR 2016, section 4.2, with n = 3: the first of the three
stages is three residual blocks at 16 channels of 32 x 32, each

    z = h2(bn2(conv2(h1(bn1(conv1(x))))) + x)

with 3x3 convolutions of stride 1 and padding 1 and the identity
shortcut. Departures from the paper, each forced by CKKS:

* the activation is a per-channel degree-2 polynomial h(y) = a y^2 + b y
  + e (AESPA, Park et al., 2022), not ReLU, which CKKS cannot evaluate
  exactly;
* batch norm is folded into the convolution, as at inference: conv(x)
  times s plus t, s = gamma / sqrt(var + eps), t = beta - s mean;
* the weights are random from a seed (He init, batch-norm statistics and
  activation coefficients near those of a trained network), not trained.

It imports nothing of the port: torch and numpy only, TF32 off, so the
convolutions are float32 throughout.

    PYTHONPATH=src python -m repro_torch.examples.resnet20_plain
"""
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5


def random_params(blocks: int = 3, channels: int = 16,
                  seed: int = 0) -> List[Dict[str, np.ndarray]]:
    """One dict a block, float32: `w1`, `w2` (C, C, 3, 3) He-initialised;
    `bn1`, `bn2` (4, C): gamma, beta, running mean, running variance;
    `act1`, `act2` (3, C): a, b, e of h(y) = a y^2 + b y + e."""
    rng = np.random.default_rng(seed)
    c = channels
    std = np.sqrt(2.0 / (9 * c))

    def bn():
        return np.stack([rng.uniform(0.8, 1.2, c), rng.normal(0, 0.1, c),
                         rng.normal(0, 0.1, c), rng.uniform(0.5, 1.5, c)])

    def act():
        return np.stack([rng.uniform(0.05, 0.2, c), rng.uniform(0.4, 0.6, c),
                         rng.normal(0, 0.05, c)])

    out = []
    for _ in range(blocks):
        out.append({k: v.astype(np.float32) for k, v in (
            ("w1", rng.normal(0, std, (c, c, 3, 3))), ("bn1", bn()),
            ("act1", act()),
            ("w2", rng.normal(0, std, (c, c, 3, 3))), ("bn2", bn()),
            ("act2", act()))})
    return out


def fold_bn(bn: np.ndarray):
    """(scale, bias), each (C,), of a batch norm at inference."""
    gamma, beta, mean, var = (np.asarray(r, dtype=np.float64) for r in bn)
    s = gamma / np.sqrt(var + BN_EPS)
    return s, beta - s * mean


def _per_channel(v, x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v), dtype=x.dtype,
                           device=x.device)[None, :, None, None]


def _conv_bn(x: torch.Tensor, w, bn) -> torch.Tensor:
    s, t = fold_bn(bn)
    y = F.conv2d(x, torch.as_tensor(w, device=x.device), padding=1)
    return y * _per_channel(s, x) + _per_channel(t, x)


def _act(y: torch.Tensor, coeffs) -> torch.Tensor:
    a, b, e = (_per_channel(r, y) for r in coeffs)
    return (y * y) * a + y * b + e


def forward(x: torch.Tensor, params: List[Dict[str, np.ndarray]]
            ) -> torch.Tensor:
    """(N, C, H, W) float32 maps through the stage's blocks."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for p in params:
            h = _act(_conv_bn(x, p["w1"], p["bn1"]), p["act1"])
            x = _act(_conv_bn(h, p["w2"], p["bn2"]) + x, p["act2"])
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    return x


def main(argv=()):
    params = random_params()
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (4, 16, 32, 32)).astype(np.float32))
    y = forward(x, params)
    print(f"resnet20 stage 1: in {tuple(x.shape)} out {tuple(y.shape)} "
          f"rms {float(y.pow(2).mean().sqrt()):.4f}")
    return y


if __name__ == "__main__":
    main()
