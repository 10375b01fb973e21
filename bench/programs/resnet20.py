"""The first stage of ResNet-20 for CIFAR-10 (He et al., CVPR 2016,
section 4.2, n = 3): `blocks` residual blocks z = h2(conv2(h1(conv1(x)))
+ x) over `channels` maps of hw x hw, a conv a 3x3 convolution with its
batch norm folded in, h(y) = a y^2 + b y + e a per-channel degree-2
activation (AESPA). Channel-major packing (Lee et al., ICML 2022): pixel
(i, j) of channel c at slot c hw^2 + hw i + j, the values written twice,
so a rotation by d hw^2 brings channel c + d to c. A conv is the sum over
d < channels and dy, dx in {-1, 0, 1} of rotate(x, d hw^2 + hw dy + dx)
times a named diagonal, plus a bias: one rotation a term, as written;
the compiler factors them.

One departure from `runtime/workloads.make_resnet20_stage`: the harness
draws every constant N(0, const_std) per slot, so the activation adds y
to y b, h(y) = a y^2 + (1 + b) y + e. A linear coefficient about 1 passes
each conv's signal on to the output, as a trained activation's (AESPA's
about 0.5 after batch norm) does; one about 0 would shrink it 5 to 10
times an activation, and the output would read mostly the last
activation's constant term."""


def _weight(conv, d, ky, kx):
    return f"{conv}.w{d}.{ky}{kx}"


def consts(blocks, channels):
    names = []
    for k in range(blocks):
        for j in (1, 2):
            conv = f"b{k}.c{j}"
            names += [_weight(conv, d, ky, kx) for d in range(channels)
                      for ky in range(3) for kx in range(3)]
            names.append(f"{conv}.bias")
            names += [f"b{k}.h{j}.{c}" for c in "abe"]
    return tuple(names)


def make(blocks=3, channels=16, hw=32):
    stride = hw * hw

    def conv(x, cs, name):
        acc = None
        for d in range(channels):
            for ky in range(3):
                for kx in range(3):
                    step = d * stride + hw * (ky - 1) + (kx - 1)
                    r = x if step == 0 else x.rotate(step)
                    t = r * cs[_weight(name, d, ky, kx)]
                    acc = t if acc is None else acc + t
        return acc + cs[f"{name}.bias"]

    def act(y, cs, name):
        return ((y * y) * cs[f"{name}.a"] + y * cs[f"{name}.b"] + y
                + cs[f"{name}.e"])

    def stage(x, consts=None):
        for k in range(blocks):
            h = act(conv(x, consts, f"b{k}.c1"), consts, f"b{k}.h1")
            x = act(conv(h, consts, f"b{k}.c2") + x, consts, f"b{k}.h2")
        return x
    return stage, 1, consts(blocks, channels)
