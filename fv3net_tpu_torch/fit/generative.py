"""Generative model families: autoencoder and CycleGAN (the JAX package's
``fit/generative.py``; fv3fit pytorch/cyclegan/train_autoencoder.py:66,
train_cyclegan.py:226).

Both operate on cubed-sphere tiles packed channel-last [batch*6, y, x, c]
like the convolutional family, and run their convolutions in NCHW on the
model's device, in IEEE float32 (not TF32).  The CycleGAN is the
reference's domain-translation tool (coarse <-> fine, or free-running <->
corrected climate states): two resnet generators G: A->B, F: B->A and two
patch discriminators, trained with LSGAN + cycle-consistency + identity
losses, the generator and discriminator Adam steps (b1 0.5) in turn.

flax's convolutions are written out so that a flax kernel (HWIO) loads
as it is:
  * ``_SameConv2d``: ``padding="SAME"`` as ``lax`` splits it: total =
    max((ceil(n/s) - 1) s + k - n, 0), low = total // 2, the rest high
    (asymmetric where the total is odd), padded explicitly before
    ``F.conv2d``;
  * ``_ConvTranspose2d``: ``lax.conv_transpose`` with SAME padding: the
    input dilated by the stride (zeros between its values), padded by
    (k - 1, s - 1) where s > k - 1, else (ceil((k + s - 2) / 2), the
    rest), and convolved with the kernel as it is, unflipped.
    ``nn.ConvTranspose2d`` is the gradient of a convolution, which would
    need the kernel flipped and its channels swapped.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..convert import module_from_flat, module_to_flat, nested_flax_layers
from ..graphs import jit
from . import _shared
from ._shared import (
    Predictor,
    StandardScaler,
    register,
    register_training_function,
)
from .convolutional import (
    _ChannelScaler,
    _float32_convolutions,
    _stack_channels,
)


def same_pads(n: int, k: int, s: int):
    """(low, high) padding of lax's SAME convolution along one axis."""
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def transpose_pads(k: int, s: int):
    """(low, high) padding of lax's SAME transposed convolution along one
    axis of the dilated input."""
    pad_len = k + s - 2
    low = k - 1 if s > k - 1 else math.ceil(pad_len / 2)
    return low, pad_len - low


class _SameConv2d(nn.Conv2d):
    """flax ``nn.Conv(features, kernel, strides, padding="SAME")`` in NCHW."""

    def __init__(self, n_in, n_out, kernel, stride=1):
        super().__init__(n_in, n_out, kernel, stride=stride)

    def forward(self, x):
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        ylo, yhi = same_pads(x.shape[-2], kh, sh)
        xlo, xhi = same_pads(x.shape[-1], kw, sw)
        x = F.pad(x, (xlo, xhi, ylo, yhi))
        return F.conv2d(x, self.weight, self.bias, self.stride)


class _ConvTranspose2d(nn.Conv2d):
    """flax ``nn.ConvTranspose(features, kernel, strides,
    padding="SAME")`` in NCHW (module docstring): the weight has
    nn.Conv2d's layout [out, in, kh, kw], the flax kernel's transpose."""

    def __init__(self, n_in, n_out, kernel, stride):
        super().__init__(n_in, n_out, kernel, stride=stride)

    def forward(self, x):
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        b, c, ny, nx = x.shape
        dilated = x.new_zeros(b, c, (ny - 1) * sh + 1, (nx - 1) * sw + 1)
        dilated[:, :, ::sh, ::sw] = x
        ylo, yhi = transpose_pads(kh, sh)
        xlo, xhi = transpose_pads(kw, sw)
        return F.conv2d(F.pad(dilated, (xlo, xhi, ylo, yhi)), self.weight,
                        self.bias)


def _nchw(module, x):
    """`module` (NCHW) on channel-last x [b, y, x, c]."""
    return module(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class _Encoder(nn.Module):
    """flax ``Conv_i`` (3x3, stride 2) for each stage, ``Conv_depth`` (1x1
    to the latent channels)."""

    def __init__(self, n_in, filters, depth, latent):
        super().__init__()
        chans = [n_in] + [filters * 2 ** i for i in range(depth)]
        self.stages = nn.ModuleList(
            _SameConv2d(a, b, 3, 2) for a, b in zip(chans[:-1], chans[1:]))
        self.head = _SameConv2d(chans[-1], latent, 1)

    def forward(self, x):  # NCHW
        for conv in self.stages:
            x = torch.relu(conv(x))
        return self.head(x)

    def flax_layers(self):
        layers = {f"Conv_{i}": m for i, m in enumerate(self.stages)}
        layers[f"Conv_{len(self.stages)}"] = self.head
        return layers


class _Decoder(nn.Module):
    """flax ``ConvTranspose_j`` (3x3, stride 2; widths filters * 2^i for
    i from depth - 1 down) and ``Conv_0`` (1x1 to the output channels)."""

    def __init__(self, latent, filters, depth, n_out):
        super().__init__()
        chans = [latent] + [filters * 2 ** i for i in reversed(range(depth))]
        self.stages = nn.ModuleList(
            _ConvTranspose2d(a, b, 3, 2)
            for a, b in zip(chans[:-1], chans[1:]))
        self.head = _SameConv2d(chans[-1], n_out, 1)

    def forward(self, z):  # NCHW
        for conv in self.stages:
            z = torch.relu(conv(z))
        return self.head(z)

    def flax_layers(self):
        layers = {f"ConvTranspose_{i}": m
                  for i, m in enumerate(self.stages)}
        layers["Conv_0"] = self.head
        return layers


class _AE(nn.Module):
    """flax ``encoder`` and ``decoder``; channel-last in and out."""

    def __init__(self, n_in, filters, depth, latent, n_out):
        super().__init__()
        self.filters, self.depth = filters, depth
        self.latent, self.n_out = latent, n_out
        self.encoder = _Encoder(n_in, filters, depth, latent)
        self.decoder = _Decoder(latent, filters, depth, n_out)

    def forward(self, x):
        return _nchw(lambda a: self.decoder(self.encoder(a)), x)

    def encode(self, x):
        return _nchw(self.encoder, x)

    def flax_layers(self):
        return {**nested_flax_layers("encoder", self.encoder),
                **nested_flax_layers("decoder", self.decoder)}


@dataclasses.dataclass
class AutoencoderHyperparameters:
    filters: int = 16
    depth: int = 2  # stride-2 stages; tile size must be divisible
    latent: int = 8
    epochs: int = 20
    learning_rate: float = 1e-3
    seed: int = 0


def _unstack(y, names, widths):
    """[..., y, x, c] -> Quantity dict, a width above 1 a [tile, z, y, x]
    field and any other a [tile, y, x] one (the JAX package's rule for
    these families)."""
    from ..util.quantity import Quantity

    out, i = {}, 0
    for name in names:
        w = widths[name]
        block = y[..., i : i + w]
        i += w
        if w > 1:
            out[name] = Quantity(
                np.moveaxis(block, -1, 1), ("tile", "z", "y", "x"), "",
            )
        else:
            out[name] = Quantity(block[..., 0], ("tile", "y", "x"), "")
    return out


def _jit(fn):
    """fn (a module or its method) jitted: without gradients, in IEEE
    float32 convolutions."""
    return jit(_shared.no_grad(fn, _float32_convolutions))


def _run(module, xn, apply):
    """`apply` (a jitted forward of `module`) on host xn on the module's
    device; numpy out."""
    device = next(module.parameters()).device
    return apply(torch.as_tensor(np.asarray(xn, np.float32),
                                 device=device)).cpu().numpy()


@register("autoencoder")
class AutoencoderModel(Predictor):
    def __init__(self, variables, widths, scaler, module):
        super().__init__(variables, variables)
        self.widths = widths
        self.scaler = scaler
        self.module = module.float().eval()
        # the JAX package's jitted apply and encoder
        self._apply = _jit(self.module)
        self._encode = _jit(self.module.encode)

    def encode(self, X):
        x, _ = _stack_channels(X, self.input_variables)
        xn = (x - self.scaler.mean) / self.scaler.std
        return _run(self.module, xn, self._encode)

    def predict(self, X):
        x, _ = _stack_channels(X, self.input_variables)
        xn = (x - self.scaler.mean) / self.scaler.std
        y = _run(self.module, xn, self._apply) * self.scaler.std + \
            self.scaler.mean
        return _unstack(y, self.output_variables, self.widths)

    def dump(self, path: str):
        self.scaler.dump(os.path.join(path, "scaler.npz"))
        np.save(os.path.join(path, "params.npy"), module_to_flat(self.module))
        meta = {
            "input_variables": self.input_variables,
            "widths": self.widths,
            "filters": self.module.filters,
            "depth": self.module.depth,
            "latent": self.module.latent,
            "n_out": self.module.n_out,
        }
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, path: str, device):
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        module = _AE(meta["n_out"], meta["filters"], meta["depth"],
                     meta["latent"], meta["n_out"])
        module_from_flat(module, np.load(os.path.join(path, "params.npy")))
        return cls(
            meta["input_variables"], meta["widths"],
            StandardScaler.load_from(os.path.join(path, "scaler.npz")),
            module.to(device),
        )


def _mse(x, y):
    return torch.mean((x - y) ** 2)


def _reconstruction(module, xb):
    return _mse(module(xb), xb)


@register_training_function("autoencoder", AutoencoderHyperparameters)
def train_autoencoder(
    hyperparameters: AutoencoderHyperparameters,
    train_batches,
    validation_batches=None,
    input_variables=None,
    output_variables=None,
    device=None,
) -> AutoencoderModel:
    """One Adam step an epoch on every sample, in float32 on `device` (the
    CUDA device unless the caller names one)."""
    hp = hyperparameters
    device = _shared.train_device(device, "train_autoencoder")
    names = list(input_variables or output_variables)
    Xs = []
    widths = {}
    for b in train_batches:
        x, widths = _stack_channels(b, names)
        Xs.append(x)
    X = np.concatenate(Xs)
    scaler = _ChannelScaler().fit(X)
    Xn = ((X - scaler.mean) / scaler.std).astype(np.float32)
    module = _AE(X.shape[-1], hp.filters, hp.depth, hp.latent, X.shape[-1])
    _shared.init_params(module, hp.seed)
    module.to(device)
    optimizer = _shared.adam(module, hp.learning_rate)
    xb_all = torch.as_tensor(Xn, device=device)
    with _float32_convolutions(deterministic=True):
        _shared.run_steps(module, optimizer, _reconstruction,
                          ((xb_all,) for _ in range(hp.epochs)))
    return AutoencoderModel(names, widths, scaler, module)


# --------------------------------------------------------------------------
# CycleGAN
# --------------------------------------------------------------------------


class _ResBlock(nn.Module):
    """flax ``Conv_0``, ``Conv_1`` (3x3 SAME); residual."""

    def __init__(self, filters):
        super().__init__()
        self.conv0 = _SameConv2d(filters, filters, 3)
        self.conv1 = _SameConv2d(filters, filters, 3)

    def forward(self, x):  # NCHW
        return x + self.conv1(torch.relu(self.conv0(x)))

    def flax_layers(self):
        return {"Conv_0": self.conv0, "Conv_1": self.conv1}


class _Generator(nn.Module):
    """flax ``Conv_0`` (3x3 to the filters), ``_ResBlock_i``, ``Conv_1``
    (3x3 to the output channels); channel-last in and out."""

    def __init__(self, n_in, filters, n_res, n_out):
        super().__init__()
        self.filters, self.n_res, self.n_out = filters, n_res, n_out
        self.inp = _SameConv2d(n_in, filters, 3)
        self.blocks = nn.ModuleList(_ResBlock(filters) for _ in range(n_res))
        self.out = _SameConv2d(filters, n_out, 3)

    def _forward(self, x):
        h = torch.relu(self.inp(x))
        for block in self.blocks:
            h = block(h)
        return self.out(h)

    def forward(self, x):
        return _nchw(self._forward, x)

    def flax_layers(self):
        layers = {"Conv_0": self.inp, "Conv_1": self.out}
        for i, block in enumerate(self.blocks):
            layers.update(nested_flax_layers(f"_ResBlock_{i}", block))
        return layers


class _Discriminator(nn.Module):
    """flax ``Conv_0`` (4x4 stride 2), ``Conv_1`` (4x4 stride 2, twice the
    filters), leaky ReLU of slope 0.2 after each, ``Conv_2`` (4x4, one
    channel: patch outputs); channel-last in and out."""

    def __init__(self, n_in, filters):
        super().__init__()
        self.convs = nn.ModuleList([
            _SameConv2d(n_in, filters, 4, 2),
            _SameConv2d(filters, 2 * filters, 4, 2),
            _SameConv2d(2 * filters, 1, 4),
        ])

    def _forward(self, x):
        h = F.leaky_relu(self.convs[0](x), 0.2)
        h = F.leaky_relu(self.convs[1](h), 0.2)
        return self.convs[2](h)

    def forward(self, x):
        return _nchw(self._forward, x)

    def flax_layers(self):
        return {f"Conv_{i}": m for i, m in enumerate(self.convs)}


@dataclasses.dataclass
class CycleGANHyperparameters:
    filters: int = 16
    n_res: int = 2
    epochs: int = 50
    learning_rate: float = 2e-4
    cycle_weight: float = 10.0
    identity_weight: float = 0.5
    seed: int = 0


@register("cyclegan")
class CycleGANModel(Predictor):
    """Domain translation A->B on cubed-sphere tiles; predict() maps
    the input variables (domain A) to the output names (domain B)."""

    def __init__(self, input_variables, output_variables, widths,
                 scaler_a, scaler_b, gen_ab, gen_ba):
        super().__init__(input_variables, output_variables)
        self.widths = widths
        self.scaler_a = scaler_a
        self.scaler_b = scaler_b
        self.gen_ab = gen_ab.float().eval()
        self.gen_ba = gen_ba.float().eval()
        # the JAX package's jitted translations A->B and B->A
        self._fwd = _jit(self.gen_ab)
        self._bwd = _jit(self.gen_ba)

    def predict(self, X):
        x, _ = _stack_channels(X, self.input_variables)
        xn = (x - self.scaler_a.mean) / self.scaler_a.std
        y = _run(self.gen_ab, xn, self._fwd) * self.scaler_b.std + \
            self.scaler_b.mean
        return _unstack(y, self.output_variables, self.widths)

    def dump(self, path: str):
        self.scaler_a.dump(os.path.join(path, "scaler_a.npz"))
        self.scaler_b.dump(os.path.join(path, "scaler_b.npz"))
        for tag, gen in (("ab", self.gen_ab), ("ba", self.gen_ba)):
            np.save(os.path.join(path, f"params_{tag}.npy"),
                    module_to_flat(gen))
        meta = {
            "input_variables": self.input_variables,
            "output_variables": self.output_variables,
            "widths": self.widths,
            "filters": self.gen_ab.filters,
            "n_res": self.gen_ab.n_res,
            "n_out": self.gen_ab.n_out,
        }
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, path: str, device):
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        gens = []
        for tag in ("ab", "ba"):
            gen = _Generator(meta["n_out"], meta["filters"], meta["n_res"],
                             meta["n_out"])
            module_from_flat(
                gen, np.load(os.path.join(path, f"params_{tag}.npy")))
            gens.append(gen.to(device))
        return cls(
            meta["input_variables"], meta["output_variables"],
            meta["widths"],
            StandardScaler.load_from(os.path.join(path, "scaler_a.npz")),
            StandardScaler.load_from(os.path.join(path, "scaler_b.npz")),
            *gens,
        )


def _frozen(module):
    """`module` applied with its parameters detached (no gradient flows
    into them)."""
    params = {k: v.detach() for k, v in module.named_parameters()}
    return lambda x: torch.func.functional_call(module, params, (x,))


def _cyclegan_losses(hp, d_a, d_b):
    """The generator loss of the pair (G_ab, G_ba) with the
    discriminators fixed, and the discriminator loss of the pair (D_a,
    D_b) against the generators' current fakes (the JAX package's g_step
    and d_step)."""

    def g_loss(gens, xa, xb):
        gab, gba = gens
        da, db = _frozen(d_a), _frozen(d_b)
        fake_b = gab(xa)
        fake_a = gba(xb)
        adv = _mse(db(fake_b), 1.0) + _mse(da(fake_a), 1.0)
        cyc = _mse(gba(fake_b), xa) + _mse(gab(fake_a), xb)
        idt = _mse(gab(xb), xb) + _mse(gba(xa), xa)
        return (adv + hp.cycle_weight * cyc
                + hp.cycle_weight * hp.identity_weight * idt)

    def d_loss(discs, gens, xa, xb):
        da, db = discs
        with torch.no_grad():
            fake_b = gens[0](xa)
            fake_a = gens[1](xb)
        return (_mse(da(xa), 1.0) + _mse(da(fake_a), 0.0)
                + _mse(db(xb), 1.0) + _mse(db(fake_b), 0.0))

    return g_loss, d_loss


@register_training_function("cyclegan", CycleGANHyperparameters)
def train_cyclegan(
    hyperparameters: CycleGANHyperparameters,
    train_batches,
    validation_batches=None,
    input_variables=None,
    output_variables=None,
    device=None,
) -> CycleGANModel:
    """train_batches: iterable of dicts holding BOTH domains' states;
    input_variables name domain A's fields, output_variables domain
    B's.  LSGAN objective with cycle + identity terms: each epoch one
    generator Adam step, then one discriminator step against the updated
    generators, on every sample, in float32 on `device` (the CUDA device
    unless the caller names one)."""
    hp = hyperparameters
    device = _shared.train_device(device, "train_cyclegan")
    As, Bs = [], []
    widths = {}
    for b in train_batches:
        a, _ = _stack_channels(b, input_variables)
        bb, widths = _stack_channels(b, output_variables)
        As.append(a)
        Bs.append(bb)
    A = np.concatenate(As)
    B = np.concatenate(Bs)
    if A.shape[-1] != B.shape[-1]:
        raise ValueError("cyclegan domains must share channel count")
    scaler_a = _ChannelScaler().fit(A)
    scaler_b = _ChannelScaler().fit(B)
    An = ((A - scaler_a.mean) / scaler_a.std).astype(np.float32)
    Bn = ((B - scaler_b.mean) / scaler_b.std).astype(np.float32)

    c = A.shape[-1]
    gens = nn.ModuleList(_Generator(c, hp.filters, hp.n_res, c)
                         for _ in range(2))
    discs = nn.ModuleList(_Discriminator(c, hp.filters) for _ in range(2))
    # the JAX package draws g_ab, g_ba, d_a, d_b from four split keys
    for i, m in enumerate((*gens, *discs)):
        _shared.init_params(m, hp.seed + i)
    gens.to(device)
    discs.to(device)
    opt_g = _shared.adam(gens, hp.learning_rate, b1=0.5)
    opt_d = _shared.adam(discs, hp.learning_rate, b1=0.5)
    g_loss, d_loss = _cyclegan_losses(hp, *discs)
    xa = torch.as_tensor(An, device=device)
    xb = torch.as_tensor(Bn, device=device)
    with _float32_convolutions(deterministic=True):
        _shared.run_rounds(
            [(gens, opt_g, g_loss, (xa, xb)),
             (discs, opt_d, lambda d, *x: d_loss(d, gens, *x), (xa, xb))],
            hp.epochs)
    return CycleGANModel(
        list(input_variables), list(output_variables), widths,
        scaler_a, scaler_b, gens[0], gens[1],
    )
