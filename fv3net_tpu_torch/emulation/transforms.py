"""Differentiable physics-space transforms for microphysics emulation.

The reference trains its Zhao-Carr emulators in transformed spaces —
log cloud/humidity, gscond differences, per-temperature-bin scaled
tendencies, tendency-sign classes — via invertible TensorTransforms
composed from YAML (`external/fv3fit/fv3fit/emulation/transforms/
{transforms,factories,zhao_carr}.py`).  Each transform maps a dict of
arrays forward (physics -> model space) before training and backward
(model -> physics space) at prediction time; factories fit data-derived
parameters (bin scales) from a sample batch via ``build``.

The JAX package's ``emulation/transforms.py`` translated: transforms are
pure functions over ``{name: array}`` dicts (shape [sample, feature]) of
numpy arrays or torch tensors, switching on the kind they are given (the
JAX package switches between numpy and jax.numpy), so a tensor stays on
its device.  Zhao-Carr class names,
thresholds, and the zero-cloud/zero-tendency reconstruction follow
`zhao_carr.py:285-298` (classify) and `zhao_carr.py:221-244` (_combine).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Set

import numpy as np
import torch

ArrayDict = Dict[str, np.ndarray]

# physcons.f values used by the reference emulation stack
# (zhao_carr.py:21-22)
LATENT_HEAT = 2.5e6
SPECIFIC_HEAT = 1.0046e3

POSITIVE_TENDENCY = "positive_tendency"
ZERO_TENDENCY = "zero_tendency"
ZERO_CLOUD = "zero_cloud"
NEGATIVE_TENDENCY = "negative_tendency"
NONTRIVIAL_TENDENCY = "nontrivial_tendency"
CLASS_NAMES = {
    POSITIVE_TENDENCY, ZERO_TENDENCY, ZERO_CLOUD, NEGATIVE_TENDENCY,
}

CLOUD_INPUT = "cloud_water_mixing_ratio_input"
CLOUD_GSCOND = "cloud_water_mixing_ratio_after_gscond"
T_INPUT = "air_temperature_input"
T_GSCOND = "air_temperature_after_gscond"
QV_INPUT = "specific_humidity_input"
QV_GSCOND = "specific_humidity_after_gscond"


def _xp(x):
    """The array namespace of `x`: torch for a tensor, else numpy."""
    return torch if isinstance(x, torch.Tensor) else np


def _where(cond, a, b):
    if isinstance(cond, torch.Tensor):
        return torch.where(cond, a, b)
    return np.where(cond, a, b)


def _table(values, like):
    """`values` (a host array) in the namespace, dtype and device of
    `like`."""
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(np.asarray(values), dtype=like.dtype,
                               device=like.device)
    return np.asarray(values)


class TensorTransform:
    """Invertible dict-to-dict transform.  ``build`` fits data-derived
    parameters from a sample batch and returns the ready transform."""

    def build(self, sample: ArrayDict) -> "TensorTransform":
        return self

    def forward(self, x: ArrayDict) -> ArrayDict:
        return x

    def backward(self, y: ArrayDict) -> ArrayDict:
        return y

    def backward_names(self, requested: Set[str]) -> Set[str]:
        """Names needed in model space to reconstruct ``requested``
        physics-space names (factories.py backward_names contract)."""
        return set(requested)


@dataclasses.dataclass
class LogTransform:
    """y = log(x + eps) elementwise (transforms.py:111-130)."""

    epsilon: float = 1e-10

    def forward(self, x):
        return _xp(x).log(x + self.epsilon)

    def backward(self, y):
        return _xp(y).exp(y) - self.epsilon


@dataclasses.dataclass
class LimitValueTransform:
    """Identity forward; backward clamps into [lower, upper] (zeroing
    out-of-range values, transforms.py:133-154)."""

    lower: Optional[float] = 0.0
    upper: Optional[float] = None

    def forward(self, x):
        return x

    def backward(self, y):
        out = y
        if self.lower is not None:
            out = _where(out < self.lower, 0.0, out)
        if self.upper is not None:
            out = _where(out > self.upper, 0.0, out)
        return out


@dataclasses.dataclass
class TransformedVariableConfig(TensorTransform):
    """Univariate transform of ``source`` stored under ``to``
    (factories.py TransformedVariableConfig)."""

    source: str
    to: str
    transform: object = dataclasses.field(default_factory=LogTransform)

    def forward(self, x):
        out = dict(x)
        if self.source in x:
            out[self.to] = self.transform.forward(x[self.source])
        return out

    def backward(self, y):
        out = dict(y)
        if self.to in y:
            out[self.source] = self.transform.backward(y[self.to])
        return out

    def backward_names(self, requested):
        requested = set(requested)
        if self.source in requested:
            requested.discard(self.source)
            requested.add(self.to)
        return requested


@dataclasses.dataclass
class Difference(TensorTransform):
    """to = after - before; backward reconstructs after = before + to
    (transforms.py:18-59)."""

    to: str
    before: str
    after: str

    def forward(self, x):
        out = dict(x)
        if self.before in x and self.after in x:
            out[self.to] = x[self.after] - x[self.before]
        return out

    def backward(self, y):
        out = dict(y)
        if self.to in y and self.before in y:
            out[self.after] = y[self.before] + y[self.to]
        return out

    def backward_names(self, requested):
        requested = set(requested)
        if self.after in requested:
            requested.discard(self.after)
            requested |= {self.to, self.before}
        return requested


@dataclasses.dataclass
class ConditionallyScaled(TensorTransform):
    """to = (source - binned_mean) / max(binned_std, min_scale), with
    bins over a conditioning variable (factories.py ConditionallyScaled):
    the per-temperature-bin tendency scaling of the Zhao-Carr configs.

    ``build`` fits equal-population bin edges of ``condition_on`` and
    the per-bin mean/std of ``source`` from the sample.
    """

    to: str = ""
    source: str = ""
    condition_on: str = ""
    bins: int = 50
    min_scale: float = 1e-14
    fit_filter_magnitude: Optional[float] = None

    def build(self, sample):
        cond = np.asarray(sample[self.condition_on]).ravel()
        src = np.asarray(sample[self.source]).ravel()
        if self.fit_filter_magnitude is not None:
            keep = np.abs(src) > self.fit_filter_magnitude
            cond, src = cond[keep], src[keep]
        qs = np.linspace(0.0, 1.0, self.bins + 1)
        edges = np.quantile(cond, qs)
        # strictly increasing interior edges for searchsorted
        interior = np.maximum.accumulate(edges[1:-1])
        idx = np.searchsorted(interior, cond, side="right")
        mean = np.zeros(self.bins)
        std = np.full(self.bins, self.min_scale)
        for b in range(self.bins):
            sel = src[idx == b]
            if sel.size:
                mean[b] = sel.mean()
                std[b] = max(sel.std(), self.min_scale)
        fitted = dataclasses.replace(self)
        fitted._edges = interior
        fitted._mean = mean
        fitted._std = std
        return fitted

    def _bin(self, cond):
        if isinstance(cond, torch.Tensor):
            edges = _table(self._edges, cond).contiguous()
            return torch.searchsorted(edges, cond.contiguous(), right=True)
        return np.searchsorted(self._edges, cond, side="right")

    def forward(self, x):
        out = dict(x)
        if self.source in x and self.condition_on in x:
            idx = self._bin(x[self.condition_on])
            src = x[self.source]
            mean = _table(self._mean, src)[idx]
            std = _table(self._std, src)[idx]
            out[self.to] = (src - mean) / std
        return out

    def backward(self, y):
        out = dict(y)
        if self.to in y and self.condition_on in y:
            idx = self._bin(y[self.condition_on])
            scaled = y[self.to]
            mean = _table(self._mean, scaled)[idx]
            std = _table(self._std, scaled)[idx]
            out[self.source] = scaled * std + mean
        return out

    def backward_names(self, requested):
        requested = set(requested)
        if self.source in requested:
            requested.discard(self.source)
            requested |= {self.to, self.condition_on}
        return requested

    # fitted parameters for serialization
    def params(self) -> Dict[str, np.ndarray]:
        return {
            "edges": self._edges, "mean": self._mean, "std": self._std,
        }

    def with_params(self, edges, mean, std) -> "ConditionallyScaled":
        fitted = dataclasses.replace(self)
        fitted._edges = np.asarray(edges)
        fitted._mean = np.asarray(mean)
        fitted._std = np.asarray(std)
        return fitted


def classify(cloud_in, cloud_out, timestep: float) -> ArrayDict:
    """Tendency-sign classes (zhao_carr.py:285-298): positive / zero /
    negative tendency, and the zero-cloud destruction case."""
    xp = _xp(cloud_in)
    state_thresh = 1e-15
    tend_thresh = 1e-15
    tend = (cloud_out - cloud_in) / timestep
    some_cloud_out = xp.abs(cloud_out) > state_thresh
    negative_tend = tend < -tend_thresh
    return {
        POSITIVE_TENDENCY: tend > tend_thresh,
        ZERO_TENDENCY: xp.abs(tend) <= tend_thresh,
        ZERO_CLOUD: negative_tend & ~some_cloud_out,
        NEGATIVE_TENDENCY: negative_tend & some_cloud_out,
    }


@dataclasses.dataclass
class MicrophysicsClassesV1OneHot(TensorTransform):
    """Stacked one-hot gscond classes under ``to``
    (zhao_carr.py:MicrophysicsClassesV1OneHot)."""

    cloud_in: str = CLOUD_INPUT
    cloud_out: str = CLOUD_GSCOND
    timestep: float = 900.0
    to: str = "gscond_classes"

    def build(self, sample):
        return self

    @property
    def names(self) -> List[str]:
        return sorted(CLASS_NAMES)

    def forward(self, x):
        out = dict(x)
        if self.cloud_in in x and self.cloud_out in x:
            xp = _xp(x[self.cloud_in])
            classes = classify(
                x[self.cloud_in], x[self.cloud_out], self.timestep
            )
            out.update(classes)
            out[NONTRIVIAL_TENDENCY] = (
                classes[POSITIVE_TENDENCY] | classes[NEGATIVE_TENDENCY]
            )
            out[self.to] = xp.stack(
                [classes[name] for name in self.names], -1
            )
        return out

    def backward_names(self, requested):
        requested = set(requested)
        if self.to in requested or requested & (CLASS_NAMES | {NONTRIVIAL_TENDENCY}):
            requested -= CLASS_NAMES | {NONTRIVIAL_TENDENCY, self.to}
            requested |= {self.cloud_in, self.cloud_out}
        return requested


@dataclasses.dataclass
class GscondClassesRoute(TensorTransform):
    """Reconstruct gscond outputs from predicted humidity/temperature
    plus predicted classes (zhao_carr.py GscondRoute/_combine):

    - net condensation = qv_in - qv_out updates cloud,
    - the zero-tendency class freezes the state,
    - the zero-cloud class evaporates the whole cloud.
    """

    class_key: str = "gscond_classes"
    timestep: float = 900.0

    def backward(self, y):
        out = dict(y)
        need = {T_GSCOND, QV_GSCOND, CLOUD_INPUT, T_INPUT, QV_INPUT}
        if not need <= set(y) or self.class_key not in y:
            return out
        xp = _xp(y[CLOUD_INPUT])
        names = sorted(CLASS_NAMES)
        cls = y[self.class_key]
        # predicted logits/probabilities -> hard argmax routing
        hard = xp.argmax(cls, axis=-1)
        zero_tend = hard == names.index(ZERO_TENDENCY)
        zero_cloud = hard == names.index(ZERO_CLOUD)

        cloud_in = y[CLOUD_INPUT]
        t_in, t_aft = y[T_INPUT], y[T_GSCOND]
        qv_in, qv_aft = y[QV_INPUT], y[QV_GSCOND]
        condensation = qv_in - qv_aft
        cloud_aft = cloud_in + condensation

        cloud = _where(zero_tend, cloud_in, cloud_aft)
        t = _where(zero_tend, t_in, t_aft)
        qv = _where(zero_tend, qv_in, qv_aft)
        cloud = _where(zero_cloud, 0.0, cloud)
        qv = _where(zero_cloud, qv_in + cloud_in, qv)
        t = _where(
            zero_cloud,
            t_in - cloud_in * LATENT_HEAT / SPECIFIC_HEAT,
            t,
        )
        out[CLOUD_GSCOND] = cloud
        out[T_GSCOND] = t
        out[QV_GSCOND] = qv
        return out

    def backward_names(self, requested):
        requested = set(requested)
        if CLOUD_GSCOND in requested:
            requested.discard(CLOUD_GSCOND)
            requested |= {
                self.class_key, T_GSCOND, QV_GSCOND,
                CLOUD_INPUT, T_INPUT, QV_INPUT,
            }
        return requested


@dataclasses.dataclass
class CloudLimiter(TensorTransform):
    """Condense away negative cloud on backward, conserving moisture
    and energy (zhao_carr.py:55-63 limit_negative_cloud)."""

    cloud: str = CLOUD_GSCOND
    humidity: str = QV_GSCOND
    temperature: str = T_GSCOND

    def backward(self, y):
        out = dict(y)
        need = {self.cloud, self.humidity, self.temperature}
        if not need <= set(y):
            return out
        xp = _xp(y[self.cloud])
        cloud, qv, t = y[self.cloud], y[self.humidity], y[self.temperature]
        condensation = _where(cloud < 0, -cloud, 0.0)
        condensation = xp.minimum(condensation, qv)
        out[self.humidity] = qv - condensation
        out[self.temperature] = (
            t + condensation * LATENT_HEAT / SPECIFIC_HEAT
        )
        out[self.cloud] = cloud + condensation
        return out


@dataclasses.dataclass
class RelativeHumidityTransform(TensorTransform):
    """Adds relative humidity from T, qv, p (zhao_carr.py:112-147)."""

    to: str = "relative_humidity"
    temperature: str = T_INPUT
    humidity: str = QV_INPUT
    pressure: str = "air_pressure"

    def forward(self, x):
        out = dict(x)
        if {self.temperature, self.humidity, self.pressure} <= set(x):
            from ..utils.thermo import relative_humidity_from_pressure

            out[self.to] = relative_humidity_from_pressure(
                x[self.temperature], x[self.humidity], x[self.pressure]
            )
        return out

    def backward_names(self, requested):
        requested = set(requested)
        if self.to in requested:
            requested.discard(self.to)
            requested |= {self.temperature, self.humidity, self.pressure}
        return requested


def _forward_deps(t) -> Set[str]:
    """Physics/model-space names a transform's forward pass consumes to
    produce its ``to`` name."""
    if isinstance(t, TransformedVariableConfig):
        return {t.source}
    if isinstance(t, Difference):
        return {t.before, t.after}
    if isinstance(t, ConditionallyScaled):
        return {t.source, t.condition_on}
    if isinstance(t, MicrophysicsClassesV1OneHot):
        return {t.cloud_in, t.cloud_out}
    if isinstance(t, RelativeHumidityTransform):
        return {t.temperature, t.humidity, t.pressure}
    return set()


class ComposedTransform(TensorTransform):
    """forward applies in order, backward in reverse
    (transforms.py:227-247)."""

    def __init__(self, transforms: Sequence[TensorTransform]):
        self.transforms = list(transforms)

    def forward_input_names(self, requested: Set[str]) -> Set[str]:
        """Names a caller must supply so that ``forward`` produces all
        of ``requested`` (the factories.py input-resolution role)."""
        requested = set(requested)
        for t in reversed(self.transforms):
            to = getattr(t, "to", None)
            if to is not None and to in requested:
                requested.discard(to)
                requested |= _forward_deps(t)
        return requested

    def build(self, sample):
        built = []
        x = dict(sample)
        for t in self.transforms:
            t = t.build(x)
            x = t.forward(x)
            built.append(t)
        return ComposedTransform(built)

    def forward(self, x):
        for t in self.transforms:
            x = t.forward(x)
        return x

    def backward(self, y):
        for t in reversed(self.transforms):
            y = t.backward(y)
        return y

    def backward_names(self, requested):
        for t in reversed(self.transforms):
            requested = t.backward_names(requested)
        return requested


_TRANSFORM_KINDS = {
    "log": lambda d: TransformedVariableConfig(
        source=d["source"], to=d["to"],
        transform=LogTransform(d.get("epsilon", 1e-10)),
    ),
    "limit": lambda d: TransformedVariableConfig(
        source=d["source"], to=d["to"],
        transform=LimitValueTransform(
            d.get("lower", 0.0), d.get("upper")
        ),
    ),
    "difference": lambda d: Difference(
        to=d["to"], before=d["before"], after=d["after"]
    ),
    "conditionally_scaled": lambda d: ConditionallyScaled(
        to=d["to"], source=d["source"], condition_on=d["condition_on"],
        bins=d.get("bins", 50), min_scale=d.get("min_scale", 1e-14),
        fit_filter_magnitude=d.get("fit_filter_magnitude"),
    ),
    "classes_v1_one_hot": lambda d: MicrophysicsClassesV1OneHot(
        timestep=d.get("timestep", 900.0),
        to=d.get("to", "gscond_classes"),
    ),
    "gscond_route": lambda d: GscondClassesRoute(
        class_key=d.get("class_key", "gscond_classes"),
        timestep=d.get("timestep", 900.0),
    ),
    "cloud_limiter": lambda d: CloudLimiter(
        cloud=d.get("cloud", CLOUD_GSCOND),
        humidity=d.get("humidity", QV_GSCOND),
        temperature=d.get("temperature", T_GSCOND),
    ),
    "relative_humidity": lambda d: RelativeHumidityTransform(
        to=d.get("to", "relative_humidity")
    ),
}


def transform_from_config(spec: Mapping) -> TensorTransform:
    """One transform from a config dict; mirrors the YAML vocabulary of
    the reference's factories (`tensor_transform:` lists).  The kind is
    inferred the same way: ``before/after`` -> difference,
    ``condition_on`` -> conditionally scaled, else a univariate
    ``transform`` entry, unless an explicit ``kind`` is given."""
    spec = dict(spec)
    kind = spec.pop("kind", None)
    if kind is None:
        if "before" in spec:
            kind = "difference"
        elif "condition_on" in spec:
            kind = "conditionally_scaled"
        elif "epsilon" in spec or "transform" in spec:
            kind = "log"
        else:
            raise ValueError(f"cannot infer transform kind from {spec}")
    return _TRANSFORM_KINDS[kind](spec)


def compose_from_config(specs: Sequence[Mapping]) -> ComposedTransform:
    return ComposedTransform([transform_from_config(s) for s in specs])
