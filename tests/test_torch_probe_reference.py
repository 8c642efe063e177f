"""K7/K8 (fv3net_tpu_torch.probe) against the reference's own kernel
bodies: ``kern`` and ``stenc`` of tools/probe_pallas.py, run by
``pl.pallas_call(..., interpret=True)`` on the CPU, bit for bit with
``probe.affine`` and ``probe.stencil`` on CPU tensors.

tools/probe_pallas.py runs non-interpret pallas_calls when it is imported
(:21-46), so the two bodies are taken out of its source with ``ast`` and
compiled alone.  ``stenc`` calls ``pltpu.roll(x, -1, 1)``, which the
installed Pallas refuses when traced ("shift must be non-negative",
ROADMAP quirk (s)); it runs here with a ``pltpu`` whose ``roll`` takes the
shift modulo the axis length, as the TPU's rotate does.  That
``pltpu.roll(x, 1, 1)`` is ``torch.roll(x, 1, 1)`` (the left neighbour)
is checked once: it fixes the order of the reference's adds,
(x + left) + right, which the port's plain version and kernel keep."""

import ast
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from fv3net_tpu_torch import probe

SOURCE = Path(__file__).resolve().parents[1] / "tools" / "probe_pallas.py"
SHAPES = [probe.SHAPE, (8, 128)]


def _bodies(pltpu_module):
    """kern and stenc of tools/probe_pallas.py, with `pltpu_module` as
    their pltpu."""
    tree = ast.parse(SOURCE.read_text(), str(SOURCE))
    defs = [node for node in tree.body if isinstance(node, ast.FunctionDef)
            and node.name in ("kern", "stenc")]
    assert [d.name for d in defs] == ["kern", "stenc"]
    ns = {"pltpu": pltpu_module}
    exec(compile(ast.Module(body=defs, type_ignores=[]), str(SOURCE),
                 "exec"), ns)
    return ns["kern"], ns["stenc"]


def _roll_mod(x, shift, axis):
    return pltpu.roll(x, shift % x.shape[axis], axis)


SHIM = types.SimpleNamespace(VMEM=pltpu.VMEM, roll=_roll_mod)


def _interpret(body, x):
    """body run as tools/probe_pallas.py calls it, in interpret mode."""
    spec = pl.BlockSpec(memory_space=pltpu.VMEM)
    return np.asarray(pl.pallas_call(
        body, out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        in_specs=[spec], out_specs=spec, interpret=True,
    )(jnp.asarray(x)))


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_affine_matches_kern(shape):
    kern, _ = _bodies(SHIM)
    x = _x(shape, 0)
    want = _interpret(kern, x)
    got = probe.affine(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_stencil_matches_stenc(shape):
    _, stenc = _bodies(SHIM)
    x = _x(shape, 1)
    want = _interpret(stenc, x)
    got = probe.stencil(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_pltpu_roll_by_one_is_the_left_neighbour():
    def roll1(x_ref, o_ref):
        o_ref[:] = pltpu.roll(x_ref[:], 1, 1)

    x = _x((8, 128), 2)
    np.testing.assert_array_equal(
        _interpret(roll1, x), torch.roll(torch.as_tensor(x), 1, 1).numpy())


def test_stenc_as_written_refuses_its_negative_shift():
    """Quirk (s): the reference's own stencil does not trace here."""
    _, stenc = _bodies(pltpu)
    with pytest.raises(ValueError, match="non-negative"):
        _interpret(stenc, _x((8, 128), 3))
