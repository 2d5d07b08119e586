"""The port's compute module against the JAX package's: it exposes every
public name of `arrow_go_tpu.compute`, and each typed wrapper (`add` ...
`stddev`, with `and_` / `or_` and the builtin-shadowing `sum`, `min`,
`max`, `abs`, `round`, `any` and `all`) gives the JAX wrapper's result
on the registry test's data (its seeded columns, options and
comparison: ints and bools bit for bit, transcendental functions at
rtol 1e-14), with the first column as a device column and as a host
array."""
import types

import pytest

import arrow_go_tpu.compute as jpc

import arrow_go_tpu_torch.compute as pc
from test_torch_registry import (FLOAT_BINARY, FLOAT_UNARY, JAX_TYPE_ERROR,
                                 _args, _case, _same)


def _public(m) -> set:
    """A module's public names, less its submodules and the typing and
    __future__ names its imports leave."""
    out = set()
    for n in dir(m):
        v = getattr(m, n)
        if n.startswith("_") or isinstance(v, types.ModuleType) or \
                type(v).__module__ in ("typing", "__future__"):
            continue
        out.add(n)
    return out


WRAPPERS = sorted(n for n, f in vars(jpc).items()
                  if getattr(f, "__qualname__", "").startswith(
                      ("_wrap1.", "_wrap2.")))


def test_the_public_surface_is_the_jax_one():
    assert _public(jpc) - _public(pc) == set()
    assert len(WRAPPERS) == 60


@pytest.mark.parametrize("name", WRAPPERS)
def test_typed_wrapper_matches_jax(name):
    jfn, fn = getattr(jpc, name), getattr(pc, name)
    reg = jfn.__name__               # and_ -> "and", or_ -> "or"
    assert fn.__name__ == reg
    assert reg not in JAX_TYPE_ERROR
    spec, jopts, topts = _case(reg)
    rtol = 1e-14 if reg in FLOAT_BINARY or reg in FLOAT_UNARY - {
        "floor", "ceil", "trunc", "abs", "sign", "negate"} else None
    for host_first in (False, True):
        jargs, targs = _args(spec, host_first)
        want = jfn(*jargs, options=jopts)
        got = fn(*targs, options=topts, device="cpu")
        _same(got, want, rtol)
