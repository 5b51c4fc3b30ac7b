"""Carry state across between the reference package and this one.

Everything crosses as numpy arrays keyed by field name, so neither
package imports the other: a caller holding a reference state turns it
into `{name: np.asarray(leaf)}` and hands the dict over.  A batched state
(a multi-world batch, every leaf with a leading world axis) crosses the
same way.
"""

from __future__ import annotations

import numpy as np
import torch

from avida_tpu_torch.config.schema import AvidaConfig, _parse_scalar
from avida_tpu_torch.core.state import (FIELD_DTYPES, PopulationState,
                                        state_field_names)


def state_from_arrays(arrays: dict, device="cpu") -> PopulationState:
    """{field: np.ndarray} (every state_field_names() key; a missing or
    None entry is a disabled leaf) -> PopulationState on `device`."""
    leaves = {}
    for name in state_field_names():
        a = arrays.get(name)
        if a is None:
            leaves[name] = None
            continue
        t = torch.from_numpy(np.array(a, copy=True, order="C"))
        if t.dtype != FIELD_DTYPES[name]:
            raise TypeError(f"field {name!r}: dtype {t.dtype}, expected "
                            f"{FIELD_DTYPES[name]}")
        leaves[name] = t.to(device)
    return PopulationState(**leaves)


def state_to_arrays(st: PopulationState) -> dict:
    """PopulationState -> {field: np.ndarray} (None for disabled leaves);
    a batched state keeps its leading world axis."""
    return {name: (None if getattr(st, name) is None
                   else getattr(st, name).detach().cpu().numpy())
            for name in state_field_names()}


def batched_state_from_arrays(arrays: dict, device="cpu") -> PopulationState:
    """A reference batched state ({field: np.ndarray}, every leaf with a
    leading world axis) -> the port's batched state (core/state.py
    stack_states' layout) on `device`."""
    sizes = {np.shape(a)[0] for a in arrays.values() if a is not None}
    if len(sizes) != 1 or 0 in sizes:
        raise ValueError(f"batched state: leading world axes {sorted(sizes)}"
                         f", expected one size >= 1")
    return state_from_arrays(arrays, device)


def key_from_data(data, device="cpu") -> torch.Tensor:
    """A reference key's raw words (uint32[2], `jax.random.key_data`)."""
    d = np.asarray(data, dtype=np.uint32).reshape(2)
    return torch.tensor([int(d[0]), int(d[1])], dtype=torch.int64,
                        device=device)


def keys_from_data(data, device="cpu") -> torch.Tensor:
    """Stacked reference keys' raw words (uint32[W, 2]) -> int64[W, 2],
    the run keys of a batch."""
    d = np.asarray(data, dtype=np.uint32).reshape(-1, 2)
    return torch.from_numpy(d.astype(np.int64)).to(device)


def config_from_dict(values: dict) -> AvidaConfig:
    """An AvidaConfig from {NAME: value}, coerced as `-set NAME VALUE`."""
    cfg = AvidaConfig()
    for name, value in values.items():
        cfg.set(name, _parse_scalar(str(value)))
    return cfg
