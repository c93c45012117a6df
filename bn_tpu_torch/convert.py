"""State carried between numpy (and so the JAX package's arrays) and torch.

A limb tensor holds 16-bit limbs (values 0..65535).  The JAX package stores
them as uint32; this package stores them as torch.int32, because torch.uint32
has no shift operator on the CPU while int32 has `>>`, `&` and `*`.  The
values are the same integers, so a comparison between the two packages is an
exact integer compare on `to_numpy(...)`.

`from_jax` and `to_numpy` map over tuples and lists, so points (x, y, z),
affine pairs, line-coefficient tensors and constant tables convert in one
call.  `object_from_jax` / `object_to_numpy` carry the state of an API object
(Fr, G1, G2, Gt) across: its `.dev` is a limb array, or for a group element
the tuple (x, y, z).
"""

from __future__ import annotations

import numpy as np
import torch


def default_device(device=None) -> torch.device:
    """The device a creating function uses: the card unless the caller names
    another one.  torch raises when asked for "cuda" where there is none."""
    return torch.device("cuda") if device is None else torch.device(device)


def from_jax(a, device=None):
    """numpy limb array (any integer dtype), or a tuple/list of them ->
    torch.int32 tensor(s) on `device` (default: the card)."""
    if isinstance(a, (tuple, list)):
        return tuple(from_jax(x, device) for x in a)
    arr = np.ascontiguousarray(np.asarray(a).astype(np.int32))
    return torch.from_numpy(arr).to(default_device(device))


def to_numpy(t):
    """torch limb tensor, or a tuple/list of them -> numpy uint32 array(s)."""
    if isinstance(t, (tuple, list)):
        return tuple(to_numpy(x) for x in t)
    return t.detach().cpu().numpy().astype(np.uint32)


def object_from_jax(cls, dev, device=None):
    """The `.dev` of a JAX-side Fr / G1 / G2 / Gt (an array, or a tuple of
    them; numpy or anything numpy reads) -> the port's object of class `cls`
    on `device` (default: the card)."""
    return cls(from_jax(dev, device))


def object_to_numpy(obj):
    """The port's Fr / G1 / G2 / Gt -> its `.dev` as numpy uint32 array(s),
    which the JAX-side class of the same name takes (after `jnp.asarray`)."""
    return to_numpy(obj.dev)
