"""In-place carry updates: the port's meaning of buffer donation.

Counterpart of ``keystone_tpu/utils/donation.py``. The JAX package
donates a streamed fit's carry buffers to the accumulate program, so the
update writes the new carry into the old carry's memory (one carry of
device memory, not two, and no allocation per chunk). In PyTorch that
is an in-place update: ``gram_cross`` adds into G and C and the column
sums use ``+=``. :func:`donates_carry` marks such an update and enters
it in a registry (:func:`registered_donations`):

* ``nodes/learning/linear.py::accumulate_gram_carry`` (the least-squares
  estimators' ``(G, C, sx, sy, n)`` carry);
* ``nodes/stats::StandardScaler.accumulate`` (the ``(S, SQ, n)``
  moments).

``KEYSTONE_TORCH_DONATE_CARRY=0`` is the debugging switch: each update
then works on a copy of the carry, and the caller's carry is never
written. Both settings give the same bits (``clone`` copies every bit,
-0.0 included). The contract for callers is the JAX one: a carry passed
to an update is dead after the call, so a checkpoint must copy it
before the next update (``resilience/stream_checkpoint.py`` does).

Each site registers a shape ``probe``: a zero-argument callable giving
example arguments on the ``meta`` device. :func:`donation_shape_mismatches`
runs the update on them (no device memory, no kernel launch) and checks
that every carry tensor comes back updated in place, as the same tensor
with its shape and dtype: the static gate of
``python -m keystone_tpu_torch.tools.lint``.
"""
from __future__ import annotations

import functools
import os
from dataclasses import KW_ONLY, dataclass
from typing import Any, Callable, List, Optional, Tuple

import torch


@dataclass(frozen=True)
class DonationSite:
    """One registered in-place carry update: the raw update ``fn``, its
    carry's positional index (where the JAX package lists donated
    argnums) and its shape ``probe`` (a zero-argument callable returning
    ``(args, kwargs)`` on the ``meta`` device, or None)."""

    fn: Optional[Callable]
    carry_arg: int
    _: KW_ONLY
    probe: Optional[Callable[[], Tuple]]
    name: str
    module: str


_REGISTRY: List[DonationSite] = []


def registered_donations() -> Tuple[DonationSite, ...]:
    """Every in-place update site registered so far (its module must
    have been imported)."""
    return tuple(_REGISTRY)


def _tensor_leaves(tree: Any) -> List[Any]:
    if isinstance(tree, (tuple, list)):
        return [leaf for x in tree for leaf in _tensor_leaves(x)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def donation_shape_mismatches(site: DonationSite) -> List[str]:
    """The carry tensors of ``site`` the update does not write in place,
    found by running the raw update on its probe's ``meta`` tensors: a
    carry tensor with no output of its shape and dtype, or one whose
    output is another tensor (the update allocated a new carry where it
    must write the old one). Sites without a probe return ``[]``."""
    if site.probe is None or site.fn is None:
        return []
    args, kwargs = site.probe()
    carry = _tensor_leaves(args[site.carry_arg])
    out = _tensor_leaves(site.fn(*args, **kwargs))
    available = [(tuple(t.shape), t.dtype) for t in out]
    mismatches = []
    for i, t in enumerate(carry):
        key = (tuple(t.shape), t.dtype)
        if key not in available:
            mismatches.append(
                f"{site.name} carry leaf {i} {str(t.dtype).replace('torch.', '')}"
                f"{list(key[0])} has no shape-compatible output")
            continue
        available.remove(key)
        if not any(o is t for o in out):
            mismatches.append(
                f"{site.name} carry leaf {i} is not updated in place (the "
                "update returns a new tensor)")
    return mismatches


def donation_enabled() -> bool:
    """False when ``KEYSTONE_TORCH_DONATE_CARRY=0``: updates then copy
    the carry first. Read at each call, never at import."""
    return os.environ.get("KEYSTONE_TORCH_DONATE_CARRY", "").strip() != "0"


def clone_carry(carry: Any) -> Any:
    """A carry with every tensor leaf copied (host ints pass through)."""
    if isinstance(carry, (tuple, list)):
        return type(carry)(clone_carry(x) for x in carry)
    return carry.clone() if isinstance(carry, torch.Tensor) else carry


def donates_carry(carry_arg: int = 0,
                  probe: Optional[Callable[[], Tuple]] = None) -> Callable:
    """Decorator marking an update that writes its carry (positional
    argument ``carry_arg``) in place; ``probe`` gives example arguments
    on the ``meta`` device for :func:`donation_shape_mismatches`."""

    def wrap(fn: Callable) -> Callable:
        _REGISTRY.append(DonationSite(fn, carry_arg, probe=probe,
                                      name=fn.__qualname__,
                                      module=fn.__module__))

        @functools.wraps(fn)
        def update(*args: Any, **kwargs: Any) -> Any:
            if not donation_enabled() and args[carry_arg] is not None:
                args = (args[:carry_arg] + (clone_carry(args[carry_arg]),)
                        + args[carry_arg + 1:])
            return fn(*args, **kwargs)

        return update

    return wrap
