"""K11: the wrapper of the full-rectangle NW kernel (``csrc/nw.cu``) and the
batch edit-distance entries over it.

Counterparts of ``astarpa_tpu/ops/pallas_myers.py::nw_right_edge``,
``nw_cost`` and ``nw_cost_pairs``.  On a CPU tensor :func:`nw_right_edge`
runs the plain :func:`.myers.nw_right_edge_ref`; on a CUDA tensor it
launches K11 or raises.  Its launches are counted in
``banded_kernel.LAUNCHES["nw_right_edge"]`` beside the other kernels'.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from . import myers
from .banded_kernel import _check as check_planes, _count, _plain as plain_route, recorded
from .pack import pack_batch_staggered
from .words import lengths, value_to_window

#: Words a thread of K11 holds in registers (``kWords`` in ``csrc/nw.cu``);
#: taller pairs hand carries between stripes through a byte plane.
STRIPE_WORDS = 32


@recorded
def nw_right_edge(a0, a1, pb0, pb1, n):
    """Right-edge ``(vp, vm)`` (S, B) int32 planes at column ``n`` per pair.

    a0/a1: (n_max, B) int32 sign-mask planes; pb0/pb1: (S, B) int32 negated
    b profiles; n: (B,) lengths in ``[0, n_max]`` (host numpy or a tensor).
    """
    _check(a0, a1, pb0, pb1, n)
    if plain_route(a0):
        return myers.nw_right_edge_ref(a0, a1, pb0, pb1, n)
    return _launch(a0, a1, pb0, pb1, n)


def nw_cost(a0, a1, pb0, pb1, n, m) -> torch.Tensor:
    """Edit distances ``n + value_to(v, m)``, (B,) int32 on the planes'
    device, of a pack of :func:`.pack.pack_batch_staggered`."""
    vp, vm = nw_right_edge(a0, a1, pb0, pb1, n)
    B, dev = a0.shape[1], a0.device
    return lengths(n, B, dev) + value_to_window(vp, vm, lengths(m, B, dev))


def nw_cost_pairs(pairs, device=None) -> np.ndarray:
    """Exact edit distances of byte pairs, (len(pairs),) int32.  ``device``
    ``None`` or ``"cuda"`` runs K11 on the card and raises without one;
    ``"cpu"`` runs the plain version."""
    dev = resolve_device(device)
    if not pairs:
        return np.zeros(0, np.int32)
    args, B0 = pack_batch_staggered(pairs, 1, device=dev)
    return nw_cost(*args)[:B0].cpu().numpy()


def _check(a0, a1, pb0, pb1, n) -> None:
    """The planes as every kernel wrapper checks them, and n in [0, n_max]."""
    check_planes("nw_right_edge", a0, a1, pb0, pb1, pb0.shape[0])
    n_max, B = a0.shape
    n_host = np.asarray(torch.as_tensor(n).cpu())
    if n_host.shape != (B,) or (B and (n_host.min() < 0 or n_host.max() > n_max)):
        raise ValueError(f"nw_right_edge: n must be ({B},) lengths in [0, {n_max}]")


def _launch(a0, a1, pb0, pb1, n):
    from ._build import load

    dev = a0.device
    n_max, B = a0.shape
    S = pb0.shape[0]
    n_t = lengths(n, B, dev)
    carry = torch.empty((n_max if S > STRIPE_WORDS else 0, B), dtype=torch.uint8, device=dev)
    vp = torch.empty((S, B), dtype=torch.int32, device=dev)
    vm = torch.empty((S, B), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = load().astarpa_nw_right_edge(
            *(t.data_ptr() for t in (a0, a1, pb0, pb1, n_t, carry, vp, vm)), B, S, stream,
        )
    if rc != 0:
        raise RuntimeError(f"nw_right_edge kernel launch failed: cudaError {rc}")
    _count("nw_right_edge")
    return vp, vm
