"""Window packing for window-based point attention (port of
ao_tpu/ops/window_partition.py).

Points are bucketed into cubic windows (optionally shifted by half a
window), sorted by window id, and scattered into a ``(num_windows,
capacity)`` buffer with validity masks. Windows beyond ``num_windows`` and
points beyond a window's ``capacity`` are dropped (their ``win_of_point``
is -1), as in the JAX package. The maps are integers and equal the JAX
package's bit for bit:

* ``window_ids`` floors ``c * (1 / w)``, the float32 reciprocal of the
  window size: XLA rewrites the JAX package's division by a constant into
  that product when it compiles (a jitted step), and so does PyTorch's
  CUDA division by a scalar; true division puts a point lying on a window
  edge into the other window;
* the order inside a window is a stable sort's (``jnp.argsort`` is
  stable), which decides the points a full window drops;
* ids are int64 here; an invalid point's id is the JAX package's int32
  maximum, above every valid id of a scene.
"""

from __future__ import annotations

import numpy as np
import torch

_INT_MAX = 2**31 - 1  # the JAX package's int32 sentinel: invalid points


def reciprocal(x: float) -> float:
    """The float32 reciprocal of float32(x), as XLA folds ``a / x`` into
    ``a * (1 / x)``."""
    return float(np.float32(1.0) / np.float32(x))


def window_ids(coord: torch.Tensor, mask: torch.Tensor, window_size: float,
               shift: bool = False) -> torch.Tensor:
    """Cubic window id per point (B, N) int64: the extent-linearised floor of
    ``(coord - lo [+ w / 2]) / w``, lo the scene's minimum over its valid
    points; invalid points get the int32 maximum."""
    lo = torch.where(mask[..., None], coord, 1e30).amin(dim=1)  # (B, 3)
    c = coord - lo[:, None, :]
    if shift:
        c = c + window_size / 2
    d = torch.floor(c * reciprocal(window_size)).to(torch.int64)
    d = torch.where(mask[..., None], d, 0)
    extent = d.amax(dim=1) + 1
    wid = (d[..., 0] * extent[:, None, 1] + d[..., 1]) * extent[:, None, 2] + d[..., 2]
    return torch.where(mask, wid, _INT_MAX)


@torch.no_grad()
def pack_windows(wid: torch.Tensor, num_windows: int, capacity: int):
    """Returns the JAX package's four maps, (point_idx (B, W, C) int64 rows
    into N, slot_valid (B, W, C), win_of_point (B, N) int64 window row or
    -1, slot_of_point (B, N)), then the points dropped, summed over the
    batch as int64 device tensors: (of windows beyond ``num_windows``, of
    slots beyond ``capacity``).

    Window rows follow ascending window-id order; windows beyond
    ``num_windows`` and points beyond ``capacity`` are dropped (their
    win_of_point = -1)."""
    B, N = wid.shape
    dev = wid.device
    order = torch.argsort(wid, dim=1, stable=True)
    wid_sorted = torch.gather(wid, 1, order)
    valid_sorted = wid_sorted != _INT_MAX
    new_w = torch.ones_like(valid_sorted)
    new_w[:, 1:] = wid_sorted[:, 1:] != wid_sorted[:, :-1]
    new_w &= valid_sorted
    wrow_sorted = torch.cumsum(new_w.to(torch.int64), dim=1) - 1
    # the slot is the distance to the window's first point (a running
    # maximum of the starts)
    idx_in_seq = torch.arange(N, device=dev).expand(B, N)
    seg_start = torch.cummax(torch.where(new_w, idx_in_seq, 0), dim=1).values
    slot_sorted = idx_in_seq - seg_start

    in_rows = valid_sorted & (wrow_sorted < num_windows)
    keep = in_rows & (slot_sorted < capacity)
    # dropped points go to a last row, cut off after the scatter
    flat = torch.where(keep, wrow_sorted * capacity + slot_sorted,
                       num_windows * capacity)
    buf = torch.full((B, num_windows * capacity + 1), -1, dtype=torch.int64,
                     device=dev)
    buf.scatter_(1, flat, order)
    point_idx = buf[:, :-1].reshape(B, num_windows, capacity)
    slot_valid = point_idx >= 0
    point_idx = torch.where(slot_valid, point_idx, 0)

    # inverse maps in the original point order
    win_of_point = torch.empty_like(order).scatter_(
        1, order, torch.where(keep, wrow_sorted, -1))
    slot_of_point = torch.empty_like(order).scatter_(
        1, order, torch.where(keep, slot_sorted, 0))
    dropped = ((valid_sorted & ~in_rows).sum(), (in_rows & ~keep).sum())
    return (point_idx, slot_valid, win_of_point, slot_of_point), dropped

